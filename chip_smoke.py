#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and ``nvcc``.
It builds the port's CUDA kernels from ``mast3r_slam_tpu_torch/csrc``,
then:

1. holds each kernel against its plain PyTorch version on the card at every
   shape the tracking path gives it (K1 on the model's own head-split
   views, checking its token-major output; K3 at the encoder, decoder,
   batched-decode and cross shapes; K2 with the path and split count each
   shape takes, in bf16 and f32, and at the evaluation crops' shapes),
   checks that two launches are bitwise equal, and times kernel, first
   design, plain version, one PyTorch library call of the same function (a
   yardstick the port never calls) and the least time the card could take; f32 K2 (the 3xTF32 path of the evaluation configs' f32
   heads) is summed per tracked frame at each crop and held within 4x of
   its first design's error against a float64 conv, and the TF32 rounding
   of the plain versions against the card's;
2. drives the port's main path at full ViT-L width with random weights and
   ``config/base.yaml`` settings: one mono-inference keyframe, then
   ``FrameTracker.track`` on 8 more frames, twice on the same frames: with
   ``track_core`` eager and as the tracker's CUDA graph (captured once,
   replayed; its LM loops conditional WHILE nodes), checking on both that
   every ``track_core`` output is finite, that each kernel was launched
   exactly as often as the path needs (every K2 launch on the implicit
   GEMM; a replay counts its captured launches and two loop nodes), that
   ``track_core`` makes no host sync (``set_sync_debug_mode("error")``
   around every call but the capture), and that the two paths' outputs
   and keyframe buffers agree bit for bit (the graphed outputs kept across
   later replays); then both paths' frame ms and its host steps by host
   clock (``utils/tictoc.py::STEPS``: ``create_frame``'s resize, upload,
   display image and pose; the keyframe snapshot, which the graphed
   tracker copies straight into its graph's buffers; the small inputs;
   the graph's key, input copies, launch, counters and output clones; the
   decision read; the rest of ``track``), and under ``torch.profiler`` the
   device busy ms, the kernels a frame counted from the device's events
   (in the replay and outside it) and the idle time split into the gaps
   inside the replay and outside it (``bench/frame_profile.py``), peak
   memory and the capture count;
3. runs the backend keyframe event at full width on that path's state:
   three keyframes, ``FactorGraph.add_factors`` with the tracker's 5-tuple
   hint (``match_oneway``) and without one (``match_symmetric``), the
   measured channels and ``solve_GN_rays`` twice from the same poses,
   eagerly and as the CLI runs them, as CUDA graphs (decode + match one a
   batch size, the solve one a padded edge bucket, its LM loop a
   conditional WHILE node): matches, Q, channels, poses and iterations
   bit for bit, exact K1 / K2 / K4 launch counts for each part (K4 = 1 +
   iterations, counted for the steps the loop ran), one capture per
   batch size and bucket, every solve but the capture under
   ``set_sync_debug_mode("error")``, the graphs' pool memory and each
   part's time eager, on its first graphed call (with the capture) and
   warm; then one warm graphed ``add_factors`` of edge (1, 2) on a factor
   graph of its own under ``torch.profiler``: its device time by kind and
   by source (``bench/trace_breakdown.py``), its host time outside the
   device's busy time, and its matches, Q and channels equal to the
   untraced call's bit for bit;
4. runs mono inference and the asymmetric pair decode (both heads) at full
   width and reduced depth in f32 on the card (kernels) and on the CPU
   (plain versions) and compares the entry points' outputs;
5. holds K4 / K5 (the BA Gram) against their plain versions on channels
   measured on oracle pointmaps at 384x512, over the edge counts, pixel
   counts and types of the backend, with their times, each Gram entry
   against the scale of its own rows (and shows that this comparison
   rejects a Gram with its smallest residual dropped or flipped); bf16
   rows take the tensor-core path, f32 rows the 3xTF32 tensor-core path
   (held within 4x of the first design's error against a float64 Gram at
   E = 128, N = 196,608), and the first, FMA design (``path="fma"``) is
   held and timed beside both; every launch is counted on its path, here
   and in phases 3, 7, 8 and 10 (every bf16-row launch on the tensor
   cores);
6. holds K4', the Gram microbenchmark's four kernels (the channel sum, the
   row sum, the diagonal blocks and the full Gram as one product), and the
   row sum on K4's tensor-core arithmetic, against their plain versions on
   the benchmark's inputs at 16 and 128 edges with their times, the
   diagonal blocks and the one product (K4's tensor-core kernel with other
   tiles) against K4's diagonal-block sum and K4 itself, the row sum
   against its first kernel bit for bit on edges of one live pixel
   and timed beside it, with its SASS a pixel, then runs
   the benchmark itself
   (``mast3r_slam_tpu_torch.bench.gram_kernel_bench``, its default run and
   ``--r2``) with exact launch counts and its agreement lines in tolerance;
7. runs the oracle SLAM harness at 384x512 (exact geometry plus noise in
   place of the network) for the ray and the calibrated BA, checks that the
   BA recovers the trajectory, cross-checks one Gram and one system build
   on the card against the CPU, holds the BA's solve as a CUDA graph (a
   capture and two replays) against the eager solve bit for bit, and
   reruns the BA's LM loop from kicked keyframe poses on the card and on
   the CPU: several accepted steps, the trajectory recovered, both runs
   ending at the same poses;
8. runs the port's CLI (``mast3r_slam_tpu_torch.main.main``) at full ViT-L
   width on a 24-frame TUM clip it writes (an out-and-back pan) with
   ``config/base.yaml``'s quality service and local TSDF refiner as
   shipped, checking every frame processed, at least 8 keyframes, a
   retrieval edge, the exported trajectory, PLYs (the quality one with
   non-zero fields) and keyframe PNGs, each kernel's launches against the
   run's own model calls and LM iterations, every quality job processed
   or dropped and every refiner task ended, and its frame reads
   (``dataset[i]`` + ``create_frame``) timed; then the same clip with the
   services off (their cost to the tracked frame and the backend step),
   again with the tracker, the solves and the decode + match eager (the
   same modes, keyframes, edges and keyframe poses, bit for bit, as the
   graphed run; the step's parts of both), a calibrated run (K5), a
   checkpoint restored bit for bit and resumed, and a threaded run with
   the global TSDF on as well that drains (its backend capturing beside
   the tracker's replays); every CLI run (here and in phases 13-15)
   captures the tracker's graph once, each solve bucket and decode +
   match batch size at most once, and runs the loop nodes its replays
   hold, and reports its graphs' captures, replays and pool memory;
9. runs the CLI with one reduced-depth f32 model on the card and on the
   CPU (services off): the same modes, keyframes and edges, the same
   poses, and every BA solve of the card's run solved again on the CPU
   from the card's inputs to the same poses;
10. runs the relocalization episode of ``tests/test_oracle_reloc.py`` at
   384x512: a teleport recovered within the JAX test's bounds, an impostor
   rejected and rolled back;
11. runs the services on the oracle scene's keyframes at 384x512 with
   base.yaml's settings: the quality service fed seeded jobs, the refiner
   refining at least one block at G = 64, the global TSDF's pose optimizer
   pulling a 3 cm offset back onto the surface, and
   ``compute_quality_batch``, ``refine_blocks_core`` and one integrate and
   query on the card against the CPU, with their times;
12. (first, before any kernel: phase ``data``) builds the JPEG decoder on
   this machine, decodes the committed fixtures (``tests/data/jpeg``:
   baseline, progressive, 4:1:1, CMYK, YCCK, RGB-coded, cut and
   EXIF-tagged files; ``tests/data/png``: every colour type x bit depth x
   interlace, tRNS, gamma and eXIf files) in the colour and the gray read
   to the SHA-256 digests of cv2.imread's reads recorded beside them,
   checks EuRoC cam0's and TUM freiburg1/2's ``K_undist`` against cv2's
   numbers to 1e-6, times one 1200x680 Replica decode on the host, as a
   baseline and as a progressive file of the same coefficients (which
   must decode to the same pixels), and builds the frame read's compiled
   host code (``native/image_host.cpp``) and holds it against its plain
   versions, equal bytes and float32 bits, timing both: the 480x640 PNG
   decode with Sub, Up, Average and Paeth rows, the EuRoC (gray and
   colour) and TUM freiburg1 remaps, and ``resize_img`` (cv2's INTER_AREA
   pass and its copy) at the TUM, EuRoC and Replica sizes and the model
   crop's copy; both resizes on the seeded inputs of
   ``tests/data/resize`` against the SHA-256 of cv2.resize's output
   recorded there; then a calibrated TUM frame's read step by step (the
   PNG decode, the float conversion, the remap, ``create_frame``'s
   steps);
13. (phase ``cli_datasets``) runs the CLI at full ViT-L width on 12-frame
   clips it writes in the evaluation datasets' layouts, each under its
   evaluation script's config: EuRoC (gray 752x480 PNGs, undistorted on
   read, ``eval_no_calib``: K4's f32-row path), TUM freiburg1 under
   calibration (undistorted, ``eval_calib``: K5's) and Replica (680x1200
   JPEGs written by ``tests/torch_jpeg_writer.py``, ``eval_replica``: K5),
   then Replica again as progressive JPEGs of the same coefficients, then
   an image folder of the cli phase's pan frames as 8-bit PNGs and as
   mixed PNG kinds (16-bit, Adam7, stored under each EXIF orientation,
   written by ``tests/torch_png_writer.py``) under base.yaml with the
   services off (bf16), checking outputs, launches per kernel and path
   (the eval configs' DPT convs on K2's 3xTF32 path and system builds on
   the f32-row Gram; base.yaml's on the implicit GEMM and the tensor-core
   Gram), K_frame's principal point, and that the progressive and mixed
   clips' reader frames equal their baseline clips' bit for bit and their
   runs give the same modes, keyframes and edges; each run times its
   frame reads (``dataset[i]`` + ``create_frame``), then the clip's reads
   are timed compiled and plain in turns (the same frames, bit for bit),
   and the EuRoC, TUM, Replica and image-folder runs are repeated with the
   plain read: the same modes, keyframes, edges and poses, bit for bit;
14. (phase ``topology``) prints the layout ``plan_topology()`` gives on
   the visible cards, then on a virtual 5-slot layout of cuda:0 checks
   the sharded symmetric decode of 3 pairs at full width (padded to a
   4-slot backend mesh: one decoder call a slot with one decode's K1 / K2
   launches, equal bit for bit to each slot's pairs decoded alone, within
   ``TOPO_DECODE_TOL`` of one unsharded decode), the 4-slot K4 / K5
   systems at the keyframe event's E (bf16 and f32 channels and rows)
   against one build, ``main()`` on the CLI clip with base.yaml's
   services and ``devices=[cuda:0] * 5`` (the cli phase's checks, a
   sharded solve, launches from the run's decoder calls and system
   builds, its medians beside the cli phase's one-slot run) and the
   fallback of a 3-slot backend with one edge; the sharded decode and the
   mesh's matcher as CUDA graphs (one a device and per-slot batch, the
   matcher's one a batch on the first slot) bit for bit their eager path,
   a second call replaying every slot, warm ms beside eager ms; the mesh
   solve (rays and calibrated, bf16, the padded bucket split in equal
   shares) eager and graphed, bit for bit, K4 / K5 launched slots x (1 +
   iterations) a solve; the CLI's mesh solves, decodes and matcher as
   graphs (captures and replays counted); with two or more cards the same
   on the distinct cards (the solve as a graph a card with the loop on the
   host), else it says that layout was not run;
15. (phase ``viz``) runs the CLI with its viewer (no ``--no-viz``) on the
   cli phase's clip: launches from its own calls, and the modes,
   keyframes and edges of the ``--no-viz`` run; then, on that run's
   keyframe buffer against a CPU copy, the software renderer
   (``viz/render.py``) at 480x640 and 720x1280 (99.9% of pixels equal,
   median ms of 20, points splatted, lock hold) and the GL viewer's data
   path (``_refresh_dirty``, ``_gather_map``, ``_camera_mvp``, the
   overlay; ms and lock hold); one frame through EGL where OpenGL
   imports, else a line that the GL pipeline was not exercised and why;
   and ``two_view_infer`` / ``match_asymmetric`` at 384x512, bit for bit
   their compositions, with their K1 / K2 launches.
16. (phase ``ate_study``) runs ``bench/ate_study.py``'s ``modes`` table
   at the JAX oracle studies' protocol (96 frames, 64x96, a keyframe every
   4, a 30-iteration BA) with noise seed 0, and base.yaml's row again with
   the calibrated solves: no skips, 24 keyframes, the BA holding the
   tracked trajectory (but for the separable ablation), base.yaml's cuts
   within ``tests/test_oracle_modes.py``'s bounds of strict, and K4 / K5
   launched 1 + LM iterations a solve on the path of the row's Gram rows
   (strict: ``tf32``, the bf16 rows: ``mma``), with each row's wall time;
17. (phase ``eval_harness``) runs ``bench/eval_datasets.py`` at full ViT-L
   width on a calibrated TUM clip with its ground truth and a 7-Scenes
   scene whose ground truth the harness derives from its pose files: the
   trajectory written where the JAX scripts' evaluation reads it, its ATE
   equal to ``evaluation.ate_rmse`` on the same files, K1 / K2 / K5 launched
   as the run's model calls and solves need (K2 on ``tf32x3``, K5 on
   ``tf32``);
18. (phase ``recall``) runs ``bench/retrieval_recall.py`` at full ViT-L
   width on 384x512 frames: 24 K1 launches a frame encoded, recall@1-3 of
   the bootstrap codebook and the projector head, the encoder's ms a
   frame;
19. (phase ``backend_tools``) runs the JAX repo's backend speed tools as
   ported: ``bench/bench_ba.py`` at deployment scale (110 poses, 128
   two-way edge rows x 196,608 pixels) with bf16 rows, f32 rows and
   calibrated, graphed and eager (every solve ``max_iter`` LM iterations
   and 1 + iterations K4 / K5 launches on the rows' path, graphed and
   eager poses bit for bit), ``bench/ba_solve_microbench.py`` (the two
   assemblies within 1e-4 of max |H|, the solve's residual within 1e-3 of
   |g|), ``bench/profile_backend_decode.py`` at full ViT-L width with f32
   and bf16 heads (each stage's K1 / K2 launches, the graphed
   ``match_symmetric`` bit for bit its eager call), and
   ``bench/trace_breakdown.py`` on ``bench_ba``'s trace of a graphed
   10-iteration solve (11 K4 kernels in it);
20. (phase ``debug_tools``) runs the JAX repo's last two scripts as
   ported: ``bench/profile_refine.py`` at 384x512 (the three gather
   layouts of one refine level, five levels of layout B and the port's
   production search, each a CUDA graph timed by CUDA events; layouts A
   and B equal bit for bit) and ``bench/debug_oracle_fail.py`` (the oracle
   harness's 96 frames at 64x96 to a first tracking failure, if any, then
   a failure planted in frame 7 of 12 on the card and on the CPU: the
   same frames' ``ok``, failing frame and LM rows' flags);
21. (phase ``video``) builds the video decoder (``native/video_decode.cpp``
   with ``native/h264_decode.cpp`` and ``native/vp9_decode.cpp``) on this
   machine and reads every
   committed fixture of ``tests/data/video`` (MPEG-4 Part 2 in MP4, MOV,
   AVI and Matroska; MJPEG in AVI and Matroska; H.264, CAVLC and CABAC, in
   MP4, Matroska and AVI, a cropped 152x104 clip and a 1920x1080 one; H.264
   with B pictures in MP4 (ctts with and without elst), Matroska and AVI,
   and IBBP clips at 1920x1080 and 480x640; VP9 from cv2's writer in
   Matroska, MP4 and AVI at 160x120, 130x98, 480x640 and 1920x1080 and the
   VP9 test writer's hidden / compound / adaptation / segmentation / tile
   streams; MPEG-4 Part 2 as Xvid and DivX write it from the MPEG-4 test
   writer: an IBBP clip at 480x640 under the Xvid IDCT, B-VOPs in MP4 and
   Matroska BlockGroups, packed B-VOPs in AVI, the I/P tools under FF_BUG_EDGE
   and DC_CLIP), in order and backwards (each seek decoding from an IDR
   picture, a VP9 key frame or, as OpenCV seeks, an I-VOP), to the SHA-256 digests of
   cv2.VideoCapture's frames recorded beside them; times the host ms a
   480x640 frame of MPEG-4 I-VOPs, P-VOPs, MJPEG and H.264 (an IDR
   picture, CAVLC P and CABAC P pictures, and the B and P pictures of the
   IBBP clip; VP9 key and inter frames; the Xvid IBBP clip's I-, P- and
   B-VOPs) and a 1920x1080 H.264 frame (and the
   IBBP clip's B and P pictures, and VP9 key and inter frames), beside the
   compiled and plain numpy converters on the same planes (equal bytes);
   holds VP9's three plain versions (``vp9_itx_ref``, ``vp9_mc_ref``,
   ``vp9_lf_ref``) and MPEG-4's (``xvid_idct_ref``, ``hpel_ref``,
   ``mpeg4_bipred_ref``) against the compiled entries; then runs the CLI at
   full ViT-L width on the committed 16-frame 480x640 mp4v clip, the H.264
   I/P one, the H.264 IBBP one, the VP9 one and the Xvid IBBP one under
   base.yaml with the services off (bf16): all 16 frames
   read, the outputs checked, K1, K2 (implicit GEMM) and K4 (tensor cores)
   launched and counted as each run's calls need, with its median tracked
   frame and frame read (``dataset[i]`` + ``create_frame``).

In every phase that runs a service, an exception in a service worker (which
prints it and carries on) fails the run, and the global TSDF must run on
the native voxel hash.

K3 (flash attention without RoPE, which no path calls) is held against its
plain version in phase 1. ``--phases`` runs a subset (no kernel table).

Any failed check raises and the script exits non-zero. Its last three lines
are the kernel table (JSON), the card's name and power limit as
``nvidia-smi`` reports them, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, f32
# CUDA-core rate, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
# dense TF32 tensor-core rate: a float32-accurate product on the tensor
# cores takes TF32_PASSES TF32 products (hi*hi + hi*lo + lo*hi)
PEAK_TF32 = 494.7e12
TF32_PASSES = 3
# a float32 path's largest error against float64 may be at most this many
# times its first (CUDA-core FMA) design's on the same inputs
F64_GUARD = 4.0

N_FRAMES = 9
IMG_HW = (384, 512)
PROFILED_FRAMES = 4   # tracked frames under torch.profiler, per path
K1_PER_PAIR = 48      # 24 encoder + 12 decoder self + 12 decoder cross
K1_PER_DECODE = 24    # 12 decoder self + 12 decoder cross, any batch
K2_PER_HEAD = 20      # rn0-rn3, 14 fusion-block convs, head_c1, head_c2
# two-way edges of a BA system: a first edge, the keyframe event's (2
# edges), the oracle BA's (5 edges), a 9-keyframe map, K4′'s production shape
GRAM_EDGES = (2, 4, 10, 16, 128)
GRAM_PIXELS = (98_304, 196_608)       # 384*512 / pixel_step 2 and 1
# the evaluation layouts' crops at img_size 512 besides IMG_HW (TUM's):
# EuRoC's 752x480 and Replica's 1200x680 frames. Their token grids (20x32,
# 18x32), DPT shapes (down to 10x16 and 9x16) and BA pixel counts at
# pixel_step 1 (163,840, 147,456) are checked on their own, with a first
# edge and a three-edge system for the Gram
EVAL_CROPS = ((320, 512), (288, 512))
EVAL_GRAM_EDGES = (1, 3)
GRAM_REPORT = (16, 98_304)            # the shape of the table's K4/K5 row
GRAM_REPORT_EDGES = (16, 128)         # ... and its E = 128 set (ms_e128, ...)
ORACLE_FRAMES = 24
# make_trajectory's amplitudes (0.45 / 0.3 / 0.12 m, 0.06 rad) scaled so
# that keyframes 4 frames apart stay within the cold-start matcher's reach
# at 384x512; at full amplitude every BA edge's match falls under
# run_oracle_slam's 20% valid gate and the BA has no edges
ORACLE_MOTION = 0.125
# tests/test_oracle_modes.py FAST: config/base.yaml's matcher and BA cuts
ORACLE_FAST = dict(refine_mode="plus", level_step=2, plateau_frac=0.001,
                   radius=2, proj_step=2, track_dilation_max=1,
                   ba_pixel_step=2, ba_meas_dtype="bfloat16",
                   ba_compute_dtype="bfloat16", ba_delta_norm=1e-2)
# K4 / K5 against their plain versions: ``ba_kernels.gram_error``, each
# Gram entry against the scale of its own rows (the distance and log-depth
# blocks sit orders of magnitude below max|G| with base.yaml's sigmas)
GRAM_TOL = {"float32": 1e-4, "bfloat16": 1e-4}
# the oracle BA's LM loop restarted from keyframe poses moved by this much
# (per se(3)/scale coordinate, radians and metres), run to max_iter
ORACLE_KICK = 0.02
ORACLE_KICK_ITERS = 10


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Median of ``iters`` per-call CUDA-event times (ms) after warm-up.

    The calls are queued behind a ~30 ms device-side sleep, so the host has
    enqueued them all before the first one runs: each event pair then
    brackets device work only, not the host's launch overhead."""
    import torch

    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


K4P = (("K4'a", "load"), ("K4'b", "rows"), ("K4'c", "diag"),
       ("K4'd", "one_product"))
# K4' and the benchmark's row-stage probe on K4's tensor-core arithmetic
K4P_ALL = K4P + (("K4'b-fast", "rows_fast"),)


def k4p_counters():
    from mast3r_slam_tpu_torch.ops import gram_variants as GV

    return {key: getattr(GV, f"{name}_counter") for key, name in K4P_ALL}


def reset_counters(FA, C3, BA):
    from mast3r_slam_tpu_torch.ops import device_loop

    for c in (FA.counter, FA.attn_counter, C3.counter, BA.rays_counter,
              BA.calib_counter, *k4p_counters().values(),
              *C3.path_counters.values(), *BA.path_counters.values(),
              device_loop.counter, device_loop.masked):
        c.launches = 0


def masked_launches():
    """Counted kernels' launches in the steps that the card's eager loops
    launched after their exit, which ran masked (``ops/device_loop.py``;
    not on the kernels' counters); none in a graph's replay."""
    from mast3r_slam_tpu_torch.ops import device_loop

    return device_loop.masked.launches


def loop_nodes():
    """Conditional loop nodes run (``ops/device_loop.py``): two a replayed
    tracked frame (the matcher's and the pose solve's LM loops), none on
    an eager path."""
    from mast3r_slam_tpu_torch.ops import device_loop

    return device_loop.counter.launches


def launch_counts(FA, C3, BA):
    """Launches per kernel; "K2 <path>" count K2 by path and "BA <path>" K4
    and K5 together by path."""
    out = {"K1": FA.counter.launches, "K2": C3.counter.launches,
           "K3": FA.attn_counter.launches, "K4": BA.rays_counter.launches,
           "K5": BA.calib_counter.launches}
    out.update({f"K2 {p}": c.launches for p, c in C3.path_counters.items()})
    out.update({f"BA {p}": c.launches for p, c in BA.path_counters.items()})
    out.update({k: c.launches for k, c in k4p_counters().items()})
    return out


def _build_sms(torch):
    from mast3r_slam_tpu_torch import _build

    return _build.sm_count(torch.device("cuda"))


def sync_clock(torch):
    """The host clock after every visible card has finished its work (a
    layout over several cards runs the backend on cards other than the
    calling thread's); not while the tracker captures its CUDA graph (a
    device-wide sync would invalidate the capture)."""
    from mast3r_slam_tpu_torch.ops import device_loop

    with device_loop.capture_lock:
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    return time.perf_counter()


def bound_ms(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compare(out, ref, dtype_name, what):
    """f32: max|out-ref| <= 1e-4·max|ref| + 1e-5; bf16: <= 2e-2·max|ref|."""
    out, ref = out.float(), ref.float()
    check(bool(out.isfinite().all()), f"{what}: non-finite output")
    err = (out - ref).abs().max().item()
    scale = ref.abs().max().item()
    tol = (1e-4 * scale + 1e-5 if dtype_name == "float32" else 2e-2 * scale)
    check(err <= tol, f"{what}: max abs err {err:.3e} > {tol:.3e}")
    return err


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def k1_cases():
    """(batch, heads, label, calls per track_core, calls per keyframe
    event) at 768 tokens, D = 64: the event decodes one pair at batch 1
    (``match_oneway``) and one at batch 2 (``match_symmetric``)."""
    return [(1, 16, "encoder", 24, 0), (2, 12, "decoder", 24, 24),
            (4, 12, "batched pairs", 0, 24)]


def k2_cases(hw=IMG_HW):
    """The ten distinct 3x3 conv shapes of one DPT head at ``hw``
    (96x128 ... 384x512 at 384x512): (H, W, Cin, Cout, has_bias, calls per
    head)."""
    H, W = hw
    return [
        (H // 4, W // 4, 96, 256, False, 1),      # rn0
        (H // 8, W // 8, 192, 256, False, 1),     # rn1
        (H // 16, W // 16, 384, 256, False, 1),   # rn2
        (H // 32, W // 32, 768, 256, False, 1),   # rn3
        (H // 32, W // 32, 256, 256, True, 2),    # ref4 rcu2
        (H // 16, W // 16, 256, 256, True, 4),    # ref3
        (H // 8, W // 8, 256, 256, True, 4),      # ref2
        (H // 4, W // 4, 256, 256, True, 4),      # ref1
        (H // 2, W // 2, 256, 128, True, 1),      # head_c1
        (H, W, 128, 128, True, 1),                # head_c2
    ]


def cudnn_conv(x, w, bias):
    """cuDNN's conv of the same function (the K2 rows' library call; f32
    in true f32 after ``use_full_f32``)."""
    import torch
    import torch.nn.functional as F

    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return F.conv2d(xc, wc, bias, padding=1)


def conv3x3_f64(x, w, bias):
    """The conv in float64 (NHWC), the reference of the float64 guard."""
    import torch.nn.functional as F

    y = F.conv2d(x.double().permute(0, 3, 1, 2),
                 w.double().permute(3, 2, 0, 1),
                 None if bias is None else bias.double(), padding=1)
    return y.permute(0, 2, 3, 1)


def k2_f32_frame():
    return dict(ms=0.0, first_ms=0.0, plain_ms=0.0, library_ms=0.0,
                prepass_ms=0.0, flops=0.0, nbytes=0.0, err=0.0, err64=0.0,
                err64_first=0.0)


def k2_f32_frame_add(acc, calls, flops, nbytes, t_k, t_f, t_p, t_l, t_w):
    """Adds one f32 DPT shape's calls of a tracked frame (two heads);
    ``t_w``: the weight pre-pass alone, part of ``t_k``."""
    n = 2 * calls
    for key, val in (("ms", t_k), ("first_ms", t_f), ("plain_ms", t_p),
                     ("library_ms", t_l), ("prepass_ms", t_w),
                     ("flops", flops), ("nbytes", nbytes)):
        acc[key] += n * val


def k2_f32_frame_done(acc, hw):
    """The f32 K2 sums of a tracked frame at ``hw`` with their floors: the
    tensor cores' (TF32_PASSES TF32 products, the float32-accurate route:
    the bound), the CUDA cores' (f32 FMAs) and the bytes'."""
    tc = acc["flops"] * TF32_PASSES / PEAK_TF32 * 1e3
    acc["cuda_core_ms"] = acc["flops"] / PEAK_FLOPS["float32"] * 1e3
    acc["bytes_ms"] = acc["nbytes"] / PEAK_BYTES * 1e3
    acc["bound_ms"] = max(tc, acc["bytes_ms"])
    acc["by"] = "operations" if tc >= acc["bytes_ms"] else "bytes"
    log(f"K2 float32 per tracked frame at {hw[0]}x{hw[1]} (40 calls, "
        f"{acc['flops'] * 1e-9:.1f} GFLOP): kernel {acc['ms']:.4f} ms (its "
        f"weight pre-pass {acc['prepass_ms']:.4f} ms), "
        f"first (fma) {acc['first_ms']:.4f} ms, plain {acc['plain_ms']:.4f}"
        f" ms, cudnn f32 (TF32 off) {acc['library_ms']:.4f} ms; bound "
        f"{acc['bound_ms']:.4f} ms (tensor cores, {TF32_PASSES} TF32 "
        f"passes; CUDA-core floor {acc['cuda_core_ms']:.4f} ms, bytes "
        f"{acc['bytes_ms']:.4f} ms); float64 error {acc['err64']:.3e}, "
        f"first design's {acc['err64_first']:.3e}")
    return acc


def prepass_ms(C3, path, w):
    """Time of the 3xTF32 path's weight pre-pass alone (0 on another
    path)."""
    return (time_ms(lambda: C3.tf32_split_weights(w)) if path == "tf32x3"
            else 0.0)


def tf32_round_check(torch):
    """``ops.tf32.tf32_round`` against the card's ``cvt.rna.tf32.f32`` on a
    million random float32 bit patterns and the edge values (signed zeros,
    subnormals, ties, the largest finite float, infinities), bit for bit
    (NaN as NaN)."""
    import numpy as np

    from mast3r_slam_tpu_torch.ops import conv3x3 as C3
    from mast3r_slam_tpu_torch.ops.tf32 import tf32_round

    edge = [0x0, 0x80000000, 0x1, 0x1000, 0x80001000, 0x7fffff, 0x3f801000,
            0x3f803000, 0xbf801000, 0x3f800fff, 0x7f7fefff, 0x7f7ff000,
            0x7f7fffff, 0xff7fffff, 0x7f800000, 0xff800000, 0x7fc00000]
    rng = np.random.default_rng(0)
    bits = np.concatenate([np.array(edge, np.uint32), rng.integers(
        0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)])
    x = torch.from_numpy(bits.view(np.float32).copy())
    want = tf32_round(x)
    got = C3.tf32_round_on_card(x.to("cuda")).cpu()
    nan = torch.isnan(want)
    same = (torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))
    check(same, "ops.tf32.tf32_round differs from the card's cvt.rna")
    log(f"TF32 rounding: ops.tf32.tf32_round equals the card's "
        f"cvt.rna.tf32.f32 on {bits.size} float32 values")


def k2_f64_guard(torch, C3, x, w, bias, out, tag, acc):
    """The f32 conv's largest error against float64 is at most
    ``F64_GUARD`` times the first (fma) design's on the same inputs."""
    ref = conv3x3_f64(x, w, bias)
    first = C3.conv3x3(x, w, bias, path="fma")
    torch.cuda.synchronize()
    e_new = (out.double() - ref).abs().max().item()
    e_first = (first.double() - ref).abs().max().item()
    check(e_new <= F64_GUARD * e_first,
          f"{tag}: float64 error {e_new:.3e} > {F64_GUARD:g} x the first "
          f"design's {e_first:.3e}")
    acc["err64"] = max(acc["err64"], e_new)
    acc["err64_first"] = max(acc["err64_first"], e_first)


def crop_kernel_checks(torch, g):
    """K1 and K2 against their plain versions at the token grids and DPT
    shapes of ``EVAL_CROPS``: K1 in bf16 (the trunk's dtype) and f32, K2 in
    f32 (the evaluation configs' head_dtype) and bf16, with f32 K2's
    float64 guard. Times only f32 K2's calls of a tracked frame (kernel,
    first design, plain, cuDNN). Returns the largest error of each kernel
    and the f32 K2 sums per crop."""
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.ops import conv3x3 as C3
    from mast3r_slam_tpu_torch.ops import flash_attention as FA

    dev = "cuda"
    errs = {"K1": 0.0, "K2": 0.0}
    frames = {}
    n_checks = 0
    for hw in EVAL_CROPS:
        f32_frame = k2_f32_frame()
        hp, wp = hw[0] // 16, hw[1] // 16
        for b, h, label, _, _ in k1_cases():
            pos = M.patch_positions(hp, wp, b, dev)
            cos, sin = FA.rope_tables(pos, 64)
            for dt in (torch.bfloat16, torch.float32):
                dn = str(dt).split(".")[-1]
                q, k, v = model_qkv(torch, M, b, h, hp * wp, dt, g)
                before = FA.counter.launches
                out = FA.flash_attention_rope(q, k, v, cos, sin, cos, sin)
                ref = FA.flash_attention_rope_ref(q, k, v, cos, sin, cos, sin)
                torch.cuda.synchronize()
                tag = (f"K1 {label} at {hw[0]}x{hw[1]} "
                       f"({b},{h},{hp * wp},64) {dn}")
                check(FA.counter.launches == before + 1,
                      f"{tag}: not launched")
                errs["K1"] = max(errs["K1"], compare(out, ref, dn, tag))
                n_checks += 1
        for hh, ww, cin, cout, has_bias, calls in k2_cases(hw):
            for dt in (torch.float32, torch.bfloat16):
                dn = str(dt).split(".")[-1]
                path = C3.conv3x3_path(dt, cin, cout)
                for bsz in (1, 2):
                    x = torch.randn(bsz, hh, ww, cin, generator=g, device=dev)
                    w = torch.randn(3, 3, cin, cout, generator=g, device=dev)
                    w = w * (1.0 / math.sqrt(9 * cin))
                    x, w = x.to(dt), w.to(dt)
                    bvec = torch.randn(cout, generator=g, device=dev).to(dt)
                    for bias in (None, bvec):
                        before = C3.path_counters[path].launches
                        out = C3.conv3x3(x, w, bias)
                        ref = C3.conv3x3_ref(x, w, bias)
                        torch.cuda.synchronize()
                        tag = (f"K2 ({bsz},{hh},{ww},{cin}->{cout}) {dn} "
                               f"bias={bias is not None}")
                        check(C3.path_counters[path].launches == before + 1,
                              f"{tag}: did not take the {path} path")
                        e = compare(out, ref, dn, tag)
                        errs["K2"] = max(errs["K2"], e)
                        n_checks += 1
                        if dt != torch.float32:
                            continue
                        f32_frame["err"] = max(f32_frame["err"], e)
                        k2_f64_guard(torch, C3, x, w, bias, out, tag,
                                     f32_frame)
                        if bsz == 1 and (bias is not None) == has_bias:
                            nbytes = (x.numel() + hh * ww * cout + w.numel()
                                      + (cout if has_bias else 0)) * 4
                            k2_f32_frame_add(
                                f32_frame, calls,
                                2.0 * hh * ww * 9 * cin * cout, nbytes,
                                time_ms(lambda: C3.conv3x3(x, w, bias)),
                                time_ms(lambda: C3.conv3x3(x, w, bias,
                                                           path="fma")),
                                time_ms(lambda: C3.conv3x3_ref(x, w, bias)),
                                time_ms(lambda: cudnn_conv(x, w, bias)),
                                prepass_ms(C3, path, w))
        frames[hw] = k2_f32_frame_done(f32_frame, hw)
    log(f"K1 / K2 at the evaluation crops {EVAL_CROPS}: {n_checks} checks "
        f"against the plain versions, largest errors K1 {errs['K1']:.2e}, "
        f"K2 {errs['K2']:.2e}")
    return errs, frames


def k3_cases():
    """(batch, heads, Nq, Nk, label): the encoder's and the decoder's
    self-attention shapes at 384x512, a batched backend decode, and cross
    shapes with Nq != Nk. The first one is the kernel table's row."""
    return [(1, 16, 768, 768, "encoder"), (1, 12, 768, 768, "decoder"),
            (8, 12, 768, 768, "batched decode"),
            (1, 2, 128, 384, "cross"), (1, 2, 384, 128, "cross")]


def phase_k3(torch, g):
    """K3 (flash attention without RoPE) against its plain version at
    every shape of ``k3_cases`` in f32 and bf16, with times. No path of the
    system calls it (its launches on the main path are 0)."""
    import torch.nn.functional as F

    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.ops import flash_attention as FA

    row = dict(err=0.0)
    for b, h, nq, nk, label in k3_cases():
        for dt in (torch.bfloat16, torch.float32):
            dn = str(dt).split(".")[-1]
            q = torch.randn(b, h, nq, 64, generator=g, device="cuda").to(dt)
            k, v = (torch.randn(b, h, nk, 64, generator=g, device="cuda")
                    .to(dt) for _ in range(2))
            before = FA.attn_counter.launches
            out = M.attention(q, k, v)
            check(FA.attn_counter.launches == before + 1,
                  "models/mast3r.py::attention did not launch K3")
            ref = FA.flash_attention_ref(q, k, v)
            torch.cuda.synchronize()
            err = compare(out, ref, dn, f"K3 {label} ({b},{h},{nq},{nk}) {dn}")
            check(torch.equal(out, FA.flash_attention(q, k, v)),
                  f"K3 {label} {dn}: two launches differ")
            row["err"] = max(row["err"], err)
            t_k = time_ms(lambda: FA.flash_attention(q, k, v))
            t_p = time_ms(lambda: FA.flash_attention_ref(q, k, v))
            t_l = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
            t_f = (time_ms(lambda: FA.first_design_attention(q, k, v))
                   if dt == torch.bfloat16 else t_k)
            flops = 4.0 * b * h * nq * nk * 64
            nbytes = (2 * b * h * nq + 2 * b * h * nk) * 64 * q.element_size()
            bnd, by = bound_ms(flops, nbytes, dn)
            log(f"K3 {label:14s} ({b},{h},{nq},{nk},64) {dn:8s} err "
                f"{err:.2e} kernel {t_k:.4f} ms (first design {t_f:.4f}) "
                f"plain {t_p:.4f} ms sdpa {t_l:.4f} ms bound "
                f"{bnd * 1e3:.2f} us ({by})")
            if "ms" not in row and dt == torch.bfloat16:
                row.update(ms=t_k, first_ms=t_f, plain_ms=t_p,
                           library_ms=t_l, bound_ms=bnd, by=by)
    return row


def model_qkv(torch, M, b, h, n, dt, g):
    """q, k, v as the model builds them: the head-split views of one qkv
    projection's output, ``_split_heads`` for the encoder's batch 1 and
    ``_heads_s`` of the stacked two-stream decoder otherwise (b = 2 x the
    decoder batch)."""
    c = h * 64
    if b == 1:
        x = torch.randn(1, n, 3 * c, generator=g, device="cuda").to(dt)
        return tuple(M._split_heads(t, h) for t in x.chunk(3, dim=-1))
    x = torch.randn(2, b // 2, n, 3 * c, generator=g, device="cuda").to(dt)
    return tuple(M._heads_s(t, h) for t in x.chunk(3, dim=-1))


def phase_kernels(torch):
    import torch.nn.functional as F

    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.ops import conv3x3 as C3
    from mast3r_slam_tpu_torch.ops import flash_attention as FA

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1234)
    per_frame = {k: dict(ms=0.0, first_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                         library_ms=0.0, err=0.0) for k in ("K1", "K2")}
    hp, wp = IMG_HW[0] // 16, IMG_HW[1] // 16
    n = hp * wp
    for b, h, label, calls, event_calls in k1_cases():
        pos = M.patch_positions(hp, wp, b, dev)
        cos, sin = FA.rope_tables(pos, 64)
        for dt in (torch.bfloat16, torch.float32):
            dn = str(dt).split(".")[-1]
            q, k, v = model_qkv(torch, M, b, h, n, dt, g)
            check(not q.is_contiguous(), "the model's q view is contiguous")
            out = FA.flash_attention_rope(q, k, v, cos, sin, cos, sin)
            ref = FA.flash_attention_rope_ref(q, k, v, cos, sin, cos, sin)
            torch.cuda.synchronize()
            err = compare(out, ref, dn, f"K1 {label} {dn}")
            check(torch.equal(out, FA.flash_attention_rope(
                q, k, v, cos, sin, cos, sin)),
                f"K1 {label} {dn}: two launches differ")
            merged = M._merge_heads(out)
            if dt == torch.bfloat16:
                check(out.transpose(1, 2).is_contiguous()
                      and merged.data_ptr() == out.data_ptr(),
                      f"K1 {label}: output not token-major, or merging "
                      f"the heads copied it")
            t_k = time_ms(lambda: FA.flash_attention_rope(
                q, k, v, cos, sin, cos, sin))
            t_p = time_ms(lambda: FA.flash_attention_rope_ref(
                q, k, v, cos, sin, cos, sin))
            qc, kc, vc = (t.contiguous() for t in (q, k, v))
            t_f = (time_ms(lambda: FA.first_design_rope(
                qc, kc, vc, cos, sin, cos, sin))
                if dt == torch.bfloat16 else t_k)
            qr = (FA.rope_rotate(q.float(), cos[:, None], sin[:, None])
                  .to(dt))
            kr = (FA.rope_rotate(k.float(), cos[:, None], sin[:, None])
                  .to(dt))
            t_l = time_ms(lambda: F.scaled_dot_product_attention(qr, kr, vc))
            flops = 4.0 * b * h * n * n * 64
            nbytes = 4 * b * h * n * 64 * q.element_size() + 4 * b * n * 64 * 4
            bnd, by = bound_ms(flops, nbytes, dn)
            rows = FA.BLOCK_Q
            log(f"K1 {label:13s} ({b},{h},{n},64) {dn:8s} err {err:.2e} "
                f"kernel {t_k:.4f} ms (first design {t_f:.4f}) plain "
                f"{t_p:.4f} ms sdpa {t_l:.4f} ms bound {bnd * 1e3:.2f} us "
                f"({by}) calls/frame {calls} calls/event {event_calls}"
                + (f" blocks {b * h * -(-n // rows)} of {rows} q rows"
                   if dt == torch.bfloat16 else ""))
            if dt == torch.bfloat16:
                acc = per_frame["K1"]
                for key, val in (("ms", t_k), ("first_ms", t_f),
                                 ("plain_ms", t_p), ("library_ms", t_l),
                                 ("bound_ms", bnd)):
                    acc[key] += calls * val
                acc["by"] = by
            per_frame["K1"]["err"] = max(per_frame["K1"]["err"], err)

    per_frame["K3"] = phase_k3(torch, g)

    tf32_round_check(torch)
    f32_frame = k2_f32_frame()
    for hh, ww, cin, cout, has_bias, calls in k2_cases():
        for dt in (torch.bfloat16, torch.float32):
            dn = str(dt).split(".")[-1]
            first = "mma" if dt == torch.bfloat16 else "fma"
            for bsz in (1, 2):
                x = torch.randn(bsz, hh, ww, cin, generator=g, device=dev)
                w = torch.randn(3, 3, cin, cout, generator=g, device=dev)
                w = w * (1.0 / math.sqrt(9 * cin))
                x, w = x.to(dt), w.to(dt)
                bvec = torch.randn(cout, generator=g, device=dev).to(dt)
                path = C3.conv3x3_path(dt, cin, cout)
                splits = (C3.plan(bsz, hh, ww, cin, cout, _build_sms(torch),
                                  *C3.TILES[path]).splits
                          if path in C3.TILES else 1)
                for bias in (None, bvec):
                    before = C3.path_counters[path].launches
                    out = C3.conv3x3(x, w, bias)
                    ref = C3.conv3x3_ref(x, w, bias)
                    torch.cuda.synchronize()
                    tag = (f"K2 ({bsz},{hh},{ww},{cin}->{cout}) {dn} "
                           f"bias={bias is not None}")
                    check(C3.path_counters[path].launches == before + 1,
                          f"{tag}: did not take the {path} path")
                    err = compare(out, ref, dn, tag)
                    check(torch.equal(out, C3.conv3x3(x, w, bias)),
                          f"{tag}: two launches differ")
                    per_frame["K2"]["err"] = max(per_frame["K2"]["err"], err)
                    if dt == torch.float32:
                        f32_frame["err"] = max(f32_frame["err"], err)
                        k2_f64_guard(torch, C3, x, w, bias, out, tag,
                                     f32_frame)
                    t_k = time_ms(lambda: C3.conv3x3(x, w, bias))
                    t_f = time_ms(lambda: C3.conv3x3(x, w, bias, path=first))
                    t_p = time_ms(lambda: C3.conv3x3_ref(x, w, bias))
                    t_l = time_ms(lambda: cudnn_conv(x, w, bias))
                    flops = 2.0 * bsz * hh * ww * 9 * cin * cout
                    nbytes = (x.numel() + bsz * hh * ww * cout + w.numel()
                              + (cout if bias is not None else 0)
                              ) * x.element_size()
                    bnd, by = bound_ms(flops, nbytes, dn)
                    log(f"{tag:45s} err {err:.2e} kernel {t_k:.4f} ms "
                        f"(first design {t_f:.4f}) plain {t_p:.4f} ms "
                        f"cudnn {t_l:.4f} ms bound {bnd * 1e3:.2f} us ({by}) "
                        f"path {path} splits {splits} "
                        f"{flops / t_k * 1e-9:.0f} TFLOP/s")
                    if bsz == 1 and (bias is not None) == has_bias:
                        if dt == torch.float32:
                            k2_f32_frame_add(f32_frame, calls, flops, nbytes,
                                             t_k, t_f, t_p, t_l,
                                             prepass_ms(C3, path, w))
                            continue
                        acc = per_frame["K2"]
                        for key, val in (("ms", t_k), ("first_ms", t_f),
                                         ("plain_ms", t_p),
                                         ("library_ms", t_l),
                                         ("bound_ms", bnd)):
                            acc[key] += 2 * calls * val   # two heads
                        acc["by"] = by
    per_frame["K2 f32"] = {IMG_HW: k2_f32_frame_done(f32_frame, IMG_HW)}
    crop_errs, crop_frames = crop_kernel_checks(torch, g)
    per_frame["K2 f32"].update(crop_frames)
    for fr in per_frame["K2 f32"].values():
        per_frame["K2"]["err"] = max(per_frame["K2"]["err"], fr["err"])
    for key, err in crop_errs.items():
        per_frame[key]["err"] = max(per_frame[key]["err"], err)
    return per_frame


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------

def synthetic_frames(n_frames, hw, seed=0):
    """Smoothly shifting colour pattern in [-1, 1] (numpy, from a seed)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    freqs = rng.uniform(0.01, 0.05, (3, 2))
    phases = rng.uniform(0, 2 * np.pi, 3)
    frames = []
    for i in range(n_frames):
        x = xx + 3.0 * i
        y = yy + 1.5 * i
        chans = [np.sin(fx * x + fy * y + p)
                 for (fx, fy), p in zip(freqs, phases)]
        frames.append((0.9 * np.stack(chans, -1)).astype(np.float32))
    return frames


def main_path_run(torch, T, model, cfg, imgs, graphed, FA, C3, BA):
    """The main path once on its own keyframe buffer: mono inference of
    ``imgs[0]`` into keyframe 0, then ``FrameTracker.track`` on the rest,
    the launch counters at 0 just before and read just after. ``graphed``:
    the tracker's CUDA graph of ``track_core`` (the default) or the eager
    path. Every ``track_core`` call but a capture runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a host read inside it
    raises. Returns the recorded outputs, frame times, modes, frames,
    keyframes, launches and tracker."""
    from mast3r_slam_tpu_torch.slam.frame import KeyframeBuffer, Mode
    from mast3r_slam_tpu_torch.slam.pipeline import create_frame
    from mast3r_slam_tpu_torch.utils.tictoc import STEPS

    H, W = IMG_HW
    keyframes = KeyframeBuffer(H, W, capacity=16,
                               feat_dim=model.cfg.enc_embed_dim,
                               device="cuda")
    tracker = T.FrameTracker(model, keyframes, cfg, graphed=graphed)
    outputs = []
    core = T.track_core

    def recording_core(*a, **kw):
        graphs = kw.get("graphs")
        capture = graphs is not None and graphs.captures == 0
        torch.cuda.set_sync_debug_mode("default" if capture else "error")
        try:
            out = core(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outputs.append(out)
        return out

    T.track_core = recording_core
    frame_ms, modes, frames = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(FA, C3, BA)
    STEPS.start()
    try:
        mode = Mode.INIT
        last_T = None
        for i, img in enumerate(imgs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            frame = create_frame(i, (img + 1.0) * 0.5, T_WC=last_T,
                                 img_size=IMG_HW[1], device="cuda")
            frames.append(frame)
            if mode == Mode.INIT:
                X, C = model.inference_mono(frame)
                frame.update_pointmap(X[0], C[0])
                keyframes.append(frame)
                mode = Mode.TRACKING
                note = "init"
            else:
                new_kf, _, try_reloc = tracker.track(frame)
                if new_kf:
                    keyframes.append(frame)
                note = ("reloc" if try_reloc else
                        "new keyframe" if new_kf else "tracked")
            last_T = frame.T_WC
            torch.cuda.synchronize()
            STEPS.lap("frame: end sync")
            frame_ms.append((time.perf_counter() - t) * 1e3)
            STEPS.end_frame()
            modes.append(note)
            log(f"frame {i} ({'graphed' if graphed else 'eager'}): "
                f"{note:12s} {frame_ms[-1]:9.1f} ms  keyframes "
                f"{len(keyframes)}")
    finally:
        STEPS.stop()
        T.track_core = core
    return dict(outputs=outputs, frame_ms=frame_ms, modes=modes,
                frames=frames, keyframes=keyframes, steps=STEPS.frames,
                launches=launch_counts(FA, C3, BA), loops=loop_nodes(),
                tracker=tracker,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _fmt(v, digits):
    """A measured number, or "not measured" where there is none."""
    return "not measured" if v is None else f"{v:.{digits}f}"


def same_bits(a, b):
    """Equal shape, dtype and bits."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.view(bits[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def device_profile(torch, fn, n, frame_ms):
    """``n`` calls of ``fn`` under ``torch.profiler``: the device side a
    call (``bench/frame_profile.py::device_split``: busy ms, kernels
    counted from the device's events, in the graph replay and outside it,
    the idle time against the unprofiled ``frame_ms`` split into the gaps
    inside the replay and the rest) and the profiled wall ms a call."""
    from torch.profiler import ProfilerActivity, profile

    from mast3r_slam_tpu_torch.bench import frame_profile as FP

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    return dict(FP.device_split(prof, n, frame_ms), profiled_wall_ms=wall)


def phase_main_path(torch, FA, C3, BA):
    """The main path twice on the same frames, each from a keyframe of its
    own made the same way: ``track_core`` eagerly, then as the tracker's
    CUDA graph (the path a user runs, whose launches the table reports).
    Both take each kernel exactly as often as the path needs, every
    ``track_core`` output agrees bit for bit between them, and the
    graphed outputs kept from each frame are intact after the later
    replays; then both paths' device time a frame under the profiler."""
    from mast3r_slam_tpu_torch.bench import frame_profile as FP
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.models.inference import MASt3RInference
    from mast3r_slam_tpu_torch.slam import tracker as T
    from mast3r_slam_tpu_torch.slam.pipeline import create_frame
    from mast3r_slam_tpu_torch.utils.config import load_config

    cfg = load_config(str(ROOT / "config" / "base.yaml"))
    mcfg = M.MASt3RConfig(dtype=cfg["model"]["dtype"],
                          head_dtype=cfg["model"]["head_dtype"])
    t0 = time.perf_counter()
    params = M.prepare_params(M.init_params(mcfg, seed=0, device="cuda"),
                              mcfg)
    torch.cuda.synchronize()
    log(f"main path: ViT-L random init + prepare {time.perf_counter() - t0:.1f} s "
        f"(trunk {mcfg.dtype}, heads {mcfg.head_dtype})")
    model = MASt3RInference(params, mcfg, cfg["matching"])
    imgs = synthetic_frames(N_FRAMES, IMG_HW)
    runs = {g: main_path_run(torch, T, model, cfg, imgs, g, FA, C3, BA)
            for g in (False, True)}
    eager, graphed = runs[False], runs[True]
    want_k1 = K1_PER_PAIR * N_FRAMES
    want_k2 = K2_PER_HEAD + 2 * K2_PER_HEAD * (N_FRAMES - 1)
    for g, run in runs.items():
        tag = "graphed" if g else "eager"
        launches = run["launches"]
        k1, k2 = launches["K1"], launches["K2"]
        check(launches["K4"] == launches["K5"] == 0
              and not any(launches[f"BA {p}"] for p in BA.PATHS),
              f"a BA kernel ran on the tracking path ({tag})")
        check(not any(launches[key] for key, _ in K4P_ALL),
              f"a K4' kernel ran on the tracking path ({tag})")
        outputs = run["outputs"]
        check(len(outputs) == N_FRAMES - 1,
              f"track_core ran {len(outputs)} times, expected "
              f"{N_FRAMES - 1} ({tag})")
        for i, out in enumerate(outputs):
            for key, val in out.items():
                if val.is_floating_point():
                    check(bool(val.isfinite().all()),
                          f"track_core frame {i + 1}: {key} not finite "
                          f"({tag})")
        log(f"main path launches ({tag}): K1 {k1} (want {want_k1}), "
            f"K2 {k2} (want {want_k2})")
        check(k1 == want_k1,
              f"K1 launched {k1} times, expected {want_k1} ({tag})")
        check(k2 == want_k2,
              f"K2 launched {k2} times, expected {want_k2} ({tag})")
        paths = {p: launches[f"K2 {p}"] for p in C3.PATHS}
        log(f"main path K2 launches by path ({tag}): {paths}")
        check(paths["igemm"] == k2, "a main-path conv did not take the "
              f"implicit GEMM ({tag})")
    tracker = graphed["tracker"]
    check(tracker.graphs.captures == 1
          and tracker.graphs.replays == N_FRAMES - 2,
          f"graphed run: {tracker.graphs.captures} captures, "
          f"{tracker.graphs.replays} replays")
    want_loops = {False: 0, True: 2 * (N_FRAMES - 2)}
    for g, run in runs.items():
        check(run["loops"] == want_loops[g], f"{run['loops']} loop nodes "
              f"ran, expected {want_loops[g]} (graphed: {g})")
    check(eager["modes"] == graphed["modes"], "eager and graphed modes "
          f"differ: {eager['modes']} vs {graphed['modes']}")
    differ = [(i + 1, key) for i, (oe, og) in enumerate(zip(
        eager["outputs"], graphed["outputs"])) for key in oe
        if not same_bits(oe[key], og[key])]
    check(not differ, f"graphed track_core differs from eager at (frame, "
          f"output) {differ}")
    for key in ("T_WC", "X", "C"):
        check(same_bits(getattr(eager["keyframes"], key),
                        getattr(graphed["keyframes"], key)),
              f"the keyframe buffers' {key} differ")
    ms = {g: statistics.median(run["frame_ms"][2:])
          for g, run in runs.items()}
    # the host steps of tracked frames 2 on (frame 1 captures the graph)
    host = {g: FP.host_breakdown(run["steps"][2:], run["frame_ms"][2:])
            for g, run in runs.items()}
    log(f"main path: eager and graphed track_core equal bit for bit on "
        f"{N_FRAMES - 1} tracked frames (every output; the graphed ones "
        f"kept across later replays); no host sync inside track_core "
        f"(sync debug mode 'error'); captures {tracker.graphs.captures}, "
        f"replays {tracker.graphs.replays}, loop nodes {graphed['loops']}")

    # device time a frame: both paths on tracked frames 1-4 again
    kfs = {g: run["keyframes"] for g, run in runs.items()}
    trackers = {g: run["tracker"] for g, run in runs.items()}
    dev = {}
    for g in (False, True):
        def one(i, g=g):
            frame = create_frame(i + 1, (imgs[i + 1] + 1.0) * 0.5,
                                 T_WC=kfs[g].T_WC[0], img_size=IMG_HW[1],
                                 device="cuda")
            trackers[g].track(frame)
        dev[g] = device_profile(torch, one, PROFILED_FRAMES, ms[g])
    for g in (False, True):
        check(len(kfs[g]) == 1, "the main path added keyframes")
    check(trackers[True].graphs.captures == 1, "a profiled frame recaptured")
    log("main path: median ms/frame over frames 2-"
        f"{N_FRAMES - 1}: eager {ms[False]:.1f}, graphed {ms[True]:.1f}; "
        f"modes {graphed['modes']}; keyframes {len(graphed['keyframes'])}")
    smi = FP.smi()
    for g, tag in ((False, "eager"), (True, "graphed")):
        d = dev[g]
        log(f"main path ({tag}): device busy "
            f"{_fmt(d['busy_ms'], 2)} ms/frame (the events' durations "
            f"summed: {_fmt(d.get('busy_sum_ms'), 2)}) over "
            f"{PROFILED_FRAMES} "
            f"profiled frames ({d['profiled_wall_ms']:.1f} ms/frame under "
            f"the profiler), idle share {_fmt(d.get('idle_share'), 3)} of "
            f"the unprofiled {ms[g]:.1f} ms frame: "
            f"{_fmt(d.get('gap_in_replay_ms'), 2)} ms of gaps inside the "
            f"replay, {_fmt(d.get('gap_outside_ms'), 2)} ms outside it; "
            f"kernels/frame from device events {_fmt(d['kernels'], 1)} "
            f"({_fmt(d['replay_kernels'], 1)} in the replay, replays/frame "
            f"{_fmt(d['replays'], 2)}); peak device memory "
            f"{runs[g]['peak_gib']:.2f} GiB")
        h = host[g]
        log(f"main path ({tag}) host steps, median ms of tracked frames 2-"
            f"{N_FRAMES - 1} (host clock, no sync inside a step): "
            + ", ".join(f"{k} {v:.3f}" for k, v in h["steps"].items())
            + f"; sum {h['steps_sum_ms']:.2f} of the {h['frame_ms']:.2f} ms "
            f"frame ({h['steps_share']:.1%})")
        log(f"main path ({tag}) breakdown: " + json.dumps(
            {"smi": smi, "frame_ms": ms[g], "host": h, "device": d}))
    if not dev[True]["busy_ms"]:
        log("main path: the profiler saw no device event in the graph "
            "replays (device time not measured for the graphed path)")
    del trackers, kfs
    state = dict(cfg=cfg, model=model, keyframes=graphed["keyframes"],
                 frames=graphed["frames"], outputs=graphed["outputs"])
    return ({"K1": graphed["launches"]["K1"], "K2": graphed["launches"]["K2"],
             "K3": graphed["launches"]["K3"]}, ms[True], state)


# ---------------------------------------------------------------------------
# Phase: the backend keyframe event at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def sync_debug_error(torch, on=True):
    """Within the block, a host sync on the card raises (``torch.cuda.
    set_sync_debug_mode("error")``), unless ``on`` is False."""
    torch.cuda.set_sync_debug_mode("error" if on else "default")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def counted_call(torch, FA, C3, BA, fn, no_sync=False):
    """``fn()`` with the launch counters at 0 before and read after, timed
    from a synced card to a synced card (ms); ``no_sync``: under
    :func:`sync_debug_error`. Returns (result, launches, ms)."""
    reset_counters(FA, C3, BA)
    t0 = sync_clock(torch)
    with sync_debug_error(torch, no_sync):
        out = fn()
    ms = (sync_clock(torch) - t0) * 1e3
    launches = {k: v for k, v in launch_counts(FA, C3, BA).items()
                if v or k in ("K1", "K2", "K4", "K5")}
    return out, launches, ms


def event_edges(torch, FA, C3, BA, graph, hint, min_frac):
    """The event's two edges on ``graph``: (0, 1) with the tracker's hint
    (``match_oneway``), then (1, 2) (``match_symmetric``), each with one
    decode's K1 and two heads' K2 launches; returns each one's ms."""
    want = {"K1": K1_PER_DECODE, "K2": 2 * K2_PER_HEAD, "K2 igemm":
            2 * K2_PER_HEAD, "K4": 0, "K5": 0}
    ms = []
    for ii, jj, kw in (([0], [1], dict(init_hint=hint)), ([1], [2], {})):
        added, launches, t = counted_call(
            torch, FA, C3, BA, lambda: graph.add_factors(ii, jj, min_frac,
                                                         **kw))
        check(added, f"edge ({ii[0]}, {jj[0]}) was not added")
        check(launches == want, f"edge ({ii[0]}, {jj[0]}) launches "
              f"{launches}, expected {want}")
        ms.append(t)
    check(graph.n_edges() == 2, f"{graph.n_edges()} edges, expected 2")
    check(torch.equal(graph.idx_jj2ii[0], hint[2]),
          "the hint's j->i match was not reused verbatim")
    return ms


def event_solve(torch, FA, C3, BA, graph, T0, no_sync, replay):
    """``solve_GN_rays`` from the poses ``T0``: its launches (K4 = 1 +
    iterations, on the tensor cores), ms, poses and iterations, the
    iteration count read once, after the solve (``no_sync``: none before
    it). The K4 launches of the steps an eager loop ran masked after its
    exit are counted apart: at most ``max_iters`` less the iterations,
    none in a graph's replay (``replay``)."""
    graph.keyframes.T_WC = T0.clone()
    _, launches, ms = counted_call(torch, FA, C3, BA, graph.solve_GN_rays,
                                   no_sync)
    iters = graph.last_solve_iters
    masked = masked_launches()
    want = {"K1": 0, "K2": 0, "K4": 1 + iters, "K5": 0,
            "BA mma": 1 + iters}
    check(launches == want, f"event solve launches {launches}, expected "
          f"{want} ({iters} LM iterations)")
    spare = int(graph.cfg["max_iters"]) - iters
    check(0 <= masked <= (0 if replay else spare),
          f"event solve: {masked} masked K4 launches after {iters} LM "
          f"iterations ({'a replay' if replay else 'eager'})")
    return graph.keyframes.T_WC.clone(), iters, ms, masked


def trace_add_factors(torch, model, keyframes, cfg, min_frac):
    """One warm graphed ``add_factors`` of edge (1, 2) (symmetric, a replay
    of the decode + match graph captured before) on a factor graph of its
    own, under the profiler: the graph, the call's host ms and its device
    breakdown by kernel, source and kind."""
    from torch.profiler import ProfilerActivity, profile

    from mast3r_slam_tpu_torch.bench import trace_breakdown as TB
    from mast3r_slam_tpu_torch.slam.factor_graph import FactorGraph

    graph = FactorGraph(model, keyframes, cfg)
    replays = model.graphs.replays
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as d:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_stack=True) as prof:
            t0 = sync_clock(torch)
            added = graph.add_factors([1], [2], min_frac)
            wall = (sync_clock(torch) - t0) * 1e3
        path = str(Path(d) / "add_factors.json")
        prof.export_chrome_trace(path)
        b = TB.breakdown(path)
    check(added and graph.n_edges() == 1, "traced add_factors added no edge")
    check(model.graphs.replays == replays + 1,
          "the traced add_factors did not replay the decode + match graph")
    kinds = sum(b["by_kind"].values())
    check(abs(kinds - b["busy_ms"]) <= 0.01 * b["busy_ms"],
          f"traced add_factors: by-kind total {kinds:.4f} ms against "
          f"device busy {b['busy_ms']:.4f} ms")
    log(f"event: traced warm graphed add_factors (1, 2): host {wall:.2f} ms, "
        f"device busy {b['busy_ms']:.2f} ms, host outside device busy "
        f"{wall - b['busy_ms']:.2f} ms; {b['events']} device events, "
        f"{b['replay_events']} in the decode + match replay")
    TB.report(b, emit=log)
    return graph, dict(wall_ms=wall, busy_ms=b["busy_ms"],
                       outside_ms=wall - b["busy_ms"], events=b["events"],
                       replay_events=b["replay_events"],
                       by_kind=b["by_kind"],
                       by_source=dict(list(b["by_source"].items())[:25]))


def phase_event(torch, FA, C3, BA, state):
    """Frames 1 and 2 of the main path become keyframes 1 and 2; edge
    (0, 1) reuses frame 1's recorded ``track_core`` match as the 5-tuple
    hint (``match_oneway``), edge (1, 2) takes the symmetric path; then the
    measured channels and ``solve_GN_rays``, twice from the same poses.
    Eagerly (``graphed=False`` model and factor graph) and graphed (the
    CLI's default: the first call of each decode + match and of the solve
    captures, the second replays; a second factor graph replays the
    decode + match): matches, Q, channels, poses and iterations bit for
    bit, the exact K1 / K2 / K4 launches of each part, one capture per
    batch size and per solve bucket, and every solve but the capture
    under sync debug mode "error" (its only host read the iteration
    count, afterwards). Random weights leave every confidence under
    ``Q_conf``, so K4 builds systems of zeros here; the oracle phase
    holds the graphed solve on real input."""
    from mast3r_slam_tpu_torch.models.inference import MASt3RInference
    from mast3r_slam_tpu_torch.slam.factor_graph import FactorGraph

    cfg, keyframes, frames = state["cfg"], state["keyframes"], state["frames"]
    model = state["model"]
    out1 = state["outputs"][0]            # frame 1 tracked against kf 0
    check(len(keyframes) == 1, "the main path added keyframes")
    keyframes.append(frames[1])
    keyframes.append(frames[2])
    T0 = keyframes.T_WC.clone()
    hint = (0, 1, out1["idx_f2k"][0], out1["valid_match"], out1["Qk"])
    min_frac = float(cfg["local_opt"]["min_match_frac"])
    eager_model = MASt3RInference(model.params, model.cfg, model.match_cfg,
                                  graphed=False)
    check(model.graphs is not None and model.graphs.captures == 0,
          "the main path's model already holds decode + match graphs")
    paths = {}
    for tag, m, graphed in (("eager", eager_model, False),
                            ("graphed", model, True)):
        keyframes.T_WC = T0.clone()       # the matcher inits read the poses
        graph = FactorGraph(m, keyframes, cfg, graphed=graphed)
        ms = event_edges(torch, FA, C3, BA, graph, hint, min_frac)
        if graphed:               # the decode + match graphs replayed
            again = FactorGraph(m, keyframes, cfg)
            ms_again = event_edges(torch, FA, C3, BA, again, hint, min_frac)
            traced, traced_rec = trace_add_factors(torch, m, keyframes, cfg,
                                                   min_frac)
        _, _, ms_meas = counted_call(torch, FA, C3, BA,
                                     lambda: graph._ensure_meas("rays"))
        solves = [event_solve(torch, FA, C3, BA, graph, T0,
                              no_sync=not graphed or k > 0,
                              replay=graphed and k > 0)
                  for k in range(2)]
        paths[tag] = dict(graph=graph, ms=ms, ms_meas=ms_meas, solves=solves,
                          again=again if graphed else None,
                          ms_again=ms_again if graphed else None)
    keyframes.T_WC = paths["graphed"]["solves"][0][0].clone()
    e, g = paths["eager"], paths["graphed"]
    fields = ("idx_ii2jj", "idx_jj2ii", "valid_match_j", "valid_match_i",
              "Q_ii2jj", "Q_jj2ii")
    for other in (g["graph"], g["again"]):
        for key in fields:
            check(same_bits(getattr(e["graph"], key), getattr(other, key)),
                  f"event: graphed {key} differs from eager")
    for a, b in zip(e["graph"]._meas_ij + e["graph"]._meas_ji,
                    g["graph"]._meas_ij + g["graph"]._meas_ji):
        check(same_bits(a, b), "event: graphed channels differ from eager")
    # the traced call's edge is edge 1 of the untraced graphs
    for key in fields:
        check(same_bits(getattr(traced, key)[0], getattr(g["again"], key)[1]),
              f"event: the traced add_factors' {key} differs from the "
              "untraced call's")
    traced._ensure_meas("rays")
    for a, b in zip(traced._meas_ij + traced._meas_ji,
                    g["graph"]._meas_ij + g["graph"]._meas_ji):
        check(same_bits(a[0], b[1]), "event: the traced add_factors' "
              "channels differ from the untraced call's")
    traced_rec["untraced_ms"] = g["ms_again"][1]
    log(f"event: the traced add_factors' matches, Q and channels equal the "
        f"untraced call's bit for bit (untraced warm call "
        f"{g['ms_again'][1]:.2f} ms, traced {traced_rec['wall_ms']:.2f} ms)")
    (T_e, it_e, _, _), (T_e2, it_e2, _, _) = e["solves"]
    for T_x, it_x in [(T_e2, it_e2)] + [(t, i) for t, i, _, _ in
                                        g["solves"]]:
        check(same_bits(T_e, T_x) and it_x == it_e,
              f"event solve: poses / iterations {it_x} differ from eager's "
              f"({it_e})")
    for t in (T_e, g["graph"].Q_ii2jj, g["graph"].Q_jj2ii,
              *g["graph"]._meas_ij, *g["graph"]._meas_ji):
        check(bool(t.float().isfinite().all()), "event output not finite")
    for idx in (g["graph"].idx_ii2jj, g["graph"].idx_jj2ii):
        check(int(idx.min()) >= 0 and int(idx.max()) < IMG_HW[0] * IMG_HW[1],
              "match index out of range")
    mg, sg = model.graphs, g["graph"].graphs
    check((mg.captures, mg.replays) == (2, 3),
          f"decode + match graphs: {mg.captures} captures, {mg.replays} "
          "replays, expected 2 (one-way and symmetric at B = 1) and 3 (the "
          "second factor graph's two, the traced add_factors' one)")
    check((sg.captures, sg.replays) == (1, 1),
          f"solve graphs: {sg.captures} captures, {sg.replays} replays, "
          "expected 1 (bucket 8) and 1")
    pools = {k: round(sum(c.pool_bytes().values()) / 2**30, 3)
             for k, c in (("match", mg), ("solve", sg))}
    pools["solve_buffers"] = round(g["graph"].bucket_bytes() / 2**30, 3)
    masked = {tag: [s[3] for s in p["solves"]] for tag, p in paths.items()}
    ms = {tag: dict(oneway=p["ms"][0], symmetric=p["ms"][1],
                    premeas=p["ms_meas"], solve=p["solves"][0][2],
                    solve_warm=p["solves"][1][2])
          for tag, p in paths.items()}
    ms["graphed"].update(oneway_warm=g["ms_again"][0],
                         symmetric_warm=g["ms_again"][1])
    log(f"event: eager and graphed equal bit for bit (matches, Q, "
        f"channels, poses, {it_e} LM iterations, E = 4 two-way edges in a "
        f"bucket of 8); captures decode + match {mg.captures}, solve "
        f"{sg.captures}; graph pools and the solve's edge buffers {pools} "
        f"GiB; K4 launches in masked steps (eager / graphed, two solves "
        f"each) {masked['eager']} / {masked['graphed']}")
    log("event ms (eager / graphed first call, with the capture / graphed "
        f"warm, a replay): match_oneway {ms['eager']['oneway']:.1f} / "
        f"{ms['graphed']['oneway']:.1f} / {ms['graphed']['oneway_warm']:.1f}"
        f"; match_symmetric {ms['eager']['symmetric']:.1f} / "
        f"{ms['graphed']['symmetric']:.1f} / "
        f"{ms['graphed']['symmetric_warm']:.1f}; decode+match "
        f"{ms['eager']['oneway'] + ms['eager']['symmetric']:.1f} / "
        f"{ms['graphed']['oneway'] + ms['graphed']['symmetric']:.1f} / "
        f"{ms['graphed']['oneway_warm'] + ms['graphed']['symmetric_warm']:.1f}"
        f"; solve {ms['eager']['solve']:.1f} / {ms['graphed']['solve']:.1f}"
        f" / {ms['graphed']['solve_warm']:.1f} (eager warm "
        f"{ms['eager']['solve_warm']:.1f}); premeas "
        f"{ms['eager']['premeas']:.1f} / {ms['graphed']['premeas']:.1f}")
    return dict(K4=1 + it_e, ms=ms, pools=pools, iters=it_e, masked=masked,
                add_factors_trace=traced_rec)


# ---------------------------------------------------------------------------
# Phase: K4 / K5 against their plain versions
# ---------------------------------------------------------------------------

def oracle_channels(torch, hw=IMG_HW, steps=(2, 1), dev="cuda"):
    """Measured channels of four edges among three oracle keyframes at
    ``hw`` (ground-truth correspondences), at each pixel_step of
    ``steps``, for the ray and the calibrated residual, and the true
    poses, on ``dev``."""
    import numpy as np

    from mast3r_slam_tpu_torch.ops import geometry
    from mast3r_slam_tpu_torch.slam import factor_graph as FG
    from mast3r_slam_tpu_torch.utils.oracle_scene import OracleScene

    scene = OracleScene(seed=0)
    poses = oracle_trajectory()[0:9:4]
    K = scene.intrinsics(hw)
    maps = [scene.raycast(T, K, hw) for T in poses]
    edges = [(0, 1), (1, 0), (1, 2), (2, 1)]
    idx, valid = [], []
    for i, j in edges:
        p_, ok = scene.project(scene.world_to_cam(maps[j][1], poses[i]), K,
                               hw)
        idx.append(p_)
        valid.append(ok[:, None])
    n = hw[0] * hw[1]
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    X = torch.as_tensor(np.stack([m[0] for m in maps]), device=dev)
    Xc = geometry.constrain_points_to_ray(hw, X, Kt)
    args = dict(ii=torch.tensor([e[0] for e in edges], device=dev),
                jj=torch.tensor([e[1] for e in edges], device=dev),
                idx_ii2jj=torch.as_tensor(np.stack(idx), device=dev),
                valid_match=torch.as_tensor(np.stack(valid), device=dev),
                Q=torch.full((4, n, 1), 2.0, device=dev))
    C = torch.ones(3, n, 1, device=dev)
    meas = {}
    for ps in steps:
        meas["rays", n // ps] = FG.precompute_meas_rays(
            X, C, **args, C_thresh=0.0, Q_thresh=1.5, pixel_step=ps)
        meas["calib", n // ps] = FG.precompute_meas_calib(
            Xc, C, **args, W_img=hw[1], z_eps=1e-6, C_thresh=0.0,
            Q_thresh=1.5, pixel_step=ps)
    T = torch.as_tensor(np.stack(poses), device=dev)
    return meas, T, args["ii"], args["jj"], Kt


def compare_gram(BA, out, ref, dtype_name, what):
    """``gram_error(out, ref) <= GRAM_TOL``; returns (max abs error, that
    relative error)."""
    check(bool(out.isfinite().all()), f"{what}: non-finite Gram")
    rel = BA.gram_error(out, ref)
    check(rel <= GRAM_TOL[dtype_name],
          f"{what}: Gram entry error {rel:.3e} of its rows' scale > "
          f"{GRAM_TOL[dtype_name]:.0e}")
    return (out - ref).abs().max().item(), rel


def planted_faults_caught(BA, kind, G):
    """The comparison rejects a Gram whose smallest residual channel (the
    distance rows 24-31 of K4, the log-depth rows 16-23 of K5) is dropped
    or has its rho sign flipped; returns the smallest error it reported."""
    lo = 24 if kind == "rays" else 16
    errs = []
    for fault in ("dropped", "rho negated"):
        bad = G.clone()
        if fault == "dropped":
            bad[:, lo:lo + 8] = 0.0
            bad[:, :, lo:lo + 8] = 0.0
        else:
            bad[:, lo + 7] *= -1.0
            bad[:, :, lo + 7] *= -1.0
        err = BA.gram_error(bad, G)
        hidden = (bad - G).abs().max().item() / G.abs().max().item()
        log(f"planted fault: {kind} rows {lo}-{lo + 7} {fault}: Gram error "
            f"{err:.3e} (abs err / max|G| {hidden:.2e})")
        check(err > 100 * max(GRAM_TOL.values()),
              f"a {kind} Gram with rows {lo}-{lo + 7} {fault} passes")
        errs.append(err)
    return min(errs)


def gram_case(torch, kind, base, T, ii, jj, K, E, dt, seed):
    """Edges 0..E-1 cycle over the four base edges; each copy gets its own
    perturbed poses, so every edge's relative pose differs."""
    from mast3r_slam_tpu_torch.ops import geometry, lie
    from mast3r_slam_tpu_torch.slam import factor_graph as FG

    g = torch.Generator(device="cuda").manual_seed(seed)
    reps = -(-E // 4)
    xi = 0.01 * torch.randn(reps, T.shape[0], 7, generator=g, device="cuda")
    Tp = lie.retr(T[None].expand(reps, -1, -1), xi).reshape(-1, 8)
    offs = (torch.arange(reps, device="cuda") * T.shape[0])[:, None]
    ii_e = (ii[None] + offs).reshape(-1)[:E]
    jj_e = (jj[None] + offs).reshape(-1)[:E]
    mask = torch.ones(E, device="cuda")
    extra = geometry.decompose_K(K) if kind == "calib" else ()
    _, rts = FG._rel_pose_rows(Tp, ii_e, jj_e, mask, extra=extra)
    sel = torch.arange(E, device="cuda") % 4
    meas = tuple(ch[sel].to(dt).contiguous() for ch in base)
    return rts.contiguous(), meas


def phase_ba_kernels(torch, BA):
    meas_all, T, ii, jj, K = oracle_channels(torch)
    calib_args = (IMG_HW, -10.0, 1e-6, 1.0, 10.0)
    report = {}
    for kind in ("rays", "calib"):
        fn, ref = ((BA.gram_rays, BA.gram_rays_ref) if kind == "rays"
                   else (BA.gram_calib, BA.gram_calib_ref))
        args = (0.003, 10.0) if kind == "rays" else calib_args
        rows = 32 if kind == "rays" else 24
        acc = dict(err=0.0)
        for E in GRAM_EDGES:
            for N in GRAM_PIXELS:
                for mdt in (torch.bfloat16, torch.float32):
                    rts, meas = gram_case(torch, kind, meas_all[kind, N], T,
                                          ii, jj, K, E, mdt, seed=E + N)
                    for cdt in (torch.bfloat16, torch.float32):
                        cn = str(cdt).split(".")[-1]
                        mn = str(mdt).split(".")[-1]
                        path = BA.gram_path(cdt)
                        before = BA.path_counters[path].launches
                        out = fn(rts, meas, *args, compute_dtype=cdt)
                        want = ref(rts, meas, *args, compute_dtype=cdt)
                        torch.cuda.synchronize()
                        tag = f"{kind} E={E} N={N} meas {mn} rows {cn}"
                        check(BA.path_counters[path].launches == before + 1,
                              f"{tag}: not launched on path {path}")
                        err, rel = compare_gram(BA, out, want, cn, tag)
                        check(torch.equal(out, fn(rts, meas, *args,
                                                  compute_dtype=cdt)),
                              f"{tag}: two launches differ")
                        acc["err"] = max(acc["err"], err)
                        acc["rel"] = max(acc.get("rel", 0.0), rel)
                        t_k = time_ms(lambda: fn(rts, meas, *args,
                                                 compute_dtype=cdt))
                        # the first (FMA) design on the same inputs
                        compare_gram(BA, fn(rts, meas, *args,
                                            compute_dtype=cdt, path="fma"),
                                     want, cn, f"{tag} path fma")
                        t_f = time_ms(lambda: fn(rts, meas, *args,
                                                 compute_dtype=cdt,
                                                 path="fma"))
                        if (cdt == mdt == torch.float32 and E == 128
                                and N == GRAM_PIXELS[-1]):
                            gram_f64_guard(torch, BA, kind, fn, rts, meas,
                                           args, out, tag, acc)
                        t_p = time_ms(lambda: ref(rts, meas, *args,
                                                  compute_dtype=cdt),
                                      iters=5, warmup=1)
                        S = torch.randn(E, 32, N, device="cuda").to(cdt)
                        t_l = time_ms(lambda: torch.bmm(S, S.transpose(1, 2)))
                        del S
                        nbytes = (len(meas) * E * N * meas[0].element_size()
                                  + rts.numel() * 4 + E * 32 * 32 * 4)
                        bnd, by = gram_bound_ms(2.0 * rows * rows * N * E,
                                                nbytes, cn)
                        log(f"{'K4' if kind == 'rays' else 'K5'} {tag:42s} "
                            f"Gram err {rel:.2e} kernel ({path}) {t_k:.4f} "
                            f"ms first (fma) {t_f:.4f} ms plain {t_p:.4f} ms "
                            f"bmm (Gram only) {t_l:.4f} ms bound "
                            f"{bnd * 1e3:.2f} us ({by})")
                        if (N == GRAM_PIXELS[-1] and mdt == cdt
                                == torch.float32 and E in GRAM_REPORT_EDGES):
                            sfx = "" if E == GRAM_REPORT[0] else f"_e{E}"
                            acc.update({f"f32_ms{sfx}": t_k,
                                        f"f32_first_ms{sfx}": t_f,
                                        f"f32_plain_ms{sfx}": t_p,
                                        f"f32_library_ms{sfx}": t_l,
                                        f"f32_bound_ms{sfx}": bnd,
                                        "f32_by": by})
                        if (N == GRAM_REPORT[1] and mdt == cdt
                                == torch.bfloat16 and E in GRAM_REPORT_EDGES):
                            sfx = "" if E == GRAM_REPORT[0] else f"_e{E}"
                            acc.update({f"ms{sfx}": t_k,
                                        f"first_ms{sfx}": t_f,
                                        f"plain_ms{sfx}": t_p,
                                        f"library_ms{sfx}": t_l,
                                        f"bound_ms{sfx}": bnd, "by": by})
                            if E == GRAM_REPORT[0]:
                                planted_faults_caught(BA, kind, want)
        log(f"{kind}: largest Gram error {acc['rel']:.3e} (tolerance "
            f"{GRAM_TOL})")
        report["K4" if kind == "rays" else "K5"] = acc
    for key, (err, rel) in gram_crop_checks(torch, BA).items():
        report[key]["err"] = max(report[key]["err"], err)
        report[key]["rel"] = max(report[key]["rel"], rel)
    torch.cuda.empty_cache()
    return report


def gram_bound_ms(flops, nbytes, dtype_name):
    """The Gram's bound: bf16 rows at the bf16 tensor rate; f32 rows, whose
    float32-accurate product takes two TF32 passes on the tensor cores (S
    S^T = hi hi^T + X + X^T, X = hi lo^T), at the TF32 rate; either beside
    the bytes."""
    if dtype_name == "bfloat16":
        return bound_ms(flops, nbytes, dtype_name)
    t_ops = 2.0 * flops / PEAK_TF32
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def gram_f64_guard(torch, BA, kind, fn, rts, meas, args, out, tag, acc):
    """The f32-row Gram's error against the float64 Gram of the same f32
    rows (``gram_error``) is at most ``F64_GUARD`` times the first (fma)
    design's on the same inputs."""
    rows = (BA.rays_rows(rts, meas, *args) if kind == "rays"
            else BA.calib_rows(rts, meas, *args))
    S = torch.stack(rows, dim=1).double()
    del rows
    G64 = S @ S.transpose(1, 2)
    del S
    first = fn(rts, meas, *args, compute_dtype=torch.float32, path="fma")
    e_new = BA.gram_error(out, G64)
    e_first = BA.gram_error(first, G64)
    log(f"{tag}: Gram error against float64 {e_new:.3e}, first design's "
        f"{e_first:.3e}")
    check(e_new <= F64_GUARD * e_first,
          f"{tag}: float64 Gram error {e_new:.3e} > {F64_GUARD:g} x the "
          f"first design's {e_first:.3e}")
    acc["f32_err64"] = e_new
    acc["f32_err64_first"] = e_first
    del G64
    torch.cuda.empty_cache()


def gram_crop_checks(torch, BA):
    """K4 and K5 against their plain versions at the pixel counts of
    ``EVAL_CROPS`` at pixel_step 1 with ``EVAL_GRAM_EDGES`` edges, on
    oracle channels rendered at each crop, in every channel and row dtype
    (the evaluation configs take f32 and f32, the 3xTF32 path). Checks only;
    returns (max abs error, Gram error) of each kernel."""
    errs = {"K4": (0.0, 0.0), "K5": (0.0, 0.0)}
    n_checks = 0
    for hw in EVAL_CROPS:
        meas_all, T, ii, jj, K = oracle_channels(torch, hw, steps=(1,))
        N = hw[0] * hw[1]
        for kind in ("rays", "calib"):
            key = "K4" if kind == "rays" else "K5"
            fn, ref = ((BA.gram_rays, BA.gram_rays_ref) if kind == "rays"
                       else (BA.gram_calib, BA.gram_calib_ref))
            args = ((0.003, 10.0) if kind == "rays"
                    else (hw, -10.0, 1e-6, 1.0, 10.0))
            for E in EVAL_GRAM_EDGES:
                for mdt in (torch.float32, torch.bfloat16):
                    rts, meas = gram_case(torch, kind, meas_all[kind, N], T,
                                          ii, jj, K, E, mdt, seed=E + N)
                    for cdt in (torch.float32, torch.bfloat16):
                        cn = str(cdt).split(".")[-1]
                        mn = str(mdt).split(".")[-1]
                        path = BA.gram_path(cdt)
                        before = BA.path_counters[path].launches
                        out = fn(rts, meas, *args, compute_dtype=cdt)
                        want = ref(rts, meas, *args, compute_dtype=cdt)
                        torch.cuda.synchronize()
                        tag = f"{key} {kind} E={E} N={N} meas {mn} rows {cn}"
                        check(BA.path_counters[path].launches == before + 1,
                              f"{tag}: not launched on path {path}")
                        err, rel = compare_gram(BA, out, want, cn, tag)
                        check(torch.equal(out, fn(rts, meas, *args,
                                                  compute_dtype=cdt)),
                              f"{tag}: two launches differ")
                        errs[key] = (max(errs[key][0], err),
                                     max(errs[key][1], rel))
                        n_checks += 1
    log(f"K4 / K5 at the evaluation crops {EVAL_CROPS}, E in "
        f"{EVAL_GRAM_EDGES}: {n_checks} checks against the plain versions, "
        f"largest Gram errors K4 {errs['K4'][1]:.2e}, K5 {errs['K5'][1]:.2e} "
        f"(tolerance {GRAM_TOL})")
    return errs


# ---------------------------------------------------------------------------
# Phase: K4', the Gram microbenchmark's four kernels, and the benchmark
# ---------------------------------------------------------------------------

# (E, N) of the K4' checks; the second is the production shape, the table's
K4P_SHAPES = ((16, 98_304), (128, 98_304))
# f32 operations a pixel of K4's 32 rows take on the CUDA cores: transform
# 18, norm and rays 10, residuals and sqrt(conf) 6, per residual channel
# Huber and weight 7 and the 8 rows 19 (x 4), the rows' sum 31
ROWS_FLOPS = 169
K4P_SUM_TOL = 1e-5      # of the sum of |terms|, float64


def k4p_case(torch, GV, BA, name, rts, meas, sig):
    """One K4' kernel against its plain version; returns (max abs error,
    kernel ms, plain ms, library ms or None, bound ms, bound by)."""
    bf16 = torch.bfloat16
    E, N = meas[0].shape
    fn = getattr(GV, f"gram_{name}")
    ref = getattr(GV, f"gram_{name}_ref")
    args = (rts, meas) if name == "load" else (rts, meas, *sig)
    sums = name in ("load", "rows", "rows_fast")
    kw = {} if sums else dict(compute_dtype=bf16)
    out = fn(*args, **kw)
    want = ref(*args, **kw)
    torch.cuda.synchronize()
    tag = f"K4' {name} E={E} N={N}"
    check(bool(out.isfinite().all()), f"{tag}: non-finite output")
    if sums:
        scale = GV.abs_sum(*args)
        rel = ((out.double() - want.double()).abs() / scale).max().item()
        check(rel <= K4P_SUM_TOL, f"{tag}: error {rel:.3e} of the sum of "
              f"|terms| > {K4P_SUM_TOL:.0e}")
        err = (out.double() - want.double()).abs().max().item()
        del scale
    else:
        err, rel = compare_gram(BA, out, want, "bfloat16", tag)
    check(torch.equal(out, fn(*args, **kw)), f"{tag}: two launches differ")
    t_k = time_ms(lambda: fn(*args, **kw))
    t_p = time_ms(lambda: ref(*args, **kw), iters=5, warmup=1)
    t_l = None
    if name == "load":
        stack = torch.stack(meas)
        t_l = time_ms(lambda: torch.sum(stack, dim=(0, 2),
                                        dtype=torch.float32))
        del stack
    elif name in ("diag", "one_product"):
        rows, k = (8, 4 * N) if name == "diag" else (32, N)
        S = torch.randn(E, rows, k, device="cuda").to(bf16)
        t_l = time_ms(lambda: torch.bmm(S, S.transpose(1, 2)))
        del S
    out_floats = out.numel()
    nbytes = (8 * E * N * meas[0].element_size() + rts.numel() * 4
              + out_floats * 4)
    t_bytes = nbytes / PEAK_BYTES
    t_f32 = (8 if name == "load" else ROWS_FLOPS) * E * N / PEAK_FLOPS[
        "float32"]
    mma = {"diag": 4 * 2 * 8 * 8, "one_product": 2 * 32 * 32}.get(name, 0)
    t_mma = mma * E * N / PEAK_FLOPS["bfloat16"]
    bnd = max(t_bytes, t_f32, t_mma) * 1e3
    by = "bytes" if t_bytes >= max(t_f32, t_mma) else "operations"
    lib = "none" if t_l is None else f"{t_l:.4f} ms"
    what = "of sum|terms|" if sums else "Gram"
    log(f"{tag:30s} error {rel:.2e} ({what}; abs {err:.3e}) kernel "
        f"{t_k:.4f} ms plain {t_p:.4f} "
        f"ms library {lib} bound {bnd * 1e3:.2f} us ({by})")
    return err, t_k, t_p, t_l, bnd, by


def rows_sass_per_pixel(GV):
    """SASS instructions a pixel of K4'b's loop (bf16 channels, vector
    path) and of its first design's, and the new loop's slow-path call
    sites (``bench/sass_count.py``)."""
    from mast3r_slam_tpu_torch import _build
    from mast3r_slam_tpu_torch.bench import sass_count as SC

    rows = SC.report(_build.library_path(GV.KERNEL))
    vp = GV.vec_pixels(1, True)
    out = {}
    for key, name, pixels in (
            ("new", f"rows_kernel<(bool)1, (int){vp}, (bool)0>", vp),
            ("first", "reduce_kernel<(bool)1, (bool)1, (int)8>", 8)):
        (r,) = [r for r in rows if name in r["kernel"]]
        loop = max(r["loops"], key=lambda lp: lp["length"])
        out[key] = loop["length"] / pixels
        out[f"{key}_slow"] = loop["slow"]
    return out


def rows_bitwise(torch, GV, rts, meas, sig):
    """K4'b against its first kernel on the benchmark's inputs with every
    confidence 0 but one random pixel an edge: each edge's sum is that
    pixel's 32 rows, so the two must be equal whatever their order."""
    E = meas[0].shape[0]
    one, _ = GV.one_live_pixel(meas, seed=8)
    out = GV.gram_rows(rts, one, *sig)
    first = GV.gram_rows_first(rts, one, *sig)
    torch.cuda.synchronize()
    check(bool((out != 0).all()), f"K4'b one live pixel E={E}: a zero sum")
    check(torch.equal(out, first), f"K4'b one live pixel E={E}: "
          f"{int((out != first).sum())} edges differ from the first kernel")


def phase_gram_bench(torch, FA, C3, BA):
    """K4' (``ops/gram_variants.py``) against its plain versions on the
    benchmark's inputs at ``K4P_SHAPES`` with bf16 channels and rows, with
    times, and K4'c / K4'd against K4 on the same inputs; then the
    benchmark itself (its default run and ``--r2``) with
    every launch counter at 0 before and read after, and its agreement
    lines against ``GRAM_TOL``."""
    from mast3r_slam_tpu_torch.bench import gram_kernel_bench as GB
    from mast3r_slam_tpu_torch.ops import gram_variants as GV

    sig = (GB.SIGMA_RAY, GB.SIGMA_DIST)
    report = {}
    for E, N in K4P_SHAPES:
        rts, meas = GB.make_inputs(E, N, "cuda")
        for key, name in K4P_ALL:
            err, t_k, t_p, t_l, bnd, by = k4p_case(torch, GV, BA, name, rts,
                                                   meas, sig)
            row = report.setdefault(key, dict(err=0.0))
            row["err"] = max(row["err"], err)
            if (E, N) == K4P_SHAPES[-1]:
                row.update(ms=t_k, plain_ms=t_p, library_ms=t_l,
                           bound_ms=bnd, by=by)
        # K4'b's first kernel in the same run, and their rows bit for bit
        t_first = time_ms(lambda: GV.gram_rows_first(rts, meas, *sig))
        log(f"K4' rows E={E} N={N}: first kernel {t_first:.4f} ms")
        report["K4'b"]["first_ms"] = t_first
        rows_bitwise(torch, GV, rts, meas, sig)
        log(f"K4' rows E={E} N={N}: one live pixel an edge, equal to the "
            f"first kernel bit for bit")
        # K4'c / K4'd with bf16 rows run K4's kernel on K4's rows with other
        # tiles: against K4's diagonal-block sum and K4 itself
        G4 = BA.gram_rays(rts, meas, *sig)
        for key, name, want in (("K4'c", "diag", GB.diag_blocks(G4)),
                                ("K4'd", "one_product", G4)):
            a = GB.agreement(getattr(GV, f"gram_{name}")(rts, meas, *sig),
                             want)
            what = "diagonal-block sum" if name == "diag" else "Gram"
            log(f"K4' {name} E={E} N={N} vs K4's {what}: gram_error "
                f"{a['gram_error']:.3e} (max abs {a['max_abs']:.3e} of "
                f"{a['scale']:.3e})")
            check(a["gram_error"] <= GRAM_TOL["bfloat16"],
                  f"K4' {name} E={E} vs K4: Gram error "
                  f"{a['gram_error']:.3e} > {GRAM_TOL['bfloat16']:.0e}")
            report[key]["vs_k4"] = max(report[key].get("vs_k4", 0.0),
                                       a["gram_error"])
        del rts, meas, G4
        torch.cuda.empty_cache()

    reset_counters(FA, C3, BA)
    default = GB.main([])
    r2 = GB.main(["--r2"])
    torch.cuda.synchronize()
    launches = launch_counts(FA, C3, BA)
    per_call = 3 + 20                     # the benchmark's warm-up + reps
    # v0 and v3's check (default); the sweep and v0 with v2c's check (--r2)
    mma = 2 * (per_call + 1) + per_call * len(r2.get("grid", {}))
    want = {key: 0 for key in launches}
    want.update({"K4'a": per_call, "K4'b": per_call, "K4'b-fast": per_call,
                 "K4'c": per_call + 1, "K4'd": per_call + 1,
                 "K4": per_call + mma, "BA fma": per_call, "BA mma": mma})
    log(f"gram bench launches: {launches} (want {want})")
    check(launches == want, "gram bench launch counts")
    for what, a in (("v3 vs v0", default["v3_vs_v0"]),
                    ("v2c vs v0", r2["v2c_vs_v0"])):
        check(a["gram_error"] <= GRAM_TOL["bfloat16"],
              f"gram bench {what}: Gram error {a['gram_error']:.3e} > "
              f"{GRAM_TOL['bfloat16']:.0e}")
    sweep = {f"{g[0]}x{g[1]}": round(t, 4)
             for g, t in r2.get("grid", {}).items()}
    log(f"gram bench (E = {GB.EDGES}, N = {GB.PIXELS}, bf16): v1 load "
        f"{default['ms']['v1']:.4f} ms, v2 rows {default['ms']['v2']:.4f}, "
        f"v2f rows on the mma path's arithmetic "
        f"{default['ms']['v2f']:.4f}, v3 diag {default['ms']['v3']:.4f}, "
        f"v0f (K4, fma) {default['ms']['v0f']:.4f}, v0 (K4, mma) "
        f"{default['ms']['v0']:.4f}; v2c one product "
        f"{r2['ms']['v2c']:.4f} vs v0 {r2['ms']['v0']:.4f}; K4 grid sweep "
        f"{sweep}; agreement v3 vs v0 "
        f"{default['v3_vs_v0']['gram_error']:.2e}, "
        f"v2c vs v0 {r2['v2c_vs_v0']['gram_error']:.2e} (gram_error)")
    for key, _ in K4P:
        report[key]["launches"] = launches[key]
    sass = rows_sass_per_pixel(GV)
    log(f"K4'b SASS a pixel (bf16 channels): {sass['new']:.1f} "
        f"({sass['new_slow']} slow-path call sites in the loop), first "
        f"kernel {sass['first']:.1f} ({sass['first_slow']})")
    check(sass["new_slow"] == 0, "K4'b's loop has slow-path call sites")
    report["K4'b"]["sass"] = sass["new"]
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# Phase: the backend speed tools (bench/bench_ba.py, ba_solve_microbench.py,
# profile_backend_decode.py, trace_breakdown.py)
# ---------------------------------------------------------------------------

# bench_ba's runs: rays with bf16 and f32 rows, calibrated with bf16 rows
BA_BENCH_RUNS = (("rays bf16", "bfloat16", False),
                 ("rays f32", "float32", False),
                 ("calib bf16", "bfloat16", True))
MICRO_H_TOL = 1e-4          # incidence vs scatter assembly, of max |H|
MICRO_RESIDUAL_TOL = 1e-3   # _solve_system's residual, of |g|


def check_ba_bench(rec, tag, paths):
    """Every solve of a ``bench_ba`` run: ``max_iter`` LM iterations
    (``delta_thresh`` 0), K4 (rays) or K5 (calibrated) launched 1 +
    iterations times, all on the row type's path; graphed and eager poses
    equal bit for bit, finite; a positive per-iteration time."""
    kernel, other = ("K5", "K4") if rec["kind"] == "calib" else ("K4", "K5")
    path = "mma" if rec["dtype"] == "bfloat16" else "tf32"
    for mode in ("graphed", "eager"):
        s = rec[mode]
        for n in rec["iters"]:
            for it, launches in zip(s["iterations"][str(n)],
                                    s["launches"][str(n)]):
                want = {kernel: 1 + it, other: 0,
                        **{p: (1 + it if p == path else 0)
                           for p in paths}}
                check(it == n and launches == want,
                      f"bench_ba {tag} {mode}: {it} iterations of {n}, "
                      f"launches {launches}, want {want}")
        check(s["per_iter_ms"] > 0, f"bench_ba {tag} {mode}: per-iteration "
              f"{s['per_iter_ms']:.4f} ms (medians {s['median_ms']})")
    check(rec["same_bits"], f"bench_ba {tag}: graphed poses differ from "
          "eager")
    check(rec["finite"], f"bench_ba {tag}: non-finite poses")


def decode_stage_launches(cfg_head_dtype):
    """The K1 / K2 launches of each ``profile_backend_decode`` stage (K2 on
    the heads' path: ``tf32x3`` under f32 heads, else ``igemm``)."""
    path = "tf32x3" if cfg_head_dtype == "float32" else "igemm"

    def want(k1, k2):
        out = {"K1": k1, "K3": 0, "K2": k2}
        out.update({f"K2 {p}": (k2 if p == path else 0)
                    for p in ("igemm", "mma", "tf32x3", "fma")})
        return out

    from mast3r_slam_tpu_torch.bench import profile_backend_decode as PD

    counts = dict(zip(PD.STAGES, ((K1_PER_DECODE, 0), (0, K2_PER_HEAD),
                                  (K1_PER_DECODE, 2 * K2_PER_HEAD),
                                  (0, 0), (0, 0), (0, 0))))
    return {k: want(*v) for k, v in counts.items()}, want(
        K1_PER_DECODE, 2 * K2_PER_HEAD)


def phase_backend_tools(torch, FA, C3, BA):
    """The JAX repo's backend speed tools, ported (``bench/``), at their
    defaults: ``bench_ba`` at deployment scale (cap 110, 128 two-way edge
    rows x 196,608 pixels) with bf16 rows (traced), f32 rows and
    calibrated, graphed and eager; ``ba_solve_microbench`` (cap 110, E
    128); ``profile_backend_decode`` at full ViT-L width with the script's
    f32 heads and with base.yaml's bf16 heads; then ``trace_breakdown`` on
    ``bench_ba``'s trace. Each tool's own checks: see ``check_ba_bench``,
    the assemblies' agreement and the solve's residual, each decode
    stage's K1 / K2 launches, the graphed ``match_symmetric`` bit for bit
    its eager call."""
    from mast3r_slam_tpu_torch.bench import ba_solve_microbench as MB
    from mast3r_slam_tpu_torch.bench import bench_ba as BB
    from mast3r_slam_tpu_torch.bench import profile_backend_decode as PD
    from mast3r_slam_tpu_torch.bench import trace_breakdown as TB

    dev = torch.device("cuda", 0)
    out = {}
    t0 = time.perf_counter()
    ring = BB.make_ring()
    log(f"bench_ba: the keyframe ring built on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ba_") as d:
        for i, (tag, dtype, calib) in enumerate(BA_BENCH_RUNS):
            rec = BB.bench(ring, dev, dtype, calib,
                           trace_dir=d if i == 0 else None, emit=log)
            log(json.dumps(rec))
            check_ba_bench(rec, tag, BA.PATHS)
            out[tag] = rec
            torch.cuda.empty_cache()
        b = TB.breakdown(out[BA_BENCH_RUNS[0][0]]["trace"])
    del ring
    TB.report(b, emit=log)
    k4 = sum(c for _, _, c, kind, _ in b["kernels"] if kind == "K4 mma")
    if b["replay_events"]:
        check(k4 == 1 + BB.TRACE_ITERS, f"bench_ba trace: {k4} K4 kernels "
              f"in the traced {BB.TRACE_ITERS}-iteration solve")
    else:
        log("bench_ba trace: no kernel seen inside the graph replay")
    out["ba_trace"] = {k: b[k] for k in ("busy_ms", "events",
                                         "replay_events", "by_kind")}
    micro = MB.main([])
    check(micro["h_diff"] <= MICRO_H_TOL * micro["h_scale"],
          f"ba_solve_microbench: incidence vs scatter assembly "
          f"{micro['h_diff']:.3e} of max |H| {micro['h_scale']:.3e}")
    check(micro["solve_ok"] and micro["solve_residual"]
          <= MICRO_RESIDUAL_TOL * micro["g_norm"],
          f"ba_solve_microbench: _solve_system residual "
          f"{micro['solve_residual']:.3e}, |g| {micro['g_norm']:.3e}")
    check(all(math.isfinite(v) for v in micro["ms"].values()),
          f"ba_solve_microbench: times {micro['ms']}")
    out["micro"] = micro
    torch.cuda.empty_cache()
    for head in ("float32", "bfloat16"):
        rec = PD.main(["--head-dtype", head])
        stages, sym = decode_stage_launches(head)
        check(rec["launches"] == stages, f"profile_backend_decode "
              f"({head} heads): launches {rec['launches']}, want {stages}")
        m = rec["match_symmetric"]
        check(m["eager_launches"] == sym and m["replay_launches"] == sym,
              f"match_symmetric ({head} heads): launches eager "
              f"{m['eager_launches']}, replay {m['replay_launches']}, want "
              f"{sym}")
        check(m["same_bits"] and (m["captures"], m["replays"]) == (1, 4),
              f"match_symmetric ({head} heads): graphed equal to eager "
              f"{m['same_bits']}, captures {m['captures']}, replays "
              f"{m['replays']}")
        out[f"decode {head}"] = rec
        torch.cuda.empty_cache()
    summary = {tag: {mode: (round(out[tag][mode]["per_iter_ms"], 4),
                            round(out[tag][mode]["pre_ms"], 3))
                     for mode in ("graphed", "eager")}
               for tag, _, _ in BA_BENCH_RUNS}
    peaks = {tag: round(out[tag]["peak_bytes"] / 2**30, 3)
             for tag, _, _ in BA_BENCH_RUNS}
    log(f"backend tools: bench_ba (per LM iteration ms, precompute + "
        f"overhead ms) {summary}; peak GiB {peaks}; solve pool GiB "
        f"{round(out['rays bf16']['pool_bytes'] / 2**30, 3)}, edge-row "
        f"buffers GiB {round(out['rays bf16']['buffer_bytes'] / 2**30, 3)}; "
        f"microbench ms/rep {micro['ms']} ({micro['timing']}); decode + "
        f"match stages ms, f32 / bf16 heads: "
        + ", ".join(f"{s} {out['decode float32']['ms'][s]:.2f} / "
                    f"{out['decode bfloat16']['ms'][s]:.2f}"
                    for s in PD.STAGES)
        + f"; match_symmetric graphed "
        f"{out['decode float32']['match_symmetric']['ms']:.2f} / "
        f"{out['decode bfloat16']['match_symmetric']['ms']:.2f}")
    return out


# ---------------------------------------------------------------------------
# Phase: the JAX repo's last two scripts (profile_refine, debug_oracle_fail)
# ---------------------------------------------------------------------------

DEBUG_PLANTED = (12, 7)         # frames of the planted run, its NaN frame


def phase_debug_tools(torch, smi):
    """``bench/profile_refine.py`` at its 384x512 and
    ``bench/debug_oracle_fail.py`` at its 96 frames on the card (see the
    module docstring, item 20); the planted failure also on the CPU.
    Returns the layouts' ms, the failures and the tools' wall time."""
    from mast3r_slam_tpu_torch.bench import debug_oracle_fail as D
    from mast3r_slam_tpu_torch.bench import profile_refine as P

    t0 = time.perf_counter()
    records, pos = P.run(device="cuda", emit=log)
    t_refine = time.perf_counter() - t0
    n = P.HW[0] * P.HW[1]
    check(len(records) == 6 and all(r["ms"] > 0 for r in records),
          f"profile_refine: {len(records)} records")
    for name, p in pos.items():
        check(p.shape == (1, n, 2) and p.dtype == torch.int64,
              f"profile_refine {name}: positions {tuple(p.shape)}")
    a, b, d = (pos[f"{v} dil={P.DIL}"] for v in P.VARIANTS)
    check(torch.equal(a, b), "profile_refine: layouts A and B differ (the "
          "same candidates, the same product)")
    agree = float((d == a).all(-1).float().mean())
    check(agree >= 0.999, f"profile_refine: layout D agrees with A on "
          f"{agree:.5f} of the positions")
    t1 = time.perf_counter()
    run = D.run(device="cuda", emit=log)
    frames, nan_frame = DEBUG_PLANTED
    planted = D.run(frames, D.HW, "cuda", nan_frame=nan_frame, emit=log)
    t_debug = time.perf_counter() - t1
    with one_cpu_thread(torch):
        cpu = D.run(frames, D.HW, "cpu", nan_frame=nan_frame,
                    emit=lambda *a: None)
    check(planted["failure"] == cpu["failure"] == [nan_frame, 4]
          and planted["ok"] == cpu["ok"], f"debug_oracle_fail planted: card "
          f"{planted['failure']} {planted['ok']}, cpu {cpu['failure']} "
          f"{cpu['ok']}")
    flags = [[(r["lam"], r["chol"], r["acc"]) for r in o["rows"]]
             for o in (planted, cpu)]
    check(len(flags[0]) == D.LM_ROWS and flags[0] == flags[1],
          "debug_oracle_fail planted: the LM rows' flags differ, card / cpu")
    check(len(run["ok"]) >= 1 and (run["failure"] is None
                                   or len(run["rows"]) == D.LM_ROWS),
          f"debug_oracle_fail: {run['failure']}, {len(run['rows'])} rows")
    ms = {r["variant"]: r["ms"] for r in records}
    log(f"debug_tools: profile_refine ms (best of {P.REPS} graph replays) "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; layout D equal to A on {agree:.5f}; debug_oracle_fail "
        f"{D.N_FRAMES} frames: first failure {run['failure']} "
        f"({len(run['ok'])} frames tracked, {run['ms']:.0f} ms), planted "
        f"frame {nan_frame} of {frames}: {planted['failure']} as on the "
        f"CPU; tools' wall time {t_refine:.1f} + {t_debug:.1f} s; on {smi}")
    return dict(ms=ms, failure=run["failure"], frames=len(run["ok"]),
                wall_s=t_refine + t_debug)


# ---------------------------------------------------------------------------
# Phase: oracle SLAM at 384x512 (ray and calibrated BA)
# ---------------------------------------------------------------------------

def phase_oracle(torch, FA, C3, BA):
    from mast3r_slam_tpu_torch.ops import geometry
    from mast3r_slam_tpu_torch.slam import factor_graph as FG
    from mast3r_slam_tpu_torch.utils.oracle_scene import (OracleScene,
                                                          run_oracle_slam)

    poses = oracle_trajectory()
    launches = {}
    for calib in (False, True):
        kind = "calib" if calib else "rays"
        name = "K5" if calib else "K4"
        counter = BA.calib_counter if calib else BA.rays_counter
        reset_counters(FA, C3, BA)
        t0 = time.perf_counter()
        r = run_oracle_slam(OracleScene(seed=0), poses, IMG_HW, ORACLE_FAST,
                            kf_every=4, use_calib=calib, device="cuda")
        t_run = time.perf_counter() - t0
        p = r["ba_problem"]
        launches[name] = counter.launches
        check(not any(c.launches for c in k4p_counters().values()),
              f"oracle {kind}: a K4' kernel ran")
        log(f"oracle {kind}: {t_run:.1f} s, keyframes {r['kf_ids']}, "
            f"skipped {r['n_skipped']}, relocs {r['n_relocs']}, ATE track "
            f"{r['ate_track'] * 1e3:.3f} mm, ATE BA {r['ate_ba'] * 1e3:.3f} "
            f"mm, mean pixel error {r['mean_pix_err']:.3f}, {name} launches "
            f"{counter.launches}")
        check(p is not None, f"oracle {kind}: no BA edges")
        log(f"oracle {kind} BA: E = {p['ii'].numel()}, N = "
            f"{p['meas'][0].shape[1]}, LM iterations {p['iters']}")
        check(counter.launches == 1 + p["iters"],
              f"oracle {kind}: {name} launched {counter.launches} times")
        paths = {k: c.launches for k, c in BA.path_counters.items()}
        check(paths == {"mma": counter.launches, "tf32": 0, "fma": 0},
              f"oracle {kind}: bf16-row {name} launches by path {paths}")
        check(r["n_skipped"] == 0, f"oracle {kind}: skipped frames")
        check(r["ate_ba"] < 0.03, f"oracle {kind}: ATE after BA "
              f"{r['ate_ba']:.4f} m")
        check(r["ate_ba"] <= 1.05 * r["ate_track"],
              f"oracle {kind}: BA did not hold the tracked trajectory "
              f"({r['ate_ba']:.4f} vs {r['ate_track']:.4f} m)")
        check(bool(torch.isfinite(torch.as_tensor(r["T_kf_ba"])).all()),
              f"oracle {kind}: poses not finite")

        def system(dev, cdt):
            return oracle_system(p, dev, cdt, p["T"].to(dev))

        def gram(dev):
            T, ii, jj, mask = (p[k].to(dev) for k in ("T", "ii", "jj", "mask"))
            meas = tuple(ch.to(dev) for ch in p["meas"])
            sig = p["sigmas"]
            if calib:
                extra = geometry.decompose_K(p["K"].to(dev))
                _, rts = FG._rel_pose_rows(T, ii, jj, mask, extra=extra)
                return BA.gram_calib(rts, meas, p["hw"], -10.0, 1e-6, *sig,
                                     compute_dtype=torch.float32)
            _, rts = FG._rel_pose_rows(T, ii, jj, mask)
            return BA.gram_rays(rts, meas, *sig, compute_dtype=torch.float32)

        with one_cpu_thread(torch):
            g_cpu = gram("cpu")
        _, rel = compare_gram(BA, gram("cuda").cpu(), g_cpu, "float32",
                              f"oracle {kind} Gram card vs CPU")
        log(f"oracle {kind} Gram card vs CPU (f32 rows): error {rel:.3e} "
            f"of each entry's rows' scale")
        gpu = system("cuda", torch.float32)
        with one_cpu_thread(torch):
            cpu = system("cpu", torch.float32)
        for what, a, b in zip(("H", "g", "cost"), gpu, cpu):
            a, b = a.cpu(), b.cpu()
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            log(f"oracle {kind} system card vs CPU (f32 rows): {what} max "
                f"abs err {err:.3e}, max |cpu| {scale:.3e}")
            check(err <= 1e-4 * scale, f"oracle {kind}: {what} card vs CPU")
        oracle_lm_from_kick(torch, p, counter, kind,
                            [poses[f] for f in r["kf_ids"]])
        cdt = p["compute_dtype"]
        t_build = time_ms(lambda: system("cuda", cdt))
        solve = oracle_graphed_solve(torch, FA, C3, BA, p, kind)
        log(f"oracle {kind}: system build {t_build:.3f} ms per LM iteration "
            f"(rows {cdt}), whole solve eager {solve['eager_ms']:.1f} ms, "
            f"graphed first call {solve['first_ms']:.1f} ms, warm "
            f"{solve['warm_ms']:.1f} ms ({solve['iters']} iterations)")
        del r, p, gpu, cpu
    torch.cuda.empty_cache()
    return launches


def oracle_solve(p, graphs=None):
    """The oracle BA's solve (``gauss_newton_rays`` / ``_calib``) of the
    problem ``p``; with ``graphs`` as its CUDA graph (the problem's edge,
    mask and channel tensors are the graph's buffers)."""
    from mast3r_slam_tpu_torch.slam import factor_graph as FG

    args = dict(compute_dtype=p["compute_dtype"], graphs=graphs)
    if p["kind"] == "calib":
        return FG.gauss_newton_calib(
            p["T"], p["meas"], p["K"], p["ii"], p["jj"], p["mask"],
            p["free"], p["hw"], -10.0, 1e-6, *p["sigmas"], p["max_iter"],
            p["delta"], **args)
    return FG.gauss_newton_rays(
        p["T"], p["meas"], p["ii"], p["jj"], p["mask"], p["free"],
        *p["sigmas"], p["max_iter"], p["delta"], **args)


def oracle_graphed_solve(torch, FA, C3, BA, p, kind):
    """The oracle BA's solve eagerly, then as a CUDA graph (a capture and
    two replays): the same poses and iterations bit for bit, K4 / K5
    launched 1 + iterations times a solve, every solve but the capture
    under sync debug mode "error". Returns the iterations and ms."""
    from mast3r_slam_tpu_torch.ops.graphs import GraphCache

    name = "K5" if kind == "calib" else "K4"
    cache = GraphCache("solve")
    runs = []
    for graphs, no_sync in ((None, True), (cache, False), (cache, True),
                            (cache, True)):
        (T, iters), launches, ms = counted_call(
            torch, FA, C3, BA, lambda: oracle_solve(p, graphs), no_sync)
        iters = int(iters)
        check(launches[name] == 1 + iters and launches["BA mma"] == 1 + iters,
              f"oracle {kind} solve (graphed: {graphs is not None}): "
              f"launches {launches} for {iters} iterations")
        runs.append((T, iters, ms))
    for T, iters, _ in runs[1:]:
        check(same_bits(T, runs[0][0]) and iters == runs[0][1],
              f"oracle {kind}: the graphed solve ({iters} iterations) "
              f"differs from the eager one ({runs[0][1]})")
    check((cache.captures, cache.replays) == (1, 2),
          f"oracle {kind}: {cache.captures} captures, {cache.replays} "
          "replays of the solve graph")
    log(f"oracle {kind}: graphed solve equal to the eager one bit for bit "
        f"({runs[0][1]} iterations, E = {p['ii'].numel()}); graph pool "
        f"{sum(cache.pool_bytes().values()) / 2**30:.3f} GiB")
    return dict(iters=runs[0][1], eager_ms=runs[0][2], first_ms=runs[1][2],
                warm_ms=min(runs[2][2], runs[3][2]))


@contextlib.contextmanager
def one_cpu_thread(torch):
    """The CPU side of a card-vs-CPU check on one torch thread: a
    multi-threaded float32 ``torch.sqrt`` has been seen to return ~3e-4
    relative errors in its first call on some hosts, which the per-entry
    Gram comparison resolves."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def oracle_system(p, dev, cdt, T):
    """``(H, g, cost)`` of the oracle BA problem ``p`` at poses ``T``."""
    from mast3r_slam_tpu_torch.slam import factor_graph as FG

    ii, jj, mask, free = (p[k].to(dev) for k in ("ii", "jj", "mask", "free"))
    meas = tuple(ch.to(dev) for ch in p["meas"])
    if p["kind"] == "calib":
        return FG._accumulate_calib(T, meas, p["K"].to(dev), ii, jj, mask,
                                    free, T.shape[0], p["hw"], -10.0, 1e-6,
                                    *p["sigmas"], compute_dtype=cdt)
    return FG._accumulate_rays(T, meas, ii, jj, mask, free, T.shape[0],
                               *p["sigmas"], compute_dtype=cdt)


def oracle_lm_from_kick(torch, p, counter, kind, gt_kf):
    """The LM loop over the oracle BA's edges from keyframe poses moved
    ``ORACLE_KICK`` off the tracked ones, for ``ORACLE_KICK_ITERS``
    iterations with float32 rows, on the card and on the CPU. The card's run
    must accept several steps, bring the keyframes back near the truth and
    end where the CPU's run ends."""
    import numpy as np

    from mast3r_slam_tpu_torch.ops import device_loop, lie
    from mast3r_slam_tpu_torch.slam import factor_graph as FG
    from mast3r_slam_tpu_torch.utils.oracle_scene import ate_rmse_points

    rng = np.random.default_rng(7)
    free = p["free"].cpu()
    xi = torch.as_tensor(rng.normal(size=(free.numel(), 7)) * ORACLE_KICK,
                         dtype=torch.float32) * free[:, None].float()
    T0 = lie.retr(p["T"].cpu(), xi)
    cap = T0.shape[0]
    ate0 = ate_rmse_points(list(T0.numpy()), gt_kf)
    ends = {}
    for dev in ("cuda", "cpu"):
        costs = []

        def system(T):
            out = oracle_system(p, dev, torch.float32, T)
            costs.append(float(out[2]))
            return out

        counter.launches = 0
        device_loop.masked.launches = 0
        t0 = time.perf_counter()
        with one_cpu_thread(torch):
            T_out, iters = FG._lm_loop(system, T0.to(dev),
                                       p["free"].to(dev), cap,
                                       ORACLE_KICK_ITERS, 1e-12, 1e-4)
        iters = int(iters)
        t_run = (time.perf_counter() - t0) * 1e3
        # the systems of the live steps (the card's eager loop may launch
        # masked steps after the exit); one K4 / K5 launch each
        masked = len(costs) - 1 - iters
        costs = costs[:1 + iters]
        accepted = sum(c < min(costs[:k]) for k, c in enumerate(costs)
                       if k > 0)
        T_out = T_out.cpu()
        ate = ate_rmse_points(list(T_out.numpy()), gt_kf)
        log(f"oracle {kind} LM from a {ORACLE_KICK} kick on {dev}: "
            f"{iters} iterations, {accepted} accepted, cost {costs[0]:.6e} "
            f"-> {min(costs):.6e}, ATE {ate0 * 1e3:.3f} -> {ate * 1e3:.3f} "
            f"mm, {t_run:.1f} ms")
        if dev == "cuda":
            check(counter.launches == 1 + iters
                  and device_loop.masked.launches == masked,
                  f"oracle {kind} kick: {counter.launches} launches for "
                  f"{iters} iterations, {device_loop.masked.launches} in "
                  f"masked steps, {masked} systems built after the exit")
            check(accepted >= 3, f"oracle {kind} kick: {accepted} accepted "
                  f"LM steps")
            check(ate < 0.03 and ate < 0.5 * ate0,
                  f"oracle {kind} kick: ATE {ate0:.4f} -> {ate:.4f} m")
        ends[dev] = T_out
    err = (ends["cuda"] - ends["cpu"]).abs().max().item()
    log(f"oracle {kind} LM from a kick: card vs CPU poses max abs err "
        f"{err:.3e}")
    check(err <= 1e-4, f"oracle {kind} kick: card and CPU solves end "
          f"{err:.3e} apart")


def oracle_trajectory():
    from mast3r_slam_tpu_torch.utils.oracle_scene import make_trajectory

    m = ORACLE_MOTION
    return make_trajectory(ORACLE_FRAMES, rot_amp=0.06 * m,
                           trans_amp=(0.45 * m, 0.3 * m, 0.12 * m))


# ---------------------------------------------------------------------------
# Phase 4: card vs CPU at full width, reduced depth, f32
# ---------------------------------------------------------------------------

def phase_cross_check(torch):
    """The entry points' outputs on the card (kernels) and on the CPU
    (plain versions): ``inference_mono``'s (X, C) and
    ``asymmetric_inference`` of two different frames, which runs both
    decoder streams and both heads as ``track_core`` does."""
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.models.inference import MASt3RInference
    from mast3r_slam_tpu_torch.slam.pipeline import create_frame

    mcfg = M.MASt3RConfig(enc_depth=4, dec_depth=4, dtype="float32",
                          head_dtype="float32")
    params = M.prepare_params(M.init_params(mcfg, seed=1, device="cuda"),
                              mcfg)
    params_cpu = M.tree_map(lambda t: t.cpu(), params)
    img_a, img_b = synthetic_frames(2, IMG_HW, seed=3)
    results = {}
    for dev, p in (("cuda", params), ("cpu", params_cpu)):
        model = MASt3RInference(p, mcfg)
        frame_a = create_frame(0, (img_a + 1.0) * 0.5, img_size=IMG_HW[1],
                               device=dev)
        frame_b = create_frame(1, (img_b + 1.0) * 0.5, img_size=IMG_HW[1],
                               device=dev)
        X, C = model.inference_mono(frame_a)
        pts, conf, desc, desc_conf = model.asymmetric_inference(frame_a,
                                                                frame_b)
        outs = {"mono X": X, "mono C": C}
        for key, val in (("pts3d", pts), ("conf", conf), ("desc", desc),
                         ("desc_conf", desc_conf)):
            for head in (0, 1):
                outs[f"asym {key}[{head}]"] = val[head]
        results[dev] = {k: v.float().cpu() for k, v in outs.items()}
    for key, b in results["cpu"].items():
        a = results["cuda"][key]
        check(a.shape == b.shape, f"cross-check {key}: shape {tuple(a.shape)}"
              f" on the card, {tuple(b.shape)} on the CPU")
        check(bool(a.isfinite().all()), f"cross-check {key}: not finite")
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        close = torch.allclose(a, b, rtol=1e-3, atol=1e-3 * scale)
        log(f"cross-check {key:18s} max abs err {err:.3e} (max |cpu| "
            f"{scale:.3e}) rtol 1e-3 atol 1e-3*max|cpu| -> "
            f"{'ok' if close else 'FAIL'}")
        check(close, f"cross-check {key}: card and CPU disagree")


# ---------------------------------------------------------------------------
# Phases: the port's CLI end to end
# ---------------------------------------------------------------------------

CLI_FRAMES = 24                 # the clip: out 11 steps and back to the start
CLI_SRC_HW = (480, 640)         # TUM frames
CLI_STEP = (12.0, 4.0)          # pan per step, pixels (x, y)
CLI_CALIB_FRAMES = 8
CLI_THREADED_FRAMES = 12
CLI_CKPT_FRAMES = 8
# what random weights force (tests/test_e2e_smoke.py's cuts; the decoder
# streams are tied in tied_model); base.yaml's services stay as shipped
CLI_CUTS = {
    "single_thread": True,
    "tracking": {"Q_conf": 0.0, "min_match_frac": 0.0,
                 "match_frac_thresh": 0.9},
    "local_opt": {"Q_conf": 0.0, "min_match_frac": 0.0},
}
SERVICES_OFF = {"quality": {"enabled": False},
                "tsdf_refine": {"enabled": False}}
# card-vs-CPU run: encoder depth 2 and decoder depth 4, the shallowest
# decoder whose four DPT hooks (0, d/2, 3d/4, d) are distinct
CROSS_DEPTH = (2, 4)
CROSS_IMG_SIZE = 128            # 96x128 crops
CROSS_FRAMES = 8
CROSS_POSE_TOL = 1e-3
CROSS_DRIFT_TOL = 0.1
CROSS_SHARE = 0.995     # of matches, or BA channel elements, that agree
RELOC_HW = (384, 512)
RELOC_KF_X = (0.0, 0.6, 1.2, 1.8, 2.4, 3.0)
RELOC_WORDS = 64


def pan_frames(n_frames, hw, step, seed=0):
    """uint8 RGB frames ``hw`` of the ``synthetic_frames`` texture panning
    ``step`` pixels per frame out and back, so the last frame revisits the
    first."""
    import numpy as np

    rng = np.random.default_rng(seed)
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    freqs = rng.uniform(0.01, 0.05, (3, 2))
    phases = rng.uniform(0, 2 * np.pi, 3)
    for i in range(n_frames):
        p = min(i, n_frames - 1 - i)
        x, y = xx + step[0] * p, yy + step[1] * p
        chans = [np.sin(fx * x + fy * y + ph)
                 for (fx, fy), ph in zip(freqs, phases)]
        yield ((0.9 * np.stack(chans, -1) + 1.0) * 127.5).astype(np.uint8)


def write_clip(root, n_frames, seed=0):
    """A TUM-format directory of ``n_frames`` 480x640 PNGs panning
    ``CLI_STEP`` per frame out and back."""
    from mast3r_slam_tpu_torch.data import png

    root = Path(root)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    rows = []
    for i, img in enumerate(pan_frames(n_frames, CLI_SRC_HW, CLI_STEP,
                                       seed)):
        png.write_png(root / "rgb" / f"{i:04d}.png", img)
        rows.append(f"{1e9 + i / 30.0:.6f} rgb/{i:04d}.png")
    (root / "rgb.txt").write_text("# timestamp filename\n"
                                  + "\n".join(rows) + "\n")
    return root


def write_config(path, inherit="base.yaml", **over):
    """A config inheriting ``config/<inherit>`` with ``CLI_CUTS`` and
    ``over`` merged in."""
    import yaml

    from mast3r_slam_tpu_torch.utils.config import merge_config

    cfg = merge_config({"inherit": str(ROOT / "config" / inherit)},
                       merge_config(CLI_CUTS, over))
    Path(path).write_text(yaml.safe_dump(cfg))
    return str(path)


def tied_model(cfg, device, seed=0, **mcfg_over):
    """MASt3R at ``config/base.yaml``'s dtypes (or ``mcfg_over``) with
    random weights from ``seed``; the second decoder stream and head take
    the first's weights, so that a frame decoded against its keyframe
    predicts consistent geometry and tracking has input to work on."""
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.models.inference import MASt3RInference

    kw = dict(dtype=cfg["model"]["dtype"], head_dtype=cfg["model"]["head_dtype"])
    kw.update(mcfg_over)
    mcfg = M.MASt3RConfig(**kw)
    p = M.init_params(mcfg, seed=seed, device=device)
    p["dec_blocks2"] = p["dec_blocks"]
    p["head2"] = p["head1"]
    return MASt3RInference(M.prepare_params(p, mcfg), mcfg,
                           cfg.get("matching", {}))


# loop nodes a replay runs, by graph kind: the tracked frame's matcher and
# pose solve, the BA solve's LM loop (none in the pieces of a solve over
# distinct cards, whose loop runs on the host), one matcher call per
# direction and pair (the mesh's matcher: one per row of its init), none in
# a slot's decode
def graph_loops(name, key, inputs):
    if name == "match":
        if key[0] == "rows":
            return inputs[2].shape[0]
        return 2 * inputs[0].shape[0] if key[0] == "symmetric" else 1
    if name == "solve" and {"build", "sum", "propose", "accept"} & set(key):
        return 0
    return {"track": 2, "solve": 1, "decode": 0}[name]


@contextlib.contextmanager
def instrumented(torch, model):
    """Counts the model calls that launch K1/K2, the symmetric decoder
    calls (one per match_symmetric, one per backend slot on a mesh), the
    BA's solves, LM iterations and system builds (1 + iterations per
    solve, each one K4/K5 launch per slot on a mesh), the quality jobs
    submitted, the CUDA graph captures and replays by graph (``track``,
    ``solve``, ``match``; a key captured twice fails) and the loop nodes
    the replays run, and times tracked frames and the backend step's parts
    with a device sync around each."""
    import inspect

    from mast3r_slam_tpu_torch.ops import graphs as G
    from mast3r_slam_tpu_torch.services.quality_async import (
        AsynchronousQualityService)
    from mast3r_slam_tpu_torch.slam import factor_graph as FG
    from mast3r_slam_tpu_torch.slam import tracker as T
    from mast3r_slam_tpu_torch.slam.pipeline import Backend
    from mast3r_slam_tpu_torch.slam.retrieval import RetrievalDatabase

    rec = {"calls": {k: 0 for k in ("mono", "track", "oneway", "symmetric",
                                    "decodes", "solves", "lm_iters",
                                    "builds", "spare_builds",
                                    "quality_jobs")},
           "captures": {k: 0 for k in ("track", "solve", "match",
                                       "decode")},
           "replays": {k: 0 for k in ("track", "solve", "match", "decode")},
           "loops": 0, "captured": set(),
           "ms": {k: [] for k in ("track", "step", "retrieval",
                                  "add_factors", "solve")}}
    saved = []

    def patch(owner, name, wrapper):
        orig = getattr(owner, name)
        saved.append((owner, name, orig))
        setattr(owner, name, wrapper(orig))

    def counted(key):
        def wrap(fn):
            def inner(*a, **kw):
                rec["calls"][key] += 1
                return fn(*a, **kw)
            return inner
        return wrap

    def timed(key):
        def wrap(fn):
            def inner(*a, **kw):
                t0 = sync_clock(torch)
                try:
                    return fn(*a, **kw)
                finally:
                    rec["ms"][key].append((sync_clock(torch) - t0) * 1e3)
            return inner
        return wrap

    def solved(fn):
        sig = inspect.signature(fn)

        def inner(*a, **kw):
            T_out, iters = fn(*a, **kw)
            n = int(iters)
            mesh = kw.get("mesh")
            slots = 1 if mesh is None else mesh.size
            max_iter = int(sig.bind(*a, **kw).arguments["max_iter"])
            rec["calls"]["solves"] += 1
            rec["calls"]["lm_iters"] += n
            rec["calls"]["builds"] += (1 + n) * slots
            # the most builds an eager loop can run masked after its exit
            rec["calls"]["spare_builds"] += (max_iter - n) * slots
            return T_out, iters
        return inner

    def symmetric(fn):
        def inner(*a, **kw):
            rec["calls"]["symmetric"] += 1
            rec["calls"]["decodes"] += (1 if model.mesh is None
                                        else model.mesh.size)
            return fn(*a, **kw)
        return inner

    def graph_run(fn):
        def inner(self, key, run, inputs, **kw):
            before = self.captures
            out = fn(self, key, run, inputs, **kw)
            full = (id(self), key, tuple(tuple(t.shape) for t in inputs))
            if self.captures > before:
                check(full not in rec["captured"], f"{self.name} graph "
                      f"captured twice for key {key}")
                rec["captured"].add(full)
                rec["captures"][self.name] += 1
            else:
                rec["replays"][self.name] += 1
                rec["loops"] += graph_loops(self.name, key, inputs)
            return out
        return inner

    patch(model, "inference_mono", counted("mono"))
    patch(model, "match_oneway", counted("oneway"))
    patch(model, "match_symmetric", symmetric)
    patch(T, "track_core", counted("track"))
    patch(G.GraphCache, "run", graph_run)
    patch(T.FrameTracker, "track", timed("track"))
    patch(FG, "gauss_newton_rays", solved)
    patch(FG, "gauss_newton_calib", solved)
    patch(Backend, "step", timed("step"))
    patch(RetrievalDatabase, "update", timed("retrieval"))
    patch(FG.FactorGraph, "add_factors", timed("add_factors"))
    patch(FG.FactorGraph, "solve_GN_rays", timed("solve"))
    patch(FG.FactorGraph, "solve_GN_calib", timed("solve"))
    patch(AsynchronousQualityService, "submit", counted("quality_jobs"))
    try:
        yield rec
    finally:
        for owner, name, orig in reversed(saved):
            setattr(owner, name, orig)


def expected_launches(calls, calib, ba_path="mma", k2_path="igemm"):
    """Launches per kernel from the run's model calls, symmetric decoder
    calls and BA system builds. ``ba_path`` / ``k2_path``: the path every
    BA system build and every DPT conv takes (base.yaml's bf16 rows and
    heads: ``"mma"`` and ``"igemm"``; the eval configs' float32 ones:
    ``gram_path`` and ``conv3x3_path`` of float32)."""
    from mast3r_slam_tpu_torch.ops import ba_kernels as BA
    from mast3r_slam_tpu_torch.ops import conv3x3 as C3

    c = calls
    k1 = K1_PER_PAIR * (c["mono"] + c["track"]) + K1_PER_DECODE * (
        c["oneway"] + c["decodes"])
    k2 = K2_PER_HEAD * c["mono"] + 2 * K2_PER_HEAD * (
        c["track"] + c["oneway"] + c["decodes"])
    ba = c["builds"]
    out = {"K1": k1, "K2": k2, "K3": 0, "K4": 0 if calib else ba,
           "K5": ba if calib else 0}
    out.update({f"K2 {p}": k2 if p == k2_path else 0 for p in C3.PATHS})
    out.update({f"BA {p}": ba if p == ba_path else 0 for p in BA.PATHS})
    out.update({key: 0 for key, _ in K4P_ALL})  # the benchmark's alone
    return out


def check_ply(path):
    """A binary PLY's header names its vertex count and properties, and the
    file holds exactly that many records. Returns the vertex count."""
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    n = int(next(l for l in header if l.startswith("element vertex")).split()[-1])
    sizes = {"float": 4, "int": 4, "uchar": 1}
    row = sum(sizes[l.split()[1]] for l in header if l.startswith("property"))
    check(header[0] == "ply" and "binary_little_endian" in header[1],
          f"{path}: not a binary PLY")
    check(len(data) - end == n * row,
          f"{path}: {len(data) - end} bytes of records, expected {n} x {row}")
    check(n > 0, f"{path}: no vertices")
    return n


def check_outputs(out, savedir, name, n_frames, img_hw):
    """The exported trajectory, PLYs and keyframe PNGs of one CLI run."""
    import numpy as np

    from mast3r_slam_tpu_torch.data import png

    n_kf = len(out["keyframes"])
    rows = [l.split() for l in (savedir / f"{name}.txt").read_text()
            .splitlines() if l.strip()]
    traj = np.asarray(rows, np.float64)
    check(out["frames_processed"] == n_frames,
          f"{out['frames_processed']} of {n_frames} frames processed")
    check(traj.shape == (n_kf, 8),
          f"trajectory {traj.shape}, expected ({n_kf}, 8)")
    check(bool(np.isfinite(traj).all()), "non-finite exported pose")
    qn = np.linalg.norm(traj[:, 4:8], axis=1)
    check(bool(np.abs(qn - 1.0).max() < 1e-3),
          f"exported quaternion norms {qn.min():.6f}-{qn.max():.6f}")
    n_pts = check_ply(savedir / f"{name}.ply")
    n_q = check_ply(savedir / f"{name}_quality.ply")
    check(n_pts == n_q, "the two PLYs hold different point counts")
    pngs = sorted((savedir / "keyframes").glob("*.png"))
    check(len(pngs) == n_kf, f"{len(pngs)} keyframe PNGs for {n_kf} keyframes")
    for p_ in pngs:
        im = png.read_png(p_)
        check(im.shape == (*img_hw, 3), f"{p_.name}: shape {im.shape}")
    return traj, n_pts


def check_services(out, rec, tag):
    """The CLI run's services ended cleanly: every quality job processed or
    dropped, every refiner task ended, every worker stopped, and the global
    TSDF (when on) on the native hash with voxels in its volume."""
    from mast3r_slam_tpu_torch.services.native_tsdf import NativeVoxelHash

    q, ref, m = out["quality"], out["refiner"], out["tsdf_manager"]
    if q is not None:
        check(q.processed_jobs + q.dropped_jobs
              == rec["calls"]["quality_jobs"] and not q.is_alive(),
              f"cli {tag}: quality {q.processed_jobs} processed + "
              f"{q.dropped_jobs} dropped of {rec['calls']['quality_jobs']}")
    if ref.enabled:
        s = ref.stats
        check(s["refined_blocks"] + s["rejected_blocks"] == s["scheduled"]
              and not ref.is_alive(), f"cli {tag}: refiner tasks {s}")
    if m.enabled:
        check(isinstance(m.volume.hash, NativeVoxelHash),
              f"cli {tag}: the global TSDF is not on the native hash")
        check(m.volume.stats()["voxels"] > 0
              and not m.integrator.is_alive()
              and not m.opt_thread.is_alive(),
              f"cli {tag}: global TSDF {m.volume.stats()}")


def quality_fields(path):
    """The quality PLY's per-vertex fields r / delta_cov / u / priority /
    class_id."""
    import numpy as np

    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    types = {"float": "<f4", "int": "<i4", "uchar": "u1"}
    props = [l.split()[1:] for l in data[:end].decode().splitlines()
             if l.startswith("property")]
    return np.frombuffer(data[end:], dtype=[(n, types[t]) for t, n in props])


@contextlib.contextmanager
def eager_paths(model):
    """The CLI's tracker runs ``track_core`` eagerly, its factor graph its
    solves and ``model`` its decode + match (no CUDA graph): the reference
    of the graphed runs."""
    import functools

    from mast3r_slam_tpu_torch import main as cli

    saved = cli.FrameTracker, cli.FactorGraph, model.graphs
    cli.FrameTracker = functools.partial(saved[0], graphed=False)
    cli.FactorGraph = functools.partial(saved[1], graphed=False)
    model.graphs = None
    try:
        yield
    finally:
        cli.FrameTracker, cli.FactorGraph, model.graphs = saved


def run_cli(torch, FA, C3, BA, model, workdir, argv, tag, calib=False,
            ba_path="mma", k2_path="igemm", devices=None, graphed=True):
    """``main(argv)`` on the card (``devices``: the slot list of its
    topology, default the visible cards) with every launch counter at 0
    before and read after; checks the launches against the run's own model
    calls, decoder calls and system builds (on one slot: one decoder call
    per match_symmetric, 1 + iterations builds per solve), and the CUDA
    graphs: the tracker's captured once when a frame was tracked, each
    solve bucket and decode + match batch size at most once, the loop
    nodes the replays run; none with ``graphed=False``, which runs the
    tracker, the solves and the decode + match eagerly. Returns (summary,
    launches, instrumentation record)."""
    import os

    from mast3r_slam_tpu_torch import main as cli

    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        with (instrumented(torch, model) as rec, worker_faults() as faults,
              contextlib.nullcontext() if graphed else eager_paths(model)):
            reset_counters(FA, C3, BA)
            t0 = time.perf_counter()
            out = cli.main(argv, device="cuda", model=model,
                           devices=devices)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts(FA, C3, BA)
            loops = loop_nodes()
            masked = masked_launches()
    finally:
        os.chdir(cwd)
    check_no_faults(faults, f"cli {tag}")
    check_services(out, rec, tag)
    c, caps = rec["calls"], rec["captures"]
    want_track = 1 if graphed and c["track"] else 0
    check(caps["track"] == want_track and (graphed or not any(caps.values())),
          f"cli {tag}: captures {caps}, expected track {want_track}"
          + ("" if graphed else " and none else"))
    check(loops == rec["loops"], f"cli {tag}: {loops} loop nodes run, "
          f"expected {rec['loops']} from the replays {rec['replays']}")
    want = expected_launches(c, calib, ba_path, k2_path)
    g = out["graph"]
    log(f"cli {tag}: {out['frames_processed']} frames in {wall:.1f} s, "
        f"keyframes {len(out['keyframes'])}, edges {g.n_edges()}, modes "
        f"{''.join(m[0] for m in out['modes'])}; model calls {rec['calls']}; "
        f"graph captures {caps}, replays {rec['replays']}, loop nodes "
        f"{loops}; launches {launches} (want {want}); K4 / K5 launches in "
        f"masked steps {masked} (at most {c['spare_builds']})")
    check(launches == want, f"cli {tag}: launch counts {launches} != {want}")
    check(0 <= masked <= c["spare_builds"], f"cli {tag}: {masked} launches "
          f"in masked steps, at most {c['spare_builds']}")
    return out, launches, rec


def cli_decisions(out):
    """A CLI run's modes, keyframes (dataset indices), edges and keyframe
    poses (on the host)."""
    kf = out["keyframes"]
    n = len(kf)
    return dict(modes=out["modes"], kfs=[int(x) for x in kf.dataset_idx[:n]],
                edges=graph_edges(out["graph"]), T=kf.T_WC[:n].cpu())


def graph_edges(g):
    return [(int(i), int(j)) for i, j in zip(g.ii, g.jj)]


def graph_pool_gib(out, model):
    """GiB held by the pools of a CLI run's CUDA graphs, by graph: the
    tracker's, the factor graph's solves and the model's decode + match
    (the model's graphs are kept across the runs that share it), and by
    the solves' edge buffers."""
    caches = {"track": out["tracker"].graphs, "solve": out["graph"].graphs,
              "match": model.graphs}
    out_gib = {k: round(sum(c.pool_bytes().values()) / 2**30, 3)
               for k, c in caches.items() if c is not None}
    # the padded two-way edge buffers that the solve graphs read in place
    out_gib["solve_buffers"] = round(out["graph"].bucket_bytes() / 2**30, 3)
    return out_gib


def cli_parts(rec):
    return {k: statistics.median(v) if v else 0.0
            for k, v in rec["ms"].items()}


def phase_cli(torch, FA, C3, BA, workdir):
    """The port's CLI at full ViT-L width on a clip it writes: a 24-frame
    out-and-back pan (retrieval has a revisit) with base.yaml's quality
    service and local TSDF refiner, the same clip with them off (their cost
    to the tracked frame and the backend step), then a calibrated run on a
    freiburg3 directory, a checkpoint / resume pair and a threaded run with
    the global TSDF on as well."""
    from mast3r_slam_tpu_torch.slam.factor_graph import FactorGraph
    from mast3r_slam_tpu_torch.slam.frame import KeyframeBuffer
    from mast3r_slam_tpu_torch.utils.checkpoint import load_state
    from mast3r_slam_tpu_torch.utils.config import load_config

    work = Path(workdir)
    clip = write_clip(work / "smoke_tum_clip", CLI_FRAMES)
    calib_clip = write_clip(work / "smoke_tum_freiburg3", CLI_CALIB_FRAMES)
    cfg_path = write_config(work / "cli.yaml")
    cfg = load_config(cfg_path)
    t0 = time.perf_counter()
    model = tied_model(cfg, "cuda")
    torch.cuda.synchronize()
    log(f"cli: ViT-L random init (tied streams) + prepare "
        f"{time.perf_counter() - t0:.1f} s")
    H, W = IMG_HW
    base = ["--config", cfg_path, "--no-viz"]

    with timed_frame_reads([]) as read_ms:
        out, launches, rec = run_cli(torch, FA, C3, BA, model, work,
                                     ["--dataset", str(clip), "--save-as",
                                      "main", *base], "main")
    check(len(read_ms) == CLI_FRAMES, f"cli main: {len(read_ms)} frame "
          f"reads timed, {CLI_FRAMES} frames")
    g = out["graph"]
    kf = out["keyframes"]
    check(len(kf) >= 8, f"cli main: {len(kf)} keyframes, need >= 8")
    loop = sorted({(int(i), int(j)) for i, j in zip(g.ii, g.jj)
                   if abs(int(i) - int(j)) > 1})
    check(loop, "cli main: no non-consecutive (retrieval) edge")
    check(rec["calls"]["lm_iters"] > 0, "cli main: no BA iterations")
    savedir = work / "logs" / "main" / clip.name
    check_outputs(out, savedir, clip.name, CLI_FRAMES, IMG_HW)
    qf = quality_fields(savedir / f"{clip.name}_quality.ply")
    for field in ("r", "delta_cov"):
        check(bool((qf[field] != 0).any()),
              f"cli main: the quality PLY's {field} is all zero")
    rs = out["refiner"].stats
    check(out["quality"].processed_jobs > 0 and rs["scheduled"] > 0,
          f"cli main: services idle (quality "
          f"{out['quality'].processed_jobs} jobs, refiner {rs})")
    ms = rec["ms"]
    parts = cli_parts(rec)
    summary = dict(modes=out["modes"], edge_pairs=graph_edges(g),
                   tracked_ms=parts["track"], step_ms=parts["step"],
                   read_ms=statistics.median(read_ms),
                   retrieval_ms=parts["retrieval"],
                   add_factors_ms=parts["add_factors"],
                   solve_ms=parts["solve"], keyframes=len(kf),
                   edges=g.n_edges(), loop_edges=len(loop),
                   launches=launches, steps=len(ms["step"]),
                   captures=rec["captures"], replays=rec["replays"],
                   quality_jobs=out["quality"].processed_jobs,
                   quality_dropped=out["quality"].dropped_jobs,
                   refined=rs["refined_blocks"],
                   rejected=rs["rejected_blocks"])
    log(f"cli main: median tracked frame {parts['track']:.1f} ms over "
        f"{len(ms['track'])} frames, median frame read (dataset[i] + "
        f"create_frame, 480x640 PNG to the 384x512 crop) "
        f"{summary['read_ms']:.2f} ms; median backend step {parts['step']:.1f} "
        f"ms over {len(ms['step'])} steps (retrieval {parts['retrieval']:.1f}"
        f", add_factors {parts['add_factors']:.1f}, solve "
        f"{parts['solve']:.1f}); keyframes {len(kf)}, edges {g.n_edges()}, "
        f"retrieval edges {loop}; quality {out['quality'].processed_jobs} "
        f"jobs ({out['quality'].dropped_jobs} dropped), refiner {rs}; graph "
        f"captures {rec['captures']}, replays {rec['replays']}, pools "
        f"{graph_pool_gib(out, model)} GiB")
    del out, g, kf

    # the same clip with the services off: their cost to the frame and step
    off_cfg = write_config(work / "cli_off.yaml", **SERVICES_OFF)
    out, _, rec = run_cli(torch, FA, C3, BA, model, work,
                          ["--dataset", str(clip), "--config", off_cfg,
                           "--no-viz", "--save-as", "off"], "services off")
    check(out["quality"] is None and not out["refiner"].enabled,
          "cli services off: a service ran")
    off = cli_parts(rec)
    summary.update(tracked_ms_off=off["track"], step_ms_off=off["step"])
    log(f"cli services on / off: median tracked frame "
        f"{parts['track']:.1f} / {off['track']:.1f} ms, median backend step "
        f"{parts['step']:.1f} / {off['step']:.1f} ms (solve "
        f"{parts['solve']:.1f} / {off['solve']:.1f})")

    # again with the tracker, the solves and the decode + match eager: the
    # graphs change nothing
    runs = {"graphed": cli_decisions(out)}
    pools = graph_pool_gib(out, model)
    del out
    out, _, rec = run_cli(torch, FA, C3, BA, model, work,
                          ["--dataset", str(clip), "--config", off_cfg,
                           "--no-viz", "--save-as", "off_eager"],
                          "services off, eager", graphed=False)
    runs["eager"] = cli_decisions(out)
    eager = cli_parts(rec)
    a, b = runs["graphed"], runs["eager"]
    for key in ("modes", "kfs", "edges"):
        check(a[key] == b[key], f"cli graphed vs eager: {key} differ: "
              f"{a[key]} vs {b[key]}")
    check(same_bits(a["T"], b["T"]), "cli graphed vs eager: keyframe poses "
          f"differ by {float((a['T'] - b['T']).abs().max()):.3e}")
    summary.update(
        tracked_ms_eager=eager["track"], step_ms_eager=eager["step"],
        retrieval_ms_off=off["retrieval"], add_factors_ms_off=off[
            "add_factors"], solve_ms_off=off["solve"],
        retrieval_ms_eager=eager["retrieval"],
        add_factors_ms_eager=eager["add_factors"],
        solve_ms_eager=eager["solve"], pool_gib=pools)
    log(f"cli services off, graphed / eager (tracker, solves, decode + "
        f"match): the same modes, {len(a['kfs'])} keyframes, "
        f"{len(a['edges'])} edges and keyframe poses (bit for bit); median "
        f"tracked frame {off['track']:.1f} / {eager['track']:.1f} ms, "
        f"median backend step {off['step']:.1f} / {eager['step']:.1f} ms "
        f"(retrieval {off['retrieval']:.1f} / {eager['retrieval']:.1f}, "
        f"add_factors {off['add_factors']:.1f} / {eager['add_factors']:.1f}"
        f", solve {off['solve']:.1f} / {eager['solve']:.1f}); graph pools "
        f"after the graphed run (GiB): {pools}")
    del out

    # calibrated: freiburg3 has no distortion; K5 carries the BA
    calib_cfg = write_config(work / "cli_calib.yaml", use_calib=True)
    out, launches, _ = run_cli(
        torch, FA, C3, BA, model, work,
        ["--dataset", str(calib_clip), "--config", calib_cfg, "--no-viz",
         "--save-as", "calib"], "calibrated", calib=True)
    check(launches["K5"] > 0 and launches["K4"] == 0,
          "cli calibrated: the BA did not run on K5")
    check_outputs(out, work / "logs" / "calib" / calib_clip.name,
                  calib_clip.name, CLI_CALIB_FRAMES, IMG_HW)
    summary["calib_K5"] = launches["K5"]
    del out

    # checkpoint, then the restored tensors against the saved run's
    ckpt = work / "state.npz"
    out, _, _ = run_cli(torch, FA, C3, BA, model, work,
                        ["--dataset", str(clip), "--save-as", "ck1",
                         "--max-frames", str(CLI_CKPT_FRAMES), "--checkpoint",
                         str(ckpt), *base], "checkpoint")
    kf, g = out["keyframes"], out["graph"]
    n = len(kf)
    kf2 = KeyframeBuffer(kf.h, kf.w, capacity=kf.capacity,
                         feat_dim=kf.feat_dim, device="cuda",
                         model_hw=kf.model_hw)
    g2 = FactorGraph(model, kf2, cfg)
    frame_idx = load_state(str(ckpt), kf2, g2)
    check(frame_idx == CLI_CKPT_FRAMES and len(kf2) == n,
          "checkpoint: frame index or keyframe count")
    for key in ("T_WC", "X", "C", "feat", "pos"):
        check(torch.equal(getattr(kf, key)[:n], getattr(kf2, key)[:n]),
              f"checkpoint: restored {key} differs")
    for key in ("idx_ii2jj", "idx_jj2ii", "valid_match_j", "valid_match_i",
                "Q_ii2jj", "Q_jj2ii"):
        check(torch.equal(getattr(g, key), getattr(g2, key)),
              f"checkpoint: restored graph {key} differs")
    for i in range(n):
        check(torch.equal(kf.img[i], kf2.img[i])
              and (kf.uimg[i] == kf2.uimg[i]).all(),
              f"checkpoint: keyframe {i} images differ")
    check((kf.N[:n] == kf2.N[:n]).all()
          and (kf.dataset_idx[:n] == kf2.dataset_idx[:n]).all(),
          "checkpoint: counters differ")
    del out, kf, g, kf2, g2
    out, _, _ = run_cli(torch, FA, C3, BA, model, work,
                        ["--dataset", str(clip), "--save-as", "ck2",
                         "--resume", str(ckpt), *base], "resume")
    check(out["frames_processed"] == CLI_FRAMES
          and len(out["keyframes"]) > n, "resume: the run did not continue")
    log(f"cli checkpoint/resume: {n} keyframes restored bit for bit; the "
        f"resumed run ended with {len(out['keyframes'])}")
    del out

    # threaded backend with the global TSDF on as well: drains and exits
    thr_cfg = write_config(work / "cli_threaded.yaml", single_thread=False,
                           tsdf_global={"enabled": True})
    t0 = time.perf_counter()
    out, _, _ = run_cli(torch, FA, C3, BA, model, work,
                        ["--dataset", str(clip), "--config", thr_cfg,
                         "--no-viz", "--save-as", "threaded", "--max-frames",
                         str(CLI_THREADED_FRAMES)], "threaded")
    check(out["frames_processed"] == CLI_THREADED_FRAMES,
          "threaded: frames")
    check(out["states"].global_optimizer_tasks == []
          and out["states"].reloc_sem == 0, "threaded: backend not drained")
    m = out["tsdf_manager"]
    check(m.enabled, "threaded: the global TSDF is off")
    log(f"cli threaded: {time.perf_counter() - t0:.1f} s, keyframes "
        f"{len(out['keyframes'])}, edges {out['graph'].n_edges()}; global "
        f"TSDF {m.volume.stats()}, {m.optimizer.refined} poses refined")
    del out, model
    torch.cuda.empty_cache()
    return summary


def _apart(a, b):
    """Largest elementwise distance of two tensors."""
    return float((a.float() - b.float()).abs().max())


def _share(a, b):
    """The share of the elements of two tuples of tensors that agree
    within ``CROSS_POSE_TOL``, relative to the larger of 1 and the second
    tensor's largest magnitude."""
    n = ok = 0
    for x, y in zip(a, b, strict=True):
        if x.shape != y.shape:
            return 0.0
        x, y = x.float(), y.float()
        scale = max(1.0, float(y.abs().max()))
        ok += int(((x - y).abs() <= CROSS_POSE_TOL * scale).sum())
        n += x.numel()
    return ok / max(n, 1)


def phase_cli_cross(torch, workdir):
    """The CLI with one model on the card and on the CPU: full width, depth
    ``CROSS_DEPTH`` (encoder, decoder), f32, 96x128 crops, ``CROSS_FRAMES``
    frames, base.yaml's bundle adjustment (BA). The same mode sequence,
    keyframes and edges. Every BA solve of the card's run is solved again
    on the CPU from the card's own inputs (start poses, channels, edges)
    and must end within ``CROSS_POSE_TOL`` of the card. Every tracked pose
    within ``CROSS_POSE_TOL`` while the two runs' valid matches agree
    index for index (a random-weight matcher can put a pixel on a
    near-singular LM step, after which the chains part: then the first
    frames must agree and the final poses are reported and bounded by
    ``CROSS_DRIFT_TOL``). A random-weight BA can be a near-tie as well:
    inputs that agree to a few 1e-6 end far apart. Where the CPU's own
    solve parts from the card's while the inputs agree (poses within
    ``CROSS_POSE_TOL``, the edges equal, ``CROSS_SHARE`` of the edge
    matches and of the channel elements alike), the CPU solved from the
    card's inputs is the witness (it lands beside the card, so the
    reference itself parts that far from a perturbation of that size; the
    CPU is also solved from the card's start poses with its own channels),
    and the CPU's run goes on from the card's poses, so that the rest of
    the clip is compared pose for pose."""
    import os

    import numpy as np

    from mast3r_slam_tpu_torch import main as cli
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.models.inference import MASt3RInference
    from mast3r_slam_tpu_torch.slam import factor_graph as FG
    from mast3r_slam_tpu_torch.slam import tracker as T
    from mast3r_slam_tpu_torch.utils.config import load_config

    work = Path(workdir)
    clip = work / "smoke_tum_cross"
    # one frame more than the run reads: positions 0, 1, 2, 3, 4, 3, 2, 1,
    # no two alike in a row (tracking a frame against an identical
    # keyframe is the matcher's most degenerate case)
    write_clip(clip, CROSS_FRAMES + 1)
    # sigma_dist 0.1 pins the Sim(3) scale (at 10 the distance rows weigh
    # ~1e-7 of the ray rows); f32 channels and BA rows, as the model; the
    # services off, since the refiner's write-backs land at times that the
    # worker threads decide, which differ between two runs
    cfg_path = write_config(work / "cli_cross.yaml", **SERVICES_OFF,
                            dataset={"img_size": CROSS_IMG_SIZE},
                            model={"dtype": "float32",
                                   "head_dtype": "float32"},
                            tracking={"sigma_dist": 0.1},
                            local_opt={"sigma_dist": 0.1,
                                       "meas_dtype": "float32",
                                       "ba_compute_dtype": "float32"})
    cfg = load_config(cfg_path)
    gpu_model = tied_model(cfg, "cuda", seed=1, enc_depth=CROSS_DEPTH[0],
                           dec_depth=CROSS_DEPTH[1])
    cpu_model = MASt3RInference(M.tree_map(lambda t: t.cpu(),
                                           gpu_model.params),
                                gpu_model.cfg, gpu_model.match_cfg)
    argv = ["--dataset", str(clip), "--config", cfg_path, "--no-viz",
            "--max-frames", str(CROSS_FRAMES)]
    res = {}
    core, solve0 = T.track_core, FG.FactorGraph._solve
    cwd = os.getcwd()
    os.chdir(work)
    try:
        for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
            tracked, solves = [], []
            card = res["cuda"]["solves"] if dev == "cpu" else None

            def rec(*a, **kw):
                out = core(*a, **kw)
                valid = out["valid_match"].reshape(-1).bool()
                idx = out["idx_f2k"].reshape(-1)
                tracked.append((torch.where(valid, idx, -1).cpu(),
                                out["T_WCf"].cpu()))
                return out

            def solve(graph, kind, solver, solves=solves, card=card):
                def traced(T_in, meas, *rest):
                    T_new, iters = solver(T_in, meas, *rest)
                    E = graph.n_edges()
                    got = dict(ins=tuple(x.cpu().clone() for x in
                                         (T_in, *rest[:4])),
                               meas=tuple(x.cpu().clone() for x in meas),
                               out=T_new.cpu().clone(), iters=int(iters),
                               matches=torch.cat([
                                   torch.where(v[:E, :, 0], i[:E], -1).cpu()
                                   for i, v in ((graph.idx_ii2jj,
                                                 graph.valid_match_j),
                                                (graph.idx_jj2ii,
                                                 graph.valid_match_i))]))
                    if card is not None and len(solves) < len(card):
                        c = card[len(solves)]
                        fed, it_fed = solver(c["ins"][0].clone(), c["meas"],
                                             *c["ins"][1:], None, None)
                        posed = solver(c["ins"][0].clone(), got["meas"],
                                       *got["ins"][1:], None, None)[0]
                        got.update(
                            fed=fed.clone(), fed_iters=int(it_fed),
                            posed=posed.clone(),
                            poses_apart=_apart(got["ins"][0], c["ins"][0]),
                            meas_share=_share(got["meas"], c["meas"]),
                            match_share=float((got["matches"] == c[
                                "matches"]).float().mean())
                            if got["matches"].shape == c["matches"].shape
                            else 0.0,
                            edges=all(torch.equal(x, y) for x, y in
                                      zip(got["ins"][1:], c["ins"][1:])))
                        if (_apart(got["out"], c["out"]) > CROSS_POSE_TOL
                                and got["edges"]
                                and got["poses_apart"] <= CROSS_POSE_TOL
                                and min(got["match_share"],
                                        got["meas_share"]) >= CROSS_SHARE):
                            got["reanchored"] = True
                            T_new = c["out"].to(T_new.device, T_new.dtype,
                                                copy=True)
                    solves.append(got)
                    return T_new, iters

                solve0(graph, kind, traced)

            T.track_core, FG.FactorGraph._solve = rec, solve
            t0 = time.perf_counter()
            with one_cpu_thread(torch):
                out = cli.main(argv + ["--save-as", f"cross_{dev}"],
                               device=dev, model=model)
            kf = out["keyframes"]
            n = len(kf)
            res[dev] = dict(modes=out["modes"],
                            kfs=[int(x) for x in kf.dataset_idx[:n]],
                            ii=[int(x) for x in out["graph"].ii],
                            jj=[int(x) for x in out["graph"].jj],
                            T=kf.T_WC[:n].cpu().numpy(), tracked=tracked,
                            solves=solves)
            log(f"cli card vs CPU, {dev}: {time.perf_counter() - t0:.1f} s, "
                f"modes {''.join(m[0] for m in out['modes'])}, keyframes "
                f"{res[dev]['kfs']}, edges "
                f"{list(zip(res[dev]['ii'], res[dev]['jj']))}")
    finally:
        T.track_core, FG.FactorGraph._solve = core, solve0
        os.chdir(cwd)
    a, b = res["cuda"], res["cpu"]
    for key in ("modes", "kfs", "ii", "jj"):
        check(a[key] == b[key], f"cli card vs CPU: {key} differ: "
              f"{a[key]} vs {b[key]}")
    check(len(a["kfs"]) >= 2, "cli card vs CPU: no keyframe after the first")
    check(len(a["solves"]) == len(b["solves"]) > 0,
          f"cli card vs CPU: {len(a['solves'])} BA solves on the card, "
          f"{len(b['solves'])} on the CPU")
    fed_err = []
    for k, (c, h) in enumerate(zip(a["solves"], b["solves"])):
        fed_err.append(_apart(h["fed"], c["out"]))
        log(f"cli card vs CPU: BA solve {k}: LM steps card {c['iters']} CPU "
            f"{h['iters']} (from the card's inputs {h['fed_iters']}); "
            f"inputs: poses {h['poses_apart']:.3e} apart, edge matches "
            f"{h['match_share']:.5f} and channel elements {h['meas_share']:.5f}"
            f" within {CROSS_POSE_TOL:g} (relative) alike, edges "
            f"{'equal' if h['edges'] else 'differ'}; the CPU's own solve "
            f"ends {_apart(h['out'], c['out']):.3e} from the card's; the CPU "
            f"from the card's inputs {fed_err[-1]:.3e} from the card's and "
            f"{_apart(h['fed'], h['out']):.3e} from its own; from the card's "
            f"start poses and its own channels "
            f"{_apart(h['posed'], c['out']):.3e} from the card's and "
            f"{_apart(h['posed'], h['out']):.3e} from its own"
            + ("; the CPU goes on from the card's poses"
               if h.get("reanchored") else ""))
    reanchored = [k for k, h in enumerate(b["solves"]) if h.get("reanchored")]
    check(max(fed_err) <= CROSS_POSE_TOL,
          f"cli card vs CPU: a BA solve on the CPU from the card's inputs "
          f"ends {max(fed_err):.3e} from the card's")
    agree = [torch.equal(x[0], y[0])
             for x, y in zip(a["tracked"], b["tracked"])]
    first = agree.index(False) if False in agree else len(agree)
    pose_err = [float((x[1] - y[1]).abs().max())
                for x, y in zip(a["tracked"], b["tracked"])]
    share = [float((x[0] == y[0]).float().mean())
             for x, y in zip(a["tracked"], b["tracked"])]
    err = float(np.abs(a["T"] - b["T"]).max())
    log(f"cli card vs CPU: same modes, keyframes and edges; {len(fed_err)} "
        f"BA solves, each on the CPU from the card's inputs within "
        f"{max(fed_err):.3e}, the CPU going on from the card's poses after "
        f"solves {reanchored}; tracked frames "
        f"with identical valid matches: {first} of {len(agree)} (match "
        f"agreement per frame {['%.5f' % v for v in share]}); tracked pose "
        f"err per frame {['%.2e' % v for v in pose_err]}; keyframe poses max "
        f"abs err {err:.3e}")
    check(max(pose_err[:first], default=0.0) <= CROSS_POSE_TOL,
          "cli card vs CPU: tracked poses differ while the matches agree")
    if first == len(agree):
        check(err <= CROSS_POSE_TOL,
              f"cli card vs CPU: keyframe poses {err:.3e} apart")
    else:
        check(first >= 2 and min(share) >= CROSS_SHARE,
              f"cli card vs CPU: matches part at tracked frame {first}")
        check(err <= CROSS_DRIFT_TOL,
              f"cli card vs CPU: keyframe poses {err:.3e} apart")
    del gpu_model, cpu_model
    torch.cuda.empty_cache()
    return dict(err=err, first=first, n=len(agree),
                solves=len(fed_err), reanchored=reanchored)


# ---------------------------------------------------------------------------
# Phases: the data layer (undistortion, the image readers) and the CLI on
# the evaluation datasets' layouts and on an image folder
# ---------------------------------------------------------------------------

JPEG_FIXTURES = ROOT / "tests" / "data" / "jpeg"
PNG_FIXTURES = ROOT / "tests" / "data" / "png"
# the mixed image folder's frames in turn: 16-bit RGB (v * 257),
# Adam7-interlaced RGB, and stored under the inverse of each EXIF
# orientation (5-8 transposed)
MIXED_PNG_KINDS = ("16-bit", "adam7") + tuple(range(1, 9))
K_UNDIST_RTOL = 1e-6
HOST_REPEATS = 20
DATA_FRAMES = 12
# EuRoC MH cam0 (mav0/cam0/sensor.yaml): 752x480, radial-tangential
EUROC_CAM0 = dict(intrinsics=[458.654, 457.296, 367.215, 248.375],
                  distortion_coefficients=[-0.28340811, 0.07395907,
                                           0.00019359, 1.76187114e-05],
                  resolution=[752, 480])
# Replica (the fork's renders): 1200x680 JPEG frames, cam_params.json
REPLICA_HW = (680, 1200)
REPLICA_CAM = dict(w=1200, h=680, fx=600.0, fy=600.0, cx=599.5, cy=339.5,
                   scale=6553.5)
REPLICA_QUALITY = 95
NOISE_LEVELS = 16       # sigma of the noisy decode timing frame
# the plain versions' slow cases (a 480x640 PNG of Average or Paeth rows
# through unfilter_ref, ~0.4 s a decode) are timed over fewer calls
PLAIN_SLOW_REPEATS = 3
# TUM freiburg1 (the JAX package's _TUM_CALIB): 640x480, undistorted under
# use_calib
TUM_FR1 = (640, 480, 517.3, 516.5, 318.6, 255.3,
           (0.2624, -0.9531, -0.0054, 0.0026, 1.1633))
PNG_FILTERS = {"Sub": 1, "Up": 2, "Average": 3, "Paeth": 4}
# the cli_datasets runs repeated with the plain read (one per layout; the
# progressive and mixed clips are held to these runs' decisions already)
PLAIN_READ_RUNS = ("euroc", "tum_fr1_calib", "replica", "rgbfiles")


def _host_ms(fn, repeats=HOST_REPEATS):
    """Median host milliseconds of ``repeats`` calls of ``fn``."""
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


@contextlib.contextmanager
def plain_host_read():
    """Within the block, the readers run the plain versions of the
    compiled host code: the PNG unfilter row by row in Python
    (``png.unfilter_ref``), the remap in numpy
    (``undistort.remap_bilinear_ref``), the INTER_AREA resize and copy in
    numpy (``image_ops.resize_area_ref``) and the LANCZOS4 weights built
    afresh on every call."""
    from mast3r_slam_tpu_torch.data import (image_host, image_ops, png,
                                            undistort)

    saved = [(image_host, "png_unfilter", png.unfilter_ref),
             (undistort, "remap_bilinear", undistort.remap_bilinear_ref),
             (image_host, "resize_area", image_ops.resize_area_ref),
             (image_ops, "resize_weights",
              image_ops.resize_weights.__wrapped__)]
    saved = [(m, n, getattr(m, n), v) for m, n, v in saved]
    for m, n, _, v in saved:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, orig, _ in saved:
            setattr(m, n, orig)


# resize_img's sizes timed on the host: (name, source H x W, size); the
# last is the main path's own crop, which the resize copies
RESIZE_TIMED = (("tum 480x640", (480, 640), 512),
                ("euroc 480x752", (480, 752), 512),
                ("replica 680x1200", (680, 1200), 512),
                ("copy 384x512", (384, 512), 512))
RESIZE_FIXTURES = ROOT / "tests" / "data" / "resize"


def resize_checks(smi):
    """``resize_img`` (its INTER_AREA pass and copy in compiled code,
    ``data/image_host.py::resize_area``) against its plain version
    (``image_ops.resize_area_ref``, :func:`plain_host_read`) at
    ``RESIZE_TIMED``'s sizes: equal bits of the model and display images,
    the median host ms of each; then both resizes on each committed
    fixture's seeded input against the SHA-256 of cv2.resize's output
    recorded beside it (this machine has no cv2)."""
    import hashlib

    import numpy as np

    from mast3r_slam_tpu_torch.data import image_host, image_ops

    out = {}
    rng = np.random.default_rng(8)
    for name, hw, size in RESIZE_TIMED:
        img = rng.random((*hw, 3)).astype(np.float32)
        new = image_ops.resize_img(img, size)
        ms = _host_ms(lambda: image_ops.resize_img(img, size))
        with plain_host_read():
            plain = image_ops.resize_img(img, size)
            plain_ms = _host_ms(lambda: image_ops.resize_img(img, size),
                                PLAIN_SLOW_REPEATS * 3)
        check(new["img"].dtype == np.float32
              and np.array_equal(new["img"].view(np.int32),
                                 plain["img"].view(np.int32))
              and np.array_equal(new["unnormalized_img"],
                                 plain["unnormalized_img"]),
              f"data: resize_img {name} differs from its plain version")
        out[name] = dict(ms=ms, plain_ms=plain_ms,
                         crop=list(new["img"].shape[1:3]))
    rec = json.loads((RESIZE_FIXTURES / "fixtures.json").read_text())
    inputs = _test_writer("torch_resize_inputs")
    for name, r in sorted(rec["resizes"].items()):
        img = inputs.seeded_image(tuple(r["input"]), r["seed"])
        check(hashlib.sha256(img.tobytes()).hexdigest() == r["input_sha256"],
              f"data: the resize fixture {name}'s input is not the one "
              f"recorded")
        for fn, what in ((image_host.resize_area, "compiled"),
                         (image_ops.resize_area_ref, "plain")):
            got = fn(img, r["out_hw"])
            digest = hashlib.sha256(got.tobytes()).hexdigest()
            check(list(got.shape) == r["shape"] and digest == r["sha256"],
                  f"data: the {what} resize of {name} {got.shape} "
                  f"{digest[:16]}, cv2 {r['shape']} {r['sha256'][:16]}")
    out["fixtures"] = len(rec["resizes"])
    log("data: resize_img host ms, compiled / plain (median of "
        f"{HOST_REPEATS} / {PLAIN_SLOW_REPEATS * 3}; equal bits): "
        + ", ".join(f"{n} -> {out[n]['crop'][0]}x{out[n]['crop'][1]} "
                    f"{out[n]['ms']:.3f} / {out[n]['plain_ms']:.2f}"
                    for n, _, _ in RESIZE_TIMED)
        + f"; compiled and plain resizes equal cv2 {rec['opencv']}'s "
        f"digests on {out['fixtures']} fixtures; on {smi}")
    return out


def frame_read_steps(tum, smi):
    """A TUM frame's read on this machine's host, step by step, as
    ``dataset[i]`` + ``create_frame`` make it under ``use_calib``: the PNG
    decode, the conversion to float, freiburg1's remap, then
    ``create_frame``'s steps (``utils/tictoc.py::STEPS``: the resize with
    the model and display images, the upload from pinned memory, the
    display image as float, the pose); median ms of ``HOST_REPEATS``
    reads, each ended by a device sync."""
    import numpy as np
    import torch

    from mast3r_slam_tpu_torch.data import png
    from mast3r_slam_tpu_torch.data.datasets import Intrinsics
    from mast3r_slam_tpu_torch.slam.pipeline import create_frame
    from mast3r_slam_tpu_torch.utils.tictoc import STEPS

    data = _test_writer("torch_png_writer").encode_png(tum)
    intr = Intrinsics(*TUM_FR1[:6], TUM_FR1[6], cfg={})
    reads, totals = [], []
    STEPS.start()
    try:
        for _ in range(HOST_REPEATS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            STEPS.mark()
            img = png.decode_png(data)
            STEPS.lap("decode")
            img = img.astype(np.float32) / 255.0
            STEPS.lap("to float")
            img = intr.remap(img)
            STEPS.lap("remap")
            create_frame(0, img, img_size=512, device="cuda")
            torch.cuda.synchronize()
            STEPS.lap("end sync")
            totals.append((time.perf_counter() - t0) * 1e3)
            reads.append(STEPS.end_frame())
    finally:
        STEPS.stop()
    reads, totals = reads[1:], totals[1:]
    steps = {k: statistics.median(r[k] for r in reads) for k in reads[0]}
    total = statistics.median(totals)
    log(f"data: TUM fr1 frame read by step (480x640 PNG, calibrated, to "
        f"the 384x512 crop on the card), median ms of {HOST_REPEATS}: "
        + ", ".join(f"{k} {v:.3f}" for k, v in steps.items())
        + f"; read {total:.2f} ms; on {smi}")
    return dict(steps=steps, ms=total)


def host_read_checks(smi):
    """The compiled host code of the frame read (``data/image_host.py``:
    the PNG unfilter, the remap and the resize) against their plain
    versions on this machine's host, in one call: equal bytes and equal
    float32 bits, and the median ms of each (``HOST_REPEATS`` calls;
    ``PLAIN_SLOW_REPEATS`` for the plain Average and Paeth decodes). The
    PNGs are a TUM-size 480x640 RGB frame with one filter type on every
    row; the remaps EuRoC cam0's (752x480, gray as EuRoC reads it and
    colour) and TUM freiburg1's (640x480 colour); the resizes
    :func:`resize_checks`'; then a TUM frame's read step by step
    (:func:`frame_read_steps`)."""
    import numpy as np

    from mast3r_slam_tpu_torch.data import png
    from mast3r_slam_tpu_torch.data.datasets import Intrinsics

    out = {}
    tum = next(pan_frames(1, CLI_SRC_HW, (0, 0), seed=7))
    pw = _test_writer("torch_png_writer")
    for name, f in PNG_FILTERS.items():
        data = pw.encode_png(tum, filters=f)
        new = png.decode_png(data)
        with plain_host_read():
            plain = png.decode_png(data)
            plain_ms = _host_ms(lambda: png.decode_png(data),
                                PLAIN_SLOW_REPEATS if f > 2
                                else HOST_REPEATS)
        check(np.array_equal(new, tum) and np.array_equal(plain, tum),
              f"data: the {name}-filtered PNG decodes to other pixels")
        out[f"png_{name.lower()}"] = dict(
            ms=_host_ms(lambda: png.decode_png(data)), plain_ms=plain_ms,
            bytes=len(data))
    e = EUROC_CAM0
    euroc = Intrinsics(*e["resolution"], *e["intrinsics"],
                       (*e["distortion_coefficients"], 0.0), cfg={})
    tum_fr1 = Intrinsics(*TUM_FR1[:6], TUM_FR1[6], cfg={})
    rng = np.random.default_rng(0)
    for key, intr, chans in (("remap_euroc_gray", euroc, 0),
                             ("remap_euroc_rgb", euroc, 3),
                             ("remap_tum_rgb", tum_fr1, 3)):
        shape = (intr.H, intr.W) + ((chans,) if chans else ())
        frame = rng.random(shape).astype(np.float32)
        new = intr.remap(frame)
        with plain_host_read():
            plain = intr.remap(frame)
            plain_ms = _host_ms(lambda: intr.remap(frame))
        check(new.shape == frame.shape and new.dtype == np.float32
              and np.array_equal(new.view(np.int32), plain.view(np.int32)),
              f"data: {key} differs from its plain version")
        out[key] = dict(ms=_host_ms(lambda: intr.remap(frame)),
                        plain_ms=plain_ms)
    log(f"data: host ms, compiled / plain (median of {HOST_REPEATS}; plain "
        f"Average and Paeth of {PLAIN_SLOW_REPEATS}), equal bytes and bits: "
        f"480x640 RGB PNG decode "
        + ", ".join(f"{n} rows {out[f'png_{n.lower()}']['ms']:.2f} / "
                    f"{out[f'png_{n.lower()}']['plain_ms']:.2f}"
                    for n in PNG_FILTERS)
        + f"; remap EuRoC 752x480 gray {out['remap_euroc_gray']['ms']:.2f} "
        f"/ {out['remap_euroc_gray']['plain_ms']:.2f}, x3 "
        f"{out['remap_euroc_rgb']['ms']:.2f} / "
        f"{out['remap_euroc_rgb']['plain_ms']:.2f}, TUM fr1 640x480x3 "
        f"{out['remap_tum_rgb']['ms']:.2f} / "
        f"{out['remap_tum_rgb']['plain_ms']:.2f}; on {smi}")
    out["resize"] = resize_checks(smi)
    out["read_steps"] = frame_read_steps(tum, smi)
    return out


def _test_writer(name):
    """A test encoder (tests/torch_jpeg_writer.py, torch_png_writer.py):
    the card machine has no cv2 or PIL to write JPEGs or PNGs of every kind
    with."""
    import importlib

    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    return importlib.import_module(name)


def fixture_reads():
    """Every committed JPEG and PNG fixture through ``data/imread.py``'s
    colour and gray reads, against the SHA-256 of cv2.imread's read
    recorded beside it; only the cut JPEGs warn. Returns the count."""
    import hashlib
    import warnings

    from mast3r_slam_tpu_torch.data import imread

    n = 0
    for folder in (JPEG_FIXTURES, PNG_FIXTURES):
        reads = json.loads((folder / "fixtures.json").read_text())["reads"]
        for name, rec in sorted(reads.items()):
            for kind in ("color", "gray"):
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    read = (imread.read_gray if kind == "gray"
                            else imread.read_rgb)
                    img = read(folder / name)
                got = hashlib.sha256(img.tobytes()).hexdigest()
                want = rec[f"{kind}_sha256"]
                check(list(img.shape) == rec[f"{kind}_shape"]
                      and got == want,
                      f"data: {folder.name}/{name} {kind} read {img.shape} "
                      f"{got[:16]}, cv2 {rec[f'{kind}_shape']} {want[:16]}")
                check(bool(caught) == name.startswith("cut"),
                      f"data: {name} {kind} warnings {caught}")
                n += 1
    return n


def phase_data(smi):
    """The host data layer on this machine: the JPEG decoder built here
    decodes the committed fixtures to the SHA-256 digests of cv2's decode
    recorded beside them, and every JPEG and PNG fixture reads to cv2's
    colour and gray reads; EuRoC cam0's and TUM freiburg1/2's K_undist
    equal the numbers cv2 gave; then the host ms of EuRoC cam0's maps, of
    one 1200x680 Replica decode (a smooth frame and a noisy one, baseline
    and progressive), and :func:`host_read_checks`: the PNG decodes, the
    remaps and the resize, compiled and plain."""
    import hashlib

    import numpy as np

    from mast3r_slam_tpu_torch.data import image_host, jpeg
    from mast3r_slam_tpu_torch.data.datasets import Intrinsics

    t0 = time.perf_counter()
    jpeg.load_library()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    image_host.load_library()
    host_build_s = time.perf_counter() - t0
    rec = json.loads((JPEG_FIXTURES / "fixtures.json").read_text())
    for name, want in sorted(rec["decoded_sha256"].items()):
        img = jpeg.read_jpeg(JPEG_FIXTURES / name)
        got = hashlib.sha256(img.tobytes()).hexdigest()
        check(list(img.shape) == rec["shape"][name] and got == want,
              f"data: {name} decodes to {img.shape} {got[:16]}, cv2 "
              f"{rec['shape'][name]} {want[:16]}")
    for name, cam in sorted(rec["cameras"].items()):
        W, H, fx, fy, cx, cy, *dist = cam["calib"]
        K = Intrinsics(W, H, fx, fy, cx, cy, dist, cfg={}).K_undist
        want = np.asarray(cam["K_undist"], np.float32)
        err = float(np.abs(K - want).max() / np.abs(want).max())
        check(err <= K_UNDIST_RTOL, f"data: {name} K_undist {K.tolist()} "
              f"!= cv2's {want.tolist()} (relative {err:.2e})")
    n_reads = fixture_reads()
    log(f"data: JPEG decoder built in {build_s:.1f} s, image host library "
        f"(PNG unfilter, remap) in {host_build_s:.1f} s; "
        f"{len(rec['decoded_sha256'])} fixtures equal cv2 {rec['opencv']} "
        f"bit for bit; {n_reads} colour and gray reads of the JPEG and PNG "
        f"fixtures equal cv2.imread's; K_undist of {sorted(rec['cameras'])} "
        f"within {K_UNDIST_RTOL:g}")

    e = EUROC_CAM0
    t0 = time.perf_counter()
    Intrinsics(*e["resolution"], *e["intrinsics"],
               (*e["distortion_coefficients"], 0.0), cfg={})
    maps_ms = (time.perf_counter() - t0) * 1e3
    host = dict(host_read_checks(smi), host_build_s=host_build_s)
    jw = _test_writer("torch_jpeg_writer")
    img = next(pan_frames(1, REPLICA_HW, (0, 0), seed=5))
    data = jw.encode_jpeg(img, REPLICA_QUALITY)
    dec = jpeg.decode_jpeg(data)
    check(dec.shape == (*REPLICA_HW, 3), "data: Replica decode shape")
    err = float(np.abs(dec.astype(np.float64) - img).mean())
    check(err < 3.0, f"data: Replica frame decoded {err:.2f} levels off")
    decode_ms = _host_ms(lambda: jpeg.decode_jpeg(data))
    # Huffman decoding time grows with the entropy-coded bytes: the same
    # frame with seeded noise is a textured render's upper side
    noise = np.random.default_rng(6).normal(0.0, NOISE_LEVELS, img.shape)
    noisy = np.clip(img + noise, 0, 255).astype(np.uint8)
    data_noisy = jw.encode_jpeg(noisy, REPLICA_QUALITY)
    check(jpeg.decode_jpeg(data_noisy).shape == (*REPLICA_HW, 3),
          "data: noisy Replica decode shape")
    decode_noisy_ms = _host_ms(lambda: jpeg.decode_jpeg(data_noisy))
    # the same frames as progressive files of the same coefficients: the
    # same pixels, and their decode time beside the baseline's
    prog, prog_noisy = (jw.encode_jpeg(x, REPLICA_QUALITY, progressive=True)
                        for x in (img, noisy))
    for p_, b_, what in ((prog, data, "smooth"),
                         (prog_noisy, data_noisy, "noisy")):
        check(np.array_equal(jpeg.decode_jpeg(p_), jpeg.decode_jpeg(b_)),
              f"data: the progressive {what} Replica frame does not decode "
              f"to its baseline file's pixels")
    prog_ms = _host_ms(lambda: jpeg.decode_jpeg(prog))
    prog_noisy_ms = _host_ms(lambda: jpeg.decode_jpeg(prog_noisy))
    log(f"data: EuRoC maps + tables {maps_ms:.1f} ms; host ms per "
        f"1200x680 Replica decode "
        f"(4:2:0, q{REPLICA_QUALITY}) {decode_ms:.2f} for a smooth frame "
        f"of {len(data)} bytes, {decode_noisy_ms:.2f} with noise of "
        f"sigma {NOISE_LEVELS} levels, {len(data_noisy)} bytes; progressive "
        f"(jpeg_simple_progression, the same coefficients) {prog_ms:.2f} "
        f"smooth ({len(prog)} bytes), {prog_noisy_ms:.2f} noisy "
        f"({len(prog_noisy)} bytes) (median of {HOST_REPEATS}); on {smi}")
    return dict(decode_ms=decode_ms, maps_ms=maps_ms,
                decode_bytes=len(data), decode_noisy_ms=decode_noisy_ms,
                decode_noisy_bytes=len(data_noisy), prog_ms=prog_ms,
                prog_bytes=len(prog), prog_noisy_ms=prog_noisy_ms,
                prog_noisy_bytes=len(prog_noisy), fixture_reads=n_reads,
                **host)


def write_euroc_clip(root, n_frames):
    """EuRoC's layout: mav0/cam0/data/<ns>.png gray 752x480 frames and
    sensor.yaml with MH cam0's calibration."""
    import yaml

    from mast3r_slam_tpu_torch.data import png

    cam = Path(root) / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True, exist_ok=True)
    W, H = EUROC_CAM0["resolution"]
    step = (CLI_STEP[0] * W / CLI_SRC_HW[1], CLI_STEP[1] * W / CLI_SRC_HW[1])
    for i, img in enumerate(pan_frames(n_frames, (H, W), step, seed=1)):
        png.write_png(cam / "data" / f"{1403636579763555584 + i * 50_000_000}"
                      ".png", img[..., 1])
    (cam / "sensor.yaml").write_text(yaml.safe_dump(EUROC_CAM0))
    return Path(root)


def write_replica_clip(root, n_frames, progressive=False):
    """Replica's layout: results/frame%06d.jpg at 680x1200 (written by the
    test encoder, baseline or progressive with the same coefficients) and
    cam_params.json."""
    root = Path(root)
    (root / "results").mkdir(parents=True, exist_ok=True)
    W = REPLICA_HW[1]
    step = (CLI_STEP[0] * W / CLI_SRC_HW[1], CLI_STEP[1] * W / CLI_SRC_HW[1])
    writer = _test_writer("torch_jpeg_writer")
    for i, img in enumerate(pan_frames(n_frames, REPLICA_HW, step, seed=2)):
        writer.write_jpeg(root / "results" / f"frame{i:06d}.jpg", img,
                          REPLICA_QUALITY, progressive=progressive)
    (root / "cam_params.json").write_text(json.dumps({"camera":
                                                      REPLICA_CAM}))
    return root


def write_image_folder(root, n_frames, mixed=False):
    """An image folder (the ``RGBFiles`` reader) of the cli phase's pan
    frames at 480x640: 8-bit RGB PNGs, or with ``mixed`` the PNG kinds of
    ``MIXED_PNG_KINDS`` in turn, each decoding to the same pixels."""
    from mast3r_slam_tpu_torch.data import png

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    pw = _test_writer("torch_png_writer")
    for i, img in enumerate(pan_frames(n_frames, CLI_SRC_HW, CLI_STEP)):
        path = root / f"frame{i:04d}.png"
        kind = MIXED_PNG_KINDS[i % len(MIXED_PNG_KINDS)]
        if not mixed:
            png.write_png(path, img)
        elif kind == "16-bit":
            pw.write_png(path, img.astype("int64") * 257, depth=16,
                         filters=2)
        elif kind == "adam7":
            pw.write_png(path, img, interlace=True, filters=2)
        else:
            pw.write_png(path, pw.stored_under(img, kind), filters=2,
                         exif=pw.exif_orientation(kind, "MM" if kind % 2
                                                  else "II"))
    return root


@contextlib.contextmanager
def timed_frame_reads(ms):
    """Within the block, each frame the CLI reads appends to ``ms`` the
    host ms from the start of ``dataset[i]`` to the return of
    ``create_frame`` (the read, the decode, the remap, the resize, the
    upload), as ``main.py``'s frame loop calls them."""
    from mast3r_slam_tpu_torch import main as cli
    from mast3r_slam_tpu_torch.data.datasets import MonocularDataset

    started = {}
    getitem, create = MonocularDataset.__getitem__, cli.create_frame

    def timed_getitem(self, idx):
        started["t0"] = time.perf_counter()
        return getitem(self, idx)

    def timed_create(*a, **kw):
        frame = create(*a, **kw)
        t0 = started.pop("t0", None)
        if t0 is not None:
            ms.append((time.perf_counter() - t0) * 1e3)
        return frame

    MonocularDataset.__getitem__, cli.create_frame = (timed_getitem,
                                                      timed_create)
    try:
        yield ms
    finally:
        MonocularDataset.__getitem__, cli.create_frame = getitem, create


def read_turns(torch, ds, cfg, tag):
    """``dataset[i]`` + ``create_frame`` over the clip's frames on the
    card, compiled and plain (:func:`plain_host_read`) in turns, frame by
    frame: the reader's frames equal bit for bit, and so do the model
    crops uploaded. Returns the medians (ms) of both."""
    import numpy as np

    from mast3r_slam_tpu_torch.slam.pipeline import create_frame

    img_size = int(cfg["dataset"].get("img_size", 512))
    down = int(cfg["dataset"].get("img_downsample", 1))
    ms = {"new": [], "plain": []}

    def read(i):
        t0 = time.perf_counter()
        _, img = ds[i]
        f = create_frame(i, img, img_size=img_size, downsample=down,
                         device="cuda")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, img, f

    for i in range(len(ds)):
        got = {}
        for kind in (("new", "plain") if i % 2 else ("plain", "new")):
            with (plain_host_read() if kind == "plain"
                  else contextlib.nullcontext()):
                t, img, f = read(i)
            ms[kind].append(t)
            got[kind] = (img, f.img.cpu(), f.uimg)
        (a, fa, ua), (b, fb, ub) = got["new"], got["plain"]
        check(np.array_equal(a.view(np.int32), b.view(np.int32))
              and torch.equal(fa, fb) and np.array_equal(ua, ub),
              f"cli {tag}: frame {i} read with the compiled host code "
              f"differs from its plain read")
    return {k: statistics.median(v) for k, v in ms.items()}


def phase_cli_datasets(torch, FA, C3, BA, workdir, smi):
    """The CLI at full ViT-L width on ``DATA_FRAMES``-frame clips in the
    evaluation datasets' layouts, each under its evaluation script's config
    with ``CLI_CUTS``: EuRoC (gray, undistorted on read; eval_no_calib,
    the ray BA on K4's f32-row path), TUM freiburg1 under calibration
    (undistorted; eval_calib, K5's), Replica (JPEG frames; eval_replica,
    K5) and Replica again as progressive JPEGs of the same coefficients;
    then an image folder (``RGBFiles``) of the pan frames as 8-bit PNGs and
    as mixed PNG kinds (16-bit, Adam7, EXIF-tagged), under base.yaml with
    the services off (bf16: K1, K2 on the implicit GEMM, K4 on the tensor
    cores). Each run checks its outputs and its launches per kernel and
    path; the evaluation layouts K_frame's principal point at the crop's
    centre. The progressive and the mixed clips' reader frames equal their
    baseline clips' bit for bit, and their runs give the baseline runs'
    modes, keyframes and edges."""
    import numpy as np

    from mast3r_slam_tpu_torch.data.datasets import load_dataset
    from mast3r_slam_tpu_torch.utils.config import load_config

    work = Path(workdir)
    # (tag, config, calibrated, clip, the run whose frames and decisions
    # it must give)
    runs = (
        ("euroc", "eval_no_calib.yaml", False,
         write_euroc_clip(work / "euroc" / "MH_01_easy", DATA_FRAMES), None),
        ("tum_fr1_calib", "eval_calib.yaml", True,
         write_clip(work / "rgbd_dataset_freiburg1_desk", DATA_FRAMES), None),
        ("replica", "eval_replica.yaml", True,
         write_replica_clip(work / "replica" / "office0", DATA_FRAMES), None),
        ("replica_progressive", "eval_replica.yaml", True,
         write_replica_clip(work / "replica_progressive" / "office0",
                            DATA_FRAMES, progressive=True), "replica"),
        ("rgbfiles", "base.yaml", False,
         write_image_folder(work / "frames" / "pan", DATA_FRAMES), None),
        ("rgbfiles_mixed", "base.yaml", False,
         write_image_folder(work / "frames_mixed" / "pan", DATA_FRAMES,
                            mixed=True), "rgbfiles"),
    )
    model, model_dtypes, summary, decided, frames = None, None, {}, {}, {}
    for tag, inherit, calib, clip, baseline in runs:
        evaluation = inherit != "base.yaml"
        over = {} if evaluation else SERVICES_OFF
        cfg_path = write_config(work / f"cli_{tag}.yaml", inherit=inherit,
                                **over)
        cfg = load_config(cfg_path)
        if evaluation:
            check(cfg["local_opt"]["ba_compute_dtype"] == "float32"
                  and int(cfg["local_opt"]["pixel_step"]) == 1
                  and bool(cfg.get("use_calib")) == calib,
                  f"cli {tag}: {inherit} is not the evaluation config")
        # the eval configs' f32 heads and BA rows, base.yaml's bf16: every
        # DPT conv (Cin, Cout multiples of 8) and every system build on
        # these paths
        dt = getattr(torch, cfg["model"]["head_dtype"])
        k2_path = C3.conv3x3_path(dt, 256, 256)
        ba_path = BA.gram_path(getattr(torch,
                                       cfg["local_opt"]["ba_compute_dtype"]))
        dtypes = (cfg["model"]["dtype"], cfg["model"]["head_dtype"])
        if dtypes != model_dtypes:
            del model
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            model, model_dtypes = tied_model(cfg, "cuda"), dtypes
            torch.cuda.synchronize()
            log(f"cli datasets: ViT-L random init (tied streams, "
                f"{cfg['model']['head_dtype']} heads) "
                f"{time.perf_counter() - t0:.1f} s")
        ds = load_dataset(str(clip), cfg)
        frames[tag] = [ds.read_img(i) for i in range(len(ds))]
        (h, w), _ = ds.get_img_shape()
        intr = ds.camera_intrinsics
        pp = None
        if evaluation:
            pp = (float(intr.K_frame[0, 2]), float(intr.K_frame[1, 2]))
            check(abs(pp[0] - w / 2) <= 0.5 and abs(pp[1] - h / 2) <= 0.5,
                  f"cli {tag}: K_frame principal point {pp}, crop {w}x{h}")
            check(intr.has_distortion == (tag == "euroc" or tag.startswith(
                "tum")) and ds.has_calib() == (tag == "euroc" or calib),
                f"cli {tag}: undistortion / calibration not in use")
        else:
            check(type(ds).__name__ == "RGBFiles" and intr is None,
                  f"cli {tag}: read as {type(ds).__name__}, not RGBFiles")
        if baseline is not None:
            same = [np.array_equal(a, b) for a, b in zip(frames[tag],
                                                        frames[baseline])]
            check(len(same) == len(frames[baseline]) == DATA_FRAMES
                  and all(same), f"cli {tag}: reader frames differ from "
                  f"{baseline}'s: {same}")
        with timed_frame_reads([]) as read_ms:
            out, launches, rec = run_cli(
                torch, FA, C3, BA, model, work,
                ["--dataset", str(clip), "--config", cfg_path, "--no-viz",
                 "--save-as", tag], tag, calib=calib, ba_path=ba_path,
                k2_path=k2_path)
        check(len(read_ms) == DATA_FRAMES,
              f"cli {tag}: {len(read_ms)} frame reads timed, "
              f"{DATA_FRAMES} frames")
        turns = read_turns(torch, ds, cfg, tag)
        plain_run = ""
        if tag in PLAIN_READ_RUNS:
            # the same run reading through the plain versions, the
            # arithmetic the port read with before its compiled host code
            with plain_host_read():
                again, _, _ = run_cli(
                    torch, FA, C3, BA, model, work,
                    ["--dataset", str(clip), "--config", cfg_path,
                     "--no-viz", "--save-as", f"{tag}_plain"],
                    f"{tag} plain read", calib=calib, ba_path=ba_path,
                    k2_path=k2_path)
            a, b = cli_decisions(out), cli_decisions(again)
            del again
            for key in ("modes", "kfs", "edges"):
                check(a[key] == b[key], f"cli {tag}: {key} differ with the "
                      f"plain read: {a[key]} vs {b[key]}")
            check(same_bits(a["T"], b["T"]), f"cli {tag}: keyframe poses "
                  f"differ with the plain read by "
                  f"{float((a['T'] - b['T']).abs().max()):.3e}")
            plain_run = ("; with the plain read the same modes, keyframes, "
                         "edges and keyframe poses (bit for bit)")
        kernel = "K5" if calib else "K4"
        check(launches["K1"] > 0 and launches[kernel] > 0
              and launches[f"BA {ba_path}"] == launches[kernel]
              and launches["K2"] > 0
              and launches[f"K2 {k2_path}"] == launches["K2"],
              f"cli {tag}: K1 or {kernel} not launched, a BA system build "
              f"not on {kernel}'s {ba_path} path, or a conv not on K2's "
              f"{k2_path} path")
        if calib:
            K = out["keyframes"].K
            check(K is not None and bool(torch.allclose(
                K.cpu(), torch.as_tensor(intr.K_frame))),
                f"cli {tag}: the BA's K is not K_frame")
        seq = clip.name
        check_outputs(out, work / "logs" / tag / seq, seq, DATA_FRAMES,
                      (h, w))
        decided[tag] = dict(modes=list(out["modes"]),
                            keyframes=len(out["keyframes"]),
                            edge_pairs=graph_edges(out["graph"]))
        if baseline is not None:
            for key, got in decided[tag].items():
                check(got == decided[baseline][key],
                      f"cli {tag}: {key} {got}, the {baseline} run's "
                      f"{decided[baseline][key]}")
        parts = cli_parts(rec)
        summary[tag] = dict(tracked_ms=parts["track"], step_ms=parts["step"],
                            read_ms=statistics.median(read_ms),
                            read_new_ms=turns["new"],
                            read_plain_ms=turns["plain"],
                            keyframes=len(out["keyframes"]),
                            edges=out["graph"].n_edges(),
                            launches={k: launches[k] for k in (
                                "K1", "K2", f"K2 {k2_path}", kernel,
                                f"BA {ba_path}")},
                            crop=(h, w), pp=pp)
        log(f"cli {tag}: {w}x{h} crop"
            + (f", K_frame principal point ({pp[0]:.3f}, {pp[1]:.3f})"
               if pp else "") + f"; median tracked frame "
            f"{parts['track']:.1f} ms over {len(rec['ms']['track'])} "
            f"frames, median frame read (dataset[i] + create_frame) "
            f"{summary[tag]['read_ms']:.2f} ms in the run (after it, in "
            f"turns: compiled {turns['new']:.2f}, plain "
            f"{turns['plain']:.2f}, equal bits), median backend step "
            f"{parts['step']:.1f} ms over "
            f"{len(rec['ms']['step'])} steps; keyframes "
            f"{len(out['keyframes'])}, edges {out['graph'].n_edges()}; "
            f"K1 launches {launches['K1']}, {kernel} {ba_path} launches "
            f"{launches[kernel]}, K2 {k2_path} launches {launches['K2']}"
            + (f"; frames, modes, keyframes and edges as the {baseline} "
               f"run's" if baseline else "") + plain_run + f"; on {smi}")
        del out
    del model
    torch.cuda.empty_cache()
    return summary


# ---------------------------------------------------------------------------
# Phase 21: video files (data/containers.py, data/video.py)
# ---------------------------------------------------------------------------

VIDEO_FIXTURES = ROOT / "tests" / "data" / "video"
VIDEO_CLI = "cli_640x480.mp4"       # 16 frames of mp4v: GOP 12, no B-VOPs
VIDEO_CLI_H264 = "cli_640x480_h264.mp4"  # 16 frames of H.264 (CABAC): I, 15 P
VIDEO_H264_CAVLC = "h264_cavlc_640x480.avi"  # 4 frames of H.264 (CAVLC), Annex B
VIDEO_H264_1080 = "h264_1920x1080.mp4"  # 4 frames of H.264, coded at 1088
VIDEO_CLI_H264_B = "cli_640x480_h264_b.mp4"  # 16 frames of H.264 IBBP (CABAC)
VIDEO_H264_B_1080 = "h264_b_1920x1080.mp4"  # 6 frames of H.264 IBBP, at 1088
VIDEO_CLI_VP9 = "cli_640x480_vp9.mkv"  # 16 frames of VP9 (libvpx via cv2), 2 tile columns
# 16 frames of MPEG-4 Part 2 as Xvid writes it (XviD0064, fourcc XVID:
# FFmpeg's Xvid IDCT), IBBP with 4MV and AC prediction, and the test
# writer's smaller Xvid / DivX streams (B-VOPs in MP4 and Matroska, packed
# B-VOPs in AVI, the I/P tools under FF_BUG_EDGE / DC_CLIP)
VIDEO_CLI_XVID_B = "cli_640x480_xvid_b.avi"
VIDEO_MPEG4_WRITER = (VIDEO_CLI_XVID_B, "xvid_b.mp4", "xvid_b4mv.mkv", "divx_packed.avi",
                      "xvid_tools_66x50.avi")
VIDEO_VP9_1080 = "vp9_1920x1080.mkv"  # 4 frames of VP9, 4 tile columns
# HEVC from the test writer: 16 frames of the pan (I, 15 P), 8 of low-delay B
# pictures at 480x640, 4 at 1920x1080 (coded 1088), all three coded with the
# loop filters off and one CU a CTB; and random syntax, 6 frames of it (I,
# 5 P) at 480x640 with deblocking and SAO in every slice
VIDEO_CLI_HEVC = "cli_640x480_hevc.mp4"
VIDEO_HEVC_B = "hevc_b_640x480.mp4"
VIDEO_HEVC_1080 = "hevc_1920x1080.mp4"
VIDEO_HEVC_LF = "hevc_sao_640x480.mp4"
# and in GOP structures out of decode order: 32 frames of the pan in HM's
# hierarchical GOPs of 8 (a CRA picture with RASL pictures at frame 16,
# ctts; the CLI reads every second frame, each read a seek), and random
# syntax in x265's, HM's (its last picture not put out: its last read
# fails, as cv2's) and the BLA structures
VIDEO_CLI_HEVC_GOP = "cli_640x480_hevc_gop.mp4"
VIDEO_HEVC_GOP_SUBSAMPLE = 2
VIDEO_HEVC_WRITER = (VIDEO_CLI_HEVC, VIDEO_HEVC_B, VIDEO_HEVC_1080, VIDEO_HEVC_LF,
                     "hevc_main.mp4", "hevc_tiles.mkv", "hevc_ltr.mov", "hevc_hev1.mp4",
                     "hevc_ldb.mkv", VIDEO_CLI_HEVC_GOP, "hevc_x265.mp4", "hevc_hm.mkv",
                     "hevc_bla.mp4")
VIDEO_REPS = 10                     # timed passes over each codec's frames
VIDEO_HW = (480, 640)


def video_fixture_reads():
    """Every committed video fixture through ``VideoReader``: its fps,
    frame count and size as cv2 reported them, and every frame (in order,
    then backwards: every seek from its GOP's sync sample) at the SHA-256
    of cv2.VideoCapture's frame recorded beside it, or failing where cv2
    read none (the last frames of a file whose last pictures are not put
    out). Returns the frames read."""
    import hashlib

    from mast3r_slam_tpu_torch.data import video

    rec = json.loads((VIDEO_FIXTURES / "digests.json").read_text())
    check(VIDEO_CLI_H264_B in rec and VIDEO_H264_B_1080 in rec,
          "video: the B-picture fixtures are not in digests.json")
    check(sum(d["fourcc"] in ("VP90", "vp09") for d in rec.values()) == 11
          and VIDEO_CLI_VP9 in rec and VIDEO_VP9_1080 in rec,
          "video: the VP9 fixtures are not in digests.json")
    check(all(n in rec for n in VIDEO_MPEG4_WRITER),
          "video: the MPEG-4 writer's fixtures are not in digests.json")
    check(all(n in rec for n in VIDEO_HEVC_WRITER),
          "video: the HEVC writer's fixtures are not in digests.json")
    n = 0
    for name, want in sorted(rec.items()):
        r = video.VideoReader(VIDEO_FIXTURES / name)
        check(r.fps == want["fps"] and len(r) == want["frame_count"]
              and r.track.fourcc == want["fourcc"],
              f"video: {name} fps {r.fps}, {len(r)} frames, "
              f"{r.track.fourcc!r}; cv2 {want['fps']}, "
              f"{want['frame_count']}, {want['fourcc']!r}")
        order = list(range(len(r))) + list(range(len(r) - 1, -1, -1))
        for i in order:
            if want["frames"][i] is None:
                try:
                    r.read(i)
                except ValueError as e:
                    check(str(e) == f"failed to decode frame {i} of {r.path}",
                          f"video: {name} frame {i} fails as {e}")
                else:
                    check(False, f"video: {name} frame {i} reads, cv2 reads none")
                n += 1
                continue
            img = r.read(i)
            got = hashlib.sha256(img.tobytes()).hexdigest()
            check(list(img.shape[:2]) == want["hw"]
                  and got == want["frames"][i]["cv2"],
                  f"video: {name} frame {i} decodes to {img.shape} "
                  f"{got[:16]}, cv2's {want['frames'][i]['cv2'][:16]}")
            n += 1
    return n


def video_samples(name):
    """The track of committed fixture ``name`` and its samples' bytes."""
    from mast3r_slam_tpu_torch.data import containers

    path = VIDEO_FIXTURES / name
    t = containers.open_track(path)
    with open(path, "rb") as f:
        samples = []
        for off, size in zip(t.offsets, t.sizes):
            f.seek(int(off))
            samples.append(f.read(int(size)))
    return t, samples


def video_decode_times(smi):
    """Host ms a frame, decode and RGB conversion, at 480x640: MPEG-4
    I-VOPs (the CLI clip's sample 0, decoded anew each time), P-VOPs (its
    samples 1-11 in order), MJPEG (a 4:2:0 JPEG of the pan frame by the
    test encoder, as one Motion JPEG frame), an H.264 IDR picture (the H.264
    CLI clip's sample 0), H.264 CABAC P pictures (its samples 1-15) and
    CAVLC P pictures (the CAVLC clip's samples 1-3); and at 1920x1080 the
    H.264 clip's 4 pictures (IDR and P, coded at 1088, cropped); each beside
    the compiled and the plain numpy converter on the same planes, which
    must give the same bytes; HEVC likewise (the CLI clip's IDR picture and
    15 P pictures, the B clip's 6 low-delay B pictures after its I and P
    pictures, and the 1080p clip's 4 pictures, all with the loop filters
    off; the filtered random-syntax clip's I picture and 5 P pictures).
    Then the IBBP clips (480x640 and 1920x1080;
    H.264, and the Xvid one at 480x640 with its I-VOP too) and the HEVC
    clip of hierarchical GOPs (by picture: the IDR and CRA pictures, the
    P anchors, the reference and the non-reference B pictures; samples
    out of presentation order, a sample's frame the one it puts out);
    each sample decoded in turn with the frame it puts out converted, B pictures and P
    pictures timed apart (a B picture's sample puts out itself, a P
    picture's the B picture before it in display order, an Xvid I- or
    P-VOP's the reference before it)."""
    import numpy as np

    from mast3r_slam_tpu_torch.data import video

    t, samples = video_samples(VIDEO_CLI)
    gop = int(np.flatnonzero(t.sync)[1]) if t.sync.sum() > 1 else len(samples)
    th, hs = video_samples(VIDEO_CLI_H264)
    tc, cs = video_samples(VIDEO_H264_CAVLC)
    tk, ks = video_samples(VIDEO_H264_1080)
    _, vs = video_samples(VIDEO_CLI_VP9)
    _, v9 = video_samples(VIDEO_VP9_1080)
    he, hes = video_samples(VIDEO_CLI_HEVC)
    hb, hbs = video_samples(VIDEO_HEVC_B)
    hk, hks = video_samples(VIDEO_HEVC_1080)
    hf, hfs = video_samples(VIDEO_HEVC_LF)
    jw = _test_writer("torch_jpeg_writer")
    jpeg = jw.encode_jpeg(next(pan_frames(1, VIDEO_HW, (0, 0), seed=7)), 90)

    def timed(codec, extra, warm, frames, hw):
        """ms a frame of decode + rgb over ``frames`` (after ``warm``),
        VIDEO_REPS passes, each on a fresh decoder."""
        ms = []
        dec = None
        for _ in range(VIDEO_REPS):
            dec = video.Decoder(codec, extra)
            for w in warm:
                dec.decode(w)
            for data in frames:
                t0 = time.perf_counter()
                dec.decode(data)
                rgb = dec.rgb()
                ms.append((time.perf_counter() - t0) * 1e3)
        check(rgb.shape == (*hw, 3), f"video: frame {rgb.shape}, want {hw}")
        return statistics.median(ms), dec

    out = {}
    for kind, codec, extra, warm, frames, hw in (
            ("mpeg4_i", video.MPEG4, t.extradata, [], samples[:1], VIDEO_HW),
            ("mpeg4_p", video.MPEG4, t.extradata, samples[:1],
             samples[1:gop], VIDEO_HW),
            ("mjpeg", video.MJPEG, b"", [], [jpeg], VIDEO_HW),
            ("h264_idr", video.H264, th.extradata, [], hs[:1], VIDEO_HW),
            ("h264_cabac_p", video.H264, th.extradata, hs[:1], hs[1:],
             VIDEO_HW),
            ("h264_cavlc_p", video.H264, tc.extradata, cs[:1], cs[1:],
             VIDEO_HW),
            ("h264_1080", video.H264, tk.extradata, [], ks, (1080, 1920)),
            ("vp9_key", video.VP9, b"", [], vs[:1], VIDEO_HW),
            ("vp9_inter", video.VP9, b"", vs[:1], vs[1:12], VIDEO_HW),
            ("vp9_1080_key", video.VP9, b"", [], v9[:1], (1080, 1920)),
            ("vp9_1080_inter", video.VP9, b"", v9[:1], v9[1:], (1080, 1920)),
            ("hevc_idr", video.HEVC, he.extradata, [], hes[:1], VIDEO_HW),
            ("hevc_p", video.HEVC, he.extradata, hes[:1], hes[1:], VIDEO_HW),
            ("hevc_b", video.HEVC, hb.extradata, hbs[:2], hbs[2:], VIDEO_HW),
            ("hevc_1080", video.HEVC, hk.extradata, [], hks, (1080, 1920)),
            ("hevc_lf_i", video.HEVC, hf.extradata, [], hfs[:1], VIDEO_HW),
            ("hevc_lf_p", video.HEVC, hf.extradata, hfs[:1], hfs[1:], VIDEO_HW)):
        ms, dec = timed(codec, extra, warm, frames, hw)
        y, cb, cr = dec.planes()
        full = codec == video.MJPEG
        # the HEVC clips timed are BT.601 limited range (no VUI), as the others
        conv, plain = [], []
        pair = ((video.yuv_to_rgb, conv), (video.yuv_to_rgb_ref, plain))
        for k in range(VIDEO_REPS):  # in turns
            for fn, acc in (pair if k % 2 == 0 else pair[::-1]):
                t0 = time.perf_counter()
                rgb = fn(y, cb, cr, full)
                acc.append((time.perf_counter() - t0) * 1e3)
                check(np.array_equal(rgb, dec.rgb()), f"video: {kind} "
                      f"{fn.__name__} differs from the decoder's frame")
        out[kind] = dict(ms=ms, convert_ms=statistics.median(conv),
                         plain_convert_ms=statistics.median(plain),
                         frames=len(frames), hw=list(hw))
    tx, xs = video_samples(VIDEO_CLI_XVID_B)
    vop = [data[data.index(b"\x00\x00\x01\xb6") + 4] >> 6 for data in xs]
    ms = {0: [], 1: [], 2: []}
    for _ in range(VIDEO_REPS):
        dec = video.Decoder(video.MPEG4, tx.extradata, "XVID")
        for k, data in enumerate(xs):
            t0 = time.perf_counter()
            if dec.decode(data, k):
                dec.rgb()
            ms[vop[k]].append((time.perf_counter() - t0) * 1e3)
        while dec.flush():
            check(dec.rgb().shape == (*VIDEO_HW, 3), "video: Xvid frame shape")
    check(dec.mpeg4_info()["xvid_idct"], "video: the Xvid clip not under the Xvid IDCT")
    for t, tag in ((0, "xvid_i"), (1, "xvid_p"), (2, "xvid_b")):
        out[tag] = dict(ms=statistics.median(ms[t]), frames=len(ms[t]) // VIDEO_REPS,
                        hw=list(VIDEO_HW), convert_ms=float("nan"),
                        plain_convert_ms=float("nan"))
    for name, tag, hw in ((VIDEO_CLI_H264_B, "h264_ibbp", VIDEO_HW),
                          (VIDEO_H264_B_1080, "h264_ibbp_1080", (1080, 1920))):
        tb, bs = video_samples(name)
        is_b = [k > 0 and tb.pts[k] < tb.pts[:k].max() for k in range(len(bs))]
        ms = {True: [], False: []}
        for _ in range(VIDEO_REPS):
            dec = video.Decoder(video.H264, tb.extradata)
            dec.delay(tb.video_delay)
            for k, data in enumerate(bs):
                t0 = time.perf_counter()
                if dec.decode(data, k):
                    dec.rgb()
                if k:  # the IDR picture is timed above
                    ms[is_b[k]].append((time.perf_counter() - t0) * 1e3)
            while dec.flush():
                check(dec.rgb().shape == (*hw, 3), f"video: {name} frame shape")
        for b in (True, False):
            out[f"{tag}_{'b' if b else 'p'}"] = dict(
                ms=statistics.median(ms[b]), frames=len(ms[b]) // VIDEO_REPS,
                hw=list(hw), convert_ms=float("nan"), plain_convert_ms=float("nan"))
    out.update(hevc_gop_times())
    log("video: host ms a frame, 480x640 unless named (decode + RGB; "
        "converter compiled / plain numpy on the same planes, equal bytes): "
        + ", ".join(f"{k} {v['ms']:.3f} ({v['convert_ms']:.3f} / "
                    f"{v['plain_convert_ms']:.2f})" for k, v in out.items()
                    if v["convert_ms"] == v["convert_ms"])
        + "; IBBP clips, ms a sample (decode + RGB of the frame it puts "
        "out): " + ", ".join(f"{k} {v['ms']:.3f} ({v['frames']} samples)"
                             for k, v in out.items()
                             if v["convert_ms"] != v["convert_ms"])
        + f"; median of {VIDEO_REPS} passes; on {smi}")
    return out


def hevc_gop_times():
    """Host ms a sample of the HEVC clip of hierarchical GOPs by picture
    type (NAL unit type, and whether its presentation time is the latest
    yet): decode, and RGB of the frame it puts out, in decode order from
    the start, VIDEO_REPS passes on fresh decoders; every frame put out."""
    from mast3r_slam_tpu_torch.data import video

    tg, gs = video_samples(VIDEO_CLI_HEVC_GOP)
    nal_len = (tg.extradata[21] & 3) + 1
    kinds = []
    for k, data in enumerate(gs):
        nal = video._nal_types(data, nal_len, True)[0]
        kinds.append({19: "hevc_gop_idr", 20: "hevc_gop_idr", 21: "hevc_gop_cra"}.get(nal)
                     or ("hevc_gop_b" if nal in (0, 8) else
                         "hevc_gop_p" if tg.pts[k] > tg.pts[:k].max() else "hevc_gop_ref_b"))
    ms = {kind: [] for kind in kinds}
    for _ in range(VIDEO_REPS):
        dec = video.Decoder(video.HEVC, tg.extradata)
        got = 0
        for k, data in enumerate(gs):
            t0 = time.perf_counter()
            if dec.decode(data, k):
                dec.rgb()
                got += 1
            ms[kinds[k]].append((time.perf_counter() - t0) * 1e3)
        while dec.flush():
            got += 1
            check(dec.rgb().shape == (*VIDEO_HW, 3), "video: HEVC GOP frame shape")
        check(got == len(gs), f"video: {VIDEO_CLI_HEVC_GOP} put out {got} frames of "
              f"{len(gs)}")
    check(set(ms) == {"hevc_gop_idr", "hevc_gop_cra", "hevc_gop_p", "hevc_gop_ref_b",
                      "hevc_gop_b"}, f"video: {VIDEO_CLI_HEVC_GOP} picture types {set(ms)}")
    return {kind: dict(ms=statistics.median(v), frames=len(v) // VIDEO_REPS,
                       hw=list(VIDEO_HW), convert_ms=float("nan"),
                       plain_convert_ms=float("nan")) for kind, v in ms.items()}


def mpeg4_plain_checks():
    """MPEG-4 Part 2's plain numpy versions against the compiled entries
    on random inputs: the Xvid IDCT put and added (DC rows, sparse, dense
    and 16-bit-saturating blocks), half-pel blocks 8 and 16 wide at every
    position with and without rounding (the 8-wide no_rnd approximation),
    and the B-VOP average of two half-pel predictions, past the planes'
    edges; the cases held, each equal bit for bit."""
    import numpy as np

    from mast3r_slam_tpu_torch.data import video

    rng = np.random.default_rng(26)
    n = 0
    for trial in range(200):
        blk = np.zeros(64, np.int16)
        kind = trial % 4
        if kind == 0:
            blk[::8] = rng.integers(-2048, 2048, 8)
        elif kind == 1:
            k = int(rng.integers(1, 10))
            blk[rng.integers(0, 64, k)] = rng.integers(-300, 300, k)
        elif kind == 2:
            blk[:] = rng.integers(-2048, 2048, 64)
        else:
            blk[rng.integers(0, 64, 3)] = rng.integers(-32768, 32768, 3)
        base = rng.integers(0, 256, (8, 8)).astype(np.uint8)
        for add in (0, 1):
            want = np.clip(base.astype(np.int64) * add + video.xvid_idct_ref(blk), 0, 255)
            check(np.array_equal(video.xvid_idct(blk, add, base), want),
                  f"video: xvid_idct (add {add}) differs from its plain version")
            n += 1
    plane = rng.integers(0, 256, (21, 27)).astype(np.uint8)
    plane[rng.random(plane.shape) < 0.2] = 0  # where no_rnd's approximation shows
    other = rng.integers(0, 256, (21, 27)).astype(np.uint8)
    for size in (8, 16):
        for dxy in range(4):
            for rounding in (0, 1):
                for _ in range(6):
                    x, y = int(rng.integers(-20, 30)), int(rng.integers(-20, 25))
                    got = np.empty((size, size), np.uint8)
                    video.load_library().vd_hpel(video._u8(plane), 27, 27, 21, x, y, dxy,
                                                 rounding, size, video._u8(got))
                    check(np.array_equal(got, video.hpel_ref(plane, x, y, dxy, rounding, size)),
                          f"video: MPEG-4 half-pel {size} dxy {dxy} rounding {rounding} "
                          "differs from its plain version")
                    n += 1
            for _ in range(6):
                fwd = (int(rng.integers(-20, 30)), int(rng.integers(-20, 25)), dxy)
                bwd = (int(rng.integers(-20, 30)), int(rng.integers(-20, 25)),
                       int(rng.integers(0, 4)))
                check(np.array_equal(video.mpeg4_bipred(plane, other, fwd, bwd, size),
                                     video.mpeg4_bipred_ref(plane, other, fwd, bwd, size)),
                      f"video: the B-VOP average {size} differs from its plain version")
                n += 1
    log(f"video: MPEG-4's plain versions equal the compiled entries on {n} cases "
        f"(Xvid IDCT, half-pel blocks, B-VOP average)")
    return n


def vp9_plain_checks():
    """VP9's three plain numpy versions against the compiled entries on
    random inputs: every inverse transform size and type and the WHT, the
    four filters at every 1/16 fraction (put and averaged, past the
    plane's edges) and the three loop-filter widths at every level and
    sharpness; the cases held, each equal bit for bit."""
    import numpy as np

    from mast3r_slam_tpu_torch.data import video

    rng = np.random.default_rng(25)
    n = 0
    for tx in range(4):
        m = 4 << tx
        for tx_type in ([0, 1, 2, 3, 4] if tx == 0 else [0, 1, 2, 3] if tx < 3 else [0]):
            for _ in range(4):
                c = np.zeros((m, m), np.int64)
                k = int(rng.integers(1, min(m * m, 64)))
                c.flat[rng.choice(m * m, k, replace=False)] = rng.integers(-400, 401, k)
                pred = rng.integers(0, 256, (m, m)).astype(np.uint8)
                check(np.array_equal(video.vp9_itx(c, tx, tx_type, pred),
                                     video.vp9_itx_ref(c, tx, tx_type, pred)),
                      f"video: vp9_itx tx {tx} type {tx_type} differs from its plain version")
                n += 1
    plane = rng.integers(0, 256, (21, 27)).astype(np.uint8)
    for filt in range(4):
        for fx in range(16):
            for fy in range(0, 16, 5):
                x, y = int(rng.integers(-12, 32)), int(rng.integers(-12, 26))
                dst = rng.integers(0, 256, (8, 8)).astype(np.uint8) if fx & 1 else None
                check(np.array_equal(video.vp9_mc(plane, x, y, fx, fy, 8, 8, filt, dst),
                                     video.vp9_mc_ref(plane, x, y, fx, fy, 8, 8, filt, dst)),
                      f"video: vp9_mc filter {filt} ({fx}, {fy}) differs from its plain version")
                n += 1
    for wd in (4, 8, 16):
        for level in range(1, 64, 6):
            for sharp in range(8):
                base = rng.integers(60, 200, (8, 1)) + \
                    rng.integers(-2, 3, (8, 16)) * int(rng.integers(0, 3))
                base[:, 8:] += int(rng.integers(-10, 11))
                lines = np.clip(base, 0, 255).astype(np.uint8)
                check(np.array_equal(video.vp9_lf(lines, wd, level, sharp),
                                     video.vp9_lf_ref(lines, wd, level, sharp)),
                      f"video: vp9_lf width {wd} level {level} differs from its plain version")
                n += 1
    log(f"video: VP9's plain versions equal the compiled entries on {n} cases "
        f"(inverse transforms, 8-tap prediction, loop-filter edges)")
    return n


def hevc_plain_checks():
    """HEVC's five plain numpy versions against the compiled entries on
    random inputs: the inverse DCT at 4-32, the 4x4 DST and transform skip
    (sparse and saturated coefficients), luma and chroma interpolation at
    every fraction, uni and bi, default and explicit weights, past the
    plane's edges, the 35 intra modes of luma and chroma at every size with
    random availability, one deblocking edge of luma and chroma over bS,
    QPs and offsets, and SAO band and edge offsets of a block with usable
    and unusable neighbours; the cases held, each equal bit for bit."""
    import numpy as np

    from mast3r_slam_tpu_torch.data import video

    rng = np.random.default_rng(27)
    n = 0
    for log2 in (2, 3, 4, 5):
        m = 1 << log2
        for t in range(12):
            c = rng.integers(-400, 400, (m, m)) * (rng.random((m, m)) < 0.2)
            if t % 6 == 0:
                c = rng.integers(-32768, 32768, (m, m))
            for trtype, skip in ([(0, False), (1, False), (0, True)] if log2 == 2 else
                                 [(0, False)]):
                check(np.array_equal(video.hevc_idct(c, log2, trtype, skip),
                                     video.hevc_idct_ref(c, log2, trtype, skip)),
                      f"video: hevc_idct {m}x{m} type {trtype} skip {skip} differs "
                      "from its plain version")
                n += 1
    p0 = rng.integers(0, 256, (24, 32)).astype(np.uint8)
    p1 = rng.integers(0, 256, (24, 32)).astype(np.uint8)
    for chroma in (False, True):
        for frac in range(8 if chroma else 4):
            for pred in (1, 2, 3):
                for weighted in (False, True):
                    mv = rng.integers(-96, 96, 4) * (8 if chroma else 4) // 4
                    mv[0] = (mv[0] & ~(7 if chroma else 3)) | frac
                    mv[3] = (mv[3] & ~(7 if chroma else 3)) | frac
                    wt = ((int(rng.integers(6, 14)), int(rng.integers(-128, 256)),
                           int(rng.integers(-128, 256)), int(rng.integers(-128, 128)),
                           int(rng.integers(-128, 128))) if weighted else None)
                    x, y = int(rng.integers(-12, 32)), int(rng.integers(-12, 24))
                    bw, bh = int(rng.choice([4, 8, 16])), int(rng.choice([4, 8, 12, 16]))
                    check(np.array_equal(video.hevc_mc(p0, p1, chroma, x, y, mv, pred, bw, bh, wt),
                                         video.hevc_mc_ref(p0, p1, chroma, x, y, mv, pred, bw,
                                                           bh, wt)),
                          f"video: hevc_mc chroma {chroma} pred {pred} weighted {weighted} "
                          "differs from its plain version")
                    n += 1
    for log2 in (2, 3, 4, 5):
        m = 1 << log2
        for mode in range(35):
            ref = rng.integers(0, 256, 4 * m + 1)
            if mode % 2:
                ref = np.clip(100 + np.cumsum(rng.integers(-2, 3, 4 * m + 1)), 0, 255)
            av = rng.random(4 * m + 1) < (0.5, 1.0, 0.0)[mode % 3]
            for c in (0, 1):
                check(np.array_equal(video.hevc_intra(ref, av, log2, c, mode, True),
                                     video.hevc_intra_ref(ref, av, log2, c, mode, True)),
                      f"video: hevc_intra {m}x{m} mode {mode} c {c} differs from its "
                      "plain version")
                n += 1
    for t in range(200):
        base = int(rng.integers(40, 216))
        lines = np.clip(base + rng.integers(-6, 7, (4, 8)) +
                        np.array([0] * 4 + [1] * 4) * int(rng.integers(-24, 25)), 0, 255)
        args = (bool(t % 2), int(rng.integers(0, 3)), int(rng.integers(0, 52)),
                int(rng.integers(-6, 7)), int(rng.integers(-6, 7)), int(rng.integers(-12, 13)),
                bool(rng.random() < 0.1), bool(rng.random() < 0.1))
        check(np.array_equal(video.hevc_deblock(lines, *args), video.hevc_deblock_ref(lines, *args)),
              f"video: hevc_deblock {args} differs from its plain version")
        n += 1
    for t in range(40):
        h, w = int(rng.integers(1, 33)), int(rng.integers(1, 33))
        pad = rng.integers(0, 256, (h + 2, w + 2)).astype(np.uint8)
        args = (1 + t % 2, int(rng.integers(0, 32)), int(rng.integers(0, 4)),
                rng.integers(-7, 8, 4), rng.random(8) < 0.7)
        check(np.array_equal(video.hevc_sao(pad, *args), video.hevc_sao_ref(pad, *args)),
              "video: hevc_sao differs from its plain version")
        n += 1
    log(f"video: HEVC's plain versions equal the compiled entries on {n} cases "
        f"(inverse transforms, interpolation and weighting, intra prediction, "
        f"deblocking edges, SAO)")
    return n


def phase_video(torch, FA, C3, BA, workdir, smi):
    """Video files on this machine: the decoder built here reads every
    committed fixture (MPEG-4 Part 2 in MP4, MOV, AVI and Matroska; MJPEG
    in AVI and Matroska; H.264 in MP4, Matroska and AVI) to the SHA-256 of
    cv2.VideoCapture's frames recorded beside them; the host ms a frame of
    each codec (:func:`video_decode_times`) beside the plain converter;
    then the CLI at full ViT-L width on the committed 16-frame 480x640
    mp4v clip, the H.264 I/P one, the H.264 IBBP one, the VP9 one, the
    Xvid IBBP one (B-VOPs, 4MV, FFmpeg's Xvid IDCT), the HEVC one (the
    test writer's encoder: IDR, 15 P) and every second frame of the HEVC
    clip of hierarchical GOPs (32 frames, a CRA picture at frame 16: each
    read a seek, some across the open GOP) under base.yaml with
    the services off (bf16: K1, K2 on the implicit GEMM, K4 on the
    tensor cores), each
    checking all 16 frames read, its outputs and its launches as the
    cli_datasets phase's image-folder run does, with the median tracked
    frame and frame read (``dataset[i]`` + ``create_frame``)."""
    from mast3r_slam_tpu_torch.data import video

    t0 = time.perf_counter()
    video.load_library()
    build_s = time.perf_counter() - t0
    n_reads = video_fixture_reads()
    log(f"video: decoder built in {build_s:.1f} s; {n_reads} frame reads of "
        f"the committed fixtures (in order and backwards) equal "
        f"cv2.VideoCapture's")
    out = {"decode": video_decode_times(smi), "vp9_plain_cases": vp9_plain_checks(),
           "mpeg4_plain_cases": mpeg4_plain_checks(), "hevc_plain_cases": hevc_plain_checks()}
    out["cli"] = video_cli_run(torch, FA, C3, BA, workdir, smi, VIDEO_CLI,
                               "video")
    out["cli_h264"] = video_cli_run(torch, FA, C3, BA, workdir, smi,
                                    VIDEO_CLI_H264, "video_h264")
    out["cli_h264_b"] = video_cli_run(torch, FA, C3, BA, workdir, smi,
                                      VIDEO_CLI_H264_B, "video_h264_b")
    out["cli_vp9"] = video_cli_run(torch, FA, C3, BA, workdir, smi,
                                   VIDEO_CLI_VP9, "video_vp9")
    out["cli_xvid_b"] = video_cli_run(torch, FA, C3, BA, workdir, smi,
                                      VIDEO_CLI_XVID_B, "video_xvid_b")
    out["cli_hevc"] = video_cli_run(torch, FA, C3, BA, workdir, smi,
                                    VIDEO_CLI_HEVC, "video_hevc")
    out["cli_hevc_gop"] = video_cli_run(torch, FA, C3, BA, workdir, smi, VIDEO_CLI_HEVC_GOP,
                                        "video_hevc_gop", subsample=VIDEO_HEVC_GOP_SUBSAMPLE)
    return out


def video_cli_run(torch, FA, C3, BA, workdir, smi, name, tag, subsample=1):
    """The CLI on committed clip ``name`` (16 frames read, 480x640: every
    ``subsample``-th frame, each read then a seek) at full ViT-L width
    under base.yaml with the services off, checked as :func:`phase_video`
    says; its numbers."""
    from mast3r_slam_tpu_torch.data.datasets import load_dataset
    from mast3r_slam_tpu_torch.utils.config import load_config

    work = Path(workdir)
    clip = VIDEO_FIXTURES / name
    cfg_path = write_config(work / f"cli_{tag}.yaml", **SERVICES_OFF,
                            dataset={"subsample": subsample})
    cfg = load_config(cfg_path)
    k2_path = C3.conv3x3_path(getattr(torch, cfg["model"]["head_dtype"]),
                              256, 256)
    ba_path = BA.gram_path(getattr(torch,
                                   cfg["local_opt"]["ba_compute_dtype"]))
    ds = load_dataset(str(clip), cfg)
    n_frames = len(ds)
    check(type(ds).__name__ == "MP4Dataset" and n_frames == 16,
          f"video: {clip.name} read as {type(ds).__name__} of {n_frames} "
          f"frames")
    (h, w), _ = ds.get_img_shape()
    t0 = time.perf_counter()
    model = tied_model(cfg, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    with timed_frame_reads([]) as read_ms:
        res, launches, rec = run_cli(
            torch, FA, C3, BA, model, work,
            ["--dataset", str(clip), "--config", cfg_path, "--no-viz",
             "--save-as", tag], tag, ba_path=ba_path,
            k2_path=k2_path)
    check(len(read_ms) == n_frames, f"video: {len(read_ms)} frame reads "
          f"timed, {n_frames} frames")
    check(launches["K1"] > 0 and launches["K4"] > 0
          and launches[f"BA {ba_path}"] == launches["K4"]
          and launches["K2"] > 0
          and launches[f"K2 {k2_path}"] == launches["K2"],
          f"video: K1 or K4 not launched, a BA system build not on K4's "
          f"{ba_path} path, or a conv not on K2's {k2_path} path")
    check(len(res["keyframes"]) >= 1, f"video: no keyframe in {name}")
    check_outputs(res, work / "logs" / tag / clip.name, clip.name,
                  n_frames, (h, w))
    parts = cli_parts(rec)
    out = dict(tracked_ms=parts["track"], step_ms=parts["step"],
               read_ms=statistics.median(read_ms),
               keyframes=len(res["keyframes"]),
               edges=res["graph"].n_edges(),
               launches={k: launches[k] for k in (
                   "K1", "K2", f"K2 {k2_path}", "K4", f"BA {ba_path}")})
    log(f"video cli: {clip.name} ({n_frames} frames, subsample {subsample}, {w}x{h} crop, model "
        f"init {init_s:.1f} s): median tracked frame {parts['track']:.1f} ms "
        f"over {len(rec['ms']['track'])} frames, median frame read "
        f"(dataset[i] + create_frame) {out['read_ms']:.2f} ms, median "
        f"backend step {parts['step']:.1f} ms; keyframes "
        f"{out['keyframes']}, edges {out['edges']}; launches "
        f"{out['launches']}; on {smi}")
    del res, model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 16-18: the accuracy tools (bench/ate_study.py, bench/eval_datasets.py,
# bench/retrieval_recall.py)
# ---------------------------------------------------------------------------

# the modes table's ablation: its BA is not expected to hold the tracked
# trajectory (the JAX study records it at 3.5x strict, 61.4 mm)
ATE_ABLATION = "separable (ablation)"
ATE_BASE_ROW = "production-defaults (all cuts, base.yaml)"
# a TUM-layout clip's ground truth: the pan's camera moving along x and y
GT_STEP = (0.02, 0.007)


def check_ate_rows(rows, tag):
    """Each row of a one-seed study run on the card: no skips, a keyframe
    every 4 frames, the BA's K4 (rays) or K5 (calibrated) launched 1 + LM
    iterations times, all on the path of the row's Gram rows (float32:
    ``tf32``, else ``mma``), nothing else; but for the ablation, ATE after
    BA under 30 mm and at most 1.05x the tracked one."""
    from mast3r_slam_tpu_torch.bench import ate_study as AS

    for r in rows:
        what = f"ate_study {tag} {r['row']!r}"
        kfs = [r["frames"] // AS.KF_EVERY] * len(r["seeds"])
        check(r["skips"] == [0] * len(r["seeds"]) and r["keyframes"] == kfs,
              f"{what}: skips {r['skips']}, keyframes {r['keyframes']}")
        kernel, other = ("K5", "K4") if r["calib"] else ("K4", "K5")
        path = ("tf32" if r["mode"].get("ba_compute_dtype") == "float32"
                else "mma")
        for iters, n in zip(r["lm_iters"], r["launches"]):
            want = {kernel: 1 + iters, other: 0,
                    **{p: (1 + iters if p == path else 0)
                       for p in ("mma", "tf32", "fma")}}
            check(n == want, f"{what}: BA launches {n}, want {want}")
        if r["row"] != ATE_ABLATION:
            for at, ab in zip(r["ate_track"], r["ate_ba"]):
                check(ab < 0.03 and ab <= 1.05 * at, f"{what}: ATE after BA "
                      f"{ab:.5f} m, tracked {at:.5f} m")


def phase_ate_study(torch, FA, C3, BA, smi):
    """``bench/ate_study.py``'s ``modes`` table at the JAX scripts' protocol
    (96 frames, 64x96, a keyframe every 4, 30 BA iterations) with noise
    seed 0 on the card, then base.yaml's row with the calibrated solves:
    each row checked by :func:`check_ate_rows`, and base.yaml's cuts against
    strict as ``tests/test_oracle_modes.py`` bounds them (ATE after BA
    within 2x strict + 1 mm, matched-pixel error within +0.5 px)."""
    import functools

    from mast3r_slam_tpu_torch.bench import ate_study as AS
    from mast3r_slam_tpu_torch.utils.oracle_scene import (
        OracleScene, make_trajectory, run_oracle_slam)

    run = functools.partial(run_oracle_slam, kf_every=AS.KF_EVERY,
                            device="cuda")
    scene, poses = OracleScene(seed=0), make_trajectory(AS.FRAMES)
    reset_counters(FA, C3, BA)
    rays = AS.run_study("modes", run, scene, poses, AS.HW, (0,), False, smi,
                        emit=log)
    calib = AS.run_study("modes", run, scene, poses, AS.HW, (0,), True, smi,
                         modes={ATE_BASE_ROW: AS.MODES[ATE_BASE_ROW]},
                         emit=log)
    launches = launch_counts(FA, C3, BA)
    check(not any(launches[k] for k in ("K1", "K2", "K3",
                                        *dict(K4P_ALL))),
          f"ate_study: a kernel other than K4 / K5 ran: {launches}")
    check_ate_rows(rays, "rays")
    check_ate_rows(calib, "calib")
    strict = rays[0]
    fast = next(r for r in rays if r["row"] == ATE_BASE_ROW)
    check(fast["ate_ba_mean"] < 2.0 * strict["ate_ba_mean"] + 1e-3
          and fast["pix_err_mean"] < strict["pix_err_mean"] + 0.5,
          f"ate_study: base.yaml's cuts cost more than the bound: ATE "
          f"{fast['ate_ba_mean']:.5f} vs strict {strict['ate_ba_mean']:.5f}"
          f" m, pixel error {fast['pix_err_mean']:.3f} vs "
          f"{strict['pix_err_mean']:.3f}")
    out = {}
    for r in rays + calib:
        tag = ("calib " if r["calib"] else "") + r["row"]
        out[tag] = {k: r[k] for k in ("ate_track_mean", "ate_ba_mean",
                                      "pix_err_mean", "lm_iters", "wall_s")}
        log(f"ate_study {tag}: {r['wall_s']:.1f} s, ATE track "
            f"{r['ate_track_mean'] * 1e3:.3f} mm, BA "
            f"{r['ate_ba_mean'] * 1e3:.3f} mm, pixel error "
            f"{r['pix_err_mean']:.4f}, LM iterations {r['lm_iters']}, "
            f"launches {r['launches']}; on {smi}")
    return out


def write_tum_groundtruth(clip, n_frames):
    """``groundtruth.txt`` beside a ``write_clip`` clip: a pose a frame at
    its ``rgb.txt`` timestamp, moving ``GT_STEP`` a frame out and back."""
    rows = []
    for i in range(n_frames):
        p = min(i, n_frames - 1 - i)
        rows.append(f"{1e9 + i / 30.0:.6f} {GT_STEP[0] * p:.6f} "
                    f"{GT_STEP[1] * p:.6f} 0.000000 0 0 0 1")
    (Path(clip) / "groundtruth.txt").write_text(
        "# timestamp tx ty tz qx qy qz qw\n" + "\n".join(rows) + "\n")


def write_seven_scenes_clip(scene, n_frames):
    """7-Scenes' layout: ``seq-01/frame-XXXXXX.color.png`` (the cli phase's
    480x640 pan) and ``frame-XXXXXX.pose.txt`` camera-to-world matrices
    moving ``GT_STEP`` a frame out and back, with a small turn about y."""
    import numpy as np

    from mast3r_slam_tpu_torch.data import png

    seq = Path(scene) / "seq-01"
    seq.mkdir(parents=True, exist_ok=True)
    for i, img in enumerate(pan_frames(n_frames, CLI_SRC_HW, CLI_STEP,
                                       seed=3)):
        png.write_png(seq / f"frame-{i:06d}.color.png", img)
        p = min(i, n_frames - 1 - i)
        a = 0.01 * p
        T = np.eye(4)
        T[0, 0] = T[2, 2] = math.cos(a)
        T[0, 2], T[2, 0] = math.sin(a), -math.sin(a)
        T[:2, 3] = GT_STEP[0] * p, GT_STEP[1] * p
        np.savetxt(seq / f"frame-{i:06d}.pose.txt", T)
    return Path(scene)


def phase_eval_harness(torch, FA, C3, BA, workdir, smi):
    """``bench/eval_datasets.py`` at full ViT-L width on ``DATA_FRAMES``-
    frame clips the phase writes: a calibrated TUM freiburg1 clip with its
    ``groundtruth.txt``, and a 7-Scenes scene with its pose files (the
    ground truth derived by ``data/seven_scenes_gt.py``), each under the
    dataset's config with ``CLI_CUTS`` through an appended ``--config``,
    the model the tied random weights (``tied_model``). Each run writes
    ``logs/<save_as>/<seq>/<seq>.txt`` under the harness's workdir, its
    ATE equals ``evaluation.ate_rmse`` on the same two files, and K1, K2
    and K5 launch as its model calls and solves need, K2 on ``tf32x3``
    and K5 on ``tf32`` (eval_calib's f32 heads and BA rows)."""
    from mast3r_slam_tpu_torch import evaluation
    from mast3r_slam_tpu_torch import main as cli
    from mast3r_slam_tpu_torch.bench import eval_datasets as ED
    from mast3r_slam_tpu_torch.utils.config import load_config

    work = Path(workdir) / "eval_harness"
    tum = write_clip(work / "tum" / "rgbd_dataset_freiburg1_desk",
                     DATA_FRAMES)
    write_tum_groundtruth(tum, DATA_FRAMES)
    chess = write_seven_scenes_clip(work / "7-scenes" / "chess", DATA_FRAMES)
    model, summary = None, {}
    for dataset, clip in (("tum", tum), ("7-scenes", chess)):
        spec = ED.DATASETS[dataset]
        cfg_path = write_config(work / f"harness_{dataset}.yaml",
                                inherit=spec.config)
        cfg = load_config(cfg_path)
        if model is None:
            model = tied_model(cfg, "cuda")
        k2_path = C3.conv3x3_path(getattr(torch, cfg["model"]["head_dtype"]),
                                  256, 256)
        ba_path = BA.gram_path(getattr(
            torch, cfg["local_opt"]["ba_compute_dtype"]))
        check((k2_path, ba_path) == ("tf32x3", "tf32"),
              f"eval_harness {dataset}: {spec.config} takes K2 {k2_path}, "
              f"K5 {ba_path}")
        t0 = time.perf_counter()
        with (instrumented(torch, model) as rec, worker_faults() as faults,
              contextlib.ExitStack() as stack):
            saved = cli.build_model
            cli.build_model = lambda *a, **kw: model
            stack.callback(setattr, cli, "build_model", saved)
            reset_counters(FA, C3, BA)
            out = ED.main([dataset, str(clip.parent), "--workdir", str(work),
                           "--config", cfg_path], device="cuda")
            torch.cuda.synchronize()
            launches = launch_counts(FA, C3, BA)
        wall = time.perf_counter() - t0
        check_no_faults(faults, f"eval_harness {dataset}")
        seq = clip.name
        check(list(out["sequences"]) == [seq]
              and out["skipped"] == [s for s in ED.sequences(dataset,
                                                             clip.parent)
                                     if s != seq],
              f"eval_harness {dataset}: sequences {list(out['sequences'])}, "
              f"skipped {out['skipped']}")
        r = out["sequences"][seq]
        est = work / "logs" / spec.save_as / seq / f"{seq}.txt"
        gt = (clip / "groundtruth.txt" if dataset == "tum" else
              work / "groundtruths" / "7-scenes" / f"{seq}.txt")
        check(Path(r["traj"]) == est and est.is_file()
              and Path(r["gt"]) == gt and gt.is_file(),
              f"eval_harness {dataset}: trajectory {r['traj']}, ground "
              f"truth {r['gt']}")
        want_ate = evaluation.ate_rmse(gt, est, align=True, scale=True)
        check(math.isfinite(r["ate_rmse"])
              and r["ate_rmse"] == want_ate["rmse"]
              and r["frames"] == DATA_FRAMES,
              f"eval_harness {dataset}: ATE {r['ate_rmse']} vs "
              f"{want_ate['rmse']}, frames {r['frames']}")
        want = expected_launches(rec["calls"], True, ba_path, k2_path)
        check(launches == want and launches["K5"] > 0,
              f"eval_harness {dataset}: launches {launches} != {want}")
        summary[dataset] = dict(ate_rmse=r["ate_rmse"], pairs=r["pairs"],
                                keyframes=r["keyframes"],
                                tracked_ms=r["tracked_ms_median"],
                                step_ms=r["step_ms_median"], wall_s=wall,
                                launches={k: launches[k] for k in (
                                    "K1", "K2", "K5", f"K2 {k2_path}",
                                    f"BA {ba_path}")})
        log(f"eval_harness {dataset}: {wall:.1f} s, {r['frames']} frames, "
            f"{r['keyframes']} keyframes, ATE {r['ate_rmse']:.6f} m over "
            f"{r['pairs']} pairs (= evaluation.ate_rmse), median tracked "
            f"frame {r['tracked_ms_median']:.1f} ms, backend step "
            f"{r['step_ms_median']:.1f} ms; launches "
            f"{summary[dataset]['launches']}; on {smi}")
    del model
    torch.cuda.empty_cache()
    return summary


def phase_recall(torch, FA, C3, BA, smi):
    """``bench/retrieval_recall.py``'s tables at full ViT-L width on
    384x512 frames (random weights from seed 0): every frame encoded with
    K1's launches (24 a frame, no K2), recall@1-3 in [0, 1], and the
    encoder's ms a frame."""
    from mast3r_slam_tpu_torch.bench import retrieval_recall as RR

    reset_counters(FA, C3, BA)
    t0 = time.perf_counter()
    out = RR.main([], device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(FA, C3, BA)
    want = {k: 0 for k in launches}
    want.update(K1=(K1_PER_PAIR - K1_PER_DECODE) * out["frames"])
    check(out["frames"] == 2 * RR.N_HALF and launches == want,
          f"recall: {out['frames']} frames, launches {launches} != {want}")
    recalls = [out["bootstrap"], out["head"], *out["min_thresh"].values()]
    check(all(set(r) == {1, 2, 3} and all(0.0 <= v <= 1.0
                                          for v in r.values())
              for r in recalls), f"recall: recall@k out of range {recalls}")
    log(f"recall: {wall:.1f} s, {out['frames']} frames at "
        f"{RR.FULL_HW[0]}x{RR.FULL_HW[1]}, encoder median "
        f"{out['encode_ms']:.2f} ms a frame, K1 launches {launches['K1']}; "
        f"recall@1-3 bootstrap {out['bootstrap']}, projector head "
        f"{out['head']}; on {smi}")
    return dict(out, launches=launches["K1"], wall_s=wall)


class _ForcedRetrieval:
    """Retrieval stand-in that always proposes keyframes 0 and 1, so that
    the strict geometric check is what rejects an impostor."""

    def update(self, frame, add_after_query, k, min_thresh=0.0,
               kf_idx=None, skip_query=False):
        return [] if skip_query else [0, 1]


def phase_reloc(torch, FA, C3, BA):
    """``tests/test_oracle_reloc.py``'s episode on the card at 384x512:
    six oracle keyframes walking +x, a teleport back to the start that
    relocalization recovers through the real ``RetrievalDatabase``,
    ``FactorGraph`` and matcher, and an impostor that the strict check
    rejects and rolls back."""
    import numpy as np

    from mast3r_slam_tpu_torch.ops import lie
    from mast3r_slam_tpu_torch.slam.factor_graph import FactorGraph
    from mast3r_slam_tpu_torch.slam.frame import KeyframeBuffer
    from mast3r_slam_tpu_torch.slam.pipeline import relocalization
    from mast3r_slam_tpu_torch.slam.retrieval import RetrievalDatabase
    from mast3r_slam_tpu_torch.utils.oracle_scene import OracleWorld

    cfg = {
        "use_calib": False,
        "local_opt": {"pin": 1, "C_conf": 0.0, "Q_conf": 0.0,
                      "min_match_frac": 0.0, "max_iters": 30,
                      "sigma_ray": 0.003, "sigma_dist": 10.0,
                      "delta_norm": 1e-8},
        "retrieval": {"k": 3, "min_thresh": 5e-3},
        "reloc": {"min_match_frac": 0.3, "strict": True},
    }
    H, W = RELOC_HW

    def pose(x, yaw=0.0):
        return lie.exp(torch.tensor([x, 0.0, 0.0, 0.0, yaw, 0.0, 0.0])).numpy()

    t0 = time.perf_counter()
    world = OracleWorld(RELOC_HW, seed=0, device="cuda")
    kfs = KeyframeBuffer(H, W, capacity=16, feat_dim=world.desc_dim,
                         device="cuda")
    rng = np.random.default_rng(4)
    for i, x in enumerate(RELOC_KF_X):
        T = pose(x, yaw=0.02 * i)
        world.observe(i, T)
        T_est = None
        if i > 0:
            xi = torch.as_tensor((rng.normal(size=7) * 0.004).astype(np.float32))
            T_est = lie.compose(lie.exp(xi), torch.as_tensor(T)).numpy()
        kfs.append(world.make_frame(i, T_est=T_est))
    # the JAX test's codebook is 16 scene descriptors for 12 tokens a frame
    # at 48x64; at 384x512 (768 tokens) 16 words rank keyframes 1-3 over
    # keyframe 0 and the strict check rejects the batch on keyframe 3, so
    # the codebook grows to RELOC_WORDS, sampled the same way
    db = RetrievalDatabase(cfg, codebook_size=RELOC_WORDS,
                           nfeat=world.n_tokens, desc_dim=world.desc_dim)
    n = H * W
    samp = world.frames[0]["hits"][:: n // (4 * RELOC_WORDS)][:4 * RELOC_WORDS]
    db.set_codebook(world.scene.descriptors(samp)[:RELOC_WORDS])
    for i in range(len(RELOC_KF_X)):
        db.update(kfs[i], add_after_query=True, k=0, kf_idx=i)
    log(f"reloc: oracle episode built in {time.perf_counter() - t0:.1f} s "
        f"({len(RELOC_KF_X)} keyframes at {H}x{W})")

    T_tele = pose(0.05, yaw=0.01)
    world.observe(100, T_tele)
    frame = world.make_frame(100, T_est=pose(1.5))
    graph = FactorGraph(world, kfs, cfg)
    reset_counters(FA, C3, BA)
    t0 = sync_clock(torch)
    ok = relocalization(frame, kfs, graph, db, cfg)
    t_rel = (sync_clock(torch) - t0) * 1e3
    check(ok, "reloc: relocalization failed on a genuine revisit")
    check(len(kfs) == len(RELOC_KF_X) + 1 and graph.n_edges() >= 1,
          "reloc: keyframe or edge missing")
    T_rec = kfs.T_WC[len(kfs) - 1].cpu().numpy()
    t_err = float(np.linalg.norm(T_rec[:3] - T_tele[:3]))
    q_err = float(min(np.linalg.norm(T_rec[3:7] - T_tele[3:7]),
                      np.linalg.norm(T_rec[3:7] + T_tele[3:7])))
    s_err = abs(float(T_rec[7]) - 1.0)
    log(f"reloc: recovered in {t_rel:.1f} ms, edges "
        f"{[(int(i), int(j)) for i, j in zip(graph.ii, graph.jj)]}, "
        f"translation err {t_err:.4f}, quaternion err {q_err:.4f}, scale err "
        f"{s_err:.4f}; K4 launches {BA.rays_counter.launches}")
    check(t_err < 0.05 and q_err < 0.05 and s_err < 0.12,
          "reloc: pose outside the JAX test's bounds")
    check(BA.rays_counter.launches >= 2, "reloc: the global solve skipped K4")
    paths = {k: c.launches for k, c in BA.path_counters.items()}
    check(BA.calib_counter.launches == 0
          and paths == {"mma": BA.rays_counter.launches, "tf32": 0,
                        "fma": 0},
          f"reloc: bf16-row K4 launches by path {paths}")
    check(not any(c.launches for c in k4p_counters().values()),
          "reloc: a K4' kernel ran")

    world.observe(200, pose(8.0))
    impostor = world.make_frame(200)
    n_kf, n_edges = len(kfs), graph.n_edges()
    ok = relocalization(impostor, kfs, graph, _ForcedRetrieval(), cfg)
    check(not ok, "reloc: strict check accepted an impostor")
    check(len(kfs) == n_kf and graph.n_edges() == n_edges,
          "reloc: impostor not rolled back")
    log("reloc: impostor rejected and rolled back")
    del world, kfs, graph, db
    torch.cuda.empty_cache()
    return dict(t_err=t_err, q_err=q_err, s_err=s_err, ms=t_rel)


# ---------------------------------------------------------------------------
# Phase 11: the services on the card
# ---------------------------------------------------------------------------

SERVICES_HW = (384, 512)
SERVICES_KF_X = (0.0, 0.05, 0.1)        # three keyframes stepping +x
SERVICES_DEPTH_NOISE = 0.004            # relative, ~1 cm at 2.5 m
SERVICES_LOW_CONF = (slice(128, 256), slice(192, 320))
SERVICES_OFFSET = 0.03                  # the pose optimizer's z offset, m
SERVICES_WAIT_S = 60.0
QUALITY_TOL = 1e-6                      # tests/test_torch_quality.py's
TSDF_TOL = 1e-5                         # tests/test_torch_tsdf_local.py's
MAX_PARTING = 1e-3
HASH_TOL = 1e-6                         # tests/test_torch_tsdf_global.py's


@contextlib.contextmanager
def worker_faults():
    """The service workers print an exception and carry on: record every
    exception that ``_process_group``, ``_process``, ``_refine_blocks`` and
    ``optimize_single`` raise (and re-raise it, so the workers behave as
    they do), for the caller to fail on."""
    import traceback

    from mast3r_slam_tpu_torch.services import quality_async as QA
    from mast3r_slam_tpu_torch.services import tsdf_global as TG
    from mast3r_slam_tpu_torch.services import tsdf_local as TLo

    faults = []
    saved = []
    for owner, name in ((QA.AsynchronousQualityService, "_process_group"),
                        (QA.AsynchronousQualityService, "_process"),
                        (TLo.TSDFRefiner, "_refine_blocks"),
                        (TG.TSDFPoseOptimizer, "optimize_single")):
        orig = getattr(owner, name)
        saved.append((owner, name, orig))

        def wrapped(*a, _orig=orig, _name=name, **kw):
            try:
                return _orig(*a, **kw)
            except Exception:
                faults.append(f"{_name}: {traceback.format_exc()}")
                raise

        setattr(owner, name, wrapped)
    try:
        yield faults
    finally:
        for owner, name, orig in saved:
            setattr(owner, name, orig)


def check_no_faults(faults, what):
    check(not faults, f"{what}: a service worker raised:\n"
          + "\n".join(faults))


def oracle_keyframes(torch, device, seed=0):
    """The oracle scene's keyframes at ``SERVICES_HW`` in a keyframe buffer
    on ``device``: noisy depth, confidence 1 with a low-confidence region
    of 0.05. Returns (scene, K, buffer, clean pointmaps, true poses)."""
    import numpy as np

    from mast3r_slam_tpu_torch.slam.frame import Frame, KeyframeBuffer
    from mast3r_slam_tpu_torch.utils.oracle_scene import OracleScene

    H, W = SERVICES_HW
    scene = OracleScene(seed=seed)
    K = scene.intrinsics(SERVICES_HW)
    rng = np.random.default_rng(seed)
    kfs = KeyframeBuffer(H, W, capacity=8, feat_dim=8, device=device)
    clean, poses = [], []
    for i, x in enumerate(SERVICES_KF_X):
        T = np.array([x, 0, 0, 0, 0, 0, 1, 1], np.float32)
        X, _ = scene.raycast(T, K, SERVICES_HW)
        noisy = X * (1.0 + SERVICES_DEPTH_NOISE * rng.normal(
            size=(H * W, 1))).astype(np.float32)
        C = np.ones((H, W), np.float32)
        C[SERVICES_LOW_CONF] = 0.05
        fr = Frame(frame_id=i, img=torch.zeros(H, W, 3, device=device),
                   img_shape=SERVICES_HW, img_true_shape=SERVICES_HW,
                   uimg=np.zeros((H, W, 3), np.float32),
                   T_WC=torch.as_tensor(T, device=device))
        fr.X_canon = torch.as_tensor(noisy, device=device)
        fr.C = torch.as_tensor(C.reshape(-1, 1), device=device)
        fr.feat = torch.zeros(1, kfs.num_patches, 8, device=device)
        fr.pos = torch.zeros(1, kfs.num_patches, 2, dtype=torch.int32,
                             device=device)
        fr.N = 1
        kfs.append(fr)
        clean.append(X)
        poses.append(T)
    return scene, K, kfs, clean, poses


def quality_jobs(torch, device, n_kf, per_kf=2, seed=0):
    """Seeded tracker-form quality jobs (tensors on ``device``): residuals
    and uncertainty high in the low-confidence region."""
    import numpy as np

    H, W = SERVICES_HW
    rng = np.random.default_rng(seed)
    bad = np.zeros((H, W), bool)
    bad[SERVICES_LOW_CONF] = True
    jobs = []
    for f in range(n_kf * per_kf):
        r = rng.uniform(0.0, 0.05, (H, W)).astype(np.float32)
        r[bad] += 0.3
        Q = rng.uniform(1.5, 3.0, (H, W)).astype(np.float32)
        Q[bad] = 0.2
        C = np.ones((H, W), np.float32)
        C[bad] = 0.05
        arrays = dict(valid_kf=rng.random(H * W) > 0.1,
                      r_pix=r.reshape(-1), Ck=C.reshape(-1),
                      Qk=Q.reshape(-1))
        job = {k: torch.as_tensor(v, device=device)
               for k, v in arrays.items()}
        job.update(kf_id=f // per_kf, frame_id=f, H=H, W=W,
                   t_norm=torch.tensor(0.05 + 0.01 * f, device=device),
                   theta=torch.tensor(0.02, device=device))
        jobs.append(job)
    return jobs


def wait_until(cond, timeout=SERVICES_WAIT_S):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def parting(got, want, atol):
    """Fraction of entries that part: NaN in one only, or unequal and
    further apart than ``atol``."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    with np.errstate(invalid="ignore"):
        same = ((got == want) | (np.isnan(got) & np.isnan(want))
                | (np.abs(got - want) <= atol))
    return float((~same).mean())


def phase_services(torch, device="cuda"):
    """The quality service, the local TSDF refiner and the global TSDF on
    the card, on the oracle scene's keyframes at 384x512 with base.yaml's
    settings: the quality service fed seeded jobs, the refiner refining at
    least one block at G = 64, the pose optimizer pulling back a 3 cm
    offset; ``compute_quality_batch``, ``refine_blocks_core`` and one
    integrate and query on the card against the same port functions on the
    CPU (within the CPU tests' tolerances). No worker may raise; the global
    TSDF must run on the native hash."""
    import numpy as np

    from mast3r_slam_tpu_torch.ops import lie
    from mast3r_slam_tpu_torch.services import quality_core as QC
    from mast3r_slam_tpu_torch.services import tsdf_local as TLo
    from mast3r_slam_tpu_torch.services.native_tsdf import NativeVoxelHash
    from mast3r_slam_tpu_torch.services.quality_async import (
        AsynchronousQualityService)
    from mast3r_slam_tpu_torch.services.tsdf_global import (
        TSDFGlobalIntegrator, TSDFPoseOptimizer, TSDFVolume)
    from mast3r_slam_tpu_torch.slam.frame import KeyframeBuffer
    from mast3r_slam_tpu_torch.utils.config import load_config

    cuda = torch.device(device).type == "cuda"
    cfg = load_config(str(ROOT / "config" / "base.yaml"))
    H, W = SERVICES_HW
    out = {}
    scene, K, kfs, clean, poses = oracle_keyframes(torch, device)
    n_kf = len(SERVICES_KF_X)

    with worker_faults() as faults:
        # -- the quality service, fed seeded jobs -------------------------
        svc = AsynchronousQualityService(cfg, device=device).start()
        jobs = quality_jobs(torch, device, n_kf)
        try:
            for j in jobs:
                check(svc.submit(j), "quality: a job was dropped")
            check(wait_until(lambda: svc.processed_jobs == len(jobs)),
                  f"quality: {svc.processed_jobs} of {len(jobs)} jobs "
                  "processed")
            for k in range(n_kf):
                res = svc.get_by_kf_id(k)
                pr = res["priority"]
                gy, gx = np.unravel_index(int(pr.argmax()), pr.shape)
                check(8 <= gy < 16 and 12 <= gx < 20 and pr.max() > 0.5,
                      f"quality: keyframe {k}'s top priority at patch "
                      f"({gy}, {gx}), not in the low-confidence region")

            # compute_quality_batch: time on the card, card vs CPU
            ps = svc.ps
            B = cfg["quality"]["batch_size"]
            batch = jobs[:B]
            args = (svc.alpha, svc.b0, svc.theta0, svc.C_thr, svc.Q_thr,
                    svc.thr_zr, svc.thr_zu, svc.thr_dc)

            def stacked(dev):
                st = {k: torch.stack([j[k].reshape(-1) for j in batch]).to(dev)
                      for k in ("valid_kf", "r_pix", "Ck", "Qk")}
                sc = {k: torch.stack([j[k] for j in batch]).to(dev)
                      for k in ("t_norm", "theta")}
                prev = torch.zeros(B, H // ps, W // ps, device=dev)
                chain = np.array([False] + [batch[i]["kf_id"]
                                            == batch[i - 1]["kf_id"]
                                            for i in range(1, B)])
                return (st["valid_kf"], st["r_pix"], st["Ck"], st["Qk"],
                        sc["t_norm"], sc["theta"], prev, chain, H, W, ps,
                        *args)

            on_dev = stacked(device)
            got = QC.compute_quality_batch(*on_dev)
            with one_cpu_thread(torch):
                want = QC.compute_quality_batch(*stacked("cpu"))
            for k, v in want.items():
                g = got[k].cpu()
                if k == "class_id":
                    check(torch.equal(g, v), "quality card vs CPU: class_id")
                else:
                    err = (g - v).abs().max().item()
                    check(err <= QUALITY_TOL,
                          f"quality card vs CPU: {k} off by {err:.2e}")
            if cuda:
                out["quality_ms"] = time_ms(
                    lambda: QC.compute_quality_batch(*on_dev), iters=10)
            log(f"services: quality batch of {B} at {H}x{W} "
                f"{out.get('quality_ms', float('nan')):.3f} ms; card vs CPU "
                f"within {QUALITY_TOL} (class_id equal)")

            # -- the refiner at base.yaml's settings ----------------------
            captured = []
            orig_core = TLo.refine_blocks_core

            def capture(*a, **kw):
                captured.append((a, kw))
                return orig_core(*a, **kw)

            TLo.refine_blocks_core = capture
            ref = TLo.TSDFRefiner(kfs, cfg, quality_service=svc,
                                  device=device)
            try:
                ref.start()
                ref.schedule_final_pass(n_kf - 1)
                check(ref.stats["scheduled"] > 0, "refiner: nothing "
                      f"scheduled ({ref.stats})")
                check(wait_until(
                    lambda: ref.stats["refined_blocks"]
                    + ref.stats["rejected_blocks"] >= ref.stats["scheduled"]
                    and ref.task_q.empty() and not ref._retry),
                    f"refiner: tasks left after {SERVICES_WAIT_S} s "
                    f"({ref.stats})")
            finally:
                ref.stop()
                TLo.refine_blocks_core = orig_core
            st = ref.stats
            check(st["refined_blocks"] >= 1,
                  f"refiner: no block refined ({st})")
            check(st["refined_blocks"] + st["rejected_blocks"]
                  == st["scheduled"], f"refiner: tasks unaccounted ({st})")
            out.update(refined=st["refined_blocks"],
                       rejected=st["rejected_blocks"],
                       scheduled=st["scheduled"],
                       events=len(captured))
        finally:
            svc.shutdown()
        check(not svc.is_alive(), "quality: the worker did not stop")

        # refine_blocks_core: time one keyframe event at G = 64, card vs CPU
        a, kw = captured[0]
        Bk, P = a[4].shape
        new_d, ok_d = TLo.refine_blocks_core(*a, **kw)
        with one_cpu_thread(torch):
            a_cpu = [x.cpu() if torch.is_tensor(x) else x for x in a]
            new_c, ok_c = TLo.refine_blocks_core(*a_cpu, **kw)
        ok_part = float((ok_d.cpu() != ok_c).float().mean())
        pt_part = parting(new_d.cpu().numpy(), new_c.numpy(), TSDF_TOL)
        check(ok_part <= MAX_PARTING and pt_part <= MAX_PARTING,
              f"refine_blocks_core card vs CPU: {ok_part:.2e} of the masks "
              f"and {pt_part:.2e} of the points part")
        check(int(ok_c.sum()) > 0, "refine_blocks_core: nothing refined")
        if cuda:
            out["refine_ms"] = time_ms(lambda: TLo.refine_blocks_core(*a, **kw),
                                       iters=10)
        log(f"services: refiner (base.yaml: G {a[12]}, {a[14]} ray "
            f"samples, {cfg['tsdf_refine']['max_rois_per_kf']} blocks a "
            f"keyframe) refined {out['refined']} and rejected "
            f"{out['rejected']} of {out['scheduled']} blocks in "
            f"{out['events']} keyframe events; refine_blocks_core "
            f"{out.get('refine_ms', float('nan')):.3f} ms per keyframe event "
            f"({Bk} blocks, {P} pixels a block); card vs CPU partings "
            f"{ok_part:.1e} (masks), {pt_part:.1e} (points)")

        # -- the global TSDF: integrate, query, pose optimizer --------------
        gcfg = {"tsdf_global": dict(cfg["tsdf_global"], enabled=True)}
        vol = TSDFVolume(gcfg)
        check(isinstance(vol.hash, NativeVoxelHash),
              "global TSDF: not on the native hash")
        integ = TSDFGlobalIntegrator(vol, kfs, gcfg)
        ms = []
        for i in range(n_kf):
            t0 = sync_clock(torch) if cuda else time.perf_counter()
            integ._integrate_kf(i)
            ms.append((time.perf_counter() - t0) * 1e3)
        out["integrate_ms"] = statistics.median(ms)
        # the same keyframes (as the refiner left them) from a CPU buffer:
        # the same volume
        kfs_cpu = KeyframeBuffer(H, W, capacity=kfs.capacity, feat_dim=8,
                                 device="cpu")
        with kfs.lock:
            for key in ("X", "C", "T_WC"):
                getattr(kfs_cpu, key).copy_(getattr(kfs, key).cpu())
            kfs_cpu.N[:] = kfs.N
            kfs_cpu.n_size = kfs.n_size
        vol_cpu = TSDFVolume(gcfg)
        integ_cpu = TSDFGlobalIntegrator(vol_cpu, kfs_cpu, gcfg)
        for i in range(n_kf):
            integ_cpu._integrate_kf(i)
        check(vol.stats() == vol_cpu.stats(),
              f"global TSDF card vs CPU: {vol.stats()} != {vol_cpu.stats()}")
        q = clean[0][::97] + np.random.default_rng(1).normal(
            size=(clean[0][::97].shape[0], 3)).astype(np.float32) * 0.02
        t_d, g_d, v_d = vol.query(q)
        t_c, g_c, v_c = vol_cpu.query(q)
        check(np.array_equal(v_d, v_c) and v_d.sum() > 100
              and np.abs(t_d - t_c).max() <= HASH_TOL,
              "global TSDF card vs CPU: queries differ")
        log(f"services: integrate {statistics.median(ms):.1f} ms per "
            f"keyframe ({H}x{W}, max {integ.max_points} points; host hash), "
            f"{vol.stats()['voxels']} voxels; card vs CPU equal")

        # the pose optimizer pulls a 3 cm z offset back onto the surface
        dense_vol = TSDFVolume(gcfg)
        Kd = scene.intrinsics((2 * H, 2 * W))
        _, hits = scene.raycast(poses[0], Kd, (2 * H, 2 * W))
        dense_vol.integrate(hits.astype(np.float32), np.ones(hits.shape[0]),
                            poses[0][:3])
        T_true = torch.as_tensor(poses[0])
        T_off = lie.compose(lie.exp(torch.tensor(
            [0, 0, SERVICES_OFFSET, 0, 0, 0, 0.0])), T_true)
        kfs.update_T_WCs(T_off[None], [0])
        opt = TSDFPoseOptimizer(dense_vol, kfs, gcfg)

        def surf_res(T):
            Xw = lie.act(torch.as_tensor(T).cpu()[None],
                         torch.as_tensor(clean[0])).numpy()
            return float(np.mean(np.abs(
                Xw[:, 2] - scene.height(Xw[:, 0], Xw[:, 1]))))

        def pose_err(T):
            rel = lie.compose(lie.inv(T_true), torch.as_tensor(T).cpu())
            return float(torch.linalg.norm(lie.log(rel)))

        # the contract is surface agreement (tests/test_tsdf.py's curved
        # oracle test): the keyframe's points back on the true surface, the
        # pose error along the surface's sliding directions bounded
        r0, e0 = surf_res(T_off), pose_err(T_off)
        t0 = time.perf_counter()
        check(opt.optimize_single(0), "pose optimizer: no pose written")
        opt_ms = (time.perf_counter() - t0) * 1e3
        T_new = kfs.T_WC[0].cpu()
        r1, e1 = surf_res(T_new), pose_err(T_new)
        check(r1 < 0.5 * r0 and e1 < 2.0 * e0,
              f"pose optimizer: surface residual {r0:.4f} -> {r1:.4f} m, "
              f"pose error {e0:.4f} -> {e1:.4f}")
        out.update(pose_r0=r0, pose_r1=r1, pose_e0=e0, pose_e1=e1,
                   opt_ms=opt_ms)
        log(f"services: pose optimizer (base.yaml: {opt.samples} samples, "
            f"{opt.max_iters} LM steps) from a {SERVICES_OFFSET} m z offset:"
            f" surface residual {r0 * 1e3:.2f} -> {r1 * 1e3:.2f} mm, pose "
            f"error |log| {e0:.4f} -> {e1:.4f}, {opt_ms:.0f} ms")
    check_no_faults(faults, "services")
    return out


# ---------------------------------------------------------------------------
# Phase: the disjoint device topology
# ---------------------------------------------------------------------------

TOPO_SLOTS = 5            # the virtual layout on one card
TOPO_PAIRS = 3            # the sharded decode's pairs, padded to the mesh
TOPO_FALLBACK_SLOTS = 3   # a backend whose size divides no edge bucket
# the sharded decode (batch 2 a slot) against one batch-6 decoder call:
# cuBLAS's algorithms and K2's split-K plan follow the batch, so bf16
# rounding lands in other places through 12 decoder blocks and the heads;
# bound as tests/test_torch_model.py bounds bf16 outputs whose rounding
# lands elsewhere (test_downstream_heads_bf16_trunk): 6e-2 x max |ref|
TOPO_DECODE_TOL = 6e-2
# the BA systems of the check: (channel and row type, pixels) of base.yaml
# (bf16, pixel_step 2) and of the evaluation configs (f32, pixel_step 1)
TOPO_GRAM = (("bfloat16", IMG_HW[0] * IMG_HW[1] // 2),
             ("float32", IMG_HW[0] * IMG_HW[1]))


def topo_meshes(slots):
    """The backend mesh of the decode and BA checks (slots 1..4 of
    ``slots``, numbered as a topology numbers them) and the 3-slot mesh of
    the fallback check (its slots repeat when there are fewer)."""
    from mast3r_slam_tpu_torch.parallel.sharding import DeviceMesh

    back = list(range(1, min(len(slots), 5)))
    fall = [back[k % len(back)] for k in range(TOPO_FALLBACK_SLOTS)]
    return (DeviceMesh(tuple(slots[s] for s in back), tuple(back)),
            DeviceMesh(tuple(slots[s] for s in fall), tuple(fall)))


def topo_decode(torch, FA, C3, BA, model, mesh):
    """The sharded symmetric decode of ``TOPO_PAIRS`` pairs at full width,
    eagerly: one decoder call per slot on the slot's device with exactly
    one decode's K1 / K2 launches each; its outputs bit for bit those of
    each slot's (padded) pairs decoded alone on the frontend's parameters,
    concatenated and trimmed, and within ``TOPO_DECODE_TOL`` of one
    unsharded decode of all pairs. Then as CUDA graphs (``topo_graphed``).
    Returns the largest relative error and the times."""
    from mast3r_slam_tpu_torch.models import inference as I
    from mast3r_slam_tpu_torch.models import mast3r as M

    H, W = IMG_HW
    dev0 = model.params["enc_norm"]["g"].device
    g = torch.Generator(device=dev0).manual_seed(21)
    feats = [torch.randn(TOPO_PAIRS, (H // 16) * (W // 16),
                         model.cfg.enc_embed_dim, generator=g, device=dev0)
             for _ in range(2)]
    pos = M.patch_positions(H // 16, W // 16, TOPO_PAIRS, dev0)
    args = (feats[0], pos, feats[1], pos, IMG_HW)
    one = {"K1": K1_PER_DECODE, "K2": 2 * K2_PER_HEAD}
    model.set_mesh(None)
    reset_counters(FA, C3, BA)
    t0 = sync_clock(torch)
    ref = model.decode_symmetric_batch(*args)
    t_one = (sync_clock(torch) - t0) * 1e3
    got_one = {k: v for k, v in launch_counts(FA, C3, BA).items() if k in one}
    check(got_one == one, f"topology: unsharded decode launches {got_one}")
    per_slot = -(-TOPO_PAIRS // mesh.size)
    pad = per_slot * mesh.size - TOPO_PAIRS
    padded = [torch.cat([a, a[-1:].expand(pad, *a.shape[1:])])
              for a in (feats[0], pos, feats[1], pos)]
    chunks = [model.decode_symmetric_batch(
        *(a[k * per_slot:(k + 1) * per_slot] for a in padded), IMG_HW)
        for k in range(mesh.size)]
    slotwise = [torch.cat([c[i] for c in chunks], 1)[:, :TOPO_PAIRS]
                for i in range(4)]
    core, calls = I._decode_symmetric_core, []

    def counted(params, cfg, f_i, *a, **kw):
        before = launch_counts(FA, C3, BA)
        out = core(params, cfg, f_i, *a, **kw)
        after = launch_counts(FA, C3, BA)
        calls.append((f_i.device, f_i.shape[0],
                      {k: after[k] - before[k] for k in one}))
        return out

    graphs = model.graphs
    model.set_mesh(mesh)
    model.graphs = None                 # the eager mesh path
    I._decode_symmetric_core = counted
    try:
        reset_counters(FA, C3, BA)
        t0 = sync_clock(torch)
        got = model.decode_symmetric_batch(*args)
        t_mesh = (sync_clock(torch) - t0) * 1e3
        launches = launch_counts(FA, C3, BA)
    finally:
        I._decode_symmetric_core = core
        model.graphs = graphs
    check(len(calls) == mesh.size, f"topology: {len(calls)} decoder calls on "
          f"{mesh.size} slots")
    for (dev, b, n), want_dev in zip(calls, mesh.devices):
        check(dev == want_dev and b == per_slot and n == one,
              f"topology: a slot's decode on {dev} of {b} pairs launched "
              f"{n}, want {want_dev}, {per_slot}, {one}")
    check(launches["K1"] == mesh.size * one["K1"]
          and launches["K2"] == launches["K2 igemm"]
          == mesh.size * one["K2"], f"topology: decode launches {launches}")
    err = 0.0
    for name, a, b, s in zip(("pts3d", "conf", "desc", "desc_conf"), got,
                             ref, slotwise):
        check(a.shape == b.shape and a.shape[:2] == (4, TOPO_PAIRS),
              f"topology decode {name}: shape {tuple(a.shape)}")
        check(a.device == mesh.first, f"topology decode {name} on {a.device}")
        check(torch.equal(a, s.to(a.device)), f"topology decode {name}: not "
              f"each slot's pairs decoded alone, bit for bit")
        check(bool(a.float().isfinite().all()), f"topology decode {name}: "
              f"not finite")
        e = (a.float() - b.float().to(a.device)).abs().max().item()
        scale = b.float().abs().max().item()
        log(f"topology decode {name:9s} equal to the slot-wise decode; max "
            f"abs err {e:.3e} against one batch-{2 * TOPO_PAIRS} call (max "
            f"|ref| {scale:.3e}, tolerance {TOPO_DECODE_TOL} x max |ref|)")
        check(e <= TOPO_DECODE_TOL * scale, f"topology decode {name}: max "
              f"abs err {e:.3e} > {TOPO_DECODE_TOL} x {scale:.3e}")
        err = max(err, e / max(scale, 1e-30))
    log(f"topology: decode of {TOPO_PAIRS} pairs padded to "
        f"{per_slot * mesh.size} on {mesh.size} slots {t_mesh:.1f} ms, "
        f"unsharded {t_one:.1f} ms (host clock, first calls); per slot "
        f"K1 {one['K1']} K2 {one['K2']} launches")
    try:
        out = topo_graphed(torch, FA, C3, BA, model, mesh, args, got, one)
    finally:
        model.set_mesh(None)
    return dict(rel_err=err, ms=t_mesh, ms_one=t_one, **out)


def topo_graphed(torch, FA, C3, BA, model, mesh, args, eager, one):
    """The sharded decode and the mesh's matcher as CUDA graphs: the
    decode's graph per device and per-slot batch (captured on each
    distinct device's first slot, replayed on the others), bit for bit the
    eager mesh decode ``eager``, one decode's K1 / K2 launches a slot a
    call; a second call replays every slot. Then ``match_symmetric`` on
    the mesh (decode, then the matcher's graph on the first slot) against
    its eager path, bit for bit, captured once and then replayed. Returns
    the warm times beside the eager ones (ms, synced card to synced
    card)."""
    n_dev = len(mesh.distinct())
    runs = []
    for call in range(3):
        caches_before = {d: (c.captures, c.replays)
                         for d, c in model.slot_graphs.items()}
        reset_counters(FA, C3, BA)
        t0 = sync_clock(torch)
        got = model.decode_symmetric_batch(*args)
        ms = (sync_clock(torch) - t0) * 1e3
        launches = launch_counts(FA, C3, BA)
        caps = sum(c.captures - caches_before.get(d, (0, 0))[0]
                   for d, c in model.slot_graphs.items())
        reps = sum(c.replays - caches_before.get(d, (0, 0))[1]
                   for d, c in model.slot_graphs.items())
        want = (n_dev, mesh.size - n_dev) if call == 0 else (0, mesh.size)
        check((caps, reps) == want, f"topology graphed decode call {call}: "
              f"{caps} captures, {reps} replays, want {want}")
        check(launches["K1"] == mesh.size * one["K1"]
              and launches["K2"] == launches["K2 igemm"]
              == mesh.size * one["K2"], f"topology graphed decode call "
              f"{call}: launches {launches}")
        for name, a, b in zip(("pts3d", "conf", "desc", "desc_conf"), got,
                              eager):
            check(same_bits(a, b), f"topology graphed decode {name} (call "
                  f"{call}) differs from the eager mesh decode")
        runs.append(ms)
    log(f"topology: graphed sharded decode bit for bit the eager one; "
        f"{len(model.slot_graphs)} device cache(s), first call "
        f"{runs[0]:.1f} ms (captures), warm {min(runs[1:]):.1f} ms")
    feat_i, pos_i, feat_j, pos_j, hw = args
    n = hw[0] * hw[1]
    init = torch.arange(n, device=feat_i.device).flip(0).expand(
        TOPO_PAIRS, n)
    graphs, outs, match_ms = model.graphs, [], []
    cap0, rep0 = graphs.captures, graphs.replays
    for graphed in (False, True, True, True):
        model.graphs = graphs if graphed else None
        try:
            t0 = sync_clock(torch)
            outs.append(model.match_symmetric(
                feat_i, pos_i, feat_j, pos_j, hw, init_i2j=init,
                init_j2i=init))
            match_ms.append((sync_clock(torch) - t0) * 1e3)
        finally:
            model.graphs = graphs
    check((graphs.captures - cap0, graphs.replays - rep0) == (1, 2),
          f"topology mesh matcher: {graphs.captures - cap0} captures, "
          f"{graphs.replays - rep0} replays, want 1, 2")
    for out in outs[1:]:
        for k, (a, b) in enumerate(zip(out, outs[0])):
            check(same_bits(a, b), f"topology mesh match_symmetric output "
                  f"{k}: graphed differs from eager")
    log(f"topology: mesh match_symmetric of {TOPO_PAIRS} pairs, graphed "
        f"(decode graphs + the matcher's graph on the first slot) bit for "
        f"bit the eager path; eager {match_ms[0]:.1f} ms, graphed first "
        f"{match_ms[1]:.1f} ms, warm {min(match_ms[2:]):.1f} ms")
    return dict(graphed_first_ms=runs[0], graphed_ms=min(runs[1:]),
                match_eager_ms=match_ms[0], match_first_ms=match_ms[1],
                match_ms=min(match_ms[2:]))


def topo_solve(torch, FA, C3, BA, mesh, device="cuda"):
    """The mesh solve (``gauss_newton_rays`` / ``_calib`` on the first
    power-of-two slots of ``mesh``) at the keyframe event's E (four two-way edges among three oracle
    keyframes at 384x512, padded to the bucket of 8 rows, which the mesh
    splits into equal shares), on base.yaml's bf16 channels and LM
    settings from kicked poses: eagerly, then as CUDA graphs (a capture
    and two replays; one graph when every slot is on one card, else each
    slot's build on its card and the step on the first slot with the exit
    read on the host): poses and iterations bit for bit, K4 / K5 launched
    slots x (1 + iterations) a solve on the tensor-core path. Returns per
    kind the iterations and times."""
    from mast3r_slam_tpu_torch.ops import lie
    from mast3r_slam_tpu_torch.ops.graphs import GraphCache
    from mast3r_slam_tpu_torch.parallel.sharding import DeviceMesh
    from mast3r_slam_tpu_torch.slam import factor_graph as FG

    # the mesh's first power-of-two slots: they divide the bucket
    m = 1 << (mesh.size.bit_length() - 1)
    mesh = DeviceMesh(mesh.devices[:m], mesh.slots[:m])
    N = IMG_HW[0] * IMG_HW[1] // 2
    # the solve's inputs live on the mesh's first slot, as FactorGraph's
    dev = mesh.first
    meas_all, T, ii, jj, K = oracle_channels(torch, steps=(2,), dev=dev)
    B, E = 8, ii.shape[0]
    check(B % mesh.size == 0, f"topology solve: {mesh.size} slots do not "
          f"divide the bucket of {B}")
    ii2 = torch.cat([ii, ii.new_zeros(B - E)])
    jj2 = torch.cat([jj, jj.new_zeros(B - E)])
    mask = (torch.arange(B, device=dev) < E).float()
    free = torch.arange(T.shape[0], device=dev) > 0
    kick = torch.zeros(T.shape[0], 7, device=dev)
    kick[1:] = torch.tensor([0.01, -0.005, 0.008, 0.004, -0.003, 0.002,
                             0.01], device=dev)
    T0 = lie.retr(T, kick)
    design = "one graph" if len(mesh.distinct()) == 1 else (
        "a graph a card + the step on the first slot, exit read on the host")
    out = {}
    for kind in ("rays", "calib"):
        name = "K4" if kind == "rays" else "K5"
        meas = tuple(torch.cat([ch, ch.new_zeros(B - E, *ch.shape[1:])])
                     .to(torch.bfloat16).contiguous()
                     for ch in meas_all[kind, N])

        def solve(graphs):
            kw = dict(compute_dtype="bfloat16", mesh=mesh, graphs=graphs)
            if kind == "rays":
                return FG.gauss_newton_rays(T0, meas, ii2, jj2, mask, free,
                                            0.003, 10.0, 10, 1e-2, **kw)
            return FG.gauss_newton_calib(T0, meas, K, ii2, jj2, mask, free,
                                         IMG_HW, -10.0, 1e-6, 1.0, 10.0, 10,
                                         1e-2, **kw)

        cache = GraphCache("solve")
        runs = []
        for graphs in (None, cache, cache, cache):
            (T_out, iters), launches, ms = counted_call(
                torch, FA, C3, BA, lambda: solve(graphs))
            iters = int(iters)
            want = mesh.size * (1 + iters)
            check(launches[name] == want and launches["BA mma"] == want,
                  f"topology {kind} mesh solve (graphed: {graphs is not None}"
                  f"): launches {launches}, want {want} ({iters} iterations"
                  f" on {mesh.size} slots)")
            runs.append((T_out, iters, ms))
        for T_out, iters, _ in runs[1:]:
            check(same_bits(T_out, runs[0][0]) and iters == runs[0][1],
                  f"topology {kind}: the graphed mesh solve ({iters} "
                  f"iterations) differs from the eager one ({runs[0][1]})")
        check(runs[0][1] >= 1 and bool(runs[0][0].isfinite().all()),
              f"topology {kind}: the mesh solve did not iterate")
        check(cache.replays >= 2 * cache.captures >= 2,
              f"topology {kind}: {cache.captures} captures, {cache.replays}"
              f" replays of the solve graphs")
        log(f"topology {kind} mesh solve on {mesh.size} slots ({design}): "
            f"graphed bit for bit the eager one, {runs[0][1]} iterations, "
            f"{name} {mesh.size} x (1 + {runs[0][1]}) launches a solve; "
            f"{cache.captures} graphs; eager {runs[0][2]:.1f} ms, graphed "
            f"first {runs[1][2]:.1f} ms, warm "
            f"{min(r[2] for r in runs[2:]):.1f} ms")
        out[kind] = dict(iters=runs[0][1], eager_ms=runs[0][2],
                         first_ms=runs[1][2],
                         warm_ms=min(r[2] for r in runs[2:]),
                         graphs=cache.captures, design=design)
    return out


def topo_gram(torch, BA, mesh, device="cuda"):
    """The sharded K4 / K5 system at the keyframe event's E (four two-way
    edges among three oracle keyframes at 384x512) against one build of
    the same edges, on bf16 (base.yaml) and on f32 (evaluation configs)
    channels and rows: ``system_error`` within the Gram tolerance, one
    launch per slot on the row type's path. Returns the largest error."""
    from mast3r_slam_tpu_torch.ops import geometry
    from mast3r_slam_tpu_torch.slam import factor_graph as FG

    meas_all, T, ii, jj, K = oracle_channels(torch, dev=device)
    dev = T.device
    cap = T.shape[0]
    free = torch.arange(cap, device=dev) > 0
    mask = torch.ones(ii.shape[0], device=dev)
    calib_args = (IMG_HW, -10.0, 1e-6, 1.0, 10.0)
    worst = 0.0
    for kind in ("rays", "calib"):
        counter = BA.rays_counter if kind == "rays" else BA.calib_counter
        for dt_name, N in TOPO_GRAM:
            dt = getattr(torch, dt_name)
            meas = tuple(ch.to(dt).contiguous() for ch in meas_all[kind, N])
            if kind == "rays":
                def accum(T_, meas_, ii_, jj_, mask_, free_):
                    return FG._accumulate_rays(T_, meas_, ii_, jj_, mask_,
                                               free_, cap, 0.003, 10.0,
                                               compute_dtype=dt)
                extra = ()
            else:
                def accum(T_, meas_, ii_, jj_, mask_, free_, K_):
                    return FG._accumulate_calib(T_, meas_, K_, ii_, jj_,
                                                mask_, free_, cap,
                                                *calib_args, compute_dtype=dt)
                extra = (K,)
            path = BA.path_counters[BA.gram_path(dt)]
            before = (counter.launches, path.launches)
            single = accum(T, meas, ii, jj, mask, free, *extra)
            torch.cuda.synchronize()
            mid = (counter.launches, path.launches)
            sharded = FG._shard_edge_system(mesh, accum, T, free, ii, jj,
                                            mask, meas, extra)
            torch.cuda.synchronize()
            after = (counter.launches, path.launches)
            tag = f"topology {kind} E={ii.shape[0]} N={N} {dt_name}"
            check(mid[0] - before[0] == mid[1] - before[1] == 1
                  and after[0] - mid[0] == after[1] - mid[1] == mesh.size,
                  f"{tag}: launches {before} {mid} {after}, want 1 then "
                  f"{mesh.size} on {BA.gram_path(dt)}")
            check(all(bool(a.isfinite().all()) for a in sharded)
                  and sharded[0].device == mesh.first, f"{tag}: output")
            check(float(single[2]) > 0, f"{tag}: an empty system")
            err = FG.system_error(sharded, single)
            log(f"{tag}: sharded over {mesh.size} slots vs one build, system "
                f"error {err:.3e} (tolerance {GRAM_TOL[dt_name]:.0e})")
            check(err <= GRAM_TOL[dt_name], f"{tag}: system error {err:.3e}")
            worst = max(worst, err)
    return worst


def topo_layout(torch, FA, C3, BA, slots, model, clip, cfg_path, work, tag,
                device="cuda"):
    """(a) the sharded decode, (b) the sharded K4 / K5 system, (d) the CLI
    on ``slots`` with base.yaml's services, (c) the 3-slot fallback on the
    CLI's keyframes."""
    from mast3r_slam_tpu_torch.slam.factor_graph import FactorGraph
    from mast3r_slam_tpu_torch.utils.config import load_config

    mesh, mesh3 = topo_meshes(slots)
    log(f"topology {tag}: slots {[str(d) for d in slots]}; decode / BA mesh "
        f"slots {mesh.slots}, fallback mesh slots {mesh3.slots}")
    out = {"decode": topo_decode(torch, FA, C3, BA, model, mesh),
           "gram_err": topo_gram(torch, BA, mesh, device),
           "solve": topo_solve(torch, FA, C3, BA, mesh, device)}
    res, launches, rec = run_cli(
        torch, FA, C3, BA, model, work,
        ["--dataset", str(clip), "--config", cfg_path, "--no-viz",
         "--save-as", f"topo_{tag}"], f"topology {tag}", devices=slots)
    topo, g = res["topo"], res["graph"]
    log(f"topology {tag}: main() planned {topo.describe()}; solve_stats "
        f"{g.solve_stats}")
    check(topo.backend_mesh is not None and g.mesh == topo.backend_mesh,
          f"topology {tag}: no backend mesh in the CLI run")
    check(g.solve_stats["sharded"] >= 1, f"topology {tag}: no sharded solve "
          f"({g.solve_stats})")
    # the mesh's solves and decodes repeat their shapes within the clip;
    # its matcher's batch (B edges an event) may not repeat
    caps, reps = rec["captures"], rec["replays"]
    for name, replays in (("solve", 1), ("decode", 1), ("match", 0)):
        check(caps[name] >= 1 and reps[name] >= replays, f"topology {tag}: "
              f"the CLI's {name} graphs: {caps[name]} captures, "
              f"{reps[name]} replays")
    log(f"topology {tag}: the CLI's mesh solves, sharded decode and "
        f"matcher ran as graphs: captures {caps}, replays {reps}; K4 "
        f"{launches['K4']} launches = its {rec['calls']['builds']} slot "
        f"system builds ({g.mesh.size} a build on the mesh)")
    check(res["quality"].processed_jobs > 0
          and res["refiner"].stats["scheduled"] > 0,
          f"topology {tag}: services idle")
    # the cli phase's output checks
    kf = res["keyframes"]
    check(len(kf) >= 8 and kf.T_WC.device == topo.frontend_device,
          f"topology {tag}: keyframes {len(kf)} on {kf.T_WC.device}")
    check(any(abs(int(i) - int(j)) > 1 for i, j in zip(g.ii, g.jj)),
          f"topology {tag}: no non-consecutive (retrieval) edge")
    check(rec["calls"]["lm_iters"] > 0, f"topology {tag}: no BA iterations")
    savedir = work / "logs" / f"topo_{tag}" / clip.name
    check_outputs(res, savedir, clip.name, CLI_FRAMES, IMG_HW)
    qf = quality_fields(savedir / f"{clip.name}_quality.ply")
    for field in ("r", "delta_cov"):
        check(bool((qf[field] != 0).any()),
              f"topology {tag}: the quality PLY's {field} is all zero")
    parts = cli_parts(rec)
    out.update(tracked_ms=parts["track"], step_ms=parts["step"],
               solve_ms=parts["solve"], add_factors_ms=parts["add_factors"],
               keyframes=len(kf),
               edges=g.n_edges(), solve_stats=dict(g.solve_stats),
               launches=launches)
    # (c) a bucket of 8 rows that 3 slots do not divide: the first
    # backend slot alone
    cfg = load_config(cfg_path)
    model.set_mesh(mesh3)
    try:
        g3 = FactorGraph(model, kf, cfg, mesh=mesh3,
                         home_device=topo.frontend_device)
        check(g3.add_factors([0], [1], 0.0), "topology fallback: no edge")
        g3.solve_GN_rays()
        torch.cuda.synchronize()
    finally:
        model.set_mesh(None)
    check(g3.solve_stats == {"sharded": 0, "fallback_single_device": 1},
          f"topology fallback: {g3.solve_stats}")
    check(kf.T_WC.device == topo.frontend_device
          and bool(kf.T_WC[:len(kf)].isfinite().all()),
          "topology fallback: poses not homed or not finite")
    log(f"topology {tag}: fallback on {mesh3.size} slots with 2 two-way "
        f"edges (a bucket of 8): {g3.solve_stats}")
    return out


def phase_topology(torch, FA, C3, BA, workdir, cli=None, device="cuda"):
    """The disjoint device topology: the layout ``plan_topology()`` gives on
    the visible cards, then a virtual ``TOPO_SLOTS``-slot layout on cuda:0
    (and, with two or more cards, the same on the distinct cards): the
    sharded decode and its graphs, the sharded BA system, the mesh solve
    eager and graphed, the CLI with services (its mesh solves, decodes and
    matcher as graphs) and the 3-slot fallback (``topo_layout``). ``cli``:
    the cli phase's one-slot medians, printed beside the layout's.
    ``device`` "cpu" rehearses the phase on the CPU (with ``tied_model``
    and ``main`` patched)."""
    from mast3r_slam_tpu_torch.bench.frame_profile import smi
    from mast3r_slam_tpu_torch.parallel.sharding import visible_devices
    from mast3r_slam_tpu_torch.parallel.topology import plan_topology
    from mast3r_slam_tpu_torch.utils.config import load_config

    where = smi() if device == "cuda" else "cpu"
    cards = visible_devices()
    log(f"topology: plan_topology() on the {len(cards)} visible card(s): "
        f"{plan_topology().describe()}")
    work = Path(workdir)
    clip = write_clip(work / "topo_tum_clip", CLI_FRAMES)
    cfg_path = write_config(work / "cli_topo.yaml")
    model = tied_model(load_config(cfg_path), device)
    first = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    layouts = [("virtual", [first] * TOPO_SLOTS)]
    if len(cards) >= 2:
        layouts.append(("cards", cards))
    else:
        log("topology: the layout over distinct cards was NOT run (1 card "
            "visible); only the virtual layout on cuda:0 was checked")
    out = {}
    for tag, slots in layouts:
        out[tag] = topo_layout(torch, FA, C3, BA, slots, model, clip,
                               cfg_path, work, tag, device)
        r = out[tag]
        one = ("not run in this call" if cli is None else
               f"{cli['tracked_ms']:.1f} / {cli['step_ms']:.1f} ms "
               f"(add_factors {cli['add_factors_ms']:.1f}, solve "
               f"{cli['solve_ms']:.1f})")
        log(f"topology {tag}: CLI median tracked frame / backend step "
            f"{r['tracked_ms']:.1f} / {r['step_ms']:.1f} ms (add_factors "
            f"{r['add_factors_ms']:.1f}, solve {r['solve_ms']:.1f}); one "
            f"slot (phase cli): {one}; keyframes "
            f"{r['keyframes']}, edges {r['edges']}, {r['solve_stats']}")
        d, sv = r["decode"], r["solve"]
        log(f"topology {tag}: sharded decode of {TOPO_PAIRS} pairs eager "
            f"{d['ms']:.1f} ms (first call), graphed first "
            f"{d['graphed_first_ms']:.1f} ms, warm {d['graphed_ms']:.1f} ms;"
            f" mesh match_symmetric eager {d['match_eager_ms']:.1f} ms, "
            f"graphed warm {d['match_ms']:.1f} ms; mesh solve ("
            + ", ".join(f"{k} {v['iters']} iterations eager "
                        f"{v['eager_ms']:.1f} ms, graphed warm "
                        f"{v['warm_ms']:.1f} ms" for k, v in sv.items())
            + f"; {sv['rays']['design']}); on {where}")
    del model
    torch.cuda.empty_cache()
    return out

VIZ_RENDER_HW = ((480, 640), (720, 1280))   # the JAX default, the viewer's
VIZ_AGREE = 0.999                          # share of pixels, card vs CPU
VIZ_TOL = 1e-5                             # viewer points and normals
VIZ_GL_HW = (240, 320)


class TimedLock:
    """A stand-in for a buffer's ``RLock`` that records how long each
    outermost hold lasted (s)."""

    def __init__(self, lock):
        self.lock, self.depth, self.held = lock, 0, []

    def __enter__(self):
        self.lock.acquire()
        self.depth += 1
        if self.depth == 1:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.depth -= 1
        if self.depth == 0:
            self.held.append(time.perf_counter() - self.t0)
        self.lock.release()


@contextlib.contextmanager
def timed_lock(buf):
    saved = buf.lock
    buf.lock = TimedLock(saved)
    try:
        yield buf.lock.held
    finally:
        buf.lock = saved


def cpu_copy(torch, kf, states):
    """The keyframe buffer (what the viewer and the renderer read) and the
    controller state's edges and current frame, copied to the CPU."""
    from mast3r_slam_tpu_torch.slam.frame import Frame, KeyframeBuffer, States

    c = KeyframeBuffer(kf.h, kf.w, capacity=kf.capacity, feat_dim=8,
                       device="cpu", model_hw=kf.model_hw)
    n = len(kf)
    for key in ("T_WC", "X", "C"):
        getattr(c, key)[:n] = getattr(kf, key)[:n].cpu()
    c.N[:], c.n_size, c.uimg = kf.N.copy(), n, list(kf.uimg)
    cs = States()
    cs.set_edges(states.edges_ii, states.edges_jj)
    cur = states.get_frame()
    if cur is not None:
        f = Frame(frame_id=cur.frame_id, img=None, img_shape=cur.img_shape,
                  img_true_shape=cur.img_true_shape, uimg=cur.uimg,
                  T_WC=cur.T_WC.cpu())
        f.X_canon = None if cur.X_canon is None else cur.X_canon.cpu()
        cs.set_frame(f)
    return c, cs


def card_ms(torch, fn):
    """``_host_ms`` of ``fn`` followed by a card sync."""
    return _host_ms(lambda: (fn(), torch.cuda.synchronize()))


def same(torch, a, b, tol=0.0):
    a, b = torch.as_tensor(a).cpu(), torch.as_tensor(b).cpu()
    return a.shape == b.shape and bool(torch.allclose(
        a, b, rtol=0, atol=tol, equal_nan=True))


def viz_renderer(torch, kf, states, kf_cpu, states_cpu):
    """``render_state`` on the card's buffer against the CPU copy at each
    size, with the median ms of 20 on the card, one CPU call's ms, the
    points splatted and the lock hold."""
    from mast3r_slam_tpu_torch.viz import render as R

    out = {}
    splatted = []
    splat = R.splat_points

    def counting(img, zbuf, P, *a):
        splatted.append(int(P.shape[0]))
        return splat(img, zbuf, P, *a)

    for hw in VIZ_RENDER_HW:
        R.splat_points = counting
        try:
            with timed_lock(kf) as held:
                got = R.render_state(kf, states, img_hw=hw)
            with one_cpu_thread(torch):
                t0 = time.perf_counter()
                want = R.render_state(kf_cpu, states_cpu, img_hw=hw)
                cpu_ms = (time.perf_counter() - t0) * 1e3
        finally:
            R.splat_points = splat
        agree = (got.cpu() == want).all(-1).float().mean().item()
        lit = (want > 0).any(-1).float().mean().item()
        check(got.device.type == "cuda" and agree >= VIZ_AGREE and lit > 0,
              f"viz render {hw}: {agree:.6f} of pixels agree card vs CPU "
              f"(need {VIZ_AGREE}), {lit:.4f} lit")
        ms = card_ms(torch, lambda: R.render_state(kf, states, img_hw=hw))
        out[hw] = dict(ms=ms, cpu_ms=cpu_ms, agree=agree, lit=lit,
                       points=splatted[-1], lock_ms=max(held) * 1e3)
        log(f"viz render_state {hw[0]}x{hw[1]}: {ms:.2f} ms on the card "
            f"(median of {HOST_REPEATS}; one CPU call {cpu_ms:.1f} ms), "
            f"{splatted[-1]} points splatted, {agree:.6f} of pixels equal "
            f"card vs CPU, {lit:.4f} lit, lock held {max(held) * 1e3:.3f} ms")
    return out


def viz_data_path(torch, kf, states, kf_cpu, states_cpu, cfg):
    """The GL viewer's data path without GL on the card's buffer against
    the CPU copy: ``_refresh_dirty`` (all keyframes dirty), ``_gather_map``,
    ``_camera_mvp`` and the overlay's triangles, with ms per call and the
    lock hold of ``_refresh_dirty``."""
    from mast3r_slam_tpu_torch.viz.viewer import Viewer

    n = len(kf)
    card, host = Viewer(kf, states, cfg), Viewer(kf_cpu, states_cpu, cfg)
    for v in (card, host):
        v.conf_threshold = 1.0
        v.keyframes.is_dirty[:n] = True
    with one_cpu_thread(torch):
        host._refresh_dirty()
    with timed_lock(kf) as held:
        card._refresh_dirty()
    check(sorted(card._kf_points) == list(range(n)),
          f"viz _refresh_dirty: keyframes {sorted(card._kf_points)}")
    for i in range(n):
        for name, a, b, tol in zip(("X", "C/N", "colour", "T_WC", "normals"),
                                   card._kf_points[i], host._kf_points[i],
                                   (0, 0, 0, 0, VIZ_TOL)):
            check(a.device.type == "cpu" and same(torch, a, b, tol),
                  f"viz _refresh_dirty keyframe {i}: {name} card vs CPU")
    got, want = card._gather_map(), host._gather_map()
    check(len(got[0]) > 0 and all(
        same(torch, a, b, tol) for a, b, tol in zip(got, want, (
            VIZ_TOL, 0, VIZ_TOL))), "viz _gather_map: card vs CPU")
    check(same(torch, card._camera_mvp(), host._camera_mvp()),
          "viz _camera_mvp: card vs CPU")
    check(all(same(torch, a, b) for a, b in zip(
        card.overlay.triangles(card.width, card.height),
        host.overlay.triangles(host.width, host.height))),
        "viz overlay triangles: card vs CPU")

    def refresh():
        kf.is_dirty[:n] = True
        card._refresh_dirty()

    with timed_lock(kf) as held_timed:
        refresh_ms = card_ms(torch, refresh)
    out = dict(refresh_ms=refresh_ms,
               refresh_lock_ms=max(held_timed) * 1e3,
               first_lock_ms=max(held) * 1e3,
               gather_ms=card_ms(torch, card._gather_map),
               mvp_ms=card_ms(torch, card._camera_mvp),
               overlay_ms=card_ms(torch, lambda: card.overlay.triangles(
                   card.width, card.height)),
               points=len(got[0]), keyframes=n)
    log(f"viz data path ({n} keyframes, {len(got[0])} points above conf "
        f"1.0): _refresh_dirty {out['refresh_ms']:.2f} ms (lock held at "
        f"most {out['refresh_lock_ms']:.3f} ms; first call "
        f"{out['first_lock_ms']:.3f})"
        f", _gather_map {out['gather_ms']:.2f} ms, _camera_mvp "
        f"{out['mvp_ms']:.4f} ms, overlay.triangles {out['overlay_ms']:.3f} "
        f"ms (medians of {HOST_REPEATS}); card vs CPU: points and normals "
        f"within {VIZ_TOL}, colours, matrices and triangles equal")
    return out


def viz_gl(torch, kf, states, cfg, cli_viewer):
    """The GL pipeline, where it can run: one frame through EGL with
    pixels landed. Returns why it was not exercised, or None."""
    import importlib.util

    from mast3r_slam_tpu_torch.viz.viewer import Viewer

    if cli_viewer.error is not None:
        log(f"viz: the CLI's viewer stopped in init_gl: "
            f"{type(cli_viewer.error).__name__}: {cli_viewer.error}")
    else:
        log(f"viz: the CLI's viewer drew {cli_viewer.frames} frames")
    if importlib.util.find_spec("OpenGL") is None:
        why = "PyOpenGL is not installed on this machine"
    else:
        v = Viewer(kf, states, cfg, width=VIZ_GL_HW[1], height=VIZ_GL_HW[0],
                   headless=True)
        try:
            v.init_gl()
        except Exception as e:
            why = f"no EGL context: {type(e).__name__}: {e}"
        else:
            try:
                v.render_frame()
                img = v.ctx.read_pixels()
            finally:
                v.ctx.destroy()
            bg = (int(0.05 * 255), int(0.05 * 255), int(0.08 * 255))
            lit = float((abs(img.astype(int) - bg).sum(-1) > 10).mean())
            check(lit > 0.01, f"viz GL: {lit:.4f} of pixels drawn")
            log(f"viz GL: one {VIZ_GL_HW[0]}x{VIZ_GL_HW[1]} frame through "
                f"EGL, {lit:.4f} of pixels drawn")
            return None
    log(f"viz: the GL pipeline was NOT exercised ({why}); the renderer "
        f"and the viewer's data path ran on the card")
    return why


def viz_model_entries(torch, FA, C3, BA, model, device="cuda"):
    """``two_view_infer`` and ``match_asymmetric`` at 384x512 on the card:
    bit for bit their plain compositions, with their K1 / K2 launches."""
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.ops import matching
    from mast3r_slam_tpu_torch.slam.frame import Frame

    imgs = [torch.from_numpy(f).to(device)
            for f in synthetic_frames(2, IMG_HW)]
    p, cfg = model.params, model.cfg
    want_one = {"K1": K1_PER_PAIR + K1_PER_DECODE, "K2": 2 * K2_PER_HEAD}
    reset_counters(FA, C3, BA)
    got = M.two_view_infer(p, cfg, imgs[0][None], imgs[1][None])
    torch.cuda.synchronize()
    two_view = launch_counts(FA, C3, BA)
    f1, p1 = M.encode_image(p, cfg, imgs[0][None])
    f2, p2 = M.encode_image(p, cfg, imgs[1][None])
    want = M.decode_heads(p, cfg, f1, p1, f2, p2, IMG_HW)
    check(all(torch.equal(a[k], b[k]) for a, b in zip(got, want)
              for k in ("pts3d", "conf", "desc", "desc_conf")),
          "viz two_view_infer: differs from decode_heads(encode_image x2)")
    check({k: two_view[k] for k in want_one} == want_one
          and two_view["K2 igemm"] == want_one["K2"],
          f"viz two_view_infer launches {two_view}, want {want_one}")
    frames = [Frame(frame_id=k, img=im, img_shape=IMG_HW,
                    img_true_shape=IMG_HW) for k, im in enumerate(imgs)]
    reset_counters(FA, C3, BA)
    got = model.match_asymmetric(*frames)
    torch.cuda.synchronize()
    asym = launch_counts(FA, C3, BA)
    X, C, D, Q = model.asymmetric_inference(*frames)
    idx, valid = matching.match(X[:1], X[1:], D[:1], D[1:],
                                **model._match_kw())
    n = IMG_HW[0] * IMG_HW[1]
    want = (idx, valid, *(a.reshape(2, n, -1)[k][None] for k in (0, 1)
                          for a in (X, C, Q)))
    check(len(got) == 8 and all(torch.equal(a, b)
                                for a, b in zip(got, want)),
          "viz match_asymmetric: differs from asymmetric_inference + match")
    check({k: asym[k] for k in want_one} == want_one,
          f"viz match_asymmetric launches {asym}, want {want_one}")
    log(f"viz two_view_infer / match_asymmetric at {IMG_HW[0]}x{IMG_HW[1]}:"
        f" bit for bit their compositions; launches K1 {two_view['K1']} / "
        f"{asym['K1']}, K2 {two_view['K2']} / {asym['K2']} (valid matches "
        f"{float(valid.float().mean()):.4f})")
    return {"two_view": two_view, "match_asymmetric": asym}


def phase_viz(torch, FA, C3, BA, workdir, cli=None, device="cuda"):
    """The port's CLI with its viewer (no ``--no-viz``) at full ViT-L width
    on the cli phase's 24-frame clip with base.yaml's services: launches
    from its own calls, and the modes, keyframes and edges of the clip's
    ``--no-viz`` run (the cli phase's main run, or one made here). Then, on
    that run's keyframe buffer on cuda:0 against a CPU copy: the software
    renderer at 480x640 and 720x1280 and the GL viewer's data path, with
    their times and lock holds; the GL pipeline through EGL where OpenGL
    imports (else a line says it was not exercised, and why); and
    ``two_view_infer`` / ``match_asymmetric`` at 384x512."""
    from mast3r_slam_tpu_torch.utils.config import load_config

    work = Path(workdir)
    clip = work / "smoke_tum_clip"
    if not (clip / "rgb.txt").exists():
        write_clip(clip, CLI_FRAMES)
    cfg_path = write_config(work / "cli.yaml")
    cfg = load_config(cfg_path)
    model = tied_model(cfg, device)
    base = ["--dataset", str(clip), "--config", cfg_path]
    t0 = time.perf_counter()
    out, launches, rec = run_cli(torch, FA, C3, BA, model, work,
                                 [*base, "--save-as", "viz"], "viewer")
    wall = time.perf_counter() - t0
    viewer, kf, states = out["viewer"], out["keyframes"], out["states"]
    check(viewer is not None and not viewer.is_alive(),
          "viz: the CLI did not start and stop its viewer")
    if cli is None:
        ref, _, ref_rec = run_cli(torch, FA, C3, BA, model, work,
                                  [*base, "--no-viz", "--save-as",
                                   "viz_off"], "viewer off")
        parts = cli_parts(ref_rec)
        cli = dict(modes=ref["modes"], edge_pairs=graph_edges(ref["graph"]),
                   keyframes=len(ref["keyframes"]),
                   tracked_ms=parts["track"], step_ms=parts["step"])
        del ref
    got = dict(modes=out["modes"], edge_pairs=graph_edges(out["graph"]),
               keyframes=len(kf))
    parts = cli_parts(rec)
    for key in got:
        check(got[key] == cli[key], f"viz: the run with the viewer has "
              f"{key} {got[key]}, the --no-viz run {cli[key]}")
    log(f"viz: the CLI with its viewer ran {len(out['modes'])} frames in "
        f"{wall:.1f} s: {len(kf)} keyframes, {len(got['edge_pairs'])} "
        f"edges, modes as the --no-viz run; launches K1 {launches['K1']}, "
        f"K2 {launches['K2']}, K4 {launches['K4']}; median tracked frame "
        f"{parts['track']:.1f} ms, backend step {parts['step']:.1f} ms "
        f"(--no-viz run: {cli['tracked_ms']:.1f} / {cli['step_ms']:.1f})")
    kf_cpu, states_cpu = cpu_copy(torch, kf, states)
    summary = dict(launches=launches, keyframes=len(kf),
                   tracked_ms=parts["track"], step_ms=parts["step"],
                   render=viz_renderer(torch, kf, states, kf_cpu,
                                       states_cpu),
                   data=viz_data_path(torch, kf, states, kf_cpu, states_cpu,
                                      cfg),
                   gl_not_exercised=viz_gl(torch, kf, states, cfg, viewer))
    del out, kf, states, kf_cpu, states_cpu
    summary.update(viz_model_entries(torch, FA, C3, BA, model, device))
    del model
    torch.cuda.empty_cache()
    return summary


PHASES = ("data", "kernels", "main", "event", "cross", "ba_kernels",
          "gram_bench", "backend_tools", "debug_tools", "oracle", "cli", "cli_cross",
          "cli_datasets", "video", "ate_study", "eval_harness", "recall",
          "reloc", "services", "topology", "viz")


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default="all",
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (a partial run prints no kernel table)")
    args = ap.parse_args()
    if not (ROOT / "mast3r_slam_tpu_torch" / "csrc").is_dir():
        raise CheckFailed(f"the port's package is not beside {__file__}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise CheckFailed("torch.cuda.is_available() is False: no CUDA card")

    from mast3r_slam_tpu_torch import _build
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.ops import ba_kernels as BA
    from mast3r_slam_tpu_torch.ops import conv3x3 as C3
    from mast3r_slam_tpu_torch.ops import device_loop as DL
    from mast3r_slam_tpu_torch.ops import flash_attention as FA

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    M.use_full_f32()
    t0 = time.perf_counter()
    ptx = []
    _build.build_all([FA.KERNEL, C3.KERNEL, BA.KERNEL, DL.KERNEL],
                     log=ptx.append)
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for block in ptx:
        for line in block.splitlines():
            if ("registers" in line or "spill" in line
                    or line.startswith("[nvcc")):
                log("  " + line.strip())

    phases = set(PHASES if args.phases == "all" else args.phases.split(","))
    unknown = phases - set(PHASES)
    if unknown:
        raise CheckFailed(f"unknown phases {sorted(unknown)}")
    timings = {}

    def run(name, fn, *a):
        if name not in phases:
            return None
        t0 = time.perf_counter()
        out = fn(*a)
        timings[name] = time.perf_counter() - t0
        log(f"phase {name}: {timings[name]:.1f} s")
        return out

    data = run("data", phase_data, smi)
    per_frame = run("kernels", phase_kernels, torch)
    main_path = run("main", phase_main_path, torch, FA, C3, BA)
    if main_path is not None:
        launches, tracked_ms, state = main_path
        event = run("event", phase_event, torch, FA, C3, BA, state)
        del state, main_path
        torch.cuda.empty_cache()
    run("cross", phase_cross_check, torch)
    gram = run("ba_kernels", phase_ba_kernels, torch, BA)
    k4p = run("gram_bench", phase_gram_bench, torch, FA, C3, BA)
    run("backend_tools", phase_backend_tools, torch, FA, C3, BA)
    run("debug_tools", phase_debug_tools, torch, smi)
    oracle = run("oracle", phase_oracle, torch, FA, C3, BA)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as work:
        cli = run("cli", phase_cli, torch, FA, C3, BA, work)
        run("cli_cross", phase_cli_cross, torch, work)
        datasets = run("cli_datasets", phase_cli_datasets, torch, FA, C3, BA,
                       work, smi)
        vid = run("video", phase_video, torch, FA, C3, BA, work, smi)
        ate = run("ate_study", phase_ate_study, torch, FA, C3, BA, smi)
        harness = run("eval_harness", phase_eval_harness, torch, FA, C3, BA,
                      work, smi)
        recall = run("recall", phase_recall, torch, FA, C3, BA, smi)
        run("topology", phase_topology, torch, FA, C3, BA, work, cli)
        viz = run("viz", phase_viz, torch, FA, C3, BA, work, cli)
    reloc = run("reloc", phase_reloc, torch, FA, C3, BA)
    services = run("services", phase_services, torch)
    log(f"phase times (s): {timings}")
    if phases != set(PHASES):
        log("partial run: no kernel table")
        return
    launches.update(K4=event["K4"], K5=oracle["K5"])
    ev_e, ev_g = event["ms"]["eager"], event["ms"]["graphed"]
    log(f"event: decode+match eager "
        f"{ev_e['oneway'] + ev_e['symmetric']:.1f} ms, graphed warm "
        f"{ev_g['oneway_warm'] + ev_g['symmetric_warm']:.1f} ms; solve "
        f"eager {ev_e['solve_warm']:.1f} ms, graphed "
        f"first {ev_g['solve']:.1f} ms, warm "
        f"{ev_g['solve_warm']:.1f} ms ({event['iters']} LM "
        f"iterations); graph pools {event['pools']} GiB; on {smi}")
    log(f"cli services off, graphed / eager track_core: median tracked "
        f"frame {cli['tracked_ms_off']:.1f} / {cli['tracked_ms_eager']:.1f} "
        f"ms, median backend step {cli['step_ms_off']:.1f} / "
        f"{cli['step_ms_eager']:.1f} ms; on {smi}")
    log(f"cli: median tracked frame {cli['tracked_ms']:.1f} ms, median "
        f"backend step {cli['step_ms']:.1f} ms (retrieval "
        f"{cli['retrieval_ms']:.1f}, add_factors {cli['add_factors_ms']:.1f},"
        f" solve {cli['solve_ms']:.1f}; {cli['steps']} steps), keyframes "
        f"{cli['keyframes']}, edges {cli['edges']} ({cli['loop_edges']} "
        f"from retrieval); reloc {reloc['ms']:.1f} ms; on {smi}")
    log(f"services (base.yaml): CLI median tracked frame "
        f"{cli['tracked_ms']:.1f} ms on / {cli['tracked_ms_off']:.1f} off, "
        f"median backend step {cli['step_ms']:.1f} / {cli['step_ms_off']:.1f}"
        f" ms; CLI quality jobs {cli['quality_jobs']} ({cli['quality_dropped']}"
        f" dropped), blocks refined / rejected {cli['refined']} / "
        f"{cli['rejected']}; oracle keyframes at 384x512: quality batch of 4 "
        f"{services['quality_ms']:.3f} ms, refine_blocks_core "
        f"{services['refine_ms']:.3f} ms per keyframe event (G 64), "
        f"integrate {services['integrate_ms']:.1f} ms per keyframe (host), "
        f"blocks refined / rejected {services['refined']} / "
        f"{services['rejected']}; on {smi}")
    r, d = viz["render"], viz["data"]
    log(f"viz: CLI with its viewer, launches K1 {viz['launches']['K1']} K2 "
        f"{viz['launches']['K2']} K4 {viz['launches']['K4']} on "
        f"{viz['keyframes']} keyframes; render_state ms "
        + ", ".join(f"{h}x{w} {r[h, w]['ms']:.2f} ({r[h, w]['points']} "
                    f"points, lock {r[h, w]['lock_ms']:.3f})"
                    for h, w in VIZ_RENDER_HW)
        + f"; _refresh_dirty {d['refresh_ms']:.2f} (lock "
        f"{d['refresh_lock_ms']:.3f}), _gather_map {d['gather_ms']:.2f}; "
        f"two_view_infer launches K1 {viz['two_view']['K1']} K2 "
        f"{viz['two_view']['K2']}, match_asymmetric K1 "
        f"{viz['match_asymmetric']['K1']} K2 "
        f"{viz['match_asymmetric']['K2']}; GL pipeline "
        + ("exercised" if viz["gl_not_exercised"] is None else
           f"not exercised ({viz['gl_not_exercised']})") + f"; on {smi}")
    log(f"accuracy tools: ate_study (seed 0, 96 frames, 64x96) "
        + "; ".join(f"{t} ATE BA {r['ate_ba_mean'] * 1e3:.3f} mm (track "
                    f"{r['ate_track_mean'] * 1e3:.3f}), {r['wall_s']:.1f} s"
                    for t, r in ate.items())
        + "; eval_harness " + "; ".join(
            f"{d} ATE {r['ate_rmse']:.6f} m, {r['keyframes']} keyframes, "
            f"frame {r['tracked_ms']:.1f} ms, step {r['step_ms']:.1f} ms"
            for d, r in harness.items())
        + f"; recall encoder {recall['encode_ms']:.2f} ms a frame "
        f"({recall['launches']} K1 launches), recall@1-3 "
        f"{recall['bootstrap']}; on {smi}")
    log(f"data: host ms, compiled / plain: remap EuRoC 752x480 gray "
        f"{data['remap_euroc_gray']['ms']:.2f} / "
        f"{data['remap_euroc_gray']['plain_ms']:.2f}, TUM fr1 640x480x3 "
        f"{data['remap_tum_rgb']['ms']:.2f} / "
        f"{data['remap_tum_rgb']['plain_ms']:.2f}; 480x640 PNG "
        + ", ".join(f"{n} {data[f'png_{n.lower()}']['ms']:.2f} / "
                    f"{data[f'png_{n.lower()}']['plain_ms']:.2f}"
                    for n in PNG_FILTERS)
        + "; resize_img compiled / plain " + ", ".join(
            f"{n} {data['resize'][n]['ms']:.3f} / "
            f"{data['resize'][n]['plain_ms']:.2f}" for n, _, _ in RESIZE_TIMED)
        + f"; TUM fr1 frame read {data['read_steps']['ms']:.2f}"
        f"; per 1200x680 Replica decode {data['decode_ms']:.2f} (smooth, "
        f"{data['decode_bytes']} bytes) / {data['decode_noisy_ms']:.2f} "
        f"(noisy, {data['decode_noisy_bytes']} bytes), progressive "
        f"{data['prog_ms']:.2f} / {data['prog_noisy_ms']:.2f}; "
        f"{data['fixture_reads']} fixture reads equal cv2's; CLI on the "
        f"evaluation layouts and the image folders (median tracked frame / "
        f"frame read / backend step ms; frame read compiled / plain in "
        f"turns): "
        + "; ".join(f"{t} {d['tracked_ms']:.1f} / {d['read_ms']:.2f} / "
                    f"{d['step_ms']:.1f} ({d['read_new_ms']:.2f} / "
                    f"{d['read_plain_ms']:.2f}; {d['keyframes']} keyframes, "
                    f"launches {d['launches']})"
                    for t, d in datasets.items()) + f"; on {smi}")

    dec = vid["decode"]
    log(f"video: host ms a frame, decode + RGB (converter compiled / "
        f"plain): " + ", ".join(
            f"{k} {v['hw'][1]}x{v['hw'][0]} {v['ms']:.3f}" + (
                f" ({v['convert_ms']:.3f} / {v['plain_convert_ms']:.2f})"
                if v["convert_ms"] == v["convert_ms"] else "")
            for k, v in dec.items())
        + "; " + "; ".join(
            f"CLI on {clip}: median tracked frame {vc['tracked_ms']:.1f} ms, "
            f"frame read {vc['read_ms']:.2f} ms, backend step "
            f"{vc['step_ms']:.1f} ms, {vc['keyframes']} keyframes, launches "
            f"{vc['launches']}"
            for clip, vc in ((VIDEO_CLI, vid["cli"]),
                             (VIDEO_CLI_H264, vid["cli_h264"]),
                             (VIDEO_CLI_H264_B, vid["cli_h264_b"]),
                             (VIDEO_CLI_VP9, vid["cli_vp9"]),
                             (VIDEO_CLI_XVID_B, vid["cli_xvid_b"]),
                             (VIDEO_CLI_HEVC, vid["cli_hevc"]),
                             (VIDEO_CLI_HEVC_GOP, vid["cli_hevc_gop"])))
        + f"; on {smi}")

    k2f = per_frame["K2 f32"]
    k2_path = C3.conv3x3_path(torch.float32, 256, 256)
    ba_path = BA.gram_path(torch.float32)
    table = {"kernels": [
        {"name": "flash_attention_rope", "route": "cuda",
         "source": "mast3r_slam_tpu_torch/csrc/flash_attention_rope.cu",
         "replaces": "mast3r_slam_tpu/ops/flash_attention.py:146",
         "launches": launches["K1"],
         "max_abs_err": per_frame["K1"]["err"],
         "ms": per_frame["K1"]["ms"],
         "first_ms": per_frame["K1"]["first_ms"],
         "plain_ms": per_frame["K1"]["plain_ms"],
         "bound_ms": per_frame["K1"]["bound_ms"],
         "bound_by": per_frame["K1"]["by"],
         "library_ms": per_frame["K1"]["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "mast3r_slam_tpu_torch/csrc/flash_attention_rope.cu",
         "replaces": "mast3r_slam_tpu/ops/flash_attention.py:200",
         "launches": launches["K3"],
         "max_abs_err": per_frame["K3"]["err"],
         "ms": per_frame["K3"]["ms"],
         "first_ms": per_frame["K3"]["first_ms"],
         "plain_ms": per_frame["K3"]["plain_ms"],
         "bound_ms": per_frame["K3"]["bound_ms"],
         "bound_by": per_frame["K3"]["by"],
         "library_ms": per_frame["K3"]["library_ms"]},
        {"name": "conv3x3", "route": "cuda",
         "source": "mast3r_slam_tpu_torch/csrc/conv3x3.cu",
         "replaces": "mast3r_slam_tpu/ops/conv3x3.py:119",
         "launches": launches["K2"],
         "max_abs_err": per_frame["K2"]["err"],
         "ms": per_frame["K2"]["ms"],
         "first_ms": per_frame["K2"]["first_ms"],
         "plain_ms": per_frame["K2"]["plain_ms"],
         "bound_ms": per_frame["K2"]["bound_ms"],
         "bound_by": per_frame["K2"]["by"],
         "library_ms": per_frame["K2"]["library_ms"]},
    ] + [
        {"name": name, "route": "cuda",
         "source": "mast3r_slam_tpu_torch/csrc/ba_gram.cu",
         "replaces": f"mast3r_slam_tpu/ops/ba_kernels.py:{line}",
         "launches": launches[key],
         "max_abs_err": gram[key]["err"],
         "ms": gram[key]["ms"],
         "first_ms": gram[key]["first_ms"],
         "plain_ms": gram[key]["plain_ms"],
         "bound_ms": gram[key]["bound_ms"],
         "bound_by": gram[key]["by"],
         "library_ms": gram[key]["library_ms"],
         **{f"{m}_e128": gram[key][f"{m}_e128"] for m in (
             "ms", "first_ms", "plain_ms", "library_ms", "bound_ms")}}
        for key, name, line in (("K4", "gram_rays", 216),
                                ("K5", "gram_calib", 232))
    ] + [
        {"name": "conv3x3 (float32)", "route": "cuda",
         "source": "mast3r_slam_tpu_torch/csrc/conv3x3.cu",
         "replaces": "mast3r_slam_tpu/ops/conv3x3.py:119",
         "launches": sum(d["launches"].get(f"K2 {k2_path}", 0)
                         for d in datasets.values()),
         "max_abs_err": k2f[IMG_HW]["err"],
         **{k: k2f[IMG_HW][k] for k in (
             "ms", "first_ms", "plain_ms", "bound_ms", "cuda_core_ms",
             "library_ms", "err64", "err64_first")},
         "bound_by": k2f[IMG_HW]["by"],
         **{f"{k}_{h}x{w}": k2f[h, w][k] for h, w in EVAL_CROPS
            for k in ("ms", "first_ms", "plain_ms", "bound_ms",
                      "library_ms")}},
    ] + [
        {"name": f"{name} (float32)", "route": "cuda",
         "source": "mast3r_slam_tpu_torch/csrc/ba_gram.cu",
         "replaces": f"mast3r_slam_tpu/ops/ba_kernels.py:{line}",
         "launches": sum(d["launches"][f"BA {ba_path}"]
                         for t, d in datasets.items() if t in tags),
         "max_abs_err": gram[key]["err"],
         **{m + sfx: gram[key][f"f32_{m}{sfx}"] for sfx in ("", "_e128")
            for m in ("ms", "first_ms", "plain_ms", "bound_ms",
                      "library_ms")},
         "bound_by": gram[key]["f32_by"],
         "err64_e128": gram[key]["f32_err64"],
         "err64_first_e128": gram[key]["f32_err64_first"]}
        for key, name, line, tags in (
            ("K4", "gram_rays", 216, ("euroc",)),
            ("K5", "gram_calib", 232, ("tum_fr1_calib", "replica",
                                       "replica_progressive")))
    ] + [
        {"name": f"gram_{name}", "route": "cuda",
         "source": "mast3r_slam_tpu_torch/csrc/ba_gram.cu",
         "replaces": f"scripts/gram_kernel_bench.py:{line}",
         "launches": k4p[key]["launches"],
         "max_abs_err": k4p[key]["err"],
         "ms": k4p[key]["ms"],
         "plain_ms": k4p[key]["plain_ms"],
         "bound_ms": k4p[key]["bound_ms"],
         "bound_by": k4p[key]["by"],
         "library_ms": k4p[key]["library_ms"],
         **({"gram_error_vs_k4": k4p[key]["vs_k4"]}
            if "vs_k4" in k4p[key] else {}),
         **({"first_ms": k4p[key]["first_ms"],
             "sass_per_pixel": k4p[key]["sass"]}
            if "first_ms" in k4p[key] else {})}
        for (key, name), line in zip(K4P, (62, 75, 115, 256))
    ]}
    log(f"K3's numbers are one call at the encoder shape (1, 16, 768, "
        f"768), bf16 (library: F.scaled_dot_product_attention); no path "
        f"calls K3. "
        f"K1/K2 ms/plain_ms/bound_ms/library_ms are per tracked frame "
        f"(the bf16 calls of one track_core; tracked frame "
        f"{tracked_ms:.1f} ms); K4/K5's are per system build at E = "
        f"{GRAM_REPORT[0]} (and, suffixed _e128, E = 128), N = "
        f"{GRAM_REPORT[1]}, bf16 channels and rows on the tensor-core path "
        f"(first_ms: the first, FMA design, path fma, in the same run; "
        f"library: torch.bmm of a pre-built bf16 row stack, Gram only). "
        f"Launches: K1/K2 on the main path, K4 in the keyframe event, K5 "
        f"in the calibrated oracle BA. K4'a-d (the Gram microbenchmark's "
        f"bodies, scripts/gram_kernel_bench.py's run_variant at :165): ms "
        f"at E = {K4P_SHAPES[-1][0]}, N = {K4P_SHAPES[-1][1]}, bf16 "
        f"channels and rows (library: torch.sum of an (8, E, N) bf16 stack "
        f"for K4'a, none for K4'b, torch.bmm of an (E, 8, 4N) / (E, 32, N) "
        f"bf16 stack for K4'c / K4'd); launches are the benchmark's own run "
        f"(python -m mast3r_slam_tpu_torch.bench.gram_kernel_bench, default "
        f"and --r2), 0 on every SLAM path (main, event, oracle, cli, reloc "
        f"checked); gram_error_vs_k4: K4'c against K4's diagonal-block sum, "
        f"K4'd against K4, on the same inputs (both K4's tensor-core kernel "
        f"with other tiles); K4'b's first_ms: its first kernel in the "
        f"same run, sass_per_pixel: its loop's SASS a pixel, bf16 "
        f"channels. The float32 rows: conv3x3 per tracked frame of f32 "
        f"heads at {IMG_HW[0]}x{IMG_HW[1]} (and, suffixed, the evaluation "
        f"crops), first_ms the first (fma) design, library cuDNN f32 with "
        f"TF32 off, bound the tensor-core floor of {TF32_PASSES} TF32 "
        f"passes (cuda_core_ms: the f32 CUDA-core floor), err64 against a "
        f"float64 conv; gram_rays / gram_calib with f32 channels and rows at"
        f" N = {GRAM_PIXELS[-1]}, E = {GRAM_REPORT[0]} (and _e128), library "
        f"torch.bmm of a pre-built f32 row stack with TF32 off, err64 the "
        f"Gram error against the float64 Gram of the same rows; launches "
        f"from the cli_datasets runs (eval configs: f32 heads, f32 rows)")
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except CheckFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
