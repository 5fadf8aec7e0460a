"""Writes the video fixtures of this folder and ``digests.json``: for each
file, cv2's ``CAP_PROP_FPS`` and ``CAP_PROP_FRAME_COUNT``, and per frame
the SHA-256 of ``cv2.VideoCapture``'s RGB frame and of the port's
(``data/video.py``), with the largest and the mean absolute difference
between the two. The MPEG-4 Part 2 and MJPEG files come from OpenCV's
writer (``cv2.VideoWriter``, its FFmpeg backend), which writes no H.264;
the VP9 files from cv2's writer too (libvpx: ``VP90`` into Matroska and
AVI, ``vp09`` into MP4) and from the test writer
``tests/torch_vp9_writer.py`` (random legal syntax of the tools libvpx
through cv2 never writes: hidden frames and ``show_existing_frame``,
compound prediction, backward adaptation with intra-only and
error-resilient frames, segmentation with lossless and delta-q, tile
rows); the MPEG-4 Part 2 files as Xvid and DivX write them from the test writer
``tests/torch_mpeg4_writer.py`` (its encoder's IBBP pan at 480x640 with
4MV and AC prediction, the CLI's Xvid clip; random syntax: B-VOPs in MP4
and in Matroska BlockGroups, a packed DivX AVI, the I/P tools at an odd
size under an Xvid build FFmpeg gives its edge and DC workarounds);
the H.264 files from the test writer ``tests/torch_h264_writer.py``:
random legal syntax from a seed (CAVLC and CABAC, in MP4, Matroska and
AVI) and its small encoder's pans (a cropped 152x104 clip, a 1920x1080 one
coded at 1088, and the 640x480 clips of the CLI run and the host timing);
with B pictures, random syntax in MP4 (``ctts`` with and without ``elst``),
Matroska and AVI, and IBBP pans at 1920x1080 and 640x480 (the CLI's B
clip); the HEVC files from the test writer ``tests/torch_hevc_writer.py``:
random syntax by tool group (``hvc1`` and ``hev1`` MP4, MOV, Matroska; a
640x480 one deblocks and runs SAO in every slice) and its small encoder's
pans (1920x1080 coded at 1088, the CLI's 640x480
clip, a 640x480 one of low-delay B pictures); and in GOP structures out of
decode order, random syntax in x265's, HM's (its last picture not put out)
and the BLA types' structures and the CLI's 640x480 clip of hierarchical
GOPs with a CRA picture. A fixture's digests hold null for a frame cv2
does not read (only at the end).

    python tests/data/video/make_fixtures.py          # every file
    python tests/data/video/make_fixtures.py h264     # the H.264 I/P files
    python tests/data/video/make_fixtures.py h264b    # the H.264 B files
    python tests/data/video/make_fixtures.py vp9      # the VP9 files
    python tests/data/video/make_fixtures.py mpeg4    # the MPEG-4 writer's files
    python tests/data/video/make_fixtures.py hevc     # the HEVC writer's files

The last five forms keep the cv2-written files and their digests as they are:
cv2 rewrites the MP4, MOV and AVI files byte for byte, but FFmpeg's
Matroska muxer draws a new segment UID and track UID (and the CRC-32s over
them) each run, so every full run changes ``mp4v.mkv`` and ``mjpg.mkv``
though their frames stay the same.

The frames are a smooth texture panning out and back (the CLI tests'
clips), so that the P-VOPs carry real motion vectors; ``xvid_busy.avi``
cuts from it to moving noise halfway, which gives intra macroblocks in
P-VOPs and TCOEF escapes. ``tests/test_torch_video.py`` holds the port
against cv2 and the JAX reader on these files, and ``chip_smoke.py``'s
video phase holds it against the digests on the card machine, which has
no cv2. This script is a test tool: the port never imports it.
"""

import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))
sys.path.insert(0, str(HERE.parents[1]))
import torch_h264_writer as W  # noqa: E402
import torch_hevc_writer as WH  # noqa: E402
import torch_mpeg4_writer as W4  # noqa: E402
import torch_vp9_writer as W9  # noqa: E402

from mast3r_slam_tpu_torch.data import video  # noqa: E402

# name: (fourcc, (height, width), frames, kind)
FILES = {
    "cli_640x480.mp4": ("mp4v", (480, 640), 16, "pan"),
    "mp4v.mov": ("mp4v", (120, 160), 16, "pan"),
    "mp4v.mkv": ("mp4v", (120, 160), 16, "pan"),
    "mp4v_152x104.mp4": ("mp4v", (104, 152), 12, "pan"),
    "mp4v_one.mp4": ("mp4v", (120, 160), 1, "pan"),
    "xvid.avi": ("XVID", (120, 160), 16, "pan"),
    "xvid_busy.avi": ("XVID", (88, 120), 10, "busy"),
    "mjpg.avi": ("MJPG", (120, 160), 8, "pan"),
    "mjpg.mkv": ("MJPG", (96, 128), 8, "pan"),
}


# name: (entropy coder, container, random_stream options) of the H.264
# random-syntax clips, 64x48 coded, 8 pictures each
H264_RANDOM = {
    "h264_cavlc.mp4": (False, dict(seed=11, t8=True, lists=True, weighted=True,
                                   poc_type=0, max_refs=4, crop=(0, 4, 0, 2))),
    "h264_cavlc.mkv": (False, dict(seed=12, t8=False, poc_type=1,
                                   constrained_intra=True,
                                   vui=dict(full_range=1, matrix=1))),
    "h264_cavlc.avi": (False, dict(seed=13, t8=True, poc_type=2, max_refs=3,
                                   vui=dict(full_range=0, matrix=9))),
    "h264_cabac.mp4": (True, dict(seed=21, t8=True, lists=True, weighted=True,
                                  poc_type=0, max_refs=4, crop=(0, 0, 2, 4))),
    "h264_cabac.mkv": (True, dict(seed=22, t8=True, poc_type=1,
                                  constrained_intra=True,
                                  vui=dict(full_range=1, matrix=6))),
    "h264_cabac.avi": (True, dict(seed=23, t8=False, poc_type=2, weighted=True,
                                  max_refs=3)),
}
# name: (frames, (height, width), CABAC, QP, crop (l, r, t, b), pan step) of
# the encoder's pans
# (sub-sample steps: the P pictures' motion vectors run the 6-tap filter)
H264_PANS = {
    "h264_152x104.mp4": (12, (104, 152), False, 26, (0, 8, 0, 8), (5.5, 2.25)),
    "h264_1920x1080.mp4": (4, (1080, 1920), True, 30, (0, 0, 0, 8), (12.75, 4.5)),
    "cli_640x480_h264.mp4": (16, (480, 640), True, 24, (0, 0, 0, 0), (12.5, 4.25)),
    "h264_cavlc_640x480.avi": (4, (480, 640), False, 24, (0, 0, 0, 0), (12.5, 4.25)),
}
H264_NAMES = tuple(H264_RANDOM) + tuple(H264_PANS)
# the same for B pictures: random syntax (16 pictures, mini-GOPs of up to
# three B pictures, a reference one in the middle) and IBBP pans
H264B_RANDOM = {
    "h264_b_cabac.mp4": (True, dict(seed=31, frames=16, idr_every=8, reorder=2)),
    "h264_b_noelst.mp4": (True, dict(seed=32, frames=16, reorder=-1, bipred=2),
                          dict(elst=False)),
    "h264_b_cavlc.mkv": (False, dict(seed=33, frames=16, idr_every=8, reorder=2,
                                     bipred=1, direct8x8=False)),
    "h264_b_cavlc.avi": (False, dict(seed=34, frames=16, reorder=2, spatial=False)),
}
H264B_PANS = {
    "h264_b_1920x1080.mp4": (6, (1080, 1920), True, 30, (0, 0, 0, 8), (6.25, 2.25)),
    "cli_640x480_h264_b.mp4": (16, (480, 640), True, 24, (0, 0, 0, 0), (6.25, 2.125)),
}
H264B_NAMES = tuple(H264B_RANDOM) + tuple(H264B_PANS)
# VP9 from cv2's writer: name: (fourcc, (height, width), frames, kind). cv2
# codes the 131x99 busy clip at 130x98 (its writer halves odd sizes down)
VP9_FILES = {
    "vp9.mkv": ("VP90", (120, 160), 16, "pan"),
    "vp9.mp4": ("vp09", (120, 160), 16, "pan"),
    "vp9.avi": ("VP90", (120, 160), 16, "pan"),
    "vp9_busy_131x99.mkv": ("VP90", (99, 131), 14, "busy"),
    "cli_640x480_vp9.mkv": ("VP90", (480, 640), 16, "pan"),
    "vp9_1920x1080.mkv": ("VP90", (1080, 1920), 4, "pan"),
}
# and from the test writer: name: (tool group, seed, frames)
VP9_RANDOM = {
    "vp9_hidden.mkv": ("hidden", 101, 8),
    "vp9_compound.mp4": ("compound", 100, 8),
    "vp9_adapt.avi": ("adapt", 103, 8),
    "vp9_seg.mkv": ("seg", 101, 8),
    "vp9_tiles.mp4": ("tiles", 100, 8),
}
VP9_NAMES = tuple(VP9_FILES) + tuple(VP9_RANDOM)

# the MPEG-4 Part 2 writer's files, as Xvid and DivX write them: name:
# (fourcc, random_stream group or "pan", options, muxer options)
MPEG4_FILES = {
    "cli_640x480_xvid_b.avi": ("XVID", "pan", dict(n=16, hw=(480, 640), step=(12.0, 4.0)), {}),
    "xvid_b.mp4": ("mp4v", "b", dict(seed=41, width=64, height=48, frames=12, gop=6,
                                      gov=True, time_res=7), {}),
    "xvid_b4mv.mkv": ("XVID", "b4mv", dict(seed=42, width=80, height=48, frames=12, gop=6),
                      dict(vfw=b"XVID", groups=True)),
    "divx_packed.avi": ("XVID", "packed", dict(seed=43, width=64, height=48, frames=12, gop=6,
                                               build="divx_packed"), {}),
    "xvid_tools_66x50.avi": ("XVID", "inter", dict(seed=44, width=66, height=50, frames=8,
                                                   gop=4, build="xvid0"), {}),
}


# HEVC from the test writer: random syntax (name: tool group, seed, frames,
# random_stream options, muxer options), chosen so that each file carries
# its tools (CTB sizes and counts come with the seed)
HEVC_RANDOM = {
    "hevc_main.mp4": ("inter", 302, 8, dict(wpp=True, sao=True, amp=True, tmvp=True,
                                            sign_hiding=True, transform_skip=True,
                                            scaling="sps"), {}),
    "hevc_tiles.mkv": ("tiles", 310, 8, dict(tiles=(3, 2), lf_across_tiles=False,
                                             lf_across_slices=False, dependent_slices=True,
                                             cuts=6), {}),
    "hevc_ltr.mov": ("ltr", 312, 12, dict(pcm=(8, 7, 3, 4, True), bypass=True,
                                          weighted_pred=True), {}),
    "hevc_hev1.mp4": ("inter", 319, 12, dict(gop=4, irap=21, reorder=1), dict(entry=b"hev1")),
    "hevc_ldb.mkv": ("ldb", 308, 8, dict(vui=dict(full_range=1, matrix=1)), {}),
    # deblocking and SAO in every slice at 640x480, CTB 64: the host time
    # of the loop filters the encoder's pans leave off
    "hevc_sao_640x480.mp4": ("sao", 404, 6, dict(width=640, height=480, filters=True, cuts=1),
                             {}),
    # GOP structures out of decode order (torch_hevc_writer.GOPS): x265's
    # pyramid with a CRA picture and RASL pictures, explicit weights and
    # TMVP from either list; HM's GOP 8 in Matroska, its last picture in
    # presentation order sent with pic_output_flag 0 (the last read fails,
    # in any order); BLA_W_LP / BLA_W_RADL with RADL pictures, BLA_N_LP, a
    # CRA picture with RASL pictures and IDR_W_RADL in hev1
    "hevc_x265.mp4": ("weights", 410, 26, dict(gop="x265"), {}),
    "hevc_hm.mkv": ("inter", 410, 28, dict(gop="hm", hidden=(27,)), {}),
    "hevc_bla.mp4": ("ldb", 412, 36, dict(gop="bla"), dict(entry=b"hev1")),
}
# the encoder's pans: name: (frames, (height, width), QP, crop (l, r, t, b),
# pan step, CTB log2, low-delay B pictures)
HEVC_PANS = {
    "hevc_1920x1080.mp4": (4, (1080, 1920), 34, (0, 0, 0, 8), (12.75, 4.5), 5, False),
    "cli_640x480_hevc.mp4": (16, (480, 640), 28, (0, 0, 0, 0), (12.5, 4.25), 4, False),
    "hevc_b_640x480.mp4": (8, (480, 640), 30, (0, 0, 0, 0), (6.25, 2.25), 4, True),
}
# the encoder's pans in HM's hierarchical GOPs (frames, (height, width), QP,
# pan step, GOP size, the CRA picture's place): the CLI clip of B pictures
# out of decode order, read with subsample 2 across its open GOP
HEVC_GOP_PANS = {
    "cli_640x480_hevc_gop.mp4": (32, (480, 640), 28, (12.5, 4.25), 8, 16),
}
HEVC_NAMES = tuple(HEVC_RANDOM) + tuple(HEVC_PANS) + tuple(HEVC_GOP_PANS)


def write_hevc(path, name):
    """An HEVC writer fixture; returns its clip."""
    if name in HEVC_RANDOM:
        group, seed, n, opts, mux = HEVC_RANDOM[name]
        opts = dict(opts)
        cuts = opts.pop("cuts", 3)
        clip = WH.random_stream(seed, group, frames=n, cuts=cuts, **opts)
    elif name in HEVC_PANS:
        n, hw, qp, crop, step, ctb, bframes = HEVC_PANS[name]
        mot = pan_motion(n, step)
        motion = [(0, 0)] + [tuple(2 * v for v in mot(i, i - 1)) for i in range(1, n)]
        clip = WH.encode(pan_frames(n, hw, step=step), qp=qp, crop=crop, motion=motion,
                         ctb_log2=ctb, bframes=bframes)
        mux = {}
    else:
        n, hw, qp, step, gop, cra = HEVC_GOP_PANS[name]
        mot = pan_motion(n, step)
        clip = WH.encode(pan_frames(n, hw, step=step), qp=qp, gop=gop, cra=cra,
                         motion=lambda a, b: tuple(2 * v for v in mot(a, b)))
        mux = {}
    WH.MUX[path.suffix[1:]](path, clip, **mux)
    return clip


def pan_motion(n, step):
    """pan_frames' global motion in half-pels from frame b to frame a."""
    def motion(a, b):
        pa, pb = min(a, n - 1 - a), min(b, n - 1 - b)
        return (int(round(2 * step[0] * (pa - pb))), int(round(2 * step[1] * (pa - pb))))
    return motion


def write_mpeg4(path, name):
    """An MPEG-4 writer fixture; returns its clip."""
    fourcc, group, opts, mux = MPEG4_FILES[name]
    if group == "pan":
        n, hw, step = opts["n"], opts["hw"], opts["step"]
        clip = W4.encode(pan_frames(n, hw, step=step), motion=pan_motion(n, step))
    else:
        clip = W4.random_stream(opts.pop("seed"), group, **opts)
    W4.MUX[path.suffix[1:]](path, clip, **mux)
    return clip


def pan_frames(n, hw, step=(6.0, 2.0), seed=0):
    """Smooth texture panning out and back: uint8 RGB ``(H, W, 3)``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float64)
    freqs = rng.uniform(0.01, 0.05, (3, 2))
    phases = rng.uniform(0, 2 * np.pi, 3)
    for i in range(n):
        p = min(i, n - 1 - i)
        x, y = xx + step[0] * p, yy + step[1] * p
        img = np.stack([np.sin(fx * x + fy * y + ph)
                        for (fx, fy), ph in zip(freqs, phases)], -1)
        yield ((0.9 * img + 1.0) * 127.5).astype(np.uint8)


def busy_frames(n, hw, seed=5):
    """The pan, then from frame n // 2 moving noise around a still patch."""
    noise = np.random.default_rng(seed).integers(0, 256, (*hw, 3),
                                                 dtype=np.uint8)
    h, w = hw
    for i, f in enumerate(pan_frames(n, hw, seed=3)):
        if i >= n // 2:
            g = np.roll(noise, (3 * i, 5 * i), (0, 1))
            g[h // 3:2 * h // 3, w // 3:2 * w // 3] = \
                f[h // 3:2 * h // 3, w // 3:2 * w // 3]
            f = g
        yield f


def write_h264(path, name):
    mux = {".mp4": W.write_mp4, ".mkv": W.write_mkv, ".avi": W.write_avi}[path.suffix]
    if name in H264B_RANDOM:
        cabac, opts, *mux_opts = H264B_RANDOM[name]
        clip = W.random_stream(opts["seed"], cabac=cabac, b=True,
                               **{k: v for k, v in opts.items() if k != "seed"})
        mux(path, clip, **(mux_opts[0] if mux_opts else {}))
        return clip
    if name in H264B_PANS:
        n, hw, cabac, qp, crop, step = H264B_PANS[name]
        clip = W.encode(pan_frames(n, hw, step=step), cabac=cabac, qp=qp, crop=crop,
                        bframes=2)
        mux(path, clip)
        return clip
    if name in H264_RANDOM:
        cabac, opts = H264_RANDOM[name]
        clip = W.random_stream(opts["seed"], cabac=cabac, frames=8,
                               **{k: v for k, v in opts.items() if k != "seed"})
    else:
        n, hw, cabac, qp, crop, step = H264_PANS[name]
        clip = W.encode(pan_frames(n, hw, step=step), cabac=cabac, qp=qp, crop=crop)
    mux(path, clip)
    return clip


def write(path, fourcc, hw, n, kind):
    frames = (pan_frames(n, hw, step=(12.0, 4.0)) if hw[1] >= 640 else
              busy_frames(n, hw) if kind == "busy" else pan_frames(n, hw))
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 30,
                         (hw[1], hw[0]))
    if not wr.isOpened():
        raise RuntimeError(f"cv2 cannot write {path}")
    for f in frames:
        wr.write(np.ascontiguousarray(f[..., ::-1]))
    wr.release()


def sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def record(path, fourcc, hw):
    """cv2's frames of the fixture read in order, and the port's: their
    digests, or None where cv2 reads no frame (a file whose last pictures
    are not put out: the port must fail there too, and only at the end)."""
    cap = cv2.VideoCapture(str(path))
    reader = video.VideoReader(path)
    frames = []
    for i in range(int(cap.get(cv2.CAP_PROP_FRAME_COUNT))):
        ok, bgr = cap.read()
        if not ok:
            try:
                reader.read(i)
            except ValueError:
                frames.append(None)
                continue
            raise AssertionError(f"{path.name}: cv2 reads no frame {i}, the port does")
        assert not frames or frames[-1] is not None, (path.name, i)
        want = bgr[..., ::-1]
        got = reader.read(i)
        d = np.abs(got.astype(np.int16) - want.astype(np.int16))
        frames.append({"cv2": sha(want), "port": sha(got),
                       "max_abs": int(d.max()),
                       "mean_abs": float(d.mean())})
    print(path.name, path.stat().st_size, "bytes,",
          "max |port - cv2|", max(f["max_abs"] for f in frames if f))
    return {"fourcc": fourcc, "hw": list(hw),
            "fps": cap.get(cv2.CAP_PROP_FPS),
            "frame_count": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            "frames": frames}


def write_vp9(path, name):
    """A VP9 fixture; returns its fourcc and (height, width)."""
    if name in VP9_FILES:
        fourcc, hw, n, kind = VP9_FILES[name]
        write(path, fourcc, hw, n, kind)
    else:
        group, seed, n = VP9_RANDOM[name]
        W9.MUX[path.suffix[1:]](path, W9.random_stream(seed, group, frames=n))
    t = video.VideoReader(path).track
    return t.fourcc, (t.height, t.width)


def main(which="all"):
    out = {}
    digests = HERE / "digests.json"
    names = {"h264": H264_NAMES, "h264b": H264B_NAMES, "vp9": (), "mpeg4": (),
             "hevc": ()}.get(which, H264_NAMES + H264B_NAMES)
    vp9 = which in ("vp9", "all")
    mpeg4 = which in ("mpeg4", "all")
    hevc = which in ("hevc", "all")
    if which in ("h264", "h264b", "vp9", "mpeg4", "hevc") and digests.exists():
        drop = (VP9_NAMES if which == "vp9" else tuple(MPEG4_FILES) if which == "mpeg4"
                else HEVC_NAMES if which == "hevc" else names)
        out = {k: v for k, v in json.loads(digests.read_text()).items()
               if k not in drop}
    else:
        for name, (fourcc, hw, n, kind) in FILES.items():
            write(HERE / name, fourcc, hw, n, kind)
            out[name] = record(HERE / name, fourcc, hw)
    for name in VP9_NAMES if vp9 else ():
        fourcc, hw = write_vp9(HERE / name, name)
        out[name] = record(HERE / name, fourcc, hw)
    for name in MPEG4_FILES if mpeg4 else ():
        clip = write_mpeg4(HERE / name, name)
        out[name] = record(HERE / name, MPEG4_FILES[name][0], (clip.height, clip.width))
    for name in HEVC_NAMES if hevc else ():
        clip = write_hevc(HERE / name, name)
        fourcc = video.VideoReader(HERE / name).track.fourcc
        out[name] = record(HERE / name, fourcc, (clip.height, clip.width))
    for name in names:
        path = HERE / name
        clip = write_h264(path, name)
        fourcc = "H264" if path.suffix == ".avi" else "avc1"
        out[name] = record(path, fourcc, (clip.height, clip.width))
    digests.write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main(*sys.argv[1:])
