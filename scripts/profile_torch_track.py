#!/usr/bin/env python3
"""Where a tracked frame's time goes in the PyTorch port, on one CUDA card.

    python3 scripts/profile_torch_track.py [--frames 8] [--eager]
        [--src-hw 480,640] [--trace out.json]

Builds the full-width ViT-L model with random weights and the
``config/base.yaml`` settings (as ``chip_smoke.py`` does), makes a keyframe
by mono inference, tracks a few warm-up frames (the first captures the
tracker's CUDA graph), then:

- by default, the graphed frame (``FrameTracker``'s CUDA graph of
  ``track_core``, the path a user runs): ``--frames`` frames with the host
  steps timed by host clock (``utils/tictoc.py::STEPS``: ``create_frame``'s
  resize, upload, display image and pose; the tracker's keyframe snapshot
  and small inputs; the graph's key, input copies, launch, counters and
  output clones; the decision read; the rest of ``track``), no sync inside
  a step and one at the frame's end;
- with ``--eager``, ``FrameTracker(..., graphed=False)``: the stages of
  ``track_core`` (``encode_image``, ``decode_heads``, ``match``, the pose
  solve, fusion, the selection stats and the quality tensors), each timed
  by host clock with a device sync at its end;

then ``--frames`` more frames under ``torch.profiler``: the device's busy
time a frame, its kernels a frame counted from the device's own events (in
the graph replay and outside it), and its idle time split into the gaps
inside the replay and the rest (``bench/frame_profile.py``), the share of
the two ported kernels (K1 with its RoPE pre-pass, K2 with its split-K
sum) and the top kernels. Each result is a JSON line with the card's
``nvidia-smi`` name and power limit. Frames are made at ``--src-hw``
(default the model crop, which ``create_frame`` copies) and resized by
``create_frame``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--eager", action="store_true",
                    help="track_core eagerly, timed stage by stage")
    ap.add_argument("--src-hw", default=None,
                    help="H,W of the frames before create_frame's resize")
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled frames here")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from mast3r_slam_tpu_torch.bench import frame_profile as FP
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.models.inference import MASt3RInference
    from mast3r_slam_tpu_torch.ops import matching
    from mast3r_slam_tpu_torch.slam import tracker as T
    from mast3r_slam_tpu_torch.slam.frame import KeyframeBuffer
    from mast3r_slam_tpu_torch.slam.pipeline import create_frame
    from mast3r_slam_tpu_torch.utils.config import load_config
    from mast3r_slam_tpu_torch.utils.tictoc import STEPS

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = FP.smi()
    mode = "eager" if args.eager else "graphed"
    cfg = load_config(str(ROOT / "config" / "base.yaml"))
    mcfg = M.MASt3RConfig(dtype=cfg["model"]["dtype"],
                          head_dtype=cfg["model"]["head_dtype"])
    params = M.prepare_params(M.init_params(mcfg, seed=0), mcfg)
    model = MASt3RInference(params, mcfg)
    H, W = chip_smoke.IMG_HW
    src_hw = (tuple(int(v) for v in args.src_hw.split(","))
              if args.src_hw else (H, W))
    kfs = KeyframeBuffer(H, W, capacity=8, feat_dim=mcfg.enc_embed_dim)
    tracker = T.FrameTracker(model, kfs, cfg, graphed=not args.eager)

    n_warm = 2
    imgs = chip_smoke.synthetic_frames(1 + n_warm + 2 * args.frames, src_hw)
    # the frames are in [-1, 1]: create_frame takes [0, 1]
    f0 = create_frame(0, (imgs[0] + 1.0) * 0.5, img_size=W)
    X, C = model.inference_mono(f0)
    f0.update_pointmap(X[0], C[0])
    kfs.append(f0)
    frames = iter(enumerate(imgs[1:], start=1))

    def track_next():
        i, img = next(frames)
        frame = create_frame(i, (img + 1.0) * 0.5,
                             T_WC=kfs.T_WC[len(kfs) - 1], img_size=W)
        new_kf, _, _ = tracker.track(frame)
        if new_kf:
            kfs.append(frame)

    for _ in range(n_warm):
        track_next()

    stage_ms = defaultdict(list)

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            stage_ms[name].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapper

    patches = ([(M, "encode_image"), (M, "decode_heads"),
                (matching, "match"), (T, "opt_pose_ray_dist_sim3"),
                (T, "fuse_pointmap"), (T, "kf_selection_stats"),
                (T, "quality_job_tensors")] if args.eager else [])
    saved = [(mod, name, getattr(mod, name)) for mod, name in patches]
    for mod, name, fn in saved:
        setattr(mod, name, timed(name, fn))
    total = []
    STEPS.start()
    try:
        for _ in range(args.frames):
            torch.cuda.synchronize()
            t = time.perf_counter()
            track_next()
            torch.cuda.synchronize()
            STEPS.lap("frame: end sync")
            total.append((time.perf_counter() - t) * 1e3)
            STEPS.end_frame()
    finally:
        STEPS.stop()
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    host = FP.host_breakdown(STEPS.frames, total)
    if args.eager:
        host["stages"] = {k: statistics.median(v)
                          for k, v in stage_ms.items()}
    print(json.dumps({"profile": f"{mode} frame, host", "smi": smi,
                      "frames": args.frames, "src_hw": src_hw, **host}))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(args.frames):
            track_next()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / args.frames
    frame_ms = host["frame_ms"]
    dev = FP.device_split(prof, args.frames, frame_ms)
    # Only device-side events: a CPU op's self device time is the time of
    # the kernels it launched, which appear again as events of their own.
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in events)
    ported_us = sum(e.self_device_time_total for e in events
                    if any(name in e.key for name in
                           ("flash_", "rope_rotate_rows", "conv3x3")))
    print(json.dumps({
        "profile": f"{mode} frame, device", "smi": smi,
        "frames": args.frames, "frame_ms": frame_ms,
        "profiled_wall_ms": wall, **dev,
        "ported_ms": ported_us / 1e3 / args.frames,
        "ported_share": ported_us / dev_us if dev_us else None}))
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:20]:
        print(f"  {e.self_device_time_total / 1e3 / args.frames:8.3f} ms/frame"
              f" {e.self_device_time_total / max(dev_us, 1):6.1%} "
              f"{e.count / args.frames:6.0f}/frame  {e.key[:70]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
