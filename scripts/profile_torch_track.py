#!/usr/bin/env python3
"""Where a tracked frame's time goes in the PyTorch port, on one CUDA card.

    python3 scripts/profile_torch_track.py [--frames 6] [--trace out.json]

Builds the full-width ViT-L model with random weights and the
``config/base.yaml`` settings (as ``chip_smoke.py`` does), makes a keyframe
by mono inference, tracks a few warm-up frames, then times ``--frames``
tracked frames stage by stage (host clock around each stage, with a
device sync at its end) and once more under ``torch.profiler`` for the
device-side breakdown: device busy time per frame (the device events'
own times, summed), the share of the two ported kernels (K1 with its RoPE
pre-pass, K2 with its split-K sum), and the top kernels.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled frames here")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.models.inference import MASt3RInference
    from mast3r_slam_tpu_torch.ops import matching
    from mast3r_slam_tpu_torch.slam import tracker as T
    from mast3r_slam_tpu_torch.slam.frame import KeyframeBuffer
    from mast3r_slam_tpu_torch.slam.pipeline import create_frame
    from mast3r_slam_tpu_torch.utils.config import load_config

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cfg = load_config(str(ROOT / "config" / "base.yaml"))
    mcfg = M.MASt3RConfig(dtype=cfg["model"]["dtype"],
                          head_dtype=cfg["model"]["head_dtype"])
    params = M.prepare_params(M.init_params(mcfg, seed=0), mcfg)
    model = MASt3RInference(params, mcfg)
    H, W = chip_smoke.IMG_HW
    kfs = KeyframeBuffer(H, W, capacity=8, feat_dim=mcfg.enc_embed_dim)
    tracker = T.FrameTracker(model, kfs, cfg)

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

    n_warm = 2
    imgs = chip_smoke.synthetic_frames(1 + n_warm + 2 * args.frames, (H, W))
    # the frames are at the model crop in [-1, 1]: create_frame takes [0, 1]
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

    patches = [(M, "encode_image"), (M, "decode_heads"), (matching, "match"),
               (T, "opt_pose_ray_dist_sim3"), (T, "fuse_pointmap"),
               (T, "kf_selection_stats"), (T, "quality_job_tensors")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in patches]
    for mod, name, fn in saved:
        setattr(mod, name, timed(name, fn))
    total = []
    try:
        for _ in range(args.frames):
            torch.cuda.synchronize()
            t = time.perf_counter()
            track_next()
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t) * 1e3)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"tracked frame (host clock, sync at end): median "
          f"{statistics.median(total):.1f} ms over {len(total)} frames")
    for name, vals in stage_ms.items():
        print(f"  {name:24s} median {statistics.median(vals):8.2f} ms")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(args.frames):
            track_next()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / args.frames
    # Only device-side events: a CPU op's self device time is the time of the
    # kernels it launched, which appear again as events of their own.
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in averages
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cuLaunchKernelEx", "cudaLaunchKernelExC"))
    dev_us = sum(e.self_device_time_total for e in events)
    busy = dev_us / 1e3 / args.frames
    frame_ms = statistics.median(total)
    print(f"profiled: device busy {busy:.2f} ms/frame (sum of kernel and "
          f"copy times), idle share {max(0.0, 1 - busy / frame_ms):.3f} of "
          f"the unprofiled {frame_ms:.1f} ms frame ({wall:.1f} ms/frame "
          f"under the profiler), {launches / args.frames:.0f} kernel "
          f"launches/frame")
    ported_us = sum(e.self_device_time_total for e in events
                    if any(name in e.key for name in
                           ("flash_", "rope_rotate_rows", "conv3x3")))
    print(f"  ported kernels (K1 + K2): {ported_us / 1e3 / args.frames:.2f} "
          f"ms/frame, {ported_us / dev_us:.1%} of device time")
    events.sort(key=lambda e: -e.self_device_time_total)
    for e in events[:20]:
        print(f"  {e.self_device_time_total / 1e3 / args.frames:8.3f} ms/frame"
              f" {e.self_device_time_total / dev_us:6.1%} "
              f"{e.count / args.frames:6.0f}/frame  {e.key[:70]}")
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
