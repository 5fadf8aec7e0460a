"""The keyframe event's decode + match, stage by stage, at full ViT-L width.

    python -m mast3r_slam_tpu_torch.bench.profile_backend_decode
        [--head-dtype float32|bfloat16] [--device cuda]

Counterpart of ``scripts/profile_backend_decode.py``: ``MASt3RConfig()``
(ViT-L encoder, base decoder, DPT 256; bf16 trunk, float32 heads, or
base.yaml's bf16 heads with ``--head-dtype bfloat16``) with random weights
from seed 0 at 384x512, and the script's synthetic workload
(:func:`make_inputs`): encoder features ``(2, 768, 1024)`` decoded against
their own reverse; for the matcher a smooth depth surface seen through
f 300, its second view rolled by -3 pixels along W, 24 sin·cos descriptor
channels (unit norm, rolled the same way) and the identity init. The JAX
script draws the features and the descriptors' frequencies with
``jax.random``; the port draws them with numpy from the same seeds (1 and
7), so its arrays differ from the script's (the tests hand the port's
arrays to both packages). The stages:

  decode_pair (batch 2)          the two-stream decoder,
  downstream_head (batch 2)      head 1 on stream 1's hooks,
  decode+both heads (fused)      the decoder and both heads in one call,
  match B=2 (level_step=1, 2)    ``matching.match`` on both rows at once,
  match 2x B=1 (level_step=2)    the same rows one by one,

each the best of 3 calls with its input varied by 1e-6 r, timed by CUDA
events from a synced card, after one warm call whose K1 / K2 launches are
counted (K2 by path). Beside them, the port's graphed
``MASt3RInference.match_symmetric`` on the same features (B = 1: the
event's symmetric edge, its decode the batch-2 decode above) with
base.yaml's matcher settings: its capture, its best warm replay and the
eager call, whose outputs must equal the replay's bit for bit. It prints
the script's lines, then one JSON line with the card's ``nvidia-smi``
name and power limit. It runs on the card; ``--device cpu`` (or
``main(argv, device="cpu")``) runs the plain versions, for the tests (every
time labelled cpu; no graph). There is no fallback from the card to the
CPU. ``--tiny``, ``--hw`` and ``--reps`` only shrink the run for the
tests.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

HW = (384, 512)
REPS = 3
FOCAL = 300.0
SHIFT = -3                      # the second view's roll along W, pixels
DESC_CHANNELS = 24
CONFIG = Path(__file__).resolve().parents[2] / "config" / "base.yaml"
STAGES = ("decode_pair (batch 2)", "downstream_head (batch 2)",
          "decode+both heads (fused)", "match B=2 (level_step=1)",
          "match B=2 (level_step=2)", "match 2x B=1 (level_step=2)")


def make_inputs(cfg, hw=HW):
    """The synthetic workload as numpy arrays: ``feat (2, n_tok, C)``;
    ``X1, X2 (2, H, W, 3)``, ``D1, D2 (2, H, W, 24)`` and ``init (2, N)``
    (see the module docstring)."""
    H, W = hw
    n_tok = (H // cfg.patch_size) * (W // cfg.patch_size)
    feat = np.random.default_rng(1).standard_normal(
        (2, n_tok, cfg.enc_embed_dim)).astype(np.float32)
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    z = 2.0 + 0.3 * np.sin(u / 23.0) + 0.2 * np.cos(v / 17.0)
    X1 = np.stack([(u - W / 2) / FOCAL * z, (v - H / 2) / FOCAL * z, z],
                  -1)[None]
    X1 = np.concatenate([X1, X1], 0)
    X2 = np.roll(X1, SHIFT, axis=2)
    dk = np.random.default_rng(7).uniform(
        0.02, 0.3, (DESC_CHANNELS, 4)).astype(np.float32)
    D1 = np.stack([np.sin(u * dk[i, 0]) * np.cos(v * dk[i, 1])
                   for i in range(DESC_CHANNELS)], -1)[None]
    D1 = np.concatenate([D1, D1], 0)
    D1 = D1 / np.maximum(np.linalg.norm(D1, axis=-1, keepdims=True), 1e-6)
    D2 = np.roll(D1, SHIFT, axis=2)
    init = np.broadcast_to(np.arange(H * W, dtype=np.int64)[None],
                           (2, H * W)).copy()
    return dict(feat=feat, X1=X1, X2=X2, D1=D1.astype(np.float32),
                D2=D2.astype(np.float32), init=init)


def to_device(arrs, cfg, hw, device):
    from mast3r_slam_tpu_torch.models import mast3r as M

    t = {k: torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for k, a in arrs.items()}
    t["pos"] = M.patch_positions(hw[0] // cfg.patch_size,
                                 hw[1] // cfg.patch_size, 2, device)
    return t


def stages(params, cfg, t, hw):
    """``{name: fn(r)}``: each stage on its input varied by ``1e-6 r``, as
    the script's jitted lambdas (``params`` from ``prepare_params``)."""
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.ops import matching

    feat, pos = t["feat"], t["pos"]
    rev = feat.flip(0)
    hw = tuple(hw)

    def dec(r):
        return M.decode_pair(params, cfg, feat + 1e-6 * r, pos, rev, pos)

    d1, _ = dec(0)

    def head(r):
        return M.downstream_head(M.head_params(params, 0), cfg,
                                 [x + 1e-6 * r for x in d1], hw)

    def full(r):
        return tuple(M.downstream_head(M.head_params(params, k), cfg, d,
                                       hw)["pts3d"]
                     for k, d in enumerate(dec(r)))

    def match(ls, rows=slice(None)):
        def run(r):
            return matching.match(t["X1"][rows] + 1e-6 * r, t["X2"][rows],
                                  t["D1"][rows], t["D2"][rows],
                                  idx_1_to_2_init=t["init"][rows],
                                  level_step=ls)
        return run

    one = match(2, slice(0, 1))

    def both_rows(r):
        return one(r)[0], one(r + 0.5)[0]

    return dict(zip(STAGES, (dec, head, full, match(1), match(2),
                             both_rows)))


def _first_tensor(out):
    while isinstance(out, (tuple, list, dict)):
        out = out[0] if not isinstance(out, dict) else next(iter(
            out.values()))
    return out


def _counters():
    from mast3r_slam_tpu_torch.ops import conv3x3 as C3
    from mast3r_slam_tpu_torch.ops import flash_attention as FA

    return {"K1": FA.counter, "K3": FA.attn_counter, "K2": C3.counter,
            **{f"K2 {p}": c for p, c in C3.path_counters.items()}}


def launches_of(fn):
    """``fn()`` with the K1 / K2 / K3 counters at 0 before and read after:
    ``(out, launches)``."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    out = fn()
    return out, {k: c.launches for k, c in counters.items()}


def best_ms(fn, reps, device):
    """The best of ``reps`` calls ``fn(1..reps)``, each from a synced
    device (``frame_profile.call_ms``), and the last call's checksum (the
    sum of its first output)."""
    from mast3r_slam_tpu_torch.bench.frame_profile import call_ms

    best, s = float("inf"), None
    for r in range(1, reps + 1):
        out, ms = call_ms(lambda: fn(r), device)
        best = min(best, ms)
        s = float(_first_tensor(out).double().sum())
    return best, s


def graphed_match(params, cfg, t, hw, match_cfg, reps, device):
    """``match_symmetric`` of the features' first and second rows (B = 1),
    graphed (capture, then the best of ``reps`` replays) and eagerly.
    Returns the record and whether the replay's outputs equal the eager
    call's bit for bit (None on the CPU: no graph)."""
    from mast3r_slam_tpu_torch.models.inference import MASt3RInference

    feat, pos = t["feat"], t["pos"]
    args = (feat[:1], pos[:1], feat[1:], pos[1:], tuple(hw))
    eager = MASt3RInference(params, cfg, match_cfg, graphed=False)
    rec = {}
    t0 = time.perf_counter()
    ref, rec["eager_launches"] = launches_of(
        lambda: eager.match_symmetric(*args))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    rec["eager_first_ms"] = (time.perf_counter() - t0) * 1e3
    rec["eager_ms"], _ = best_ms(lambda r: eager.match_symmetric(*args), reps,
                                 device)
    if device.type != "cuda":
        rec.update(capture_ms=None, ms=None, same_bits=None)
        return rec
    model = MASt3RInference(params, cfg, match_cfg)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    model.match_symmetric(*args)
    torch.cuda.synchronize(device)
    rec["capture_ms"] = (time.perf_counter() - t0) * 1e3
    rec["ms"], _ = best_ms(lambda r: model.match_symmetric(*args), reps,
                           device)
    out, rec["replay_launches"] = launches_of(
        lambda: model.match_symmetric(*args))
    rec["same_bits"] = all(torch.equal(a, b) for a, b in zip(out, ref))
    rec["captures"], rec["replays"] = (model.graphs.captures,
                                       model.graphs.replays)
    return rec


def run(params, cfg, hw, match_cfg, reps, device, emit=print):
    """Every stage and the graphed ``match_symmetric``; returns the
    record (the JSON line). ``params`` from ``prepare_params``."""
    from mast3r_slam_tpu_torch.bench.frame_profile import device_label

    label = device_label(device)
    unit = "ms" if device.type == "cuda" else "ms (cpu)"
    t = to_device(make_inputs(cfg, hw), cfg, hw, device)
    emit(f"backend decode + match stages at {hw[0]}x{hw[1]} on {label}: "
         f"trunk {cfg.dtype}, heads {cfg.head_dtype}, best of {reps}")
    rec = dict(tool="profile_backend_decode", hw=list(hw), dtype=cfg.dtype,
               head_dtype=cfg.head_dtype, enc_embed_dim=cfg.enc_embed_dim,
               reps=reps, ms={}, launches={}, checksum={})
    for name, fn in stages(params, cfg, t, hw).items():
        _, rec["launches"][name] = launches_of(lambda: fn(0))
        rec["ms"][name], rec["checksum"][name] = best_ms(fn, reps, device)
        emit(f"{name:34s} {rec['ms'][name]:8.1f} {unit}   (sum "
             f"{rec['checksum'][name]:.3g})")
    ms = rec["ms"]
    rec["stage_sum_ms"] = (ms["decode+both heads (fused)"]
                           + ms["match 2x B=1 (level_step=2)"])
    rec["match_symmetric"] = m = graphed_match(params, cfg, t, hw, match_cfg,
                                               reps, device)
    emit(f"{'decode+both heads + 2x B=1 match':34s} "
         f"{rec['stage_sum_ms']:8.1f} {unit}   (stage sum)")
    if m["ms"] is not None:
        emit(f"{'match_symmetric B=1 (graphed)':34s} {m['ms']:8.1f} {unit}"
             f"   (capture {m['capture_ms']:.1f}; eager {m['eager_ms']:.1f};"
             f" bit for bit {m['same_bits']})")
    else:
        emit(f"{'match_symmetric B=1 (eager)':34s} {m['eager_ms']:8.1f} "
             f"{unit}")
    rec["device"] = label
    return rec


def main(argv=None, device="cuda"):
    """Run the profile; returns its record (the JSON line)."""
    from mast3r_slam_tpu_torch.main import _check_device
    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.utils.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--head-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="DPT / MLP head compute type (float32: the "
                    "script's MASt3RConfig(); bfloat16: base.yaml's)")
    ap.add_argument("--device", default=device)
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny test config instead of ViT-L")
    ap.add_argument("--hw", type=int, nargs=2, default=HW)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = _check_device(args.device)
    cfg = (M.tiny_config(head_dtype=args.head_dtype) if args.tiny
           else M.MASt3RConfig(head_dtype=args.head_dtype))
    params = M.prepare_params(M.init_params(cfg, seed=0, device=dev), cfg)
    match_cfg = load_config(str(CONFIG)).get("matching", {})
    rec = run(params, cfg, tuple(args.hw), match_cfg, args.reps, dev,
              emit=lambda *a: print(*a, flush=True))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
