"""Loop-closure recall of the retrieval database through the port's encoder.

    python -m mast3r_slam_tpu_torch.bench.retrieval_recall [--stress]
        [--tiny] [--device cuda]

The port's counterpart of the JAX repo's ``scripts/retrieval_recall.py``.
It builds a camera path over a textured world that goes out and comes back
(second-leg frames revisit first-leg viewpoints with a small pixel jitter
and noise), encodes every frame with the MASt3R encoder and measures the
loop-closure recall@k of ``slam/retrieval.py::RetrievalDatabase`` as the
CLI builds it: with the online-bootstrap codebook, with a projector head
of the pretrained shape (random weights), and over a sweep of
``min_thresh``. ``--stress`` prints the perturbation-family table instead
(viewpoint shift, photometric drift, descriptor noise, distractor scenes).

By default the encoder is MASt3R at full ViT-L width with random weights
from seed 0 on 384x512 frames, where K1 runs at the tracking path's shape;
``--tiny`` is the JAX script's tiny encoder on 64x96 frames. It runs on
the CUDA card; ``--device cpu`` (or ``main(argv, device="cpu")``) runs the
plain versions. There is no fallback from the card to the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np

N_HALF = 12
FULL_HW = (384, 512)
TINY_HW = (64, 96)


def _make_world(H, W, rng):
    """Smooth world texture: random field blurred by separable box passes."""
    world = rng.random((H * 3, W * 8, 3)).astype(np.float32)
    for _ in range(8):
        world = 0.25 * (np.roll(world, 1, 0) + np.roll(world, -1, 0)
                        + np.roll(world, 1, 1) + np.roll(world, -1, 1))
    return (world - world.min()) / (np.ptp(world) + 1e-9) * 2.0 - 1.0


def build_loop_frames(n_half=12, H=64, W=96, seed=0, jitter=2,
                      shift_frac=0.0, gain=1.0, bias=0.0, noise=0.02,
                      n_distractors=0):
    """Crops from a smooth textured world along an out-and-back path.

    Returns (images (2*n_half [+ distractors], H, W, 3) float32 in [-1, 1],
    revisit_of: for second-half frame i, the first-half index it revisits).

    Stress knobs: ``shift_frac`` shifts the revisit crops horizontally by
    this fraction of W (partial overlap with the mapped view); ``gain`` /
    ``bias`` drift their photometry; ``noise`` is the sigma of the noise
    added to them; ``n_distractors`` frames from a different world are
    inserted between the legs (hard negatives).
    """
    rng = np.random.default_rng(seed)
    world = _make_world(H, W, rng)
    shift_px = int(shift_frac * W)

    xs = np.linspace(0, world.shape[1] - W - jitter - shift_px - 1,
                     n_half).astype(int)
    ys = (H + (H * np.sin(np.linspace(0, np.pi, n_half))).astype(int) // 2)
    imgs, revisit_of = [], []
    for i in range(n_half):
        imgs.append(world[ys[i]: ys[i] + H, xs[i]: xs[i] + W].copy())
    if n_distractors:
        other = _make_world(H, W, np.random.default_rng(seed + 1000))
        dxs = np.linspace(0, other.shape[1] - W - 1,
                          n_distractors).astype(int)
        for x in dxs:
            imgs.append(other[H: 2 * H, x: x + W].copy())
    for i in range(n_half - 1, -1, -1):
        dx = rng.integers(0, jitter + 1) + shift_px
        dy = rng.integers(0, jitter + 1)
        crop = world[ys[i] + dy: ys[i] + dy + H,
                     xs[i] + dx: xs[i] + dx + W].copy()
        crop = np.clip(gain * crop + bias, -1.0, 1.0)
        crop += noise * rng.standard_normal(crop.shape).astype(np.float32)
        revisit_of.append(i)
        imgs.append(crop)
    return np.stack(imgs), revisit_of


def encode_frames(imgs, params, cfg, device):
    """Each image's encoder tokens ``(1, N, D)`` on ``device``, and the host
    ms of each encode with the device synced around it."""
    import torch

    from mast3r_slam_tpu_torch.models import mast3r as M
    from mast3r_slam_tpu_torch.utils.tictoc import sync

    feats, ms = [], []
    with torch.no_grad():
        for im in imgs:
            x = torch.as_tensor(im, device=device)[None]
            sync()
            t0 = time.perf_counter()
            feat, _ = M.encode_image(params, cfg, x)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            feats.append(feat)
    return feats, ms


@dataclasses.dataclass
class _Frame:
    feat: object


def measure_recall(feats, revisit_of, n_half, head_params=None, k=3,
                   min_thresh=0.0, desc_dim=None):
    """Recall@1..k of the revisit leg (a hit: a first-leg frame within one
    path step of the revisited one) and the number of revisits."""
    from mast3r_slam_tpu_torch.slam.retrieval import RetrievalDatabase

    db = RetrievalDatabase({}, codebook_size=64, nfeat=64,
                           desc_dim=desc_dim, head_params=head_params)
    hits = {kk: 0 for kk in range(1, k + 1)}
    total = 0
    # layout: [first leg (n_half)][optional distractors][revisit leg];
    # the revisit leg is always the LAST len(revisit_of) frames
    revisit_start = len(feats) - len(revisit_of)
    for i, feat in enumerate(feats):
        top = db.update(_Frame(feat=feat), add_after_query=True, k=k,
                        min_thresh=min_thresh)
        if i >= revisit_start:
            gt = revisit_of[i - revisit_start]
            good = {gt - 1, gt, gt + 1}
            total += 1
            for kk in range(1, k + 1):
                if any(t in good for t in top[:kk]):
                    hits[kk] += 1
    return {kk: hits[kk] / max(total, 1) for kk in hits}, total


def projector_head(d, seed=1):
    """Whiteners and a one-layer projector as ``models/convert.py`` emits
    them, random weights of the pretrained shape."""
    rng = np.random.default_rng(seed)
    return {
        "prewhiten_m": np.zeros((1, d), np.float32),
        "prewhiten_P": np.eye(d, dtype=np.float32),
        "projector": [
            {"w": (rng.standard_normal((d, d)) / np.sqrt(d)).astype(
                np.float32),
             "b": np.zeros(d, np.float32)},
        ],
        "postwhiten_m": np.zeros((1, d), np.float32),
        "postwhiten_P": np.eye(d, dtype=np.float32),
        "residual": False,
    }


def _fmt(rec):
    return ", ".join(f"@{k}={v:.2f}" for k, v in rec.items())


def recall_tables(params, cfg, hw, device):
    """The JAX script's ``main``: bootstrap codebook, projector head and the
    ``min_thresh`` sweep. Returns the recalls and the encoder's ms a
    frame (median)."""
    imgs, revisit_of = build_loop_frames(n_half=N_HALF, H=hw[0], W=hw[1])
    feats, ms = encode_frames(imgs, params, cfg, device)
    d = cfg.enc_embed_dim
    enc_ms = statistics.median(ms)
    print(f"encoded {len(feats)} frames ({d}-wide encoder, {hw[0]}x{hw[1]}; "
          f"median {enc_ms:.2f} ms a frame)", flush=True)
    out = {"frames": len(feats), "encode_ms": enc_ms}
    out["bootstrap"], total = measure_recall(feats, revisit_of, N_HALF,
                                             desc_dim=d)
    print(f"bootstrap codebook: recall@k over {total} revisits: "
          + _fmt(out["bootstrap"]), flush=True)
    out["head"], _ = measure_recall(feats, revisit_of, N_HALF,
                                    head_params=projector_head(d),
                                    desc_dim=d)
    print("projector-head path:  recall@k: " + _fmt(out["head"]), flush=True)
    out["min_thresh"] = {}
    for mt in (0.0, 1e-3, 5e-3, 2e-2, 5e-2):
        rec, _ = measure_recall(feats, revisit_of, N_HALF, min_thresh=mt,
                                desc_dim=d)
        out["min_thresh"][mt] = rec
        print(f"min_thresh={mt:g}: recall@1={rec[1]:.2f} "
              f"recall@3={rec[3]:.2f}", flush=True)
    return out


STRESS = {
    "viewpoint shift (frac of W)": [
        ("0.12", dict(shift_frac=0.12)),
        ("0.25", dict(shift_frac=0.25)),
        ("0.40", dict(shift_frac=0.40)),
    ],
    "photometric drift (gain/bias)": [
        ("0.9/+0.05", dict(gain=0.9, bias=0.05)),
        ("0.75/+0.15", dict(gain=0.75, bias=0.15)),
        ("0.6/-0.25", dict(gain=0.6, bias=-0.25)),
    ],
    "descriptor noise (sigma)": [
        ("0.05", dict(noise=0.05)),
        ("0.10", dict(noise=0.10)),
        ("0.20", dict(noise=0.20)),
    ],
    "distractor scenes (count)": [
        ("6", dict(n_distractors=6)),
        ("12", dict(n_distractors=12)),
        ("24", dict(n_distractors=24)),
    ],
}


def stress(params, cfg, hw, device):
    """Recall of the bootstrap-codebook stack under viewpoint shift,
    photometric drift, descriptor noise and distractor scenes, at three
    severities each."""
    print(f"stress table ({N_HALF} revisits per cell, {cfg.enc_embed_dim}-"
          f"wide encoder, {hw[0]}x{hw[1]}):", flush=True)
    out = {}
    for fam, cells in STRESS.items():
        row = []
        for label, kw in cells:
            imgs, revisit_of = build_loop_frames(n_half=N_HALF, H=hw[0],
                                                 W=hw[1], **kw)
            feats, _ = encode_frames(imgs, params, cfg, device)
            rec, _ = measure_recall(feats, revisit_of, N_HALF,
                                    desc_dim=cfg.enc_embed_dim)
            out[(fam, label)] = rec
            row.append(f"{label}: @1={rec[1]:.2f} @3={rec[3]:.2f}")
        print(f"  {fam:32s} " + " | ".join(row), flush=True)
    return out


def main(argv=None, device="cuda"):
    """Run the recall tables (or ``--stress``); returns their recalls."""
    from mast3r_slam_tpu_torch.bench.frame_profile import device_label
    from mast3r_slam_tpu_torch.main import _check_device
    from mast3r_slam_tpu_torch.models import mast3r as M

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stress", action="store_true",
                    help="the perturbation-family table")
    ap.add_argument("--tiny", action="store_true",
                    help="the JAX script's tiny encoder on 64x96 frames")
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    dev = _check_device(args.device)
    cfg = M.tiny_config() if args.tiny else M.MASt3RConfig()
    hw = TINY_HW if args.tiny else FULL_HW
    params = M.cast_params_for_compute(M.init_params(cfg, seed=0,
                                                    device=dev), cfg)
    print(f"retrieval recall on {device_label(dev)}", flush=True)
    if args.stress:
        return stress(params, cfg, hw, dev)
    return recall_tables(params, cfg, hw, dev)


if __name__ == "__main__":
    main()
