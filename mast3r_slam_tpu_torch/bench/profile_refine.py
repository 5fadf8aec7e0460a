"""Layouts of the descriptor refine's gather, timed on the card.

    python -m mast3r_slam_tpu_torch.bench.profile_refine [--device cuda]

Counterpart of ``scripts/profile_refine.py``, at its sizes: one 384x512
image of F = 24 descriptor channels (``D11``), 196,608 query descriptors
(``D21``) and integer positions ``p1`` in ``[1, W-2) x [1, H-2)``, drawn
from numpy seed 0 (the JAX script draws them with ``jax.random``, so the
arrays differ; the tests hand the same arrays to both). One search level
at dilation 5 over the full (2r+1)^2 = 49-offset window (r = 3) moves each
position to its best-scoring offset, descriptors rounded to bf16 and
scores summed in float32, as the script's three layouts do (the image
rolled per offset, so a candidate off the image wraps around):

  A (H,W,K,F) stack       every offset's rolled image stacked (462 MB of
                          bf16 at 384x512), one row gather, one product,
  B flat (N,K*F) stack    the rolled images concatenated along channels,
  D per-offset gather     one rolled image and one gather per offset,
  B full 5 levels         B at dilations 5, 4, 3, 2, 1.

Beside them, the port's production search at the same shape:
``ops/matching.py``'s ``_search`` (one level at dilation 5, the joint
window, candidates off the image masked) and ``refine_matches`` (the
joint mode's five levels). On the card each is captured in a CUDA graph
and timed by CUDA events over ``--reps`` replays (the best replay and the
median); the eager call times the host (PR 20's finding). Each prints the
script's line, then one JSON line: the ms, the positions' digest, and the
card's ``nvidia-smi`` name and power limit. ``--device cpu`` (or
``main(argv, device="cpu")``) runs eagerly on the CPU, timed by the host
clock and labelled cpu; ``--hw`` and ``--reps`` only shrink the run for
the tests.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import statistics
import time

import numpy as np
import torch

HW = (384, 512)
F = 24
R, DIL = 3, 5
REPS = 10
VARIANTS = ("A (H,W,K,F) stack", "B flat (N,K*F) stack",
            "D per-offset gather")


def offsets(radius, dilation):
    """The window's ``(K, 2)`` integer ``(du, dv)`` offsets, du fastest (the
    script's)."""
    rng = np.arange(-radius, radius + 1) * dilation
    du, dv = np.meshgrid(rng, rng, indexing="xy")
    return np.stack([du.ravel(), dv.ravel()], -1)


@functools.lru_cache(maxsize=None)
def _offsets_on(radius, dilation, device):
    """:func:`offsets` on ``device``, made once (a captured level finds
    them there: a host copy cannot be captured)."""
    return torch.as_tensor(offsets(radius, dilation), device=device)


def make_inputs(hw=HW, f=F, seed=0):
    """``D11 (1, H, W, F)``, ``D21 (1, N, F)`` float32 normals and ``p1 (1,
    N, 2)`` int64 ``(u, v)`` positions, from numpy ``seed``."""
    H, W = hw
    rng = np.random.default_rng(seed)
    D11 = rng.standard_normal((1, H, W, f)).astype(np.float32)
    D21 = rng.standard_normal((1, H * W, f)).astype(np.float32)
    p1 = np.stack([rng.integers(1, W - 1, (1, H * W)),
                   rng.integers(1, H - 1, (1, H * W))], -1)
    return D11, D21, p1.astype(np.int64)


def _rolled(Di, du, dv):
    """``Di (H, W, F)`` rolled so that entry (v, u) holds (v + dv, u + du),
    wrapping around."""
    return torch.roll(Di, (-int(dv), -int(du)), (0, 1))


def _level(Dimg, pq, q, dil, radius, candidates):
    """One search level of each image: ``candidates(Di, lin, offs)`` gives
    the ``(N, K, F)`` bf16 candidates of the clamped linear positions; the
    scores are float32 sums of the bf16 products, the first maximum
    wins."""
    offs = offsets(radius, dil)
    offs_t = _offsets_on(radius, dil, pq.device)
    out = []
    for Di, pqi, qi in zip(Dimg.to(torch.bfloat16), pq,
                           q.to(torch.bfloat16)):
        h, w, _ = Di.shape
        pu = pqi[:, 0].clamp(0, w - 1)
        pv = pqi[:, 1].clamp(0, h - 1)
        sc = candidates(Di, pv * w + pu, offs, qi)
        out.append(pqi + offs_t[sc.argmax(-1)])
    return torch.stack(out)


def _scores_A(Di, lin, offs, qi):
    h, w, f = Di.shape
    rolled = torch.stack([_rolled(Di, du, dv) for du, dv in offs],
                         2).reshape(h * w, len(offs), f)
    return torch.einsum("nkf,nf->nk", rolled[lin].float(), qi.float())


def _scores_B(Di, lin, offs, qi):
    h, w, f = Di.shape
    rolled = torch.cat([_rolled(Di, du, dv) for du, dv in offs],
                       -1).reshape(h * w, len(offs) * f)
    cand = rolled[lin].reshape(-1, len(offs), f)
    return torch.einsum("nkf,nf->nk", cand.float(), qi.float())


def _scores_D(Di, lin, offs, qi):
    h, w, f = Di.shape
    return torch.stack([
        (_rolled(Di, du, dv).reshape(h * w, f)[lin].float()
         * qi.float()).sum(-1) for du, dv in offs], -1)


def level_A(Dimg, pq, q, dil, radius=R):
    """Variant A: the ``(H, W, K, F)`` stack of rolled images."""
    return _level(Dimg, pq, q, dil, radius, _scores_A)


def level_B(Dimg, pq, q, dil, radius=R):
    """Variant B: the flat ``(N, K*F)`` stack."""
    return _level(Dimg, pq, q, dil, radius, _scores_B)


def level_D(Dimg, pq, q, dil, radius=R):
    """Variant D: one gather per offset."""
    return _level(Dimg, pq, q, dil, radius, _scores_D)


def full_B(Dimg, pq, q, dil_max=DIL, radius=R):
    """Variant B at every dilation from ``dil_max`` down to 1."""
    for d in range(dil_max, 0, -1):
        pq = level_B(Dimg, pq, q, d, radius)
    return pq


def production_search(Dimg, pq, q, dil=DIL, radius=R):
    """``ops/matching.py``'s ``_search`` at one level of the joint window
    (bf16-rounded float32 descriptors, as ``refine_matches`` feeds it)."""
    from mast3r_slam_tpu_torch.ops import matching

    b, h, w, f = Dimg.shape
    D = Dimg.to(torch.bfloat16).float().reshape(b, h * w, f)
    qh = q.to(torch.bfloat16).float()
    ((offs, offs_t),) = matching._offset_tables(radius, dil, "joint",
                                                pq.device)
    out = [torch.stack(matching._search(D[i], qh[i], pq[i, :, 0],
                                        pq[i, :, 1], offs, offs_t, h, w),
                       -1) for i in range(b)]
    return torch.stack(out)


def production_refine(Dimg, pq, q, dil=DIL, radius=R):
    """``ops/matching.py``'s ``refine_matches``, joint mode, every level."""
    from mast3r_slam_tpu_torch.ops import matching

    return matching.refine_matches(Dimg, q, pq, radius, dil, "joint", 1)


def digest(p):
    """The first 16 hex digits of the positions' SHA-256 (int64 bytes)."""
    a = np.ascontiguousarray(p.detach().cpu().numpy().astype(np.int64))
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def graph_ms(fn, reps):
    """``fn()`` captured in a CUDA graph and replayed ``reps`` times, each
    replay between CUDA events: ``(output, best ms, median ms)``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                               # warm: caches, cuBLAS workspace
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    out = out.clone()
    del graph
    torch.cuda.empty_cache()
    return out, min(times), statistics.median(times)


def host_ms(fn, reps):
    out = fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, min(times), statistics.median(times)


def run(hw=HW, reps=REPS, device="cuda", emit=print):
    """Every variant and the production search at ``hw``; returns the
    records (one a variant) and the positions by name."""
    from mast3r_slam_tpu_torch.bench.frame_profile import smi

    dev = torch.device(device)
    D11, D21, p1 = (torch.as_tensor(a, device=dev) for a in make_inputs(hw))
    cases = [(f"{name} dil={DIL}", lambda fn=fn: fn(D11, p1, D21, DIL))
             for name, fn in zip(VARIANTS, (level_A, level_B, level_D))]
    cases += [("B full 5 levels", lambda: full_B(D11, p1, D21)),
              (f"production _search dil={DIL}",
               lambda: production_search(D11, p1, D21)),
              ("production refine_matches (joint)",
               lambda: production_refine(D11, p1, D21))]
    card = dev.type == "cuda"
    where = smi() if card else "cpu"
    records, positions = [], {}
    for name, fn in cases:
        out, best, med = (graph_ms if card else host_ms)(fn, reps)
        positions[name] = out
        emit(f"{name:42s} {best:8.2f} ms")
        rec = dict(variant=name, ms=best, median_ms=med, reps=reps,
                   timing="cuda graph, cuda events" if card
                   else "eager, host clock (cpu)",
                   digest=digest(out), hw=list(hw), channels=F, radius=R,
                   device=where)
        emit(json.dumps(rec))
        records.append(rec)
    return records, positions


def main(argv=None, device="cuda"):
    """Run the profile; returns the records (one JSON line each)."""
    from mast3r_slam_tpu_torch.main import _check_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=device)
    ap.add_argument("--hw", type=int, nargs=2, default=HW)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = _check_device(args.device)
    records, _ = run(tuple(args.hw), args.reps, dev,
                     emit=lambda *a: print(*a, flush=True))
    return records


if __name__ == "__main__":
    main()
