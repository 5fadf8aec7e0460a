"""Where the BA Gram kernel's time goes on the card: K4 against the floors
of its stages (kernel K4′, ``ops/gram_variants.py``).

    python -m mast3r_slam_tpu_torch.bench.gram_kernel_bench [--r2 | --grids]

Counterpart of ``scripts/gram_kernel_bench.py``. At the production shape
(E = 128 edges, N = 98,304 pixels, bf16 channels and rows) it times

  v1 load   the sum of the 8 channels (the memory-read floor),
  v2 rows   K4's 32 weighted rows, correctly rounded as the JAX body's
            (IEEE division and square root), summed without a Gram: nvcc's
            fast sequences with one range guard a pixel, one-wave grid,
  v2 first  the same function on the first kernel, with a check
            and a slow-path branch per operation (on the card only),
  v2f rows  v2's kernel on the tensor-core path's arithmetic (MUFU ops,
            reciprocal sigmas; ``gram_variants.gram_rows_fast``), so that
            v2 − v2f is what correct rounding costs the row stage,
  v3 diag   only the four diagonal 8x8 blocks that the solver reads,
  v0f full  K4 on its first design (``path="fma"``, the Gram as f32 FMAs),
  v0 full   the production K4 (``ba_kernels.gram_rays``, path "mma"),

then prints how far v3 is from the sum of v0's diagonal blocks. ``--r2``
sweeps K4's grid (blocks per edge x tiles per block of the "mma" path; the
TPU's lane tile has no meaning here) and times v2c, the full Gram as one
product (K4′d), against v0, and prints their agreement.

v3 and v2c run K4's tensor-core kernel with K4's rows, staging, sums and
one-wave grid; only the n8 tiles of a k step differ: 4 for v3, 8 for v2c
(every entry its own product), 6 for v0 (the upper tiles, 2 mirrored). So
v3 − v0 is what a Gram of the diagonal blocks alone would save the solver,
and v2c − v0 what v0's symmetric tiles save. ``--grids`` times v2, v2f, v3
and v2c on the grids of a sweep around their own production grid and on
the grid the first designs' planner gives (``ba_kernels.grid_shape``).

Inputs are drawn as the JAX script draws them, from
``numpy.random.default_rng(0)`` in the same order: the 8 channels
|0.3·N(0,1) + 1| in bf16, 110 poses ``exp(0.02·N(0,1))``, the edges' first
keyframes and ``jj = (ii + 1) % 110``. Kernel times are CUDA events around
a run of launches after a warm-up. It runs on the card unless the caller
passes ``device="cpu"`` (the plain versions; every time is then labelled
``cpu``); without a card the default raises.
"""

from __future__ import annotations

import argparse
import math
import statistics
import time

import numpy as np
import torch

from mast3r_slam_tpu_torch.ops import ba_kernels as BA
from mast3r_slam_tpu_torch.ops import gram_variants as GV
from mast3r_slam_tpu_torch.ops import lie
from mast3r_slam_tpu_torch.slam import factor_graph as FG

EDGES, PIXELS = 128, 98_304
N_POSES = 110
SIGMA_RAY, SIGMA_DIST = 0.0003, 0.1


def make_inputs(E, N, device="cpu"):
    """``(rts (E, 13) float32, 8 bf16 channels (E, N))`` on ``device``."""
    rng = np.random.default_rng(0)
    meas = [torch.from_numpy(np.abs(
        rng.normal(size=(E, N)).astype(np.float32) * 0.3 + 1.0)).to(
            device=device, dtype=torch.bfloat16) for _ in range(8)]
    T = lie.exp(torch.from_numpy(
        rng.normal(size=(N_POSES, 7)).astype(np.float32) * 0.02))
    ii = torch.from_numpy(rng.integers(0, N_POSES, E).astype(np.int32))
    jj = (ii + 1) % N_POSES
    _, rts = FG._rel_pose_rows(T, ii, jj, torch.ones(E))
    return rts.to(device).contiguous(), meas


def time_ms(fn, device, reps=20, warmup=3):
    """ms per call: on the card, CUDA events around ``reps`` launches
    after ``warmup``; on the CPU, the median host time of ``reps`` calls."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / reps
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def diag_blocks(G):
    """The sum of a 32x32 Gram's four diagonal 8x8 blocks."""
    return sum(G[:, d * 8:d * 8 + 8, d * 8:d * 8 + 8] for d in range(4))


def agreement(got, want):
    """Max abs difference, max |want| and ``ba_kernels.gram_error``."""
    return dict(max_abs=(got - want).abs().max().item(),
                scale=want.abs().max().item(),
                gram_error=BA.gram_error(got.cpu(), want.cpu()))


def sweep_grids(prod, N, tile=BA.THREADS):
    """The grids of a sweep around the production grid ``prod`` of a
    one-wave kernel: 1, 2, half, 1x, 2x and 4x its blocks per edge, each
    walking contiguous runs of ``tile``-pixel tiles."""
    n_tiles = math.ceil(N / tile)
    grids = []
    for bpe in sorted({1, 2, max(1, prod[0] // 2), prod[0], 2 * prod[0],
                       4 * prod[0]}):
        bpe = min(bpe, n_tiles)
        grid = (math.ceil(n_tiles / math.ceil(n_tiles / bpe)),
                math.ceil(n_tiles / bpe))
        if grid not in grids:
            grids.append(grid)
    return grids


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the Gram microbenchmark runs on a CUDA card (or "
                           "on the CPU when the caller passes device='cpu')")
    return device


def main(argv=None, device="cuda"):
    """Run the benchmark; returns its times (ms) and agreements."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--r2", action="store_true",
                    help="sweep K4's grid, then time v2c against v0")
    ap.add_argument("--grids", action="store_true",
                    help="time v2, v2f, v3 and v2c on the grids of a sweep "
                    "around their production grid and on the first "
                    "designs' planner's (ba_kernels.grid_shape)")
    ap.add_argument("--edges", type=int, default=EDGES)
    ap.add_argument("--pixels", type=int, default=PIXELS)
    args = ap.parse_args(argv)
    dev = _device(device)
    E, N = args.edges, args.pixels
    rts, meas = make_inputs(E, N, dev)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    unit = "ms" if dev.type == "cuda" else "ms (cpu)"
    print(f"Gram microbenchmark on {name}: E = {E}, N = {N}, bf16 channels, "
          f"sigma_ray {SIGMA_RAY}, sigma_dist {SIGMA_DIST}", flush=True)
    sig = (SIGMA_RAY, SIGMA_DIST)
    bf16 = torch.bfloat16

    def timed(label, fn):
        t = time_ms(fn, dev)
        print(f"{label:28s}: {t:8.3f} {unit}", flush=True)
        return t

    out = dict(device=name, ms={})
    if args.grids:
        if dev.type != "cuda":
            raise RuntimeError("--grids times the card's grids only")
        sm = torch.cuda.get_device_properties(dev).multi_processor_count
        out["grids"] = {}
        vp = GV.vec_pixels(1, True)
        tile = GV.tile_pixels("rows", N, vp)
        for label, fn, kind in (("v2", GV.gram_rows, 1),
                                ("v2f", GV.gram_rows_fast, 4),
                                ("v3", GV.gram_diag, 2),
                                ("v2c", GV.gram_one_product, 3)):
            if kind in (1, 4):
                prod = GV.grid_rows(E, N, sm, GV.rows_blocks_per_sm(
                    dev, kind, True, N % vp == 0), vp)
                first, t, kw = BA.grid_shape(E, N, sm, tile), tile, {}
            else:
                prod = BA.grid_mma(E, N, sm,
                                   BA.mma_blocks_per_sm(dev, kind, True))
                first, t = BA.grid_shape(E, N, sm), BA.THREADS
                kw = dict(compute_dtype=bf16)
            grids = sweep_grids(prod, N, t)
            for grid in grids + ([first] if first not in grids else []):
                tag = (" (production)" if grid == prod else
                       " (grid_shape)" if grid == first else "")
                out["grids"][label, grid] = timed(
                    f"{label} grid {grid[0]}x{grid[1]}{tag}",
                    lambda g=grid, f=fn, kw=kw: f(rts, meas, *sig, grid=g,
                                                  **kw))
        return out
    if not args.r2:
        out["ms"]["v1"] = timed("v1 load floor", lambda: GV.gram_load(
            rts, meas))
        out["ms"]["v2"] = timed("v2 rows", lambda: GV.gram_rows(
            rts, meas, *sig))
        if dev.type == "cuda":
            out["ms"]["v2 first"] = timed(
                "v2 first (first kernel)",
                lambda: GV.gram_rows_first(rts, meas, *sig))
        else:
            print("v2 first: the card's only (no kernel on the CPU)",
                  flush=True)
        out["ms"]["v2f"] = timed("v2f rows (mma arithmetic)",
                                 lambda: GV.gram_rows_fast(rts, meas, *sig))
        out["ms"]["v3"] = timed("v3 diag 4x8x8", lambda: GV.gram_diag(
            rts, meas, *sig, compute_dtype=bf16))
        out["ms"]["v0f"] = timed("v0f full 32x32 (fma)", lambda: BA.gram_rays(
            rts, meas, *sig, compute_dtype=bf16, path="fma"))
        out["ms"]["v0"] = timed("v0 full 32x32 (mma)", lambda: BA.gram_rays(
            rts, meas, *sig, compute_dtype=bf16))
        H0 = diag_blocks(BA.gram_rays(rts, meas, *sig, compute_dtype=bf16))
        H3 = GV.gram_diag(rts, meas, *sig, compute_dtype=bf16)
        out["v3_vs_v0"] = a = agreement(H3, H0)
        print(f"max |diag-block diff| v3 vs v0: {a['max_abs']:.6e}  scale: "
              f"{a['scale']:.6e}  gram_error: {a['gram_error']:.3e}",
              flush=True)
        return out

    if dev.type == "cuda":
        sm = torch.cuda.get_device_properties(dev).multi_processor_count
        prod = BA.grid_mma(E, N, sm, BA.mma_blocks_per_sm(dev, 0, True))
        out["grid"] = {}
        for grid in sweep_grids(prod, N):
            label = f"v0 grid {grid[0]}x{grid[1]}"
            out["grid"][grid] = timed(
                label + (" (production)" if grid == prod else ""),
                lambda g=grid: BA.gram_rays(rts, meas, *sig,
                                            compute_dtype=bf16, grid=g))
    else:
        print("v0 grid sweep: the card's only (no grid on the CPU)",
              flush=True)
    out["ms"]["v2c"] = timed("v2c one product", lambda: GV.gram_one_product(
        rts, meas, *sig, compute_dtype=bf16))
    out["ms"]["v0"] = timed("v0 full 32x32 (mma)", lambda: BA.gram_rays(
        rts, meas, *sig, compute_dtype=bf16))
    G0 = BA.gram_rays(rts, meas, *sig, compute_dtype=bf16)
    G2 = GV.gram_one_product(rts, meas, *sig, compute_dtype=bf16)
    out["v2c_vs_v0"] = a = agreement(G2, G0)
    print(f"max |G diff| v2c vs v0: {a['max_abs']:.6e}  scale: "
          f"{a['scale']:.6e}  gram_error: {a['gram_error']:.3e}", flush=True)
    return out


if __name__ == "__main__":
    main()
