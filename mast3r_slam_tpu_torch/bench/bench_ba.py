"""The bundle adjustment's solve at deployment scale: ms per LM iteration.

    python -m mast3r_slam_tpu_torch.bench.bench_ba [--dtype bfloat16|float32]
        [--calib] [--pixel-step 1] [--trace DIR] [--device cuda]

Counterpart of ``scripts/bench_ba.py``. A keyframe ring of 110 poses (the
capacity of ``slam/frame.py::SharedKeyframes``) and 128 two-way edge rows
of 384x512 pixels (in the CLI, the ``_two_way_padded`` bucket of 33-64
edges), drawn from ``numpy.random.default_rng(0)`` with the JAX script's
draws in its order (:func:`make_ring`): smooth geometry with 1 cm noise,
confidences, poses ``exp(0.02 N(0, 1))`` through the port's ``lie.exp``,
each edge's first keyframe and ``jj = (ii + 1) % 110``, correspondences
within three image rows of the identity, 80% valid, Q in [0.5, 3].

It times ``precompute_meas_rays`` (C_thresh 0, Q_thresh 0.5; first call and
warm), then ``gauss_newton_rays`` (sigma 0.003 / 10, ``delta_thresh`` 0, so
every iteration runs) at 5 and 25 iterations from three pose variants each
(``lie.retr`` by 1e-4 (r + 1)), and takes the per-iteration time and the
"precompute + overhead" by the script's differencing, from the medians of
each setting's solves. It solves twice: graphed, as ``FactorGraph`` runs a
solve on a card (one CUDA graph a configuration, here one for 5 and one
for 25 iterations, reading the edge rows and channels where they lie in
fixed buffers, as ``FactorGraph._two_way_padded`` holds them; each
capture's cost is reported apart and only replays are timed), and eagerly.
Each solve is timed by CUDA events around it from a synced card. Both
raw medians are printed beside their difference, so a bad difference
shows.

``--dtype`` takes base.yaml's bf16 Gram rows (``"mma"``) or the
evaluation configs' float32 rows (``"tf32"``); the channels stay float32,
as the script's. ``--calib`` runs ``precompute_meas_calib`` (on the
ray-constrained pointmaps, as ``FactorGraph``) and ``gauss_newton_calib``
(K5) with the ring's own intrinsics (f 300, c (256, 192)) and base.yaml's
calibrated settings. ``--pixel-step 2`` is base.yaml's decimation (the
script's is 1). ``--trace DIR`` also writes a ``torch.profiler`` Chrome
trace (with Python stacks) of one graphed 10-iteration solve after its
capture, for ``bench/trace_breakdown.py`` (the JAX script's ``--trace``
traces instead of timing). The TPU kernel's sublane-split layout has no
counterpart.

It prints the script's lines, then one JSON line: the times, each
solve's iterations and K4 / K5 launches by path, whether the graphed and
eager poses are equal bit for bit, the peak of
``torch.cuda.max_memory_allocated``, the solve graphs' pool bytes and the
bytes of the edge-row buffers they read, and the card's ``nvidia-smi``
name and power limit. It runs on the card; ``--device cpu`` (or
``main(argv, device="cpu")``) runs the plain versions eagerly, for the
tests (every time labelled cpu; no graph). There is no fallback from the
card to the CPU. ``--cap``, ``--edges``, ``--hw`` and ``--reps`` only
shrink the run for the tests.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np
import torch

CAP, EDGES, HW = 110, 128, (384, 512)
FOCAL = 300.0
LO, HI = 5, 25                  # the two iteration counts differenced
REPS = 3                        # pose variants a setting
TRACE_ITERS = 10
SIGMA_RAY, SIGMA_DIST = 0.003, 10.0
C_THRESH, Q_THRESH = 0.0, 0.5
# base.yaml's calibrated local_opt settings
PIXEL_BORDER, Z_EPS, SIGMA_PIXEL, SIGMA_DEPTH = -10.0, 1e-6, 1.0, 10.0


def make_ring(cap=CAP, edges=EDGES, hw=HW, seed=0):
    """The JAX script's keyframe ring as numpy arrays, drawn in its order:
    ``X (cap, N, 3)``, ``Cavg (cap, N, 1)``, ``xi (cap, 7)`` (the poses'
    tangents), ``ii, jj (edges,)`` int32, ``idx (edges, N)`` int32,
    ``valid (edges, N, 1)`` bool, ``Q (edges, N, 1)``, ``mask (edges,)``
    and ``free (cap,)`` (all but pose 0). At the defaults every array is
    the script's bit for bit; the centre is the image's (256, 192 there)."""
    H, W = hw
    n_pix = H * W
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    z = 2.0 + 0.3 * np.sin(u / 23.0) + 0.2 * np.cos(v / 17.0)
    X0 = np.stack([(u - W // 2) / FOCAL * z, (v - H // 2) / FOCAL * z, z],
                  -1)
    X = (X0.reshape(1, n_pix, 3)
         + 0.01 * rng.normal(size=(cap, n_pix, 3)).astype(np.float32))
    Cavg = rng.uniform(0.2, 1.0, (cap, n_pix, 1)).astype(np.float32)
    xi = rng.normal(size=(cap, 7)).astype(np.float32) * 0.02
    ii = rng.integers(0, cap, edges).astype(np.int32)
    jj = (ii + 1) % cap
    base = np.arange(n_pix, dtype=np.int32)
    idx = np.clip(base[None] + rng.integers(-3 * W, 3 * W, (edges, n_pix)),
                  0, n_pix - 1).astype(np.int32)
    valid = rng.random((edges, n_pix, 1)) < 0.8
    Q = rng.uniform(0.5, 3.0, (edges, n_pix, 1)).astype(np.float32)
    mask = np.ones(edges, np.float32)
    free = np.ones(cap, bool)
    free[0] = False
    return dict(X=X, Cavg=Cavg, xi=xi, ii=ii, jj=jj, idx=idx, valid=valid,
                Q=Q, mask=mask, free=free, hw=tuple(hw))


def intrinsics(hw=HW):
    """The ring's camera: f 300 at the image centre."""
    H, W = hw
    return torch.tensor([[FOCAL, 0.0, W // 2], [0.0, FOCAL, H // 2],
                         [0.0, 0.0, 1.0]], dtype=torch.float32)


def ring_poses(xi, reps=REPS):
    """The ring's poses ``lie.exp(xi)`` and the script's ``reps`` pose
    variants ``lie.retr(T, 1e-4 (r + 1))``, on the CPU."""
    from mast3r_slam_tpu_torch.ops import lie

    T = lie.exp(torch.from_numpy(xi))
    variants = [lie.retr(T, torch.full((T.shape[0], 7), 1e-4 * (r + 1)))
                for r in range(reps)]
    return T, variants


def difference(ms_lo, ms_hi, lo=LO, hi=HI):
    """The script's differencing: ``(per-iteration ms, precompute +
    overhead ms)`` from the solve times at ``lo`` and ``hi`` iterations."""
    per_iter = (ms_hi - ms_lo) / (hi - lo)
    return per_iter, ms_lo - lo * per_iter


def _counters():
    from mast3r_slam_tpu_torch.ops import ba_kernels as BA

    return {"K4": BA.rays_counter, "K5": BA.calib_counter,
            **BA.path_counters}


def _launches():
    return {k: c.launches for k, c in _counters().items()}


def _reset():
    for c in _counters().values():
        c.launches = 0


def host_ms(fn, device):
    """``(fn(), host ms)`` from a synced device to a synced device (a
    first call: builds, captures)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def to_device(ring, device):
    """The ring's arrays as tensors on ``device``, the edge rows and the
    free-pose mask in buffers as ``FactorGraph`` keeps them (long edge
    rows, float32 mask)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(ring[k])).to(device)
         for k in ("X", "Cavg", "idx", "valid", "Q")}
    edges = torch.from_numpy(np.stack([ring["ii"], ring["jj"]]).astype(
        np.int64)).to(device)
    t.update(edges=edges, ii=edges[0], jj=edges[1],
             mask=torch.from_numpy(ring["mask"]).to(device),
             free=torch.from_numpy(ring["free"]).to(device))
    return t


def premeas(t, calib, pixel_step, hw):
    """The measured channels of every edge (float32)."""
    from mast3r_slam_tpu_torch.ops import geometry
    from mast3r_slam_tpu_torch.slam import factor_graph as FG

    if not calib:
        return FG.precompute_meas_rays(
            t["X"], t["Cavg"], t["ii"], t["jj"], t["idx"], t["valid"],
            t["Q"], C_THRESH, Q_THRESH, pixel_step=pixel_step)
    K = intrinsics(hw).to(t["X"].device)
    Xc = geometry.constrain_points_to_ray(hw, t["X"], K)
    return FG.precompute_meas_calib(
        Xc, t["Cavg"], t["ii"], t["jj"], t["idx"], t["valid"], t["Q"],
        hw[1], Z_EPS, C_THRESH, Q_THRESH, pixel_step=pixel_step)


def solver(t, meas, calib, dtype, hw):
    """``solve(T, max_iter, graphs) -> (T, iterations)`` over the ring's
    buffers (the same tensors on every call, as a graph reads them)."""
    from mast3r_slam_tpu_torch.slam import factor_graph as FG

    K = intrinsics(hw).to(t["X"].device)

    def solve(T, max_iter, graphs=None):
        if calib:
            return FG.gauss_newton_calib(
                T, meas, K, t["ii"], t["jj"], t["mask"], t["free"], hw,
                PIXEL_BORDER, Z_EPS, SIGMA_PIXEL, SIGMA_DEPTH, max_iter, 0.0,
                compute_dtype=dtype, graphs=graphs)
        return FG.gauss_newton_rays(
            T, meas, t["ii"], t["jj"], t["mask"], t["free"], SIGMA_RAY,
            SIGMA_DIST, max_iter, 0.0, compute_dtype=dtype, graphs=graphs)

    return solve


def _nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def run_solves(solve, T, variants, graphs, dev, iters=(LO, HI)):
    """For each iteration count: the first call from ``T`` (with
    ``graphs``, the capture), then one timed solve a variant (``call_ms``).
    Returns ``{max_iter: dict(first_ms, ms [...], median_ms, iterations
    [...], launches [...], poses [...])}``."""
    from mast3r_slam_tpu_torch.bench.frame_profile import call_ms

    out = {}
    for n in iters:
        (T0, _), first = host_ms(lambda: solve(T.to(dev), n, graphs), dev)
        rec = dict(first_ms=first, ms=[], iterations=[], launches=[],
                   poses=[T0])
        for Tv in variants:
            Tv = Tv.to(dev)
            _reset()
            (Tn, it), ms = call_ms(lambda: solve(Tv, n, graphs), dev)
            rec["iterations"].append(int(it))
            rec["launches"].append(_launches())
            rec["ms"].append(ms)
            rec["poses"].append(Tn)
        rec["median_ms"] = statistics.median(rec["ms"])
        out[n] = rec
    return out


def _summary(runs, lo=LO, hi=HI):
    per_iter, pre = difference(runs[lo]["median_ms"], runs[hi]["median_ms"],
                               lo, hi)
    return dict(
        first_ms={str(n): r["first_ms"] for n, r in runs.items()},
        ms={str(n): r["ms"] for n, r in runs.items()},
        median_ms={str(n): r["median_ms"] for n, r in runs.items()},
        per_iter_ms=per_iter, pre_ms=pre,
        iterations={str(n): r["iterations"] for n, r in runs.items()},
        launches={str(n): r["launches"] for n, r in runs.items()},
        checksums={str(n): float(sum(p.double().sum() for p in r["poses"]))
                   for n, r in runs.items()})


def trace_solve(solve, T, graphs, trace_dir, device):
    """A ``torch.profiler`` Chrome trace (CPU and CUDA activity, Python
    stacks) of one graphed ``TRACE_ITERS``-iteration solve from ``T``,
    after its capture; returns the trace's path."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    # CUPTI set up before the capture: a graph instantiated before it
    # reports only the first step of its conditional loops
    with profile(activities=acts):
        torch.cuda.synchronize(device)
    solve(T.to(device), TRACE_ITERS, graphs)        # the capture
    torch.cuda.synchronize(device)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "bench_ba_trace.json")
    with profile(activities=acts, with_stack=True) as prof:
        solve(T.to(device), TRACE_ITERS, graphs)
        torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    return path


def bench(ring, device, dtype="bfloat16", calib=False, pixel_step=1,
          trace_dir=None, reps=REPS, emit=print):
    """Time the ring's premeas and solves on ``device`` (see the module
    docstring); returns the JSON line's record. ``ring``: :func:`make_ring`'s
    arrays."""
    from mast3r_slam_tpu_torch.bench.frame_profile import device_label
    from mast3r_slam_tpu_torch.ops.graphs import GraphCache

    cuda = device.type == "cuda"
    hw = ring["hw"]
    unit = "ms" if cuda else "ms (cpu)"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = to_device(ring, device)
    T, variants = ring_poses(ring["xi"], reps)
    kind = "calib" if calib else "rays"
    emit(f"bench_ba ({kind}, {dtype} rows) on {device_label(device)}: cap "
         f"{T.shape[0]}, {t['ii'].shape[0]} two-way edge rows x "
         f"{hw[0] * hw[1]} pixels, pixel_step {pixel_step}")
    meas, first = host_ms(lambda: premeas(t, calib, pixel_step, hw), device)
    emit(f"premeas first call: {first / 1e3:.2f}s")
    meas, warm = host_ms(lambda: premeas(t, calib, pixel_step, hw), device)
    emit(f"premeas (warm): {warm:.1f} {unit}")
    meas = tuple(ch.contiguous() for ch in meas)
    solve = solver(t, meas, calib, dtype, hw)
    graphs = GraphCache("solve") if cuda else None
    rec = dict(tool="bench_ba", kind=kind, dtype=dtype, cap=int(T.shape[0]),
               edges=int(t["ii"].shape[0]), pixels=hw[0] * hw[1],
               pixel_step=pixel_step, iters=[LO, HI], reps=reps,
               premeas_first_ms=first, premeas_ms=warm)
    paths = {}
    for mode, g in (("graphed", graphs), ("eager", None)):
        if mode == "graphed" and not cuda:
            rec[mode] = None
            emit("graphed: the card's only (no CUDA graph on the CPU)")
            continue
        runs = run_solves(solve, T, variants, g, device)
        paths[mode] = runs
        s = rec[mode] = _summary(runs)
        emit(f"[{mode}] solve({LO} iters): {s['median_ms'][str(LO)]:.1f} "
             f"{unit}   solve({HI} iters): {s['median_ms'][str(HI)]:.1f} "
             f"{unit}   (first calls {s['first_ms'][str(LO)]:.1f} / "
             f"{s['first_ms'][str(HI)]:.1f})")
        emit(f"[{mode}] per-GN-iteration: {s['per_iter_ms']:.2f} {unit}   "
             f"precompute+overhead: {s['pre_ms']:.2f} {unit}")
        emit(f"[{mode}] (checksums {s['checksums'][str(LO)]:.6e} "
             f"{s['checksums'][str(HI)]:.6e})")
    poses = [p for runs in paths.values() for r in runs.values()
             for p in r["poses"]]
    rec["finite"] = bool(all(torch.isfinite(p).all() for p in poses))
    if "graphed" in paths:
        rec["same_bits"] = all(
            torch.equal(a, b) for n in (LO, HI)
            for a, b in zip(paths["graphed"][n]["poses"],
                            paths["eager"][n]["poses"]))
        rec["pool_bytes"] = sum(graphs.pool_bytes().values())
    else:
        rec["same_bits"] = rec["pool_bytes"] = None
    rec["buffer_bytes"] = _nbytes(t["edges"], t["mask"], t["free"], *meas)
    rec["meas_bytes"] = _nbytes(*meas)
    rec["trace"] = None
    if trace_dir is not None:
        if not cuda:
            raise ValueError("--trace profiles the card's graphed solve")
        rec["trace"] = trace_solve(solve, T, graphs, trace_dir, device)
        emit(f"trace -> {rec['trace']}")
    rec["peak_bytes"] = (torch.cuda.max_memory_allocated(device) if cuda
                         else None)
    rec["device"] = device_label(device)
    emit(f"memory: peak allocated {_gib(rec['peak_bytes'])} GiB, solve "
         f"graphs' pools {_gib(rec['pool_bytes'])} GiB, edge-row buffers "
         f"{_gib(rec['buffer_bytes'])} GiB (channels "
         f"{_gib(rec['meas_bytes'])})")
    return rec


def _gib(n):
    return "n/a" if n is None else f"{n / 2**30:.3f}"


def _ints(text):
    return tuple(int(v) for v in text.replace(",", " ").split())


def main(argv=None, device="cuda"):
    """Run the benchmark; returns its record (the JSON line)."""
    from mast3r_slam_tpu_torch.main import _check_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="Gram row type: bfloat16 (mma) or float32 (tf32)")
    ap.add_argument("--calib", action="store_true",
                    help="the calibrated premeas and solve (K5)")
    ap.add_argument("--pixel-step", type=int, default=1)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="also write a Chrome trace of one graphed "
                    f"{TRACE_ITERS}-iteration solve into DIR")
    ap.add_argument("--device", default=device)
    ap.add_argument("--cap", type=int, default=CAP)
    ap.add_argument("--edges", type=int, default=EDGES)
    ap.add_argument("--hw", type=int, nargs=2, default=HW)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = _check_device(args.device)
    ring = make_ring(args.cap, args.edges, tuple(args.hw))
    rec = bench(ring, dev, args.dtype, args.calib, args.pixel_step,
                args.trace, args.reps, emit=lambda *a: print(*a, flush=True))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
