"""The non-Gram parts of one BA LM iteration, each alone, per rep.

    python -m mast3r_slam_tpu_torch.bench.ba_solve_microbench [--device cuda]

Counterpart of ``scripts/ba_solve_microbench.py``, at its size (a
110-pose buffer, E = 128 edges) and with its inputs, drawn from
``numpy.random.default_rng(0)`` in its order (:func:`make_inputs`):
per-edge blocks ``He = A Aᵀ`` and gradients ``ge``, each edge's first
keyframe and ``jj = (ii + 1) % 110``, every pose free but the first; then
a 770² matrix ``10 I + 0.01 N`` (symmetrised) and its right-hand side,
110 poses ``exp(0.02 N)`` and their steps ``1e-3 N``. The pieces:

  scatter assembly   ``factor_graph._scatter_blocks`` into the dense
                     (111, 7, 111, 7) system (``index_put_`` with
                     accumulate),
  incidence matmul   the script's other assembly, ``H = Pᵀ·Hs·P`` with
                     ``P`` the signed one-hot edge incidence (this module's
                     own copy; the solve does not use it),
  _solve_system      ``factor_graph._solve_system`` on that system + 10 I
                     (damping 1e-4),
  cholesky 770       ``torch.linalg.cholesky_ex`` alone (``cholesky``
                     reads ``info`` on the host),
  chol + cho_solve   ``cholesky_ex`` + ``torch.cholesky_solve``,
  lie.retr           the retraction of 110 poses;

and the two assemblies' agreement after symmetrisation (max |H diff|,
max |g diff|) and the solve's residual on the system it solves.

Timing is the card's counterpart of the script's K-rep in-program scan:
K = 32 reps of a piece, each with its input perturbed (1e-6 r, 1e-9 r for
the factorisations), captured in one CUDA graph, and 1 rep in another;
per rep = (t(K) - t(1)) / (K - 1), each t the median of 8 replays timed by
CUDA events. A piece that does not capture is timed eagerly, K launches
between two events, and its entry says ``"eager"``. It prints the
script's lines, then one JSON line with the card's ``nvidia-smi`` name and
power limit. It runs on the card; ``--device cpu`` (or ``main(argv,
device="cpu")``) runs the K reps eagerly on the CPU, timed by the host
clock, for the tests (every time labelled cpu). There is no fallback from
the card to the CPU. ``--cap``, ``--edges``, ``--k`` and ``--reps`` only
shrink the run for the tests.
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

CAP, EDGES = 110, 128
K_REPS = 32
REPS = 8
DAMPING = 1e-4
PIECES = ("scatter assembly", "incidence matmul", "_solve_system",
          "cholesky 770", "chol + cho_solve", "lie.retr")


def make_inputs(cap=CAP, edges=EDGES, seed=0):
    """The script's draws, in its order, as numpy arrays: ``He_raw (E, 7,
    7)`` (``He = He_raw He_rawᵀ``), ``ge (E, 7)``, ``ii, jj (E,)`` int32,
    ``free (cap,)``, ``Hd_noise (7 cap, 7 cap)``, ``gd (7 cap,)``, ``xi
    (cap, 7)`` (the poses' tangents) and ``dx (cap, 7)``."""
    rng = np.random.default_rng(seed)
    He_raw = rng.normal(size=(edges, 7, 7)).astype(np.float32)
    ge = rng.normal(size=(edges, 7)).astype(np.float32)
    ii = rng.integers(0, cap, edges).astype(np.int32)
    jj = (ii + 1) % cap
    free = np.arange(cap) > 0
    n = cap * 7
    Hd_noise = rng.normal(size=(n, n)).astype(np.float32)
    gd = rng.normal(size=(n,)).astype(np.float32)
    xi = rng.normal(size=(cap, 7)).astype(np.float32) * 0.02
    dx = rng.normal(size=(cap, 7)).astype(np.float32) * 1e-3
    return dict(He_raw=He_raw, ge=ge, ii=ii, jj=jj, free=free,
                Hd_noise=Hd_noise, gd=gd, xi=xi, dx=dx, cap=cap)


def to_device(arrs, device):
    """The inputs as tensors on ``device``: ``He`` (formed there, as the
    script forms it on its device), the 770² matrix ``Hd``, the poses."""
    from mast3r_slam_tpu_torch.ops import lie

    t = {k: torch.from_numpy(np.ascontiguousarray(arrs[k])).to(device)
         for k in ("He_raw", "ge", "free", "Hd_noise", "gd", "dx")}
    t["ii"] = torch.from_numpy(arrs["ii"].astype(np.int64)).to(device)
    t["jj"] = torch.from_numpy(arrs["jj"].astype(np.int64)).to(device)
    t["He"] = t["He_raw"] @ t["He_raw"].transpose(-1, -2)
    n = arrs["cap"] * 7
    Hd = (torch.eye(n, device=device) * 10.0 + 0.01 * t["Hd_noise"])
    t["Hd"] = 0.5 * (Hd + Hd.T)
    t["T"] = lie.exp(torch.from_numpy(arrs["xi"])).to(device)
    t["cap"] = arrs["cap"]
    return t


def scatter_assembly(He, ge, ii, jj, free, cap):
    """The dense system by ``factor_graph._scatter_blocks``."""
    from mast3r_slam_tpu_torch.slam import factor_graph as FG

    H = He.new_zeros(cap + 1, 7, cap + 1, 7)
    g = He.new_zeros(cap + 1, 7)
    return FG._scatter_blocks(H, g, He, ge, ii, jj, free, cap)


def incidence_assembly(He, ge, ii, jj, free, cap):
    """The script's incidence-matmul assembly: ``H[a, f, b, g] = Σ_e P[e,
    a] Hs[e, f, g] P[e, b]`` and ``g = Pᵀ ge``, ``P`` the signed one-hot
    of each edge's slots (a fixed pose's slot is ``cap``) and ``Hs`` the
    symmetrised blocks."""
    trash = torch.full_like(ii, cap)
    slot_i = torch.where(free[ii], ii, trash)
    slot_j = torch.where(free[jj], jj, trash)
    P = (torch.nn.functional.one_hot(slot_i, cap + 1).to(He.dtype)
         - torch.nn.functional.one_hot(slot_j, cap + 1).to(He.dtype))
    Hs = 0.5 * (He + He.transpose(-1, -2))
    Kk = Hs[:, :, None, :] * P[:, None, :, None]
    H = torch.einsum("ea,efbg->afbg", P, Kk)
    return H, P.T @ ge


def symmetrised(H):
    """``(H + Hᵀ) / 2`` of a dense ``(cap+1, 7, cap+1, 7)`` system as a
    square matrix (what ``_solve_system`` factors)."""
    n = H.shape[0] * H.shape[1]
    Hm = H.reshape(n, n)
    return 0.5 * (Hm + Hm.T)


def pd_system(H):
    """The assembled system made solidly positive definite: + 10 I on the
    block diagonal (the script's ``eye_blocks``)."""
    c = H.shape[0]
    eye = torch.einsum("ab,fg->afbg", torch.eye(c, device=H.device),
                       torch.eye(7, device=H.device))
    return H + 10.0 * eye


def solved_system(H, free, cap, damping=DAMPING):
    """The matrix ``_solve_system`` factors for ``H`` (masked to the free
    poses, symmetrised, damped; identity rows for fixed poses), float64."""
    n = cap * 7
    Hd = H[:cap, :, :cap, :].reshape(n, n).double()
    diag_free = free[:cap].repeat_interleave(7)
    Hd = torch.where(diag_free[:, None] & diag_free[None, :], Hd,
                     torch.zeros_like(Hd))
    Hd = 0.5 * (Hd + Hd.T)
    diag = torch.diagonal(Hd).float()
    add = torch.where(diag_free, torch.tensor(damping, dtype=torch.float32,
                                              device=H.device)
                      * diag.clamp_min(1e-6), torch.ones_like(diag))
    return Hd + torch.diag(add.double())


def pieces(t):
    """``{name: step(r) -> 0-dim tensor}``: one rep of each piece on its
    input perturbed by ``r``."""
    from mast3r_slam_tpu_torch.ops import lie
    from mast3r_slam_tpu_torch.slam import factor_graph as FG

    cap = t["cap"]
    edge = (t["ii"], t["jj"], t["free"], cap)
    Hs, gs = scatter_assembly(t["He"], t["ge"], *edge)
    Hpd = pd_system(Hs)
    t.update(H_assembled=Hs, g_assembled=gs, H_pd=Hpd)

    def scatter(r):
        H, g = scatter_assembly(t["He"] + r * 1e-6, t["ge"], *edge)
        return H[0, 0, 0, 0] + g[0, 0]

    def incidence(r):
        H, g = incidence_assembly(t["He"] + r * 1e-6, t["ge"], *edge)
        return H[0, 0, 0, 0] + g[0, 0]

    def solve(r):
        dx, ok = FG._solve_system(Hpd + r * 1e-9, gs, t["free"], cap,
                                  DAMPING)
        return dx[0, 0] + ok.float()

    def chol(r):
        L, _ = torch.linalg.cholesky_ex(t["Hd"] + r * 1e-9)
        return L[0, 0]

    def chosolve(r):
        L, _ = torch.linalg.cholesky_ex(t["Hd"] + r * 1e-9)
        return torch.cholesky_solve(t["gd"][:, None], L)[0, 0]

    def retr(r):
        return lie.retr(t["T"], t["dx"] * (1.0 + r * 1e-6))[0, 0]

    return dict(zip(PIECES, (scatter, incidence, solve, chol, chosolve,
                             retr)))


def reps_fn(step, n):
    """``n`` reps of ``step``, their outputs summed (a carry keeps each
    rep's result)."""
    def run():
        carry = step(0.0)
        for r in range(1, n):
            carry = carry + step(float(r))
        return carry
    return run


def per_rep(t_k, t_1, k=K_REPS):
    """The script's amortised per-rep time: ``(t(K) - t(1)) / (K - 1)``."""
    return (t_k - t_1) / (k - 1)


def _median_ms(fn, reps, device):
    """Median ms of ``reps`` calls of ``fn`` after one warm call
    (``frame_profile.call_ms``)."""
    from mast3r_slam_tpu_torch.bench.frame_profile import call_ms

    fn()
    return statistics.median(call_ms(fn, device)[1] for _ in range(reps))


def _captured(run, device):
    """``run`` captured as a CUDA graph (after an eager warm-up on a side
    stream); returns its replay, or raises what the capture raised."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = run()
    torch.cuda.synchronize(device)
    return graph.replay, out


def time_piece(step, k, reps, device):
    """``(per-rep ms, t(K) ms, t(1) ms, "graph" | "eager" | "cpu", why)``
    of a piece (see the module docstring)."""
    runs = [reps_fn(step, n) for n in (k, 1)]
    how, why = ("cpu", None) if device.type != "cuda" else ("graph", None)
    if how == "graph":
        try:
            replays = [_captured(run, device)[0] for run in runs]
        except RuntimeError as e:
            torch.cuda.synchronize(device)
            how, why = "eager", str(e).splitlines()[0][:200]
        else:
            runs = replays
    t_k, t_1 = (_median_ms(run, reps, device) for run in runs)
    return per_rep(t_k, t_1, k), t_k, t_1, how, why


def agreement(t):
    """The two assemblies after symmetrisation, and the solve's residual
    ``|| A dx - g ||`` on the system ``A`` it solves, in float64."""
    from mast3r_slam_tpu_torch.slam import factor_graph as FG

    cap = t["cap"]
    edge = (t["ii"], t["jj"], t["free"], cap)
    Hs, gs = t["H_assembled"], t["g_assembled"]
    Hm, gm = incidence_assembly(t["He"], t["ge"], *edge)
    a, b = symmetrised(Hs), symmetrised(Hm)
    dx, ok = FG._solve_system(t["H_pd"], gs, t["free"], cap, DAMPING)
    A = solved_system(t["H_pd"], t["free"], cap)
    diag_free = t["free"][:cap].repeat_interleave(7)
    g = torch.where(diag_free, gs[:cap].reshape(-1),
                    torch.zeros_like(gs[:cap].reshape(-1))).double()
    res = (A @ dx.reshape(-1).double() - g).norm()
    return dict(h_diff=(a - b).abs().max().item(),
                h_scale=a.abs().max().item(),
                g_diff=(gs - gm).abs().max().item(),
                solve_ok=bool(ok), solve_residual=res.item(),
                g_norm=g.norm().item())


def main(argv=None, device="cuda"):
    """Run the microbenchmark; returns its record (the JSON line)."""
    from mast3r_slam_tpu_torch.bench.frame_profile import device_label
    from mast3r_slam_tpu_torch.main import _check_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=device)
    ap.add_argument("--cap", type=int, default=CAP)
    ap.add_argument("--edges", type=int, default=EDGES)
    ap.add_argument("--k", type=int, default=K_REPS)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = _check_device(args.device)
    label = device_label(dev)
    unit = "ms/rep" if dev.type == "cuda" else "ms/rep (cpu)"
    t = to_device(make_inputs(args.cap, args.edges), dev)
    steps = pieces(t)
    print(f"BA solve microbenchmark on {label}: cap {args.cap}, E "
          f"{args.edges}, K = {args.k}, median of {args.reps}", flush=True)
    rec = dict(tool="ba_solve_microbench", cap=args.cap, edges=args.edges,
               k=args.k, reps=args.reps, ms={}, t_k_ms={}, t_1_ms={},
               timing={}, eager_why={})
    for name, step in steps.items():
        ms, t_k, t_1, how, why = time_piece(step, args.k, args.reps, dev)
        rec["ms"][name], rec["t_k_ms"][name], rec["t_1_ms"][name] = (
            ms, t_k, t_1)
        rec["timing"][name] = how
        if why:
            rec["eager_why"][name] = why
        note = f"  ({how}: {why})" if how == "eager" else ""
        print(f"{name:17s}: {ms:8.3f} {unit}{note}", flush=True)
    rec.update(agreement(t))
    print(f"max |H diff| (post-sym): {rec['h_diff']:.6e} (max |H| "
          f"{rec['h_scale']:.6e})", flush=True)
    print(f"max |g diff|: {rec['g_diff']:.6e}", flush=True)
    print(f"_solve_system residual: {rec['solve_residual']:.6e} (|g| "
          f"{rec['g_norm']:.6e}, ok {rec['solve_ok']})", flush=True)
    rec["device"] = label
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
