"""Backend factor graph and global Sim(3) Levenberg-Marquardt bundle
adjustment, on torch tensors.

Counterpart of ``mast3r_slam_tpu/slam/factor_graph.py``, in two phases:

1. **Measured-channel precompute** (:func:`precompute_meas_rays` /
   :func:`precompute_meas_calib`): everything that depends on the matches
   and the keyframe pointmaps but not on the poses — the scattered correspondence
   gather ``X[ii][e, idx]``, the confidence gates and the observer rows
   ``X[jj]`` — becomes flat ``(E, N)`` channels once per edge.
   :class:`FactorGraph` caches them across solves and refreshes an edge
   only when a touched keyframe's pointmap changed (``xc_version``).
2. **LM iterations**: each builds the per-edge Gram with K4 / K5
   (``ops/ba_kernels.py``: the kernel on the card, its plain version on the
   CPU — the port's one system build), maps the 7x7 blocks to the world
   frame, scatters them into a dense ``(7*cap, 7*cap)`` system, and takes a
   damped Cholesky step with accept / reject on the whitened-Huber cost.

Pose Jacobian convention: residuals are functions of ``X' = T_i^{-1} T_j X_j``;
the local point Jacobian ``[I | -skew(X') | X']`` maps to world-frame
perturbations of pose j through ``Adj(T_i^{-1})``, and ``J_i = -J_j``.

With a backend mesh (``parallel/``) the graph keeps its edge buffers and
channel cache on the first backend slot's device and places each solve as
the JAX package does: when the mesh size divides the padded bucket, each
slot builds the full-size system from its equal share of the two-way rows
(one K4 / K5 launch per slot and system build; a share of padding rows
builds an exactly zero system) and the systems are summed onto the first
slot in slot order (:func:`_mesh_system`, the JAX ``shard_map`` and
``psum``); otherwise the first backend slot solves alone. Solved poses go
back to the frontend device.

As in the JAX package, the LM loop exits on the device (``ops/device_loop.py``:
the JAX ``lax.while_loop``'s state and rules, updated in place, with the
steps after the exit masked), and the two-way edges are padded to a
power-of-two bucket (padded rows ``ii = jj = 0`` with zero channels and
``edge_mask`` 0, whose Gram is exactly zero). On a card,
:class:`FactorGraph` runs each solve as CUDA graphs, one set per bucket,
static configuration and mesh (``ops/graphs.py``, the counterpart of the
JAX ``jax.jit`` of :func:`gauss_newton_rays` / :func:`gauss_newton_calib`,
whose mesh is static). Without a mesh, or with every slot on one device,
the solve is one graph: the system builds (every slot's), the damped
solve, the retraction and the exit rules sit in one conditional WHILE
node, and the only host read of a solve is its iteration count,
afterwards (:attr:`FactorGraph.last_solve_iters`). A conditional node's
body holds the nodes of one device, so over distinct cards each slot's
system build is a graph on its card, the step's two halves are graphs on
the first slot, and the host reads the loop's exit once an iteration
(:func:`_lm_hosted`). Edges are never removed, so a kind holds one
bucket's buffers: the smaller bucket's, and the graphs that read them, go
when the edges outgrow it.

What differs from the JAX package: a Cholesky failure is read from
``cholesky_ex``'s ``info``; the cache is updated in place; over distinct
cards the LM loop's exit is read on the host. The XLA chunked scans have
no counterpart here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mast3r_slam_tpu_torch.ops import ba_kernels, device_loop, geometry, lie
from mast3r_slam_tpu_torch.ops.graphs import GraphCache
from mast3r_slam_tpu_torch.parallel import sharding as S

# ---------------------------------------------------------------------------
# Measured channels
# ---------------------------------------------------------------------------

def _decimate_queries(idx_ii2jj, valid_match, Q, pixel_step):
    """BA residual decimation: keep every ``pixel_step``-th query pixel of
    each edge (1 = every pixel, the reference)."""
    if pixel_step > 1:
        idx_ii2jj = idx_ii2jj[:, ::pixel_step]
        valid_match = valid_match[:, ::pixel_step]
        Q = Q[:, ::pixel_step]
    return idx_ii2jj, valid_match, Q


def _gather_edge(X, Cavg, ii, jj, idx_ii2jj, valid_match, pixel_step):
    """The gather side ``X[ii][e, idx]`` / its confidence and the
    observer rows ``X[jj]`` / their confidence of each edge."""
    safe_idx = torch.where(valid_match[..., 0], idx_ii2jj,
                           torch.zeros_like(idx_ii2jj)).long()
    rows = ii.long()[:, None]
    Xi = X[rows, safe_idx]                                  # (E, N, 3)
    Ci = Cavg[rows, safe_idx, 0]
    Cj = Cavg[jj.long()][:, ::pixel_step, 0]
    Xj = X[jj.long()][:, ::pixel_step]
    return safe_idx, Xi, Ci, Cj, Xj


def precompute_meas_rays(X, Cavg, ii, jj, idx_ii2jj, valid_match, Q,
                         C_thresh, Q_thresh, pixel_step=1):
    """Pose-invariant channels of the ray residual for every edge,
    ``(mx, my, mz, di, conf, xj, yj, zj)``, each ``(E, N)``: the unit
    measurement ray and its length, the gated confidence, and the observer
    points the iterations transform. (The JAX ``_premeas_rays``, run by an
    8-edge chunked scan that fed XLA's gather; here one batched gather.)"""
    idx_ii2jj, valid_match, Q = _decimate_queries(idx_ii2jj, valid_match, Q,
                                                  pixel_step)
    _, Xi, Ci, Cj, Xj = _gather_edge(X, Cavg, ii, jj, idx_ii2jj, valid_match,
                                     pixel_step)
    di = torch.linalg.norm(Xi, dim=-1)
    di_safe = di.clamp_min(1e-12)
    q = Q[..., 0]
    valid = (valid_match[..., 0] & (q > Q_thresh) & (Ci > C_thresh)
             & (Cj > C_thresh))
    conf = torch.where(valid, q, torch.zeros_like(q))
    return (Xi[..., 0] / di_safe, Xi[..., 1] / di_safe, Xi[..., 2] / di_safe,
            di, conf, Xj[..., 0], Xj[..., 1], Xj[..., 2])


def precompute_meas_calib(X, Cavg, ii, jj, idx_ii2jj, valid_match, Q, W_img,
                          z_eps, C_thresh, Q_thresh, pixel_step=1):
    """Pose-invariant channels of the calibrated residual for every edge
    (the JAX ``_premeas_calib``), ``(ui, vi, logzi, conf, xj, yj, zj)``,
    each ``(E, N)``. ``X`` must be
    the ray-constrained pointmap: the measured pixel of the constrained
    point is the grid position of the match index, so ``ui, vi`` come
    straight from ``idx``; only z of the measured side is read."""
    idx_ii2jj, valid_match, Q = _decimate_queries(idx_ii2jj, valid_match, Q,
                                                  pixel_step)
    safe_idx, Xi, Ci, Cj, Xj = _gather_edge(X, Cavg, ii, jj, idx_ii2jj,
                                            valid_match, pixel_step)
    zi = Xi[..., 2]
    valid_zi = zi > z_eps
    zi_safe = torch.where(valid_zi, zi, torch.ones_like(zi))
    fidx = safe_idx.to(zi.dtype)
    ui = torch.remainder(fidx, float(W_img))
    vi = torch.floor(fidx / float(W_img))
    q = Q[..., 0]
    valid = (valid_match[..., 0] & (q > Q_thresh) & (Ci > C_thresh)
             & (Cj > C_thresh) & valid_zi)
    conf = torch.where(valid, q, torch.zeros_like(q))
    logz = torch.where(valid_zi, torch.log(zi_safe), torch.zeros_like(zi))
    return (ui, vi, logz, conf, Xj[..., 0], Xj[..., 1], Xj[..., 2])


# ---------------------------------------------------------------------------
# System build and solve
# ---------------------------------------------------------------------------

def _rel_pose_rows(T, ii, jj, edge_mask, extra=()):
    """``(Ti, [s*R | t | mask | extra...] (E, 13+len(extra)))``."""
    Ti = T[ii.long()]
    Tij = lie.compose(lie.inv(Ti), T[jj.long()])
    sR = lie.quat_to_matrix(lie.quaternion(Tij)) * lie.scale(Tij)[..., None]
    cols = [sR.reshape(-1, 9), lie.translation(Tij),
            edge_mask.to(sR.dtype)[:, None]]
    if extra:
        row = torch.stack([torch.as_tensor(v, dtype=sR.dtype,
                                           device=sR.device)
                           for v in extra])
        cols.append(row[None].expand(ii.shape[0], len(extra)))
    return Ti, torch.cat(cols, dim=-1)


def _edge_blocks_from_gram(G, D, Ti):
    """Per-edge world-frame ``H (E, 7, 7)``, ``g (E, 7)`` and the total
    whitened-Huber cost (the Gram's (rho, rho) corners) from the Gram."""
    H_local = sum(G[:, d * 8:d * 8 + 7, d * 8:d * 8 + 7] for d in range(D))
    g_local = sum(G[:, d * 8:d * 8 + 7, d * 8 + 7] for d in range(D))
    cost = sum(G[:, d * 8 + 7, d * 8 + 7].sum() for d in range(D))
    adj_inv = lie.adjoint(lie.inv(Ti))
    H = adj_inv.transpose(1, 2) @ H_local @ adj_inv
    g = (adj_inv.transpose(1, 2) @ g_local[..., None])[..., 0]
    return H, g, cost


def _scatter_blocks(H, g, He, ge, ii, jj, free_mask, cap):
    """Add the per-edge blocks into the dense system ``H (cap+1, 7, cap+1,
    7)``, ``g (cap+1, 7)`` in place (slot ``cap`` takes fixed poses).

    With ``J_i = -J_j`` the blocks are (ii: +He, jj: +He, ij: -He,
    ji: -Heᵀ) and ``g_i = +ge``, ``g_j = -ge``. Repeated keyframe pairs
    accumulate (``index_put_`` with ``accumulate=True`` on the
    ``(cap+1, cap+1, 7, 7)`` view; plain advanced-index ``+=`` would keep
    only one of the duplicates)."""
    trash = torch.full_like(ii, cap)
    slot_i = torch.where(free_mask[ii], ii, trash)
    slot_j = torch.where(free_mask[jj], jj, trash)
    Hb = H.permute(0, 2, 1, 3)
    Hb.index_put_((slot_i, slot_i), He, accumulate=True)
    Hb.index_put_((slot_j, slot_j), He, accumulate=True)
    Hb.index_put_((slot_i, slot_j), -He, accumulate=True)
    Hb.index_put_((slot_j, slot_i), -He.transpose(1, 2), accumulate=True)
    g.index_put_((slot_i,), ge, accumulate=True)
    g.index_put_((slot_j,), -ge, accumulate=True)
    return H, g


def _assemble(G, D, Ti, ii, jj, free_mask, cap):
    He, ge, cost = _edge_blocks_from_gram(G, D, Ti)
    H = G.new_zeros(cap + 1, 7, cap + 1, 7)
    g = G.new_zeros(cap + 1, 7)
    _scatter_blocks(H, g, He, ge, ii.long(), jj.long(), free_mask, cap)
    return H, g, cost


def _accumulate_rays(T, meas, ii, jj, edge_mask, free_mask, cap,
                     sigma_ray, sigma_dist, compute_dtype=torch.bfloat16):
    """Dense normal equations ``(H, g, cost)`` of the ray residual at
    poses ``T`` (one K4 launch on the card)."""
    Ti, rts = _rel_pose_rows(T, ii, jj, edge_mask)
    G = ba_kernels.gram_rays(rts, meas, sigma_ray, sigma_dist,
                             compute_dtype=compute_dtype)
    return _assemble(G, 4, Ti, ii, jj, free_mask, cap)


def _accumulate_calib(T, meas, K, ii, jj, edge_mask, free_mask, cap,
                      img_size, pixel_border, z_eps, sigma_pixel,
                      sigma_depth, compute_dtype=torch.bfloat16):
    """Dense normal equations of the calibrated residual (one K5 launch)."""
    fx, fy, cx, cy = geometry.decompose_K(K)
    Ti, rts = _rel_pose_rows(T, ii, jj, edge_mask, extra=(fx, fy, cx, cy))
    G = ba_kernels.gram_calib(rts, meas, img_size, pixel_border, z_eps,
                              sigma_pixel, sigma_depth,
                              compute_dtype=compute_dtype)
    return _assemble(G, 3, Ti, ii, jj, free_mask, cap)


def _split_edges(mesh, ii, jj, edge_mask, meas):
    """Each slot's share of the two-way edges ``ii, jj, edge_mask`` and
    their channels ``meas``, on the slot's device, in slot order:
    ``[(ii_k, jj_k, mask_k, meas_k), ...]`` (``torch.tensor_split``; a
    solve splits its padded bucket, which the mesh size divides, into
    equal parts)."""
    parts = [S.shard_leading(a, mesh) for a in (ii, jj, edge_mask)]
    meas_parts = [S.shard_leading(ch, mesh) for ch in meas]
    return [(parts[0][k], parts[1][k], parts[2][k],
             tuple(m[k] for m in meas_parts)) for k in range(mesh.size)]


def _sum_systems(mesh, outs):
    """The slots' systems ``[(H, g, cost), ...]`` added onto the first
    slot's device in slot order (the JAX ``psum``; the order fixes the
    sum)."""
    H, g, cost = outs[0]
    for H_k, g_k, cost_k in outs[1:]:
        H = H + H_k.to(mesh.first)
        g = g + g_k.to(mesh.first)
        cost = cost + cost_k.to(mesh.first)
    return H, g, cost


def _mesh_system(mesh, accum, shares, free_mask, extra_arrays=()):
    """``system(T)``: the dense system ``(H, g, cost)`` of all edges at
    poses ``T``, built per slot of ``mesh`` from its share (``shares``, from
    :func:`_split_edges`) and summed (:func:`_sum_systems`). ``free_mask``
    and ``extra_arrays`` (e.g. K) are replicated once, ``T`` on every call.
    Each slot builds the full-size system from its own edges on its device
    with ``accum(T, meas, ii, jj, mask, free, *extras)`` (the scatter
    targets are global keyframe slots, so the slots' systems are disjoint
    contributions); every slot is launched before any is summed."""
    reps = S.replicate((free_mask, *extra_arrays), mesh)

    def system(T):
        Ts = S.replicate(T, mesh)
        return _sum_systems(mesh, [
            accum(Ts[k], meas_k, ii_k, jj_k, mask_k, reps[k][0],
                  *reps[k][1:])
            for k, (ii_k, jj_k, mask_k, meas_k) in enumerate(shares)])

    return system


def _edge_system(mesh, accum, ii, jj, edge_mask, free_mask, meas,
                 extra_arrays=()):
    """``system(T)`` of a solve: one build of every edge without a mesh,
    else :func:`_mesh_system` over the edges split once."""
    if mesh is None:
        return lambda T: accum(T, meas, ii, jj, edge_mask, free_mask,
                               *extra_arrays)
    return _mesh_system(mesh, accum,
                        _split_edges(mesh, ii, jj, edge_mask, meas),
                        free_mask, extra_arrays)


def _shard_edge_system(mesh, accum, T, free_mask, ii, jj, edge_mask, meas,
                       extra_arrays=()):
    """The dense system ``(H, g, cost)`` of all edges, built per slot of
    ``mesh`` and summed (the JAX ``_shard_edge_system``: ``shard_map`` over
    the edge axis and a ``psum``): the edges and channels split over the
    slots (:func:`_split_edges`), ``T``, ``free_mask`` and
    ``extra_arrays`` replicated (:func:`_mesh_system`)."""
    shares = _split_edges(mesh, ii, jj, edge_mask, meas)
    return _mesh_system(mesh, accum, shares, free_mask, extra_arrays)(T)


def system_error(sys, ref):
    """Largest error of a dense system ``(H, g, cost)`` against a reference
    system, each entry relative to its own scale: ``H_ab`` to ``sqrt(H_aa
    H_bb)``, ``g_a`` to ``sqrt(H_aa cost)``, the cost to itself (the bounds
    Cauchy-Schwarz gives a sum of whitened Gram blocks, as
    ``ba_kernels.gram_error`` holds a Gram). An entry whose scale is zero
    must be exactly zero, else the error is infinite. Checks the sharded
    system against one build (on the reference's device); never on the
    solve's path."""
    H, g, c = (a.to(ref[0].device).double() for a in sys)
    H0, g0, c0 = (a.double() for a in ref)
    n = H0.shape[0] * H0.shape[1]
    H, H0 = H.reshape(n, n), H0.reshape(n, n)
    g, g0 = g.reshape(n), g0.reshape(n)
    d = torch.diagonal(H0).clamp_min(0.0).sqrt()
    c0 = c0.clamp_min(0.0)

    def rel(diff, den):
        return torch.where(den > 0, diff / den.clamp_min(1e-300),
                           torch.where(diff > 0, math.inf, 0.0)).max().item()

    return max(rel((H - H0).abs(), d[:, None] * d[None, :]),
               rel((g - g0).abs(), d * c0.sqrt()),
               rel((c - c0).abs().reshape(1), c0.reshape(1)))


def _solve_system(H, g, free_mask, cap, damping):
    """Damped dense Cholesky step. Returns ``(dx (cap, 7), ok)``.

    ``damping`` (a float or a 0-dim float32 tensor, the LM loop's λ) is
    Marquardt-style relative damping ``H + λ·diag(H)``; poses that may not
    move get identity rows. ``ok`` is False when the factorization fails
    (``cholesky_ex``'s ``info``) or is not finite; dx is then 0."""
    n = cap * 7
    Hd = H[:cap, :, :cap, :].reshape(n, n)
    gd = g[:cap].reshape(n)
    diag_free = free_mask[:cap].repeat_interleave(7)
    Hd = torch.where(diag_free[:, None] & diag_free[None, :], Hd,
                     torch.zeros_like(Hd))
    # bf16-Gram rounding leaves H slightly asymmetric along weak directions
    Hd = 0.5 * (Hd + Hd.T)
    diag = torch.diagonal(Hd)
    Hd = Hd + torch.diag(torch.where(diag_free,
                                     damping * diag.clamp_min(1e-6),
                                     torch.ones_like(diag)))
    gd = torch.where(diag_free, gd, torch.zeros_like(gd))
    Lc, info = torch.linalg.cholesky_ex(Hd)
    ok = (info == 0) & torch.isfinite(Lc).all()
    eye = torch.eye(n, dtype=Hd.dtype, device=Hd.device)
    Lc_safe = torch.where(ok, Lc, eye)
    # two triangular solves (cholesky_solve's potrs allocates inside a CUDA
    # graph's loop body, which a conditional node does not allow)
    y = torch.linalg.solve_triangular(Lc_safe, gd[:, None], upper=False)
    dx = torch.linalg.solve_triangular(Lc_safe.T, y, upper=True)[:, 0]
    dx = torch.where(ok, dx, torch.zeros_like(dx))
    return dx.reshape(cap, 7), ok


def _lm_state(T_WC, H, g, cost, damping, max_iter):
    """The LM loop's state at poses ``T_WC`` and their system: ``(T_ref,
    cost_ref, H, g, lam, delta, iters, live)``, device tensors that the
    steps update in place (JAX's carry)."""
    dev = H.device
    return (T_WC.clone(), cost.clone(), H.clone(), g.clone(),
            torch.full((), damping, dtype=torch.float32, device=dev),
            torch.full((), math.inf, dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.full((), max_iter > 0, dtype=torch.bool, device=dev))


def _lm_propose(state, free_mask, cap):
    """A step's candidate: the damped solve of the state's system and the
    retraction of its poses. Returns ``(dx, chol_ok, T_cand)``."""
    T_ref, _, H, g, lam = state[:5]
    dx, chol_ok = _solve_system(H, g, free_mask, cap, lam)
    return dx, chol_ok, lie.retr(T_ref, dx)


def _lm_accept(state, dx, chol_ok, T_cand, H_c, g_c, cost_c, max_iter,
               delta_thresh, damping):
    """The accept / reject rules of a step, given the candidate's system
    ``H_c, g_c, cost_c``: the state updated in place."""
    T_ref, cost_ref, H, g, lam, delta, iters, live = state
    accept = live & chol_ok & (cost_c < cost_ref)
    T_ref.copy_(torch.where(accept, T_cand, T_ref))
    cost_ref.copy_(torch.where(accept, cost_c, cost_ref))
    H.copy_(torch.where(accept, H_c, H))
    g.copy_(torch.where(accept, g_c, g))
    lam.copy_(torch.where(accept, (lam * 0.25).clamp_min(damping),
                          torch.where(live, lam * 10.0, lam)))
    # only a small ACCEPTED step means converged; the λ cap ends a
    # reject-only stall
    moved = torch.where(accept, torch.linalg.norm(dx), math.inf)
    delta.copy_(torch.where(live, torch.where(lam > 1e8, 0.0, moved),
                            delta))
    iters.add_(live)
    live.copy_(live & (iters < max_iter) & (delta >= delta_thresh))


def _lm_loop(system, T_WC, free_mask, cap, max_iter, delta_thresh, damping):
    """Levenberg-Marquardt accept / reject loop of the BA solvers.

    Each iteration solves the damped system, builds the system at the
    candidate (its whitened-Huber cost is the Gram's (rho, rho) corner) and:
    - accepts when the Cholesky succeeded and the cost fell: keep the
      candidate, λ ← max(damping, λ/4);
    - rejects otherwise: keep the iterate, λ ← 10λ, re-solve the same
      system.
    ``delta`` is the step's ‖dx‖ when accepted and inf otherwise, 0 once λ
    passes 1e8; the loop goes on while fewer than ``max_iter`` iterations
    ran and ``delta >= delta_thresh``. As the JAX ``lax.while_loop``, it
    exits on the device (``ops/device_loop.py``): the iterate, its cost, H,
    g, λ and delta are float32 device tensors updated in place by each
    step, in the JAX loop's order, and a step after the exit leaves them
    as they are. Returns ``(T, iterations)``, iterations a device int."""
    state = _lm_state(T_WC, *system(T_WC), damping, max_iter)

    def step():
        dx, chol_ok, T_cand = _lm_propose(state, free_mask, cap)
        _lm_accept(state, dx, chol_ok, T_cand, *system(T_cand), max_iter,
                   delta_thresh, damping)

    device_loop.run(max_iter, state[-1], step)
    return state[0], state[-2]


def _lm_hosted(graphs, key, mesh, accum, T_WC, extras, ii, jj, edge_mask,
               free_mask, meas, cap, max_iter, delta_thresh, damping):
    """:func:`_lm_loop` over a mesh of distinct cards, as CUDA graphs: a
    conditional node's body holds the nodes of one device, so the loop
    runs on the host. Each slot's system build is a graph on its own card
    (one per card and shape), the step's solve and retraction
    (``propose``) and its sum of the slots' systems and accept rules
    (``accept``) are graphs on the first slot, and the host reads the
    loop's exit once an iteration. The edges are split over the slots once
    a solve. ``graphs.run`` may also be a plain call (``fn(*inputs)``):
    the same operations in the same order as :func:`_lm_loop`, so the
    results are its bits. Returns ``(T, iterations)``."""
    shares = _split_edges(mesh, ii, jj, edge_mask, meas)
    reps = S.replicate((free_mask, *extras), mesh)
    n_extra = len(extras)
    first = mesh.first

    def build(T, free, ii_k, jj_k, mask_k, *rest):
        return accum(T, rest[n_extra:], ii_k, jj_k, mask_k, free,
                     *rest[:n_extra])

    def system(T):
        outs = []
        for k, (ii_k, jj_k, mask_k, meas_k) in enumerate(shares):
            dev = mesh.devices[k]
            outs.append(graphs.run(
                key + ("build", dev), build,
                (T.to(dev), reps[k][0], ii_k, jj_k, mask_k, *reps[k][1:],
                 *meas_k)))
        # the slots' systems as flat inputs of a graph on the first slot
        return [t.to(first) for out in outs for t in out]

    def summed(*flat):
        return _sum_systems(mesh, [flat[i:i + 3]
                                   for i in range(0, len(flat), 3)])

    def propose(*state_free):
        return _lm_propose(state_free[:-1], state_free[-1], cap)

    def accept(*a):
        state, (dx, chol_ok, T_cand), flat = a[:8], a[8:11], a[11:]
        _lm_accept(state, dx, chol_ok, T_cand, *summed(*flat), max_iter,
                   delta_thresh, damping)
        return state

    H, g, cost = graphs.run(key + ("sum",), summed, tuple(system(T_WC)))
    state = _lm_state(T_WC, H, g, cost, damping, max_iter)
    for _ in range(max_iter):
        if not bool(state[-1]):          # the exit, read once an iteration
            break
        cand = graphs.run(key + ("propose",), propose,
                          (*state, free_mask))
        state = graphs.run(key + ("accept",), accept,
                           (*state, *cand, *system(cand[2])))
    return state[0], state[-2]


def _run_solve(graphs, mesh, key, solve, inputs, static, hosted):
    """``solve(*inputs)``: eagerly, or with ``graphs`` as the CUDA graph of
    ``key`` and the mesh (every slot on one device: the whole solve, the
    inputs at indices ``static`` read where they are; see
    :func:`gauss_newton_rays`), or, over distinct cards, as
    :func:`_lm_hosted`'s graphs (``hosted(graphs, key)``)."""
    if graphs is None:
        return solve(*inputs)
    if mesh is not None and len(mesh.distinct()) > 1:
        return hosted(graphs, key + (mesh,))
    return graphs.run(key + (mesh,), solve, inputs, static=static)


def gauss_newton_rays(T_WC, meas, ii, jj, edge_mask, free_mask, sigma_ray,
                      sigma_dist, max_iter, delta_thresh, damping=1e-4,
                      compute_dtype="bfloat16", mesh=None, graphs=None):
    """Global ray-alignment BA over two-way edges ``ii, jj (E,)``.

    ``T_WC (cap, 8)``; ``meas``: channels from :func:`precompute_meas_rays`
    (float32 or bfloat16); ``edge_mask (E,)``; ``free_mask (cap,)`` bool.
    Returns ``(T (cap, 8), iterations)``, iterations a device int; one K4
    launch per system build (1 + iterations), or with ``mesh`` one per slot
    and build: the edges split over the slots once a solve (the mesh size
    divides E), the slots' systems summed in slot order
    (:func:`_mesh_system`; the inputs and ``T_WC`` on the first slot's
    device). With ``graphs`` (an ``ops.graphs.GraphCache``, CUDA inputs)
    the solve runs as its graph for this configuration, mesh and shape
    (its LM loop a conditional node); ``ii, jj, edge_mask, free_mask`` and
    ``meas`` must then be the caller's buffers, the same tensors on every
    call of a shape (:meth:`FactorGraph._two_way_padded`'s), which the
    graph reads where they are. Over a mesh of distinct cards the solve
    runs as :func:`_lm_hosted`'s graphs instead."""
    cap = T_WC.shape[0]
    cdt = ba_kernels.as_dtype(compute_dtype)

    def accum(T, meas_l, ii_l, jj_l, mask_l, free_l):
        return _accumulate_rays(T, meas_l, ii_l, jj_l, mask_l, free_l, cap,
                                sigma_ray, sigma_dist, compute_dtype=cdt)

    def solve(T_WC, ii, jj, edge_mask, free_mask, *meas):
        system = _edge_system(mesh, accum, ii, jj, edge_mask, free_mask,
                              meas)
        return _lm_loop(system, T_WC, free_mask, cap, max_iter,
                        delta_thresh, damping)

    def hosted(graphs, key):
        return _lm_hosted(graphs, key, mesh, accum, T_WC, (), ii, jj,
                          edge_mask, free_mask, meas, cap, max_iter,
                          delta_thresh, damping)

    inputs = (T_WC, ii, jj, edge_mask, free_mask, *meas)
    key = ("rays", cdt, sigma_ray, sigma_dist, max_iter, delta_thresh,
           damping)
    return _run_solve(graphs, mesh, key, solve, inputs,
                      range(1, len(inputs)), hosted)


def gauss_newton_calib(T_WC, meas, K, ii, jj, edge_mask, free_mask, img_size,
                       pixel_border, z_eps, sigma_pixel, sigma_depth,
                       max_iter, delta_thresh, damping=1e-4,
                       compute_dtype="bfloat16", mesh=None, graphs=None):
    """Global calibrated BA (pixel + log-depth residuals); as
    :func:`gauss_newton_rays` with K5 (``K`` is copied into a graph's
    buffer on every call, as ``T_WC``)."""
    cap = T_WC.shape[0]
    cdt = ba_kernels.as_dtype(compute_dtype)

    def accum(T, meas_l, ii_l, jj_l, mask_l, free_l, K_l):
        return _accumulate_calib(T, meas_l, K_l, ii_l, jj_l, mask_l, free_l,
                                 cap, img_size, pixel_border, z_eps,
                                 sigma_pixel, sigma_depth, compute_dtype=cdt)

    def solve(T_WC, K, ii, jj, edge_mask, free_mask, *meas):
        system = _edge_system(mesh, accum, ii, jj, edge_mask, free_mask,
                              meas, (K,))
        return _lm_loop(system, T_WC, free_mask, cap, max_iter,
                        delta_thresh, damping)

    def hosted(graphs, key):
        return _lm_hosted(graphs, key, mesh, accum, T_WC, (K,), ii, jj,
                          edge_mask, free_mask, meas, cap, max_iter,
                          delta_thresh, damping)

    inputs = (T_WC, K, ii, jj, edge_mask, free_mask, *meas)
    key = ("calib", cdt, tuple(img_size), pixel_border, z_eps, sigma_pixel,
           sigma_depth, max_iter, delta_thresh, damping)
    return _run_solve(graphs, mesh, key, solve, inputs,
                      range(2, len(inputs)), hosted)


# ---------------------------------------------------------------------------
# Host-side factor graph
# ---------------------------------------------------------------------------

def _bucket(n, minimum=8):
    """The power-of-two edge bucket of ``n`` two-way edges (the JAX
    ``_bucket``): one solve graph per bucket."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _upload(buf, host):
    """Copy the numpy array ``host`` into the device buffer ``buf`` without
    a stream sync: from pinned memory, asynchronously, on a card."""
    src = torch.from_numpy(host)
    if buf.device.type == "cuda":
        src = src.pin_memory()
    buf.copy_(src, non_blocking=True)


def _geo_match_init(X_i, X_j, T_i, T_j, img_hw):
    """Pose-projected matcher inits for both directions of B edges.

    ``match(X11, X21, init)`` takes one init entry per image-2 pixel naming
    a pixel of image 1, so the init of the direction whose output is
    ``idx_ii2jj`` is keyframe j's points projected into camera i, and vice
    versa. ``X (B, N, 3)``, ``T (B, 8)``. Returns
    ``(init_ii2jj, init_jj2ii)``."""
    f_i = geometry.estimate_focal(X_i, img_hw)
    f_j = geometry.estimate_focal(X_j, img_hw)
    init_ii2jj = geometry.project_to_index(X_j, T_j, T_i, f_i, img_hw)
    init_jj2ii = geometry.project_to_index(X_i, T_i, T_j, f_j, img_hw)
    return init_ii2jj, init_jj2ii


class FactorGraph:
    """Edge store and BA solves (the reference's global_opt.py): edges are
    created by a symmetric decode + match and accepted by bidirectional
    coverage; the pose-invariant measured channels of every edge are cached
    across solves and refreshed only for edges whose keyframes' pointmaps
    changed. On a card, a solve runs as CUDA graphs (``graphed=False``
    runs it eagerly there: a comparison's reference)."""

    def __init__(self, model, keyframes, cfg, K=None, mesh=None,
                 home_device=None, graphed=True):
        self.model = model
        self.keyframes = keyframes
        self.cfg = cfg["local_opt"]
        self.K = K
        # ``mesh``: the backend's device slots (``parallel.sharding``); the
        # edge buffers, the channel cache and the solve live on its first
        # slot. ``home_device``: where solved poses are committed (the
        # frontend device of a disjoint topology); None leaves them where
        # the solve put them.
        self.mesh = mesh
        self.home_device = home_device
        self.device = keyframes.device if mesh is None else mesh.first
        # which placement each solve took: "sharded" = the mesh size
        # divides the padded bucket, the system built over the mesh;
        # "fallback_single_device" = it does not, on the first backend slot
        self.solve_stats = {"sharded": 0, "fallback_single_device": 0}
        n_pix = keyframes.h * keyframes.w
        self.n_pix = n_pix
        dev = self.device
        self.ii = np.zeros((0,), np.int64)
        self.jj = np.zeros((0,), np.int64)
        self.idx_ii2jj = torch.zeros(0, n_pix, dtype=torch.long, device=dev)
        self.idx_jj2ii = torch.zeros(0, n_pix, dtype=torch.long, device=dev)
        self.valid_match_j = torch.zeros(0, n_pix, 1, dtype=torch.bool,
                                         device=dev)
        self.valid_match_i = torch.zeros(0, n_pix, 1, dtype=torch.bool,
                                         device=dev)
        self.Q_ii2jj = torch.zeros(0, n_pix, 1, device=dev)
        self.Q_jj2ii = torch.zeros(0, n_pix, 1, device=dev)
        self.last_unique_kf_idx: np.ndarray | None = None
        self._iters = 0           # the last solve's iterations (device int)
        # the solves' CUDA graphs, one per edge bucket and kind
        self.graphs = GraphCache("solve") if graphed else None
        # kind -> (bucket, the padded two-way edge buffers of that bucket),
        # and the free-pose mask: written in place by every solve. Edges
        # are never removed, so a larger bucket replaces a kind's buffers
        # (and the solve graphs that read them).
        self._buckets: dict[str, tuple] = {}
        self._free = torch.zeros(keyframes.capacity, dtype=torch.bool,
                                 device=self.device)
        # local_opt.pixel_step: BA residual decimation (1 = every pixel)
        self.pixel_step = int(self.cfg.get("pixel_step", 1))
        # local_opt.meas_dtype: channel storage type; the math widens to f32
        self.meas_dtype = ba_kernels.as_dtype(
            self.cfg.get("meas_dtype", "float32"))
        # cache per one-way edge and direction, with the (gather-side,
        # row-side) keyframe xc_versions it was computed at
        self._meas_kind: str | None = None
        self._meas_ij: tuple | None = None        # dir i->j (gather side ii)
        self._meas_ji: tuple | None = None        # dir j->i (gather side jj)
        self._meas_ver_ij = np.zeros((0, 2), np.int64)
        self._meas_ver_ji = np.zeros((0, 2), np.int64)

    def n_edges(self):
        return int(self.ii.shape[0])

    def add_factors(self, ii_new, jj_new, min_match_frac, is_reloc=False,
                    init_hint=None, allow_geo_init=True):
        """Symmetric-decode candidate edges; accept by bidirectional
        coverage (consecutive edges always). Returns True when an edge was
        added; in strict-reloc mode one invalid edge rejects the batch.

        ``init_hint`` ``(i, j, idx_j2i, valid_i, Q_i)`` is the tracker's
        converged frame→keyframe match of the consecutive edge ``(i, j)``,
        reused verbatim as that edge's j→i direction (``idx_j2i (N,)``,
        ``valid_i (N, 1)``, ``Q_i (N, 1)`` the fused confidence); the edge
        then decodes only (i, j) and runs one matcher
        (``model.match_oneway``). A hint for an edge not in the batch is not
        used. Under a mesh the hint instead warm-starts the symmetric
        matcher's j→i direction of its edge, as in the JAX package (whose
        mesh path decodes every edge sharded). (The JAX package also takes
        a 3-tuple ``(i, j, idx_j2i)`` that warm-starts the symmetric
        matcher; nothing produces it, so the port has no such branch.)"""
        if len(ii_new) == 0:
            return False
        kf = self.keyframes
        use_geo = (allow_geo_init and not is_reloc
                   and bool(self.cfg.get("warm_start_geo", True)))
        ii_t = torch.as_tensor(np.asarray(ii_new), dtype=torch.long,
                               device=kf.device)
        jj_t = torch.as_tensor(np.asarray(jj_new), dtype=torch.long,
                               device=kf.device)
        with kf.lock:
            feat_i, feat_j = kf.feat[ii_t], kf.feat[jj_t]
            pos_i, pos_j = kf.pos[ii_t], kf.pos[jj_t]
            if use_geo:
                X_i, X_j = kf.X[ii_t], kf.X[jj_t]
                T_i, T_j = kf.T_WC[ii_t], kf.T_WC[jj_t]
        img_hw = kf.img_shapes[int(ii_new[0])][1]
        n = self.n_pix

        init_i2j = init_j2i = None
        if use_geo:
            # pointmaps live at the working resolution
            init_i2j, init_j2i = _geo_match_init(X_i, X_j, T_i, T_j,
                                                 (kf.h, kf.w))

        reuse_row = None
        if init_hint is not None and not is_reloc:
            hi, hj = int(init_hint[0]), int(init_hint[1])
            if len(init_hint) != 5:
                raise ValueError("init_hint must be (i, j, idx_j2i, valid_i, "
                                 f"Q_i), got {len(init_hint)} entries")
            rows = [r for r in range(len(ii_new))
                    if int(ii_new[r]) == hi and int(jj_new[r]) == hj]
            if rows and self.mesh is None:
                reuse_row = rows[0]
            elif rows:
                # the tracker's converged i-pixel -> j-pixel match inits the
                # matcher whose output is idx_jj2ii
                if init_j2i is None:
                    init_j2i = torch.arange(n, device=kf.device).expand(
                        len(ii_new), n)
                init_j2i = init_j2i.clone().long()
                init_j2i[rows[0]] = torch.as_tensor(
                    init_hint[2], device=kf.device).reshape(-1)[:n].long()

        if reuse_row is not None:
            r = reuse_row
            full = [k for k in range(len(ii_new)) if k != r]
            idx1, vj1, Qii1, Qji1 = self.model.match_oneway(
                feat_i[r:r + 1], pos_i[r:r + 1], feat_j[r:r + 1],
                pos_j[r:r + 1], img_hw,
                init_i2j=None if init_i2j is None else init_i2j[r:r + 1])
            Qj1 = torch.sqrt(Qii1[0][idx1[0]] * Qji1[0])[None, :, None]
            idx2 = torch.as_tensor(init_hint[2], device=kf.device).reshape(
                1, n).long()
            vi1 = torch.as_tensor(init_hint[3], device=kf.device).reshape(
                1, n, 1).bool()
            Qi1 = torch.as_tensor(init_hint[4], dtype=torch.float32,
                                  device=kf.device).reshape(1, n, 1)
            if full:
                fj = torch.as_tensor(full, device=kf.device)
                (fidx_i2j, fidx_j2i, fvalid_j, fvalid_i, fQii, fQjj, fQji,
                 fQij) = self.model.match_symmetric(
                    feat_i[fj], pos_i[fj], feat_j[fj], pos_j[fj], img_hw,
                    init_i2j=None if init_i2j is None else init_i2j[fj],
                    init_j2i=None if init_j2i is None else init_j2i[fj])
                fb = torch.arange(fidx_i2j.shape[0],
                                  device=kf.device)[:, None]
                fQj = torch.sqrt(fQii[fb, fidx_i2j] * fQji)
                fQi = torch.sqrt(fQjj[fb, fidx_j2i] * fQij)

                def merge(hint_v, full_v):
                    out = [None] * len(ii_new)
                    out[r] = hint_v[0]
                    for k, row in enumerate(full):
                        out[row] = full_v[k]
                    return torch.stack(out)

                idx_i2j = merge(idx1, fidx_i2j)
                idx_j2i = merge(idx2, fidx_j2i)
                valid_j = merge(vj1, fvalid_j)
                valid_i = merge(vi1, fvalid_i)
                Qj = merge(Qj1, fQj)
                Qi = merge(Qi1, fQi)
            else:
                idx_i2j, idx_j2i = idx1, idx2
                valid_j, valid_i = vj1, vi1
                Qj, Qi = Qj1, Qi1
        else:
            (idx_i2j, idx_j2i, valid_j, valid_i, Qii, Qjj, Qji, Qij) = (
                self.model.match_symmetric(feat_i, pos_i, feat_j, pos_j,
                                           img_hw, init_i2j=init_i2j,
                                           init_j2i=init_j2i))
            b_idx = torch.arange(idx_i2j.shape[0], device=self.device)[:, None]
            Qj = torch.sqrt(Qii[b_idx, idx_i2j] * Qji)
            Qi = torch.sqrt(Qjj[b_idx, idx_j2i] * Qij)

        Q_conf = self.cfg["Q_conf"]
        frac = torch.stack([
            (valid_j & (Qj > Q_conf)).float().mean(dim=(1, 2)),
            (valid_i & (Qi > Q_conf)).float().mean(dim=(1, 2)),
        ]).cpu().numpy()
        ii_arr = np.asarray(ii_new, np.int64)
        jj_arr = np.asarray(jj_new, np.int64)
        invalid = np.minimum(frac[0], frac[1]) < min_match_frac
        consecutive = ii_arr == (jj_arr - 1)
        invalid = (~consecutive) & invalid
        if invalid.any() and is_reloc:
            return False
        keep = ~invalid
        if not keep.any():
            return False
        kidx = np.where(keep)[0]
        self.ii = np.concatenate([self.ii, ii_arr[kidx]])
        self.jj = np.concatenate([self.jj, jj_arr[kidx]])
        # the matches lie where the graph keeps its buffers: on the
        # model's mesh (its first slot) or, without one, the keyframes'
        kj = torch.as_tensor(kidx, device=self.device)
        self.idx_ii2jj = torch.cat([self.idx_ii2jj, idx_i2j[kj].long()])
        self.idx_jj2ii = torch.cat([self.idx_jj2ii, idx_j2i[kj].long()])
        self.valid_match_j = torch.cat([self.valid_match_j, valid_j[kj]])
        self.valid_match_i = torch.cat([self.valid_match_i, valid_i[kj]])
        self.Q_ii2jj = torch.cat([self.Q_ii2jj, Qj[kj].float()])
        self.Q_jj2ii = torch.cat([self.Q_jj2ii, Qi[kj].float()])
        return True

    def get_unique_kf_idx(self):
        return np.unique(np.concatenate([self.ii, self.jj]))

    # -- measured-channel cache ---------------------------------------------

    def _kf_versions(self):
        """Pointmap-content versions: pose-only updates (this graph's own
        solves included) must not invalidate the cache."""
        return np.asarray(self.keyframes.xc_version, np.int64).copy()

    def _premeas_rows(self, kind, rows, direction, X, Cavg):
        """Channels of one-way edges ``rows`` in one direction, in the
        storage type ``meas_dtype``."""
        rj = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        if direction == "ij":
            g_kf, r_kf = self.ii[rows], self.jj[rows]
            idx, valid, Q = (self.idx_ii2jj[rj], self.valid_match_j[rj],
                             self.Q_ii2jj[rj])
        else:
            g_kf, r_kf = self.jj[rows], self.ii[rows]
            idx, valid, Q = (self.idx_jj2ii[rj], self.valid_match_i[rj],
                             self.Q_jj2ii[rj])
        g_kf = torch.as_tensor(g_kf, device=rj.device)
        r_kf = torch.as_tensor(r_kf, device=rj.device)
        C_thresh = float(self.cfg["C_conf"])
        Q_thresh = float(self.cfg["Q_conf"])
        if kind == "rays":
            meas = precompute_meas_rays(X, Cavg, g_kf, r_kf, idx, valid, Q,
                                        C_thresh, Q_thresh,
                                        pixel_step=self.pixel_step)
        else:
            meas = precompute_meas_calib(
                X, Cavg, g_kf, r_kf, idx, valid, Q, self.keyframes.w,
                float(self.cfg["depth_eps"]), C_thresh, Q_thresh,
                pixel_step=self.pixel_step)
        return tuple(ch.to(self.meas_dtype).contiguous() for ch in meas)

    def _ensure_meas(self, kind):
        """Create or refresh the per-edge channel cache: new edges are
        appended; cached edges are recomputed (in place) only when the
        ``xc_version`` of either touched keyframe moved."""
        E = self.n_edges()
        if E == 0:
            return
        kf = self.keyframes
        ver = self._kf_versions()
        want_ij = np.stack([ver[self.ii], ver[self.jj]], 1)
        want_ji = np.stack([ver[self.jj], ver[self.ii]], 1)
        cache = []

        def inputs():
            # built once per call, and only when a row is (re)computed; on
            # the backend's device (a copy of the frontend's buffers in a
            # disjoint topology), so the gathers run there
            if not cache:
                X = kf.X.to(self.device)
                Cavg = (kf.C.to(self.device) / torch.as_tensor(
                    kf.N, dtype=torch.float32,
                    device=self.device).clamp_min(1.0)[:, None, None])
                if kind == "calib":
                    # both solve sides use ray-constrained points
                    X = geometry.constrain_points_to_ray(
                        (kf.h, kf.w), X.reshape(-1, self.n_pix, 3),
                        self._place_K())
                cache.append((X, Cavg))
            return cache[0]

        if self._meas_kind != kind or self._meas_ij is None:
            rows = np.arange(E)
            X, Cavg = inputs()
            self._meas_ij = self._premeas_rows(kind, rows, "ij", X, Cavg)
            self._meas_ji = self._premeas_rows(kind, rows, "ji", X, Cavg)
            self._meas_kind = kind
            self._meas_ver_ij = want_ij
            self._meas_ver_ji = want_ji
            return

        E0 = self._meas_ver_ij.shape[0]
        if E0 < E:
            rows = np.arange(E0, E)
            X, Cavg = inputs()
            new_ij = self._premeas_rows(kind, rows, "ij", X, Cavg)
            new_ji = self._premeas_rows(kind, rows, "ji", X, Cavg)
            self._meas_ij = tuple(torch.cat([a, b]) for a, b in
                                  zip(self._meas_ij, new_ij))
            self._meas_ji = tuple(torch.cat([a, b]) for a, b in
                                  zip(self._meas_ji, new_ji))
            self._meas_ver_ij = np.concatenate(
                [self._meas_ver_ij, want_ij[E0:]])
            self._meas_ver_ji = np.concatenate(
                [self._meas_ver_ji, want_ji[E0:]])

        for direction, cached, ver_cached, want in (
            ("ij", self._meas_ij, self._meas_ver_ij, want_ij),
            ("ji", self._meas_ji, self._meas_ver_ji, want_ji),
        ):
            stale = np.where((ver_cached != want).any(axis=1))[0]
            if stale.size == 0:
                continue
            X, Cavg = inputs()
            fresh = self._premeas_rows(kind, stale, direction, X, Cavg)
            sj = torch.as_tensor(stale, device=self.device)
            for ch, f in zip(cached, fresh):
                ch[sj] = f
            ver_cached[stale] = want[stale]

    def drop_meas_cache(self):
        """Invalidate the measured-channel cache (a checkpoint restore
        replaced the keyframe pointmaps)."""
        self._meas_kind = None
        self._meas_ij = self._meas_ji = None
        self._meas_ver_ij = np.zeros((0, 2), np.int64)
        self._meas_ver_ji = np.zeros((0, 2), np.int64)

    # -- solves --------------------------------------------------------------

    def _two_way_padded(self):
        """Two-way edges and channels padded to a power-of-two bucket, as
        the JAX ``_two_way_padded``: rows ``[ij (E); ji (E); pad]``, a
        padded row ``ii = jj = 0`` with zero channels and ``edge_mask`` 0
        (its Gram is exactly zero). They are written into the bucket's
        buffers, kept across solves (a graphed solve reads them where they
        are): the channels in one copy from the cache, the edge rows from
        pinned memory without a stream sync, the mask filled on the
        device. Returns ``(ii2, jj2, mask, meas, n)``, ``n = 2E``."""
        E = self.n_edges()
        n = 2 * E
        B = _bucket(n)
        dev = self.device
        held = self._buckets.get(self._meas_kind)
        if held is None or held[0] != B:
            if held is not None and self.graphs is not None:
                # the graphs that read the smaller bucket's buffers, or
                # (over distinct cards) their slot shares
                self.graphs.drop(held[1][1])
                self.graphs.drop_if(
                    lambda key: key[0] == self._meas_kind and "build" in key)
            edges = torch.empty(2, B, dtype=torch.long, device=dev)
            held = (B, (edges, edges[0], edges[1],
                        torch.empty(B, dtype=torch.float32, device=dev),
                        tuple(torch.empty((B,) + ch.shape[1:],
                                          dtype=ch.dtype, device=dev)
                              for ch in self._meas_ij)))
            self._buckets[self._meas_kind] = held
        bufs = held[1]
        edges, ii2, jj2, mask, meas = bufs
        rows = np.zeros((2, B), np.int64)
        rows[0, :n] = np.concatenate([self.ii, self.jj])
        rows[1, :n] = np.concatenate([self.jj, self.ii])
        _upload(edges, rows)
        mask.copy_(torch.arange(B, device=dev) < n)
        for buf, a, b in zip(meas, self._meas_ij, self._meas_ji):
            buf[:E].copy_(a)
            buf[E:n].copy_(b)
            buf[n:].zero_()
        return ii2, jj2, mask, meas, n

    def bucket_bytes(self):
        """Device bytes of the padded two-way edge buffers held for the
        solves (one bucket a kind), beside the solve graphs' pools."""
        return sum(t.numel() * t.element_size()
                   for _, (edges, _, _, mask, meas) in self._buckets.values()
                   for t in (edges, mask, *meas))

    def _free_mask(self, unique_kf_idx):
        """The poses a solve may move, in the graph's buffer."""
        pin = int(self.cfg["pin"])
        mask = np.zeros(self.keyframes.capacity, bool)
        mask[unique_kf_idx[pin:]] = True
        _upload(self._free, mask)
        return self._free

    def _solve_mesh(self, bucket):
        """The mesh a solve over a padded bucket of ``bucket`` two-way rows
        is sharded over, or None, as the JAX package places it: the mesh
        when its size divides the bucket, else (or without a mesh) the
        first backend slot alone; counted in ``solve_stats``."""
        if self.mesh is None:
            return None
        if bucket % self.mesh.size == 0:
            self.solve_stats["sharded"] += 1
            return self.mesh
        self.solve_stats["fallback_single_device"] += 1
        return None

    def _place_T(self, T):
        """The pose table on the solve's device (the first backend slot);
        :func:`_shard_edge_system` replicates it from there."""
        return T.to(self.device)

    def _place_K(self):
        return None if self.K is None else self.K.to(self.device)

    def _home(self, T_new):
        """Solved poses back on the frontend device, so the tracking
        computations stay on their own device."""
        if self.home_device is None:
            return T_new
        return T_new.to(self.home_device)

    @property
    def last_solve_iters(self):
        """The last solve's LM iterations, read from the device at the
        first access after the solve (the solve itself reads nothing)."""
        if torch.is_tensor(self._iters):
            self._iters = int(self._iters)
        return self._iters

    def _solve(self, kind, solver):
        unique = self.get_unique_kf_idx()
        if unique.size <= int(self.cfg["pin"]):
            self.last_unique_kf_idx = None
            return
        self.last_unique_kf_idx = unique
        kf = self.keyframes
        with kf.lock:
            self._ensure_meas(kind)
            ii2, jj2, mask, meas, _ = self._two_way_padded()
            mesh = self._solve_mesh(ii2.shape[0])
            graphs = self.graphs if self.device.type == "cuda" else None
            T_new, self._iters = solver(
                self._place_T(kf.T_WC), meas, ii2, jj2, mask,
                self._free_mask(unique), mesh, graphs)
            kf.T_WC = self._home(T_new)
            for i in unique[int(self.cfg["pin"]):]:
                kf.version[int(i)] += 1

    def _compute_dtype(self):
        return str(self.cfg.get("ba_compute_dtype", "bfloat16"))

    def solve_GN_rays(self):
        c = self.cfg

        def solver(T, meas, ii2, jj2, mask, free, mesh, graphs):
            return gauss_newton_rays(
                T, meas, ii2, jj2, mask, free, float(c["sigma_ray"]),
                float(c["sigma_dist"]), int(c["max_iters"]),
                float(c["delta_norm"]), compute_dtype=self._compute_dtype(),
                mesh=mesh, graphs=graphs)

        self._solve("rays", solver)

    def solve_GN_calib(self):
        c = self.cfg
        kf = self.keyframes

        def solver(T, meas, ii2, jj2, mask, free, mesh, graphs):
            return gauss_newton_calib(
                T, meas, self._place_K(), ii2, jj2, mask, free, (kf.h, kf.w),
                float(c["pixel_border"]), float(c["depth_eps"]),
                float(c["sigma_pixel"]), float(c["sigma_depth"]),
                int(c["max_iters"]), float(c["delta_norm"]),
                compute_dtype=self._compute_dtype(), mesh=mesh,
                graphs=graphs)

        self._solve("calib", solver)
