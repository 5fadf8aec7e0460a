"""Iterative-projection pointmap matching in plain PyTorch.

Counterpart of ``mast3r_slam_tpu/ops/matching.py`` (the JAX package has no
kernel here). Same semantics:

- ``iter_proj``: per-pixel Levenberg-Marquardt on the 2x2 normal equations
  of ``min_p ||normalize(bilerp(rays, p)) - r*||²`` with multiplicative
  damping (x0.1 on accept, x10 on reject), positions clamped to
  ``[1, W-2] x [1, H-2]``, and the progress-plateau early exit. As the
  JAX ``lax.while_loop``, the loop exits on the device
  (``ops/device_loop.py``): its condition is a device flag and nothing is
  read on the host. Each batch row runs its own loop (the JAX loop is
  vmapped, so rows keep their own iteration counts).
- occlusion gate: 3D distance between matched points < ``dist_thresh``.
- ``refine_matches``: coarse-to-fine descriptor search over a dilated
  window (``plus`` / ``separable`` / ``joint``), with descriptors rounded to
  bf16 and scored as f32 products; argmax takes the first maximum.

The JAX package's wide-row gathers over rolled image stacks are a TPU
layout choice; here each candidate is gathered directly (with clamped
indices and the same out-of-image mask), which gives the same results.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from mast3r_slam_tpu_torch.ops import device_loop
from mast3r_slam_tpu_torch.ops.image import img_gradient


def resolve_refine_mode(matching_cfg: dict) -> str:
    """``matching.refine_mode`` with back-compat for the legacy
    ``separable_refine`` bool (True→separable, False→joint)."""
    mode = matching_cfg.get("refine_mode")
    if mode is None:
        legacy = matching_cfg.get("separable_refine")
        if legacy is None:
            return "plus"
        return "separable" if legacy else "joint"
    if mode not in ("plus", "separable", "joint"):
        raise ValueError(f"unknown refine_mode {mode!r}")
    return str(mode)


def pixel_to_lin(p, w):
    """(u, v) integer pixel coords → linear index ``u + w*v``."""
    return p[..., 0] + w * p[..., 1]


def lin_to_pixel(idx, w):
    return torch.stack([idx % w, torch.div(idx, w, rounding_mode="floor")],
                       dim=-1)


def _sample_rays(flat, u, v, w):
    """Bilinear sample of ``flat (H*W, C)`` at ``u, v (N,)`` (pre-clamped
    to [1, W-2] / [1, H-2]; the corner indices are clamped again so a NaN
    position can never index out of bounds)."""
    h = flat.shape[0] // w
    u0f = torch.floor(u)
    v0f = torch.floor(v)
    du = (u - u0f)[:, None]
    dv = (v - v0f)[:, None]
    u0 = torch.nan_to_num(u0f).long().clamp(0, w - 2)
    v0 = torch.nan_to_num(v0f).long().clamp(0, h - 2)
    i00 = v0 * w + u0
    p00, p01 = flat[i00], flat[i00 + 1]
    p10, p11 = flat[i00 + w], flat[i00 + w + 1]
    top = p00 * (1.0 - du) + p01 * du
    bot = p10 * (1.0 - du) + p11 * du
    return top * (1.0 - dv) + bot * dv


def _ray_cost(flat, u, v, target, w):
    """Unit-ray alignment cost at (u, v); also the raw sample and error."""
    s = _sample_rays(flat, u, v, w)
    r = s[:, 0:3]
    r = r * torch.rsqrt((r * r).sum(-1, keepdim=True))
    err = r - target
    return (err * err).sum(-1), s, err


def _iter_proj_single(rays9, pts_norm, p_init, max_iter, lambda_init,
                      cost_thresh, plateau_frac=0.0):
    """LM projection for one image: ``rays9 (H, W, 9)``, ``pts_norm (N, 3)``,
    ``p_init (N, 2)`` → ``(p (N, 2), converged (N,), iterations ()``, the
    last a device tensor).

    The loop stops (on the device) once every pixel has converged, after
    ``max_iter`` iterations, or, with ``plateau_frac > 0``, once the
    converged-pixel count grows by less than ``plateau_frac * N`` in an
    iteration (after the first two)."""
    h, w, c = rays9.shape
    flat = rays9.reshape(h * w, c)
    u = p_init[:, 0].clamp(1.0, w - 2.0)
    v = p_init[:, 1].clamp(1.0, h - 2.0)
    lam = torch.full_like(u, lambda_init)
    cost, s, err = _ray_cost(flat, u, v, pts_norm, w)
    n_q = u.shape[0]
    min_progress = int(math.ceil(plateau_frac * n_q)) if plateau_frac else 0

    # the loop's state, updated in place by each step; live is JAX's cond
    iters = torch.zeros((), dtype=torch.int64, device=u.device)
    prev_cnt = torch.zeros_like(iters)
    live = (cost < cost_thresh).sum() < n_q

    def step():
        cnt = (cost < cost_thresh).sum()
        gx = s[:, 3:6]
        gy = s[:, 6:9]
        a00 = (gx * gx).sum(-1) + lam
        a01 = (gx * gy).sum(-1)
        a11 = (gy * gy).sum(-1) + lam
        b0 = -(err * gx).sum(-1)
        b1 = -(err * gy).sum(-1)
        det_inv = 1.0 / (a00 * a11 - a01 * a01)
        du = det_inv * (a11 * b0 - a01 * b1)
        dv = det_inv * (-a01 * b0 + a00 * b1)
        u_new = (u + du).clamp(1.0, w - 2.0)
        v_new = (v + dv).clamp(1.0, h - 2.0)
        new_cost, new_s, new_err = _ray_cost(flat, u_new, v_new, pts_norm, w)
        accept = (new_cost < cost) & live
        u.copy_(torch.where(accept, u_new, u))
        v.copy_(torch.where(accept, v_new, v))
        lam.copy_(torch.where(accept, lam * 0.1,
                              torch.where(live, lam * 10.0, lam)))
        cost.copy_(torch.where(accept, new_cost, cost))
        s.copy_(torch.where(accept[:, None], new_s, s))
        err.copy_(torch.where(accept[:, None], new_err, err))
        prev_cnt.copy_(torch.where(live, cnt, prev_cnt))
        iters.add_(live)
        # the next step's condition: not every pixel converged and, after
        # the first two steps, enough progress in this one
        cnt = (cost < cost_thresh).sum()
        nxt = live & (cnt < n_q)
        if min_progress:
            nxt &= (iters < 2) | (cnt - prev_cnt >= min_progress)
        live.copy_(nxt)

    device_loop.run(max_iter, live, step)
    return torch.stack([u, v], dim=-1), cost < cost_thresh, iters


def iter_proj(rays_with_grad, pts_norm, p_init, max_iter=10,
              lambda_init=1e-8, cost_thresh=1e-6, plateau_frac=0.0):
    """Batched LM projection, one loop per row: ``rays_with_grad (B, H, W,
    9)``, ``pts_norm (B, N, 3)``, ``p_init (B, N, 2)`` → ``(p (B, N, 2),
    converged (B, N))``."""
    rows = [_iter_proj_single(rays_with_grad[i], pts_norm[i], p_init[i],
                              max_iter, lambda_init, cost_thresh,
                              plateau_frac)
            for i in range(rays_with_grad.shape[0])]
    return (torch.stack([r[0] for r in rows]),
            torch.stack([r[1] for r in rows]))


def _dilation_levels(dilation_max: int, step: int) -> list:
    """Coarse-to-fine dilation schedule, always ending at d = 1."""
    levels = list(range(dilation_max, 0, -step))
    if not levels:
        return []
    if levels[-1] != 1:
        levels.append(1)
    return levels


def _offset_passes(rng, mode, stack, cat, meshgrid):
    """The search passes of one dilation level, each a ``(K, 2)`` table of
    integer ``(du, dv)`` offsets, from ``rng`` = ``arange(-r, r+1) * d``;
    ``stack`` / ``cat`` / ``meshgrid`` are numpy's or torch's."""
    r = (len(rng) - 1) // 2
    zeros = rng * 0
    if mode == "separable":
        return [stack([rng, zeros], -1), stack([zeros, rng], -1)]
    if mode == "plus":
        nz = cat([rng[:r], rng[r + 1:]])
        return [cat([stack([rng, zeros], -1), stack([nz * 0, nz], -1)])]
    du, dv = meshgrid(rng, rng, indexing="xy")
    return [stack([du.reshape(-1), dv.reshape(-1)], -1)]


@functools.lru_cache(maxsize=None)
def _offset_tables(radius: int, dilation: int, mode: str, device):
    """``(host table, device table)`` per search pass of one level, built
    once per (radius, dilation, mode, device): the host table drives the
    candidate loop, the device one (made on the device from ``arange``, no
    host copy) maps the winning candidate back to its offset."""
    host = _offset_passes(np.arange(-radius, radius + 1) * dilation, mode,
                          np.stack, np.concatenate, np.meshgrid)
    dev = _offset_passes(
        torch.arange(-radius, radius + 1, device=device) * dilation, mode,
        torch.stack, torch.cat, torch.meshgrid)
    return tuple(zip(host, dev))


def _search(Dflat, q, pu, pv, offs, offs_t, h, w):
    """One window search for one image: ``Dflat (H*W, F)`` and ``q (N, F)``
    (bf16-rounded, f32), integer ``pu, pv (N,)``, the pass's offsets on the
    host (``offs``) and the device (``offs_t``) → the best candidate."""
    pu_c = pu.clamp(0, w - 1)
    pv_c = pv.clamp(0, h - 1)
    scores = torch.empty(len(offs), pu.shape[0], dtype=torch.float32,
                         device=q.device)
    for k, (du, dv) in enumerate(offs):
        cu = pu_c + int(du)
        cv = pv_c + int(dv)
        inside = (cu >= 0) & (cu < w) & (cv >= 0) & (cv < h)
        idx = cv.clamp(0, h - 1) * w + cu.clamp(0, w - 1)
        sc = (Dflat[idx] * q).sum(-1)
        scores[k] = torch.where(inside, sc, -math.inf)
    best = scores.argmax(0)
    return pu + offs_t[best, 0], pv + offs_t[best, 1]


def refine_matches(D11, D21, p1, radius=3, dilation_max=5, mode="plus",
                   level_step=1):
    """Coarse-to-fine descriptor refinement of integer matches.

    ``D11 (B, H, W, F)`` target descriptors, ``D21 (B, N, F)`` query
    descriptors, ``p1 (B, N, 2)`` integer positions → refined ``(B, N, 2)``.
    ``mode``: ``joint`` (full (2r+1)² window), ``separable`` (horizontal
    then vertical pass) or ``plus`` (one pass over the 4r+1 plus-shaped
    candidates)."""
    b, h, w, f = D11.shape
    D11h = D11.to(torch.bfloat16).float().reshape(b, h * w, f)
    D21h = D21.to(torch.bfloat16).float()
    pu, pv = p1[..., 0].long(), p1[..., 1].long()
    out_u, out_v = [], []
    for bi in range(b):
        u, v = pu[bi], pv[bi]
        for d in _dilation_levels(dilation_max, level_step):
            for offs, offs_t in _offset_tables(radius, d, mode, u.device):
                u, v = _search(D11h[bi], D21h[bi], u, v, offs, offs_t, h, w)
        out_u.append(u)
        out_v.append(v)
    return torch.stack([torch.stack(out_u), torch.stack(out_v)], dim=-1)


def _prep_core(X11, X21):
    b, h, w, _ = X11.shape
    rays = X11 * torch.rsqrt((X11 * X11).sum(-1, keepdim=True).clamp_min(
        1e-24))
    gx, gy = img_gradient(rays)
    rays9 = torch.cat([rays, gx, gy], dim=-1)
    X21v = X21.reshape(b, h * w, 3)
    pts_norm = X21v * torch.rsqrt((X21v * X21v).sum(-1, keepdim=True)
                                  .clamp_min(1e-24))
    return rays9, pts_norm


def _occlusion_gate(X11, X21, p1, converged, dist_thresh):
    b, h, w, _ = X11.shape
    lin = pixel_to_lin(p1, w).clamp(0, h * w - 1)
    matched = torch.gather(X11.reshape(b, h * w, 3), 1,
                           lin[..., None].expand(-1, -1, 3))
    dists = torch.linalg.norm(matched - X21.reshape(b, -1, 3), dim=-1)
    return converged & (dists < dist_thresh)


def prep_for_iter_proj(X11, X21, idx_1_to_2_init):
    """Ray image with gradients, normalized targets and init pixels."""
    b, h, w, _ = X11.shape
    rays9, pts_norm = _prep_core(X11, X21)
    if idx_1_to_2_init is None:
        idx_1_to_2_init = torch.arange(h * w, device=X11.device).expand(
            b, h * w)
    p_init = lin_to_pixel(idx_1_to_2_init.long(), w).to(X11.dtype)
    return rays9, pts_norm, p_init


def match(X11, X21, D11, D21, idx_1_to_2_init=None, *, max_iter=10,
          lambda_init=1e-8, convergence_thresh=1e-6, dist_thresh=0.1,
          radius=3, dilation_max=5, refine_mode="plus", plateau_frac=0.001,
          level_step=1, proj_step=1):
    """LM projection + occlusion gate + refinement.

    Returns ``(idx_1_to_2 (B, N) int64, valid (B, N, 1) bool)``: for each
    pixel of image 2's pointmap-in-frame-1, the linear index of its match in
    image 1. ``proj_step > 1`` runs the LM on a strided query grid and
    upsamples the correction field ``p - p_init`` bilinearly (half-pixel
    centers, edge-clamped) back to full resolution."""
    b, h, w, _ = X21.shape
    rays9, pts_norm, p_init = prep_for_iter_proj(X11, X21, idx_1_to_2_init)
    s = proj_step if (proj_step > 1 and h % proj_step == 0
                      and w % proj_step == 0) else 1
    if s > 1:
        hc, wc = h // s, w // s
        dev = X11.device
        sel = ((torch.arange(hc, device=dev) * s)[:, None] * w
               + (torch.arange(wc, device=dev) * s)[None, :]).reshape(-1)
        p_c, conv_c = iter_proj(rays9, pts_norm[:, sel], p_init[:, sel],
                                max_iter, lambda_init, convergence_thresh,
                                plateau_frac)
        delta = (p_c - p_init[:, sel]).reshape(b, hc, wc, 2)
        delta_full = F.interpolate(delta.permute(0, 3, 1, 2), size=(h, w),
                                   mode="bilinear", align_corners=False)
        p1 = p_init + delta_full.permute(0, 2, 3, 1).reshape(b, h * w, 2)
        p1 = torch.stack([p1[..., 0].clamp(1.0, w - 2.0),
                          p1[..., 1].clamp(1.0, h - 2.0)], dim=-1)
        converged = (conv_c.reshape(b, hc, wc)
                     .repeat_interleave(s, 1).repeat_interleave(s, 2)
                     .reshape(b, h * w))
    else:
        p1, converged = iter_proj(rays9, pts_norm, p_init, max_iter,
                                  lambda_init, convergence_thresh,
                                  plateau_frac)
    p1 = torch.floor(p1).long()
    valid = _occlusion_gate(X11, X21, p1, converged, dist_thresh)
    if radius > 0:
        p1 = refine_matches(D11, D21.reshape(b, h * w, -1), p1, radius,
                            dilation_max, refine_mode, level_step)
    return pixel_to_lin(p1, w), valid[..., None]
