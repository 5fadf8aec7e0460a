"""Pointmap quality assessment on tensors (counterpart of
``mast3r_slam_tpu/services/quality_core.py``).

Per-keyframe patch-grid reductions of residuals, uncertainty and coverage,
EWMA coverage deltas, robust z-scores, and a 3-way degradation
classification with normalized refinement priorities. Every function takes
tensors of one device and stays on it; a batch of jobs is one set of
batched tensor ops plus a loop over the EWMA chain.

Two median conventions, both JAX's: :func:`masked_median` and
:func:`reduce_grid` take the LOWER middle element of an even count (as
``torch.nanmedian``), :func:`robust_z` the MEAN of the two middle elements
(``jnp.median``; ``torch.median`` would take the lower one).
"""

from __future__ import annotations

import torch


def _to_grid(x, ps):
    """``(..., H, W)`` → ``(..., gh, gw, ps*ps)`` patch grid."""
    h, w = x.shape[-2:]
    gh, gw = h // ps, w // ps
    lead = x.shape[:-2]
    x = x[..., : gh * ps, : gw * ps].reshape(*lead, gh, ps, gw, ps)
    return x.transpose(-3, -2).reshape(*lead, gh, gw, ps * ps), gh, gw


def masked_median(x, mask):
    """Median over the last axis counting only ``mask`` entries (0 if none):
    element ``(k-1)//2`` of the k sorted valid entries, the lower middle
    one for even k."""
    xs = torch.where(mask, x, torch.full_like(x, float("inf"))).sort(-1).values
    k = mask.sum(-1)
    lo = ((k - 1) // 2).clamp_min(0)
    med = xs.gather(-1, lo[..., None])[..., 0]
    return torch.where(k > 0, med, torch.zeros_like(med))


def reduce_grid(x, ps, valid=None, method="median"):
    """Patch-grid reduction of ``x (..., H, W)`` with an optional validity
    mask."""
    X, _, _ = _to_grid(x, ps)
    if valid is None:
        if method == "median":
            return X.sort(-1).values[..., (X.shape[-1] - 1) // 2]
        return X.mean(-1)
    M, _, _ = _to_grid(valid.to(torch.float32), ps)
    mask = M >= 0.5
    if method == "median":
        return masked_median(X, mask)
    s = torch.where(mask, X, torch.zeros_like(X)).sum(-1)
    n = mask.sum(-1)
    return torch.where(n > 0, s / n.clamp_min(1), torch.zeros_like(s))


def view_weight(t_norm, theta, b0, theta0):
    """Observation weight from camera motion: 0.5*(clip(t/b0) + clip(θ/θ0));
    a non-positive normalizer means "always fully weighted"."""
    one = torch.ones_like(t_norm)
    t = (t_norm / max(b0, 1e-12)).clamp(0.0, 1.0) if b0 > 0 else one
    r = (theta / max(theta0, 1e-12)).clamp(0.0, 1.0) if theta0 > 0 else one
    return 0.5 * (t + r)


def ema_delta(prev, inc, alpha):
    new = alpha * prev + (1.0 - alpha) * inc
    return new, new - prev


def _median_mean_of_middle(x):
    """``jnp.median`` over the last axis: the mean of the two middle
    elements when the count is even."""
    s = x.sort(-1).values
    n = s.shape[-1]
    return 0.5 * (s[..., (n - 1) // 2] + s[..., n // 2])


def robust_z(x, eps=1e-6):
    """Median/MAD standardization over the last axis."""
    m = _median_mean_of_middle(x)[..., None]
    mad = _median_mean_of_middle((x - m).abs())[..., None] + eps
    return (x - m) / mad


def classify(delta_cov, r, u, thr_zr=1.0, thr_zu=1.0, thr_dc=0.02):
    """3-way degradation classes + [0, 1] priority scores of ``(..., gh,
    gw)`` grids, standardized per leading index.

    Class 1: stagnant coverage + high uncertainty.
    Class 2: coverage ok but high residual AND high uncertainty.
    Class 3: high residual with low uncertainty (likely geometry error).
    """
    shape = delta_cov.shape
    dc = delta_cov.reshape(*shape[:-2], -1)
    rf = r.reshape(dc.shape)
    uf = u.reshape(dc.shape)
    zr = robust_z(rf)
    zu = robust_z(uf)

    c1 = (dc < thr_dc) & (zu > thr_zu)
    c2 = (dc >= thr_dc) & (zr > thr_zr) & (zu > thr_zu)
    c3 = (zr > thr_zr) & (zu <= thr_zu)
    zero = torch.zeros_like(dc, dtype=torch.int32)
    cls = torch.where(c1, zero + 1,
                      torch.where(c2, zero + 2, torch.where(c3, zero + 3,
                                                            zero)))

    p1 = (1.0 - dc.clamp(0.0, 1.0)) + zu.clamp_min(0.0)
    p2 = zr.clamp_min(0.0) + zu.clamp_min(0.0)
    p3 = zr.clamp_min(0.0) + (1.0 - uf).clamp_min(0.0)
    p = torch.where(c1, p1, torch.where(c2, p2, torch.where(
        c3, p3, torch.zeros_like(p1))))
    p = p / (p.amax(-1, keepdim=True) + 1e-6)
    return cls.reshape(shape), p.reshape(shape)


def _job_fields(valid_kf, r_pix, Ck, Qk, t_norm, theta,
                H, W, ps, b0, theta0, C_thr, Q_thr):
    """Per-job patch-grid fields that do NOT depend on the EWMA state:
    coverage increment ``inc``, residual median ``r``, uncertainty ``u``.
    Inputs ``(..., H*W)``, ``t_norm`` and ``theta`` ``(...)``."""
    lead = valid_kf.shape[:-1]
    valid = valid_kf.reshape(*lead, H, W)
    vgrid = (reduce_grid(valid.to(torch.float32), ps, method="mean") > 0
             ).to(torch.float32)
    inc = vgrid * view_weight(t_norm, theta, b0, theta0)[..., None, None]

    r = reduce_grid(r_pix.reshape(*lead, H, W), ps, valid=valid,
                    method="median")

    Cn = (Ck.reshape(*lead, H, W) / (C_thr + 1e-8)).clamp(0.0, 1.0)
    Qn = (Qk.reshape(*lead, H, W) / (Q_thr + 1e-8)).clamp(0.0, 1.0)
    U = 1.0 - torch.sqrt((Cn * Qn).clamp(0.0, 1.0))
    u = reduce_grid(U, ps, method="median")
    return inc, r, u


def compute_quality(valid_kf, r_pix, Ck, Qk, t_norm, theta, cov_ewma_prev,
                    H, W, ps, alpha, b0, theta0, C_thr, Q_thr,
                    thr_zr, thr_zu, thr_dc):
    """Full quality computation for one keyframe (all inputs flat H*W).

    Returns a dict of patch-grid tensors ``delta_cov, r, u, class_id,
    priority, cov_ewma``, each ``(H//ps, W//ps)``.
    """
    inc, r, u = _job_fields(valid_kf, r_pix, Ck, Qk, t_norm, theta,
                            H, W, ps, b0, theta0, C_thr, Q_thr)
    ew, dc = ema_delta(cov_ewma_prev, inc, alpha)
    cls, pri = classify(dc, r, u, thr_zr, thr_zu, thr_dc)
    return {"delta_cov": dc, "r": r, "u": u, "class_id": cls,
            "priority": pri, "cov_ewma": ew}


def compute_quality_batch(valid_kf, r_pix, Ck, Qk, t_norm, theta,
                          prev_init, chain, H, W, ps, alpha, b0, theta0,
                          C_thr, Q_thr, thr_zr, thr_zu, thr_dc):
    """Batch of B quality jobs in submission order.

    Equal to running :func:`compute_quality` per job sequentially: the
    per-job patch reductions run batched over B, and the EWMA coverage
    chain is a loop so job ``i`` sees job ``i-1``'s ``cov_ewma`` whenever
    ``chain[i]`` is set (same keyframe as the previous job in the batch).
    ``prev_init[i]`` is the service's stored EWMA state, used when
    ``chain[i]`` is False; ``chain`` is a host sequence of bools with
    ``chain[0]`` False. Returns :func:`compute_quality`'s dict with a
    leading batch axis.
    """
    inc, r, u = _job_fields(valid_kf, r_pix, Ck, Qk, t_norm, theta,
                            H, W, ps, b0, theta0, C_thr, Q_thr)
    ews, dcs = [], []
    for i in range(inc.shape[0]):
        prev = ews[-1] if chain[i] else prev_init[i]
        ew, dc = ema_delta(prev, inc[i], alpha)
        ews.append(ew)
        dcs.append(dc)
    ew, dc = torch.stack(ews), torch.stack(dcs)
    cls, pri = classify(dc, r, u, thr_zr, thr_zu, thr_dc)
    return {"delta_cov": dc, "r": r, "u": u, "class_id": cls,
            "priority": pri, "cov_ewma": ew}


def upsample_to_hw(grid, h, w):
    """Nearest-neighbour upsample of a patch grid back to (h, w)."""
    gh, gw = grid.shape
    ry = h // gh + (1 if h % gh else 0)
    rx = w // gw + (1 if w % gw else 0)
    out = grid.repeat_interleave(ry, 0).repeat_interleave(rx, 1)
    return out[:h, :w]
