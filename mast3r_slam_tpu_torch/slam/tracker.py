"""Frame-to-keyframe tracking: Sim(3) Levenberg-Marquardt on matched pointmaps.

Counterpart of ``mast3r_slam_tpu/slam/tracker.py``. :func:`track_core` is
the whole per-frame computation — encode → cross-decode + heads →
iterative-projection match → confidences and masks → Sim(3) pose solve →
keyframe pointmap fusion → keyframe-selection statistics → quality-job
tensors — and :class:`FrameTracker` makes the host-side decisions on its
outputs.

As in JAX, :func:`track_core` reads nothing on the host: the LM loops of
the matcher and of the pose solve exit on the device, as their
``lax.while_loop`` counterparts (``ops/device_loop.py``: a device flag,
polled without a wait on the eager path, a conditional node in the CUDA
graph), and the keyframe's update count ``N_k`` is a device scalar. Cholesky
failure is read from ``torch.linalg.cholesky_ex``'s ``info`` (JAX signals it
with NaNs) and keeps the same ``ok`` semantics. :class:`FrameTracker` reads
the frame's host decisions once, after the whole computation, as the JAX
tracker reads them after its one program. On the card it runs
:func:`track_core` as one CUDA graph per static shape (:class:`TrackGraphs`,
the counterpart of the JAX package's ``jax.jit`` of it).

Two measurement models, as in the reference:
- uncalibrated: residual ``[unit_ray(3), dist(1)]`` (opt_pose_ray_dist_sim3)
- calibrated:   residual ``[u, v, log z]`` against fixed keyframe pixels
  (opt_pose_calib_sim3)
"""

from __future__ import annotations

import torch

from mast3r_slam_tpu_torch.models import mast3r as M
from mast3r_slam_tpu_torch.models.inference import _decimate
from mast3r_slam_tpu_torch.ops import (device_loop, geometry, graphs, lie,
                                       matching)
from mast3r_slam_tpu_torch.ops.robust import huber
from mast3r_slam_tpu_torch.slam.frame import (Frame, fuse_weighted_spherical,
                                               median)
from mast3r_slam_tpu_torch.utils.tictoc import STEPS


def _normal_7x7(sqrt_info, r, J, huber_k):
    """Whitened-Huber IRLS normal equations → (H (7, 7), g (7,), cost).

    Channels first: ``sqrt_info, r (D, N)``, ``J (D, 7, N)``; the system is
    one ``(7, D*N) @ (D*N, 7)`` product, with the JAX package's row order
    (row k of A is channel 0's pixels, then channel 1's, ...)."""
    rob = sqrt_info * torch.sqrt(huber(sqrt_info * r, huber_k))
    bf = (rob * r).reshape(-1)
    A = (rob[:, None] * J).transpose(0, 1).reshape(7, -1)
    H = A @ A.T
    g = -(A @ bf)
    cost = 0.5 * torch.dot(bf, bf)
    return H, g, cost


def _chol_ok(L, info):
    return (info == 0) & torch.isfinite(L).all()


def _solve_damped_7x7(H, g, lam):
    """Cholesky solve of ``(H + λ·diag(H)) τ = g`` → (tau, chol_ok)."""
    Hd = H + lam * torch.diag(torch.diagonal(H).clamp_min(1e-12))
    Lc, info = torch.linalg.cholesky_ex(Hd)
    ok = _chol_ok(Lc, info)
    eye = torch.eye(7, dtype=H.dtype, device=H.device)
    Lc_safe = torch.where(ok, Lc, eye)
    # two triangular solves (cholesky_solve's potrs allocates inside a CUDA
    # graph's loop body, which a conditional node does not allow)
    y = torch.linalg.solve_triangular(Lc_safe, g[:, None], upper=False)
    tau = torch.linalg.solve_triangular(Lc_safe.T, y, upper=True)[:, 0]
    return torch.where(ok, tau, torch.zeros_like(tau)), ok


def _lm_pose_loop(system, T0, max_iters, rel_error, delta_norm,
                  lam0=1e-8, accept_slack=1e-6):
    """Levenberg-Marquardt accept/reject driver for the 7x7 pose solvers.

    - accept (candidate cost ≤ cost·(1+slack)): keep it, λ ← max(λ0, λ/4);
    - reject: keep the previous iterate, λ ← 10λ, re-solve the same normal
      equations;
    - stop after an accepted step whose relative cost change is below
      ``rel_error`` or whose step norm is below ``delta_norm``, when λ passes
      1e8, or after ``max_iters`` steps.

    ``ok`` is False when the initial system is broken or rank-deficient (its
    undamped Cholesky fails — the reference's singularity signal), when no
    step was ever accepted, or when the final cost is not finite. As the
    JAX ``lax.while_loop``, the loop exits on the device
    (``ops/device_loop.py``): λ, the reference cost, the ``accepted_any``
    flag and the loop's condition are float32 / bool device tensors, updated
    in place by each step. Returns ``(T, ok, iterations)``, ``ok`` a device
    bool and ``iterations`` (the steps taken) a device int."""
    H, g, cost_ref, ok0 = system(T0)
    L0, info0 = torch.linalg.cholesky_ex(H)
    ok0 = ok0 & _chol_ok(L0, info0)
    # the loop's state, updated in place by each step (JAX's carry)
    T_ref, H, g, cost_ref = (t.clone() for t in (T0, H, g, cost_ref))
    lam = torch.full((), lam0, dtype=torch.float32, device=H.device)
    live = torch.ones((), dtype=torch.bool, device=H.device)
    accepted_any = torch.zeros_like(live)
    iters = torch.zeros((), dtype=torch.int64, device=H.device)

    def step():
        tau, chol_ok = _solve_damped_7x7(H, g, lam)
        T_cand = lie.retr(T_ref, tau)
        H_c, g_c, cost_c, sys_ok = system(T_cand)
        accept = (live & chol_ok & sys_ok
                  & (cost_c <= cost_ref * (1.0 + accept_slack)))
        new_cost = torch.where(accept, cost_c, cost_ref)
        rel = ((cost_ref - new_cost) / cost_ref.clamp_min(1e-30)).abs()
        T_ref.copy_(torch.where(accept, T_cand, T_ref))
        H.copy_(torch.where(accept, H_c, H))
        g.copy_(torch.where(accept, g_c, g))
        lam.copy_(torch.where(accept, (lam * 0.25).clamp_min(lam0),
                              torch.where(live, lam * 10.0, lam)))
        done = (accept & ((rel < rel_error)
                          | (torch.linalg.norm(tau) < delta_norm))
                | (lam > 1e8))
        cost_ref.copy_(new_cost)
        accepted_any.copy_(accepted_any | accept)
        iters.add_(live)
        live.copy_(live & ~done)

    device_loop.run(max_iters, live, step)
    return T_ref, ok0 & accepted_any & torch.isfinite(cost_ref), iters


def _ray_dist_channels(X):
    """Channels-first ray+dist residual ``[rx, ry, rz, d] (4, N)`` of
    ``X (N, 3)`` and its Jacobian ``(4, 3, N)``: ``dr/dX = (I - r rᵀ)/d``,
    ``dd/dX = rᵀ``."""
    x, y, z = X.T
    d = torch.sqrt(x * x + y * y + z * z)
    d_inv = 1.0 / d
    r = X.T * d_inv                                          # (3, N)
    eye = torch.eye(3, dtype=X.dtype, device=X.device)[:, :, None]
    jac = torch.cat([d_inv * (eye - r[:, None] * r[None]), r[None]])
    return torch.cat([r, d[None]]), jac


def opt_pose_ray_dist_sim3(Xf, Xk, T_WCf, T_WCk, Qk, valid, sigma_ray,
                           sigma_dist, huber_k, max_iters, rel_error,
                           delta_norm):
    """Uncalibrated pose solve. ``Xf, Xk (N, 3)``; ``Qk, valid (N, 1)``.
    Returns ``(T_WCf (8,), T_CkCf (8,), ok)``."""
    sq = (valid * torch.sqrt(Qk))[:, 0]
    sqrt_ray = (1.0 / sigma_ray) * sq
    sqrt_dist = (1.0 / sigma_dist) * sq
    sqrt_info = torch.stack([sqrt_ray, sqrt_ray, sqrt_ray, sqrt_dist])
    T_CkCf0 = lie.compose(lie.inv(T_WCk), T_WCf)
    rd_k, _ = _ray_dist_channels(Xk)

    def system(T):
        Xf_Ck = lie.act(T, Xf)
        rd_f, drd_dX = _ray_dist_channels(Xf_Ck)
        J = geometry.compose_jac(drd_dX, geometry.point_jac(Xf_Ck),
                                 negate=True)
        H, g, cost = _normal_7x7(sqrt_info, rd_k - rd_f, J, huber_k)
        return H, g, cost, torch.isfinite(cost)

    T_CkCf, ok, _ = _lm_pose_loop(system, T_CkCf0, max_iters, rel_error,
                                  delta_norm)
    return lie.compose(T_WCk, T_CkCf), T_CkCf, ok


def opt_pose_calib_sim3(Xf, Xk, T_WCf, T_WCk, Qk, valid, meas_k,
                        valid_meas_k, K, img_size, sigma_pixel, sigma_depth,
                        huber_k, max_iters, rel_error, delta_norm,
                        pixel_border, depth_eps):
    """Calibrated pose solve against fixed pixel + log-depth measurements."""
    sq = (valid * torch.sqrt(Qk))[:, 0]
    sqrt_pix = (1.0 / sigma_pixel) * sq
    sqrt_dep = (1.0 / sigma_depth) * sq
    meas = meas_k.T                                          # (3, N)
    vmeas = valid_meas_k[:, 0]
    T_CkCf0 = lie.compose(lie.inv(T_WCk), T_WCf)
    fx, fy, cx, cy = geometry.decompose_K(K)
    Himg, Wimg = img_size

    def system(T):
        Xw = lie.act(T, Xf)
        x, y, z = Xw[:, 0], Xw[:, 1], Xw[:, 2]
        valid_z = z > depth_eps
        z_safe = torch.where(valid_z, z, torch.ones_like(z))
        z_inv = 1.0 / z_safe
        u = fx * x * z_inv + cx
        v = fy * y * z_inv + cy
        valid_proj = (valid_z
                      & (u > pixel_border) & (u < Wimg - 1 - pixel_border)
                      & (v > pixel_border) & (v < Himg - 1 - pixel_border))
        logz = torch.where(valid_z, torch.log(z_safe), torch.zeros_like(z))
        r = meas - torch.stack([u, v, logz])
        zero = torch.zeros_like(z_inv)
        dpz_dX = torch.stack([
            torch.stack([fx * z_inv, zero, -fx * x * z_inv * z_inv]),
            torch.stack([zero, fy * z_inv, -fy * y * z_inv * z_inv]),
            torch.stack([zero, zero, z_inv]),
        ])
        J = geometry.compose_jac(dpz_dX, geometry.point_jac(Xw), negate=True)
        gate = (valid_proj & vmeas).to(sq.dtype)
        info2 = torch.stack([sqrt_pix * gate, sqrt_pix * gate,
                             sqrt_dep * gate])
        H, g, cost = _normal_7x7(info2, r, J, huber_k)
        return H, g, cost, torch.isfinite(cost)

    T_CkCf, ok, _ = _lm_pose_loop(system, T_CkCf0, max_iters, rel_error,
                                  delta_norm)
    return lie.compose(T_WCk, T_CkCf), T_CkCf, ok


def pose_magnitude(T):
    """(|t|, rotation angle) of a Sim3."""
    w = T[..., 6].abs().clamp(0.0, 1.0)
    return torch.linalg.norm(T[..., 0:3], dim=-1), 2.0 * torch.acos(w)


def make_scfg(tracking_cfg: dict, matching_cfg: dict) -> tuple:
    """Solver/matcher config tuple for :func:`track_core` (same layout as the
    JAX package's)."""
    c, m = tracking_cfg, matching_cfg
    return (
        float(c["sigma_ray"]), float(c["sigma_dist"]),
        float(c["sigma_pixel"]), float(c["sigma_depth"]),
        float(c["huber"]), int(c["max_iters"]), float(c["rel_error"]),
        float(c["delta_norm"]), float(c["C_conf"]), float(c["Q_conf"]),
        float(c["pixel_border"]), float(c["depth_eps"]),
        int(m.get("max_iter", 10)), float(m.get("lambda_init", 1e-8)),
        float(m.get("convergence_thresh", 1e-6)),
        float(m.get("dist_thresh", 0.1)), int(m.get("radius", 3)),
        # the tracker may use a shallower refine ladder than the backend
        int(m.get("track_dilation_max", m.get("dilation_max", 5))),
        matching.resolve_refine_mode(m), float(m.get("plateau_frac", 0.001)),
        int(m.get("level_step", 1)), int(m.get("proj_step", 1)),
        str(c["filtering_mode"]), str(c.get("filtering_score", "median")),
    )


def track_core(params, mcfg, img, feat_k, pos_k, idx_init, X_k, C_k, N_k,
               T_WCf_init, T_WCk, K, img_hw, use_calib, scfg, model_hw=None,
               graphs=None):
    """The whole per-frame tracking computation (see module docstring).

    ``img (1, H, W, 3)``; keyframe ``feat_k, pos_k (1, Np, ·)``,
    ``X_k (n, 3)``, ``C_k (n, 1)``, ``N_k`` (a float32 0-dim tensor; a
    float is taken onto ``X_k``'s device); ``idx_init (1, n)``. Returns a
    dict of tensors (``ok`` a 0-dim bool, ``N_k_new`` a float32 0-dim
    tensor). With ``graphs`` (a :class:`TrackGraphs`, CUDA inputs) the
    frame runs as that runner's CUDA graph of this computation."""
    args = (params, mcfg, img, feat_k, pos_k, idx_init, X_k, C_k, N_k,
            T_WCf_init, T_WCk, K, img_hw, use_calib, scfg)
    if graphs is not None:
        return graphs(_track_core, *args, model_hw=model_hw)
    return _track_core(*args, model_hw=model_hw)


def _track_core(params, mcfg, img, feat_k, pos_k, idx_init, X_k, C_k, N_k,
                T_WCf_init, T_WCk, K, img_hw, use_calib, scfg, model_hw=None):
    (sigma_ray, sigma_dist, sigma_pixel, sigma_depth, huber_k, max_iters,
     rel_error, delta_norm, C_conf, Q_conf, pixel_border, depth_eps,
     match_max_iter, match_lambda, match_conv, match_dist, match_radius,
     match_dilation, match_refine_mode, match_plateau, match_level_step,
     match_proj_step, filtering_mode, filtering_score) = scfg
    H, W = img_hw
    n = H * W

    # -- model ----------------------------------------------------------------
    mh = model_hw if model_hw is not None else img_hw
    ds = mh[0] // H
    feat_f, pos_f = M.encode_image(params, mcfg, img)
    res_ff, res_kf = M.decode_heads(params, mcfg, feat_f, pos_f, feat_k,
                                    pos_k, tuple(mh))
    res_ff = {k: _decimate(v, ds) for k, v in res_ff.items()}
    res_kf = {k: _decimate(v, ds) for k, v in res_kf.items()}
    Xff = res_ff["pts3d"].reshape(n, 3)
    Cff = res_ff["conf"].reshape(n, 1)
    Qff = res_ff["desc_conf"].reshape(n)
    Xkf = res_kf["pts3d"].reshape(n, 3)
    Ckf = res_kf["conf"].reshape(n, 1)
    Qkf = res_kf["desc_conf"].reshape(n)

    # -- matching -------------------------------------------------------------
    idx_f2k, valid_match = matching.match(
        res_ff["pts3d"], res_kf["pts3d"], res_ff["desc"], res_kf["desc"],
        idx_1_to_2_init=idx_init,
        max_iter=match_max_iter, lambda_init=match_lambda,
        convergence_thresh=match_conv, dist_thresh=match_dist,
        radius=match_radius, dilation_max=match_dilation,
        refine_mode=match_refine_mode, plateau_frac=match_plateau,
        level_step=match_level_step, proj_step=match_proj_step,
    )
    idx0 = idx_f2k[0].clamp(0, n - 1)
    vmatch = valid_match[0]                                   # (n, 1)

    # -- masks ------------------------------------------------------------------
    N_k = torch.as_tensor(N_k, dtype=torch.float32, device=X_k.device)
    Ck_avg = C_k / N_k.clamp_min(1.0)
    Xf_all = Xff
    Xk_can = X_k
    meas_k = valid_meas_k = None
    if use_calib:
        Xf_all = geometry.constrain_points_to_ray(img_hw, Xf_all, K)
        Xk_can = geometry.constrain_points_to_ray(img_hw, Xk_can, K)
        uv_k = geometry.get_pixel_coords(img_hw, dtype=Xf_all.dtype,
                                         device=Xf_all.device)
        valid_meas_k = Xk_can[..., 2:3] > depth_eps
        logz = torch.where(valid_meas_k,
                           torch.log(Xk_can[..., 2:3].clamp_min(1e-12)),
                           torch.zeros_like(Xk_can[..., 2:3]))
        meas_k = torch.where(valid_meas_k, torch.cat([uv_k, logz], dim=-1),
                             torch.zeros(1, 3, device=uv_k.device))

    # one gather at idx0 for every frame-side channel (X, C, Q)
    fch = torch.cat([Xf_all, Cff, Qff[:, None]], dim=-1)[idx0]
    Xf, Cf, Qf = fch[:, 0:3], fch[:, 3:4], fch[:, 4:5]
    Qk = torch.sqrt(Qf * Qkf[:, None])                         # (n, 1)
    valid_opt = vmatch & (Cf > C_conf) & (Ck_avg > C_conf) & (Qk > Q_conf)
    valid_kf = vmatch & (Qk > Q_conf)
    match_frac = valid_opt.float().mean()

    # -- pose solve -------------------------------------------------------------
    if not use_calib:
        T_WCf_new, T_CkCf, ok = opt_pose_ray_dist_sim3(
            Xf, Xk_can, T_WCf_init, T_WCk, Qk, valid_opt.to(Xf.dtype),
            sigma_ray, sigma_dist, huber_k, max_iters, rel_error, delta_norm)
    else:
        T_WCf_new, T_CkCf, ok = opt_pose_calib_sim3(
            Xf, Xk_can, T_WCf_init, T_WCk, Qk, valid_opt.to(Xf.dtype),
            meas_k, valid_meas_k, K, img_hw, sigma_pixel, sigma_depth,
            huber_k, max_iters, rel_error, delta_norm, pixel_border,
            depth_eps)

    # -- keyframe pointmap fusion (frame obs mapped into the keyframe) --------
    Xkk = lie.act(T_CkCf[None], Xkf)
    X_k_new, C_k_new, N_k_new = fuse_pointmap(
        filtering_mode, filtering_score, X_k, C_k, N_k, Xkk, Ckf)

    match_frac_k, unique_frac_f = kf_selection_stats(vmatch, idx0, valid_kf,
                                                     n)
    r_pix, valid_submit, t_norm, theta = quality_job_tensors(
        use_calib, T_CkCf, Xf, Xk_can, valid_kf, meas_k, valid_meas_k, K,
        img_hw, sigma_pixel, sigma_depth)

    return {
        "feat_f": feat_f, "pos_f": pos_f,
        "X_frame": Xff, "C_frame": Cff,
        "idx_f2k": idx_f2k, "valid_match": vmatch,
        "Qk": Qk, "Qkf": Qkf[None, :, None], "Qff": Qff[None, :, None],
        "T_WCf": T_WCf_new, "T_CkCf": T_CkCf, "ok": ok,
        "match_frac": match_frac,
        "X_k_new": X_k_new, "C_k_new": C_k_new, "N_k_new": N_k_new,
        "match_frac_k": match_frac_k, "unique_frac_f": unique_frac_f,
        "Ck_avg": Ck_avg, "r_pix": r_pix, "valid_submit": valid_submit,
        "t_norm": t_norm, "theta": theta,
    }


def fuse_pointmap(filtering_mode, filtering_score, X_k, C_k, N_k, Xkk, Ckf0):
    """Keyframe pointmap fusion, all six reference policies. ``Xkk``: the
    frame's points mapped into the keyframe; ``Ckf0``: their confidences;
    ``N_k`` a float32 0-dim tensor (a float is taken onto ``X_k``'s
    device), and so is the returned count: no policy reads it on the
    host."""
    N_k = torch.as_tensor(N_k, dtype=torch.float32, device=X_k.device)
    if filtering_mode == "weighted_pointmap":
        return ((C_k * X_k + Ckf0 * Xkk) / (C_k + Ckf0), C_k + Ckf0,
                N_k + 1.0)
    if filtering_mode == "weighted_spherical":
        X_new, C_new = fuse_weighted_spherical(X_k, C_k, Xkk, Ckf0)
        return X_new, C_new, N_k + 1.0
    if filtering_mode == "recent":
        return Xkk, Ckf0, torch.ones_like(N_k)
    if filtering_mode == "indep_conf":
        better = Ckf0 > C_k
        return (torch.where(better, Xkk, X_k), torch.where(better, Ckf0, C_k),
                torch.ones_like(N_k))
    if filtering_mode == "first":
        # keep the first post-creation update: N_k == 1 means only the
        # mono-init map exists; N = 2 then blocks later updates
        first = N_k <= 1.0
        return (torch.where(first, Xkk, X_k), torch.where(first, Ckf0, C_k),
                torch.full_like(N_k, 2.0))
    if filtering_mode == "best_score":
        # the stored C is always the winning update's C (N stays 1)
        score = median if filtering_score == "median" else torch.mean
        better = score(Ckf0) > score(C_k / N_k.clamp_min(1.0))
        return (torch.where(better, Xkk, X_k), torch.where(better, Ckf0, C_k),
                torch.ones_like(N_k))
    return X_k, C_k, N_k


def kf_selection_stats(vmatch, idx0, valid_kf, n):
    """Fraction of keyframe pixels matched, and fraction of keyframe pixels
    hit by a unique frame pixel (distinct-target count by sorting)."""
    match_frac_k = valid_kf.float().mean()
    s = torch.where(vmatch[:, 0], idx0, torch.full_like(idx0, -1)).sort()
    s = s.values
    first = (s[:1] >= 0).float()
    new_vals = ((s[1:] != s[:-1]) & (s[1:] >= 0)).float()
    return match_frac_k, (new_vals.sum() + first.sum()) / n


def quality_job_tensors(use_calib, T_CkCf, Xf, Xk_can, valid_kf, meas_k,
                        valid_meas_k, K, img_hw, sigma_pixel, sigma_depth):
    """Per-pixel quality-job residuals + pose magnitude (what the tracker
    submits to the quality service)."""
    Xf_Ck = lie.act(T_CkCf[None], Xf)
    if use_calib:
        pzf, valid_proj = geometry.project_calib(Xf_Ck, K, img_hw)
        d = meas_k - pzf
        lam = (sigma_pixel ** 2) / (sigma_depth ** 2 + 1e-8)
        r_pix = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2
                           + lam * d[..., 2] ** 2)
        valid_submit = (valid_kf & valid_proj & valid_meas_k)[..., 0]
    else:
        rd_k = geometry.point_to_ray_dist(Xk_can)
        rd_f = geometry.point_to_ray_dist(Xf_Ck)
        r_pix = torch.linalg.norm(rd_k - rd_f, dim=-1)
        valid_submit = valid_kf[..., 0]
    t_norm, theta = pose_magnitude(T_CkCf)
    return r_pix, valid_submit, t_norm, theta


class TrackGraphs(graphs.GraphCache):
    """:func:`track_core` as one CUDA graph per static key, replayed every
    frame (``ops/graphs.py``): the counterpart of the JAX package's
    ``jax.jit(track_core, static_argnames=("mcfg", "img_hw", "use_calib",
    "scfg", "model_hw"))``. The key is what that jit is static on, plus the
    device, the inputs' shapes and dtypes and the identity of ``params``.
    The LM loops of the matcher and the pose solve are conditional WHILE
    nodes: two loop nodes a replay.

    The keyframe snapshot (``feat_k``, ``pos_k``, ``X_k``, ``C_k``,
    ``T_WCk``) is the graphs' own: :meth:`snapshot_buffers` hands the
    tracker buffers it copies the keyframe into under the keyframes' lock,
    and every graph reads them in place (``static`` inputs), one copy a
    tensor. A capture's eager call reads them as well; an output of it
    that shares their memory is handed back as a clone, since the next
    frame's snapshot overwrites them."""

    SNAPSHOT = (1, 2, 4, 5, 8)      # inputs: feat_k, pos_k, X_k, C_k, T_WCk

    def __init__(self):
        super().__init__("track")
        self._snapshot = None
        self._snapshot_spec = None

    def snapshot_buffers(self, kfs):
        """``(feat_k (1, Np, D), pos_k (1, Np, 2), X_k (n, 3), C_k (n, 1),
        T_WCk (8,))`` for keyframes like ``kfs``'s, made at first use; a
        keyframe buffer of another geometry gets new ones, and the graphs
        that read the old ones go."""
        spec = tuple((tuple(t.shape[1:]), t.dtype, t.device)
                     for t in (kfs.feat, kfs.pos, kfs.X, kfs.C, kfs.T_WC))
        if spec != self._snapshot_spec:
            for buf in self._snapshot or ():
                self.drop(buf)
            self._snapshot = tuple(
                torch.empty(((1,) if i < 2 else ()) + shape, dtype=dt,
                            device=dev)
                for i, (shape, dt, dev) in enumerate(spec))
            self._snapshot_spec = spec
        return self._snapshot

    def __call__(self, fn, params, mcfg, img, feat_k, pos_k, idx_init, X_k,
                 C_k, N_k, T_WCf_init, T_WCk, K, img_hw, use_calib, scfg,
                 model_hw=None):
        inputs = (img, feat_k, pos_k, idx_init, X_k, C_k, N_k, T_WCf_init,
                  T_WCk, K)
        static = (mcfg, tuple(img_hw), bool(use_calib), scfg,
                  None if model_hw is None else tuple(model_hw))
        snap = self._snapshot is not None and all(
            inputs[i] is b for i, b in zip(self.SNAPSHOT, self._snapshot))

        def run(*args):
            return fn(params, mcfg, *args, img_hw, use_calib, scfg,
                      model_hw=model_hw)

        return self.run(static, run, inputs, owner=params,
                        static=self.SNAPSHOT if snap else ())

    def _capture(self, fn, inputs, static):
        out, graph = super()._capture(fn, inputs, static)
        held = {inputs[i].untyped_storage().data_ptr() for i in static}
        return graphs._map(
            lambda t: (t.clone() if t.untyped_storage().data_ptr() in held
                       else t), out), graph


class FrameTracker:
    """Drives per-frame tracking. ``track(frame)`` returns
    ``(new_kf, match_info, try_reloc)``, as the reference FrameTracker."""

    def __init__(self, model, keyframes, cfg, quality_service=None,
                 graphed=True):
        self.model = model              # models.inference.MASt3RInference
        self.keyframes = keyframes
        self.cfg = cfg["tracking"]
        self.match_cfg = cfg.get("matching", {})
        self.use_calib = cfg["use_calib"]
        self.quality_service = quality_service
        self.idx_f2k = None             # warm-start correspondence
        self._warm_kf_idx = None        # which keyframe idx_f2k converged on
        # (kf_idx, idx_f2k, valid_match, Qk) at the last keyframe creation
        self.last_kf_match = None
        # track_core's CUDA graphs, used when the keyframes are on a card;
        # graphed=False runs it eagerly there (a comparison's reference)
        self.graphs = TrackGraphs() if graphed else None

    def reset_idx_f2k(self):
        self.idx_f2k = None
        self._warm_kf_idx = None

    def track(self, frame: Frame):
        STEPS.mark()
        cfg = self.cfg
        kfs = self.keyframes
        kf_idx = len(kfs) - 1
        # on a card, the graphs' own snapshot buffers (one copy a tensor);
        # eagerly and on the CPU, clones
        snap = (self.graphs.snapshot_buffers(kfs)
                if self.graphs is not None and kfs.device.type == "cuda"
                else None)
        with kfs.lock:
            if snap is None:
                feat_k = kfs.feat[kf_idx][None].clone()
                pos_k = kfs.pos[kf_idx][None].clone()
                X_k = kfs.X[kf_idx].clone()
                C_k = kfs.C[kf_idx].clone()
                T_WCk = kfs.T_WC[kf_idx].clone()
            else:
                feat_k, pos_k, X_k, C_k, T_WCk = snap
                feat_k[0].copy_(kfs.feat[kf_idx])
                pos_k[0].copy_(kfs.pos[kf_idx])
                X_k.copy_(kfs.X[kf_idx])
                C_k.copy_(kfs.C[kf_idx])
                T_WCk.copy_(kfs.T_WC[kf_idx])
            N_k = int(kfs.N[kf_idx])
            kf_frame_id = int(kfs.dataset_idx[kf_idx])
            ver_k = int(kfs.version[kf_idx])
        STEPS.lap("track: snapshot")

        n = kfs.h * kfs.w
        if self._warm_kf_idx is not None and self._warm_kf_idx != kf_idx:
            # a correspondence converged against another keyframe is worse
            # than the identity cold start
            self.reset_idx_f2k()
        idx_init = (self.idx_f2k if self.idx_f2k is not None else
                    torch.arange(n, device=kfs.device)[None])
        K = (kfs.K if self.use_calib
             else torch.eye(3, device=kfs.device))
        img_hw = (kfs.h, kfs.w)
        # a fill, not a host-to-device copy
        N_k = torch.full((), N_k, dtype=torch.float32, device=kfs.device)
        scfg = make_scfg(self.cfg, self.match_cfg)
        STEPS.lap("track: small inputs")

        out = track_core(
            self.model.params, self.model.cfg, frame.img[None], feat_k,
            pos_k, idx_init, X_k, C_k, N_k, frame.T_WC, T_WCk, K, img_hw,
            bool(self.use_calib), scfg, model_hw=tuple(kfs.model_hw),
            graphs=self.graphs if kfs.device.type == "cuda" else None)
        STEPS.lap("track: track_core")
        # the frame's host decisions, in one device-to-host read
        match_frac, ok, match_frac_k, unique_frac_f, N_k_new = torch.stack([
            out["match_frac"], out["ok"].float(), out["match_frac_k"],
            out["unique_frac_f"], out["N_k_new"]]).tolist()
        STEPS.lap("track: decision read")

        self.idx_f2k = out["idx_f2k"]
        self._warm_kf_idx = kf_idx
        frame.feat = out["feat_f"]
        frame.pos = out["pos_f"]
        frame.X_canon = out["X_frame"]
        frame.C = out["C_frame"]
        frame.N = frame.N_updates = 1

        if match_frac < cfg["min_match_frac"]:
            print(f"Skipped frame {frame.frame_id}")
            STEPS.lap("track: rest")
            return False, [], True
        if not ok:
            print(f"Cholesky failed {frame.frame_id}")
            STEPS.lap("track: rest")
            return False, [], True

        self._submit_quality(out, kf_idx, kf_frame_id, img_hw)

        frame.T_WC = out["T_WCf"]

        # fusion write-back, version-checked: a write that landed between
        # our snapshot and now wins over this (stale-based) fusion
        with kfs.lock:
            if int(kfs.version[kf_idx]) == ver_k:
                kfs.X[kf_idx] = out["X_k_new"]
                kfs.C[kf_idx] = out["C_k_new"]
                kfs.N[kf_idx] = int(N_k_new)
                kfs.N_updates[kf_idx] += 1
                kfs.is_dirty[kf_idx] = True
                kfs.version[kf_idx] += 1
                kfs.xc_version[kf_idx] += 1

        # keyframe selection: low coverage in either direction → new KF
        new_kf = min(match_frac_k, unique_frac_f) < cfg["match_frac_thresh"]
        if new_kf:
            # when this frame becomes keyframe kf_idx+1, the backend reuses
            # its converged match as the consecutive edge's whole j→i
            # direction; the fused Qk is that direction's Q channel
            self.last_kf_match = (kf_idx, out["idx_f2k"], out["valid_match"],
                                  out["Qk"])
            self.reset_idx_f2k()
        STEPS.lap("track: rest")
        return (new_kf,
                [out["X_k_new"], out["C_k_new"], frame.X_canon, frame.C,
                 out["Qkf"], out["Qff"]],
                False)

    def _submit_quality(self, out, kf_idx, kf_frame_id, img_hw):
        """Enqueue the quality job from :func:`track_core`'s outputs; no-op
        without a quality service. The job holds the device tensors
        themselves, with no host sync: they are this frame's own outputs
        (on the card, clones of the graph's, which its next replay
        overwrites), which nothing writes afterwards."""
        if self.quality_service is None:
            return
        try:
            H, W = img_hw
            self.quality_service.submit({
                "kf_id": kf_idx, "frame_id": kf_frame_id, "H": H, "W": W,
                "valid_kf": out["valid_submit"],
                "r_pix": out["r_pix"].reshape(-1),
                "Ck": out["Ck_avg"].reshape(-1),
                "Qk": out["Qk"].reshape(-1),
                "t_norm": out["t_norm"], "theta": out["theta"],
            })
        except Exception as e:  # quality is best-effort; never break tracking
            print(f"ERROR in quality submission: {e}")
