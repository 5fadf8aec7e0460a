"""Analytic oracle scene: exact multi-view-consistent pointmaps + descriptors.

End-to-end validation tool for the SLAM math (matcher modes, Sim(3) GN pose
solve, factor-graph BA) with KNOWN ground truth: a smooth analytic height
field is ray-cast exactly from any camera pose, so every frame's pointmap,
every cross-view pointmap ("keyframe seen from the frame's coordinates" —
what the two-view network predicts), and every ground-truth correspondence
is available in closed form. Controlled noise stands in for network
prediction error.

This isolates exactly the part of the system the speed-motivated matcher
deviations touch (`matching.refine_mode`, `level_step`, `plateau_frac` —
PARITY.md): with oracle inputs, any trajectory-error difference between
strict reference settings and the production fast settings is attributable
to the matcher semantics, not to the network. The scene itself is numpy;
:func:`run_oracle_slam` drives the port's matcher, pose solvers and
factor-graph BA on it, on the card unless the caller asks for the CPU.

Conventions match the framework: OpenCV camera (+z forward), Sim(3) poses
``[t, q(xyzw), s]`` (ops/lie.py), pointmaps row-major ``(H*W, 3)``.
"""

from __future__ import annotations

import numpy as np


class OracleScene:
    """Smooth height-field world ``z = f(x, y)`` with an analytic descriptor
    field on the surface. All math is float64 numpy for exactness; outputs
    are float32."""

    def __init__(self, seed=0, desc_dim=24, base_depth=2.5):
        rng = np.random.default_rng(seed)
        self.base = base_depth
        # relief must be genuinely 3D: a near-planar world leaves the Sim(3)
        # system with weak scale/normal-translation modes and the (reference-
        # parity, undamped) GN pose solver can spiral on them — real scenes
        # don't have this degeneracy. |∇f| stays < ~1 in the typical case so
        # the Newton ray-cast converges for mostly-forward rays.
        self.amps = rng.uniform(0.1, 0.22, 4)
        self.freqs = rng.uniform(0.5, 1.3, (4, 2))
        self.phases = rng.uniform(0, 2 * np.pi, 4)
        # descriptor field: desc_dim sinusoids over the surface, with a
        # log-spread of spatial frequencies (low channels disambiguate the
        # coarse window levels, high channels give per-pixel discrimination
        # like trained local features do)
        self.dfreq = np.exp(rng.uniform(np.log(1.0), np.log(24.0),
                                        (desc_dim, 2)))
        self.dphase = rng.uniform(0, 2 * np.pi, desc_dim)

    # -- surface ------------------------------------------------------------
    def height(self, x, y):
        z = np.full(np.broadcast(x, y).shape, self.base, np.float64)
        for a, (fx, fy), p in zip(self.amps, self.freqs, self.phases):
            z = z + a * np.sin(fx * x + fy * y + p)
        return z

    def height_grad(self, x, y):
        gx = np.zeros(np.broadcast(x, y).shape, np.float64)
        gy = np.zeros_like(gx)
        for a, (fx, fy), p in zip(self.amps, self.freqs, self.phases):
            c = a * np.cos(fx * x + fy * y + p)
            gx += fx * c
            gy += fy * c
        return gx, gy

    def descriptors(self, hits):
        """L2-normalized descriptors at world points ``hits (N, 3)``."""
        x, y = hits[:, 0:1], hits[:, 1:2]
        d = np.sin(x * self.dfreq[:, 0] + y * self.dfreq[:, 1] + self.dphase)
        d /= np.linalg.norm(d, axis=-1, keepdims=True) + 1e-12
        return d.astype(np.float32)

    # -- cameras ------------------------------------------------------------
    @staticmethod
    def intrinsics(hw, fov_scale=1.1):
        H, W = hw
        f = fov_scale * max(H, W)
        K = np.array([[f, 0, (W - 1) / 2.0],
                      [0, f, (H - 1) / 2.0],
                      [0, 0, 1.0]], np.float64)
        return K

    def raycast(self, T_WC, K, hw, newton_iters=25):
        """Exact pointmap from Sim(3) pose ``T_WC (8,)``.

        Returns ``(X_cam (H*W, 3) float32, hits_world (H*W, 3) float64)``.
        Solves ``o_z + t d_z = f(o_x + t d_x, o_y + t d_y)`` per pixel by
        Newton; with ``d_z`` bounded below by the FOV and ``|∇f| < 1`` the
        iteration is a contraction (validated to <1e-9 residual in tests).
        """
        H, W = hw
        R, tvec, s = _pose_Rts(T_WC)
        u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                           np.arange(H, dtype=np.float64), indexing="xy")
        d_cam = np.stack([(u - K[0, 2]) / K[0, 0],
                          (v - K[1, 2]) / K[1, 1],
                          np.ones_like(u)], axis=-1).reshape(-1, 3)
        d_w = d_cam @ R.T                         # row i = R @ d_cam[i]
        o = tvec                                  # camera center in world
        t = np.full(d_w.shape[0], self.base - o[2], np.float64)
        t = np.maximum(t / np.maximum(d_w[:, 2], 0.2), 0.1)
        for _ in range(newton_iters):
            px = o[0] + t * d_w[:, 0]
            py = o[1] + t * d_w[:, 1]
            pz = o[2] + t * d_w[:, 2]
            g = pz - self.height(px, py)
            gx, gy = self.height_grad(px, py)
            dg = d_w[:, 2] - gx * d_w[:, 0] - gy * d_w[:, 1]
            t = t - g / np.maximum(dg, 0.2)
        hits = o[None, :] + t[:, None] * d_w
        X_cam = self.world_to_cam(hits, T_WC)
        return X_cam.astype(np.float32), hits

    @staticmethod
    def world_to_cam(P_w, T_WC):
        """``T_WC^{-1} · P_w`` in numpy."""
        R, tvec, s = _pose_Rts(T_WC)
        return ((P_w - tvec) @ R) / s

    @staticmethod
    def project(P_cam, K, hw):
        """Linear pixel indices of camera-frame points; ``valid`` marks
        in-image, in-front points."""
        H, W = hw
        z = P_cam[:, 2]
        ok = z > 1e-6
        zs = np.where(ok, z, 1.0)
        uu = K[0, 0] * P_cam[:, 0] / zs + K[0, 2]
        vv = K[1, 1] * P_cam[:, 1] / zs + K[1, 2]
        ui = np.clip(np.round(uu).astype(np.int64), 0, W - 1)
        vi = np.clip(np.round(vv).astype(np.int64), 0, H - 1)
        ok &= (uu >= -0.5) & (uu < W - 0.5) & (vv >= -0.5) & (vv < H - 0.5)
        return ui + W * vi, ok


def _pose_Rts(T_WC):
    """Pure-numpy pose decompose."""
    T = np.asarray(T_WC, np.float64)
    x, y, z, w = T[3:7] / np.linalg.norm(T[3:7])
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])
    return R, T[0:3], float(T[7])


def make_trajectory(n_frames, seed=1, loop=True, rot_amp=0.06,
                    trans_amp=(0.45, 0.3, 0.12)):
    """Smooth Sim(3) camera path (scale 1) that returns near its start.

    Rotations stay small (<~4°) so the whole surface remains in view; the
    path's second half retraces toward the start so a loop-closure edge
    (first keyframe, last keyframe) is geometrically meaningful.
    """
    rng = np.random.default_rng(seed)
    ph = rng.uniform(0, 2 * np.pi, 3)
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * i / n_frames if loop else np.pi * i / n_frames
        t = np.array([trans_amp[0] * np.sin(th),
                      trans_amp[1] * np.sin(th) * np.cos(th),
                      trans_amp[2] * np.sin(2 * th)])
        ang = np.array([rot_amp * np.sin(th + ph[0]),
                        rot_amp * np.sin(2 * th + ph[1]),
                        0.5 * rot_amp * np.sin(th + ph[2])])
        q = _euler_to_quat(ang)
        poses.append(np.concatenate([t, q, [1.0]]).astype(np.float32))
    return poses


def _euler_to_quat(ang):
    """xyz-intrinsic small-angle Euler → xyzw quaternion."""
    hx, hy, hz = ang / 2.0
    qx = np.array([np.sin(hx), 0, 0, np.cos(hx)])
    qy = np.array([0, np.sin(hy), 0, np.cos(hy)])
    qz = np.array([0, 0, np.sin(hz), np.cos(hz)])

    def mul(a, b):
        x1, y1, z1, w1 = a
        x2, y2, z2, w2 = b
        return np.array([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ])

    return mul(mul(qx, qy), qz)


def run_oracle_slam(scene, poses, hw, mode, noise_seed=0, kf_every=4,
                    sigma_point=0.003, sigma_desc=0.02, ba_iters=30,
                    sigma_ray=0.003, sigma_dist=10.0, use_calib=False,
                    sigma_pixel=1.0, sigma_depth=10.0, debug=False,
                    device="cuda"):
    """Frame-to-keyframe tracking and keyframe BA over oracle inputs with
    the port's production math (``ops/matching.py``, the tracker's Sim(3)
    solvers, ``slam/factor_graph.py`` with K4 / K5), the network replaced by
    exact geometry plus controlled noise.

    ``mode``: the matcher knobs (``refine_mode``, ``level_step``,
    ``plateau_frac``, ``radius``, ``proj_step``, ``track_*`` overrides) and
    the BA ones (``ba_pixel_step``, ``ba_meas_dtype``, ``ba_compute_dtype``,
    ``ba_delta_norm``). ``use_calib`` switches the frame solve and the BA to
    the calibrated residuals with the scene's exact intrinsics. Returns the
    keyframe ATE before and after BA, the mean matched-pixel error against
    the ground-truth correspondence, the keyframe poses, and ``ba_problem``:
    the BA's inputs (poses, channels, edges) for rebuilding its system."""
    import torch

    from mast3r_slam_tpu_torch.ops import geometry, matching
    from mast3r_slam_tpu_torch.slam import factor_graph as FG
    from mast3r_slam_tpu_torch.slam.tracker import (opt_pose_calib_sim3,
                                                     opt_pose_ray_dist_sim3)

    dev = torch.device(device)
    H, W = hw
    n = H * W
    K = scene.intrinsics(hw)
    rng = np.random.default_rng(noise_seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    # oracle per-frame data (noise emulates network prediction error:
    # additive 3D noise scaled by depth, descriptor jitter re-normalized)
    Xs, Ds, hits_all = [], [], []
    for T in poses:
        X, hits = scene.raycast(T, K, hw)
        z = X[:, 2:3]
        Xn = X + (sigma_point * z * rng.standard_normal(X.shape)
                  ).astype(np.float32)
        D = scene.descriptors(hits)
        Dn = D + sigma_desc * rng.standard_normal(D.shape).astype(np.float32)
        Dn /= np.linalg.norm(Dn, axis=-1, keepdims=True) + 1e-12
        Xs.append(Xn)
        Ds.append(Dn)
        hits_all.append(hits)

    match_kw = dict(
        radius=int(mode.get("radius", 3)),
        dilation_max=int(mode.get("dilation_max", 5)),
        max_iter=int(mode.get("max_iter", 10)),
        refine_mode=mode.get("refine_mode", "plus"),
        level_step=int(mode.get("level_step", 2)),
        plateau_frac=float(mode.get("plateau_frac", 0.001)),
        proj_step=int(mode.get("proj_step", 1)),
    )
    # tracker-only overrides (``track_*`` keys): the warm-started tracker may
    # use a shallower refine ladder than the cold-start backend edges
    track_kw = dict(match_kw)
    for k_ in ("radius", "dilation_max", "max_iter", "level_step",
               "proj_step"):
        if f"track_{k_}" in mode:
            track_kw[k_] = int(mode[f"track_{k_}"])

    Kt = t(K)

    def step(f, k, Xkf_in_f, T_init, T_k, idx_init):
        Xff, Xk_can = t(Xs[f]), t(Xs[k])
        idx, valid = matching.match(
            Xff.reshape(1, H, W, 3), t(Xkf_in_f).reshape(1, H, W, 3),
            t(Ds[f]).reshape(1, H, W, -1), t(Ds[k]).reshape(1, H, W, -1),
            idx_1_to_2_init=idx_init[None], **track_kw)
        idx0 = idx[0]
        Qk = torch.full((n, 1), 2.0, device=dev)
        vm = valid[0].float()
        if use_calib:
            # track_core's calib branch: ray-constrained pointmaps, fixed
            # [u, v, log z] measurements from the keyframe canonical map
            Xf = geometry.constrain_points_to_ray(hw, Xff, Kt)[idx0]
            Xk_c = geometry.constrain_points_to_ray(hw, Xk_can, Kt)
            uv_k = geometry.get_pixel_coords(hw, device=dev)
            valid_meas = Xk_c[..., 2:3] > 1e-6
            logz = torch.where(valid_meas,
                               torch.log(Xk_c[..., 2:3].clamp_min(1e-12)),
                               torch.zeros_like(Xk_c[..., 2:3]))
            meas_k = torch.where(valid_meas, torch.cat([uv_k, logz], dim=-1),
                                 torch.zeros(1, 3, device=dev))
            T_new, _, ok = opt_pose_calib_sim3(
                Xf, Xk_c, T_init, T_k, Qk, vm, meas_k, valid_meas, Kt, hw,
                sigma_pixel, sigma_depth, 1.345, 50, 1e-3, 1e-3, -10, 1e-6)
        else:
            T_new, _, ok = opt_pose_ray_dist_sim3(
                Xff[idx0], Xk_can, T_init, T_k, Qk, vm, sigma_ray,
                sigma_dist, 1.345, 50, 1e-3, 1e-3)
        return idx0, valid[0, :, 0], T_new, ok

    def cross_map(k_hits, T_frame):
        X = scene.world_to_cam(k_hits, T_frame).astype(np.float32)
        return X + (sigma_point * X[:, 2:3]
                    * rng.standard_normal(X.shape)).astype(np.float32)

    def ident():
        return torch.arange(n, device=dev)

    # -- tracking ------------------------------------------------------------
    kf_ids = [0]
    T_kf_est = [np.asarray(poses[0])]            # gauge: first pose is GT
    T_prev = t(poses[0])
    idx_warm = ident()
    k = 0
    promote_due = False
    pix_err_sum, pix_err_cnt = 0.0, 0
    n_skipped = 0
    n_relocs = 0
    for f in range(1, len(poses)):
        # cadence flag set before the solve so a skipped boundary frame
        # still promotes the next successfully tracked frame
        promote_due = promote_due or (f % kf_every == 0)
        Xkf_in_f = cross_map(hits_all[k], poses[f])
        idx0, vm, T_new, ok = step(f, k, Xkf_in_f, T_prev, t(T_kf_est[-1]),
                                   idx_warm)
        gt_idx, gt_ok = scene.project(
            scene.world_to_cam(hits_all[k], poses[f]), K, hw)
        idx_np = idx0.cpu().numpy()
        sel = vm.cpu().numpy() & gt_ok
        if sel.any():
            d = (np.abs(idx_np[sel] % W - gt_idx[sel] % W)
                 + np.abs(idx_np[sel] // W - gt_idx[sel] // W))
            pix_err_sum += float(d.sum())
            pix_err_cnt += int(sel.sum())
        if not ok:
            if debug:
                print(f"  frame {f} vs kf {k}: first attempt failed",
                      flush=True)
            # solver failure → relocalization: re-match from identity and
            # solve from the keyframe pose
            idx0, vm, T_new, ok = step(f, k, Xkf_in_f, t(T_kf_est[-1]),
                                       t(T_kf_est[-1]), ident())
            if not ok:
                if debug:
                    print(f"  frame {f} vs kf {k}: reloc retry failed too",
                          flush=True)
                n_skipped += 1
                continue
            n_relocs += 1
        T_prev = T_new
        idx_warm = idx0
        # promotion happens on a successfully tracked frame
        if promote_due:
            kf_ids.append(f)
            T_kf_est.append(T_new.cpu().numpy())
            k = f
            idx_warm = ident()
            promote_due = False

    # -- keyframe BA with a loop-closure edge --------------------------------
    # loop partner chosen by ground-truth view overlap
    m = len(kf_ids)
    best_pair, best_ov = None, 0.0
    for a in range(max(m - m // 3, 1), m):
        for b in range(min(m // 3 + 1, m)):
            if abs(a - b) <= 1:
                continue
            Xab = scene.world_to_cam(hits_all[kf_ids[a]], poses[kf_ids[b]])
            _, ok_ab = scene.project(Xab, K, hw)
            if ok_ab.mean() > best_ov:
                best_ov, best_pair = ok_ab.mean(), (a, b)
    pairs = [(a, a + 1) for a in range(m - 1)]
    if best_pair is not None and best_ov > 0.4:
        pairs.append(best_pair)
    ii_l, jj_l, idx_l, val_l = [], [], [], []
    for (a, b) in pairs:
        for (i, j) in ((a, b), (b, a)):
            fi, fj = kf_ids[i], kf_ids[j]
            Xj_in_i = cross_map(hits_all[fj], poses[fi])
            idx, valid = matching.match(
                t(Xs[fi]).reshape(1, H, W, 3), t(Xj_in_i).reshape(1, H, W, 3),
                t(Ds[fi]).reshape(1, H, W, -1),
                t(Ds[fj]).reshape(1, H, W, -1), **match_kw)
            if float(valid.float().mean()) < 0.2:
                continue          # production min-match gate on new factors
            ii_l.append(i)
            jj_l.append(j)
            idx_l.append(idx[0])
            val_l.append(valid[0])

    gt_kf = [poses[f] for f in kf_ids]
    out = {
        "kf_ids": kf_ids, "n_skipped": n_skipped, "n_relocs": n_relocs,
        "ate_track": ate_rmse_points(T_kf_est, gt_kf),
        "mean_pix_err": pix_err_sum / max(pix_err_cnt, 1),
        "T_kf_track": np.stack(T_kf_est),
    }
    if not ii_l:
        out.update(ate_ba=out["ate_track"], T_kf_ba=np.stack(T_kf_est),
                   ba_problem=None)
        return out
    # the JAX harness pads the edges to a multiple of 8 with masked rows;
    # masked rows add exact zeros, so the port solves the edges alone
    ii = t(ii_l, torch.long)
    jj = t(jj_l, torch.long)
    E = len(ii_l)
    mask_e = torch.ones(E, device=dev)
    X_all = t(np.stack([Xs[f] for f in kf_ids]))
    Cavg = torch.ones(m, n, 1, device=dev)
    Q_e = torch.full((E, n, 1), 2.0, device=dev)
    free = t(np.arange(m) > 0, torch.bool)
    T_in = t(np.stack(T_kf_est))
    idx_e = torch.stack(idx_l)
    val_e = torch.stack(val_l)
    # ``ba_delta_norm``: early exit on an accepted step's ‖dx‖ (1e-8, the
    # reference, effectively never fires); ``ba_compute_dtype``: the Gram's
    # row type; ``ba_meas_dtype``: the channels' storage type
    ba_delta = float(mode.get("ba_delta_norm", 1e-8))
    ba_cdt = str(mode.get("ba_compute_dtype", "bfloat16"))
    pstep = int(mode.get("ba_pixel_step", 1))
    if use_calib:
        # the reference constrains every pointmap through the pixel rays
        # before the calib solve (global_opt.py:145-150)
        X_all = geometry.constrain_points_to_ray(hw, X_all, Kt)
        meas = FG.precompute_meas_calib(X_all, Cavg, ii, jj, idx_e, val_e,
                                        Q_e, W, 1e-6, 0.0, 1.5,
                                        pixel_step=pstep)
    else:
        meas = FG.precompute_meas_rays(X_all, Cavg, ii, jj, idx_e, val_e,
                                       Q_e, 0.0, 1.5, pixel_step=pstep)
    if mode.get("ba_meas_dtype") == "bfloat16":
        meas = tuple(ch.to(torch.bfloat16) for ch in meas)
    if use_calib:
        T_out, iters = FG.gauss_newton_calib(
            T_in, meas, Kt, ii, jj, mask_e, free, hw, -10, 1e-6, sigma_pixel,
            sigma_depth, ba_iters, ba_delta, compute_dtype=ba_cdt)
    else:
        T_out, iters = FG.gauss_newton_rays(
            T_in, meas, ii, jj, mask_e, free, sigma_ray, sigma_dist,
            ba_iters, ba_delta, compute_dtype=ba_cdt)
    T_out = T_out.cpu().numpy()
    out.update(
        ate_ba=ate_rmse_points(list(T_out), gt_kf), T_kf_ba=T_out,
        ba_problem=dict(kind="calib" if use_calib else "rays", T=T_in,
                        meas=meas, ii=ii, jj=jj, mask=mask_e, free=free,
                        K=Kt, hw=tuple(hw), iters=int(iters),
                        sigmas=((sigma_pixel, sigma_depth) if use_calib
                                else (sigma_ray, sigma_dist)),
                        compute_dtype=ba_cdt, max_iter=ba_iters,
                        delta=ba_delta))
    return out


def ate_rmse_points(est, gt, with_scale=True):
    """ATE RMSE between pose positions after Umeyama alignment."""
    from mast3r_slam_tpu_torch.evaluation import umeyama_alignment

    P = np.asarray([p[:3] for p in est], np.float64)
    G = np.asarray([g[:3] for g in gt], np.float64)
    s, R, t = umeyama_alignment(P, G, with_scale=with_scale)
    P2 = s * (P @ R.T) + t
    return float(np.sqrt(np.mean(np.sum((P2 - G) ** 2, axis=-1))))


# ---------------------------------------------------------------------------
# Relocalization episode on the oracle scene
# ---------------------------------------------------------------------------

class OracleWorld:
    """Per-frame oracle observations and a stand-in for the model's
    ``match_symmetric``, for the relocalization episode of the JAX
    package's ``tests/test_oracle_reloc.py``: exact pointmaps and
    descriptors replace the network, and the real matcher, factor graph and
    retrieval run on them. A frame's retrieval tokens are the scene
    descriptors at its 16x16 patch centres; a keyframe is recognised by its
    tokens."""

    def __init__(self, hw, seed=0, desc_dim=24, device="cuda"):
        self.hw = tuple(hw)
        self.desc_dim = desc_dim
        self.device = device
        self.scene = OracleScene(seed=seed, desc_dim=desc_dim)
        self.K = self.scene.intrinsics(self.hw)
        self.frames = {}

    @property
    def n_tokens(self):
        return (self.hw[0] // 16) * (self.hw[1] // 16)

    def observe(self, fid, T_WC):
        H, W = self.hw
        X_cam, hits = self.scene.raycast(T_WC, self.K, self.hw)
        D = self.scene.descriptors(hits)
        centers = [(r * 16 + 8) * W + (c * 16 + 8)
                   for r in range(H // 16) for c in range(W // 16)]
        self.frames[fid] = dict(pose=np.asarray(T_WC), X_cam=X_cam,
                                hits=hits, D=D, tokens=D[centers])
        return self.frames[fid]

    def make_frame(self, fid, T_est=None):
        import torch

        from mast3r_slam_tpu_torch.slam.frame import Frame

        H, W = self.hw
        dev = self.device
        ob = self.frames[fid]
        fr = Frame(frame_id=fid, img=torch.zeros(H, W, 3, device=dev),
                   img_shape=self.hw, img_true_shape=self.hw,
                   uimg=np.zeros((H, W, 3), np.float32))
        fr.X_canon = torch.as_tensor(ob["X_cam"], device=dev)
        fr.C = torch.ones(H * W, 1, device=dev)
        fr.feat = torch.as_tensor(ob["tokens"], device=dev)[None]
        fr.pos = torch.zeros(1, self.n_tokens, 2, dtype=torch.int32,
                             device=dev)
        fr.N = 1
        fr.T_WC = torch.as_tensor(
            np.array(ob["pose"] if T_est is None else T_est, np.float32),
            device=dev)
        return fr

    def _lookup(self, feat):
        f = feat.detach().float().cpu().numpy()
        best, best_d = None, np.inf
        for fid, ob in self.frames.items():
            d = float(np.abs(f - ob["tokens"]).sum())
            if d < best_d:
                best, best_d = fid, d
        return best

    def match_symmetric(self, feat_i, pos_i, feat_j, pos_j, img_hw,
                        init_i2j=None, init_j2i=None):
        """The model interface ``FactorGraph.add_factors`` calls: the cross
        pointmaps are the other frame's surface seen in this camera; Q is 2
        everywhere."""
        import torch

        from mast3r_slam_tpu_torch.ops import matching

        H, W = self.hw
        b = feat_i.shape[0]
        X11, X21, D11, D21 = [], [], [], []
        pairs = [(self._lookup(feat_i[e]), self._lookup(feat_j[e]))
                 for e in range(b)]
        for own, other in pairs + [(j, i) for i, j in pairs]:
            oo, ot = self.frames[own], self.frames[other]
            X11.append(oo["X_cam"])
            X21.append(self.scene.world_to_cam(ot["hits"], oo["pose"])
                       .astype(np.float32))
            D11.append(oo["D"])
            D21.append(ot["D"])

        def dev(a, c):
            return torch.as_tensor(np.stack(a), device=self.device).reshape(
                2 * b, H, W, c)

        idx, valid = matching.match(dev(X11, 3), dev(X21, 3),
                                    dev(D11, self.desc_dim),
                                    dev(D21, self.desc_dim), radius=2,
                                    level_step=2)
        Q = torch.full((b, H * W, 1), 2.0, device=self.device)
        return (idx[:b], idx[b:], valid[:b], valid[b:], Q, Q, Q, Q)
