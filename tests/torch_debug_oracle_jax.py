"""``scripts/debug_oracle_fail.py``'s loop as functions, for the port's
``bench/debug_oracle_fail.py`` tests: the frames and draws of the script
(the JAX package's oracle scene, one ``np.random.default_rng(0)``), a
frame count and size of the caller's, an optional NaN block planted in one
frame's pointmap as the port's ``--nan-frame`` plants it, and the
per-frame ``ok`` record. The script runs at import (96 frames), so it is
copied, not imported."""

import jax.numpy as jnp
import numpy as np

from mast3r_slam_tpu.ops import geometry, lie, matching
from mast3r_slam_tpu.slam.tracker import (_normal_7x7, _ray_dist_channels,
                                          _solve_damped_7x7,
                                          opt_pose_ray_dist_sim3)
from mast3r_slam_tpu.utils.oracle_scene import OracleScene, make_trajectory

MODE = dict(radius=3, dilation_max=5, refine_mode="joint", level_step=1,
            plateau_frac=0.0)


def lm_rows(Xf, Xk, valid, T_prev, T_k):
    """The script's eager LM replay of one solve: ``(init cost, rows)``,
    a row ``(lam, chol_ok, cost, cost_cand, accepted, taunorm)``."""
    n = Xf.shape[0]
    sq = (valid.astype(jnp.float32) * jnp.sqrt(jnp.full((n, 1), 2.0)))[:, 0]
    sqrt_info = [(1 / 0.003) * sq] * 3 + [(1 / 10.0) * sq]
    rd_k, _ = _ray_dist_channels(Xk)

    def system(T):
        Xf_Ck = lie.act(T, Xf)
        rd_f, drd = _ray_dist_channels(Xf_Ck)
        r = [rd_k[i] - rd_f[i] for i in range(4)]
        J = geometry.compose_jac_channels(
            drd, geometry.point_jac_channels(Xf_Ck), negate=True)
        return _normal_7x7(sqrt_info, r, J, 1.345)

    T = lie.compose(lie.inv(T_k), T_prev)
    Hm, g, c = system(T)
    init = float(c)
    lam, rows = 1e-8, []
    for _ in range(25):
        tau, chol_ok = _solve_damped_7x7(Hm, g, lam)
        T_cand = lie.retr(T, tau)
        H2, g2, c2 = system(T_cand)
        acc = bool(chol_ok) and float(c2) <= float(c) * (1 + 1e-6)
        rows.append((lam, bool(chol_ok), float(c), float(c2), acc,
                     float(jnp.linalg.norm(tau))))
        if acc:
            T, Hm, g, c = T_cand, H2, g2, c2
            lam = max(1e-8, lam * 0.25)
        else:
            lam *= 10
    return init, rows


def run(n_frames, hw, nan_frame=None):
    """The script's replay: ``{"ok", "failure", "init_cost", "rows",
    "first_inputs"}``, the last the first tracked frame's solve inputs
    (``Xf, Xk, valid, T_prev, T_k`` as numpy arrays)."""
    H, W = hw
    n = H * W
    scene = OracleScene(seed=0)
    poses = make_trajectory(n_frames)
    K = scene.intrinsics((H, W))
    rng = np.random.default_rng(0)
    Xs, Ds, hits_all = [], [], []
    for T in poses:
        X, hits = scene.raycast(T, K, (H, W))
        Xs.append(X + (0.003 * X[:, 2:3]
                       * rng.standard_normal(X.shape)).astype(np.float32))
        D = scene.descriptors(hits)
        D = D + 0.02 * rng.standard_normal(D.shape).astype(np.float32)
        Ds.append((D / (np.linalg.norm(D, axis=-1, keepdims=True) + 1e-12)
                   ).astype(np.float32))
        hits_all.append(hits)
    if nan_frame is not None:
        Xs[nan_frame][:n // 4] = np.nan

    def cross(k, f):
        X = scene.world_to_cam(hits_all[k], poses[f]).astype(np.float32)
        return X + (0.003 * X[:, 2:3]
                    * rng.standard_normal(X.shape)).astype(np.float32)

    T_prev = jnp.asarray(poses[0])
    k = 0
    T_k = jnp.asarray(poses[0])
    idx_warm = jnp.arange(n, dtype=jnp.int32)
    out = {"ok": [], "failure": None, "init_cost": None, "rows": [],
           "first_inputs": None}
    for f in range(1, n_frames):
        Xkf = cross(k, f)
        idx, valid = matching.match(
            jnp.asarray(Xs[f]).reshape(1, H, W, 3),
            jnp.asarray(Xkf).reshape(1, H, W, 3),
            jnp.asarray(Ds[f]).reshape(1, H, W, -1),
            jnp.asarray(Ds[k]).reshape(1, H, W, -1),
            idx_1_to_2_init=idx_warm[None], **MODE)
        Xf = jnp.asarray(Xs[f])[idx[0]]
        if out["first_inputs"] is None:
            out["first_inputs"] = tuple(np.asarray(a) for a in (
                Xf, Xs[k], valid[0], T_prev, T_k))
        T_new, _, ok = opt_pose_ray_dist_sim3(
            Xf, jnp.asarray(Xs[k]), T_prev, T_k, jnp.full((n, 1), 2.0),
            valid[0].astype(jnp.float32), 0.003, 10.0, 1.345, 50, 1e-3,
            1e-3)
        out["ok"].append(bool(ok))
        if not bool(ok):
            out["failure"] = [f, k]
            out["init_cost"], out["rows"] = lm_rows(
                Xf, jnp.asarray(Xs[k]), valid[0], T_prev, T_k)
            break
        T_prev = T_new
        idx_warm = idx[0]
        if f % 4 == 0:
            k = f
            T_k = T_new
            idx_warm = jnp.arange(n, dtype=jnp.int32)
    return out
