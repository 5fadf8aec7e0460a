"""Port parity: the tracker's pose solvers, pointmap fusion, keyframe
statistics and the whole per-frame ``track_core`` vs the JAX package."""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import mast3r as JM
from mast3r_slam_tpu.models.inference import _mono_core as j_mono_core
from mast3r_slam_tpu.ops import lie as JL
from mast3r_slam_tpu.slam import tracker as JT
from mast3r_slam_tpu.utils.config import resolve_config
from mast3r_slam_tpu_torch.models import mast3r as TM
from mast3r_slam_tpu_torch.models.inference import (MASt3RInference,
                                                    _mono_core as t_mono_core)
from mast3r_slam_tpu_torch.ops import lie as TL
from mast3r_slam_tpu_torch.slam import tracker as TT
from mast3r_slam_tpu_torch.slam.frame import KeyframeBuffer, median
from torch_parity import torch_one_thread  # noqa: F401
from torch_parity import assert_close, crop_frame, tiny_weights, to_np

RNG = np.random.default_rng(51)
t_ = torch.from_numpy


def _pose_problem(n=600, noise=0.002):
    Xk = RNG.normal(size=(n, 3)).astype(np.float32) * 0.5
    Xk[:, 2] = np.abs(Xk[:, 2]) + 2.0
    xi = np.asarray([0.1, -0.05, 0.08, 0.04, -0.06, 0.05, 0.03], np.float32)
    T_gt = np.array(JL.exp(jnp.asarray(xi)))
    Xf = np.array(JL.act(JL.inv(jnp.asarray(T_gt))[None], jnp.asarray(Xk)))
    Xf = Xf + noise * RNG.normal(size=Xf.shape).astype(np.float32)
    Q = RNG.uniform(1.0, 4.0, (n, 1)).astype(np.float32)
    valid = (RNG.random((n, 1)) < 0.9).astype(np.float32)
    T_WCk = np.array(JL.exp(jnp.asarray(RNG.normal(size=7).astype(np.float32)
                                        * 0.1)))
    return Xf, Xk, T_WCk, Q, valid


def test_ray_dist_solver_matches_jax():
    Xf, Xk, T_WCk, Q, valid = _pose_problem()
    args = (0.003, 10.0, 1.345, 50, 1e-6, 1e-6)
    Tj, Tcj, okj = JT.opt_pose_ray_dist_sim3(
        jnp.asarray(Xf), jnp.asarray(Xk), jnp.asarray(T_WCk),
        jnp.asarray(T_WCk), jnp.asarray(Q), jnp.asarray(valid), *args)
    Tt, Tct, okt = TT.opt_pose_ray_dist_sim3(
        t_(Xf), t_(Xk), t_(T_WCk), t_(T_WCk), t_(Q), t_(valid), *args)
    assert okt == bool(okj) and okt
    assert_close(Tct, Tcj, rtol=1e-5, atol=1e-5)
    assert_close(Tt, Tj, rtol=1e-5, atol=1e-5)


def test_calib_solver_matches_jax():
    H, W = 48, 64
    K = np.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
    u, v = np.meshgrid(np.arange(W), np.arange(H), indexing="xy")
    uv = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)
    z = (2.0 + 0.5 * RNG.random((H * W, 1))).astype(np.float32)
    Xk = np.concatenate([(uv - K[:2, 2]) / K[[0, 1], [0, 1]] * z, z], -1)
    xi = np.asarray([0.05, -0.02, 0.03, 0.02, -0.03, 0.02, 0.01], np.float32)
    T_gt = JL.exp(jnp.asarray(xi))
    Xf = np.array(JL.act(JL.inv(T_gt)[None], jnp.asarray(Xk)))
    meas = np.concatenate([uv, np.log(Xk[:, 2:3])], -1).astype(np.float32)
    vmeas = Xk[:, 2:3] > 1e-6
    n = H * W
    Q = np.full((n, 1), 4.0, np.float32)
    valid = np.ones((n, 1), np.float32)
    I = np.array(JL.identity())
    args = (1.0, 10.0, 1.345, 50, 1e-8, 1e-8, -10.0, 1e-6)
    _, Tcj, okj = JT.opt_pose_calib_sim3(
        *(jnp.asarray(a) for a in (Xf, Xk, I, I, Q, valid, meas, vmeas, K)),
        (H, W), *args)
    _, Tct, okt = TT.opt_pose_calib_sim3(
        *(t_(a) for a in (Xf, Xk, I, I, Q, valid, meas, vmeas, K)),
        (H, W), *args)
    assert okt == bool(okj) and okt
    assert_close(Tct, Tcj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["identical_points", "no_valid_pixels"])
def test_singular_system_reports_failure(case):
    """A rank-deficient system flags ok=False in both (the reference's
    Cholesky-failure → relocalization signal)."""
    n = 100
    Xk = np.tile(np.asarray([[0.0, 0.0, 2.0]], np.float32), (n, 1))
    valid = np.ones((n, 1), np.float32)
    if case == "no_valid_pixels":
        Xk = _pose_problem(n)[1]
        valid[:] = 0.0
    Q = np.full((n, 1), 4.0, np.float32)
    I = np.array(JL.identity())
    args = (0.003, 10.0, 1.345, 10, 1e-9, 1e-9)
    _, _, okj = JT.opt_pose_ray_dist_sim3(
        *(jnp.asarray(a) for a in (Xk, Xk, I, I, Q, valid)), *args)
    _, _, okt = TT.opt_pose_ray_dist_sim3(
        *(t_(a) for a in (Xk, Xk, I, I, Q, valid)), *args)
    assert not bool(okj) and not okt


# ---------------------------------------------------------------------------
# The pose solve's LM loop: every exit rule against JAX's lax.while_loop
# ---------------------------------------------------------------------------

_M7 = np.linalg.qr(RNG.normal(size=(7, 7)))[0].astype(np.float32) * \
    np.asarray([3.0, 2.0, 1.5, 1.0, 0.7, 0.5, 0.3], np.float32)
_C7 = np.asarray([0.5, -0.3, 0.2, 0.4, -0.2, 0.3, 0.1], np.float32)


def _quadratic_system(xp, kind):
    """A least-squares system on the Sim(3) logarithm, the same
    function in JAX (``xp = jnp``) and in the port (``xp = torch``):
    ``r = M (log(T) - c)``. ``"nan"``: every candidate's cost is NaN, so no
    step is ever accepted; ``"singular"``: H and g are zero (the initial
    undamped Cholesky fails)."""
    M = xp.asarray(_M7) if xp is jnp else torch.from_numpy(_M7)
    c = xp.asarray(_C7) if xp is jnp else torch.from_numpy(_C7)
    log = JL.log if xp is jnp else TL.log
    T0 = np.array(JL.identity())

    def system(T):
        r = M @ (log(T) - c)
        # a curvature four times the true one: every step goes a quarter
        # of the way and the cost falls by a constant ratio, so the
        # relative-change and step-norm rules stop a loop that still moves
        H, g = 4.0 * (M.T @ M), -(M.T @ r)
        cost = 0.5 * (r * r).sum()
        if kind == "nan":
            at_start = (T == (xp.asarray(T0) if xp is jnp
                              else torch.from_numpy(T0))).all()
            cost = xp.where(at_start, cost, float("nan"))
        if kind == "singular":
            H, g = H * 0.0, g * 0.0
        finite = xp.isfinite(cost)
        return H, g, cost, finite

    return system, T0


# (system kind, max_iters, rel_error, delta_norm) → the rule that stops it
_EXITS = {
    "iteration_cap": ("quadratic", 3, 0.0, 0.0),
    "rel_error": ("quadratic", 50, 0.45, 0.0),
    "delta_norm": ("quadratic", 50, 0.0, 1e-2),
    "lambda_past_1e8": ("nan", 50, 0.0, 0.0),
    "never_accepted": ("nan", 5, 0.0, 0.0),
    "initial_cholesky_failure": ("singular", 50, 1e-6, 1e-6),
}


@pytest.mark.parametrize("rule", list(_EXITS))
def test_lm_pose_loop_exit_rules_match_jax(rule):
    """The device-exit pose loop against JAX's ``lax.while_loop`` for each
    exit rule: the same pose and ``ok``; the port's step count shows where
    it stopped, and JAX capped at that count (its rules off) ends at the
    same pose, so JAX stopped there too."""
    kind, max_iters, rel_error, delta_norm = _EXITS[rule]
    sys_j, T0 = _quadratic_system(jnp, kind)
    sys_t, _ = _quadratic_system(torch, kind)
    Tj, okj = JT._lm_pose_loop(sys_j, jnp.asarray(T0), max_iters, rel_error,
                               delta_norm)
    Tt, okt, iters = TT._lm_pose_loop(sys_t, t_(T0), max_iters, rel_error,
                                      delta_norm)
    assert okt.dtype == torch.bool and bool(okt) == bool(okj)
    assert_close(Tt, Tj, rtol=1e-5, atol=1e-6)
    n = int(iters)
    want_ok = {"iteration_cap": True, "rel_error": True, "delta_norm": True,
               "lambda_past_1e8": False, "never_accepted": False,
               "initial_cholesky_failure": False}[rule]
    assert bool(okt) == want_ok
    if rule in ("iteration_cap", "never_accepted"):
        assert n == max_iters
    elif rule == "initial_cholesky_failure":
        assert n == 1                    # a zero step is accepted, and stops
    else:
        assert 1 <= n < max_iters
    if rule == "lambda_past_1e8":        # every step rejected: λ = 1e-8·10^n
        assert 16 <= n <= 17 and torch.equal(Tt, t_(T0))
    Tc, _ = JT._lm_pose_loop(sys_j, jnp.asarray(T0), n, 0.0, 0.0)
    assert_close(Tt, Tc, rtol=1e-5, atol=1e-6)
    if rule in ("rel_error", "delta_norm"):
        # one more step would still move the pose: the rule stopped it
        Tm, _ = JT._lm_pose_loop(sys_j, jnp.asarray(T0), n + 1, 0.0, 0.0)
        assert not np.array_equal(np.asarray(Tm), np.asarray(Tc))


def _masked(cap, live, step):
    """Every step runs, those after the exit masked (as the steps that the
    card's eager loop launches before it sees the exit)."""
    for _ in range(cap):
        step()


@pytest.mark.parametrize("rule", ["rel_error", "lambda_past_1e8",
                                  "initial_cholesky_failure"])
def test_lm_pose_loop_masked_steps_leave_the_state(rule):
    """The steps after the exit (some run on the card's eager path, none
    on the CPU's or in the graph) leave every part of the state as it
    is."""
    kind, max_iters, rel_error, delta_norm = _EXITS[rule]
    sys_t, T0 = _quadratic_system(torch, kind)
    want = TT._lm_pose_loop(sys_t, t_(T0), max_iters, rel_error, delta_norm)
    with mock.patch.object(TT.device_loop, "run", _masked):
        got = TT._lm_pose_loop(sys_t, t_(T0), max_iters, rel_error,
                               delta_norm)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["weighted_pointmap", "weighted_spherical",
                                  "recent", "indep_conf", "first",
                                  "best_score"])
@pytest.mark.parametrize("N_k", [1.0, 3.0])
def test_fuse_pointmap_matches_jax(mode, N_k):
    n = 64   # even: best_score's median averages the two middle values
    X_k = RNG.normal(size=(n, 3)).astype(np.float32)
    Xkk = RNG.normal(size=(n, 3)).astype(np.float32)
    C_k = RNG.uniform(1, 3, (n, 1)).astype(np.float32)
    Ckf = RNG.uniform(1, 3, (n, 1)).astype(np.float32)
    if mode == "best_score":
        # medians that differ only through the averaging convention
        Ckf = np.sort(C_k.reshape(-1)).reshape(n, 1).copy()
        Ckf[n // 2 - 1] -= 0.01
        Ckf = np.ascontiguousarray(Ckf[::-1])
    Xj, Cj, Nj = JT.fuse_pointmap(mode, "median", jnp.asarray(X_k),
                                  jnp.asarray(C_k) * N_k, jnp.asarray(N_k),
                                  jnp.asarray(Xkk), jnp.asarray(Ckf))
    Xt, Ct, Nt = TT.fuse_pointmap(mode, "median", t_(X_k), t_(C_k) * N_k,
                                  torch.tensor(N_k), t_(Xkk), t_(Ckf))
    assert_close(Xt, Xj)
    assert_close(Ct, Cj)
    # the count stays a float32 tensor: no policy reads it on the host
    assert Nt.dtype == torch.float32 and Nt.shape == ()
    assert float(Nt) == float(Nj)


def test_median_averages_middle_values():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(median(x)) == 2.5
    assert float(median(x)) == float(jnp.median(jnp.asarray(x.numpy())))


def test_kf_selection_stats_match_jax():
    n = 500
    idx0 = RNG.integers(0, n, n)
    vmatch = RNG.random((n, 1)) < 0.7
    valid_kf = RNG.random((n, 1)) < 0.5
    mj, uj = JT.kf_selection_stats(jnp.asarray(vmatch), jnp.asarray(idx0),
                                   jnp.asarray(valid_kf), n)
    mt, ut = TT.kf_selection_stats(t_(vmatch), t_(idx0), t_(valid_kf), n)
    assert float(mt) == pytest.approx(float(mj), abs=1e-7)
    assert float(ut) == pytest.approx(float(uj), abs=1e-7)


@pytest.mark.parametrize("use_calib", [False, True])
def test_quality_job_tensors_match_jax(use_calib):
    H, W = 24, 32
    n = H * W
    Xf, Xk, _, _, _ = _pose_problem(n)
    T = np.array(JL.exp(jnp.asarray(RNG.normal(size=7).astype(np.float32)
                                    * 0.05)))
    K = np.asarray([[30.0, 0, 15.5], [0, 30.0, 11.5], [0, 0, 1]], np.float32)
    meas = np.concatenate([RNG.uniform(0, W, (n, 1)), RNG.uniform(0, H, (n, 1)),
                           RNG.normal(size=(n, 1))], -1).astype(np.float32)
    valid_kf = RNG.random((n, 1)) < 0.8
    valid_meas = RNG.random((n, 1)) < 0.9
    args = (0.003, 10.0)
    outj = JT.quality_job_tensors(
        use_calib, jnp.asarray(T), jnp.asarray(Xf), jnp.asarray(Xk),
        jnp.asarray(valid_kf), jnp.asarray(meas), jnp.asarray(valid_meas),
        jnp.asarray(K), (H, W), *args)
    outt = TT.quality_job_tensors(
        use_calib, t_(T), t_(Xf), t_(Xk), t_(valid_kf), t_(meas),
        t_(valid_meas), t_(K), (H, W), *args)
    for got, want in zip(outt, outj):
        if got.dtype == torch.bool:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            assert_close(got, want)


# ---------------------------------------------------------------------------
# The slice as a whole: track_core, 3 warm-started frames at tiny_config
# ---------------------------------------------------------------------------

HW = (96, 128)


def _frames(n):
    """A smooth pattern shifting by a fraction of a pixel per frame."""
    yy, xx = np.mgrid[0:HW[0], 0:HW[1]].astype(np.float64)
    out = []
    for i in range(n):
        x, y = xx + 0.7 * i, yy + 0.4 * i
        out.append((0.8 * np.stack([np.sin(x / 9.0), np.cos(y / 7.0),
                                    np.sin((x + y) / 13.0)], -1))
                   .astype(np.float32))
    return out


def _track_cfg(use_calib=False):
    cfg = resolve_config("config/base.yaml")
    # random-weight desc_conf sits near exp(0) = 1, under the production
    # Q_conf = 1.5 gate that would mask every pixel out of the pose solve
    cfg["tracking"]["Q_conf"] = 0.0
    # at the production sigma_dist (10) the distance rows weigh ~1e-7 of the
    # ray rows, so f32 rounding in the Gram moves the solved scale by ~1e-4
    # (JAX against itself under 1e-6 input noise); 0.1 pins the scale and
    # lets the solve be held to f32 rounding
    cfg["tracking"]["sigma_dist"] = 0.1
    cfg["use_calib"] = use_calib
    return cfg


# pinhole intrinsics for the calibrated case (random-weight pointmaps are
# O(1) in size and mostly in front of the camera)
K_CALIB = np.asarray([[60.0, 0, 63.5], [0, 60.0, 47.5], [0, 0, 1]],
                     np.float32)


@functools.lru_cache(maxsize=2)
def _track_run(use_calib=False, n_frames=3):
    """JAX and port track_core outputs for frames 1..n_frames against a
    keyframe made by mono inference of frame 0, as ``(jax, port, port with
    the JAX run's matches)`` per frame. Each frame starts every run from the
    JAX run's previous state (warm-start correspondence, fused keyframe map,
    pose), so one frame's few differing pixels do not compound into the
    next. The third run replaces the port's matcher by the JAX run's
    ``idx_f2k`` and ``valid_match``, so the pose solve, fusion and the
    statistics after it see the same inputs as in JAX."""
    cj, pj, ct, pt = tiny_weights(tie_streams=True)
    pj, pt = JM.prepare_params(pj, cj), TM.prepare_params(pt, ct)
    cfg = _track_cfg(use_calib)
    scfg_j = JT.make_scfg(cfg["tracking"], cfg["matching"])
    scfg_t = TT.make_scfg(cfg["tracking"], cfg["matching"])
    assert scfg_j == scfg_t
    imgs = _frames(n_frames + 1)
    fj, posj, Xj, Cj = j_mono_core(pj, cj, jnp.asarray(imgs[0])[None], HW)
    ft, post, Xt, Ct = t_mono_core(pt, ct, t_(imgs[0])[None], HW)
    n = HW[0] * HW[1]
    assert_close(Xt, Xj)
    state = dict(X=Xj[0], C=Cj[0], T=JL.identity(), idx=jnp.arange(n)[None])
    N_k = 1.0
    runs = []
    K = K_CALIB if use_calib else np.eye(3, dtype=np.float32)
    for i in range(1, n_frames + 1):
        oj = JT.track_core(pj, cj, jnp.asarray(imgs[i])[None], fj, posj,
                           state["idx"], state["X"], state["C"],
                           jnp.asarray(N_k), state["T"], JL.identity(),
                           jnp.asarray(K), HW, use_calib, scfg_j,
                           model_hw=HW)
        st = {k: t_(np.array(v)) for k, v in state.items()}
        args = (pt, ct, t_(imgs[i])[None], ft, post, st["idx"].long(),
                st["X"], st["C"], N_k, st["T"], TL.identity(), t_(K), HW,
                use_calib, scfg_t)
        ot = TT.track_core(*args, model_hw=HW)
        jax_matches = (t_(np.array(oj["idx_f2k"])).long(),
                       t_(np.array(oj["valid_match"]))[None])
        with mock.patch.object(TT.matching, "match",
                               lambda *a, **kw: jax_matches):
            os_ = TT.track_core(*args, model_hw=HW)
        runs.append((oj, ot, os_))
        state = dict(X=oj["X_k_new"], C=oj["C_k_new"], T=oj["T_WCf"],
                     idx=oj["idx_f2k"])
        N_k = float(oj["N_k_new"])
    return runs, cfg


# outputs computed before the match, held to f32 rounding
_MODEL_KEYS = ("feat_f", "X_frame", "C_frame", "Qkf", "Qff", "Ck_avg")


@pytest.mark.parametrize("use_calib,frame", [(False, 0), (False, 1),
                                             (False, 2), (True, 0)])
def test_track_core_matches_jax(use_calib, frame):
    """Tolerances: model outputs to f32 rounding (rtol 1e-4, atol 1e-5).
    The matcher: idx_f2k equal on >= 99.5% and the valid mask on >= 99.9%
    of pixels (a few pixels whose 2x2 LM step sits on a near-singular
    system land on different sides of a pixel boundary in the two
    frameworks). Given the JAX run's matches, everything after the match
    (pose, ok, fused keyframe map, keyframe statistics, quality-job
    residuals) agrees to f32 rounding, and so does the keyframe
    decision."""
    runs, cfg = (_track_run(True, 1) if use_calib else _track_run())
    oj, ot, os_ = runs[frame]
    for key in _MODEL_KEYS:
        assert_close(ot[key], oj[key])
    np.testing.assert_array_equal(ot["pos_f"].numpy(), np.asarray(oj["pos_f"]))
    idx_t, idx_j = ot["idx_f2k"].numpy(), np.asarray(oj["idx_f2k"])
    assert (idx_t[0] == idx_j[0]).mean() >= 0.995
    vm_t, vm_j = ot["valid_match"].numpy(), np.asarray(oj["valid_match"])
    assert (vm_t == vm_j).mean() >= 0.999
    assert vm_j.mean() > 0.05            # the pose solve has real input

    np.testing.assert_array_equal(os_["idx_f2k"].numpy(), idx_j)
    assert os_["ok"] == bool(oj["ok"])
    for key in ("Qk", "T_WCf", "T_CkCf", "X_k_new", "C_k_new", "match_frac",
                "match_frac_k", "unique_frac_f", "t_norm", "theta"):
        assert_close(os_[key], oj[key], err_msg=key)
    # r_pix divides by the frame point's depth, which turns the model's f32
    # rounding into ~1e-3 at the few pixels whose point sits near z = 0;
    # test_quality_job_tensors_match_jax holds it to f32 on equal inputs
    r_t, r_j = os_["r_pix"].numpy(), np.asarray(oj["r_pix"])
    assert np.isclose(r_t, r_j, rtol=1e-4, atol=1e-5).mean() >= 0.999
    np.testing.assert_array_equal(os_["valid_submit"].numpy(),
                                  np.asarray(oj["valid_submit"]))
    assert float(os_["N_k_new"]) == float(oj["N_k_new"])
    thresh = cfg["tracking"]["match_frac_thresh"]
    new_kf_t = min(float(os_["match_frac_k"]), float(os_["unique_frac_f"]))
    new_kf_j = min(float(oj["match_frac_k"]), float(oj["unique_frac_f"]))
    assert (new_kf_t < thresh) == (new_kf_j < thresh)


def test_frame_tracker_drives_track_core_on_cpu():
    """FrameTracker over a keyframe buffer: the fusion write-back bumps the
    keyframe's version and N, and the warm start carries across frames."""
    _, _, ct, pt = tiny_weights(tie_streams=True)
    pt = TM.prepare_params(pt, ct)
    cfg = _track_cfg()
    model = MASt3RInference(pt, ct)
    kfs = KeyframeBuffer(*HW, capacity=4, feat_dim=ct.enc_embed_dim,
                         device="cpu")
    tracker = TT.FrameTracker(model, kfs, cfg)
    imgs = _frames(3)
    f0 = crop_frame(0, imgs[0])
    X, C = model.inference_mono(f0)
    f0.update_pointmap(X[0], C[0])
    kfs.append(f0)
    X0 = kfs.X[0].clone()
    f1 = crop_frame(1, imgs[1], T_WC=f0.T_WC)
    new_kf, info, reloc = tracker.track(f1)
    assert not reloc
    assert kfs.N[0] == 2 and kfs.version[0] == 1
    assert not torch.equal(kfs.X[0], X0)
    assert np.isfinite(to_np(f1.T_WC)).all()
    if not new_kf:
        assert tracker.idx_f2k is not None and tracker._warm_kf_idx == 0
    assert len(info) == 6


def test_new_keyframe_records_the_backend_match_hint():
    """A frame that becomes a keyframe leaves its converged match as
    ``last_kf_match`` (the backend's 5-tuple hint) and drops the warm
    start; a frame that does not leaves no hint."""
    _, _, ct, pt = tiny_weights(tie_streams=True)
    model = MASt3RInference(TM.prepare_params(pt, ct), ct)
    imgs = _frames(2)
    for thresh, want_kf in ((2.0, True), (-1.0, False)):
        cfg = _track_cfg()
        cfg["tracking"]["match_frac_thresh"] = thresh
        kfs = KeyframeBuffer(*HW, capacity=4, feat_dim=ct.enc_embed_dim,
                             device="cpu")
        tracker = TT.FrameTracker(model, kfs, cfg)
        f0 = crop_frame(0, imgs[0])
        X, C = model.inference_mono(f0)
        f0.update_pointmap(X[0], C[0])
        kfs.append(f0)
        f1 = crop_frame(1, imgs[1], T_WC=f0.T_WC)
        new_kf, _, reloc = tracker.track(f1)
        assert not reloc and new_kf == want_kf
        if not want_kf:
            assert tracker.last_kf_match is None
            continue
        kf_idx, idx_f2k, valid, Qk = tracker.last_kf_match
        n = HW[0] * HW[1]
        assert kf_idx == 0 and tracker.idx_f2k is None
        assert idx_f2k.shape == (1, n) and valid.shape == (n, 1)
        assert Qk.shape == (n, 1) and bool(Qk.isfinite().all())


@functools.lru_cache(maxsize=1)
def _fusion_setup():
    """Tied tiny weights in both packages and keyframe 0 (mono inference
    of frame 0) in both."""
    cj, pj, ct, pt = tiny_weights(tie_streams=True)
    pj, pt = JM.prepare_params(pj, cj), TM.prepare_params(pt, ct)
    imgs = _frames(2)
    kf_j = j_mono_core(pj, cj, jnp.asarray(imgs[0])[None], HW)
    kf_t = t_mono_core(pt, ct, t_(imgs[0])[None], HW)
    return (cj, pj, kf_j), (ct, pt, kf_t), imgs[1]


@pytest.mark.parametrize("mode", ["weighted_pointmap", "weighted_spherical",
                                  "recent", "indep_conf", "first",
                                  "best_score"])
@pytest.mark.parametrize("N_k", [1.0, 3.0])
def test_track_core_fusion_modes_match_jax(mode, N_k):
    """``track_core`` with the keyframe's update count as a device tensor,
    against JAX, for every filtering mode at N_k 1 and 3: given the JAX
    run's matches, the fused keyframe map, the confidence average and the
    new count (a float32 0-dim tensor, never read on the host) agree."""
    (cj, pj, (fj, posj, Xj, Cj)), (ct, pt, (ft, post, Xt, Ct)), img = \
        _fusion_setup()
    cfg = _track_cfg()
    cfg["tracking"]["filtering_mode"] = mode
    n = HW[0] * HW[1]
    oj = JT.track_core(pj, cj, jnp.asarray(img)[None], fj, posj,
                       jnp.arange(n)[None], Xj[0], Cj[0] * N_k,
                       jnp.asarray(N_k), JL.identity(), JL.identity(),
                       jnp.eye(3), HW, False,
                       JT.make_scfg(cfg["tracking"], cfg["matching"]),
                       model_hw=HW)
    jax_matches = (t_(np.array(oj["idx_f2k"])).long(),
                   t_(np.array(oj["valid_match"]))[None])
    with mock.patch.object(TT.matching, "match",
                           lambda *a, **kw: jax_matches):
        ot = TT.track_core(pt, ct, t_(img)[None], ft, post,
                           torch.arange(n)[None], Xt[0], Ct[0] * N_k,
                           torch.tensor(N_k), TL.identity(), TL.identity(),
                           torch.eye(3), HW, False,
                           TT.make_scfg(cfg["tracking"], cfg["matching"]),
                           model_hw=HW)
    N_new = ot["N_k_new"]
    assert N_new.dtype == torch.float32 and N_new.shape == ()
    assert float(N_new) == float(oj["N_k_new"])
    for key in ("Ck_avg", "X_k_new", "C_k_new"):
        assert_close(ot[key], oj[key], err_msg=key)
