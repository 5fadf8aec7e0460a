"""Port parity: the backend factor graph (mast3r_slam_tpu_torch/slam/
factor_graph.py) vs the JAX package — measured channels, the dense system
and its solve, the LM bundle adjustment, the measured-channel cache, and
edge creation through the symmetric and the hint (one-way) paths.

With float32 rows the solved poses agree to 1e-5 with the JAX BA run
through its Pallas Gram in interpret mode (``pallas_interpret=True``, the
port kernels' per-pixel formula). With bfloat16 rows a one-ulp difference
in a weight can round a row to the neighbouring bf16 value, and twelve LM
steps on a weakly held pose carry it far: the JAX package's own two builds
of the same system (Pallas interpret vs XLA) end more than 1e-4 apart on
both LM scenes. There the port, whose plain Gram sums in float64, is held
to 1e-4 of the XLA build, the one JAX runs on a CPU, and the test checks
that the two JAX builds are further apart than that."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import mast3r as JM
from mast3r_slam_tpu.models.inference import MASt3RInference as JInference
from mast3r_slam_tpu.ops import geometry as JG
from mast3r_slam_tpu.ops import lie as JL
from mast3r_slam_tpu.slam import factor_graph as JFG
from mast3r_slam_tpu.slam import frame as JFr
from mast3r_slam_tpu_torch.models import mast3r as TM
from mast3r_slam_tpu_torch.models.inference import MASt3RInference
from mast3r_slam_tpu_torch.ops import ba_kernels as TK
from mast3r_slam_tpu_torch.ops import lie as TL
from mast3r_slam_tpu_torch.slam import factor_graph as TFG
from mast3r_slam_tpu_torch.slam import frame as TFr
from mast3r_slam_tpu_torch.utils.oracle_scene import (OracleScene,
                                                      make_trajectory)
from torch_parity import torch_one_thread  # noqa: F401
from torch_parity import ba_edges, tiny_weights, to_np

t_ = torch.from_numpy


# ---------------------------------------------------------------------------
# Measured channels and the dense system
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pixel_step", [1, 2])
@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_premeas_matches_jax(kind, pixel_step):
    """Gathers, gates and ray / pixel channels agree exactly (the unit ray
    to one f32 ulp: the norm's rounding)."""
    T, X, Cavg, ii, jj, idx, valid, Q, _ = ba_edges(6, E=4, N=768)
    j_in = [jnp.asarray(a) for a in (X, Cavg, ii, jj, idx, valid, Q)]
    t_in = [t_(np.ascontiguousarray(a)) for a in
            (X, Cavg, ii, jj, idx, valid, Q)]
    if kind == "rays":
        want = JFG.precompute_meas_rays(*j_in, 0.5, 0.5,
                                        pixel_step=pixel_step)
        got = TFG.precompute_meas_rays(*t_in, 0.5, 0.5,
                                       pixel_step=pixel_step)
    else:
        want = JFG.precompute_meas_calib(*j_in, 24, 1e-6, 0.5, 0.5,
                                         pixel_step=pixel_step)
        got = TFG.precompute_meas_calib(*t_in, 24, 1e-6, 0.5, 0.5,
                                        pixel_step=pixel_step)
    assert len(got) == len(want) == (8 if kind == "rays" else 7)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (4, 768 // pixel_step)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-7,
                                   atol=0)


@pytest.mark.parametrize("extra", [False, True])
def test_rel_pose_rows_match_jax(extra):
    T, *_, ii, jj, _, _, _, mask = ba_edges(7, E=6)
    kx = (40.0, 41.0, 16.0, 12.0) if extra else ()
    Ti_j, r_j = JFG._rel_pose_rows(jnp.asarray(T), jnp.asarray(ii),
                                   jnp.asarray(jj), jnp.asarray(mask),
                                   extra=kx)
    Ti_t, r_t = TFG._rel_pose_rows(t_(T), t_(ii), t_(jj), t_(mask),
                                   extra=kx)
    np.testing.assert_array_equal(Ti_t.numpy(), np.asarray(Ti_j))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-6,
                               atol=1e-6)


def test_scatter_blocks_accumulates_repeated_pairs_exactly():
    """Duplicate keyframe pairs add up (integer-valued blocks: any order of
    the sums is exact); a fixed pose's blocks land in the trash slot."""
    rng = np.random.default_rng(8)
    cap = 4
    ii = np.asarray([0, 1, 1, 0, 2, 1], np.int64)
    jj = np.asarray([1, 2, 2, 1, 3, 0], np.int64)
    He = rng.integers(-8, 9, (6, 7, 7)).astype(np.float32)
    ge = rng.integers(-8, 9, (6, 7)).astype(np.float32)
    free = np.asarray([False, True, True, True])
    H0 = np.zeros((cap + 1, 7, cap + 1, 7), np.float32)
    g0 = np.zeros((cap + 1, 7), np.float32)
    Hj, gj = JFG._scatter_blocks(jnp.asarray(H0), jnp.asarray(g0),
                                 jnp.asarray(He), jnp.asarray(ge),
                                 jnp.asarray(ii), jnp.asarray(jj),
                                 jnp.asarray(free), cap)
    Ht, gt = t_(H0.copy()), t_(g0.copy())
    TFG._scatter_blocks(Ht, gt, t_(He), t_(ge), t_(ii), t_(jj), t_(free),
                        cap)
    np.testing.assert_array_equal(Ht.numpy(), np.asarray(Hj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    # the (1, 2) pair appears twice: both blocks are in H[1, :, 2, :]
    np.testing.assert_array_equal(Ht[1, :, 2, :].numpy(), -He[1] - He[2])


def _spd_system(cap, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(cap * 7, cap * 7 + 5)).astype(np.float32)
    Hd = A @ A.T + 0.1 * np.eye(cap * 7, dtype=np.float32)
    H = np.zeros((cap + 1, 7, cap + 1, 7), np.float32)
    H[:cap, :, :cap, :] = Hd.reshape(cap, 7, cap, 7)
    g = rng.normal(size=(cap + 1, 7)).astype(np.float32)
    return H, g


@pytest.mark.parametrize("case", ["spd", "nan", "indefinite"])
def test_solve_system_matches_jax(case):
    cap = 5
    H, g = _spd_system(cap, 9)
    if case == "nan":
        H[1, 2, 1, 2] = np.nan
    elif case == "indefinite":
        H[:cap, :, :cap, :] = -H[:cap, :, :cap, :]
    free = np.asarray([False, True, True, False, True])
    dx_j, ok_j = JFG._solve_system(jnp.asarray(H), jnp.asarray(g),
                                   jnp.asarray(free), cap, 1e-3)
    dx_t, ok_t = TFG._solve_system(t_(H), t_(g), t_(free), cap, 1e-3)
    assert bool(ok_t) == bool(ok_j) == (case == "spd")
    np.testing.assert_allclose(dx_t.numpy(), np.asarray(dx_j), rtol=1e-4,
                               atol=1e-5)
    if case != "spd":
        assert not dx_t.any()
    assert not dx_t[~t_(free)].any()


def _lm_scene():
    """The ``tests/test_ba_fused.py`` LM scene: three poses of a low-relief
    surface, pose 2 held by one edge and perturbed (scale included)."""
    rng = np.random.default_rng(3)
    cap, n = 3, 512
    xy = (rng.random((n, 2)) - 0.5) * 1.6
    z = 2.5 + 0.05 * np.sin(xy[:, 0] * 2.0) + 0.04 * np.cos(xy[:, 1] * 1.7)
    Xw = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    T_true = [JL.identity(),
              JL.exp(jnp.asarray([0.05, 0, 0, 0, 0.01, 0, 0])),
              JL.exp(jnp.asarray([0.1, 0.02, 0, 0.01, 0, 0, 0]))]
    X = np.stack([np.asarray(JL.act(JL.inv(T)[None], jnp.asarray(Xw)))
                  for T in T_true])
    X = (X + 0.003 * X[..., 2:3] * rng.standard_normal(X.shape)).astype(
        np.float32)
    Cavg = np.ones((cap, n, 1), np.float32)
    ii = np.asarray([0, 1, 1, 2, 0, 0, 0, 0], np.int32)
    jj = np.asarray([1, 0, 2, 1, 1, 1, 1, 1], np.int32)
    mask = np.asarray([1, 1, 1, 1, 0, 0, 0, 0], np.float32)
    idx = np.broadcast_to(np.arange(n, dtype=np.int32), (8, n)).copy()
    valid = np.ones((8, n, 1), bool)
    Q = np.full((8, n, 1), 4.0, np.float32)
    meas = JFG.precompute_meas_rays(*(jnp.asarray(a) for a in
                                      (X, Cavg, ii, jj, idx, valid, Q)),
                                    0.0, 1.5)
    T_in = np.stack([np.asarray(T_true[0]), np.asarray(T_true[1]),
                     np.asarray(JL.retr(T_true[2], jnp.asarray(
                         [0.02, -0.01, 0.03, 0.01, 0, 0, 0.05])))])
    return T_in, meas, ii, jj, mask, np.asarray([False, False, True])


def _calib_scene():
    """Three consecutive oracle keyframes at 24x32 with their ground-truth
    correspondences, ray-constrained pointmaps, the calibrated channels,
    and perturbed poses."""
    hw, n = (24, 32), 24 * 32
    scene = OracleScene(seed=0)
    poses = make_trajectory(16)[:3]
    K = scene.intrinsics(hw).astype(np.float32)
    maps = [scene.raycast(T, K, hw) for T in poses]
    edges = [(0, 1), (1, 0), (1, 2), (2, 1)]
    idx, valid = [], []
    for i, j in edges:
        p, ok = scene.project(scene.world_to_cam(maps[j][1], poses[i]), K,
                              hw)
        idx.append(p.astype(np.int32))
        valid.append(ok[:, None])
    X = JG.constrain_points_to_ray(hw, jnp.asarray(np.stack(
        [m[0] for m in maps])), jnp.asarray(K))
    ii = np.asarray([e[0] for e in edges], np.int32)
    jj = np.asarray([e[1] for e in edges], np.int32)
    meas = JFG.precompute_meas_calib(
        X, jnp.ones((3, n, 1)), jnp.asarray(ii), jnp.asarray(jj),
        jnp.asarray(np.stack(idx)), jnp.asarray(np.stack(valid)),
        jnp.full((4, n, 1), 2.0), hw[1], 1e-6, 0.0, 1.5)
    rng = np.random.default_rng(5)
    T_in = np.stack([poses[0]] + [
        np.asarray(JL.retr(jnp.asarray(T), jnp.asarray(
            (rng.normal(size=7) * 0.01).astype(np.float32))))
        for T in poses[1:]])
    return T_in, meas, K, ii, jj, np.ones(4, np.float32), hw


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_gauss_newton_matches_jax(kind, compute):
    """Poses within 1e-5 of JAX's Pallas build (interpret mode) with float32
    rows, within 1e-4 of its XLA build with bfloat16 rows. On these scenes
    JAX's own two bf16 builds end more than 1e-4 apart (a weight one f32
    ulp apart rounds its row to the neighbouring bf16 value), so the bf16
    case holds the port to one of them, the XLA build."""
    if kind == "rays":
        T_in, meas, ii, jj, mask, free = _lm_scene()
        args = (0.003, 10.0, 12, 1e-9)

        def jax_solve(interpret):
            return np.asarray(JFG.gauss_newton_rays(
                jnp.asarray(T_in), meas, jnp.asarray(ii), jnp.asarray(jj),
                jnp.asarray(mask), jnp.asarray(free), *args,
                compute_dtype=compute, pallas_interpret=interpret))

        T_t, iters = TFG.gauss_newton_rays(
            t_(T_in), tuple(t_(np.array(ch)) for ch in meas), t_(ii),
            t_(jj), t_(mask), t_(free), *args, compute_dtype=compute)
    else:
        T_in, meas, K, ii, jj, mask, hw = _calib_scene()
        free = np.asarray([False, True, True])
        args = (-10.0, 1e-6, 1.0, 10.0, 10, 1e-9)

        def jax_solve(interpret):
            return np.asarray(JFG.gauss_newton_calib(
                jnp.asarray(T_in), meas, jnp.asarray(K), jnp.asarray(ii),
                jnp.asarray(jj), jnp.asarray(mask), jnp.asarray(free), hw,
                *args, compute_dtype=compute, pallas_interpret=interpret))

        T_t, iters = TFG.gauss_newton_calib(
            t_(T_in), tuple(t_(np.array(ch)) for ch in meas), t_(K),
            t_(ii), t_(jj), t_(mask), t_(free), hw, *args,
            compute_dtype=compute)
    f32 = compute == "float32"
    want = jax_solve(f32)
    err = np.abs(T_t.numpy() - want).max()
    assert iters >= 1
    assert np.abs(T_t.numpy() - T_in).max() > 1e-3   # the solve moved
    assert err <= (1e-5 if f32 else 1e-4), err


# ---------------------------------------------------------------------------
# The BA's LM loop: every exit rule against JAX's lax.while_loop
# ---------------------------------------------------------------------------

_LM_CAP = 3
_LM_RNG = np.random.default_rng(61)
_LM_M = np.linalg.qr(_LM_RNG.normal(size=(7, 7)))[0].astype(np.float32) * \
    np.asarray([3.0, 2.0, 1.5, 1.0, 0.7, 0.5, 0.3], np.float32)
_LM_C = (_LM_RNG.normal(size=(_LM_CAP, 7)) * 0.3).astype(np.float32)
_LM_FREE = np.asarray([False, True, True])


def _dense_system(xp, kind):
    """A least-squares system on the poses' Sim(3) logarithms in the
    dense ``(cap+1, 7, cap+1, 7)`` layout, the same function in JAX
    (``xp = jnp``) and in the port (``xp = torch``): ``r_k = M (log(T_k) -
    c_k)``, with four times the true curvature, so that every step goes a
    quarter of the way and the step norm shrinks geometrically.
    ``"nan"``: every candidate's cost is NaN (no step is accepted);
    ``"cholesky"``: H holds a NaN (every factorization fails)."""
    if xp is jnp:
        M, c = jnp.asarray(_LM_M), jnp.asarray(_LM_C)
        log = jax.vmap(JL.log)
        eye = jnp.eye(_LM_CAP + 1)[:, :_LM_CAP]
    else:
        M, c = t_(_LM_M), t_(_LM_C)
        log = TL.log
        eye = torch.eye(_LM_CAP + 1)[:, :_LM_CAP]
    T0 = np.stack([np.array(JL.identity())] + [
        np.array(JL.exp(jnp.asarray(_LM_C[k] * 0.2))) for k in (1, 2)])

    def system(T):
        r = (log(T) - c) @ M.T                                # (cap, 7)
        A = 4.0 * (M.T @ M)
        H = xp.einsum("ik,jk,ab->iajb", eye, eye, A)
        g = xp.einsum("ik,ka->ia", eye, -(r @ M))
        cost = 0.5 * (r * r).sum()
        if kind == "nan":
            at_start = (T == (jnp.asarray(T0) if xp is jnp
                              else t_(T0))).all()
            cost = xp.where(at_start, cost, float("nan"))
        if kind == "cholesky":
            H = H * xp.where(xp.arange(_LM_CAP + 1) == 1, float("nan"),
                             1.0)[:, None, None, None]
        return H, g, cost

    return system, T0


# (system kind, max_iter, delta_thresh) → the rule that stops the loop
_BA_EXITS = {
    "iteration_cap": ("quadratic", 3, 1e-12),
    "small_accepted_step": ("quadratic", 50, 1e-2),
    "lambda_past_1e8": ("nan", 50, 1e-12),
    "cholesky_failure": ("cholesky", 50, 1e-12),
}


def _reject_only_steps(damping=1e-4):
    """The steps of a loop that rejects every step: λ ← 10λ in float32,
    from float32(damping), until λ > 1e8 (JAX's rule, replayed in numpy)."""
    lam, n = np.float32(damping), 0
    while not lam > np.float32(1e8):
        lam, n = np.float32(lam * np.float32(10.0)), n + 1
    return n


@pytest.mark.parametrize("rule", list(_BA_EXITS))
def test_ba_lm_loop_exit_rules_match_jax(rule):
    """The device-exit BA loop against JAX's ``lax.while_loop`` for each
    exit rule: the same poses; the port's step count shows where it
    stopped, and JAX capped at that count (its other rules off: delta
    threshold 0) ends at the same poses, so JAX stopped there too."""
    kind, max_iter, delta = _BA_EXITS[rule]
    sys_j, T0 = _dense_system(jnp, kind)
    sys_t, _ = _dense_system(torch, kind)
    Tj = JFG._lm_loop(sys_j, jnp.asarray(T0), jnp.asarray(_LM_FREE),
                      _LM_CAP, max_iter, delta, 1e-4)
    Tt, iters = TFG._lm_loop(sys_t, t_(T0), t_(_LM_FREE), _LM_CAP, max_iter,
                             delta, 1e-4)
    assert iters.dtype == torch.int32 and iters.shape == ()
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0,
                               atol=1e-5)
    n = int(iters)
    if rule == "iteration_cap":
        assert n == max_iter
    elif rule == "small_accepted_step":
        assert 2 <= n < max_iter
    else:                    # every step rejected: λ = 1e-4 · 10^n
        assert n == _reject_only_steps() and torch.equal(Tt, t_(T0))
    assert torch.equal(Tt[0], t_(T0[0]))                   # pinned
    Tc = JFG._lm_loop(sys_j, jnp.asarray(T0), jnp.asarray(_LM_FREE),
                      _LM_CAP, n, 0.0, 1e-4)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tc), rtol=0,
                               atol=1e-5)
    if rule == "small_accepted_step":
        # one more step would still move the poses: the rule stopped it
        Tm = JFG._lm_loop(sys_j, jnp.asarray(T0), jnp.asarray(_LM_FREE),
                          _LM_CAP, n + 1, 0.0, 1e-4)
        assert not np.array_equal(np.asarray(Tm), np.asarray(Tc))


def _masked(cap, live, step):
    """Every step runs, those after the exit masked (as the steps that the
    card's eager loop launches before it sees the exit)."""
    for _ in range(cap):
        step()


@pytest.mark.parametrize("rule", list(_BA_EXITS))
def test_ba_lm_loop_masked_steps_leave_the_state(rule):
    """The steps after the exit (some run on the card's eager path, none
    on the CPU's or in the graph) leave the poses and the step count as
    they are, bit for bit."""
    kind, max_iter, delta = _BA_EXITS[rule]
    sys_t, T0 = _dense_system(torch, kind)
    args = (t_(_LM_FREE), _LM_CAP, max_iter, delta, 1e-4)
    want = TFG._lm_loop(sys_t, t_(T0), *args)
    with mock.patch.object(TFG.device_loop, "run", _masked):
        got = TFG._lm_loop(sys_t, t_(T0), *args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _padded(E, B, ii, jj, mask, meas):
    """Edges, mask and channels padded from E to B rows as the factor
    graph pads them: ``ii = jj = 0``, zero channels, ``edge_mask`` 0."""
    pad = B - E

    def cat(a, fill):
        a = torch.as_tensor(np.asarray(a))
        return torch.cat([a, torch.full((pad,) + a.shape[1:], fill,
                                        dtype=a.dtype)])

    return (cat(ii, 0), cat(jj, 0), cat(mask, 0),
            tuple(cat(ch, 0) for ch in meas))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_padded_solve_matches_unpadded(kind, compute):
    """A padded row (identity relative pose, zero points) has an exactly
    zero, finite Gram in the plain K4 / K5, and the padded solve ends
    where the unpadded one does, within the JAX comparison's tolerance."""
    if kind == "rays":
        T_in, meas, ii, jj, mask, free = _lm_scene()
        real = mask > 0
        ii, jj, mask = ii[real], jj[real], mask[real]
        meas = tuple(np.array(ch)[real] for ch in meas)
        args = (0.003, 10.0, 12, 1e-9)
    else:
        T_in, meas, K, ii, jj, mask, hw = _calib_scene()
        meas = tuple(np.array(ch) for ch in meas)
        free = np.asarray([False, True, True])
        args = (hw, -10.0, 1e-6, 1.0, 10.0, 10, 1e-9)
    E = ii.shape[0]
    flat = (t_(ii.astype(np.int64)), t_(jj.astype(np.int64)), t_(mask),
            tuple(t_(ch) for ch in meas))
    padded = _padded(E, TFG._bucket(E), *flat)
    T = t_(T_in)
    if kind == "rays":
        _, rts = TFG._rel_pose_rows(T, *padded[:3])
        G = TK.gram_rays(rts, padded[3], 0.003, 10.0, compute_dtype=compute)
    else:
        _, rts = TFG._rel_pose_rows(T, *padded[:3], extra=(
            float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])))
        G = TK.gram_calib(rts, padded[3], hw, -10.0, 1e-6, 1.0, 10.0,
                          compute_dtype=compute)
    assert G.shape[0] == TFG._bucket(E) > E
    assert bool(G.isfinite().all()) and not G[E:].any()
    outs = []
    for ii_, jj_, mask_, meas_ in (flat, padded):
        if kind == "rays":
            outs.append(TFG.gauss_newton_rays(
                T, meas_, ii_, jj_, mask_, t_(free), *args,
                compute_dtype=compute))
        else:
            outs.append(TFG.gauss_newton_calib(
                T, meas_, t_(K), ii_, jj_, mask_, t_(free), *args,
                compute_dtype=compute))
    (T_a, it_a), (T_b, it_b) = outs
    assert int(it_a) == int(it_b) >= 1
    err = (T_a - T_b).abs().max().item()
    assert err <= (1e-5 if compute == "float32" else 1e-4), err


def test_bucket_matches_jax():
    for n in (0, 1, 7, 8, 9, 16, 17, 100):
        assert TFG._bucket(n) == JFG._bucket(n)


# ---------------------------------------------------------------------------
# The factor graph: cache invalidation and whole solves (stub model)
# ---------------------------------------------------------------------------

H_KF, W_KF = 16, 24
N_KF = H_KF * W_KF
CFG = {"local_opt": {"pin": 1, "C_conf": 0.0, "Q_conf": 0.0,
                     "min_match_frac": 0.0, "max_iters": 3,
                     "sigma_ray": 0.003, "sigma_dist": 0.1,
                     "delta_norm": 1e-8, "pixel_border": -10,
                     "depth_eps": 1e-6, "sigma_pixel": 1.0,
                     "sigma_depth": 10.0, "ba_compute_dtype": "float32"}}


class StubModel:
    """Identity-correspondence stand-in for MASt3RInference."""

    def __init__(self, torch_side):
        self.torch_side = torch_side

    def match_symmetric(self, feat_i, pos_i, feat_j, pos_j, img_hw,
                        init_i2j=None, init_j2i=None):
        b = feat_i.shape[0]
        if self.torch_side:
            idx = torch.arange(N_KF).expand(b, N_KF)
            return (idx, idx, torch.ones(b, N_KF, 1, dtype=torch.bool),
                    torch.ones(b, N_KF, 1, dtype=torch.bool),
                    *[torch.full((b, N_KF, 1), 4.0)] * 4)
        idx = jnp.broadcast_to(jnp.arange(N_KF, dtype=jnp.int32)[None],
                               (b, N_KF))
        valid = jnp.ones((b, N_KF, 1), bool)
        return (idx, idx, valid, valid, *[jnp.full((b, N_KF, 1), 4.0)] * 4)


def _keyframe_data(n_kf, noise, seed=13):
    rng = np.random.default_rng(seed)
    X_shared = (rng.random((N_KF, 3)) + [0, 0, 2.0]).astype(np.float32)
    out = []
    for i in range(n_kf):
        T_true = JL.exp(jnp.asarray([0.05 * i, 0, 0, 0, 0.02 * i, 0, 0.0]))
        X = np.array(JL.act(JL.inv(T_true)[None], jnp.asarray(X_shared)))
        xi = np.zeros(7, np.float32)
        if i > 0 and noise > 0:
            xi = (rng.normal(size=7) * noise).astype(np.float32)
        T0 = np.array(JL.compose(JL.exp(jnp.asarray(xi)), T_true))
        out.append((X, T0))
    return out


def _buffers(n_kf=4, noise=0.02):
    """The same keyframes in a JAX and a port KeyframeBuffer (CPU)."""
    kj = JFr.KeyframeBuffer(H_KF, W_KF, capacity=8, feat_dim=8)
    kt = TFr.KeyframeBuffer(H_KF, W_KF, capacity=8, feat_dim=8,
                            device="cpu")
    for i, (X, T0) in enumerate(_keyframe_data(n_kf, noise)):
        fj = JFr.Frame(frame_id=i, img=jnp.zeros((H_KF, W_KF, 3)),
                       img_shape=(H_KF, W_KF), img_true_shape=(H_KF, W_KF),
                       uimg=np.zeros((H_KF, W_KF, 3), np.float32),
                       T_WC=jnp.asarray(T0))
        fj.X_canon, fj.C, fj.N = jnp.asarray(X), jnp.ones((N_KF, 1)), 1
        fj.feat = jnp.zeros((1, kj.num_patches, 8))
        fj.pos = jnp.zeros((1, kj.num_patches, 2), jnp.int32)
        kj.append(fj)
        ft = TFr.Frame(frame_id=i, img=torch.zeros(H_KF, W_KF, 3),
                       img_shape=(H_KF, W_KF), img_true_shape=(H_KF, W_KF),
                       T_WC=t_(T0))
        ft.X_canon, ft.C, ft.N = t_(X), torch.ones(N_KF, 1), 1
        ft.feat = torch.zeros(1, kt.num_patches, 8)
        ft.pos = torch.zeros(1, kt.num_patches, 2, dtype=torch.int32)
        kt.append(ft)
    return kj, kt


@pytest.fixture
def graph():
    _, kt = _buffers()
    g = TFG.FactorGraph(StubModel(True), kt, CFG)
    assert g.add_factors([0, 1, 2], [1, 2, 3], 0.0)
    return g


def _cache_snapshot(g):
    g._ensure_meas("rays")
    return tuple(ch.clone() for ch in g._meas_ij)


def test_pose_update_does_not_invalidate(graph):
    before = _cache_snapshot(graph)
    ids_before = [id(ch) for ch in graph._meas_ij]
    kf = graph.keyframes
    kf.update_T_WCs(kf.T_WC[[1]], [1])        # pose-only write, as a solve
    assert kf.version[1] == 1 and kf.xc_version[1] == 1
    graph._ensure_meas("rays")
    assert [id(ch) for ch in graph._meas_ij] == ids_before
    for a, b in zip(before, graph._meas_ij):
        assert torch.equal(a, b)


def test_pointmap_update_invalidates_touched_edges(graph):
    before = _cache_snapshot(graph)
    kf = graph.keyframes
    kf.X[1] = kf.X[1] + 0.5                   # content write to keyframe 1
    kf.xc_version[1] += 1
    kf.version[1] += 1
    graph._ensure_meas("rays")
    after = graph._meas_ij
    for a, b in zip(before, after):           # edge (2 -> 3) untouched
        assert torch.equal(a[2], b[2])
    assert any(not torch.equal(a[1], b[1]) for a, b in zip(before, after))
    assert any(not torch.equal(a[0], b[0]) for a, b in zip(before, after))


def test_new_edges_append_without_recomputing_old(graph):
    before = _cache_snapshot(graph)
    graph.add_factors([0], [2], 0.0)
    graph._ensure_meas("rays")
    assert graph._meas_ij[0].shape[0] == 4
    assert torch.equal(graph._meas_ij[0][:3], before[0])
    assert graph._meas_ver_ij.shape[0] == 4


def test_mode_switch_drops_cache(graph):
    graph._ensure_meas("rays")
    assert graph._meas_kind == "rays" and len(graph._meas_ij) == 8
    graph.K = torch.tensor([[100.0, 0, 12.0], [0, 100.0, 8.0], [0, 0, 1.0]])
    graph._ensure_meas("calib")
    assert graph._meas_kind == "calib" and len(graph._meas_ij) == 7


def test_meas_dtype_stores_bfloat16():
    _, kt = _buffers()
    cfg = {"local_opt": dict(CFG["local_opt"], meas_dtype="bfloat16",
                             pixel_step=2)}
    g = TFG.FactorGraph(StubModel(True), kt, cfg)
    g.add_factors([0], [1], 0.0)
    g._ensure_meas("rays")
    assert all(ch.dtype == torch.bfloat16 and ch.shape == (1, N_KF // 2)
               for ch in g._meas_ij)


def test_solve_gn_rays_matches_jax_factor_graph():
    """Whole solves through both FactorGraphs on the same keyframes (the
    JAX one on its XLA path, float32 rows): poses, version bumps and the
    pinned first keyframe."""
    kj, kt = _buffers(noise=0.02)
    gj = JFG.FactorGraph(StubModel(False), kj, CFG)
    gt = TFG.FactorGraph(StubModel(True), kt, CFG)
    for g in (gj, gt):
        assert g.add_factors([0, 1, 2], [1, 2, 3], 0.0)
        g.solve_GN_rays()
    np.testing.assert_array_equal(gt.last_unique_kf_idx,
                                  gj.last_unique_kf_idx)
    np.testing.assert_allclose(kt.T_WC.numpy(), np.asarray(kj.T_WC),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(kt.version, kj.version)
    assert gt.last_solve_iters == 3
    _, kt0 = _buffers(noise=0.02)
    assert torch.equal(kt.T_WC[0], kt0.T_WC[0])
    assert not torch.equal(kt.T_WC[1:4], kt0.T_WC[1:4])


def test_solve_gn_calib_matches_jax_factor_graph():
    """The calibrated solve through both FactorGraphs (both pad their
    two-way edges to the bucket): poses within 1e-4 of JAX's XLA path,
    version bumps, the pinned first keyframe, and the padded buffers'
    rows."""
    K = np.asarray([[20.0, 0, 11.5], [0, 20.0, 7.5], [0, 0, 1]], np.float32)
    kj, kt = _buffers(noise=0.02)
    gj = JFG.FactorGraph(StubModel(False), kj, CFG, K=jnp.asarray(K))
    gt = TFG.FactorGraph(StubModel(True), kt, CFG, K=t_(K))
    for g in (gj, gt):
        assert g.add_factors([0, 1, 2], [1, 2, 3], 0.0)
        g.solve_GN_calib()
    np.testing.assert_allclose(kt.T_WC.numpy(), np.asarray(kj.T_WC),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(kt.version, kj.version)
    assert 1 <= gt.last_solve_iters <= 3
    _, kt0 = _buffers(noise=0.02)
    assert torch.equal(kt.T_WC[0], kt0.T_WC[0])
    assert not torch.equal(kt.T_WC[1:4], kt0.T_WC[1:4])
    ii2, jj2, mask, meas, n = gt._two_way_padded()
    assert n == 6 and ii2.shape[0] == 8
    assert ii2.tolist() == [0, 1, 2, 1, 2, 3, 0, 0]
    assert jj2.tolist() == [1, 2, 3, 0, 1, 2, 0, 0]
    assert mask.tolist() == [1.0] * 6 + [0.0] * 2
    assert len(meas) == 7 and not any(ch[6:].any() for ch in meas)


def test_padded_buffers_are_kept_per_bucket(graph):
    """The two-way buffers of a bucket are the same tensors solve after
    solve (a graphed solve reads them where they are), refilled in place;
    more edges move to the next bucket."""
    graph._ensure_meas("rays")
    first = graph._two_way_padded()
    again = graph._two_way_padded()
    for a, b in zip(first[:3] + first[3], again[:3] + again[3]):
        assert a is b
    assert first[4] == 6 and first[0].shape[0] == 8
    graph.add_factors([0, 0], [2, 3], 0.0)
    graph._ensure_meas("rays")
    ii2, _, mask, meas, n = graph._two_way_padded()
    assert n == 10 and ii2.shape[0] == 16 and mask.sum() == 10
    assert ii2[:10].tolist() == [0, 1, 2, 0, 0, 1, 2, 3, 2, 3]


@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_larger_bucket_replaces_the_smaller(graph, kind):
    """Edges are never removed: once the edges move to a larger bucket,
    the kind holds that bucket's buffers alone, and ``bucket_bytes``
    counts them (edge rows, mask, channels)."""
    graph.K = torch.tensor([[20.0, 0, 11.5], [0, 20.0, 7.5], [0, 0, 1.0]])
    graph._ensure_meas(kind)
    small = graph._two_way_padded()
    graph.add_factors([0, 0], [2, 3], 0.0)
    graph._ensure_meas(kind)
    ii2, _, mask, meas, _ = graph._two_way_padded()
    assert list(graph._buckets) == [kind]
    assert graph._buckets[kind][0] == 16 and ii2 is not small[0]
    assert all(ch.shape[0] == 16 for ch in meas)
    want = 16 * (2 * 8 + 4) + sum(ch.numel() * ch.element_size()
                                  for ch in meas)
    assert graph.bucket_bytes() == want
    assert len(meas) == (8 if kind == "rays" else 7)


def test_backend_states_queue_and_hint():
    s = TFr.States()
    s.queue_global_optimization(3)
    s.queue_global_optimization(4)
    assert s.pop_global_optimization() == 3
    s.set_kf_match_hint(3, 4, "idx", "valid", "Q")
    assert s.take_kf_match_hint(2, 3) is None     # not this edge: kept
    assert s.take_kf_match_hint(3, 4) == (3, 4, "idx", "valid", "Q")
    assert s.take_kf_match_hint() is None
    s.set_kf_match_hint(4, 5, "idx", "valid", "Q")
    s.set_kf_match_hint(5, 6, "idx2", "valid2", "Q2")   # the newest wins
    assert s.take_kf_match_hint() == (5, 6, "idx2", "valid2", "Q2")
    s.set_edges([0, 1], [1, 2])
    assert (s.edges_ii, s.edges_jj) == ([0, 1], [1, 2])
    assert s.pop_global_optimization() == 4
    assert s.pop_global_optimization() is None
    _, kt = _buffers(3)
    kt.pop_last()
    assert len(kt) == 2


# ---------------------------------------------------------------------------
# Edge creation with the model: the symmetric path and the hint path
# ---------------------------------------------------------------------------

H_M, W_M = 32, 48
MATCH_CFG = {"radius": 1, "dilation_max": 2}
LOCAL_CFG = {"local_opt": {
    "min_match_frac": 0.0, "Q_conf": 0.0, "C_conf": 0.0, "pin": 1,
    "max_iters": 2, "sigma_ray": 0.003, "sigma_dist": 10.0,
    "sigma_pixel": 1.0, "sigma_depth": 10.0, "delta_norm": 1e-8,
    "pixel_border": 3, "depth_eps": 1e-6, "warm_start_geo": False}}


@pytest.fixture(scope="module")
def model_graphs():
    """Two keyframes with numpy-seeded features in a JAX and a port buffer,
    and both packages' models with the same tiny weights."""
    cj, pj, ct, pt = tiny_weights()
    pj, pt = JM.prepare_params(pj, cj), TM.prepare_params(pt, ct)
    n, n_tok = H_M * W_M, (H_M // 16) * (W_M // 16)
    rng = np.random.default_rng(3)
    feats = [rng.normal(size=(1, n_tok, ct.enc_embed_dim)).astype(np.float32)
             for _ in range(2)]
    pos = TM.patch_positions(H_M // 16, W_M // 16, 1, "cpu")
    kj = JFr.KeyframeBuffer(H_M, W_M, capacity=4, feat_dim=ct.enc_embed_dim)
    kt = TFr.KeyframeBuffer(H_M, W_M, capacity=4, feat_dim=ct.enc_embed_dim,
                            device="cpu")
    for i in range(2):
        X = (np.random.default_rng(i).random((n, 3)) + [0, 0, 2.0]).astype(
            np.float32)
        fj = JFr.Frame(frame_id=i, img=jnp.zeros((H_M, W_M, 3)),
                       img_shape=(H_M, W_M), img_true_shape=(H_M, W_M),
                       uimg=np.zeros((H_M, W_M, 3), np.float32))
        fj.X_canon, fj.C, fj.N = jnp.asarray(X), jnp.ones((n, 1)), 1
        fj.feat, fj.pos = jnp.asarray(feats[i]), jnp.asarray(pos.numpy())
        kj.append(fj)
        ft = TFr.Frame(frame_id=i, img=torch.zeros(H_M, W_M, 3),
                       img_shape=(H_M, W_M), img_true_shape=(H_M, W_M))
        ft.X_canon, ft.C, ft.N = t_(X), torch.ones(n, 1), 1
        ft.feat, ft.pos = t_(feats[i]), pos
        kt.append(ft)
    return (JInference(pj, cj, MATCH_CFG), kj,
            MASt3RInference(pt, ct, MATCH_CFG), kt, feats, pos)


def _agree(a, b):
    return float((to_np(a) == to_np(b)).mean())


def test_symmetric_edge_matches_jax(model_graphs):
    """``add_factors`` through ``match_symmetric`` (decode at batch 2B, one
    matcher call per direction) in both packages."""
    mj, kj, mt, kt, *_ = model_graphs
    gj = JFG.FactorGraph(mj, kj, LOCAL_CFG)
    gt = TFG.FactorGraph(mt, kt, LOCAL_CFG)
    assert gj.add_factors([0], [1], 0.0) and gt.add_factors([0], [1], 0.0)
    for a, b in ((gt.idx_ii2jj, gj.idx_ii2jj), (gt.idx_jj2ii, gj.idx_jj2ii),
                 (gt.valid_match_j, gj.valid_match_j),
                 (gt.valid_match_i, gj.valid_match_i)):
        assert _agree(a, b) >= 0.995
    for qa, qb, ia, ib in ((gt.Q_ii2jj, gj.Q_ii2jj, gt.idx_ii2jj,
                            gj.idx_ii2jj),
                           (gt.Q_jj2ii, gj.Q_jj2ii, gt.idx_jj2ii,
                            gj.idx_jj2ii)):
        same = (to_np(ia) == to_np(ib))[..., None]
        np.testing.assert_allclose(to_np(qa)[same], to_np(qb)[same],
                                   rtol=1e-4, atol=1e-5)


def test_hint_path_matches_symmetric_path(model_graphs):
    """A 5-tuple hint (the tracker's j→i match reused, ``match_oneway`` for
    i→j) builds the same edge as the full symmetric path; the hint's data
    passes through verbatim."""
    _, _, mt, kt, feats, pos = model_graphs
    g_full = TFG.FactorGraph(mt, kt, LOCAL_CFG)
    assert g_full.add_factors([0], [1], 0.0)
    idx_j2i, valid_i, Qjj, Qij = mt.match_oneway(
        t_(feats[1]), pos, t_(feats[0]), pos, (H_M, W_M))
    Qi = torch.sqrt(Qjj[0][idx_j2i[0]] * Qij[0])[:, None]
    g_hint = TFG.FactorGraph(mt, kt, LOCAL_CFG)
    assert g_hint.add_factors([0], [1], 0.0,
                              init_hint=(0, 1, idx_j2i[0], valid_i[0], Qi))
    assert torch.equal(g_hint.idx_jj2ii[0], idx_j2i[0])
    assert torch.equal(g_hint.valid_match_i[0], valid_i[0])
    assert torch.equal(g_hint.Q_jj2ii[0], Qi)
    for a, b in ((g_hint.idx_jj2ii, g_full.idx_jj2ii),
                 (g_hint.idx_ii2jj, g_full.idx_ii2jj)):
        assert _agree(a, b) >= 0.995
    same = (g_hint.idx_ii2jj == g_full.idx_ii2jj)[..., None]
    torch.testing.assert_close(g_hint.Q_ii2jj[same], g_full.Q_ii2jj[same],
                               rtol=1e-4, atol=1e-5)


def test_hint_for_another_edge_is_not_used(model_graphs):
    """A hint whose (i, j) is not an edge of the batch leaves the edge to
    the symmetric path; a hint that is not the 5-tuple raises."""
    _, _, mt, kt, *_ = model_graphs
    g_full = TFG.FactorGraph(mt, kt, LOCAL_CFG)
    g_full.add_factors([0], [1], 0.0)
    n = H_M * W_M
    hint = (1, 2, torch.zeros(n, dtype=torch.long),
            torch.zeros(n, 1, dtype=torch.bool), torch.zeros(n, 1))
    g_other = TFG.FactorGraph(mt, kt, LOCAL_CFG)
    g_other.add_factors([0], [1], 0.0, init_hint=hint)
    assert torch.equal(g_other.idx_jj2ii, g_full.idx_jj2ii)
    assert torch.equal(g_other.idx_ii2jj, g_full.idx_ii2jj)
    with pytest.raises(ValueError, match="init_hint"):
        TFG.FactorGraph(mt, kt, LOCAL_CFG).add_factors(
            [0], [1], 0.0, init_hint=(0, 1, torch.arange(n)))


def test_geometric_warm_start_matches_jax(model_graphs):
    """``_geo_match_init``: both directions' projected inits."""
    _, kj, _, kt, *_ = model_graphs
    T = np.array(JL.exp(jnp.asarray(
        np.random.default_rng(4).normal(size=(2, 7)).astype(np.float32)
        * 0.05)))
    got = TFG._geo_match_init(kt.X[:1], kt.X[1:2], t_(T[:1]), t_(T[1:]),
                              (H_M, W_M))
    want = JFG._geo_match_init(kj.X[:1], kj.X[1:2], jnp.asarray(T[:1]),
                               jnp.asarray(T[1:]), (H_M, W_M))
    for g, w in zip(got, want):
        assert _agree(g, w) >= 0.999
