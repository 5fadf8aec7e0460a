"""Port parity: the matcher (mast3r_slam_tpu_torch/ops/matching.py) vs the
JAX package on oracle-scene pointmaps, under the strict evaluation and the
production matcher settings."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import matching as JMa
from mast3r_slam_tpu.utils.config import resolve_config
from mast3r_slam_tpu_torch.ops import matching as TMa
from mast3r_slam_tpu_torch.utils.oracle_scene import (OracleScene,
                                                       make_trajectory)
from torch_parity import torch_one_thread  # noqa: F401

HW = (48, 64)


def _match_kw(cfg_path, tracker):
    m = resolve_config(cfg_path)["matching"]
    dil = m.get("track_dilation_max", m["dilation_max"]) if tracker else \
        m["dilation_max"]
    return dict(
        max_iter=int(m["max_iter"]), lambda_init=float(m["lambda_init"]),
        convergence_thresh=float(m["convergence_thresh"]),
        dist_thresh=float(m["dist_thresh"]), radius=int(m["radius"]),
        dilation_max=int(dil), refine_mode=JMa.resolve_refine_mode(m),
        plateau_frac=float(m["plateau_frac"]),
        level_step=int(m["level_step"]), proj_step=int(m["proj_step"]))


def _oracle_pair(seed=0, frame=2, noise=0.003):
    """Frame pointmap X11 + descriptors D11, and the keyframe's points seen
    from the frame (X21) + the keyframe's descriptors (D21)."""
    scene = OracleScene(seed=seed, desc_dim=16)
    poses = make_trajectory(24, seed=seed + 1)
    K = scene.intrinsics(HW)
    rng = np.random.default_rng(seed)
    X_f, hits_f = scene.raycast(poses[frame], K, HW)
    _, hits_k = scene.raycast(poses[0], K, HW)
    X_kf = scene.world_to_cam(hits_k, poses[frame]).astype(np.float32)
    X11 = X_f + noise * X_f[:, 2:3] * rng.standard_normal(X_f.shape)
    X21 = X_kf + noise * X_kf[:, 2:3] * rng.standard_normal(X_kf.shape)
    D11 = scene.descriptors(hits_f)
    D21 = scene.descriptors(hits_k)
    h, w = HW
    return [a.astype(np.float32).reshape(1, h, w, -1)
            for a in (X11, X21, D11, D21)]


@pytest.mark.parametrize("cfg_path", ["config/eval_no_calib.yaml",
                                      "config/base.yaml"])
@pytest.mark.parametrize("tracker", [False, True])
def test_match_matches_jax(cfg_path, tracker):
    kw = _match_kw(cfg_path, tracker)
    arrs = _oracle_pair()
    n = HW[0] * HW[1]
    init = None
    if tracker:   # warm start: a shifted correspondence, as a previous frame
        init = np.clip(np.arange(n) + 2, 0, n - 1).astype(np.int32)[None]
    idx_j, val_j = JMa.match(*(jnp.asarray(a) for a in arrs),
                             idx_1_to_2_init=None if init is None
                             else jnp.asarray(init), **kw)
    idx_t, val_t = TMa.match(*(torch.from_numpy(a) for a in arrs),
                             idx_1_to_2_init=None if init is None
                             else torch.from_numpy(init), **kw)
    assert idx_t.shape == (1, n) and val_t.shape == (1, n, 1)
    idx_j, val_j = np.asarray(idx_j), np.asarray(val_j)
    assert val_j.mean() > 0.5            # the oracle pair really matches
    assert (idx_t.numpy() == idx_j).mean() >= 0.999
    assert (val_t.numpy() == val_j).mean() >= 0.999


@pytest.mark.parametrize("mode", ["plus", "separable", "joint"])
def test_refine_matches_modes(mode):
    _, _, D11, D21 = _oracle_pair(seed=3)
    h, w = HW
    rng = np.random.default_rng(5)
    p1 = np.stack([rng.integers(0, w, h * w), rng.integers(0, h, h * w)],
                  -1)[None].astype(np.int32)
    want = JMa.refine_matches(jnp.asarray(D11), jnp.asarray(D21).reshape(
        1, h * w, -1), jnp.asarray(p1), 2, 4, mode, 2)
    got = TMa.refine_matches(torch.from_numpy(D11), torch.from_numpy(
        D21).reshape(1, h * w, -1), torch.from_numpy(p1), 2, 4, mode, 2)
    assert (got.numpy() == np.asarray(want)).all(-1).mean() >= 0.999


def test_correction_field_resize_matches_jax():
    """proj_step = 2 upsamples the LM correction field: half-pixel bilinear
    with edge handling (jax.image.resize 'linear' == F.interpolate
    align_corners=False), pinned on a non-square field, borders included."""
    delta = np.random.default_rng(7).normal(size=(2, 6, 10, 2)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(delta), (2, 12, 20, 2), "linear")
    got = torch.nn.functional.interpolate(
        torch.from_numpy(delta).permute(0, 3, 1, 2), size=(12, 20),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_iter_proj_rows_keep_their_own_iteration_count():
    """Batch rows run their own LM loops (the JAX loop is vmapped): a batch
    of two different problems gives each row its single-row result."""
    a = _oracle_pair(seed=0)
    b = _oracle_pair(seed=1, frame=5)
    X11 = np.concatenate([a[0], b[0]])
    X21 = np.concatenate([a[1], b[1]])
    rays9, pts, p0 = TMa.prep_for_iter_proj(torch.from_numpy(X11),
                                            torch.from_numpy(X21), None)
    p, conv = TMa.iter_proj(rays9, pts, p0, 10, 1e-8, 1e-6, 0.001)
    for r in range(2):
        pr, cr = TMa.iter_proj(rays9[r:r + 1], pts[r:r + 1], p0[r:r + 1],
                               10, 1e-8, 1e-6, 0.001)
        assert torch.equal(p[r], pr[0]) and torch.equal(conv[r], cr[0])
    pj, cj = JMa.iter_proj(*(jnp.asarray(t.numpy()) for t in (rays9, pts,
                                                               p0)),
                           10, 1e-8, 1e-6, 0.001)
    assert (conv.numpy() == np.asarray(cj)).mean() >= 0.999


def _flat_pair():
    """Every pixel's point on one ray (the ray image is constant): each
    target is matched wherever the search starts, the border's clamped
    starts included."""
    h, w = HW
    X = np.broadcast_to(np.asarray([0.1, -0.2, 2.0], np.float32),
                        (1, h, w, 3)).copy()
    return X, X.copy()


# rule → (max_iter, plateau_frac, pair)
_PROJ_EXITS = {
    "iteration_cap": (2, 0.0, "oracle"),
    "all_converged": (10, 0.0, "flat"),
    "plateau": (10, 0.001, "oracle"),
}


def _proj_inputs(pair):
    X11, X21 = _flat_pair() if pair == "flat" else _oracle_pair()[:2]
    return TMa.prep_for_iter_proj(torch.from_numpy(X11),
                                  torch.from_numpy(X21), None)


@pytest.mark.parametrize("rule", list(_PROJ_EXITS))
def test_iter_proj_exit_rules_match_jax(rule):
    """The device-exit LM projection against JAX's ``lax.while_loop`` for
    each exit rule (the same tolerances as the matcher tests): the port's
    step count shows where it stopped, and JAX capped there with the
    plateau rule off ends at the same positions."""
    max_iter, plateau, pair = _PROJ_EXITS[rule]
    rays9, pts, p0 = _proj_inputs(pair)
    p, conv, iters = TMa._iter_proj_single(rays9[0], pts[0], p0[0], max_iter,
                                           1e-8, 1e-6, plateau)
    n = int(iters)
    if rule == "iteration_cap":
        assert n == max_iter and not bool(conv.all())
    elif rule == "all_converged":
        h, w = HW
        assert n == 0 and bool(conv.all())
        assert torch.equal(p, torch.stack([p0[0, :, 0].clamp(1.0, w - 2.0),
                                           p0[0, :, 1].clamp(1.0, h - 2.0)],
                                          -1))
    else:
        assert 2 <= n < max_iter
    for cap, frac in ((max_iter, plateau), (n, 0.0)):
        pj, cj = JMa.iter_proj(*(jnp.asarray(t.numpy()) for t in (rays9, pts,
                                                                   p0)),
                               cap, 1e-8, 1e-6, frac)
        assert (conv.numpy() == np.asarray(cj)[0]).mean() >= 0.999
        assert np.isclose(p.numpy(), np.asarray(pj)[0], rtol=0,
                          atol=1e-4).all(-1).mean() >= 0.999


@pytest.mark.parametrize("rule", ["iteration_cap", "plateau"])
def test_iter_proj_masked_steps_leave_the_state(rule):
    """The steps after the exit (some run on the card's eager path, none
    on the CPU or in the graph) change nothing."""
    max_iter, plateau, pair = _PROJ_EXITS[rule]
    rays9, pts, p0 = _proj_inputs(pair)
    args = (rays9[0], pts[0], p0[0], max_iter + 3, 1e-8, 1e-6, plateau)
    want = TMa._iter_proj_single(*args)

    def masked(cap, live, step):
        for _ in range(cap):
            step()

    with mock.patch.object(TMa.device_loop, "run", masked):
        got = TMa._iter_proj_single(*args)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
