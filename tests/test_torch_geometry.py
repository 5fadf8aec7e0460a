"""Port parity: robust weights, ray/projection geometry, the Jacobian
channel helpers and image gradients vs the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import geometry as JG
from mast3r_slam_tpu.ops import image as JI
from mast3r_slam_tpu.ops import robust as JR
from mast3r_slam_tpu_torch.ops import geometry as TG
from mast3r_slam_tpu_torch.ops import image as TI
from mast3r_slam_tpu_torch.ops import robust as TR
from torch_parity import torch_one_thread  # noqa: F401

RNG = np.random.default_rng(71)
K = np.asarray([[50.0, 0, 15.5], [0, 52.0, 11.5], [0, 0, 1]], np.float32)
t_ = torch.from_numpy


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _points(n=200):
    X = RNG.normal(size=(n, 3)).astype(np.float32)
    X[:, 2] = np.abs(X[:, 2]) + 0.5
    X[:5, 2] = -0.3       # behind the camera
    return X


def test_huber_matches_jax():
    r = RNG.normal(size=500).astype(np.float32) * 3
    _close(TR.huber(t_(r), 1.345), JR.huber(jnp.asarray(r), 1.345))


def test_ray_dist_matches_jax():
    X = _points()
    _close(TG.point_to_ray_dist(t_(X)), JG.point_to_ray_dist(jnp.asarray(X)))


@pytest.mark.parametrize("border", [0.0, -10.0])
def test_project_calib_matches_jax(border):
    X = _points()
    pz_t, v_t = TG.project_calib(t_(X), t_(K), (24, 32), border=border)
    pz_j, v_j = JG.project_calib(jnp.asarray(X), jnp.asarray(K), (24, 32),
                                 border=border)
    _close(pz_t, pz_j, tol=1e-5)
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


def test_constrain_points_to_ray_matches_jax():
    X = _points(24 * 32)
    _close(TG.constrain_points_to_ray((24, 32), t_(X), t_(K)),
           JG.constrain_points_to_ray((24, 32), jnp.asarray(X),
                                      jnp.asarray(K)), tol=1e-5)
    _close(TG.get_pixel_coords((24, 32)), JG.get_pixel_coords((24, 32)))


def test_jacobians_match_jax_channel_lists():
    """The port's (rows, cols, N) Jacobian tensors hold exactly the JAX
    package's nested channel lists."""
    X = _points(50)
    d_res = np.stack([np.stack([X[:, i] * (a + 1) for i in range(3)])
                      for a in range(4)])                      # (4, 3, N)
    Pt = TG.point_jac(t_(X))
    Pj = JG.point_jac_channels(jnp.asarray(X))
    Jt = TG.compose_jac(t_(d_res), Pt, negate=True)
    Jj = JG.compose_jac_channels(
        [[jnp.asarray(d_res[a, i]) for i in range(3)] for a in range(4)],
        Pj, negate=True)
    assert Pt.shape == (3, 7, 50) and Jt.shape == (4, 7, 50)
    for i in range(3):
        for k in range(7):
            _close(Pt[i, k], jnp.broadcast_to(Pj[i][k], (50,)), tol=0)
    for a in range(4):
        for k in range(7):
            _close(Jt[a, k], Jj[a][k], tol=0)


def test_img_gradient_matches_jax():
    img = RNG.normal(size=(2, 9, 13, 3)).astype(np.float32)
    for got, want in zip(TI.img_gradient(t_(img)),
                         JI.img_gradient(jnp.asarray(img))):
        _close(got, want)


def _pointmap(h, w, seed):
    rng = np.random.default_rng(seed)
    uv = np.stack(np.meshgrid(np.arange(w), np.arange(h), indexing="xy"),
                  -1).reshape(-1, 2).astype(np.float32)
    z = (2.0 + rng.random((h * w, 1))).astype(np.float32)
    f = 40.0 + 5.0 * seed
    xy = (uv - [(w - 1) / 2.0, (h - 1) / 2.0]) / f * z
    return np.concatenate([xy, z], -1).astype(np.float32)


def test_estimate_focal_matches_jax():
    """Median focal of pointmaps, an even and an odd count of usable
    slopes, plus a map with no usable slope (NaN in both)."""
    X = np.stack([_pointmap(12, 16, s) for s in (1, 2)])
    X[1, :5, 2] = 1e6                     # changes the sample count parity
    flat = X[:1].copy()
    flat[..., :2] = 0.0
    for arr in (X, flat):
        got = TG.estimate_focal(t_(arr), (12, 16))
        want = np.asarray(JG.estimate_focal(jnp.asarray(arr), (12, 16)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert np.isnan(TG.estimate_focal(t_(flat), (12, 16)).numpy()).all()


def test_project_to_index_matches_jax():
    from mast3r_slam_tpu.ops import lie as JL

    X = np.stack([_pointmap(12, 16, s) for s in (1, 2)])
    xi = RNG.normal(size=(2, 2, 7)).astype(np.float32) * 0.05
    T_src, T_dst = (np.array(JL.exp(jnp.asarray(xi[:, k]))) for k in (0, 1))
    f = np.asarray([41.0, 47.5], np.float32)
    got = TG.project_to_index(t_(X), t_(T_src), t_(T_dst), t_(f), (12, 16))
    want = JG.project_to_index(jnp.asarray(X), jnp.asarray(T_src),
                               jnp.asarray(T_dst), jnp.asarray(f), (12, 16))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bilinear_sample_matches_jax():
    """Within 1e-6: coordinates inside [1, W-2] x [1, H-2] (the matcher's
    clamp), on integer pixels, and past the far edges (the index clamp)."""
    rng = np.random.default_rng(72)
    img = rng.normal(size=(11, 17, 4)).astype(np.float32)
    uv = np.stack([rng.uniform(1, 15, (3, 50)), rng.uniform(1, 9, (3, 50))],
                  -1).astype(np.float32)
    uv[0, :10] = np.round(uv[0, :10])
    uv[1, :5] = [16.0, 10.0]
    uv[1, 5:10] = [16.5, 3.25]
    _close(TI.bilinear_sample(t_(img), t_(uv)),
           JI.bilinear_sample(jnp.asarray(img), jnp.asarray(uv)))
