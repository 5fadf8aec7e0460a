"""Port parity: Sim(3) ops (mast3r_slam_tpu_torch/ops/lie.py) vs the JAX
package, including near-zero angles and scales, and the renormalized
compose chain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import lie as JL
from mast3r_slam_tpu_torch.ops import lie as TL
from torch_parity import torch_one_thread  # noqa: F401

RNG = np.random.default_rng(11)


def _tangents(n=64):
    xi = RNG.normal(size=(n, 7)).astype(np.float32) * 0.4
    xi[:8, 3:6] *= 1e-5          # near-zero angles
    xi[8:16, 6] *= 1e-6          # near-zero log-scales
    xi[16:24] *= 1e-7            # both
    xi[24:28, 3:6] = 0.0         # exactly zero angle
    return xi


def _poses(n=64):
    return np.array(JL.exp(jnp.asarray(_tangents(n))))


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("op", ["exp", "log", "inv", "compose", "act",
                                "retr"])
def test_lie_matches_jax(op):
    xi = _tangents()
    Ta, Tb = _poses(), _poses()
    X = RNG.normal(size=(64, 3)).astype(np.float32)
    t = torch.from_numpy
    if op == "exp":
        _close(TL.exp(t(xi)), JL.exp(jnp.asarray(xi)))
    elif op == "log":
        _close(TL.log(t(Ta)), JL.log(jnp.asarray(Ta)))
    elif op == "inv":
        _close(TL.inv(t(Ta)), JL.inv(jnp.asarray(Ta)))
    elif op == "compose":
        _close(TL.compose(t(Ta), t(Tb)),
               JL.compose(jnp.asarray(Ta), jnp.asarray(Tb)))
    elif op == "act":
        _close(TL.act(t(Ta), t(X)), JL.act(jnp.asarray(Ta), jnp.asarray(X)))
    else:
        _close(TL.retr(t(Ta), t(xi)),
               JL.retr(jnp.asarray(Ta), jnp.asarray(xi)))


def test_quaternion_helpers_match_jax():
    q1 = RNG.normal(size=(16, 4)).astype(np.float32)
    q2 = RNG.normal(size=(16, 4)).astype(np.float32)
    v = RNG.normal(size=(16, 3)).astype(np.float32)
    t = torch.from_numpy
    _close(TL.quat_mul(t(q1), t(q2)), JL.quat_mul(jnp.asarray(q1),
                                                 jnp.asarray(q2)))
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    _close(TL.quat_act(t(q1), t(v)), JL.quat_act(jnp.asarray(q1),
                                                jnp.asarray(v)))
    _close(TL.so3_log(t(q1)), JL.so3_log(jnp.asarray(q1)))


def test_exp_log_roundtrip_near_zero():
    """The f32 series guards keep exp/log exact near zero angle and scale."""
    xi = np.zeros((5, 7), np.float32)
    xi[1, 3] = 1e-6
    xi[2, 6] = 1e-7
    xi[3] = 1e-8
    xi[4, :3] = 0.3
    back = TL.log(TL.exp(torch.from_numpy(xi)))
    np.testing.assert_allclose(back.numpy(), xi, atol=1e-6)


def test_compose_chain_stays_unit():
    """64 composes keep |q| = 1 (the renormalization the tracker's pose chain
    needs; without it the norm error compounds per frame)."""
    steps = torch.from_numpy(_poses(64))
    T = TL.identity()
    for i in range(64):
        T = TL.compose(TL.inv(steps[i]), TL.compose(T, steps[i]))
        T = TL.compose(T, steps[(i + 7) % 64])
    assert abs(float(torch.linalg.norm(T[3:7])) - 1.0) < 1e-5


@pytest.mark.parametrize("op", ["quat_to_matrix", "matrix", "adjoint"])
def test_matrix_forms_match_jax(op):
    T = _poses()
    arg = T[:, 3:7] if op == "quat_to_matrix" else T
    _close(getattr(TL, op)(torch.from_numpy(np.ascontiguousarray(arg))),
           getattr(JL, op)(jnp.asarray(arg)), tol=2e-6)


def test_adjoint_moves_tangents_through_the_group():
    """``T exp(xi) T⁻¹ = exp(Adj(T) xi)``, the identity the BA's world-frame
    blocks rest on."""
    T = torch.from_numpy(_poses(16))
    xi = torch.from_numpy(RNG.normal(size=(16, 7)).astype(np.float32) * 0.05)
    lhs = TL.compose(TL.compose(T, TL.exp(xi)), TL.inv(T))
    rhs = TL.exp((TL.adjoint(T) @ xi[..., None])[..., 0])
    _close(TL.matrix(lhs), TL.matrix(rhs), tol=2e-5)


def _rotations():
    """Random rotations, the identity and the half-turns about each axis
    and a diagonal (each of matrix_to_quat's four constructions wins)."""
    rng = np.random.default_rng(13)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = np.float32(np.sqrt(0.5))
    special = np.array([[0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0],
                        [0, 0, 1, 0], [s, s, 0, 0], [0, s, s, 0]],
                       np.float32)
    return np.array(JL.quat_to_matrix(jnp.asarray(np.concatenate(
        [q, special]))))


@pytest.mark.parametrize("op", ["matrix_to_quat", "normalize",
                                "se3_identity", "se3_act", "se3_compose",
                                "se3_inv", "sim3_to_se3"])
def test_se3_and_matrix_helpers_match_jax(op):
    """Within 1e-6 (``_close``), as the Sim(3) operations."""
    rng = np.random.default_rng(14)
    Ta, Tb = _poses(), _poses()
    Sa, Sb = Ta[:, :7].copy(), Tb[:, :7].copy()
    X = rng.normal(size=(64, 3)).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    if op == "matrix_to_quat":
        R = _rotations()
        _close(TL.matrix_to_quat(t(R)), JL.matrix_to_quat(j(R)))
    elif op == "normalize":
        T = Ta.copy()
        T[:, 3:7] *= rng.uniform(0.5, 2.0, (64, 1)).astype(np.float32)
        _close(TL.normalize(t(T)), JL.normalize(j(T)))
    elif op == "se3_identity":
        got = TL.se3_identity((2, 3), device="cpu")
        _close(got, JL.se3_identity((2, 3)))
        assert TL.se3_identity(dtype=torch.float64).dtype == torch.float64
    elif op == "se3_act":
        _close(TL.se3_act(t(Sa), t(X)), JL.se3_act(j(Sa), j(X)))
    elif op == "se3_compose":
        _close(TL.se3_compose(t(Sa), t(Sb)), JL.se3_compose(j(Sa), j(Sb)))
    elif op == "se3_inv":
        _close(TL.se3_inv(t(Sa)), JL.se3_inv(j(Sa)))
    else:
        _close(TL.sim3_to_se3(t(Ta)), JL.sim3_to_se3(j(Ta)))
