"""Sim(3) / SE(3) Lie-group operations in PyTorch.

Counterpart of ``mast3r_slam_tpu/ops/lie.py`` with the same conventions:

- Sim(3) elements are ``(..., 8)`` tensors ``[tx ty tz, qx qy qz qw, s]``
  (xyzw quaternion, ``s`` the scale itself).
- Group action ``T * X = s * R @ X + t``.
- Tangent vectors ``(..., 7)`` ordered ``[tau(3), phi(3), sigma]``.
- Retraction is left-multiplicative: ``retr(T, xi) = exp(xi) ∘ T``.

All functions broadcast over leading dimensions and are branchless
(``torch.where`` on guarded operands), so small angles and scales stay
f32-stable exactly as in the JAX package.
"""

from __future__ import annotations

import torch

_EPS = 1e-8  # small-angle / small-log-scale series switch


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(q1, q2):
    """Hamilton product ``q1 * q2`` for xyzw quaternions."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_inv(q):
    """Conjugate of a unit quaternion."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_act(q, v):
    """Rotate vectors ``v (..., 3)`` by unit quaternions ``q (..., 4)``."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * _cross(qv, v)
    return v + qw * uv + _cross(qv, uv)


def quat_to_matrix(q):
    """Unit quaternion → rotation matrix ``(..., 3, 3)``."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R):
    """Rotation matrix → unit quaternion (xyzw), branchless Shepperd's
    method: the four candidate constructions, the one with the largest
    diagonal term taken."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_root(x):
        return torch.sqrt(x.clamp_min(1e-12)) / 2.0

    qw0 = half_root(1.0 + tr)
    q0 = torch.stack([m21 - m12, m02 - m20, m10 - m01, 4.0 * qw0 * qw0],
                     -1) / (4.0 * qw0[..., None])
    qx1 = half_root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([4.0 * qx1 * qx1, m01 + m10, m02 + m20, m21 - m12],
                     -1) / (4.0 * qx1[..., None])
    qy2 = half_root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([m01 + m10, 4.0 * qy2 * qy2, m12 + m21, m02 - m20],
                     -1) / (4.0 * qy2[..., None])
    qz3 = half_root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([m02 + m20, m12 + m21, 4.0 * qz3 * qz3, m10 - m01],
                     -1) / (4.0 * qz3[..., None])
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], -1)
    best = scores.argmax(-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        *best.shape, 1, 4))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def skew(v):
    """``(..., 3) → (..., 3, 3)`` cross-product matrix."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def so3_exp_quat(phi):
    """so(3) vector → unit quaternion (xyzw) with Taylor fallback near 0."""
    theta_sq = (phi * phi).sum(-1)
    small = theta_sq < _EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq),
                                   theta_sq))
    imag_e = torch.sin(0.5 * theta) / theta
    real_e = torch.cos(0.5 * theta)
    t4 = theta_sq * theta_sq
    imag_s = 0.5 - theta_sq / 48.0 + t4 / 3840.0
    real_s = 1.0 - theta_sq / 8.0 + t4 / 384.0
    imag = torch.where(small, imag_s, imag_e)
    real = torch.where(small, real_s, real_e)
    return torch.cat([imag[..., None] * phi, real[..., None]], dim=-1)


def so3_log(q):
    """Unit quaternion → so(3) vector (angle in (-pi, pi])."""
    qv = q[..., :3]
    qw = q[..., 3]
    nv_sq = (qv * qv).sum(-1)
    small = nv_sq < _EPS
    nv = torch.sqrt(torch.where(small, torch.ones_like(nv_sq), nv_sq))
    theta = 2.0 * torch.atan2(nv, qw)
    factor_e = theta / nv
    factor_s = 2.0 / torch.where(qw.abs() < 1e-12, torch.ones_like(qw), qw)
    factor = torch.where(small, factor_s, factor_e)
    return factor[..., None] * qv


def identity(shape=(), dtype=torch.float32, device=None):
    """Identity Sim(3) element(s) of batch shape ``shape``."""
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1, 1], dtype=dtype, device=device)
    return base.expand(tuple(shape) + (8,)).clone()


def translation(T):
    return T[..., 0:3]


def quaternion(T):
    return T[..., 3:7]


def scale(T):
    return T[..., 7:8]


def act(T, X):
    """Apply Sim(3) ``T (..., 8)`` to points ``X (..., 3)`` (broadcasting)."""
    return scale(T) * quat_act(quaternion(T), X) + translation(T)


def _unit(q):
    """Renormalize a quaternion (rsqrt of its squared norm)."""
    return q * torch.rsqrt((q * q).sum(-1, keepdim=True).clamp_min(1e-30))


def compose(Ta, Tb):
    """Group composition ``Ta ∘ Tb``.

    The product quaternion is renormalized: ``quat_inv`` (the conjugate)
    inverts only unit quaternions and ``act`` scales points by |q|², so
    without it a norm error grows as (1+ε)³ per frame through the tracker's
    pose chain and explodes after ~33 frames."""
    q = _unit(quat_mul(quaternion(Ta), quaternion(Tb)))
    t = act(Ta, translation(Tb))
    s = scale(Ta) * scale(Tb)
    return torch.cat([t, q, s], dim=-1)


def inv(T):
    """Group inverse ``(R, t, s)^-1 = (R^T, -(1/s) R^T t, 1/s)`` with the
    conjugate renormalized (see :func:`compose`)."""
    qi = _unit(quat_inv(quaternion(T)))
    s_inv = 1.0 / scale(T)
    t_inv = -s_inv * quat_act(qi, translation(T))
    return torch.cat([t_inv, qi, s_inv], dim=-1)


# Below this magnitude of (theta, sigma) the closed-form W coefficients
# suffer catastrophic f32 cancellation, so the exact Taylor series of
# W = sum_n M^n/(n+1)!, M = sigma*I + Phi, is used instead (12 terms give
# truncation < 1e-12 for |M| < 0.3, where every closed-form denominator is
# >= 0.3 — f32-safe on both sides).
_W_SERIES_THRESH_SQ = 0.3 ** 2
_W_SERIES_TERMS = 12


def _w_series(theta_sq, sigma):
    """(C, A, B) by the M^n/(n+1)! recurrence in the {I, Phi, Phi^2} basis."""
    cI = torch.ones_like(sigma)
    cP = torch.zeros_like(sigma)
    cP2 = torch.zeros_like(sigma)
    C = torch.zeros_like(sigma)
    A = torch.zeros_like(sigma)
    B = torch.zeros_like(sigma)
    fact = 1.0
    for n in range(_W_SERIES_TERMS):
        fact *= n + 1
        inv_f = 1.0 / fact
        C = C + cI * inv_f
        A = A + cP * inv_f
        B = B + cP2 * inv_f
        cI, cP, cP2 = (
            sigma * cI,
            cI + sigma * cP - theta_sq * cP2,
            cP + sigma * cP2,
        )
    return C, A, B


def _sim3_W_coeffs(theta_sq, sigma):
    """Coefficients (C, A, B) of ``W = C I + A Phi + B Phi^2`` for the Sim(3)
    exp: closed form for large arguments, the f32-stable series near zero."""
    one = torch.ones_like(sigma)
    t_small = theta_sq < _W_SERIES_THRESH_SQ
    s_small = sigma * sigma < _W_SERIES_THRESH_SQ
    series = t_small & s_small

    C_s, A_s, B_s = _w_series(theta_sq, sigma)

    theta_sq_l = torch.where(t_small, one, theta_sq)
    theta_l = torch.sqrt(theta_sq_l)
    sigma_l = torch.where(s_small, one, sigma)
    scale_f = torch.exp(sigma)

    C_e = (scale_f - 1.0) / sigma_l
    C = torch.where(s_small, C_s, C_e)

    c_ts = sigma * sigma + theta_sq
    c_ts_safe = torch.where(series, one, c_ts)
    A_ls = (
        scale_f * (sigma - 1.0) + 1.0
        + theta_sq * scale_f * (0.5 - sigma / 6.0)
        + theta_sq * theta_sq * scale_f * (sigma / 120.0 - 1.0 / 24.0)
    ) / c_ts_safe
    B_ls = (
        C - scale_f * (1.0 - 0.5 * sigma)
        + theta_sq * scale_f * (1.0 / 6.0 - sigma / 24.0)
        + theta_sq * theta_sq * scale_f * (sigma / 720.0 - 1.0 / 120.0)
    ) / c_ts_safe
    a = scale_f * torch.sin(theta_l)
    b = scale_f * torch.cos(theta_l)
    c = theta_sq_l + sigma * sigma
    A_ll = (a * sigma + (1.0 - b) * theta_l) / (theta_l * c)
    B_ll = (C - ((b - 1.0) * sigma + a * theta_l) / c) / theta_sq_l

    A = torch.where(series, A_s, torch.where(t_small, A_ls, A_ll))
    B = torch.where(series, B_s, torch.where(t_small, B_ls, B_ll))
    return C, A, B


def exp(xi):
    """Sim(3) exponential map: tangent ``(..., 7)`` → group ``(..., 8)``."""
    tau = xi[..., 0:3]
    phi = xi[..., 3:6]
    sigma = xi[..., 6]
    q = so3_exp_quat(phi)
    s = torch.exp(sigma)[..., None]
    theta_sq = (phi * phi).sum(-1)
    C, A, B = _sim3_W_coeffs(theta_sq, sigma)
    phi_x_tau = _cross(phi, tau)
    phi_x2_tau = _cross(phi, phi_x_tau)
    t = C[..., None] * tau + A[..., None] * phi_x_tau + B[..., None] * phi_x2_tau
    return torch.cat([t, q, s], dim=-1)


def log(T):
    """Sim(3) logarithm (inverse of :func:`exp`): solves ``t = W tau``."""
    phi = so3_log(quaternion(T))
    sigma = torch.log(scale(T)[..., 0])
    theta_sq = (phi * phi).sum(-1)
    C, A, B = _sim3_W_coeffs(theta_sq, sigma)
    Phi = skew(phi)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(Phi.shape)
    W = (C[..., None, None] * eye + A[..., None, None] * Phi
         + B[..., None, None] * (Phi @ Phi))
    tau = torch.linalg.solve(W, translation(T)[..., None])[..., 0]
    return torch.cat([tau, phi, sigma[..., None]], dim=-1)


def retr(T, xi):
    """Left-multiplicative retraction ``exp(xi) ∘ T``."""
    return compose(exp(xi), T)


def matrix(T):
    """Sim(3) → ``(..., 4, 4)`` homogeneous matrix with ``sR`` upper-left."""
    sR = scale(T)[..., None] * quat_to_matrix(quaternion(T))
    top = torch.cat([sR, translation(T)[..., None]], dim=-1)
    bottom = T.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(T.shape[:-1] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def adjoint(T):
    """Sim(3) adjoint ``(..., 7, 7)`` in [tau, phi, sigma] ordering:
    ``[[sR, [t]x R, -t], [0, R, 0], [0, 0, 1]]``, so that
    ``T exp(xi) T^-1 = exp(Adj(T) xi)``."""
    R = quat_to_matrix(quaternion(T))
    t = translation(T)
    s = scale(T)[..., None]
    batch = T.shape[:-1]
    z33 = T.new_zeros(batch + (3, 3))
    z31 = T.new_zeros(batch + (3, 1))
    row0 = torch.cat([s * R, skew(t) @ R, -t[..., None]], dim=-1)
    row1 = torch.cat([z33, R, z31], dim=-1)
    row2 = torch.cat([T.new_zeros(batch + (1, 6)),
                      T.new_ones(batch + (1, 1))], dim=-1)
    return torch.cat([row0, row1, row2], dim=-2)


def normalize(T):
    """Re-normalize the quaternion part (drift after many composes)."""
    q = quaternion(T)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.cat([translation(T), q, scale(T)], dim=-1)


# ---------------------------------------------------------------------------
# SE(3) ``[t q]`` (trajectory export)
# ---------------------------------------------------------------------------

def se3_identity(shape=(), dtype=torch.float32, device=None):
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)
    return base.expand(tuple(shape) + (7,)).clone()


def se3_act(T, X):
    return quat_act(T[..., 3:7], X) + T[..., 0:3]


def se3_compose(Ta, Tb):
    q = _unit(quat_mul(Ta[..., 3:7], Tb[..., 3:7]))
    t = se3_act(Ta, Tb[..., 0:3])
    return torch.cat([t, q], dim=-1)


def se3_inv(T):
    qi = _unit(quat_inv(T[..., 3:7]))
    return torch.cat([-quat_act(qi, T[..., 0:3]), qi], dim=-1)


def sim3_to_se3(T):
    """Drop the scale: Sim(3) ``[t q s]`` → SE(3) ``[t q]``."""
    return T[..., 0:7]
