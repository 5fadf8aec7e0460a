"""Projective / ray geometry (counterpart of ``mast3r_slam_tpu/ops/geometry.py``).

Validity is returned as masks. The Gauss-Newton Jacobians are
channels-first tensors, ``(rows, cols, N)`` with the pixels last — the JAX
package keeps the same layout as nested lists of per-pixel vectors; one
tensor per Jacobian keeps the number of launched kernels small — so the
tracker's normal equations are one ``(7, D*N)`` product.
"""

from __future__ import annotations

import torch

from mast3r_slam_tpu_torch.ops import lie


def point_to_ray_dist(X):
    """Points → unit-ray + distance residual space ``[r(3), d(1)]``."""
    d = torch.linalg.norm(X, dim=-1, keepdim=True)
    r = (1.0 / d) * X
    return torch.cat([r, d], dim=-1)


def decompose_K(K):
    return K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]


def project_calib(P, K, img_size, border: float = 0, z_eps: float = 0.0):
    """Pinhole projection to ``[u, v, log z]`` with border/depth validity;
    ``img_size`` is ``(H, W)``. Returns ``(pz (..., 3), valid (..., 1))``."""
    fx, fy, cx, cy = decompose_K(K)
    x, y, z = P[..., 0], P[..., 1], P[..., 2]
    H, W = img_size
    valid_z = z > z_eps
    z_safe = torch.where(valid_z, z, torch.ones_like(z))
    z_inv = 1.0 / z_safe
    u = fx * x * z_inv + cx
    v = fy * y * z_inv + cy
    valid_u = (u > border) & (u < W - 1 - border)
    valid_v = (v > border) & (v < H - 1 - border)
    valid = (valid_u & valid_v & valid_z)[..., None]
    logz = torch.where(valid_z, torch.log(z_safe), torch.zeros_like(z))
    return torch.stack([u, v, logz], dim=-1), valid


def backproject(p, z, K):
    """Pixels ``p (..., 2)`` + depths ``z (..., 1)`` → camera-frame points."""
    x = (p[..., 0] - K[0, 2]) / K[0, 0]
    y = (p[..., 1] - K[1, 2]) / K[1, 1]
    dirs = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return z * dirs


def get_pixel_coords(img_size, dtype=torch.float32, device=None):
    """Dense pixel grid ``(H*W, 2)`` in (u, v) order, row-major over v."""
    H, W = img_size
    u = torch.arange(W, dtype=dtype, device=device)
    v = torch.arange(H, dtype=dtype, device=device)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return torch.stack([uu, vv], dim=-1).reshape(-1, 2)


def _nanmedian(x):
    """Median over the last axis ignoring NaNs, as the mean of the two
    middle values (``jnp.nanmedian``; ``torch.nanmedian`` returns the lower
    one). NaN where a row has no finite value."""
    s = x.sort(dim=-1).values                       # NaNs sort last
    n = (~torch.isnan(x)).sum(-1, keepdim=True)
    lo = ((n - 1) // 2).clamp_min(0)
    med = 0.5 * (s.gather(-1, lo) + s.gather(-1, n // 2))
    return torch.where(n > 0, med, torch.full_like(med, float("nan")))[..., 0]


def estimate_focal(X, img_size, min_ratio=0.05):
    """Median-based pinhole focal estimate of a canonical pointmap
    ``X (..., H*W, 3)`` (principal point at the image center): the focal
    ``(u - cx) / (x / z)`` over pixels with a ray slope above
    ``min_ratio``, both axes pooled. It only warm-starts the backend
    matcher, so its errors cost LM iterations, never correctness."""
    H, W = img_size
    uv = get_pixel_coords(img_size, dtype=X.dtype, device=X.device)
    z = X[..., 2].clamp_min(1e-8)
    r = torch.cat([X[..., 0] / z, X[..., 1] / z], dim=-1)
    d = torch.cat([uv[..., 0] - (W - 1) / 2.0, uv[..., 1] - (H - 1) / 2.0],
                  dim=-1).expand(r.shape)
    ok = r.abs() > min_ratio
    f = torch.where(ok, d / torch.where(ok, r, torch.ones_like(r)),
                    torch.full_like(r, float("nan")))
    return _nanmedian(f)


def project_to_index(X_src, T_src, T_dst, focal, img_size):
    """Project source-camera points ``X_src (..., N, 3)`` into the
    destination keyframe's pixel grid through the Sim3 world-from-camera
    poses ``T_src``, ``T_dst (..., 8)`` with the destination focal
    ``focal (...)``. Returns the flat pixel indices ``(..., N)`` (int64),
    clipped to the image: the geometric warm start of a backend edge. A
    non-finite projection (a NaN focal) lands on pixel 0 rather than on an
    undefined integer."""
    H, W = img_size
    T_rel = lie.compose(lie.inv(T_dst), T_src)
    if T_rel.ndim == X_src.ndim - 1:
        T_rel = T_rel[..., None, :]
    P = lie.act(T_rel, X_src)
    z = P[..., 2].clamp_min(1e-8)
    u = focal[..., None] * (P[..., 0] / z) + (W - 1) / 2.0
    v = focal[..., None] * (P[..., 1] / z) + (H - 1) / 2.0
    ui = torch.nan_to_num(torch.round(u), nan=0.0).clamp(0, W - 1).long()
    vi = torch.nan_to_num(torch.round(v), nan=0.0).clamp(0, H - 1).long()
    return vi * W + ui


def constrain_points_to_ray(img_size, Xs, K):
    """Keep each point's z, put x and y on the pinhole ray of its own pixel
    (calibrated mode). ``Xs (..., H*W, 3)``."""
    uv = get_pixel_coords(img_size, dtype=Xs.dtype, device=Xs.device)
    uv = uv.expand(Xs.shape[:-1] + (2,))
    return backproject(uv, Xs[..., 2:3], K)


def point_jac(Xw):
    """Local Sim3 point Jacobian ``[I | -skew(X') | X']`` of ``Xw (N, 3)``
    as a ``(3, 7, N)`` tensor."""
    x, y, z = Xw.T
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([one, zero, zero, zero, z, -y, x]),
        torch.stack([zero, one, zero, -z, zero, x, y]),
        torch.stack([zero, zero, one, y, -x, zero, z]),
    ])


def compose_jac(d_res, d_pt, negate=False):
    """``(D, 3, N)`` ∘ ``(3, 7, N)`` → ``(D, 7, N)``, summed over the 3 in
    the JAX package's order (term 0 + term 1, then + term 2)."""
    s = (d_res[:, 0, None] * d_pt[0] + d_res[:, 1, None] * d_pt[1]
         + d_res[:, 2, None] * d_pt[2])
    return -s if negate else s

