"""Undistortion without OpenCV: the port's counterpart of the three
``cv2`` calls in ``mast3r_slam_tpu/data/datasets.py::Intrinsics``.

- :func:`optimal_new_camera_matrix` is ``cv2.getOptimalNewCameraMatrix(K,
  dist, (W, H), alpha=0, newImgSize=(W, H))`` as OpenCV 5.0 computes it:
  a 9x9 grid over ``[0, W-1] x [0, H-1]`` undistorted with 5 fixed-point
  iterations, the largest rectangle inside it, ``f = (W-1) / width``.
  Older OpenCV releases divide ``W`` (not ``W-1``) by the width, a new K
  0.5-0.9 px apart on EuRoC cam0: the JAX package's K depends on the
  ``cv2`` it runs with, and this one follows 5.0.
- :func:`undistort_rectify_map` is ``cv2.initUndistortRectifyMap`` (no
  rectification, ``CV_32FC1``) in float64, cast to float32; it gives
  OpenCV's maps bit for bit.
- :class:`RemapTables` and :func:`remap_bilinear` are ``cv2.remap(img,
  mapx, mapy, INTER_LINEAR)`` with ``BORDER_CONSTANT`` 0 on a float32
  image. OpenCV 5.0 interpolates in float with fused multiply-adds,
  ``v0 = fma(tx, b - a, a)``, ``v1 = fma(tx, d - c, c)``, ``fma(ty, v1 -
  v0, v0)``, an out-of-range corner reading 0. :func:`remap_bilinear`
  runs exactly that in compiled code (``data/image_host.py``), float
  operands and correctly rounded float fmas, so it gives OpenCV's result
  bit for bit. Its plain version :func:`remap_bilinear_ref` emulates each
  fma in numpy as a float64 product and sum rounded to float32 (the
  product of two floats is exact in float64), which is OpenCV's result
  unless the exact sum needs more than 53 bits and lands on a float32
  tie. The weights-times-corners sum is 1.8e-7 away instead, and
  coordinates quantized to 1/32 px, as OpenCV's fixed-point tables are,
  2.6e-2.

The camera model is OpenCV's radial-tangential one with ``dist = (k1, k2,
p1, p2, k3)``. Every function takes float32 ``K`` and ``dist`` as the
readers store them and widens them to float64, as OpenCV does with the
float32 arrays it is handed.
"""

from __future__ import annotations

import numpy as np

from mast3r_slam_tpu_torch.data import image_host

_F32 = np.float32
_F64 = np.float64
_GRID = 9               # getOptimalNewCameraMatrix's sample grid
_ITERS = 5              # undistortPoints' default fixed-point iterations


def _unpack(K, dist):
    K = np.asarray(K, _F32).astype(_F64)
    k1, k2, p1, p2, k3 = np.asarray(dist, _F32).astype(_F64)
    return K, (k1, k2, p1, p2, k3)


def undistort_points(uv, K, dist):
    """Pixels ``(N, 2)`` → normalized undistorted ``(x, y)`` float64, by
    ``cv2.undistortPoints``' fixed-point iteration."""
    K, (k1, k2, p1, p2, k3) = _unpack(K, dist)
    uv = np.asarray(uv, _F64)
    x0 = (uv[:, 0] - K[0, 2]) / K[0, 0]
    y0 = (uv[:, 1] - K[1, 2]) / K[1, 1]
    x, y = x0, y0
    live = np.ones(x0.shape, bool)
    for _ in range(_ITERS):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        # OpenCV gives up on a point whose model turns negative and
        # returns its distorted coordinates
        live &= icdist >= 0
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = np.where(live, (x0 - dx) * icdist, x0)
        y = np.where(live, (y0 - dy) * icdist, y0)
    return x, y


def optimal_new_camera_matrix(K, dist, wh):
    """The float64 ``(3, 3)`` new camera matrix of ``alpha = 0`` at the
    source size ``wh = (W, H)``: every pixel of the undistorted image
    comes from inside the source."""
    W, H = (int(v) for v in wh)
    gx, gy = np.meshgrid(np.arange(_GRID) * (W - 1) / (_GRID - 1),
                         np.arange(_GRID) * (H - 1) / (_GRID - 1))
    x, y = undistort_points(np.stack([gx.ravel(), gy.ravel()], -1), K, dist)
    x, y = x.reshape(_GRID, _GRID), y.reshape(_GRID, _GRID)
    # the inner rectangle: inside the left and right grid columns and the
    # top and bottom grid rows
    x0, x1 = x[:, 0].max(), x[:, -1].min()
    y0, y1 = y[0, :].max(), y[-1, :].min()
    fx, fy = (W - 1) / (x1 - x0), (H - 1) / (y1 - y0)
    return np.array([[fx, 0.0, -fx * x0], [0.0, fy, -fy * y0],
                     [0.0, 0.0, 1.0]])


def undistort_rectify_map(K, dist, new_K, wh):
    """``(mapx, mapy)``, float32 ``(H, W)``: the source pixel each pixel of
    the undistorted image (camera ``new_K``) samples."""
    W, H = (int(v) for v in wh)
    K, (k1, k2, p1, p2, k3) = _unpack(K, dist)
    ir = np.linalg.inv(np.asarray(new_K, _F32).astype(_F64))
    j = np.arange(W, dtype=_F64)[None, :]
    i = np.arange(H, dtype=_F64)[:, None]
    w = 1.0 / (i * ir[2, 1] + ir[2, 2] + j * ir[2, 0])
    x = (i * ir[0, 1] + ir[0, 2] + j * ir[0, 0]) * w
    y = (i * ir[1, 1] + ir[1, 2] + j * ir[1, 0]) * w
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2.0 * x * y
    kr = 1.0 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = K[0, 0] * (x * kr + p1 * xy2 + p2 * (r2 + 2.0 * x2)) + K[0, 2]
    v = K[1, 1] * (y * kr + p1 * (r2 + 2.0 * y2) + p2 * xy2) + K[1, 2]
    return u.astype(_F32), v.astype(_F32)


class RemapTables:
    """What :func:`remap_bilinear` needs of one pair of maps, computed once
    per calibration: ``corners``, int32 ``(4, n)``, the flat source index
    of each output pixel's four corners (an out-of-range corner points at
    ``H * W``, past the image, which reads 0), and the float32 fractions
    ``tx``, ``ty`` ``(n,)``."""

    def __init__(self, mapx, mapy, src_hw):
        H, W = (int(v) for v in src_hw)
        if H * W >= 2**31 - 1:
            raise ValueError(f"a {H}x{W} image is too large to remap")
        mapx, mapy = np.asarray(mapx, _F32), np.asarray(mapy, _F32)
        self.src_hw, self.out_hw = (H, W), mapx.shape
        fx, fy = np.floor(mapx), np.floor(mapy)
        self.tx = (mapx - fx).ravel()
        self.ty = (mapy - fy).ravel()
        x0, y0 = fx.astype(np.int64).ravel(), fy.astype(np.int64).ravel()

        def corner(yy, xx):
            inside = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            return np.where(inside, yy * W + xx, H * W)

        self.corners = np.stack([corner(y0, x0), corner(y0, x0 + 1),
                                 corner(y0 + 1, x0),
                                 corner(y0 + 1, x0 + 1)]).astype(np.int32)


def _source(img, tables):
    img = np.asarray(img, _F32)
    if img.shape[:2] != tables.src_hw:
        raise ValueError(f"image {img.shape[:2]} is not the calibration's "
                         f"{tables.src_hw}")
    return img


def remap_bilinear(img, tables: RemapTables):
    """``img`` float32 ``(H, W)`` or ``(H, W, C)`` sampled at the tables'
    maps: ``cv2.remap(img, mapx, mapy, INTER_LINEAR)`` with zero borders,
    in compiled code. Four gathers and three float fused multiply-adds per
    sample."""
    img = _source(img, tables)
    C = 1 if img.ndim == 2 else img.shape[2]
    out = image_host.remap_bilinear(img.reshape(*tables.src_hw, C),
                                    tables.corners, tables.tx, tables.ty)
    return out.reshape(tables.out_hw + img.shape[2:])


def _fma32(t, x, y):
    """``fma(t, x, y)`` rounded to float32: ``t`` float64 holding a
    float32, ``x`` and ``y`` float32."""
    return (t * x + y).astype(_F32)


def remap_bilinear_ref(img, tables: RemapTables):
    """The plain version of :func:`remap_bilinear` in numpy: each fma a
    float64 product and sum rounded to float32."""
    img = _source(img, tables)
    C = 1 if img.ndim == 2 else img.shape[2]
    pixels = np.concatenate([img.reshape(-1, C), np.zeros((1, C), _F32)])
    a, b, c, d = (pixels.take(i, axis=0) for i in tables.corners)
    tx = tables.tx.reshape(-1, 1).astype(_F64)
    ty = tables.ty.reshape(-1, 1).astype(_F64)
    v0 = _fma32(tx, b - a, a)
    v1 = _fma32(tx, d - c, c)
    out = _fma32(ty, v1 - v0, v0)
    return out.reshape(tables.out_hw + img.shape[2:])
