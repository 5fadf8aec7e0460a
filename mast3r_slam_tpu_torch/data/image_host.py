"""The readers' per-frame host arithmetic in compiled code: the PNG
unfilter and the bilinear remap of ``native/image_host.cpp``, bound with
ctypes.

The JAX package reads each frame through OpenCV, compiled code; these two
steps are the ones of the port's reads that numpy cannot do in whole-array
operations (a PNG's Average and Paeth rows depend on the byte to the left)
or does slowly (the remap's float fused multiply-adds, emulated in
float64). Their plain versions, the arithmetic these entries must equal,
are ``png.unfilter_ref`` and ``undistort.remap_bilinear_ref``.

The library is compiled with ``g++`` at first use into the package's
``build/`` (git-ignored), keyed by a hash of the source, and loaded under a
lock. When it cannot be built, the reads raise: there is no fallback.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import numpy as np

from mast3r_slam_tpu_torch import _build

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "image_host.cpp"
_BUILD = _PKG / "build"
_LOCK = threading.Lock()
_lib = None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_library() -> ctypes.CDLL:
    """The compiled library, built at first use; raises when it cannot be
    built."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host(_SRC, _BUILD,
                                                    "image host library")))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)
            i64 = ctypes.c_int64
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [u8p, i64, i64, ctypes.c_int, u8p,
                                         ctypes.POINTER(ctypes.c_int32)]
            lib.remap_bilinear_f32.restype = None
            lib.remap_bilinear_f32.argtypes = [
                f32p, i64, i64, i64, ctypes.POINTER(ctypes.c_int32), f32p,
                f32p, i64, f32p]
            _lib = lib
    return _lib


def png_unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """One pass of filtered scanlines ``(h, 1 + stride)`` uint8, each row
    its filter type and then its bytes → the unfiltered ``(h, stride)``;
    the row before the first is zeros. A filter type above 4 raises
    ``ValueError``."""
    lib = load_library()
    rows = np.ascontiguousarray(rows, np.uint8)
    if rows.ndim != 2 or rows.shape[1] < 1 or bpp < 1:
        raise ValueError(f"bad PNG pass {rows.shape}, {bpp} bytes a pixel")
    h, stride = rows.shape[0], rows.shape[1] - 1
    out = np.empty((h, stride), np.uint8)
    bad = ctypes.c_int32(0)
    if lib.png_unfilter(_ptr(rows, ctypes.c_uint8), h, stride, int(bpp),
                        _ptr(out, ctypes.c_uint8), ctypes.byref(bad)):
        raise ValueError(f"bad PNG filter type {bad.value}")
    return out


def remap_bilinear(img: np.ndarray, corners: np.ndarray, tx: np.ndarray,
                   ty: np.ndarray) -> np.ndarray:
    """``img`` float32 ``(H, W, C)`` sampled at ``n`` points: ``corners``
    int32 ``(4, n)`` flat source indices of each point's top-left,
    top-right, bottom-left and bottom-right pixels (``H * W`` for one
    outside the image; any index not in ``[0, H * W)`` reads 0), ``tx``,
    ``ty`` float32 ``(n,)`` fractions. Returns float32 ``(n, C)``."""
    lib = load_library()
    H, W, C = img.shape
    n = corners.shape[1]
    if (img.dtype != np.float32 or corners.dtype != np.int32
            or corners.shape != (4, n) or tx.shape != (n,)
            or ty.shape != (n,) or tx.dtype != np.float32
            or ty.dtype != np.float32):
        raise ValueError("remap_bilinear: float32 (H, W, C) image, int32 "
                         "(4, n) corners and float32 (n,) fractions")
    img, corners, tx, ty = (np.ascontiguousarray(a)
                            for a in (img, corners, tx, ty))
    out = np.empty((n, C), np.float32)
    lib.remap_bilinear_f32(_ptr(img, ctypes.c_float), H, W, C,
                           _ptr(corners, ctypes.c_int32),
                           _ptr(tx, ctypes.c_float), _ptr(ty, ctypes.c_float),
                           n, _ptr(out, ctypes.c_float))
    return out
