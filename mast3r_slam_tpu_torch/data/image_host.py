"""The readers' per-frame host arithmetic in compiled code: the PNG
unfilter, the bilinear remap and the INTER_AREA resize of
``native/image_host.cpp``, bound with ctypes.

The JAX package reads and resizes each frame through OpenCV, compiled
code; these steps are the ones of the port's reads that numpy cannot do in
whole-array operations (a PNG's Average and Paeth rows depend on the byte
to the left; the resize sums each output pixel's taps in OpenCV's order)
or does slowly (the remap's float fused multiply-adds, emulated in
float64). Their plain versions, the arithmetic these entries must equal,
are ``png.unfilter_ref``, ``undistort.remap_bilinear_ref`` and
``image_ops.resize_area_ref``.

The library is compiled with ``g++ -ffp-contract=off`` (the resize's
products and sums stay apart, as OpenCV's) at first use into the package's
``build/`` (git-ignored), keyed by a hash of the source and the flags, and
loaded under a lock. When it cannot be built, the reads raise: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import threading

import numpy as np

from mast3r_slam_tpu_torch import _build

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "image_host.cpp"
_BUILD = _PKG / "build"
_FLAGS = ("-O3", "-ffp-contract=off", "-pthread")
_LOCK = threading.Lock()
_lib = None
# the resize's threads (its pool's workers, kept across calls, and the
# caller): OpenCV's parallel_for_ splits the rows likewise
RESIZE_THREADS = min(8, os.cpu_count() or 1)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_library() -> ctypes.CDLL:
    """The compiled library, built at first use; raises when it cannot be
    built."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host(
                _SRC, _BUILD, "image host library", _FLAGS)))
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
            lib.resize_area_f32.restype = ctypes.c_int
            lib.resize_area_f32.argtypes = [f32p] + [i64] * 9 + [
                f32p, f32p, u8p, ctypes.c_int]
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


def resize_area(img: np.ndarray, out_hw, window=None, *, frame=False,
                model_out=None):
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` of a
    float32 ``(H, W)`` or ``(H, W, C)`` image, C 1 or 3, ``(h, w) =
    out_hw`` no larger than ``(H, W)``, as OpenCV 5.0 computes it (the same
    size a copy), for the output rows ``y0:y1`` and columns ``x0:x1`` of
    ``window = (y0, y1, x0, x1)`` only (default: all). Returns that crop;
    with ``frame``, instead ``(model, display)`` from the same pass: ``crop
    * 2 - 1`` (written into ``model_out``, a C-contiguous float32 array of
    the crop's shape, when given) and ``clip(crop * 255, 0, 255)``
    truncated to uint8."""
    lib = load_library()
    src, (h, w), (y0, y1, x0, x1), shape = _resize_args(img, out_hw, window)
    H, W = src.shape[:2]
    C = 1 if src.ndim == 2 else src.shape[2]
    f32p = ctypes.POINTER(ctypes.c_float)
    raw = model = display = None
    if frame:
        model = np.empty(shape, np.float32) if model_out is None else model_out
        if (model.shape != shape or model.dtype != np.float32
                or not model.flags.c_contiguous):
            raise ValueError(f"resize_area: model_out must be C-contiguous "
                             f"float32 {shape}")
        display = np.empty(shape, np.uint8)
    else:
        raw = np.empty(shape, np.float32)
    path = lib.resize_area_f32(
        _ptr(src, ctypes.c_float), H, W, C, h, w, y0, y1, x0, x1,
        _ptr(raw, ctypes.c_float) if raw is not None else f32p(),
        _ptr(model, ctypes.c_float) if model is not None else f32p(),
        _ptr(display, ctypes.c_uint8) if display is not None
        else ctypes.POINTER(ctypes.c_uint8)(), RESIZE_THREADS)
    if path < 0:
        raise ValueError(f"resize_area: {src.shape} -> {out_hw}, window "
                         f"{window}")
    return (model, display) if frame else raw


def _resize_args(img, out_hw, window):
    """The contiguous float32 source, the output size, the window and the
    crop's shape; raises ``ValueError`` for what the resize does not take
    (another dtype or channel count, a larger output, a window outside
    it)."""
    if img.dtype != np.float32 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] not in (1, 3)):
        raise ValueError("resize_area: a float32 (H, W) or (H, W, C) image, "
                         "C 1 or 3")
    h, w = (int(v) for v in out_hw)
    H, W = img.shape[:2]
    y0, y1, x0, x1 = (0, h, 0, w) if window is None else (
        int(v) for v in window)
    if not (0 < h <= H and 0 < w <= W and 0 <= y0 <= y1 <= h
            and 0 <= x0 <= x1 <= w):
        raise ValueError(f"resize_area: {img.shape[:2]} -> {(h, w)}, window "
                         f"{(y0, y1, x0, x1)}")
    return (np.ascontiguousarray(img), (h, w), (y0, y1, x0, x1),
            (y1 - y0, x1 - x0) + img.shape[2:])
