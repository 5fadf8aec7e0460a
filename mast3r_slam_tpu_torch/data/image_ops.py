"""Host-side image preprocessing for model ingestion, without OpenCV.

Counterpart of ``mast3r_slam_tpu/data/image_ops.py``: resize so the long
edge is ``size`` (or the short edge 224 with a square center-crop), then
center-crop height and width to multiples of 16 so the ViT patchifier tiles
exactly. The JAX package calls ``cv2.resize`` (``INTER_AREA`` to shrink,
``INTER_LANCZOS4`` to enlarge); the card machine has no OpenCV, so both are
rebuilt here as separable ``(out, in)`` weight matrices in float64, applied
to the float32 image with two matrix products:

- ``INTER_AREA`` (shrinking, scale ``s = in / out > 1``): output pixel ``d``
  averages the source interval ``[d·s, (d+1)·s)``; a partly covered pixel
  weighs by its covered fraction (OpenCV's ``computeResizeAreaTab``, whose
  1e-3 cut-off for slivers is kept).
- ``INTER_LANCZOS4`` (enlarging): 8 taps at ``floor(f) - 3 .. floor(f) + 4``
  with ``f = (d + 0.5)·s - 0.5`` (pixel centres), the windowed sinc
  ``sin(πx)·sin(πx/4) / (π²x²/4)`` normalised to sum 1, and source indices
  clamped at the border.

The weight matrices of a size pair are built once and cached (read-only):
a dataset's frames share one size, so a frame's resize is the two matrix
products and the crop. Only the rows and columns the crop keeps are
multiplied.
"""

from __future__ import annotations

import functools
import math

import numpy as np


def area_weights(n_in: int, n_out: int) -> np.ndarray:
    """``(n_out, n_in)`` INTER_AREA weights for shrinking ``n_in → n_out``."""
    scale = n_in / n_out
    W = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            W[d, s1 - 1] += (s1 - f1) / cell
        W[d, s1:s2] += 1.0 / cell
        if f2 - s2 > 1e-3:
            W[d, s2] += min(min(f2 - s2, 1.0), cell) / cell
    return W


def _lanczos4_taps(x: float) -> np.ndarray:
    """The 8 normalised Lanczos-4 weights of taps ``-3..4`` at fractional
    offset ``x`` in [0, 1)."""
    t = x + 3.0 - np.arange(8)
    w = np.empty(8)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-6:
            w[i] = 1e30
        else:
            y = math.pi * ti / 4.0
            w[i] = math.sin(4.0 * y) * math.sin(y) / (y * y) / 4.0
    return w / w.sum()


def lanczos4_weights(n_in: int, n_out: int) -> np.ndarray:
    """``(n_out, n_in)`` INTER_LANCZOS4 weights, border indices clamped."""
    scale = n_in / n_out
    W = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        f = np.float32((d + 0.5) * scale - 0.5)
        s = math.floor(f)
        taps = _lanczos4_taps(float(f) - s)
        for k in range(8):
            W[d, min(max(s - 3 + k, 0), n_in - 1)] += taps[k]
    return W


@functools.lru_cache(maxsize=64)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """``(n_out, n_in)`` weights of one axis: INTER_AREA when shrinking,
    INTER_LANCZOS4 when enlarging. The JAX package picks one interpolation
    from the long-edge scale for both axes; one scale shrinks or enlarges
    both, so the per-axis choice is the same. Cached per ``(n_in,
    n_out)``; the array is read-only, shared by every caller."""
    if n_out < n_in:
        W = area_weights(n_in, n_out)
    elif n_out == n_in:
        W = np.eye(n_in)
    else:
        W = lanczos4_weights(n_in, n_out)
    W.setflags(write=False)
    return W


def linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """``(n_out, n_in)`` INTER_LINEAR weights: source position
    ``f = (d + 0.5)·s - 0.5`` rounded to float32, two taps ``floor(f)``
    and ``floor(f) + 1``; a position left of the first pixel or right of
    the last takes the edge pixel alone (OpenCV's ``resizeGeneric`` set-up
    for ``INTER_LINEAR``)."""
    scale = 1.0 / (n_out / n_in)
    W = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        f = float(np.float32((d + 0.5) * scale - 0.5))
        s = math.floor(f)
        f -= s
        if s < 0:
            s, f = 0, 0.0
        if s >= n_in - 1:
            s, f = n_in - 1, 0.0
        W[d, s] += 1.0 - f
        if f:
            W[d, s + 1] += f
    return W


def nearest_weights(n_in: int, n_out: int) -> np.ndarray:
    """``(n_out, n_in)`` INTER_NEAREST one-hot weights: source
    ``min(floor(d·s), n_in - 1)`` (OpenCV's ``resizeNN``, no half-pixel
    shift)."""
    scale = 1.0 / (n_out / n_in)
    W = np.zeros((n_out, n_in), np.float64)
    for d in range(n_out):
        W[d, min(math.floor(d * scale), n_in - 1)] = 1.0
    return W


def _resized_shape(h, w, size):
    """The (h', w') the JAX package asks ``cv2.resize`` for."""
    if size == 224:
        target = round(size * max(w / h, h / w))
    else:
        target = size
    s = target / max(h, w)
    return round(h * s), round(w * s)


def resize_img(img: np.ndarray, size: int = 512, square_ok: bool = False,
               return_transformation: bool = False):
    """``img (H, W, 3) float32 [0, 1]`` → dict(img, true_shape,
    unnormalized_img), as the JAX ``resize_img``.

    ``img`` out is ``(1, H', W', 3)`` normalized to [-1, 1]; ``true_shape``
    is ``[[H', W']]``; ``unnormalized_img`` is uint8 (truncated, as the JAX
    package's ``astype``). With ``return_transformation``, also returns
    ``(scale_w, scale_h, half_crop_w, half_crop_h)``.
    """
    h1, w1 = img.shape[:2]
    h, w = _resized_shape(h1, w1, size)
    cx, cy = w // 2, h // 2
    if size == 224:
        half = min(cx, cy)
        y0, y1, x0, x1 = cy - half, cy + half, cx - half, cx + half
    else:
        halfw = (w // 16) * 8
        halfh = (h // 16) * 8
        if not square_ok and w == h:
            halfh = int(3 * halfw / 4)
        y0, y1, x0, x1 = cy - halfh, cy + halfh, cx - halfw, cx + halfw
    Wy = resize_weights(h1, h)[y0:y1].astype(np.float32)
    Wx = resize_weights(w1, w)[x0:x1].astype(np.float32)
    src = np.asarray(img, np.float32)
    c = src.shape[2]
    rows = (Wy @ src.reshape(h1, w1 * c)).reshape(y1 - y0, w1, c)
    crop = np.einsum("xw,hwc->hxc", Wx, rows, optimize=True)
    ch, cw = crop.shape[:2]
    out = {
        "img": (crop * 2.0 - 1.0)[None].astype(np.float32),
        "true_shape": np.asarray([[ch, cw]], np.int32),
        "unnormalized_img": np.clip(crop * 255.0, 0, 255).astype(np.uint8),
    }
    if return_transformation:
        return out, (w1 / w, h1 / h, (w - cw) / 2, (h - ch) / 2)
    return out
