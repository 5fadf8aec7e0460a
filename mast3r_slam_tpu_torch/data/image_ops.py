"""Host-side image preprocessing for model ingestion, without OpenCV.

Counterpart of ``mast3r_slam_tpu/data/image_ops.py``: resize so the long
edge is ``size`` (or the short edge 224 with a square center-crop), then
center-crop height and width to multiples of 16 so the ViT patchifier tiles
exactly. The JAX package calls ``cv2.resize`` (``INTER_AREA`` to shrink,
``INTER_LANCZOS4`` to enlarge, a copy at the same size); the card machine
has no OpenCV, so:

- ``INTER_AREA`` and the copy are OpenCV 5.0's own arithmetic in compiled
  code (``data/image_host.py::resize_area``), bit for bit with
  ``cv2.resize``, for the crop's rows and columns only, in one pass that
  also writes the model image and the display image. Output pixel ``d``
  averages the source interval ``[d·s, (d+1)·s)`` (``s = 1 / (out /
  in)``); a partly covered pixel weighs by its covered fraction, with
  ``computeResizeAreaTab``'s 1e-3 cut-off for slivers (:func:`area_table`).
  Each output pixel sums its horizontal taps in the table's order, then
  the rows add up with their weights, a float32 product then a float32
  add each time. When both scales are integers, OpenCV takes
  ``resizeAreaFast_`` instead: the plain sum of each block, four taps at a
  time, times ``1 / area`` (:func:`area_fast_scale`). The plain version,
  :func:`resize_area_ref`, is the same arithmetic in numpy.
- ``INTER_LANCZOS4`` (enlarging, a frame whose long edge is under
  ``size``): separable ``(out, in)`` float64 weight matrices
  (:func:`resize_weights`, built once per size pair and cached read-only)
  applied to the float32 image with two matrix products, within 1e-5 of
  ``cv2.resize``: 8 taps at ``floor(f) - 3 .. floor(f) + 4`` with ``f =
  (d + 0.5)·s - 0.5`` (pixel centres), the windowed sinc ``sin(πx)·sin(πx/4)
  / (π²x²/4)`` normalised to sum 1, and source indices clamped at the
  border.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from mast3r_slam_tpu_torch.data import image_host


@functools.lru_cache(maxsize=64)
def area_table(n_in: int, n_out: int):
    """OpenCV's ``computeResizeAreaTab`` for shrinking ``n_in → n_out``,
    grouped by destination: ``(ofs, si, alpha)``, the taps of destination
    ``d`` being ``si[ofs[d]:ofs[d + 1]]`` (int64 source indices) with
    float32 weights ``alpha[ofs[d]:ofs[d + 1]]``, in the table's order.
    Cached per ``(n_in, n_out)``; the arrays are read-only."""
    scale = 1.0 / (n_out / n_in)
    ofs, si, alpha = [0], [], []
    for d in range(n_out):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            si.append(s1 - 1)
            alpha.append((s1 - f1) / cell)
        for s in range(s1, s2):
            si.append(s)
            alpha.append(1.0 / cell)
        if f2 - s2 > 1e-3:
            si.append(s2)
            alpha.append(min(min(f2 - s2, 1.0), cell) / cell)
        ofs.append(len(si))
    out = (np.asarray(ofs, np.int64), np.asarray(si, np.int64),
           np.asarray(alpha, np.float32))
    for a in out:
        a.setflags(write=False)
    return out


def area_fast_scale(hw_in, hw_out):
    """``(sx, sy)`` when OpenCV's ``hal::resize`` takes ``resizeAreaFast_``
    for ``hw_in → hw_out``: both scales ``1 / (out / in)`` within
    ``DBL_EPSILON`` of an integer; else None."""
    (H, W), (h, w) = hw_in, hw_out
    sx, sy = 1.0 / (w / W), 1.0 / (h / H)
    isx, isy = round(sx), round(sy)
    eps = np.finfo(np.float64).eps
    if abs(sx - isx) < eps and abs(sy - isy) < eps:
        return int(isx), int(isy)
    return None


def resize_area_ref(img: np.ndarray, out_hw, window=None, *, frame=False,
                    model_out=None):
    """The plain version of ``image_host.resize_area`` (same arguments and
    results, the same bits): numpy in OpenCV's order. The table path loops
    over the taps' positions (each output pixel's first tap, its second,
    ...) and the fast path over the block's taps, every step vectorised
    over rows and columns; each product is rounded to float32 before its
    add."""
    src, (h, w), (y0, y1, x0, x1), shape = image_host._resize_args(
        img, out_hw, window)
    H, W = src.shape[:2]
    s3 = src.reshape(H, W, -1)
    if (h, w) == (H, W) or y0 == y1 or x0 == x1:
        crop = s3[y0:y1, x0:x1].copy()
    elif area_fast_scale((H, W), (h, w)) is not None:
        crop = _area_fast_ref(s3, area_fast_scale((H, W), (h, w)), w,
                              (y0, y1, x0, x1))
    else:
        crop = _area_table_ref(s3, (h, w), (y0, y1, x0, x1))
    crop = crop.reshape(shape)
    if not frame:
        return crop
    model = crop * 2.0 - 1.0
    if model_out is not None:
        model_out[...] = model
        model = model_out
    return model, np.clip(crop * 255.0, 0, 255).astype(np.uint8)


def _table_sum(vals, ofs, si, alpha, lo, hi, first=None):
    """For destinations ``lo..hi`` of a table: ``Σ vals(si) · alpha`` in the
    table's order along axis 0 of ``vals`` (callable: source indices →
    float32 array with them on axis 0), the first product not added to 0
    when ``first`` (a row's first β, as OpenCV's vertical sum)."""
    cnt = np.diff(ofs)[lo:hi]
    start = ofs[lo:hi]
    out = None
    for j in range(int(cnt.max())):
        live = np.nonzero(cnt > j)[0]
        k = start[live] + j
        a = alpha[k].reshape((-1,) + (1,) * (vals(si[k[:1]]).ndim - 1))
        p = vals(si[k]) * a
        if out is None:
            out = np.zeros((hi - lo,) + p.shape[1:], np.float32)
            if first:
                out[live] = p
                continue
        out[live] = out[live] + p
    return out


def _area_table_ref(src, hw, window):
    (h, w), (y0, y1, x0, x1) = hw, window
    H, W, _ = src.shape
    yo, ys, ya = area_table(H, h)
    xo, xs, xa = area_table(W, w)
    rows = np.unique(ys[yo[y0]:yo[y1]])
    # each source row's horizontal sums: columns on axis 0, then rows back
    hsum = _table_sum(lambda s: src[rows][:, s].swapaxes(0, 1), xo, xs, xa,
                      x0, x1).swapaxes(0, 1)
    at = np.full(H, -1)
    at[rows] = np.arange(len(rows))
    return _table_sum(lambda s: hsum[at[s]], yo, ys, ya, y0, y1, first=True)


def _area_fast_ref(src, scales, w, window):
    (sx, sy), (y0, y1, x0, x1) = scales, window
    area = sx * sy
    taps = [src[sy * y0 + ty: sy * y1: sy, sx * x0 + tx: sx * x1: sx]
            for ty in range(sy) for tx in range(sx)]
    s = np.zeros_like(taps[0])
    k = 0
    while k <= area - 4:
        s = s + (((taps[k] + taps[k + 1]) + taps[k + 2]) + taps[k + 3])
        k += 4
    for k in range(k, area):
        s = s + taps[k]
    out = s * np.float32(1.0 / np.float32(area))
    if src.shape[2] == 1 and sx == sy == 2:
        # OpenCV's 128-bit vector loop over the first (w // 4) * 4 columns
        split = min(max(w // 4 * 4, x0), x1) - x0
        out[:, :split] = ((taps[0] + taps[1]) + (taps[2] + taps[3]))[
            :, :split] * np.float32(0.25)
    return out


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
    """The ``(n_out, n_in)`` weights of one axis of a LANCZOS4 resize, the
    one case :func:`resize_img` computes as matrix products (it shrinks
    and copies through ``image_host.resize_area``): :func:`lanczos4_weights`
    when the axis enlarges, the identity when it keeps its size (a short
    edge that the scale rounds back to itself). The JAX package picks one
    interpolation from the long-edge scale for both axes, so no axis of
    such a resize shrinks. Cached per ``(n_in, n_out)``; the array is
    read-only, shared by every caller."""
    if n_out < n_in:
        raise ValueError(f"resize_weights: {n_in} -> {n_out} shrinks; "
                         "that is resize_area's")
    W = np.eye(n_in) if n_out == n_in else lanczos4_weights(n_in, n_out)
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


def _resized_target(h, w, size):
    """The long edge the JAX package resizes to."""
    if size == 224:
        return round(size * max(w / h, h / w))
    return size


def _resized_shape(h, w, size):
    """The (h', w') the JAX package asks ``cv2.resize`` for."""
    s = _resized_target(h, w, size) / max(h, w)
    return round(h * s), round(w * s)


def resize_plan(h1: int, w1: int, size: int = 512, square_ok: bool = False):
    """What :func:`resize_img` does to an ``h1 x w1`` image: ``((h, w),
    (y0, y1, x0, x1), area)``, the size the JAX package asks
    ``cv2.resize`` for, the crop window in it, and whether that resize is
    INTER_AREA or a copy (else INTER_LANCZOS4)."""
    h, w = _resized_shape(h1, w1, size)
    cx, cy = w // 2, h // 2
    if size == 224:
        half = min(cx, cy)
        window = (cy - half, cy + half, cx - half, cx + half)
    else:
        halfw = (w // 16) * 8
        halfh = (h // 16) * 8
        if not square_ok and w == h:
            halfh = int(3 * halfw / 4)
        window = (cy - halfh, cy + halfh, cx - halfw, cx + halfw)
    target = _resized_target(h1, w1, size)
    return (h, w), window, (h, w) == (h1, w1) or target / max(h1, w1) < 1.0


def resize_img(img: np.ndarray, size: int = 512, square_ok: bool = False,
               return_transformation: bool = False, *, model_out=None):
    """``img (H, W, 3) float32 [0, 1]`` → dict(img, true_shape,
    unnormalized_img), as the JAX ``resize_img``.

    ``img`` out is ``(1, H', W', 3)`` normalized to [-1, 1] (a view of
    ``model_out``, a C-contiguous float32 ``(H', W', 3)`` array, when
    given); ``true_shape`` is ``[[H', W']]``; ``unnormalized_img`` is uint8
    (truncated, as the JAX package's ``astype``). With
    ``return_transformation``, also returns ``(scale_w, scale_h,
    half_crop_w, half_crop_h)``.
    """
    src = np.asarray(img, np.float32)
    h1, w1 = src.shape[:2]
    (h, w), (y0, y1, x0, x1), area = resize_plan(h1, w1, size, square_ok)
    if area:
        model, display = image_host.resize_area(
            src, (h, w), (y0, y1, x0, x1), frame=True, model_out=model_out)
    else:
        Wy = resize_weights(h1, h)[y0:y1].astype(np.float32)
        Wx = resize_weights(w1, w)[x0:x1].astype(np.float32)
        c = src.shape[2]
        rows = (Wy @ src.reshape(h1, w1 * c)).reshape(y1 - y0, w1, c)
        crop = np.einsum("xw,hwc->hxc", Wx, rows, optimize=True)
        model = (crop * 2.0 - 1.0).astype(np.float32)
        if model_out is not None:
            model_out[...] = model
            model = model_out
        display = np.clip(crop * 255.0, 0, 255).astype(np.uint8)
    ch, cw = model.shape[:2]
    out = {
        "img": model[None],
        "true_shape": np.asarray([[ch, cw]], np.int32),
        "unnormalized_img": display,
    }
    if return_transformation:
        return out, (w1 / w, h1 / h, (w - cw) / 2, (h - ch) / 2)
    return out
