"""Image-space operators (counterpart of ``mast3r_slam_tpu/ops/image.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def img_gradient(img):
    """Per-channel x/y gradients of NHWC ``img (B, H, W, C)``: the 3x3
    Scharr-like stencil ``[[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]] / 32``
    (and its transpose) with reflect padding. Returns ``(gx, gy)``."""
    b, h, w, c = img.shape
    x = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    x = x.permute(0, 2, 3, 1)                         # (B, H+2, W+2, C)

    def tap(dy, dx):
        return x[:, dy:dy + h, dx:dx + w, :]

    gx = (-3.0 * tap(0, 0) + 3.0 * tap(0, 2)
          - 10.0 * tap(1, 0) + 10.0 * tap(1, 2)
          - 3.0 * tap(2, 0) + 3.0 * tap(2, 2)) / 32.0
    gy = (-3.0 * tap(0, 0) + 3.0 * tap(2, 0)
          - 10.0 * tap(0, 1) + 10.0 * tap(2, 1)
          - 3.0 * tap(0, 2) + 3.0 * tap(2, 2)) / 32.0
    return gx, gy


def bilinear_sample(img, uv):
    """Sample ``img (H, W, C)`` at continuous pixel coordinates ``uv (...,
    2)`` (u, v). The reference matcher kernel's corner convention: the four
    neighbours of (u, v) are (floor u, floor v) .. (+1, +1), weighted by
    the opposing areas, each index clamped into the image. Coordinates are
    expected pre-clamped to [1, W-2] x [1, H-2]."""
    h, w, _ = img.shape
    u, v = uv[..., 0], uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    u0, v0 = u0.long(), v0.long()
    u1 = (u0 + 1).clamp(0, w - 1)
    v1 = (v0 + 1).clamp(0, h - 1)
    u0 = u0.clamp(0, w - 1)
    v0 = v0.clamp(0, h - 1)
    top = img[v0, u0] * (1.0 - du) + img[v0, u1] * du
    bot = img[v1, u0] * (1.0 - du) + img[v1, u1] * du
    return top * (1.0 - dv) + bot * dv
