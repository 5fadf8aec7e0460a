"""Image files for the dataset readers, as ``cv2.imread`` reads them: the
format comes from the file's first bytes (the PNG signature or the JPEG
start-of-image marker), not from its name."""

from __future__ import annotations

import numpy as np

from mast3r_slam_tpu_torch.data import jpeg, png


def decode_image(data: bytes) -> np.ndarray:
    """PNG or JPEG bytes → uint8 ``(H, W)`` or ``(H, W, C)``."""
    if data[:8] == png.SIGNATURE:
        return png.decode_png(data)
    if data[:2] == b"\xff\xd8":
        return jpeg.decode_jpeg(data)
    raise ValueError("neither a PNG nor a JPEG file")


def read_image(path) -> np.ndarray:
    """An image file as uint8 gray ``(H, W)`` or colour ``(H, W, C <= 3)``:
    alpha is dropped."""
    with open(path, "rb") as f:
        img = decode_image(f.read())
    return img if img.ndim == 2 else np.ascontiguousarray(img[..., :3])


def gray_to_rgb(img: np.ndarray) -> np.ndarray:
    """Gray ``(H, W)`` repeated into three channels; colour as it is."""
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img


def read_rgb(path) -> np.ndarray:
    """An image file as uint8 RGB ``(H, W, 3)``: gray is repeated into the
    three channels, alpha is dropped."""
    return gray_to_rgb(read_image(path))
