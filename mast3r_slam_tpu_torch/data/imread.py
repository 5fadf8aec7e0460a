"""Image files for the dataset readers, as ``cv2.imread`` reads them: the
format comes from the file's first bytes (the PNG signature or the JPEG
start-of-image marker), not from its name, and the EXIF orientation tag
(``data/exif.py``) turns or flips the decoded image."""

from __future__ import annotations

import numpy as np

from mast3r_slam_tpu_torch.data import exif, jpeg, png


def decode_image(data: bytes, gray: bool = False) -> np.ndarray:
    """PNG or JPEG bytes → uint8 ``(H, W, 3)`` RGB as ``cv2.IMREAD_COLOR``
    reads them (converted to RGB), or with ``gray`` ``(H, W)`` as
    ``cv2.IMREAD_GRAYSCALE`` does; EXIF orientation applied."""
    if data[:8] == png.SIGNATURE:
        img = png.decode_png(data, gray)
        blocks = [b for b in (png.exif_block(data),) if b is not None]
    elif data[:2] == b"\xff\xd8":
        img = jpeg.decode_jpeg(data, gray)
        blocks = exif.jpeg_blocks(data)
    else:
        raise ValueError("neither a PNG nor a JPEG file")
    if not gray:
        img = gray_to_rgb(img[..., 0] if img.ndim == 3 and img.shape[2] == 2
                          else img)[..., :3]
    return exif.apply_orientation(img, exif.orientation(blocks))


def gray_to_rgb(img: np.ndarray) -> np.ndarray:
    """Gray ``(H, W)`` repeated into three channels; colour as it is."""
    return np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img


def read_rgb(path) -> np.ndarray:
    """An image file as uint8 RGB ``(H, W, 3)``, as ``cv2.IMREAD_COLOR``
    reads it: gray is repeated into the three channels, alpha is
    dropped."""
    with open(path, "rb") as f:
        return decode_image(f.read())


def read_gray(path) -> np.ndarray:
    """An image file as uint8 gray ``(H, W)``, as ``cv2.IMREAD_GRAYSCALE``
    reads it (a colour JPEG's Y channel, a colour PNG through libpng's
    ``rgb_to_gray``)."""
    with open(path, "rb") as f:
        return decode_image(f.read(), gray=True)
