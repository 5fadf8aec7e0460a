"""JPEG decoding for the dataset readers: a C++ decoder
(``native/jpeg_decode.cpp``) bound with ctypes.

The decoder follows IJG libjpeg's decode arithmetic (the ``islow`` IDCT,
its upsampling, the fixed-point colour tables, progressive Huffman
decoding, its handling of data that ends early), and OpenCV's own CMYK
conversions, so it gives ``cv2.imread``'s results bit for bit, in the
colour read (``IMREAD_COLOR``) and the gray read (``IMREAD_GRAYSCALE``).
It reads 8-bit baseline, extended-sequential and progressive Huffman
files: gray, YCbCr, RGB-coded, CMYK or YCCK, at any integral sampling
ratio (4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1, ...). A file whose data ends
early decodes as libjpeg decodes it (the missing blocks at level 128, or
at what the progressive scans gave them) with a warning. Lossless,
arithmetic-coded, hierarchical and 12-bit files raise ``ValueError``
naming what they are.

It is compiled with ``g++`` at first use into the package's ``build/``
(git-ignored), keyed by a hash of the source, and loaded under a lock.
When it cannot be built, decoding raises: there is no fallback. (A
Huffman decoder in Python walks every symbol of the ~19,000 blocks of a
1200x680 frame one at a time, seconds a frame.)
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
import warnings

import numpy as np

from mast3r_slam_tpu_torch import _build

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "jpeg_decode.cpp"
_BUILD = _PKG / "build"
_LOCK = threading.Lock()
_ERRLEN = 256
_lib = None


def load_library() -> ctypes.CDLL:
    """The compiled decoder, built at first use; raises when it cannot be
    built."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host(_SRC, _BUILD,
                                                    "JPEG decoder")))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.jpeg_info.restype = ctypes.c_int
            lib.jpeg_info.argtypes = [u8p, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_decode.restype = ctypes.c_int
            lib.jpeg_decode.argtypes = [u8p, ctypes.c_int64, u8p,
                                        ctypes.c_int64, ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int32),
                                        ctypes.c_char_p, ctypes.c_int]
            _lib = lib
    return _lib


def decode_jpeg(data: bytes, gray: bool = False) -> np.ndarray:
    """JPEG bytes → uint8 ``(H, W, 3)`` RGB, or ``(H, W)`` for a gray
    file; with ``gray``, ``(H, W)`` as ``cv2.IMREAD_GRAYSCALE`` reads any
    file (the Y channel of YCbCr). Data that ends early warns
    (``RuntimeWarning``) and decodes as libjpeg decodes it."""
    lib = load_library()
    buf = np.frombuffer(data, np.uint8)
    src = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    err = ctypes.create_string_buffer(_ERRLEN)
    whc = (ctypes.c_int32 * 3)()
    if lib.jpeg_info(src, buf.size, whc, err, _ERRLEN):
        raise ValueError(err.value.decode())
    w, h, c = whc
    out = np.empty((h, w) if gray or c == 1 else (h, w, 3), np.uint8)
    truncated = ctypes.c_int32(0)
    if lib.jpeg_decode(src, buf.size,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       out.size, int(gray), ctypes.byref(truncated), err,
                       _ERRLEN):
        raise ValueError(err.value.decode())
    if truncated.value:
        warnings.warn("truncated JPEG data: premature end of the file "
                      "(the missing blocks decode as libjpeg decodes them)",
                      RuntimeWarning, stacklevel=2)
    return out


def read_jpeg(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
