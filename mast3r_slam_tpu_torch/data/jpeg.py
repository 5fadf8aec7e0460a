"""Baseline JPEG decoding for the dataset readers: a C++ decoder
(``native/jpeg_decode.cpp``) bound with ctypes.

The decoder follows IJG libjpeg's decode arithmetic (the ``islow`` IDCT,
fancy chroma upsampling, the fixed-point YCbCr tables), so it gives
``cv2.imdecode`` and PIL's results bit for bit. It reads 8-bit baseline and
extended-sequential Huffman files, gray or YCbCr, at 4:4:4, 4:2:2, 4:2:0
and 4:4:0; progressive, lossless, arithmetic-coded, 12-bit, 4-component
and RGB-coded files and truncated data raise ``ValueError`` naming what
they are.

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
                                        ctypes.c_int64, ctypes.c_char_p,
                                        ctypes.c_int]
            _lib = lib
    return _lib


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes → uint8 ``(H, W, 3)`` RGB, or ``(H, W)`` for gray."""
    lib = load_library()
    buf = np.frombuffer(data, np.uint8)
    src = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    err = ctypes.create_string_buffer(_ERRLEN)
    whc = (ctypes.c_int32 * 3)()
    if lib.jpeg_info(src, buf.size, whc, err, _ERRLEN):
        raise ValueError(err.value.decode())
    w, h, c = whc
    out = np.empty((h, w, 3) if c == 3 else (h, w), np.uint8)
    if lib.jpeg_decode(src, buf.size,
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       out.size, err, _ERRLEN):
        raise ValueError(err.value.decode())
    return out


def read_jpeg(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_jpeg(f.read())
