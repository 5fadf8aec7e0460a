"""Video files for the dataset readers: the container demuxers of
``data/containers.py`` and a C++ frame decoder (``native/video_decode.cpp``)
bound with ctypes.

:class:`VideoReader` reads a file as the JAX package's ``MP4Dataset`` reads
it through ``cv2.VideoCapture``: the same frame count and frame rate
(``CAP_PROP_FRAME_COUNT``, ``CAP_PROP_FPS``) and the same RGB frames,
which the decoder reproduces by following FFmpeg's decode arithmetic (its
simple IDCT, its motion compensation) and the conversion of swscale's
unscaled YUV -> RGB path that OpenCV asks for. It reads MPEG-4 Part 2
(``mp4v``, ``XVID``, ``DIVX``, ``FMP4``, ...) and Motion JPEG (``MJPG``)
tracks of MP4/MOV, AVI and Matroska files; a track of another codec
(H.264, HEVC, VP8/9, AV1, FFV1, ...) raises ``ValueError`` naming its
fourcc. Bit identity holds for what FFmpeg's own encoder writes (user data
``Lavc...``, as cv2.VideoWriter's files); FFmpeg decodes a stream that
Xvid itself wrote with the Xvid IDCT instead, which the decoder does not
reproduce (its frames differ by the IDCTs' rounding, drifting over a
GOP). A frame that is not the next one decodes forward from the last
sync sample at or before it, which is the frame that
``cap.set(CAP_PROP_POS_FRAMES, i); cap.read()`` gives. A frame that cannot
be decoded raises ``ValueError(f"failed to decode frame {i} of {path}")``,
as the JAX reader does.

The decoder is compiled with ``g++`` at first use into the package's
``build/`` (git-ignored), keyed by a hash of its sources, and loaded under
a lock. When it cannot be built, reading raises: there is no fallback.

Beside it are the plain numpy versions of its arithmetic (the IDCT, the
half-pel interpolation and the colour converter), which only the tests
use: the compiled entries must equal them bit for bit.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import numpy as np

from mast3r_slam_tpu_torch import _build
from mast3r_slam_tpu_torch.data import containers

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "video_decode.cpp"
_DEPS = (_PKG / "native" / "jpeg_decode.cpp",)
_BUILD = _PKG / "build"
_LOCK = threading.Lock()
_ERRLEN = 256
_lib = None

MPEG4, MJPEG = 1, 2
# fourccs of MPEG-4 Part 2 and of Motion JPEG (one baseline or
# progressive JPEG a sample) that FFmpeg gives its mpeg4 and mjpeg decoders
CODECS = {
    **{c: MPEG4 for c in ("mp4v", "MP4V", "XVID", "xvid", "DIVX", "divx",
                          "DX50", "dx50", "FMP4", "fmp4", "M4S2", "MP4S")},
    **{c: MJPEG for c in ("MJPG", "mjpg", "jpeg")},
}


def load_library() -> ctypes.CDLL:
    """The compiled decoder, built at first use; raises when it cannot be
    built."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host(
                _SRC, _BUILD, "video decoder", deps=_DEPS)))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i16p = ctypes.POINTER(ctypes.c_int16)
            i32p = ctypes.POINTER(ctypes.c_int32)
            cint, i64 = ctypes.c_int, ctypes.c_int64
            lib.vd_open.restype = ctypes.c_void_p
            lib.vd_open.argtypes = [cint, u8p, i64, ctypes.c_char_p, cint]
            lib.vd_close.restype = None
            lib.vd_close.argtypes = [ctypes.c_void_p]
            lib.vd_decode.restype = cint
            lib.vd_decode.argtypes = [ctypes.c_void_p, u8p, i64, i32p,
                                      ctypes.c_char_p, cint]
            lib.vd_frame.restype = cint
            lib.vd_frame.argtypes = [ctypes.c_void_p, u8p, u8p, u8p, u8p]
            lib.vd_idct.restype = None
            lib.vd_idct.argtypes = [i16p, cint, u8p]
            lib.vd_hpel.restype = None
            lib.vd_hpel.argtypes = [u8p, cint, cint, cint, cint, cint, cint,
                                    cint, cint, u8p]
            lib.vd_yuv_to_rgb.restype = None
            lib.vd_yuv_to_rgb.argtypes = [u8p, u8p, u8p, cint, cint, cint,
                                          u8p]
            _lib = lib
    return _lib


def _u8(a):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class Decoder:
    """One stream's decoder state (``MPEG4`` or ``MJPEG``): samples in
    decode order in, the last frame out. ``extradata`` holds the headers
    a container keeps apart from the samples."""

    def __init__(self, codec: int, extradata: bytes = b""):
        self._lib = load_library()
        self.codec = codec
        self._handle = None
        extra = np.frombuffer(extradata, np.uint8)
        err = ctypes.create_string_buffer(_ERRLEN)
        h = self._lib.vd_open(codec, _u8(extra), extra.size, err, _ERRLEN)
        if not h:
            raise ValueError(err.value.decode())
        self._handle = h
        self.size = None  # (width, height) of the last frame

    def decode(self, data) -> None:
        """Decodes one sample; ``ValueError`` naming why it cannot."""
        buf = np.frombuffer(data, np.uint8)
        wh = (ctypes.c_int32 * 2)()
        err = ctypes.create_string_buffer(_ERRLEN)
        if self._lib.vd_decode(self._handle, _u8(buf), buf.size, wh, err,
                               _ERRLEN):
            raise ValueError(err.value.decode())
        self.size = (int(wh[0]), int(wh[1]))

    def rgb(self) -> np.ndarray:
        """The last frame, uint8 RGB ``(H, W, 3)``."""
        w, h = self.size
        out = np.empty((h, w, 3), np.uint8)
        self._lib.vd_frame(self._handle, _u8(out), None, None, None)
        return out

    def planes(self):
        """The last frame's Y ``(H, W)``, Cb and Cr ``((H+1)/2, (W+1)/2)``
        planes as decoded."""
        w, h = self.size
        y = np.empty((h, w), np.uint8)
        cb = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        cr = np.empty_like(cb)
        self._lib.vd_frame(self._handle, None, _u8(y), _u8(cb), _u8(cr))
        return y, cb, cr

    def close(self):
        if self._handle is not None:
            self._lib.vd_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def yuv_to_rgb(y, cb, cr, full_range: bool) -> np.ndarray:
    """The decoder's converter on 4:2:0 planes (``yuv_to_rgb_ref`` is its
    plain version)."""
    lib = load_library()
    y, cb, cr = (np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr))
    h, w = y.shape
    if cb.shape != ((h + 1) // 2, (w + 1) // 2) or cr.shape != cb.shape:
        raise ValueError(f"chroma planes {cb.shape} / {cr.shape} for a "
                         f"{h}x{w} luma plane")
    out = np.empty((h, w, 3), np.uint8)
    lib.vd_yuv_to_rgb(_u8(y), _u8(cb), _u8(cr), w, h, int(full_range),
                      _u8(out))
    return out


class VideoReader:
    """Frames of the first video track of ``path`` as uint8 RGB
    ``(H, W, 3)``. ``len`` is the frame count cv2 reports; ``fps`` its
    frame rate (0.0 where the container gives none)."""

    def __init__(self, path):
        self.path = str(path)
        self.track = containers.open_track(self.path)
        codec = CODECS.get(self.track.fourcc)
        if codec is None:
            raise ValueError(
                f"{self.path}: video codec {self.track.fourcc!r} is not "
                "decoded (MPEG-4 Part 2 and MJPEG are)")
        self.codec = codec
        self.fps = float(self.track.fps)
        load_library()
        self._dec = None
        self._next = None  # the sample the decoder reads next

    def __len__(self):
        return int(self.track.frame_count)

    def _sample(self, f, k):
        off, n = int(self.track.offsets[k]), int(self.track.sizes[k])
        f.seek(off)
        data = f.read(n)
        return data if len(data) == n else None

    def read(self, i: int) -> np.ndarray:
        """Frame ``i``; ``ValueError`` where it cannot be decoded."""
        i = int(i)
        if not 0 <= i < len(self.track.sizes):
            raise ValueError(f"failed to decode frame {i} of {self.path}")
        if self._dec is None or self._next != i:
            start = i
            while start > 0 and not self.track.sync[start]:
                start -= 1
            self._dec = None
            self._dec = Decoder(self.codec, self.track.extradata)
            self._next = start
        with open(self.path, "rb") as f:
            while self._next <= i:
                data = self._sample(f, self._next)
                try:
                    if data is None:
                        raise ValueError("the file ends inside the sample")
                    self._dec.decode(data)
                except ValueError as e:
                    self._dec = None
                    raise ValueError(
                        f"failed to decode frame {i} of {self.path}") from e
                self._next += 1
        return self._dec.rgb()

    def planes(self, i: int):
        """Frame ``i``'s Y, Cb and Cr planes as decoded (for the tests)."""
        self.read(i)
        return self._dec.planes()


# ---------------------------------------------------------------------------
# The arithmetic in plain numpy (tests only)
# ---------------------------------------------------------------------------

_W = (22725, 21407, 19266, 16383, 12873, 8867, 4520)  # W1..W7


def _wrap32(x):
    """A sum as the signed 32-bit value of its unsigned wrap."""
    return ((np.asarray(x, np.int64) + 2**31) % 2**32) - 2**31


def simple_idct_ref(block: np.ndarray) -> np.ndarray:
    """FFmpeg's 8-bit simple IDCT of one 8x8 block of int16 coefficients
    (natural order): the int32 residual before it is put or added."""
    W1, W2, W3, W4, W5, W6, W7 = _W
    b = np.asarray(block, np.int16).reshape(8, 8).astype(np.int64)
    rows = np.empty((8, 8), np.int64)
    for r in range(8):
        x = b[r]
        if not x[1:].any():
            rows[r] = np.int16(np.uint16((int(x[0]) << 3) & 0xFFFF).view(np.int16))
            continue
        a0 = W4 * x[0] + (1 << 10)
        a1, a2, a3 = a0, a0, a0
        a0 += W2 * x[2] + W4 * x[4] + W6 * x[6]
        a1 += W6 * x[2] - W4 * x[4] - W2 * x[6]
        a2 += -W6 * x[2] - W4 * x[4] + W2 * x[6]
        a3 += -W2 * x[2] + W4 * x[4] - W6 * x[6]
        b0 = W1 * x[1] + W3 * x[3] + W5 * x[5] + W7 * x[7]
        b1 = W3 * x[1] - W7 * x[3] - W1 * x[5] - W5 * x[7]
        b2 = W5 * x[1] - W1 * x[3] + W7 * x[5] + W3 * x[7]
        b3 = W7 * x[1] - W5 * x[3] + W3 * x[5] - W1 * x[7]
        v = _wrap32([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2,
                     a1 - b1, a0 - b0]) >> 11
        rows[r] = v.astype(np.int32).astype(np.int16)  # stored in 16 bits
    c = rows
    a0 = W4 * (c[0] + ((1 << 19) // W4))
    a1, a2, a3 = a0, a0, a0
    a0 = a0 + W2 * c[2] + W4 * c[4] + W6 * c[6]
    a1 = a1 + W6 * c[2] - W4 * c[4] - W2 * c[6]
    a2 = a2 - W6 * c[2] - W4 * c[4] + W2 * c[6]
    a3 = a3 - W2 * c[2] + W4 * c[4] - W6 * c[6]
    b0 = W1 * c[1] + W3 * c[3] + W5 * c[5] + W7 * c[7]
    b1 = W3 * c[1] - W7 * c[3] - W1 * c[5] - W5 * c[7]
    b2 = W5 * c[1] - W1 * c[3] + W7 * c[5] + W3 * c[7]
    b3 = W7 * c[1] - W5 * c[3] + W3 * c[5] - W1 * c[7]
    out = _wrap32(np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3,
                            a2 - b2, a1 - b1, a0 - b0])) >> 20
    return out.astype(np.int32)


def hpel_ref(src: np.ndarray, x: int, y: int, dxy: int, rounding: int,
             n: int) -> np.ndarray:
    """An n x n block at full-pel (x, y) plus the half-pel offsets of dxy
    (bit 0: x, bit 1: y) of plane ``src``, its coordinates clamped into the
    plane (the reference's replicated edges); ``rounding`` is the VOP's
    rounding type."""
    h, w = src.shape
    ys = np.clip(np.arange(y, y + n + 1), 0, h - 1)
    xs = np.clip(np.arange(x, x + n + 1), 0, w - 1)
    p = src[np.ix_(ys, xs)].astype(np.int32)
    a, b, c, d = p[:n, :n], p[:n, 1:], p[1:, :n], p[1:, 1:]
    rnd = 1 - rounding
    if dxy == 0:
        out = a
    elif dxy == 1:
        out = (a + b + rnd) >> 1
    elif dxy == 2:
        out = (a + c + rnd) >> 1
    else:
        out = (a + b + c + d + 1 + rnd) >> 2
    return out.astype(np.uint8)


def _coeffs(full_range: bool):
    crv, cbu, cgu, cgv = 104597, 132201, -25675, -53279
    cy, oy = 1 << 16, 0
    if not full_range:
        cy, oy = cy * 255 // 219, 16 << 16
    else:  # C's integer division, which truncates toward zero
        crv, cbu, cgu, cgv = (-(-c * 224 // 255) if c < 0 else c * 224 // 255
                              for c in (crv, cbu, cgu, cgv))

    def r16(f):
        return int(np.clip((f + (1 << 15)) >> 16, -0x8000, 0x7FFF))

    return (r16(cy * 8192), r16(oy * 8), r16(crv * 8192), r16(cbu * 8192),
            r16(cgu * 8192), r16(cgv * 8192))


def yuv_to_rgb_ref(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                   full_range: bool) -> np.ndarray:
    """4:2:0 planes -> uint8 RGB as swscale's unscaled SIMD YUV -> RGB
    converts them (BT.601; I420 limited range, or J420 full range)."""
    yc, yo, vr, ub, ug, vg = _coeffs(full_range)
    h, w = y.shape

    def mul(a, k):  # pmulhw of a saturated 16-bit lane
        a = np.clip(a, -32768, 32767)
        return (a * k) >> 16

    u = cb[np.arange(h) // 2][:, np.arange(w) // 2].astype(np.int64)
    v = cr[np.arange(h) // 2][:, np.arange(w) // 2].astype(np.int64)
    yy = mul(y.astype(np.int64) * 8 - yo, yc)
    uu, vv = u * 8 - 1024, v * 8 - 1024
    g = np.clip(mul(uu, ug) + mul(vv, vg), -32768, 32767)
    rgb = [yy + mul(vv, vr), yy + g, yy + mul(uu, ub)]
    return np.stack([np.clip(np.clip(c, -32768, 32767), 0, 255)
                     for c in rgb], -1).astype(np.uint8)
