"""PNG reading and writing with the standard library's ``zlib``.

The port's datasets and exports need no OpenCV or PIL. This module reads
every PNG that libpng reads, with the transformations OpenCV's PNG
decoder asks libpng for, so that the reads give ``cv2.imread``'s arrays bit
for bit: all five colour types (gray, RGB, palette, gray + alpha, RGBA) at
every bit depth (1, 2 and 4 expanded to 8 bits as libpng scales them, 16
cut to its high byte), plain or Adam7-interlaced, all five scanline
filters. A palette is expanded to RGB; alpha and ``tRNS`` are dropped,
never composited. The gray read (:func:`decode_png` with ``gray=True``,
``cv2.IMREAD_GRAYSCALE``) converts colour with libpng's ``rgb_to_gray`` at
the coefficients OpenCV passes (0.299, 0.587), through libpng's gamma
tables when the file's ``sRGB`` or ``gAMA`` chunk makes its gamma
significant. :func:`exif_block` returns the ``eXIf`` chunk that
``data/exif.py`` reads the orientation from. The writer writes 8-bit gray
and RGB.

The five scanline filters are undone in compiled code, one call a pass
(``data/image_host.py::png_unfilter``); :func:`unfilter_ref` is its
plain version, a loop over each row, whose Average and Paeth rows take
Python's time for every byte. The rest of a read (the bit unpacking, the
palette, the 16-bit cut, the gray conversion) is whole-array numpy. The
writer uses the Up filter only.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

from mast3r_slam_tpu_torch.data import image_host

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}    # color type → samples a pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# libpng png_set_rgb_to_gray_fixed of OpenCV's (0.299, 0.587): the
# coefficients times 32768, truncated; blue takes the rest
_RC = 29900 * 32768 // 100000
_GC = 58700 * 32768 // 100000
_BC = 32768 - _RC - _GC
_FP_1 = 100000                   # libpng's fixed point 1.0
_GAMMA_THRESHOLD = 5000          # PNG_GAMMA_THRESHOLD_FIXED
_SRGB_GAMMA = 45455              # PNG_GAMMA_sRGB_INVERSE


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError("PNG without an IEND chunk")


def _unfilter_row(ftype, row, prev, bpp):
    """Undo one scanline's filter: ``row``/``prev`` uint8 arrays."""
    if ftype == 0:
        return row
    if ftype == 1:      # Sub: cumulative sum along the pixels, per byte
        r = row.reshape(-1, bpp).astype(np.int64).cumsum(axis=0)
        return (r & 255).astype(np.uint8).reshape(-1)
    if ftype == 2:      # Up
        return (row.astype(np.int64) + prev) .astype(np.uint8)
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    n = len(out)
    if ftype == 3:      # Average
        for i in range(n):
            a = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((a + up[i]) >> 1)) & 255
    elif ftype == 4:    # Paeth
        for i in range(n):
            if i >= bpp:
                a, c = out[i - bpp], up[i - bpp]
            else:
                a = c = 0
            b = up[i]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 255
    else:
        raise ValueError(f"bad PNG filter type {ftype}")
    return np.frombuffer(bytes(out), np.uint8)


def unfilter_ref(rows: np.ndarray, bpp: int) -> np.ndarray:
    """The plain version of ``image_host.png_unfilter``: one row at a
    time, None, Sub and Up with whole-row numpy, Average and Paeth byte by
    byte."""
    ph, stride = rows.shape[0], rows.shape[1] - 1
    plain = np.empty((ph, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(ph):
        prev = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
        plain[y] = prev
    return plain


def _unpack(rows: np.ndarray, w: int, chans: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, row bytes) → samples (h, w, chans): uint16 at 16
    bits, uint8 below (1, 2 and 4 bits unpacked, not yet scaled)."""
    h = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(h, w, chans)
    if depth == 8:
        return rows.reshape(h, w, chans)
    bits = np.unpackbits(rows, axis=1)[:, :w * depth]
    bits = bits.reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1, dtype=np.uint8)[..., None]


class _Png:
    """A parsed PNG: header fields, the chunks a read needs, the samples."""

    def __init__(self, data: bytes):
        if data[:8] != SIGNATURE:
            raise ValueError("not a PNG file")
        header, idat, self.palette, self.exif = None, [], None, None
        srgb = gama = None
        for kind, body in _chunks(data):
            if kind == b"IHDR":
                header = struct.unpack(">IIBBBBB", body)
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"PLTE" and self.palette is None:
                if len(body) % 3 or not 3 <= len(body) <= 768:
                    raise ValueError("bad PNG palette")
                self.palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
            elif kind == b"eXIf" and self.exif is None:
                self.exif = body          # libpng keeps the first
            elif kind == b"sRGB" and not idat and srgb is None:
                if len(body) == 1 and body[0] <= 3:
                    srgb = _SRGB_GAMMA
            elif kind == b"gAMA" and not idat and gama is None:
                if len(body) == 4 and struct.unpack(">I", body)[0] > 0:
                    gama = struct.unpack(">I", body)[0]
        if header is None:
            raise ValueError("PNG without an IHDR chunk")
        self.w, self.h, self.depth, self.ctype, comp, filt, self.interlace \
            = header
        if self.ctype not in _CHANNELS:
            raise ValueError(f"bad PNG color type {self.ctype}")
        if self.depth not in _DEPTHS[self.ctype]:
            raise ValueError(f"bad PNG bit depth {self.depth} for color type "
                             f"{self.ctype}")
        if comp or filt or self.interlace > 1 or not self.w or not self.h:
            raise ValueError("bad PNG header")
        if self.ctype == 3 and self.palette is None:
            raise ValueError("PNG palette image without a PLTE chunk")
        # sRGB takes precedence over gAMA (libpng's colour space)
        self.gamma = srgb if srgb is not None else gama
        self._idat = b"".join(idat)

    def samples(self) -> np.ndarray:
        """(h, w, channels) samples as stored: uint16 at 16 bits, else uint8
        (low bit depths unpacked but not scaled, palette indices as is)."""
        chans = _CHANNELS[self.ctype]
        bpp = max(1, chans * self.depth // 8)
        raw = np.frombuffer(zlib.decompress(self._idat), np.uint8)
        passes = _ADAM7 if self.interlace else ((0, 0, 1, 1),)
        out = np.zeros((self.h, self.w, chans),
                       np.uint16 if self.depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in passes:
            pw = -(-(self.w - x0) // dx) if self.w > x0 else 0
            ph = -(-(self.h - y0) // dy) if self.h > y0 else 0
            if pw == 0 or ph == 0:
                continue
            stride = -(-pw * chans * self.depth // 8)
            need = ph * (stride + 1)
            if raw.size < pos + need:
                raise ValueError("PNG image data has the wrong size")
            rows = raw[pos:pos + need].reshape(ph, stride + 1)
            pos += need
            out[y0::dy, x0::dx] = _unpack(image_host.png_unfilter(rows, bpp),
                                          pw, chans, self.depth)
        return out      # data past the image: libpng warns and reads on


def _to_8bit(s: np.ndarray, depth: int) -> np.ndarray:
    """libpng's png_set_strip_16 (the high byte) and its expansion of 1, 2
    and 4-bit gray (x255, x85, x17)."""
    if depth == 16:
        return (s >> 8).astype(np.uint8)
    if depth < 8:
        return (s * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return s


def _gamma_significant(g: int) -> bool:
    return g < _FP_1 - _GAMMA_THRESHOLD or g > _FP_1 + _GAMMA_THRESHOLD


def _reciprocal(a: int) -> int:
    return int(math.floor(1e10 / a + 0.5))


def _gamma_table(g: int) -> np.ndarray:
    """libpng png_build_8bit_table (floating-point png_gamma_8bit_correct)."""
    v = np.arange(256, dtype=np.float64)
    if not _gamma_significant(g):
        return np.arange(256)
    t = np.floor(255 * np.power(v / 255.0, g * 0.00001) + 0.5)
    return np.where((v > 0) & (v < 255), t, v).astype(np.int64)


def _rgb_to_gray(rgb: np.ndarray, depth: int, gamma) -> np.ndarray:
    """libpng png_do_rgb_to_gray (then png_do_strip_16 at 16 bits)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    if gamma is None or not _gamma_significant(gamma):
        if depth == 16:   # rounds since libpng 1.5.5
            return (((_RC * r + _GC * g + _BC * b + 16384) >> 15) >> 8
                    ).astype(np.uint8)
        return ((_RC * r + _GC * g + _BC * b) >> 15).astype(np.uint8)
    if depth == 16:
        raise ValueError("the gray read of a 16-bit colour PNG with a "
                         "significant gamma (sRGB or gAMA chunk) is not "
                         "supported")
    # the screen gamma defaults to the file's reciprocal: gamma_to_1
    # linearizes, gamma_from_1 re-encodes; gray pixels stay as they are
    to_1 = _gamma_table(_reciprocal(gamma))
    from_1 = _gamma_table(_reciprocal(_reciprocal(gamma)))
    s = (_RC * to_1[r] + _GC * to_1[g] + _BC * to_1[b] + 16384) >> 15
    return np.where((r == g) & (g == b), r, from_1[s]).astype(np.uint8)


def decode_png(data: bytes, gray: bool = False) -> np.ndarray:
    """PNG bytes → uint8 array.

    By default the file's channels at 8 bits: ``(H, W)`` gray, ``(H, W,
    2)`` gray + alpha, ``(H, W, 3)`` RGB (a palette expanded, its tRNS
    ignored) or ``(H, W, 4)`` RGBA. With ``gray``, ``(H, W)`` as
    ``cv2.IMREAD_GRAYSCALE`` reads the file (alpha dropped, colour through
    libpng's ``rgb_to_gray``)."""
    p = _Png(data)
    s = p.samples()
    if p.ctype == 3:
        # libpng's palette is 256 entries, zero past those the file gives
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(p.palette)] = p.palette
        s = pal[s[..., 0]]
    if gray:
        if p.ctype in (0, 4):
            return _to_8bit(s[..., 0], p.depth)
        return _rgb_to_gray(s, 8 if p.ctype == 3 else p.depth, p.gamma)
    s = _to_8bit(s, 8 if p.ctype == 3 else p.depth)
    return s[..., 0] if s.shape[2] == 1 else s


def exif_block(data: bytes):
    """The payload of the file's first ``eXIf`` chunk, or None."""
    return _Png(data).exif if data[:8] == SIGNATURE else None


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """uint8 ``(H, W, 3)`` RGB or ``(H, W)`` gray → PNG bytes (Up filter
    on every row)."""
    img = np.ascontiguousarray(img)
    gray = img.ndim == 2
    if img.dtype != np.uint8 or not (gray or img.ndim == 3
                                     and img.shape[2] == 3):
        raise ValueError(f"expected uint8 (H, W, 3) or (H, W), got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    up = np.diff(rows.astype(np.int16), axis=0, prepend=0).astype(np.uint8)
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if gray else 2, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
