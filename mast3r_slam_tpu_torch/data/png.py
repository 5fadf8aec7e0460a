"""PNG reading and writing with the standard library's ``zlib``.

The port's datasets and exports need no OpenCV or PIL: this module decodes
8-bit gray, RGB and RGBA PNGs (non-interlaced, all five scanline filters)
and writes 8-bit gray and RGB PNGs. An interlaced, 16-bit or palette file
raises.

The None, Sub and Up filters are undone with whole-row numpy operations;
Average and Paeth depend on the pixel to the left and run as a loop over
the row's bytes, so a file that uses them much decodes slowly. The writer
uses the Up filter only.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # color type → samples per pixel


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


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → uint8 array ``(H, W)`` (gray) or ``(H, W, 3|4)``."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"only 8-bit PNGs are read, this one has bit depth "
                         f"{depth}")
    if interlace != 0:
        raise ValueError("interlaced PNGs are not read")
    if ctype not in _CHANNELS:
        raise ValueError(f"PNG color type {ctype} is not read (gray, RGB "
                         f"and RGBA are)")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    raw = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prev, bpp)
        out[y] = prev
    return out.reshape(h, w) if bpp == 1 else out.reshape(h, w, bpp)


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
