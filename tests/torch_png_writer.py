"""A small PNG encoder in numpy and ``zlib``, for writing test files of
the kinds the port's PNG reader reads where no OpenCV or PIL can write
them (``chip_smoke.py`` on the card machine, the fixtures of
``tests/data/png``). Test scaffolding, not a package feature.

It writes every colour type (0 gray, 2 RGB, 3 palette, 4 gray + alpha,
6 RGBA) at every bit depth the PNG standard allows for it, plain or
Adam7-interlaced, with a filter chosen per scanline (by default the five
filters in turn, so that a reader meets each of them), and optional
``PLTE``, ``tRNS``, ``gAMA`` and ``eXIf`` chunks. :func:`exif_orientation`
builds the TIFF bytes of an ``eXIf`` chunk (or of a JPEG ``APP1 Exif``
segment) that holds one orientation tag, and :func:`stored_under` the
image a file must store so that a reader applying that tag shows a given
frame.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each pass
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def exif_orientation(value: int, order: str = "II") -> bytes:
    """TIFF bytes (``II`` little- or ``MM`` big-endian) whose IFD0 holds
    one entry: Orientation (tag 0x0112, SHORT, count 1) = ``value``."""
    e = "<" if order == "II" else ">"
    return (order.encode() + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, value, 0)
            + struct.pack(e + "I", 0))


def stored_under(img: np.ndarray, value: int) -> np.ndarray:
    """The image to store under EXIF orientation ``value`` (1-8) so that
    applying the tag gives ``img`` back: 2-5 and 7 undo themselves, 6
    (turn clockwise) stores ``img`` turned counter-clockwise, 8 the
    reverse; 5-8 store it transposed."""
    out = {1: img, 2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1],
           5: img.swapaxes(0, 1), 6: np.rot90(img, 1),
           7: img.swapaxes(0, 1)[::-1, ::-1], 8: np.rot90(img, -1)}[value]
    return np.ascontiguousarray(out)


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w * channels) samples → (h, row bytes) uint8, big-endian for 16
    bits, packed most significant bits first below 8."""
    h, n = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, 2 * n)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    pad = (-n) % per
    s = np.pad(samples.astype(np.uint8), ((0, 0), (0, pad)))
    s = s.reshape(h, -1, per)
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    return (s << shifts).sum(axis=-1).astype(np.uint8)


def _filter_rows(raw: np.ndarray, bpp: int, filters) -> np.ndarray:
    """Filter each row of ``raw`` (h, n) uint8 with its filter type; the
    result has the filter byte in front of each row."""
    h, n = raw.shape
    r = raw.astype(np.int64)
    prior = np.vstack([np.zeros((1, n), np.int64), r[:-1]])
    left = np.hstack([np.zeros((h, bpp), np.int64), r[:, :-bpp]])[:, :n]
    upleft = np.hstack([np.zeros((h, bpp), np.int64),
                        prior[:, :-bpp]])[:, :n]
    p = left + prior - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, prior, upleft))
    preds = np.stack([np.zeros_like(r), left, prior, (left + prior) >> 1,
                      paeth])
    ft = np.array([filters(y) for y in range(h)], np.int64)
    out = (r - preds[ft[:, None], np.arange(h)[:, None],
                     np.arange(n)[None]]) & 255
    return np.hstack([ft[:, None], out]).astype(np.uint8)


def encode_png(img, color_type=None, depth=8, palette=None, trns=None,
               interlace=False, exif=None, exif_after_idat=False, gamma=None,
               filters=None) -> bytes:
    """``img`` → PNG bytes.

    ``img`` holds samples of ``depth`` bits: ``(H, W)`` gray or palette
    indices, ``(H, W, 2)`` gray + alpha, ``(H, W, 3)`` RGB, ``(H, W, 4)``
    RGBA; ``color_type`` defaults from its channels (palette needs
    ``palette``, ``(n, 3)`` uint8). ``trns``: the tRNS chunk's bytes.
    ``exif``: the eXIf chunk's bytes (TIFF), before IDAT unless
    ``exif_after_idat``. ``gamma``: a gAMA chunk (gamma * 100000).
    ``filters``: one filter type for every row, or a function of the row
    index within its pass (default: ``row % 5``)."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    chans = 1 if img.ndim == 2 else img.shape[2]
    if color_type is None:
        color_type = 3 if palette is not None else {1: 0, 2: 4, 3: 2,
                                                     4: 6}[chans]
    if CHANNELS[color_type] != chans or depth not in DEPTHS[color_type]:
        raise ValueError(f"colour type {color_type} at {depth} bits cannot "
                         f"hold {img.shape}")
    if img.min(initial=0) < 0 or img.max(initial=0) >= 1 << depth:
        raise ValueError(f"samples out of range for {depth} bits")
    if filters is None:
        filters = lambda y: y % 5  # noqa: E731
    elif isinstance(filters, int):
        filters = (lambda f: lambda y: f)(filters)
    bpp = max(1, chans * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    data = []
    for x0, y0, dx, dy in passes:
        sub = img[y0::dy, x0::dx]
        if sub.shape[0] == 0 or sub.shape[1] == 0:
            continue
        rows = _pack_rows(sub.reshape(sub.shape[0], -1), depth)
        data.append(_filter_rows(rows, bpp, filters).tobytes())
    out = [SIGNATURE, chunk(b"IHDR", struct.pack(
        ">IIBBBBB", W, H, depth, color_type, 0, 0, int(bool(interlace))))]
    if gamma is not None:
        out.append(chunk(b"gAMA", struct.pack(">I", int(gamma))))
    if exif is not None and not exif_after_idat:
        out.append(chunk(b"eXIf", exif))
    if palette is not None:
        out.append(chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        out.append(chunk(b"tRNS", bytes(trns)))
    out.append(chunk(b"IDAT", zlib.compress(b"".join(data))))
    if exif is not None and exif_after_idat:
        out.append(chunk(b"eXIf", exif))
    out.append(chunk(b"IEND", b""))
    return b"".join(out)


def write_png(path, img, **kw) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, **kw))
