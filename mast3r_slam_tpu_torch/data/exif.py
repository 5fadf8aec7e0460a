"""The EXIF orientation tag, read and applied as ``cv2.imread`` does.

OpenCV reads the orientation (tag 0x0112 of IFD0) from every JPEG ``APP1``
segment that starts ``Exif\\0\\0`` before the first scan, in file order,
and from a PNG's ``eXIf`` chunk, with its own ``ExifReader``: the TIFF
header must be ``II`` or ``MM`` with the mark 42; the entries of IFD0 are
read in order until one runs past the data (an exception that keeps what
was read before it), and the first orientation entry read wins, its value
the 16-bit word of its value field whatever its type or count. The other
tags that ``ExifReader`` decodes count for the same reason: a string or a
rational whose data lies past the end stops the reading there. Then
``ApplyExifOrientation`` flips and transposes the decoded image; a value
outside 1-8 leaves it as it is. This holds for the colour and the gray
read alike.
"""

from __future__ import annotations

import numpy as np

ORIENTATION = 0x0112
_STRINGS = {0x010E, 0x010F, 0x0110, 0x0131, 0x0132, 0x8298}
_WORDS = {0x0128, 0x0213}                     # ResolutionUnit, YCbCrPos.
# rationals read from the offset in the value field: XResolution,
# YResolution, WhitePoint, PrimaryChromaticities, YCbCrCoefficients,
# ReferenceBlackWhite
_RATIONALS = {0x011A: 1, 0x011B: 1, 0x013E: 2, 0x013F: 6, 0x0211: 3,
              0x0214: 6}


class _PastEnd(Exception):
    pass


def _ifd0_orientation(tiff: bytes):
    """The orientation of one TIFF block as OpenCV's ``ExifReader`` reads
    it, or None when it reads none."""
    n = len(tiff)
    if n < 1 or (n > 1 and tiff[0] != tiff[1]) or tiff[:1] not in (b"I",
                                                                     b"M"):
        return None
    order = "little" if tiff[0] == ord("I") else "big"

    def u16(off):
        if off + 1 >= n:
            raise _PastEnd
        return int.from_bytes(tiff[off:off + 2], order)

    def u32(off):
        if off + 3 >= n:
            raise _PastEnd
        return int.from_bytes(tiff[off:off + 4], order)

    try:
        if u16(2) != 42:
            return None
        ifd = u32(4)
        for i in range(u16(ifd)):
            off = ifd + 2 + 12 * i
            tag = u16(off)
            if tag == ORIENTATION:
                return u16(off + 8)
            if tag in _STRINGS:          # ExifReader::getString
                count = u32(off + 4)
                data = 8 if count <= 4 else u32(off + 8)
                if data > n or data + count > n:
                    raise _PastEnd
            elif tag in _WORDS:
                u16(off + 8)
            elif tag in _RATIONALS:
                at = u32(off + 8)
                u32(at + 8 * _RATIONALS[tag] - 4)
    except _PastEnd:
        pass
    return None


def orientation(blocks) -> int:
    """The orientation value of a file's EXIF blocks (TIFF bytes, in file
    order): the first one read, 1 when there is none."""
    for tiff in blocks:
        value = _ifd0_orientation(tiff)
        if value is not None:
            return value
    return 1


def jpeg_blocks(data: bytes) -> list:
    """The TIFF bytes of every ``APP1 Exif`` segment before the first scan
    of JPEG ``data``."""
    out, p, end = [], 2, len(data)
    while p < end:
        while p < end and data[p] != 0xFF:
            p += 1
        while p < end and data[p] == 0xFF:
            p += 1
        if p >= end:
            break
        code = data[p]
        p += 1
        if code in (0xD8, 0x01) or 0xD0 <= code <= 0xD7:
            continue
        if code in (0xD9, 0xDA) or p + 2 > end:
            break
        length = int.from_bytes(data[p:p + 2], "big")
        body = data[p + 2:p + length]
        if code == 0xE1 and body[:6] == b"Exif\0\0":
            out.append(body[6:])
        p += length
    return out


def apply_orientation(img: np.ndarray, value: int) -> np.ndarray:
    """``ApplyExifOrientation``: 2 flips left-right, 3 turns 180 degrees, 4
    flips up-down, 5 transposes, 6 turns 90 degrees clockwise, 7
    transverses, 8 turns 90 degrees counter-clockwise."""
    if value in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
        value = {5: 1, 6: 2, 7: 3, 8: 4}[value]
    if value == 2:
        img = img[:, ::-1]
    elif value == 3:
        img = img[::-1, ::-1]
    elif value == 4:
        img = img[::-1]
    return np.ascontiguousarray(img)
