"""The EXIF orientation (``mast3r_slam_tpu_torch/data/exif.py``) as
``cv2.imread`` applies it, for the colour read and the gray read, in a
JPEG's ``APP1 Exif`` segment and a PNG's ``eXIf`` chunk: all 8 values and
those outside 1-8, both TIFF byte orders, malformed IFDs, the other tags
whose data OpenCV's ``ExifReader`` reads, several Exif segments, and a
derandomized hypothesis sweep of orientation x image shape. Every case is
held against cv2 here, bit for bit."""

import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

cv2 = pytest.importorskip("cv2")

from mast3r_slam_tpu_torch.data import exif, imread  # noqa: E402
from torch_png_writer import chunk, encode_png, exif_orientation  # noqa: E402

# OpenCV's ApplyExifOrientation on a 3x4 gray image of rows 0..220
# (10 * row + col): the 8 values as flips and turns
TABLE = {1: lambda a: a, 2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
         4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
         6: lambda a: np.rot90(a, -1),
         7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
         8: lambda a: np.rot90(a, 1)}


def _tiff(entries, order="II", magic=42, ifd=8, count=None, cut=None):
    """TIFF bytes with IFD0 at ``ifd`` holding ``entries`` (tag, type,
    count, value) — a SHORT's value in the first two bytes of the field,
    anything else as a 32-bit word, or raw bytes."""
    e = "<" if order == "II" else ">"
    b = order.encode() + struct.pack(e + "HI", magic, ifd)
    b += b"\0" * (ifd - 8)
    b += struct.pack(e + "H", len(entries) if count is None else count)
    for tag, typ, cnt, val in entries:
        b += struct.pack(e + "HHI", tag, typ, cnt)
        if isinstance(val, bytes):
            b += val
        elif typ == 3:
            b += struct.pack(e + "HH", val, 0)
        else:
            b += struct.pack(e + "I", val)
    b += struct.pack(e + "I", 0)
    return b if cut is None else b[:cut]


def _orient(value, order="II", **kw):
    return _tiff([(0x0112, 3, 1, value)], order, **kw)


def _image(h=12, w=20, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    return np.clip(np.stack([xx * 12, yy * 20, 128 + 0 * xx], -1)
                   + rng.integers(-9, 9, (h, w, 3)), 0, 255).astype(np.uint8)


def _jpeg(img, blocks):
    """A cv2 JPEG of ``img`` with one APP1 segment per block after APP0."""
    ok, enc = cv2.imencode(".jpg", img[..., ::-1].copy(),
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
    assert ok
    data = enc.tobytes()
    app0 = 4 + struct.unpack(">H", data[4:6])[0]
    segs = b"".join(b"\xff\xe1" + struct.pack(">H", len(p) + 2) + p
                    for p in blocks)
    return data[:app0] + segs + data[app0:]


def _check(tmp_path, data, name):
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(imread.read_rgb(path), want)
    np.testing.assert_array_equal(imread.read_gray(path),
                                  cv2.imread(str(path),
                                             cv2.IMREAD_GRAYSCALE))
    return want


def test_apply_orientation_matches_opencvs_table():
    a = (10 * np.arange(3)[:, None] + np.arange(4)[None]).astype(np.uint8)
    for value, f in TABLE.items():
        np.testing.assert_array_equal(exif.apply_orientation(a, value), f(a))
    for value in (0, 9, 255, 0x0106):
        np.testing.assert_array_equal(exif.apply_orientation(a, value), a)


@pytest.mark.parametrize("order", ["II", "MM"])
@pytest.mark.parametrize("value", range(10))
@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_orientation_matches_cv2(tmp_path, fmt, value, order):
    """All 8 values (and 0, 9: left as they are), both byte orders, both
    formats, both reads."""
    img = _image()
    data = (encode_png(img, exif=_orient(value, order)) if fmt == "png"
            else _jpeg(img, [b"Exif\0\0" + _orient(value, order)]))
    got = _check(tmp_path, data, f"a.{fmt}")
    if 1 <= value <= 8 and fmt == "png":
        np.testing.assert_array_equal(got, TABLE[value](img))


MALFORMED = {
    "type LONG": _tiff([(0x0112, 4, 1, 6)]),
    "type BYTE": _tiff([(0x0112, 1, 1, 6)]),
    "count 0": _tiff([(0x0112, 3, 0, 6)]),
    "mark 43": _orient(6, magic=43),
    "mixed order": b"IM" + _orient(6)[2:],
    "IFD at 16": _orient(6, ifd=16),
    "IFD at 0": _orient(6)[:4] + b"\0\0\0\0" + _orient(6)[8:],
    "IFD past the end": _orient(6)[:4] + struct.pack("<I", 999)
    + _orient(6)[8:],
    "five entries claimed": _orient(6, count=5),
    "value cut": _orient(6, cut=19),
    "next IFD cut": _orient(6, cut=22),
    "two orientations": _tiff([(0x0112, 3, 1, 3), (0x0112, 3, 1, 6)]),
    "unknown tag first": _tiff([(0x9999, 3, 1, 5), (0x0112, 3, 1, 6)]),
    "value in the high half": _tiff([(0x0112, 3, 1, b"\x06\x01\0\0")]),
    "empty": b"",
    "two bytes": b"II",
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_malformed_blocks_match_cv2(tmp_path, fmt, case):
    """OpenCV's ExifReader on odd blocks: the orientation word read
    whatever the type or count, the first of two kept, the entries read
    before one runs past the end kept; a bad header, mark or IFD offset
    reads nothing."""
    img = _image(9, 14, seed=1)
    block = MALFORMED[case]
    data = (encode_png(img, exif=block) if fmt == "png"
            else _jpeg(img, [b"Exif\0\0" + block]))
    _check(tmp_path, data, f"a.{fmt}")


# tags whose data ExifReader reads before the orientation entry: a
# string or rationals past the end stop the reading there
PRECEDING = [
    ("Make, string past the end", 0x010F, 2, 20, 5000),
    ("Make, 3 bytes inline", 0x010F, 2, 3, 0x414141),
    ("ImageDescription past the end", 0x010E, 2, 20, 5000),
    ("Copyright past the end", 0x8298, 2, 20, 5000),
    ("XResolution past the end", 0x011A, 5, 1, 5000),
    ("XResolution at offset 1", 0x011A, 3, 1, 1),
    ("WhitePoint at offset 1", 0x013E, 3, 1, 1),
    ("PrimaryChromaticities at offset 1", 0x013F, 3, 1, 1),
    ("YCbCrCoefficients at offset 1", 0x0211, 3, 1, 1),
    ("ReferenceBlackWhite at offset 1", 0x0214, 3, 1, 1),
    ("ResolutionUnit", 0x0128, 3, 1, 2),
    ("Artist past the end (not read)", 0x013B, 2, 20, 5000),
    ("ExifOffset past the end (not read)", 0x8769, 4, 1, 5000),
]


@pytest.mark.parametrize("case", PRECEDING, ids=[c[0] for c in PRECEDING])
@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_tags_before_the_orientation_match_cv2(tmp_path, fmt, case):
    _, tag, typ, cnt, val = case
    block = _tiff([(tag, typ, cnt, val), (0x0112, 3, 1, 6)])
    img = _image(8, 13, seed=2)
    data = (encode_png(img, exif=block) if fmt == "png"
            else _jpeg(img, [b"Exif\0\0" + block]))
    _check(tmp_path, data, f"a.{fmt}")


SEGMENTS = {
    "6 then 3": [b"Exif\0\0" + _orient(6), b"Exif\0\0" + _orient(3)],
    "bad block then 3": [b"Exif\0\0XX" + _orient(6)[2:],
                         b"Exif\0\0" + _orient(3)],
    "no orientation then 3": [b"Exif\0\0" + _tiff([(0x0128, 3, 1, 2)]),
                              b"Exif\0\0" + _orient(3)],
    "9 then 3": [b"Exif\0\0" + _orient(9), b"Exif\0\0" + _orient(3)],
    "XMP then 6": [b"http://ns.adobe.com/xap/1.0/\0<x/>",
                   b"Exif\0\0" + _orient(6)],
    "Exif\\0\\1 header": [b"Exif\0\1" + _orient(6)],
    "no Exif header": [_orient(6)],
}


@pytest.mark.parametrize("case", sorted(SEGMENTS))
def test_jpeg_exif_segments_match_cv2(tmp_path, case):
    """Every APP1 segment that starts Exif\\0\\0, in file order: the first
    orientation read wins, even one outside 1-8."""
    _check(tmp_path, _jpeg(_image(10, 16, seed=3), SEGMENTS[case]),
           "a.jpg")


def test_jpeg_exif_after_the_scan_is_not_read(tmp_path):
    data = _jpeg(_image(10, 16, seed=4), [])
    body = b"Exif\0\0" + _orient(6)
    seg = b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
    got = _check(tmp_path, data[:-2] + seg + data[-2:], "a.jpg")
    assert got.shape == (10, 16, 3)


@pytest.mark.parametrize("case", ["after IDAT", "Exif header", "two chunks"])
def test_png_exif_chunk_placement_matches_cv2(tmp_path, case):
    """libpng keeps the first eXIf chunk, before or after the image data;
    one that starts with JPEG's Exif\\0\\0 header is not TIFF."""
    img = _image(7, 11, seed=5)
    if case == "after IDAT":
        data = encode_png(img, exif=_orient(8), exif_after_idat=True)
    elif case == "Exif header":
        data = encode_png(img, exif=b"Exif\0\0" + _orient(8))
    else:
        data = encode_png(img, exif=_orient(8))
        i = data.index(b"IDAT") - 4
        data = data[:i] + chunk(b"eXIf", _orient(5)) + data[i:]
    _check(tmp_path, data, "a.png")


@settings(max_examples=60, deadline=None, derandomize=True)
@given(value=st.integers(0, 9), h=st.integers(1, 24), w=st.integers(1, 24),
       order=st.sampled_from(["II", "MM"]), gray=st.booleans())
def test_orientation_by_shape_hypothesis(value, h, w, order, gray):
    """Orientation x shape (1x1 up, square and not) x byte order x read:
    the port's PNG read equals cv2.imdecode's."""
    img = _image(h, w, seed=h * 31 + w)
    data = encode_png(img[..., 1] if gray else img,
                      exif=exif_orientation(value, order))
    buf = np.frombuffer(data, np.uint8)
    for g in (False, True):
        want = cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE if g
                            else cv2.IMREAD_COLOR)
        if not g:
            want = want[..., ::-1]
        np.testing.assert_array_equal(imread.decode_image(data, g), want)
