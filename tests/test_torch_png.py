"""The port's PNG reader (``mast3r_slam_tpu_torch/data/png.py`` through
``data/imread.py``) against ``cv2.imread``, bit for bit, in the colour read
(``IMREAD_COLOR``, as RGB) and the gray read (``IMREAD_GRAYSCALE``): the
committed fixtures of ``tests/data/png`` against cv2 and their recorded
digests, every colour type x bit depth x interlace the test writer
(``tests/torch_png_writer.py``) writes, libpng's gamma path of the gray
read, 16-bit samples cut to their high byte, and the files both refuse."""

import hashlib
import json
import struct
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

cv2 = pytest.importorskip("cv2")

from mast3r_slam_tpu_torch.data import image_host, imread, png  # noqa: E402
from torch_png_writer import CHANNELS, DEPTHS, chunk, encode_png  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "data" / "png"
RECORD = json.loads((FIXTURES / "fixtures.json").read_text())
KINDS = [(ct, d) for ct, depths in DEPTHS.items() for d in depths]


def _cv2_reads(path):
    rgb = cv2.imread(str(path), cv2.IMREAD_COLOR)
    gray = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    return (None if rgb is None else rgb[..., ::-1]), gray


def _both(tmp_path, data, name="a.png"):
    """(port colour, port gray, cv2 colour, cv2 gray) of PNG ``data``."""
    path = tmp_path / name
    path.write_bytes(data)
    return (imread.read_rgb(path), imread.read_gray(path), *_cv2_reads(path))


def _digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def test_fixtures_are_recorded_and_small():
    names = sorted(p.name for p in FIXTURES.glob("*.png"))
    assert names == sorted(RECORD["reads"]) and len(names) == 46
    assert all((FIXTURES / n).stat().st_size < 5000 for n in names)


@pytest.mark.parametrize("read", ["color", "gray"])
@pytest.mark.parametrize("name", sorted(RECORD["reads"]))
def test_fixture_matches_cv2_and_its_digest(name, read):
    """Each committed fixture reads to the digest of cv2's read recorded
    beside it (chip_smoke.py's data phase checks the same on the card
    machine), and cv2 here still agrees."""
    rec = RECORD["reads"][name]
    path = FIXTURES / name
    got = (imread.read_gray if read == "gray" else imread.read_rgb)(path)
    assert got.dtype == np.uint8 and list(got.shape) == rec[f"{read}_shape"]
    assert _digest(got) == rec[f"{read}_sha256"]
    want = _cv2_reads(path)[read == "gray"]
    np.testing.assert_array_equal(got, want)


def _samples(shape, depth, rng):
    return rng.integers(0, 1 << depth, shape)


def _expected_color(img, ct, depth, palette=None):
    """What libpng under OpenCV's settings gives for the colour read:
    palette expanded, alpha dropped, 16 bits cut to the high byte, 1-4 bit
    gray scaled to 8 bits, gray repeated into RGB."""
    if ct == 3:
        return palette[img].astype(np.uint8)
    v = img >> 8 if depth == 16 else img * (255 // ((1 << depth) - 1))
    v = v.astype(np.uint8)
    if ct in (0, 4):
        g = v if ct == 0 else v[..., 0]
        return np.repeat(g[..., None], 3, -1)
    return v[..., :3]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (17, 33)])
@pytest.mark.parametrize("ct,depth", KINDS)
def test_writer_kinds_read_as_cv2_reads_them(tmp_path, ct, depth, hw,
                                             interlace):
    """Every colour type x depth, plain and Adam7, at sizes that leave
    partial bytes and empty interlace passes: the port reads what cv2
    reads, in both reads, and the colour read is the written image."""
    rng = np.random.default_rng(ct * 100 + depth + hw[0])
    shape = hw if CHANNELS[ct] == 1 else hw + (CHANNELS[ct],)
    kw = dict(color_type=ct, depth=depth, interlace=interlace)
    if ct == 3:
        kw["palette"] = rng.integers(0, 256, (min(1 << depth, 50), 3))
        img = rng.integers(0, len(kw["palette"]), shape)
    else:
        img = _samples(shape, depth, rng)
    rgb, gray, want_rgb, want_gray = _both(tmp_path, encode_png(img, **kw))
    np.testing.assert_array_equal(rgb, want_rgb)
    np.testing.assert_array_equal(gray, want_gray)
    np.testing.assert_array_equal(
        rgb, _expected_color(img, ct, depth, kw.get("palette")))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ct,depth", [(0, 1), (0, 16), (2, 16), (3, 4),
                                      (4, 8), (6, 16)])
def test_each_filter_at_each_pixel_width(tmp_path, ct, depth, filt):
    """One scanline filter on every row, at pixel widths of 1 (below a
    byte) to 8 bytes: Sub, Average and Paeth reach back one pixel."""
    rng = np.random.default_rng(filt * 10 + ct)
    shape = (9, 11) if CHANNELS[ct] == 1 else (9, 11, CHANNELS[ct])
    kw = dict(color_type=ct, depth=depth, filters=filt)
    if ct == 3:
        kw["palette"] = rng.integers(0, 256, (16, 3))
    img = _samples(shape, depth, rng)
    rgb, gray, want_rgb, want_gray = _both(tmp_path, encode_png(img, **kw))
    np.testing.assert_array_equal(rgb, want_rgb)
    np.testing.assert_array_equal(gray, want_gray)


def test_sixteen_bits_keep_the_high_byte(tmp_path):
    """libpng's png_set_strip_16 under OpenCV: 383 -> 1, 32767 -> 127
    (png_set_scale_16 would give 128), 32896 -> 128."""
    v = np.array([[383, 32767, 32896, 33023, 65535, 255, 256, 0]])
    rgb, gray, want_rgb, want_gray = _both(tmp_path, encode_png(v, depth=16))
    np.testing.assert_array_equal(gray[0], [1, 127, 128, 128, 255, 0, 1, 0])
    np.testing.assert_array_equal(gray, want_gray)
    np.testing.assert_array_equal(rgb, want_rgb)


@pytest.mark.parametrize("gamma", [None, 45455, 50000, 97000, 220000,
                                   "srgb", "srgb+gAMA 1.0"])
@pytest.mark.parametrize("ct", [2, 3, 6])
def test_gray_read_of_colour_follows_libpng_gamma(tmp_path, ct, gamma):
    """The gray read converts colour with libpng's rgb_to_gray: truncated
    fixed-point weights without a significant gamma, and through its
    8-bit gamma tables (rounded) when an sRGB or gAMA chunk makes the file
    gamma differ from 1 by more than 5% (sRGB wins over gAMA)."""
    rng = np.random.default_rng(7)
    shape = (6, 40, 4) if ct == 6 else (6, 40, 3)
    kw = {}
    if ct == 3:
        kw["palette"] = rng.integers(0, 256, (30, 3))
        img = rng.integers(0, 30, shape[:2])
    else:
        img = rng.integers(0, 256, shape)
        img[0, :4, :3] = 77            # gray pixels stay as they are
    if isinstance(gamma, int):
        kw["gamma"] = gamma
    data = encode_png(img, **kw)
    if isinstance(gamma, str):
        extra = chunk(b"sRGB", b"\0")
        if "gAMA" in gamma:
            extra += chunk(b"gAMA", struct.pack(">I", 100000))
        data = data[:33] + extra + data[33:]
    rgb, gray, want_rgb, want_gray = _both(tmp_path, data)
    np.testing.assert_array_equal(gray, want_gray)
    np.testing.assert_array_equal(rgb, want_rgb)


@pytest.mark.parametrize("interlace", [False, True])
def test_gray_read_of_sixteen_bit_colour_rounds(tmp_path, interlace):
    """libpng converts 16-bit colour at 16 bits, rounded, then keeps the
    high byte."""
    img = np.random.default_rng(3).integers(0, 65536, (5, 23, 3))
    _, gray, _, want_gray = _both(
        tmp_path, encode_png(img, depth=16, interlace=interlace))
    np.testing.assert_array_equal(gray, want_gray)


def test_palette_index_past_the_palette_reads_black(tmp_path):
    pal = np.array([[10, 20, 30], [40, 50, 60]])
    rgb, gray, want_rgb, want_gray = _both(
        tmp_path, encode_png(np.array([[0, 1, 9, 15]]), palette=pal,
                             depth=4))
    np.testing.assert_array_equal(rgb, want_rgb)
    np.testing.assert_array_equal(rgb[0, 2:], 0)
    np.testing.assert_array_equal(gray, want_gray)


def test_png_of_every_kind_is_told_apart_from_its_name(tmp_path):
    """A PNG named .jpg reads as a PNG (cv2 goes by the bytes too)."""
    img = np.random.default_rng(1).integers(0, 65536, (5, 6, 4))
    rgb, gray, want_rgb, want_gray = _both(
        tmp_path, encode_png(img, depth=16, interlace=True), "a.jpg")
    np.testing.assert_array_equal(rgb, want_rgb)
    np.testing.assert_array_equal(gray, want_gray)


def _patched_header(data, **fields):
    """``data`` with IHDR fields replaced (the CRC is not checked by the
    port; cv2's libpng refuses these files for their header)."""
    w, h, depth, ct, comp, filt, il = struct.unpack(">IIBBBBB", data[16:29])
    vals = dict(depth=depth, ct=ct, comp=comp, il=il)
    vals.update(fields)
    ihdr = struct.pack(">IIBBBBB", w, h, vals["depth"], vals["ct"],
                       vals["comp"], filt, vals["il"])
    return data[:8] + chunk(b"IHDR", ihdr) + data[33:]


@pytest.mark.parametrize("case", ["depth 3", "rgb at 4 bits", "color type 5",
                                  "compression 1", "interlace 2",
                                  "palette without PLTE", "no IEND"])
def test_files_both_refuse(tmp_path, case):
    """Headers the PNG standard does not allow, a palette file without its
    palette, a file cut before IEND: cv2 reads nothing and the port
    raises."""
    img = np.random.default_rng(0).integers(0, 4, (4, 5))
    data = encode_png(img, depth=8)
    data = {
        "depth 3": lambda: _patched_header(data, depth=3),
        "rgb at 4 bits": lambda: _patched_header(
            encode_png(np.zeros((4, 5, 3), int)), depth=4),
        "color type 5": lambda: _patched_header(data, ct=5),
        "compression 1": lambda: _patched_header(data, comp=1),
        "interlace 2": lambda: _patched_header(data, il=2),
        "palette without PLTE": lambda: _patched_header(data, ct=3),
        "no IEND": lambda: data[:-12],
    }[case]()
    path = tmp_path / "bad.png"
    path.write_bytes(data)
    assert cv2.imread(str(path), cv2.IMREAD_COLOR) is None
    with pytest.raises(ValueError, match="PNG"):
        imread.read_rgb(path)


def test_gray_read_of_sixteen_bit_colour_with_gamma_is_refused(tmp_path):
    """libpng's 16-bit gamma tables are not reproduced: the port raises
    where cv2 would read (no dataset reader meets such a file: only
    EuRoC's gray read converts colour)."""
    img = np.random.default_rng(0).integers(0, 65536, (3, 4, 3))
    path = tmp_path / "g16.png"
    path.write_bytes(encode_png(img, depth=16, gamma=45455))
    with pytest.raises(ValueError, match="16-bit colour"):
        imread.read_gray(path)
    np.testing.assert_array_equal(
        imread.read_rgb(path),
        cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1])


def test_decode_png_keeps_the_stored_channels():
    """``png.decode_png`` without ``gray``: gray, gray + alpha, RGB (a
    palette expanded) and RGBA at 8 bits, as the file stores them."""
    rng = np.random.default_rng(2)
    for ct in (0, 2, 4, 6):
        shape = (3, 4) if CHANNELS[ct] == 1 else (3, 4, CHANNELS[ct])
        img = rng.integers(0, 65536, shape)
        got = png.decode_png(encode_png(img, color_type=ct, depth=16))
        np.testing.assert_array_equal(got, (img >> 8).astype(np.uint8))
    pal = rng.integers(0, 256, (4, 3))
    idx = rng.integers(0, 4, (3, 4))
    np.testing.assert_array_equal(
        png.decode_png(encode_png(idx, palette=pal, depth=2)), pal[idx])


# ---------------------------------------------------------------------------
# The compiled unfilter (data/image_host.py) against its plain version
# ---------------------------------------------------------------------------

BPPS = (1, 2, 3, 4, 6, 8)
# (rows, pixels) of a pass: one row, one pixel a row, an odd width
PASS_SHAPES = {"one row": (1, 9), "one pixel": (6, 1), "odd width": (5, 7)}


def _pass(rng, rows, pixels, bpp, filters, high=256):
    raw = rng.integers(0, high, (rows, 1 + pixels * bpp)).astype(np.uint8)
    raw[:, 0] = filters
    return raw


@pytest.mark.parametrize("shape", sorted(PASS_SHAPES))
@pytest.mark.parametrize("bpp", BPPS)
@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_unfilter_equals_plain_version(filt, bpp, shape):
    """Every filter type at every bytes-per-pixel a PNG has (1: gray and
    palettes, 2: gray + alpha or 16-bit gray, 3: RGB, 4, 6: 16-bit RGB, 8:
    16-bit RGBA), on one-row, one-pixel and odd-width passes, byte for
    byte; small samples (0-3) make Paeth's ties frequent."""
    rng = np.random.default_rng(filt * 100 + bpp)
    rows, pixels = PASS_SHAPES[shape]
    for high in (256, 4):
        raw = _pass(rng, rows, pixels, bpp, filt, high)
        got = image_host.png_unfilter(raw, bpp)
        assert got.dtype == np.uint8 and got.shape == (rows, pixels * bpp)
        np.testing.assert_array_equal(got, png.unfilter_ref(raw, bpp))


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(data=st.data(), bpp=st.sampled_from(BPPS),
       rows=st.integers(1, 12), pixels=st.integers(1, 23),
       high=st.sampled_from([2, 8, 256]))
def test_unfilter_random_rows_and_filters_hypothesis(data, bpp, rows, pixels,
                                                     high):
    """Random bytes with a random filter type on each row."""
    filters = data.draw(st.lists(st.integers(0, 4), min_size=rows,
                                 max_size=rows))
    seed = data.draw(st.integers(0, 2**32 - 1))
    raw = _pass(np.random.default_rng(seed), rows, pixels, bpp, filters, high)
    np.testing.assert_array_equal(image_host.png_unfilter(raw, bpp),
                                  png.unfilter_ref(raw, bpp))


@pytest.mark.parametrize("bad", [5, 7, 255])
def test_unfilter_refuses_a_bad_filter_type(bad):
    """A filter type above 4, on the first row or a later one, raises as
    the plain version raises."""
    for row in (0, 2):
        raw = _pass(np.random.default_rng(bad), 3, 4, 3, 1)
        raw[row, 0] = bad
        for fn in (image_host.png_unfilter, png.unfilter_ref):
            with pytest.raises(ValueError, match=f"bad PNG filter type {bad}"):
                fn(raw, 3)


def test_decode_never_reaches_the_plain_unfilter(tmp_path, monkeypatch):
    """A read of every filter type, plain and Adam7, runs the compiled
    unfilter only; without the library (its build failing) the read
    raises and does not fall back to the plain version."""
    from mast3r_slam_tpu_torch import _build

    def refused(*a, **k):
        raise AssertionError("the plain unfilter was called")

    monkeypatch.setattr(png, "unfilter_ref", refused)
    monkeypatch.setattr(png, "_unfilter_row", refused)
    img = np.random.default_rng(3).integers(0, 256, (9, 11, 3))
    for il in (False, True):
        for f in range(5):
            data = encode_png(img, interlace=il, filters=f)
            np.testing.assert_array_equal(png.decode_png(data), img)

    def no_compiler(*a, **k):
        raise RuntimeError("building the image host library failed: no g++")

    monkeypatch.setattr(image_host, "_lib", None)
    monkeypatch.setattr(_build, "build_host", no_compiler)
    with pytest.raises(RuntimeError, match="image host library"):
        png.decode_png(encode_png(img, filters=4))
