"""The port's JPEG reader (``mast3r_slam_tpu_torch/data/jpeg.py``, the C++
decoder ``native/jpeg_decode.cpp``) against ``cv2.imdecode`` /
``cv2.imread`` and PIL, bit for bit, in the colour and the gray read:
baseline, progressive, 4:1:1, CMYK / YCCK and RGB-coded files, truncated
data (with its warning); its refusals; the committed fixtures; the format
sniffing of ``data/imread.py``; the Replica ``.jpg`` layout against the
JAX reader; and the test encoder ``tests/torch_jpeg_writer.py`` read back
by cv2, its progressive files decoding to its baseline files' pixels."""

import hashlib
import io
import itertools
import json
import struct
import warnings
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from mast3r_slam_tpu.data import datasets as JD  # noqa: E402
from mast3r_slam_tpu.utils import config as JCfg  # noqa: E402
from mast3r_slam_tpu_torch.data import datasets as TD  # noqa: E402
from mast3r_slam_tpu_torch.data import imread, jpeg, png  # noqa: E402
from torch_jpeg_writer import encode_jpeg, write_jpeg  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "data" / "jpeg"
SAMPLING = ("444", "422", "420", "440", "gray")
QUALITY = (50, 95, 100)
SIZES = ((1, 1), (9, 17), (65, 33), (680, 1200))     # (H, W)
RESTART = (0, 1, 7)


def _texture(h, w, seed):
    """Smooth color waves plus noise (every coefficient band in use)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ch = [np.sin(rng.uniform(0.01, 0.2) * xx + rng.uniform(0.01, 0.2) * yy
                 + rng.uniform(0, 6)) for _ in range(3)]
    img = (0.9 * np.stack(ch, -1) + 1.0) * 127.5 + rng.normal(0, 20,
                                                             (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_encode(rgb, sampling, quality, restart):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if sampling == "gray":
        ok, enc = cv2.imencode(".jpg", rgb[..., 0], params)
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
        ok, enc = cv2.imencode(".jpg", rgb[..., ::-1].copy(), params)
    assert ok
    return enc.tobytes()


def _cv2_decode(data):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    return img if img.ndim == 2 else img[..., ::-1]


def _pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("sampling,quality,hw,restart", list(
    itertools.product(SAMPLING, QUALITY, SIZES, RESTART)))
def test_decode_matches_cv2_and_pil(sampling, quality, hw, restart):
    """Every sampling mode, quality, size (1x1, odd, a Replica frame) and
    restart interval: the same bytes as cv2.imdecode and PIL."""
    data = _cv2_encode(_texture(*hw, seed=hw[0] * hw[1] + quality),
                       sampling, quality, restart)
    got = jpeg.decode_jpeg(data)
    want = _cv2_decode(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _pil_decode(data))


@pytest.mark.parametrize("hw", [(2, 3), (3, 4), (5, 6), (16, 16), (24, 40)])
@pytest.mark.parametrize("sampling", ["422", "420", "440"])
def test_decode_narrow_chroma(hw, sampling):
    """Chroma 1-3 samples wide: libjpeg replicates instead of the fancy
    triangle when the downsampled width is at most 2."""
    data = _cv2_encode(_texture(*hw, seed=7), sampling, 90, 0)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _cv2_decode(data))


@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("interleaved", [True, False])
@pytest.mark.parametrize("restart", [0, 2])
def test_writer_read_back_by_cv2(gray, interleaved, restart):
    """The test encoder's files (interleaved or one scan a component, with
    or without restart markers) as cv2 reads them: the port's decoder
    gives the same bytes, and they are the image within JPEG's loss."""
    yy, xx = np.mgrid[0:37, 0:53].astype(np.float64)
    img = np.stack([(xx * 4) % 256, (yy * 6) % 256,
                    128 + 100 * np.sin(xx / 7 + yy / 5)], -1).astype(
        np.uint8)
    if gray:
        img = img[..., 2]
    data = encode_jpeg(img, 95, restart_interval=restart,
                       interleaved=interleaved)
    want = _cv2_decode(data)
    assert want.shape == img.shape
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)
    assert np.abs(want.astype(int) - img).mean() < (2 if gray else 6)


def test_writer_replica_frame_read_back_by_cv2(tmp_path):
    """A 680x1200 frame as chip_smoke.py writes Replica's: cv2 and the
    port read the same bytes."""
    path = tmp_path / "frame000000.jpg"
    write_jpeg(path, _texture(680, 1200, 3), 90)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(imread.read_rgb(path), want)


def _patched(data, old, new):
    i = data.index(old)
    return data[:i] + new + data[i + len(old):]


def _sof(data):
    """Offset of the SOF0 marker."""
    return data.index(b"\xff\xc0")


def test_refusals_name_the_feature():
    base = _cv2_encode(_texture(16, 16, 1), "420", 90, 0)
    sof = _sof(base)
    cases = {
        # a baseline scan (Ss 0, Se 63) under a progressive frame header
        "progressive": base[:sof] + b"\xff\xc2" + base[sof + 2:],
        "lossless": base[:sof] + b"\xff\xc3" + base[sof + 2:],
        "arithmetic": base[:sof] + b"\xff\xc9" + base[sof + 2:],
        "hierarchical": base[:sof] + b"\xff\xc5" + base[sof + 2:],
        # SOF precision byte: marker, length (2), then precision
        "12-bit": base[:sof + 4] + b"\x0c" + base[sof + 5:],
        "truncated": base[:len(base) // 2],
    }
    for feature, data in cases.items():
        with pytest.raises(ValueError, match=feature):
            jpeg.decode_jpeg(data)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_jpeg(b"\x89PNG....")


def test_refuses_real_progressive_cmyk_and_rgb_files(tmp_path):
    """Files PIL writes that the decoder reads as cv2.imread does:
    progressive, CMYK (Adobe, 4 components, also progressive) and an
    RGB-coded JPEG (Adobe transform 0). What it still refuses: a
    progressive file cut before its first scans are complete (libjpeg
    smooths its blocks)."""
    rgb = _texture(24, 32, 2)
    files = {}
    for name, img, kw in (("prog", Image.fromarray(rgb),
                           dict(progressive=True)),
                          ("cmyk", Image.fromarray(rgb).convert("CMYK"), {}),
                          ("cmyk_prog", Image.fromarray(rgb).convert("CMYK"),
                           dict(progressive=True)),
                          ("rgb", Image.fromarray(rgb), dict(keep_rgb=True))):
        buf = io.BytesIO()
        img.save(buf, "JPEG", **kw)
        files[name] = buf.getvalue()
    assert Image.open(io.BytesIO(files["rgb"])).mode == "RGB"
    for name, data in files.items():
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        want = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), want, name)
        np.testing.assert_array_equal(
            jpeg.decode_jpeg(data, gray=True),
            cv2.imread(str(path), cv2.IMREAD_GRAYSCALE), name)
    with pytest.raises(ValueError, match="block smoothing"):
        jpeg.decode_jpeg(files["prog"][:len(files["prog"]) // 3])


def test_fixtures_match_their_recorded_cv2_digests():
    """The committed cv2-encoded fixtures decode to the digests of
    cv2.imdecode recorded beside them (chip_smoke.py's data phase checks
    the same on the card machine), and cv2 here still agrees."""
    rec = json.loads((FIXTURES / "fixtures.json").read_text())
    names = sorted(rec["decoded_sha256"])
    assert len(names) == 7
    assert sum((FIXTURES / n).stat().st_size for n in names) < 64_000
    for name in names:
        data = (FIXTURES / name).read_bytes()
        got = jpeg.decode_jpeg(data)
        assert list(got.shape) == rec["shape"][name]
        digest = hashlib.sha256(got.tobytes()).hexdigest()
        assert digest == rec["decoded_sha256"][name], name
        want = hashlib.sha256(np.ascontiguousarray(_cv2_decode(data))
                              .tobytes()).hexdigest()
        assert want == digest, name


def test_imread_picks_the_format_from_the_bytes(tmp_path):
    """A JPEG named .png and a PNG named .jpg read as cv2.imread reads
    them; gray repeats into three channels; anything else raises."""
    rgb = _texture(20, 30, 4)
    (tmp_path / "a.png").write_bytes(_cv2_encode(rgb, "444", 95, 0))
    png.write_png(tmp_path / "b.jpg", rgb)
    (tmp_path / "g.jpg").write_bytes(_cv2_encode(rgb, "gray", 95, 0))
    for name in ("a.png", "b.jpg", "g.jpg"):
        want = cv2.imread(str(tmp_path / name), cv2.IMREAD_COLOR)[..., ::-1]
        got = imread.read_rgb(tmp_path / name)
        assert got.shape == (20, 30, 3)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imread.read_rgb(tmp_path / "b.jpg"), rgb)
    (tmp_path / "c.jpg").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="neither"):
        imread.read_rgb(tmp_path / "c.jpg")


def test_decoder_build_failure_raises(monkeypatch, tmp_path):
    """No fallback: without a compiler the decoder raises."""
    monkeypatch.setattr(jpeg, "_lib", None)
    monkeypatch.setattr(jpeg, "_BUILD", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="JPEG decoder"):
        jpeg.decode_jpeg((FIXTURES / "s420.jpg").read_bytes())


@pytest.fixture
def jax_config():
    saved = dict(JCfg.config)
    JCfg.config.clear()
    JCfg.config.update({"dataset": {"img_size": 512}, "use_calib": False})
    yield {"dataset": {"img_size": 512}, "use_calib": False}
    JCfg.config.clear()
    JCfg.config.update(saved)


@pytest.mark.parametrize("use_calib", [False, True])
def test_replica_jpg_layout_matches_jax(tmp_path, jax_config, use_calib):
    """Replica's results/frame*.jpg + cam_params.json (its own layout) read
    by the port as by the JAX reader (cv2), frame for frame."""
    cfg = dict(jax_config, use_calib=use_calib)
    JCfg.config.update(cfg)
    r = tmp_path / "replica_office0"
    (r / "results").mkdir(parents=True)
    for i in range(3):
        write_jpeg(r / "results" / f"frame{i:06d}.jpg",
                   _texture(68, 120, i), 90)
    (r / "cam_params.json").write_text(
        '{"camera": {"w": 120, "h": 68, "fx": 60.0, "fy": 60.0, '
        '"cx": 59.5, "cy": 33.5, "scale": 6553.5}}')
    dt, dj = TD.load_dataset(str(r), cfg), JD.load_dataset(str(r))
    assert isinstance(dt, TD.ReplicaDataset) and len(dt) == len(dj) == 3
    assert dt.has_calib() == dj.has_calib() == use_calib
    for i in range(3):
        (tt, it), (tj, ij) = dt[i], dj[i]
        assert tt == tj and it.dtype == np.float32
        np.testing.assert_array_equal(it, ij)
    assert dt.get_img_shape() == dj.get_img_shape()
    np.testing.assert_allclose(dt.camera_intrinsics.K_frame,
                               dj.camera_intrinsics.K_frame, rtol=1e-6)


READS = json.loads((FIXTURES / "fixtures.json").read_text())["reads"]


def _cv2_read(data, tmp_path, gray=False):
    """cv2.imread of ``data`` from a file (a truncated file decodes only
    there: cv2.imdecode's memory source refuses it), as RGB."""
    path = tmp_path / "cv2.jpg"
    path.write_bytes(data)
    img = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE if gray
                     else cv2.IMREAD_COLOR)
    return img if gray else img[..., ::-1]


def _port_read(data, gray=False):
    """The port's read of ``data`` and whether it warned."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        img = imread.decode_image(data, gray)
    return img, [str(w.message) for w in caught]


def test_fixture_reads_are_recorded_and_small():
    names = sorted(p.name for p in FIXTURES.glob("*.jpg"))
    assert names == sorted(READS) and len(names) == 27
    assert all((FIXTURES / n).stat().st_size < 5000 for n in names)


@pytest.mark.parametrize("read", ["color", "gray"])
@pytest.mark.parametrize("name", sorted(READS))
def test_fixture_reads_match_cv2_and_their_digests(tmp_path, name, read):
    """Every committed fixture (sampling modes, progressive, 4:1:1, CMYK,
    YCCK, RGB-coded, three cuts, the EXIF orientations) reads to the
    digest of cv2.imread's read recorded beside it, as cv2 here reads it;
    the cut files warn."""
    rec = READS[name]
    data = (FIXTURES / name).read_bytes()
    got, warned = _port_read(data, read == "gray")
    assert list(got.shape) == rec[f"{read}_shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == rec[f"{read}_sha256"]
    np.testing.assert_array_equal(got, _cv2_read(data, tmp_path,
                                                 read == "gray"))
    assert bool(warned) == name.startswith("cut"), warned


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("hw", [(1, 1), (9, 17), (65, 33), (680, 1200)])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "411",
                                      "gray"])
def test_progressive_and_411_match_cv2(sampling, progressive, hw, restart):
    """cv2's progressive files (jpeg_simple_progression: DC and AC first
    and refinement scans, end-of-band runs, restarts inside progressive
    scans) and 4:1:1 files, colour and gray reads, at 1x1, odd sizes and
    a Replica frame."""
    rgb = _texture(*hw, seed=hw[0] + hw[1] + restart)
    params = [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL,
              restart, cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    if sampling == "gray":
        ok, enc = cv2.imencode(".jpg", rgb[..., 0], params)
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")]
        ok, enc = cv2.imencode(".jpg", rgb[..., ::-1].copy(), params)
    assert ok
    buf = enc
    data = enc.tobytes()
    np.testing.assert_array_equal(jpeg.decode_jpeg(data), _cv2_decode(data))
    np.testing.assert_array_equal(
        jpeg.decode_jpeg(data, gray=True),
        cv2.imdecode(buf, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("sampling", SAMPLING)
@pytest.mark.parametrize("hw", [(16, 16), (65, 33)])
def test_gray_read_is_the_y_channel(sampling, hw):
    """cv2.IMREAD_GRAYSCALE of a colour JPEG: libjpeg's Y channel, no
    colour conversion."""
    data = _cv2_encode(_texture(*hw, seed=5), sampling, 90, 0)
    np.testing.assert_array_equal(
        jpeg.decode_jpeg(data, gray=True),
        cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("quality", [40, 95])
@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("hw", [(1, 1), (9, 17), (37, 53), (120, 200)])
def test_progressive_writer_decodes_to_the_baseline_pixels(hw, gray,
                                                          quality):
    """The test encoder's progressive files (the same quantized
    coefficients in jpeg_simple_progression's scans) decode, in cv2 and in
    the port, to exactly its baseline files' pixels."""
    rng = np.random.default_rng(hw[0] * 7 + quality)
    img = np.clip(_texture(*hw, seed=hw[1]).astype(int)
                  + rng.normal(0, 25, hw + (3,)), 0, 255).astype(np.uint8)
    if gray:
        img = img[..., 1]
    base = encode_jpeg(img, quality)
    prog = encode_jpeg(img, quality, progressive=True)
    assert b"\xff\xc2" in prog and b"\xff\xc2" not in base
    want = _cv2_decode(base)
    np.testing.assert_array_equal(_cv2_decode(prog), want)
    np.testing.assert_array_equal(jpeg.decode_jpeg(prog), want)
    np.testing.assert_array_equal(jpeg.decode_jpeg(prog, gray=True),
                                  jpeg.decode_jpeg(base, gray=True))


@pytest.mark.parametrize("cut", [0.2, 0.45, 0.7, 0.95, "no EOI"])
@pytest.mark.parametrize("kind", ["baseline", "restart 2", "one scan a "
                                  "component", "progressive"])
def test_truncated_data_matches_cv2_with_a_warning(tmp_path, kind, cut):
    """Data that ends early decodes as libjpeg decodes it (zero bits past
    the end, the MCU in progress finished with them, later MCUs left as
    they were) with one warning. A progressive file cut before its scans
    are complete is refused (libjpeg smooths its blocks): only its late
    cuts are compared."""
    img = _texture(96, 128, seed=11)
    if kind == "one scan a component":
        data = encode_jpeg(img, 90, interleaved=False)
    else:
        params = [cv2.IMWRITE_JPEG_QUALITY, 90,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, 2 if "restart" in kind
                  else 0, cv2.IMWRITE_JPEG_PROGRESSIVE,
                  int(kind == "progressive")]
        data = cv2.imencode(".jpg", img[..., ::-1].copy(), params)[1]
        data = data.tobytes()
    if cut == "no EOI":
        data = data[:-2]
    else:
        sos = data.index(b"\xff\xda")
        if kind == "progressive":
            cut = 0.9 + cut / 10         # inside the last scans
        data = data[:sos + int(cut * (len(data) - sos))]
    for gray in (False, True):
        got, warned = _port_read(data, gray)
        assert len(warned) == 1 and "truncated" in warned[0]
        np.testing.assert_array_equal(got, _cv2_read(data, tmp_path, gray))


def test_standard_tables_when_a_file_defines_none(tmp_path):
    """A Motion-JPEG frame without DHT: libjpeg-turbo takes the standard
    tables, as the port does."""
    bare = _cv2_encode(_texture(24, 40, 3), "422", 90, 0)
    while b"\xff\xc4" in bare:
        i = bare.index(b"\xff\xc4")
        bare = bare[:i] + bare[i + 2 + struct.unpack(">H",
                                                     bare[i + 2:i + 4])[0]:]
    np.testing.assert_array_equal(imread.decode_image(bare),
                                  _cv2_read(bare, tmp_path))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("hw", [(1, 1), (31, 45), (96, 128)])
def test_cmyk_files_match_cv2(tmp_path, hw, progressive):
    """Random CMYK (Adobe, inverted) as PIL writes it, and the same file
    marked YCCK (Adobe transform 2): OpenCV's CMYK -> RGB and CMYK -> gray
    of libjpeg's CMYK output."""
    cmyk = np.random.default_rng(hw[0]).integers(0, 256, hw + (4,),
                                                 dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=95,
                                       progressive=progressive)
    data = buf.getvalue()
    t = data.index(b"\xff\xee\x00\x0eAdobe") + 15
    for transform in (0, 2):
        d = data[:t] + bytes([transform]) + data[t + 1:]
        for gray in (False, True):
            got, _ = _port_read(d, gray)
            np.testing.assert_array_equal(got, _cv2_read(d, tmp_path, gray))
