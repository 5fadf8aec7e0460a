"""The port's JPEG reader (``mast3r_slam_tpu_torch/data/jpeg.py``, the C++
decoder ``native/jpeg_decode.cpp``) against ``cv2.imdecode`` and PIL, bit
for bit; its refusals; the committed fixtures; the format sniffing of
``data/imread.py``; the Replica ``.jpg`` layout against the JAX reader;
and the test encoder ``tests/torch_jpeg_writer.py`` read back by cv2."""

import hashlib
import io
import itertools
import json
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


def test_refuses_real_progressive_cmyk_and_rgb_files():
    """Files PIL writes: progressive, CMYK (Adobe, 4 components) and an
    RGB-coded JPEG (Adobe transform 0)."""
    rgb = _texture(24, 32, 2)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", progressive=True)
    with pytest.raises(ValueError, match="progressive"):
        jpeg.decode_jpeg(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, "JPEG")
    with pytest.raises(ValueError, match="4-component"):
        jpeg.decode_jpeg(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", keep_rgb=True)
    assert Image.open(io.BytesIO(buf.getvalue())).mode == "RGB"
    with pytest.raises(ValueError, match="Adobe transform"):
        jpeg.decode_jpeg(buf.getvalue())


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
