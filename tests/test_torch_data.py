"""Port parity of the data layer: the stdlib PNG codec against OpenCV, the
cv2-free ``resize_img`` against the JAX package's (which calls
``cv2.resize``), and the dataset readers against the JAX package's on the
fixtures of tests/test_datasets.py (undistorted frames within
``REMAP_TOL``; tests/test_torch_undistort.py holds the undistortion
itself)."""

import struct
import zlib

import numpy as np
import pytest
import yaml

cv2 = pytest.importorskip("cv2")

from mast3r_slam_tpu.data import datasets as JD  # noqa: E402
from mast3r_slam_tpu.data import image_ops as JI  # noqa: E402
from mast3r_slam_tpu.utils import config as JCfg  # noqa: E402
from mast3r_slam_tpu_torch.data import datasets as TD  # noqa: E402
from mast3r_slam_tpu_torch.data import image_ops as TI  # noqa: E402
from mast3r_slam_tpu_torch.data import image_host, imread, png  # noqa: E402

RNG = np.random.default_rng(31)
FILTERS = ["NONE", "SUB", "UP", "AVG", "PAETH"]
REMAP_TOL = 3e-7          # the port's remap against cv2.remap


def _img(h=48, w=64, c=3):
    shape = (h, w) if c == 1 else (h, w, c)
    return (RNG.random(shape) * 255).astype(np.uint8)


def _smooth(h=40, w=56):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([(xx + yy) % 256, (2 * xx) % 256, (3 * yy) % 256],
                    -1).astype(np.uint8)


@pytest.mark.parametrize("kind", ["rgb", "gray", "rgba"])
@pytest.mark.parametrize("filt", FILTERS)
def test_png_decode_matches_cv2(tmp_path, kind, filt):
    """Files cv2 writes with each of the five scanline filters forced."""
    img = {"rgb": _smooth(), "gray": _smooth()[..., 0],
           "rgba": np.concatenate([_smooth(), _img(40, 56, 1)[..., None]],
                                  -1)}[kind]
    path = tmp_path / "a.png"
    cv2.imwrite(str(path), img if img.ndim == 2 else img[..., ::-1].copy()
                if kind == "rgb" else img[..., [2, 1, 0, 3]].copy(),
                [cv2.IMWRITE_PNG_FILTER,
                 getattr(cv2, f"IMWRITE_PNG_FILTER_{filt}")])
    got = png.read_png(path)
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if want.ndim == 3:
        want = want[..., [2, 1, 0, 3][:want.shape[2]]]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)
    rgb = imread.read_rgb(path)
    assert rgb.shape == (40, 56, 3) and rgb.dtype == np.uint8


def test_png_decode_noise_all_filters_mixed(tmp_path):
    """cv2's own adaptive filter choice on noise and on a gradient."""
    for img in (_img(33, 47), _smooth(64, 96)):
        path = tmp_path / "b.png"
        cv2.imwrite(str(path), img[..., ::-1].copy())
        np.testing.assert_array_equal(imread.read_rgb(path), img)


def test_png_writer_read_back_by_cv2(tmp_path):
    img = _img(37, 53)
    png.write_png(tmp_path / "c.png", img)
    back = cv2.imread(str(tmp_path / "c.png"), cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(png.read_png(tmp_path / "c.png"), img)


def test_png_refuses_16_bit_and_interlaced(tmp_path):
    """16-bit and interlaced files, which the reader once refused, read as
    cv2.imread reads them (the high byte of each sample); a bad filter
    type still raises."""
    path = tmp_path / "d.png"
    img16 = (RNG.random((8, 8, 3)) * 65535).astype(np.uint16)
    cv2.imwrite(str(path), img16)
    want = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(png.read_png(path), want)
    np.testing.assert_array_equal(imread.read_rgb(path), want)
    data = bytearray(png.encode_png(_img(8, 8)))
    data[28] = 1                      # IHDR interlace byte (CRC not checked)
    with pytest.raises(ValueError, match="PNG"):
        png.decode_png(bytes(data))   # the rows are not Adam7's passes
    data = bytearray(png.encode_png(_img(8, 8)))
    body = zlib.decompress(bytes(data[41:-16]))
    bad = bytes([7]) + body[1:]
    idat = struct.pack(">I", len(zlib.compress(bad))) + b"IDAT" + \
        zlib.compress(bad)
    with pytest.raises(ValueError, match="filter type"):
        png.decode_png(bytes(data[:33]) + idat + b"\0" * 4
                       + bytes(data[-12:]))


@pytest.mark.parametrize("n_in,n_out", [
    (640, 512), (480, 384), (640, 96), (480, 72), (640, 299),   # TUM
    (752, 512), (480, 327),                                     # EuRoC
    (739, 512), (458, 317),                                     # ETH3D
    (1200, 512), (680, 290),                                    # Replica
    (500, 512), (333, 341), (400, 512)])                        # enlarging
def test_resize_weights_match_cv2(n_in, n_out):
    """One axis's resize against cv2.resize of one-hot rows: shrinking,
    INTER_AREA through the compiled pass and its plain version, bit for
    bit; enlarging, the INTER_LANCZOS4 (out, in) weight matrix (cv2 rounds
    its weights to f32)."""
    eye = np.eye(n_in, dtype=np.float32)
    if n_out < n_in:
        want = cv2.resize(eye, (n_out, n_in), interpolation=cv2.INTER_AREA)
        for fn in (image_host.resize_area, TI.resize_area_ref):
            np.testing.assert_array_equal(fn(eye, (n_in, n_out)), want)
        return
    want = cv2.resize(eye, (n_out, n_in),
                      interpolation=cv2.INTER_LANCZOS4).T
    np.testing.assert_allclose(TI.resize_weights(n_in, n_out), want,
                               rtol=0, atol=3e-7)


@pytest.mark.parametrize("n_in,n_out", [(480, 384), (640, 512), (752, 512),
                                        (500, 512), (96, 96)])
def test_resize_weights_are_built_once(n_in, n_out, monkeypatch):
    """A size pair's resize table is built on the first call and then
    returned from the cache: the same read-only arrays, equal to a fresh
    build (LANCZOS4's weight matrix when enlarging, INTER_AREA's tap table
    when shrinking; the same size builds none); ``resize_img`` gives the
    same bits cold, warm and with the weights built afresh on every
    call."""
    img = RNG.random((n_in, n_in * 4 // 3, 3)).astype(np.float32)
    if n_out == n_in:
        def refused(*a, **k):
            raise AssertionError("the copy built a table")

        monkeypatch.setattr(TI, "resize_weights", refused)
        monkeypatch.setattr(TI, "area_table", refused)
        cold, warm = TI.resize_img(img, n_out), TI.resize_img(img, n_out)
        for k in cold:
            assert np.array_equal(cold[k], warm[k])
        return
    cached = TI.resize_weights if n_out > n_in else TI.area_table
    cached.cache_clear()
    built = cached(n_in, n_out)
    assert cached(n_in, n_out) is built
    assert cached.cache_info().hits >= 1
    fresh = cached.__wrapped__(n_in, n_out)
    if n_out > n_in:
        built, fresh = (built,), (fresh,)
        np.testing.assert_array_equal(built[0],
                                      TI.lanczos4_weights(n_in, n_out))
    else:
        with pytest.raises(ValueError, match="shrinks"):
            TI.resize_weights(n_in, n_out)
    for got, want in zip(built, fresh, strict=True):
        np.testing.assert_array_equal(got, want)
        assert not got.flags.writeable
        with pytest.raises(ValueError, match="read-only"):
            got[0] = 1
    cached.cache_clear()
    cold = TI.resize_img(img, n_out)
    warm = TI.resize_img(img, n_out)
    monkeypatch.setattr(TI, "resize_weights", TI.resize_weights.__wrapped__)
    afresh = TI.resize_img(img, n_out)
    for k in cold:
        assert np.array_equal(cold[k], warm[k])
        assert np.array_equal(cold[k], afresh[k])


@pytest.mark.parametrize("n_in,n_out", [
    (24, 384), (32, 512), (4, 64), (6, 96), (3, 48), (5, 80),  # quality grids
    (2, 32), (7, 100), (30, 17), (12, 384)])
@pytest.mark.parametrize("kind", ["linear", "nearest"])
def test_quality_resize_matches_cv2(n_in, n_out, kind):
    """The quality PLY's upsampling: INTER_LINEAR and INTER_NEAREST weight
    matrices against cv2.resize of one-hot rows, and a whole grid resized
    by the export's float32 weights against cv2.resize of it, within
    1e-6."""
    from mast3r_slam_tpu_torch.evaluation import upsample_quality_grid

    interp = cv2.INTER_LINEAR if kind == "linear" else cv2.INTER_NEAREST
    fn = TI.linear_weights if kind == "linear" else TI.nearest_weights
    eye = np.eye(n_in, dtype=np.float32)
    want = cv2.resize(eye, (n_out, n_in), interpolation=interp).T
    np.testing.assert_allclose(fn(n_in, n_out), want, rtol=0, atol=1e-6)
    grid = np.random.default_rng(n_in).random((n_in, n_in)).astype(
        np.float32)
    want = cv2.resize(grid, (n_out, n_out), interpolation=interp)
    got = upsample_quality_grid(grid, n_out, n_out,
                                nearest=kind == "nearest")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw,size", [
    ((480, 640), 512), ((480, 640), 96), ((480, 640), 224),
    ((333, 500), 512), ((400, 400), 512), ((480, 752), 512),
    ((458, 739), 512), ((680, 1200), 512), ((384, 512), 512),
    ((768, 1024), 512)])
def test_resize_img_matches_jax(hw, size):
    """Same crop, true_shape and transformation. Where the JAX package
    shrinks (INTER_AREA) or copies, ``img`` and the uint8 display image are
    its bits exactly (the port computes cv2's arithmetic); where it enlarges
    (INTER_LANCZOS4: 333x500 and 400x400 at 512), img within 1e-5 and the
    display image within one level (both truncate, and a value on an
    integer may land either side)."""
    img = RNG.random((*hw, 3)).astype(np.float32)
    got, gt = TI.resize_img(img, size, return_transformation=True)
    want, wt = JI.resize_img(img, size, return_transformation=True)
    np.testing.assert_array_equal(got["true_shape"], want["true_shape"])
    assert got["img"].shape == want["img"].shape
    assert got["img"].dtype == np.float32
    assert gt == pytest.approx(wt)
    if not TI.resize_plan(*hw, size)[2]:
        np.testing.assert_allclose(got["img"], want["img"], rtol=0,
                                   atol=1e-5)
        diff = np.abs(got["unnormalized_img"].astype(int)
                      - want["unnormalized_img"].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        return
    np.testing.assert_array_equal(got["img"].view(np.uint32),
                                  want["img"].view(np.uint32))
    np.testing.assert_array_equal(got["unnormalized_img"],
                                  want["unnormalized_img"])


# ---------------------------------------------------------------------------
# Datasets: the fixtures of tests/test_datasets.py
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_config():
    """The JAX readers read the process-global config; set what the port's
    readers are handed, and restore it after."""
    saved = dict(JCfg.config)
    JCfg.config.clear()
    JCfg.config.update({"dataset": {"img_size": 512}, "use_calib": False})
    yield {"dataset": {"img_size": 512}, "use_calib": False}
    JCfg.config.clear()
    JCfg.config.update(saved)


@pytest.fixture
def tum_dir(tmp_path):
    d = tmp_path / "rgbd_dataset_freiburg3_desk"
    (d / "rgb").mkdir(parents=True)
    rows = []
    for i in range(4):
        cv2.imwrite(str(d / "rgb" / f"{i}.png"), _img(480, 640))
        rows.append(f"{100.0 + i / 30:.6f} rgb/{i}.png")
    (d / "rgb.txt").write_text("# header\n# header2\n" + "\n".join(rows)
                               + "\n")
    return d


def _same_dataset(dt, dj, atol=0.0):
    assert type(dt).__name__ == type(dj).__name__
    assert len(dt) == len(dj)
    np.testing.assert_array_equal(np.asarray(dt.timestamps),
                                  np.asarray(dj.timestamps))
    for i in range(len(dj)):
        (tt, it), (tj, ij) = dt[i], dj[i]
        assert tt == tj and it.dtype == np.float32 and it.shape == ij.shape
        np.testing.assert_allclose(it, ij, rtol=0, atol=atol)
    assert dt.get_img_shape() == dj.get_img_shape()


def test_tum_matches_jax(tum_dir, jax_config):
    dt = TD.load_dataset(str(tum_dir), jax_config)
    dj = JD.load_dataset(str(tum_dir))
    _same_dataset(dt, dj)
    np.testing.assert_array_equal(dt.camera_intrinsics.K_orig,
                                  dj.camera_intrinsics.K_orig)
    np.testing.assert_allclose(dt.camera_intrinsics.K_frame,
                               dj.camera_intrinsics.K_frame, rtol=1e-6)


@pytest.mark.parametrize("cfg_calib", [False, True])
def test_calibrated_tum_k_frame(tum_dir, jax_config, cfg_calib):
    """freiburg3 has no distortion: use_calib turns calibration on, and
    K_frame is the JAX one at img_size 512 and 96."""
    for size in (512, 96):
        cfg = {"dataset": {"img_size": size}, "use_calib": cfg_calib}
        JCfg.config.clear()
        JCfg.config.update(cfg)
        dt = TD.load_dataset(str(tum_dir), cfg)
        dj = JD.load_dataset(str(tum_dir))
        assert dt.has_calib() == dj.has_calib() == cfg_calib
        np.testing.assert_allclose(dt.camera_intrinsics.K_frame,
                                   dj.camera_intrinsics.K_frame, rtol=1e-6)
        _same_dataset(dt, dj)


def test_distortion_raises_when_used(tmp_path, jax_config):
    """freiburg1 has distortion. It used to raise when used; now reading
    without use_calib gives the raw frames, and using the calibration
    (K_frame, remap) gives the JAX reader's undistorted frames within
    ``REMAP_TOL`` and its K_frame."""
    d = tmp_path / "rgbd_dataset_freiburg1_xyz"
    (d / "rgb").mkdir(parents=True)
    cv2.imwrite(str(d / "rgb" / "0.png"), _img(480, 640))
    (d / "rgb.txt").write_text("0.0 rgb/0.png\n")
    ds = TD.load_dataset(str(d), jax_config)
    dj = JD.load_dataset(str(d))
    assert ds.camera_intrinsics.has_distortion and not ds.has_calib()
    assert ds[0][1].shape == (480, 640, 3)
    _same_dataset(ds, dj)
    np.testing.assert_allclose(ds.camera_intrinsics.K_frame,
                               dj.camera_intrinsics.K_frame, rtol=1e-6)
    ds.use_calibration = dj.use_calibration = True
    _same_dataset(ds, dj, atol=REMAP_TOL)
    assert not np.array_equal(ds[0][1], ds.read_img(0) / np.float32(255))


def test_euroc_layout_and_gray(tmp_path, jax_config):
    """EuRoC: gray PNGs, nanosecond stems, sensor.yaml; always undistorts,
    frame for frame as the JAX reader (within ``REMAP_TOL``)."""
    d = tmp_path / "euroc_MH01"
    cam = d / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(cam / "data" / f"{int(1e18) + i * int(5e7)}.png"),
                    _img(48, 64, 1))
    (cam / "sensor.yaml").write_text(yaml.safe_dump({
        "intrinsics": [458.6, 457.3, 367.2, 248.4],
        "distortion_coefficients": [-0.28, 0.07, 2e-5, 1.8e-5],
        "resolution": [64, 48],
    }))
    dt = TD.load_dataset(str(d), jax_config)
    dj = JD.load_dataset(str(d))
    assert isinstance(dt, TD.EurocDataset) and dt.use_calibration
    np.testing.assert_array_equal(dt.timestamps, dj.timestamps)
    gray = dt.read_img(1)
    np.testing.assert_array_equal(gray, dj.read_img(1))
    _same_dataset(dt, dj, atol=REMAP_TOL)
    np.testing.assert_allclose(dt.camera_intrinsics.K_frame,
                               dj.camera_intrinsics.K_frame, rtol=1e-6)


def test_seven_scenes_rgbfiles_eth3d_replica(tmp_path, jax_config):
    d = tmp_path / "7scenes_chess"
    (d / "seq-01").mkdir(parents=True)
    for i in range(3):
        cv2.imwrite(str(d / "seq-01" / f"frame-{i:06d}.color.png"), _img())
    _same_dataset(TD.load_dataset(str(d), jax_config),
                  JD.load_dataset(str(d)))

    f = tmp_path / "frames"
    f.mkdir()
    for i in (10, 2, 1):
        cv2.imwrite(str(f / f"img{i}.png"), _img())
    dt = TD.load_dataset(str(f), jax_config)
    _same_dataset(dt, JD.load_dataset(str(f)))
    assert [p.name for p in dt.files] == ["img1.png", "img2.png",
                                          "img10.png"]

    e = tmp_path / "eth3d_table"
    (e / "rgb").mkdir(parents=True)
    for i in range(2):
        cv2.imwrite(str(e / "rgb" / f"{i}.png"), _img(45, 67))
    (e / "rgb.txt").write_text("1.0 rgb/0.png\n2.0 rgb/1.png\n")
    (e / "calibration.txt").write_text("50 51 33 22\n")
    dt, dj = TD.load_dataset(str(e), jax_config), JD.load_dataset(str(e))
    _same_dataset(dt, dj)
    np.testing.assert_allclose(dt.camera_intrinsics.K_frame,
                               dj.camera_intrinsics.K_frame, rtol=1e-6)

    r = tmp_path / "replica_room0"
    (r / "results").mkdir(parents=True)
    for i in range(2):
        cv2.imwrite(str(r / "results" / f"frame{i:06d}.png"), _img(68, 120))
    (r / "cam_params.json").write_text(
        '{"camera": {"w": 120, "h": 68, "fx": 60, "fy": 60, "cx": 60, '
        '"cy": 34}}')
    dt, dj = TD.load_dataset(str(r), jax_config), JD.load_dataset(str(r))
    _same_dataset(dt, dj)
    np.testing.assert_allclose(dt.camera_intrinsics.K_frame,
                               dj.camera_intrinsics.K_frame, rtol=1e-6)


def test_natsorted_and_unported_readers():
    assert [str(p) for p in TD.natsorted(["f10.png", "f2.png", "f1.png"])] \
        == [str(p) for p in JD.natsorted(["f10.png", "f2.png", "f1.png"])]
    for path in ("webcam", "webcam:1"):
        with pytest.raises(NotImplementedError, match="not ported"):
            TD.load_dataset(path)
    # video files are ported (tests/test_torch_video.py): a path that
    # cannot be opened reads as an unopened cv2.VideoCapture reads
    dt, dj = TD.load_dataset("clip.mp4"), JD.load_dataset("clip.mp4")
    assert isinstance(dt, TD.MP4Dataset) and isinstance(dj, JD.MP4Dataset)
    assert (dt.total_frames, dt.fps) == (dj.total_frames, dj.fps)
    # RealSense is ported: without pyrealsense2 both packages raise
    for path in ("realsense", "rs"):
        with pytest.raises(RuntimeError, match="pyrealsense2") as got:
            TD.load_dataset(path)
        with pytest.raises(RuntimeError) as want:
            JD.load_dataset(path)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unrecognized"):
        TD.load_dataset("/nonexistent/path")


class _FakeRealsense:
    """A stand-in ``pyrealsense2`` module: a 640x480 RGB stream of seeded
    frames with millisecond timestamps and Brown-Conrady intrinsics, the
    same sequence for every pipeline it starts."""

    W, H = 640, 480
    COEFFS = (0.12, -0.25, 0.001, -0.0007, 0.08)

    class stream:
        color = "color"

    class format:
        rgb8 = "rgb8"

    def __init__(self):
        self.started = []

    def config(self):
        fake = self

        class Config:
            def enable_stream(self, *args):
                fake.started.append(args)

        return Config()

    def pipeline(self):
        fake = self

        class Intrinsics:
            width, height = fake.W, fake.H
            fx, fy, ppx, ppy = 612.5, 611.25, 321.75, 238.5
            coeffs = list(fake.COEFFS)

        class Profile:
            def get_stream(self, kind):
                assert kind == fake.stream.color
                return self

            def as_video_stream_profile(self):
                return self

            def get_intrinsics(self):
                return Intrinsics()

        class Frame:
            def __init__(self, i):
                self.i = i

            def get_color_frame(self):
                return self

            def get_timestamp(self):
                return 1.7e12 + 33.4 * self.i + 0.25 * (self.i % 3)

            def get_data(self):
                rng = np.random.default_rng(self.i)
                return rng.integers(0, 256, (fake.H, fake.W, 3),
                                    dtype=np.uint8)

        class Pipeline:
            def __init__(self):
                self.n = 0

            def start(self, cfg):
                return Profile()

            def wait_for_frames(self):
                self.n += 1
                return Frame(self.n - 1)

        return Pipeline()


def test_realsense_matches_jax(monkeypatch, jax_config):
    """One fake pyrealsense2 drives the JAX RealsenseDataset and the
    port's: the stream settings, K_undist from the stream's intrinsics
    and distortion, timestamps from the first frame, and each frame
    undistorted (within REMAP_TOL of cv2.remap)."""
    import sys

    fake = _FakeRealsense()
    monkeypatch.setitem(sys.modules, "pyrealsense2", fake)
    dt = TD.load_dataset("realsense", jax_config)
    dj = JD.load_dataset("rs")
    assert isinstance(dt, TD.RealsenseDataset)
    assert type(dj).__name__ == "RealsenseDataset"
    assert fake.started == [("color", 640, 480, "rgb8", 30)] * 2
    assert len(dt) == len(dj) and dt.has_calib() and dj.has_calib()
    assert dt.save_results is False and dj.save_results is False
    np.testing.assert_allclose(dt.camera_intrinsics.K_undist,
                               dj.camera_intrinsics.K_undist, rtol=1e-6)
    np.testing.assert_allclose(dt.camera_intrinsics.K_frame,
                               dj.camera_intrinsics.K_frame, rtol=1e-6)
    for i in range(3):
        (tt, it), (tj, ij) = dt[i], dj[i]
        assert tt == tj and it.dtype == np.float32 and it.shape == ij.shape
        np.testing.assert_allclose(it, ij, rtol=0, atol=REMAP_TOL)
    assert dt.timestamps == dj.timestamps and dt.timestamps[0] == 0.0
    # without the module both raise the same error
    monkeypatch.setitem(sys.modules, "pyrealsense2", None)
    with pytest.raises(RuntimeError) as got:
        TD.RealsenseDataset(jax_config)
    with pytest.raises(RuntimeError) as want:
        JD.RealsenseDataset()
    assert str(got.value) == str(want.value)
    assert isinstance(got.value.__cause__, ImportError)
