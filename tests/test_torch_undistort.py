"""The port's undistortion (``mast3r_slam_tpu_torch/data/undistort.py``
and ``data/datasets.py::Intrinsics``) against OpenCV and the JAX package's
``Intrinsics``, which calls ``cv2.getOptimalNewCameraMatrix``,
``initUndistortRectifyMap`` and ``remap``.

Tolerances: ``K_undist`` and ``K_frame`` within 1e-6 relative; the maps
at most 1 float32 ulp from OpenCV's (they agree bit for bit); remapped
frames within 3e-7 of ``cv2.remap`` (they agree bit for bit, see the
module docstring of ``undistort.py``).

The new camera matrix follows OpenCV 5.0's ``getOptimalNewCameraMatrix``
(``f = (W-1) / width``): older OpenCV releases give a K 0.5-0.9 px away on
EuRoC cam0, so the JAX package's K depends on its cv2, and these tests
hold the port against the cv2 installed beside them (5.0.0 when the
fixtures were recorded, ``tests/data/jpeg/fixtures.json``).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

cv2 = pytest.importorskip("cv2")

from mast3r_slam_tpu.data import datasets as JD  # noqa: E402
from mast3r_slam_tpu.utils import config as JCfg  # noqa: E402
from mast3r_slam_tpu_torch.data import datasets as TD  # noqa: E402
from mast3r_slam_tpu_torch.data import png  # noqa: E402
from mast3r_slam_tpu_torch.data import undistort as U  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = json.loads(
    (REPO / "tests" / "data" / "jpeg" / "fixtures.json").read_text())
CAMERAS = {name: tuple(c["calib"]) for name, c in FIXTURES["cameras"].items()}
_cfg = yaml.safe_load((REPO / "config" / "intrinsics.yaml").read_text())
CAMERAS["intrinsics_yaml"] = (
    _cfg["width"], _cfg["height"], _cfg["fx"], _cfg["fy"], _cfg["cx"],
    _cfg["cy"], _cfg["k1"], _cfg["k2"], _cfg["p1"], _cfg["p2"], _cfg["k3"])
REMAP_TOL = 3e-7


@pytest.fixture
def jax_config():
    saved = dict(JCfg.config)
    JCfg.config.clear()
    yield JCfg.config
    JCfg.config.clear()
    JCfg.config.update(saved)


def _both_intrinsics(jcfg, cam, img_size=512, center=True):
    cfg = {"dataset": {"img_size": img_size,
                       "center_principle_point": center}}
    jcfg.clear()
    jcfg.update(cfg)
    W, H, fx, fy, cx, cy, *dist = cam
    return (TD.Intrinsics(W, H, fx, fy, cx, cy, dist, cfg=cfg),
            JD.Intrinsics(W, H, fx, fy, cx, cy, dist))


def _ulps(a, b):
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-2**31) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2**31) - ib, ib)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("name", sorted(CAMERAS))
@pytest.mark.parametrize("img_size,center", [(512, True), (96, True),
                                             (512, False)])
def test_k_undist_and_k_frame_match_jax(jax_config, name, img_size, center):
    """EuRoC cam0, TUM freiburg1 / freiburg2 and config/intrinsics.yaml
    (--calib's example): K_undist and K_frame as the JAX Intrinsics builds
    them, with and without dataset.center_principle_point."""
    t, j = _both_intrinsics(jax_config, CAMERAS[name], img_size, center)
    assert t.has_distortion and j.mapx is not None
    assert t.K_undist.dtype == np.float32
    np.testing.assert_allclose(t.K_undist, j.K_undist, rtol=1e-6)
    np.testing.assert_allclose(t.K_frame, j.K_frame, rtol=1e-6)
    if center:
        assert (t.K_undist[0, 2], t.K_undist[1, 2]) == (t.W / 2, t.H / 2)


@pytest.mark.parametrize("name", sorted(FIXTURES["cameras"]))
def test_k_undist_matches_the_recorded_cv2_numbers(name):
    """The numbers chip_smoke.py's data phase checks on the card machine."""
    W, H, fx, fy, cx, cy, *dist = CAMERAS[name]
    t = TD.Intrinsics(W, H, fx, fy, cx, cy, dist, cfg={})
    np.testing.assert_allclose(
        t.K_undist, np.asarray(FIXTURES["cameras"][name]["K_undist"],
                               np.float32), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CAMERAS))
@pytest.mark.parametrize("center", [True, False])
def test_maps_match_cv2(name, center):
    """initUndistortRectifyMap (CV_32FC1) from the same float32 K, dist and
    new K: at most one float32 ulp apart (they are equal)."""
    W, H, fx, fy, cx, cy, *dist = CAMERAS[name]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    d = np.asarray(dist, np.float32)
    new_K = U.optimal_new_camera_matrix(K, d, (W, H))
    want_K, _ = cv2.getOptimalNewCameraMatrix(K, d, (W, H), 0, (W, H))
    np.testing.assert_allclose(new_K, want_K, rtol=1e-9, atol=1e-9)
    if center:
        new_K[0, 2], new_K[1, 2] = W / 2, H / 2
    new_K = new_K.astype(np.float32)
    mx, my = U.undistort_rectify_map(K, d, new_K, (W, H))
    wx, wy = cv2.initUndistortRectifyMap(K, d, None, new_K, (W, H),
                                         cv2.CV_32FC1)
    assert mx.dtype == np.float32 and mx.shape == (H, W)
    assert _ulps(mx, wx) <= 1 and _ulps(my, wy) <= 1


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(k1=st.floats(-0.4, 0.4), k2=st.floats(-1, 1),
       p1=st.floats(-0.01, 0.01), p2=st.floats(-0.01, 0.01),
       k3=st.floats(-1.2, 1.2))
def test_sweep_matches_cv2_and_jax(k1, k2, p1, p2, k3):
    """Distortions across |k1| <= 0.4, |k2| <= 1, |p| <= 0.01, |k3| <=
    1.2 on a 64x48 camera: K_undist and K_frame within 1e-6 of the JAX
    Intrinsics, the maps within one ulp of OpenCV's."""
    saved = dict(JCfg.config)
    cfg = {"dataset": {"img_size": 64}}
    JCfg.config.clear()
    JCfg.config.update(cfg)
    try:
        cam = (64, 48, 52.0, 51.5, 31.7, 24.2, k1, k2, p1, p2, k3)
        t = TD.Intrinsics(*cam[:6], cam[6:], cfg=cfg)
        j = JD.Intrinsics(*cam[:6], cam[6:])
    finally:
        JCfg.config.clear()
        JCfg.config.update(saved)
    # coefficients that round to 0 in float32 leave no distortion
    assert t.has_distortion == j.has_distortion == (j.mapx is not None)
    if not t.has_distortion:
        np.testing.assert_array_equal(t.K_frame, j.K_frame)
        return
    scale = np.abs(j.K_undist).max()
    np.testing.assert_allclose(t.K_undist, j.K_undist, rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(t.K_frame, j.K_frame, rtol=1e-6,
                               atol=1e-6 * scale)
    mx, my = U.undistort_rectify_map(t.K_orig, t.distortion, t.K_undist,
                                     (64, 48))
    assert _ulps(mx, j.mapx) <= 1 and _ulps(my, j.mapy) <= 1


@pytest.mark.parametrize("channels", [0, 1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_remap_matches_cv2_with_borders(channels, seed):
    """Maps reaching 3 px outside the image on every side, corner and
    integer coordinates included: cv2.remap(INTER_LINEAR) with zero
    borders within 3e-7 (bit for bit)."""
    rng = np.random.default_rng(seed)
    H, W = 41, 57
    shape = (H, W) if channels == 0 else (H, W, channels)
    img = rng.random(shape).astype(np.float32)
    mx = rng.uniform(-3, W + 2, (H, W)).astype(np.float32)
    my = rng.uniform(-3, H + 2, (H, W)).astype(np.float32)
    mx[0, :8] = [-1, -0.5, 0, W - 1, W - 0.5, W, 0.25, 3]
    my[0, :8] = [0, 0, 0, 0, H - 1, H - 0.5, -0.75, H]
    got = U.remap_bilinear(img, U.RemapTables(mx, my, (H, W)))
    want = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0,
                               atol=REMAP_TOL)
    assert np.array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("reach", [3.0, 60.0, 1e4, 1e6])
@pytest.mark.parametrize("channels", [0, 1, 3])
def test_compiled_remap_matches_cv2_past_every_border(channels, reach):
    """The compiled remap against cv2.remap(INTER_LINEAR) bit for bit on
    random maps reaching ``reach`` pixels past every border: negative
    coordinates, coordinates far past the image, integer ones."""
    rng = np.random.default_rng(int(reach) + channels)
    H, W = 45, 67
    img = rng.random((H, W) if channels == 0 else (H, W, channels)
                     ).astype(np.float32)
    mx = rng.uniform(-reach, W - 1 + reach, (H, W)).astype(np.float32)
    my = rng.uniform(-reach, H - 1 + reach, (H, W)).astype(np.float32)
    mx[1, :6] = [-reach, -1, 0, W - 1, W, W - 1 + reach]
    my[1, :6] = [0, H - 1, -reach, H - 1 + reach, -1, H]
    got = U.remap_bilinear(img, U.RemapTables(mx, my, (H, W)))
    want = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
    assert got.dtype == np.float32 and got.shape == img.shape
    assert np.array_equal(got.reshape(want.shape), want)


def _fma64_exact(t, x, y):
    """Where the float64 ``t * x + y`` of float32 operands is exact (its
    two-sum error is 0): there the plain remap's fma emulation rounds
    once, as a fused multiply-add does."""
    p = t.astype(np.float64) * x        # exact: 24 + 24 bits
    s = p + y
    bp = s - y
    err = (p - bp) + (y - (s - bp))
    return err == 0


@pytest.mark.parametrize("channels", [0, 1, 2, 3, 4])
def test_compiled_remap_equals_plain_version_without_ties(channels):
    """The compiled remap against ``remap_bilinear_ref`` bit for bit
    wherever the reference's three float64 sums are exact (there it
    cannot meet a float32 tie), on random maps past the borders and on
    EuRoC cam0's undistortion maps (every sample)."""
    rng = np.random.default_rng(channels)
    H, W = 48, 64
    shape = (H, W) if channels == 0 else (H, W, channels)
    img = (rng.random(shape) * rng.choice([1e-3, 1.0, 300.0], shape)
           ).astype(np.float32)
    mx = rng.uniform(-2, W + 1, (H, W)).astype(np.float32)
    my = rng.uniform(-2, H + 1, (H, W)).astype(np.float32)
    tables = U.RemapTables(mx, my, (H, W))
    got = U.remap_bilinear(img, tables)
    ref = U.remap_bilinear_ref(img, tables)
    C = 1 if channels == 0 else channels
    pix = np.concatenate([img.reshape(-1, C), np.zeros((1, C), np.float32)])
    a, b, c, d = (pix[k] for k in tables.corners)
    tx, ty = tables.tx[:, None], tables.ty[:, None]
    v0 = (tx.astype(np.float64) * (b - a) + a).astype(np.float32)
    v1 = (tx.astype(np.float64) * (d - c) + c).astype(np.float32)
    exact = (_fma64_exact(tx, b - a, a) & _fma64_exact(tx, d - c, c)
             & _fma64_exact(ty, v1 - v0, v0)).reshape(got.shape)
    assert exact.mean() > 0.5
    np.testing.assert_array_equal(got[exact], ref[exact])
    W0, H0, fx, fy, cx, cy, *dist = CAMERAS["euroc_cam0"]
    intr = TD.Intrinsics(W0, H0, fx, fy, cx, cy, dist, cfg={})
    frame = rng.random((H0, W0) if channels == 0 else (H0, W0, channels)
                       ).astype(np.float32)
    np.testing.assert_array_equal(U.remap_bilinear(frame, intr.tables),
                                  U.remap_bilinear_ref(frame, intr.tables))


def test_compiled_remap_matches_cv2_where_the_plain_version_ties():
    """A sample whose exact ``fma(tx, b - a, a)`` lies just above a
    float32 tie, within half a float64 ulp of it: the plain version's
    float64 sum rounds onto the tie and then to even, one float32 ulp
    low; the compiled remap's float fma gives cv2's value."""
    s = 47
    # tx = q 2^-s and b - a = j 2^-23 with q j 2^-(23+s) = 2^-24 + delta,
    # 0 < delta < 2^-53
    j, q = next((j, -(-2**(s - 1) // j)) for j in range(2**22 + 1, 2**23)
                if 0 < -(-2**(s - 1) // j) * j - 2**(s - 1) < 2**(s - 30))
    H, W = 3, 40
    img = np.zeros((H, W), np.float32)
    img[:, 0], img[:, 1] = 1.0, 1.0 + j * 2.0**-23
    mx = np.full((H, W), q * 2.0**-s, np.float32)
    my = np.zeros((H, W), np.float32)
    tables = U.RemapTables(mx, my, (H, W))
    want = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
    got = U.remap_bilinear(img, tables)
    assert np.array_equal(got, want)
    assert (want == np.float32(1.0 + 2.0**-23)).all()
    assert (U.remap_bilinear_ref(img, tables) == np.float32(1.0)).all()


def test_readers_never_reach_the_plain_remap(monkeypatch):
    """``Intrinsics.remap`` runs the compiled remap only; without the
    library (its build failing) it raises and does not fall back."""
    from mast3r_slam_tpu_torch import _build
    from mast3r_slam_tpu_torch.data import image_host

    def refused(*a, **k):
        raise AssertionError("the plain remap was called")

    monkeypatch.setattr(U, "remap_bilinear_ref", refused)
    monkeypatch.setattr(U, "_fma32", refused)
    W, H, fx, fy, cx, cy, *dist = CAMERAS["euroc_cam0"]
    intr = TD.Intrinsics(W, H, fx, fy, cx, cy, dist, cfg={})
    img = np.random.default_rng(4).random((H, W, 3)).astype(np.float32)
    assert np.isfinite(intr.remap(img)).all()

    def no_compiler(*a, **k):
        raise RuntimeError("building the image host library failed: no g++")

    monkeypatch.setattr(image_host, "_lib", None)
    monkeypatch.setattr(_build, "build_host", no_compiler)
    with pytest.raises(RuntimeError, match="image host library"):
        intr.remap(img)


@pytest.mark.parametrize("name", sorted(FIXTURES["cameras"]))
def test_intrinsics_remap_matches_jax(jax_config, name):
    """A whole frame through each package's Intrinsics.remap."""
    t, j = _both_intrinsics(jax_config, CAMERAS[name])
    img = np.random.default_rng(3).random((t.H, t.W, 3)).astype(np.float32)
    np.testing.assert_allclose(t.remap(img), j.remap(img), rtol=0,
                               atol=REMAP_TOL)


# ---------------------------------------------------------------------------
# Whole readers
# ---------------------------------------------------------------------------

def _img(rng, h, w, c=3):
    shape = (h, w) if c == 1 else (h, w, c)
    return (rng.random(shape) * 255).astype(np.uint8)


def _same(dt, dj, atol=REMAP_TOL):
    assert type(dt).__name__ == type(dj).__name__ and len(dt) == len(dj)
    assert dt.has_calib() == dj.has_calib()
    np.testing.assert_array_equal(np.asarray(dt.timestamps),
                                  np.asarray(dj.timestamps))
    for i in range(len(dj)):
        (tt, it), (tj, ij) = dt[i], dj[i]
        assert tt == tj and it.dtype == np.float32 and it.shape == ij.shape
        np.testing.assert_allclose(it, ij, rtol=0, atol=atol)
    assert dt.get_img_shape() == dj.get_img_shape()
    np.testing.assert_allclose(dt.camera_intrinsics.K_frame,
                               dj.camera_intrinsics.K_frame, rtol=1e-6)


def test_euroc_reader_matches_jax(tmp_path, jax_config):
    """EuRoC MH cam0's layout and calibration at its 752x480: every frame
    undistorted as the JAX reader undistorts it."""
    jax_config.update({"dataset": {"img_size": 512}})
    rng = np.random.default_rng(11)
    d = tmp_path / "MH_01_easy"
    cam = d / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    for i in range(2):
        png.write_png(cam / "data" / f"{1403636579763555584 + i * 50_000_000}"
                      ".png", _img(rng, 480, 752, 1))
    W, H, fx, fy, cx, cy, k1, k2, p1, p2, _ = CAMERAS["euroc_cam0"]
    (cam / "sensor.yaml").write_text(yaml.safe_dump({
        "intrinsics": [fx, fy, cx, cy],
        "distortion_coefficients": [k1, k2, p1, p2],
        "resolution": [W, H]}))
    dt = TD.load_dataset(str(d), {"dataset": {"img_size": 512}})
    dj = JD.load_dataset(str(d))
    assert isinstance(dt, TD.EurocDataset) and dt.has_calib()
    _same(dt, dj)


@pytest.mark.parametrize("seq", ["freiburg1_xyz", "freiburg2_desk"])
def test_tum_use_calib_reader_matches_jax(tmp_path, jax_config, seq):
    """TUM freiburg1 / freiburg2 under use_calib (scripts/eval_tum.sh with
    config/eval_calib.yaml): undistorted frames and K_frame."""
    cfg = {"dataset": {"img_size": 512}, "use_calib": True}
    jax_config.update(cfg)
    rng = np.random.default_rng(12)
    d = tmp_path / f"rgbd_dataset_{seq}"
    (d / "rgb").mkdir(parents=True)
    for i in range(2):
        png.write_png(d / "rgb" / f"{i}.png", _img(rng, 480, 640))
    (d / "rgb.txt").write_text("0.0 rgb/0.png\n0.5 rgb/1.png\n")
    dt, dj = TD.load_dataset(str(d), cfg), JD.load_dataset(str(d))
    assert dt.has_calib() and dt.camera_intrinsics.has_distortion
    _same(dt, dj)


def test_calib_file_matches_jax(tmp_path, jax_config):
    """main.py's --calib with config/intrinsics.yaml on a plain folder of
    frames: set_calibration, then every frame undistorted."""
    cfg = {"dataset": {"img_size": 512}, "use_calib": True}
    jax_config.update(cfg)
    rng = np.random.default_rng(13)
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(2):
        png.write_png(d / f"img{i}.png", _img(rng, 480, 640))
    dt, dj = TD.load_dataset(str(d), cfg), JD.load_dataset(str(d))
    W, H, fx, fy, cx, cy, *dist = CAMERAS["intrinsics_yaml"]
    dt.set_calibration(TD.Intrinsics(W, H, fx, fy, cx, cy, dist, cfg=cfg))
    dj.set_calibration(JD.Intrinsics(W, H, fx, fy, cx, cy, dist))
    _same(dt, dj)
