"""The port's INTER_AREA resize (``data/image_host.py::resize_area``, C++,
and its plain numpy version ``data/image_ops.py::resize_area_ref``)
against ``cv2.resize`` bit for bit: the main path's scales, the integer
scales OpenCV takes ``resizeAreaFast_`` for, odd sizes, one channel and
three, the same-size copy, crop windows, cold and warm calls, the
committed digests of ``tests/data/resize/fixtures.json``, and
``create_frame`` against the JAX package's on the CPU."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from mast3r_slam_tpu.data import image_ops as JI  # noqa: E402
from mast3r_slam_tpu_torch import _build  # noqa: E402
from mast3r_slam_tpu_torch.data import image_host  # noqa: E402
from mast3r_slam_tpu_torch.data import image_ops as TI  # noqa: E402
from mast3r_slam_tpu_torch.slam import pipeline  # noqa: E402
from torch_resize_inputs import CASES, seeded_image  # noqa: E402

FIXTURES = json.loads((Path(__file__).resolve().parent / "data" / "resize"
                       / "fixtures.json").read_text())["resizes"]
RESIZES = [image_host.resize_area, TI.resize_area_ref]
SIZES = [((480, 640), (384, 512)), ((480, 752), (327, 512)),
         ((680, 1200), (290, 512)), ((458, 739), (317, 512)),
         ((480, 640), (72, 96)), ((480, 640), (224, 299)),
         ((768, 1024), (384, 512)), ((90, 99), (30, 33)),
         ((60, 80), (15, 40)), ((37, 53), (19, 31)), ((38, 46), (19, 23)),
         ((38, 62), (19, 31)), ((513, 10), (512, 10)),
         ((384, 512), (384, 512)), ((19, 23), (19, 23))]


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32 if a.dtype == np.float32
                                        else a.dtype)


def _img(hw, c, seed):
    rng = np.random.default_rng(seed)
    # past [0, 1] on both sides: the model and display images clip there
    shape = hw if c == 1 else (*hw, c)
    return (rng.random(shape) * 1.2 - 0.1).astype(np.float32)


@pytest.mark.parametrize("fn", RESIZES, ids=["compiled", "plain"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("hw_in,hw_out", SIZES)
def test_resize_area_matches_cv2(hw_in, hw_out, c, fn):
    """Bit for bit with cv2.resize(INTER_AREA), whichever of its three
    paths the sizes take (the copy, the table, resizeAreaFast_)."""
    img = _img(hw_in, c, seed=hw_in[0] + hw_out[1] + c)
    want = cv2.resize(img, hw_out[::-1], interpolation=cv2.INTER_AREA)
    got = fn(img, hw_out)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("fn", RESIZES, ids=["compiled", "plain"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("hw_in,hw_out,window", [
    ((480, 640), (384, 512), (0, 384, 0, 512)),
    ((480, 752), (327, 512), (3, 323, 0, 512)),          # EuRoC's crop
    ((680, 1200), (290, 512), (1, 289, 0, 512)),         # Replica's
    ((480, 640), (224, 299), (0, 224, 37, 261)),         # 224 square
    ((768, 1024), (384, 512), (5, 301, 3, 499)),
    ((38, 46), (19, 23), (1, 18, 5, 22)),                # past the vector loop
    ((384, 512), (384, 512), (64, 320, 128, 384)),
    ((37, 53), (19, 31), (7, 7, 2, 30))])                # no rows
def test_resize_area_window(hw_in, hw_out, window, c, fn):
    """Only a crop window's rows and columns: the full resize then cropped,
    and the model and display images of the same pass as resize_img makes
    them from that crop (into a given array, too)."""
    img = _img(hw_in, c, seed=sum(window))
    full = cv2.resize(img, hw_out[::-1], interpolation=cv2.INTER_AREA)
    y0, y1, x0, x1 = window
    crop = full[y0:y1, x0:x1]
    np.testing.assert_array_equal(_bits(fn(img, hw_out, window)),
                                  _bits(crop))
    model, display = fn(img, hw_out, window, frame=True)
    np.testing.assert_array_equal(_bits(model), _bits(crop * 2.0 - 1.0))
    np.testing.assert_array_equal(
        display, np.clip(crop * 255.0, 0, 255).astype(np.uint8))
    into = np.full(crop.shape, np.nan, np.float32)
    model2, display2 = fn(img, hw_out, window, frame=True, model_out=into)
    assert model2 is into
    np.testing.assert_array_equal(_bits(into), _bits(model))
    np.testing.assert_array_equal(display2, display)


@pytest.mark.parametrize("name", sorted(CASES))
def test_resize_area_matches_committed_digests(name):
    """The SHA-256 of cv2.resize's output on each seeded input, recorded by
    tests/data/resize/make_fixtures.py: the check chip_smoke.py makes on
    the card machine, where there is no cv2."""
    rec = FIXTURES[name]
    img = seeded_image(tuple(rec["input"]), rec["seed"])
    assert hashlib.sha256(img.tobytes()).hexdigest() == rec["input_sha256"]
    for fn in RESIZES:
        got = fn(img, rec["out_hw"])
        assert list(got.shape) == rec["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == rec["sha256"]


@pytest.mark.parametrize("hw_in,hw_out", [((480, 640), (384, 512)),
                                          ((768, 1024), (384, 512)),
                                          ((384, 512), (384, 512))])
def test_resize_area_cold_and_warm(hw_in, hw_out, monkeypatch):
    """The first call (the library loaded afresh, the plain version's table
    built afresh) and later calls give the same bits, on one thread and on
    several."""
    img = _img(hw_in, 3, seed=7)
    monkeypatch.setattr(image_host, "_lib", None)
    TI.area_table.cache_clear()
    cold = [fn(img, hw_out) for fn in RESIZES]
    warm = [fn(img, hw_out) for fn in RESIZES]
    monkeypatch.setattr(image_host, "RESIZE_THREADS", 1)
    one = image_host.resize_area(img, hw_out)
    for got in cold[1:] + warm + [one]:
        np.testing.assert_array_equal(_bits(got), _bits(cold[0]))


@pytest.mark.filterwarnings("ignore:This process .* is multi-threaded")
def test_resize_area_from_threads_and_a_forked_child(monkeypatch):
    """The compiled resize's worker pool: calls from several threads at
    once, and a call in a forked child (which has no workers), give the
    same bits as one call on one thread."""
    import multiprocessing
    import threading

    img = _img((480, 640), 3, seed=11)
    monkeypatch.setattr(image_host, "RESIZE_THREADS", 1)
    want = image_host.resize_area(img, (384, 512))
    monkeypatch.setattr(image_host, "RESIZE_THREADS", 4)
    got = [None] * 6

    def one(i):
        got[i] = image_host.resize_area(img, (384, 512))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g in got:
        np.testing.assert_array_equal(_bits(g), _bits(want))
    ctx = multiprocessing.get_context("fork")
    with ctx.Pool(1) as pool:
        child = pool.apply(image_host.resize_area, (img, (384, 512)))
    np.testing.assert_array_equal(_bits(child), _bits(want))


def test_area_table_is_cv2s():
    """The table's taps as cv2 weighs one-hot rows, float32 bit for bit; a
    table is built once and read-only."""
    for n_in, n_out in ((640, 512), (480, 384), (752, 512), (1200, 512),
                        (739, 512), (640, 299), (99, 33)):
        eye = np.eye(n_in, dtype=np.float32)
        want = cv2.resize(eye, (n_out, n_in), interpolation=cv2.INTER_AREA).T
        ofs, si, alpha = TI.area_table(n_in, n_out)
        dense = np.zeros((n_out, n_in), np.float32)
        dense[np.repeat(np.arange(n_out), np.diff(ofs)), si] = alpha
        np.testing.assert_array_equal(dense, want)
        assert TI.area_table(n_in, n_out)[0] is ofs
        assert not alpha.flags.writeable and len(ofs) == n_out + 1
    assert TI.area_fast_scale((768, 1024), (384, 512)) == (2, 2)
    assert TI.area_fast_scale((90, 99), (30, 33)) == (3, 3)
    assert TI.area_fast_scale((480, 640), (384, 512)) is None


def test_resize_area_refuses_what_cv2_would_not_take_here():
    img = _img((20, 30), 3, seed=1)
    for fn in RESIZES:
        for bad in (dict(img=img, out_hw=(21, 30)),
                    dict(img=img, out_hw=(10, 15), window=(0, 11, 0, 15)),
                    dict(img=img.astype(np.float64), out_hw=(10, 15)),
                    dict(img=np.zeros((20, 30, 2), np.float32),
                         out_hw=(10, 15))):
            with pytest.raises(ValueError, match="resize_area"):
                fn(**bad)
    with pytest.raises(ValueError, match="model_out"):
        image_host.resize_area(img, (10, 15), frame=True,
                               model_out=np.zeros((10, 14, 3), np.float32))


def test_failed_build_raises(monkeypatch):
    """Without a compiler the resize raises; nothing falls back to the plain
    version or to the dense weights."""
    def no_compiler(*a, **k):
        raise RuntimeError("building the image host library failed: no g++")

    def refused(*a, **k):
        raise AssertionError("a fallback ran")

    monkeypatch.setattr(image_host, "_lib", None)
    monkeypatch.setattr(_build, "build_host", no_compiler)
    monkeypatch.setattr(TI, "resize_area_ref", refused)
    monkeypatch.setattr(TI, "resize_weights", refused)
    img = _img((480, 640), 3, seed=2)
    with pytest.raises(RuntimeError, match="image host library"):
        TI.resize_img(img, 512)
    with pytest.raises(RuntimeError, match="image host library"):
        pipeline.create_frame(0, img, img_size=512, device="cpu")


@pytest.mark.parametrize("hw,size", [
    ((480, 640), 512), ((480, 752), 512), ((680, 1200), 512),
    ((458, 739), 512), ((480, 640), 96), ((480, 640), 224),
    ((384, 512), 512), ((768, 1024), 512)])
def test_create_frame_matches_jax(hw, size):
    """``create_frame`` on the CPU against the JAX package's: the model
    image, the display image, the shapes, exactly."""
    from mast3r_slam_tpu.slam import pipeline as JP

    img = np.random.default_rng(hw[1] + size).random((*hw, 3)).astype(
        np.float32)
    got = pipeline.create_frame(3, img, img_size=size, device="cpu")
    want = JP.create_frame(3, img, img_size=size)
    assert got.img.dtype == torch.float32 and got.img.device.type == "cpu"
    np.testing.assert_array_equal(_bits(got.img.numpy()),
                                  _bits(np.asarray(want.img)))
    np.testing.assert_array_equal(_bits(got.uimg), _bits(want.uimg))
    assert got.img_shape == tuple(want.img_shape)
    assert got.img_true_shape == tuple(want.img_true_shape)
    res = TI.resize_img(img, size)
    np.testing.assert_array_equal(res["unnormalized_img"],
                                  JI.resize_img(img, size)["unnormalized_img"])
