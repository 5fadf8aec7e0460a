"""Port parity of the H.264 reader on B pictures: ``native/h264_decode.cpp``
behind ``data/video.py`` against ``cv2.VideoCapture`` (OpenCV's FFmpeg
backend), with tolerance 0 (``FRAME_TOL``).

The test writer (``tests/torch_h264_writer.py``) writes random legal B
syntax from a seed (every B mb_type and sub_mb_type, B_Skip and B_Direct,
spatial and temporal direct with and without direct_8x8_inference, list 1
and its modifications, weighted_bipred_idc 0 / 1 / 2, reference B pictures,
SPSs with and without bitstream_restriction) in MP4 (``ctts`` with and
without ``elst``), Matroska and AVI; cv2 decodes each as the reference, in
order and in the access patterns of the JAX reader (seeks backwards,
shuffled, strides). Also: the reorder buffer's delay and FFmpeg's dropping
of pictures that arrive out of order; open GOPs; an MMCO 5 picture's POC;
the port's ``MP4Dataset`` against the JAX one on the CLI's B clip; the
compiled bi-prediction, implicit weights and temporal scaling against their
plain numpy versions, bit for bit. The committed B fixtures are read
backwards and shuffled to their digests in ``tests/test_torch_h264.py``."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import torch_h264_writer as W  # noqa: E402
from mast3r_slam_tpu.data import datasets as JD  # noqa: E402
from mast3r_slam_tpu.utils import config as JCfg  # noqa: E402
from mast3r_slam_tpu_torch.data import containers, video  # noqa: E402
from mast3r_slam_tpu_torch.data import datasets as TD  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "data" / "video"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
B_FIXTURES = ("h264_b_cabac.mp4", "h264_b_noelst.mp4", "h264_b_cavlc.mkv",
              "h264_b_cavlc.avi", "h264_b_1920x1080.mp4",
              "cli_640x480_h264_b.mp4")
FRAME_TOL = 0  # max |port - cv2| in LSB of the RGB frames (measured: 0)
CONTAINERS = {
    "mp4": lambda p, c: W.write_mp4(p, c),
    "mp4-noelst": lambda p, c: W.write_mp4(p, c, elst=False),
    "mp4-ctts1": lambda p, c: W.write_mp4(p, c, ctts_version=1),
    "mkv": W.write_mkv,
    "avi": W.write_avi,
}


def _write(tmp_path, clip, container):
    path = tmp_path / ("clip." + container.split("-")[0])
    CONTAINERS[container](path, clip)
    return path


def _cv2_reads(path, order):
    """cv2's frames for the reads `order`, as the JAX reader makes them (a
    seek where a read is not the next frame); None where cv2 fails."""
    cap = cv2.VideoCapture(str(path))
    nxt, out = 0, []
    for i in order:
        if i != nxt:
            cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, bgr = cap.read()
        nxt = i + 1
        out.append(bgr[..., ::-1] if ok else None)
    return out


def _port_reads(path, order):
    r = video.VideoReader(path)
    out = []
    for i in order:
        try:
            out.append(r.read(i))
        except ValueError:
            out.append(None)
    return out


def _assert_reads(path, order):
    want, got = _cv2_reads(path, order), _port_reads(path, order)
    for i, w, g in zip(order, want, got):
        assert (w is None) == (g is None), (path.name, i, w is None)
        if w is not None:
            d = np.abs(g.astype(np.int16) - w.astype(np.int16))
            assert d.max() <= FRAME_TOL, (path.name, i, int(d.max()))


@pytest.fixture
def jax_config():
    saved = dict(JCfg.config)
    JCfg.config.clear()
    JCfg.config.update({"dataset": {"img_size": 512}, "use_calib": False})
    yield {"dataset": {"img_size": 512}, "use_calib": False}
    JCfg.config.clear()
    JCfg.config.update(saved)


def test_b_fixtures_committed():
    """The B fixtures and their digests: random syntax in MP4 (with and
    without elst), Matroska and AVI, the 1080p IBBP clip and the CLI's."""
    for name in B_FIXTURES:
        assert (FIXTURES / name).exists() and name in DIGESTS, name
        assert all(f["max_abs"] == 0 for f in DIGESTS[name]["frames"]), name
    assert DIGESTS["h264_b_1920x1080.mp4"]["hw"] == [1080, 1920]
    assert DIGESTS["cli_640x480_h264_b.mp4"]["frame_count"] == 16
    assert DIGESTS["cli_640x480_h264_b.mp4"]["hw"] == [480, 640]
    t = containers.open_track(FIXTURES / "cli_640x480_h264_b.mp4")
    assert t.video_delay == 1 and (np.diff(t.pts) < 0).any()


# the option sets the random streams cover (the rest drawn from the seed)
B_OPTS = {
    "spatial-default": dict(bipred=0, spatial=True, direct8x8=True, reorder=2),
    "temporal-explicit": dict(bipred=1, spatial=False, direct8x8=False, reorder=-1),
    "drawn-implicit": dict(bipred=2, direct8x8=False),
}


@pytest.mark.parametrize("container", ["mp4", "mp4-noelst", "mkv", "avi"])
@pytest.mark.parametrize("cabac", [False, True], ids=["cavlc", "cabac"])
@pytest.mark.parametrize("opts", list(B_OPTS), ids=list(B_OPTS))
def test_random_b_syntax_matches_cv2(tmp_path, opts, cabac, container):
    """A fresh stream of random B syntax decodes to cv2's frames, every one
    in order."""
    seed = 100 * list(B_OPTS).index(opts) + 10 * cabac + len(container)
    clip = W.random_stream(seed, cabac=cabac, frames=12, b=True, **B_OPTS[opts])
    path = _write(tmp_path, clip, container)
    n = int(cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT))
    assert n == len(video.VideoReader(path)) == 12
    _assert_reads(path, list(range(n)))


@pytest.mark.parametrize("container", ["mp4", "mp4-ctts1", "mkv", "avi"])
def test_random_b_seeks_match_cv2(tmp_path, container):
    """Three GOPs (an IDR picture every 9): reads backwards, shuffled and
    with strides 2 and 3 give cv2's frames, seek by seek."""
    clip = W.random_stream(7, cabac=True, frames=27, b=True, idr_every=9)
    path = _write(tmp_path, clip, container)
    n = 27
    rng = np.random.default_rng(3)
    order = (list(range(n - 1, -1, -1)) + [int(i) for i in rng.permutation(n)] +
             list(range(0, n, 2)) + list(range(0, n, 3)))
    _assert_reads(path, order)


@pytest.mark.parametrize("container", ["mp4", "mkv", "avi"])
@pytest.mark.parametrize("reorder", [2, -1], ids=["restriction", "no-restriction"])
def test_reorder_buffer_and_drops_match_cv2(tmp_path, reorder, container):
    """Mini-GOPs of one B picture, then pyramids of three: where the SPS
    gives max_num_reorder_frames the delay is 2 from the start; without it
    FFmpeg's probe finds 1 (MP4: its demuxer's ctts estimate, 2), and the
    first pyramid's late B picture is dropped (Matroska and AVI), as cv2
    drops it. In order, and backwards and shuffled, the port reads cv2's
    frames; frame counts as cv2's."""
    clip = W.random_stream(5, cabac=True, frames=25, b=True, reorder=reorder,
                           ks=[1, 1, 1, 1, 1, 1, 3, 3, 3], slices=1)
    path = _write(tmp_path, clip, container)
    n = 25
    want = _cv2_reads(path, list(range(n)))
    dropped = sum(w is None for w in want)
    assert dropped == (1 if reorder < 0 and container != "mp4" else 0)
    rng = np.random.default_rng(4)
    _assert_reads(path, list(range(n)) + list(range(n - 1, -1, -1)) +
                  [int(i) for i in rng.permutation(n)])


@pytest.mark.parametrize("container", ["mp4", "mkv"])
def test_open_gop(tmp_path, container):
    """I pictures that open GOPs (leading B pictures referencing the GOP
    before, a sync sample each): read in order, every frame is cv2's; a seek
    that OpenCV starts at such an I picture (cv2 then puts out other frames)
    raises ValueError naming it; one it starts at the IDR picture reads
    cv2's frame."""
    clip = W.random_stream(7, cabac=True, frames=40, b=True, open_gop=0.4)
    assert any(clip.sync[1:])
    path = _write(tmp_path, clip, container)
    _assert_reads(path, list(range(40)))
    r = video.VideoReader(path)
    r.read(0)
    with pytest.raises(ValueError, match="H.264 with a seek into an open GOP"):
        r.read(38)
    _assert_reads(path, [0, 10, 5, 16])


def test_mmco5_picture_keeps_its_poc(tmp_path):
    """After MMCO 5 the standard gives the picture POC 0; FFmpeg keeps its
    own, so a B picture after it orders its lists by that. The port reads
    cv2's frames (with the reset, the B picture's lists differ)."""
    p = W.Params(width=128, height=96, cabac=True, max_refs=3, vui=dict(reorder=1))
    sw = W.StreamWriter(p)
    chooser = W.RandomChooser(np.random.default_rng(1), p, pcm=False)
    total = p.mbw * p.mbh

    def spec(t, n0=1, n1=0):
        return [W.SliceSpec(0, total, type=t, num_ref=n0, num_ref1=n1)]
    sw.picture(spec(2), chooser, idr=True, poc=0, display=0)
    sw.picture(spec(0), chooser, poc=4, display=1)
    sw.picture(spec(0), chooser, poc=8, display=2, mmco=[(5, 0, 0)])
    sw.picture(spec(0), chooser, poc=4, display=4)
    sw.picture(spec(1, 2, 2), chooser, poc=2, display=3, ref_idc=0)
    sw.picture(spec(0), chooser, poc=6, display=5)
    path = tmp_path / "mmco5.mp4"
    W.write_mp4(path, sw.clip())
    _assert_reads(path, list(range(6)) + [5, 3, 1])


@pytest.mark.parametrize("k", [1, 2, 3])
def test_cli_b_clip_matches_jax(k, jax_config):
    """The CLI's IBBP clip through both MP4Datasets at subsample k: len,
    timestamps and frames equal."""
    JCfg.config["dataset"]["subsample"] = k
    cfg = {**jax_config, "dataset": {**jax_config["dataset"], "subsample": k}}
    path = str(FIXTURES / "cli_640x480_h264_b.mp4")
    dt, dj = TD.load_dataset(path, cfg), JD.load_dataset(path)
    assert isinstance(dt, TD.MP4Dataset) and dt.stride == dj.stride == k
    assert len(dt) == len(dj)
    np.testing.assert_array_equal(np.asarray(dt.timestamps), np.asarray(dj.timestamps))
    for i in range(len(dj)):
        (tt, it), (tj, ij) = dt[i], dj[i]
        assert tt == tj
        np.testing.assert_array_equal(it, ij)


def test_mp4_timestamps(tmp_path):
    """ctts (version 0 under an elst edit, without one, version 1 negative)
    gives each sample's presentation time in display order, and FFmpeg's
    reorder-depth estimate; Matroska its block timecodes; AVI none."""
    clip = W.random_stream(3, cabac=True, frames=12, b=True, reorder=2)
    rank = np.argsort(np.argsort(clip.display))
    for name, kw in (("a.mp4", {}), ("b.mp4", dict(elst=False)),
                     ("c.mp4", dict(ctts_version=1))):
        path = tmp_path / name
        W.write_mp4(path, clip, **kw)
        t = containers.open_track(path)
        assert (np.argsort(np.argsort(t.pts)) == rank).all(), name
        assert t.video_delay == max(i - d for i, d in enumerate(rank)) == 2
        if kw.get("elst", True) and not kw:
            assert t.pts.min() == 0
    t = containers.open_track(FIXTURES / "h264_b_cavlc.mkv")
    assert t.pts is not None and t.time_base * 1000 == 1
    assert containers.open_track(FIXTURES / "h264_b_cavlc.avi").pts is None


@pytest.mark.parametrize("name", ["h264_cavlc.mp4", "h264_cavlc.mkv", "h264_cavlc.avi",
                                  "h264_cabac.mp4", "h264_cabac.mkv", "h264_cabac.avi"])
def test_writer_keeps_ip_streams(tmp_path, name):
    """The writer still writes the random I/P fixtures byte for byte."""
    sys.path.insert(0, str(FIXTURES))
    import make_fixtures
    path = tmp_path / name
    make_fixtures.write_h264(path, name)
    assert path.read_bytes() == (FIXTURES / name).read_bytes()


def test_bipred_equals_plain():
    """Default, explicit (every denominator, weights across int8, offsets)
    and implicit (weights -64..128, so 128 too) bi-prediction: the compiled
    routine equals h264_bipred_ref, as FFmpeg's x86 routine and as its C
    one."""
    rng = np.random.default_rng(11)
    for trial in range(600):
        a = rng.integers(0, 256, 16).astype(np.uint8)
        b = rng.integers(0, 256, 16).astype(np.uint8)
        if trial % 3 == 0:
            kw = {}
        elif trial % 3 == 1:
            kw = dict(w0=int(rng.integers(-128, 128)), w1=int(rng.integers(-128, 128)),
                      logwd=int(rng.integers(0, 8)), offset=int(rng.integers(-256, 255)))
        else:
            w = int(rng.integers(-64, 129))
            kw = dict(w0=w, w1=64 - w)
        if trial % 7 == 0 and kw:  # sums that overflow 16 bits
            kw.update(w0=int(rng.integers(100, 128)), w1=int(rng.integers(100, 128)),
                      logwd=7)
        for x86 in (True, False):
            np.testing.assert_array_equal(video.h264_bipred(a, b, x86=x86, **kw),
                                          video.h264_bipred_ref(a, b, x86=x86, **kw))
    # the x86 routine departs from the standard where a weighted sum
    # overflows 16 bits: 200 * 127 * 2 at denominator 7
    a = np.full(4, 200, np.uint8)
    assert video.h264_bipred_ref(a, a, 127, 127, logwd=7)[0] == 127
    assert video.h264_bipred_ref(a, a, 127, 127, logwd=7, x86=False)[0] == 198


def test_implicit_weights_equal_plain():
    """Implicit weights over random POCs and long-term marks."""
    rng = np.random.default_rng(12)
    for _ in range(200):
        cur = int(rng.integers(-200, 200))
        p0 = [int(v) for v in rng.integers(-200, 200, 4)]
        p1 = [int(v) for v in rng.integers(-200, 200, 3)]
        l0 = [bool(v) for v in rng.random(4) < 0.2]
        l1 = [bool(v) for v in rng.random(3) < 0.2]
        np.testing.assert_array_equal(video.h264_implicit_weights(cur, p0, p1, l0, l1),
                                      video.h264_implicit_weights_ref(cur, p0, p1, l0, l1))


def test_temporal_scale_equals_plain():
    """DistScaleFactor and the scaled vectors, tb and td past int8, long-term
    and equal POCs."""
    rng = np.random.default_rng(13)
    for _ in range(2000):
        cur, p0, p1 = (int(v) for v in rng.integers(-300, 300, 3))
        lt = bool(rng.random() < 0.2)
        mv = [int(v) for v in rng.integers(-4000, 4000, 2)]
        assert video.h264_temporal_scale(cur, p0, p1, lt, mv) == \
            video.h264_temporal_scale_ref(cur, p0, p1, lt, mv)
    assert video.h264_temporal_scale_ref(6, 0, 8, False, (-7, 15)) == (192, (-5, 11), (2, -4))


def test_x86_biweight_overflow_matches_cv2(tmp_path):
    """Explicit weights 127 and 127 at denominator 7 on bi-predicted
    macroblocks: sums past 16 bits, where FFmpeg's x86 routine saturates
    (and the standard's formula does not); the port reads cv2's frames."""
    p = W.Params(width=64, height=48, cabac=True, max_refs=2, bipred=1,
                 vui=dict(reorder=1))
    sw = W.StreamWriter(p)
    rng = np.random.default_rng(2)
    base = W.RandomChooser(rng, p, pcm=False)

    def chooser(pw):
        if pw.stype != 1:
            return base(pw)
        return {"kind": "B", "mbt": 3, "refs": ([0], [0]),
                "mvs": ([base._mv(pw)], [base._mv(pw)]), "cbp": 0, "dqp": 0,
                "t8": False}
    total = p.mbw * p.mbh
    sw.picture([W.SliceSpec(0, total, type=2, qp=20)], chooser, idr=True, poc=0, display=0)
    sw.picture([W.SliceSpec(0, total, type=0, num_ref=1, qp=20)], chooser, poc=4, display=2)
    sw.picture([W.SliceSpec(0, total, type=1, num_ref=1, num_ref1=1, qp=20,
                            weights=(7, 0, [(127, 0)], [None], [(127, 0)], [None]))],
               chooser, poc=2, display=1, ref_idc=0)
    path = tmp_path / "overflow.mp4"
    W.write_mp4(path, sw.clip())
    _assert_reads(path, [0, 1, 2])
    frame = video.VideoReader(path).read(1)
    assert (frame < 200).any()  # not saturated to white: the lanes clipped first
