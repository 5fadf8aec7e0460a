"""Port parity of the HEVC reader: ``native/hevc_decode.cpp`` behind
``data/video.py`` against ``cv2.VideoCapture`` (OpenCV's FFmpeg backend,
whose hevc decoder is the reference), with tolerance 0 (``FRAME_TOL``).

The committed HEVC fixtures of ``tests/data/video`` (``make_fixtures.py
hevc``; ``tests/test_torch_video.py`` reads every fixture in order against
cv2 and against the JAX package's ``MP4Dataset``) are read here backwards
and shuffled to the digests of cv2's frames; their containers (MP4 / MOV
``hvc1`` and ``hev1`` with ``hvcC``, Matroska ``V_MPEGH/ISO/HEVC``, AVI
``HEVC``) and NAL length sizes; fresh writer streams with IRAP pictures
mid-stream (CRA and IDR) and output delay (sps_max_num_reorder_pics) are
read in order, backwards and shuffled against cv2's seeks; and the port's
``MP4Dataset`` is held against the JAX one on an HEVC fixture (length,
timestamps, strides, frames) and on a file cut short. The writer's tool
groups, the plain numpy arithmetic against the compiled entries and the
refusals are in ``tests/test_torch_hevc_tools.py``."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import torch_hevc_writer as W  # noqa: E402
from mast3r_slam_tpu.data import datasets as JD  # noqa: E402
from mast3r_slam_tpu.utils import config as JCfg  # noqa: E402
from mast3r_slam_tpu_torch.data import containers, video  # noqa: E402
from mast3r_slam_tpu_torch.data import datasets as TD  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "data" / "video"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
HEVC = sorted(n for n, d in DIGESTS.items() if d["fourcc"] in ("hvc1", "hev1"))
FRAME_TOL = 0  # max |port - cv2| in LSB of the RGB frames (measured: 0)


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _cv2_reads(path, order):
    """cv2's frames for the reads ``order``, as the JAX reader makes them
    (a seek where a read is not the next frame); None where cv2 fails."""
    cap = cv2.VideoCapture(str(path))
    nxt, out = 0, []
    for i in order:
        if i != nxt:
            cap.set(cv2.CAP_PROP_POS_FRAMES, i)
        ok, bgr = cap.read()
        nxt = i + 1
        out.append(bgr[..., ::-1] if ok else None)
    return out


def _assert_reads(path, order):
    want = _cv2_reads(path, order)
    r = video.VideoReader(path)
    for i, w in zip(order, want):
        assert w is not None, (path.name, i)
        got = r.read(i)
        d = np.abs(got.astype(np.int16) - w.astype(np.int16))
        assert d.max() <= FRAME_TOL, (path.name, i, int(d.max()))


@pytest.fixture
def jax_config():
    saved = dict(JCfg.config)
    JCfg.config.clear()
    JCfg.config.update({"dataset": {"img_size": 512}, "use_calib": False})
    yield {"dataset": {"img_size": 512}, "use_calib": False}
    JCfg.config.clear()
    JCfg.config.update(saved)


def test_fixtures_cover_the_slice():
    """The writer's random syntax in hvc1 and hev1 MP4, MOV and Matroska
    (a 640x480 clip of it with the loop filters in every slice), the 1080p
    clip (coded 1088), the CLI's 640x480 clip and a 640x480 one of
    low-delay B pictures are committed,
    every frame at 0 LSB from cv2's when they were written."""
    assert len(HEVC) == 9
    assert {n.rsplit(".", 1)[1] for n in HEVC} == {"mp4", "mkv", "mov"}
    assert {DIGESTS[n]["fourcc"] for n in HEVC} == {"hvc1", "hev1"}
    assert DIGESTS["hevc_1920x1080.mp4"]["hw"] == [1080, 1920]
    assert DIGESTS["cli_640x480_hevc.mp4"]["frame_count"] == 16
    assert DIGESTS["hevc_sao_640x480.mp4"]["hw"] == [480, 640]
    assert all(f["max_abs"] == 0 for n in HEVC for f in DIGESTS[n]["frames"])


def test_fixtures_carry_their_tools():
    """Each random fixture's parameter sets hold the tools its name
    promises (rebuilt from make_fixtures' table)."""
    import sys
    sys.path.insert(0, str(FIXTURES))
    import make_fixtures as MF
    got = {}
    for name, (group, seed, n, opts, _) in MF.HEVC_RANDOM.items():
        opts = {k: v for k, v in opts.items()
                if k not in ("cuts", "gop", "reorder", "irap", "filters")}
        p = W._group_params(np.random.default_rng(seed), group)
        for k, v in opts.items():
            setattr(p, k, v)
        got[name] = p
    m = got["hevc_main.mp4"]
    assert m.ctb_log2 == 6 and m.wpp and m.sao and m.amp and m.tmvp and m.sign_hiding
    assert m.transform_skip and m.scaling == "sps" and m.constrained_intra
    t = got["hevc_tiles.mkv"]
    assert t.tiles and not t.lf_across_tiles and not t.lf_across_slices and t.dependent_slices
    lt = got["hevc_ltr.mov"]
    assert lt.ctb_log2 == 4 and lt.long_term and lt.lists_mod and lt.pcm and lt.bypass
    assert lt.weighted_pred and lt.st_sets and lt.slice_ext and lt.output_flag_present
    assert got["hevc_ldb.mkv"].vui == {"full_range": 1, "matrix": 1}
    s = got["hevc_sao_640x480.mp4"]
    assert s.ctb_log2 == 6 and s.sao and s.deblock and not s.deblock[1]
    assert MF.HEVC_RANDOM["hevc_sao_640x480.mp4"][3]["filters"]


@pytest.mark.parametrize("name", HEVC)
def test_fixture_reads_backwards_and_shuffled(name):
    """Every frame read backwards, then in a shuffled order, gives cv2's
    frame (the SHA-256 recorded beside the fixture)."""
    rec = DIGESTS[name]
    r = video.VideoReader(FIXTURES / name)
    n = rec["frame_count"]
    order = list(range(n - 1, -1, -1)) + \
        [int(i) for i in np.random.default_rng(len(name)).permutation(n)]
    if n > 8:
        order = order[:8] + order[n:n + 8]
    for i in order:
        img = r.read(i)
        assert list(img.shape[:2]) == rec["hw"]
        assert _sha(img) == rec["frames"][i]["cv2"], (name, i)


def test_containers_hand_over_hvcc():
    """MP4 and MOV give the hvcC record as extradata (4-byte NAL lengths),
    Matroska its CodecPrivate under V_MPEGH/ISO/HEVC; the hev1 clip's sync
    samples are IRAP pictures, the CRA mid-stream among them."""
    for name in ("hevc_main.mp4", "hevc_ltr.mov", "hevc_tiles.mkv"):
        t = containers.open_track(FIXTURES / name)
        assert t.fourcc == "hvc1" and t.extradata[:1] == b"\x01"
        assert (t.extradata[21] & 3) + 1 == 4
        assert t.extradata[22] == 3  # VPS, SPS, PPS arrays
    r = video.VideoReader(FIXTURES / "hevc_hev1.mp4")
    keys = np.flatnonzero(r.track.sync)
    assert list(keys) == [0, 4, 8]
    assert all(r._is_idr(int(k)) for k in keys) and not r._is_idr(1)


@pytest.mark.parametrize("entry,length_size,mux", [
    (b"hvc1", 2, "mp4"), (b"hev1", 2, "mp4"), (b"hev1", 4, "mp4"), (None, 0, "avi")])
def test_nal_length_sizes_hev1_and_annexb(tmp_path, entry, length_size, mux):
    """hvcC's 2-byte NAL lengths, hev1 samples that carry the parameter
    sets, and AVI's Annex B samples under the HEVC fourcc."""
    clip = W.random_stream(77, "inter", frames=3)
    path = tmp_path / f"lengths.{mux}"
    if mux == "mp4":
        W.write_mp4(path, clip, entry=entry, length_size=length_size)
    else:
        W.write_avi(path, clip)
    r = video.VideoReader(path)
    assert r.track.fourcc == (entry.decode() if entry else "HEVC") and len(r) == 3
    _assert_reads(path, [0, 1, 2])


@pytest.mark.parametrize("mux", ["mp4", "hev1", "mkv", "avi"])
@pytest.mark.parametrize("kind", ["gop", "delay"])
def test_seeks_match_cv2(tmp_path, mux, kind):
    """Streams with IRAP pictures mid-stream (CRA and IDR, each a sync
    sample) or with output delay (sps_max_num_reorder_pics 1-2, pictures
    still in decode order): read in order, backwards and shuffled as the
    JAX reader reads, every frame is cv2's."""
    seed = {"mp4": 3, "hev1": 5, "mkv": 6, "avi": 7}[mux]
    opts = dict(gop=4, reorder=0) if kind == "gop" else dict(gop=None, reorder=1 + seed % 2)
    clip = W.random_stream(seed, "inter", frames=10, **opts)
    path = tmp_path / f"seek.{'mp4' if mux == 'hev1' else mux}"
    if mux == "hev1":
        W.write_mp4(path, clip, entry=b"hev1")
    else:
        W.MUX[mux](path, clip)
    n = 10
    rng = np.random.default_rng(seed)
    for order in (list(range(n)), list(range(n))[::-1], [int(i) for i in rng.permutation(n)]):
        _assert_reads(path, order)


@pytest.mark.parametrize("k", [1, 3])
def test_dataset_matches_jax(k, jax_config):
    """The port's MP4Dataset and the JAX one on an HEVC fixture: length,
    timestamps, strides and frames (read_img through resize)."""
    JCfg.config["dataset"]["subsample"] = k
    cfg = {**jax_config, "dataset": {**jax_config["dataset"], "subsample": k}}
    path = str(FIXTURES / "hevc_hev1.mp4")
    dt, dj = TD.load_dataset(path, cfg), JD.load_dataset(path)
    assert isinstance(dt, TD.MP4Dataset) and dt.stride == dj.stride == k
    assert len(dt) == len(dj)
    np.testing.assert_array_equal(np.asarray(dt.timestamps), np.asarray(dj.timestamps))
    for i in range(len(dj)):
        (tt, it), (tj, ij) = dt[i], dj[i]
        assert tt == tj
        np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt.read_img(len(dj) - 1), dj.read_img(len(dj) - 1))


def test_truncated_clip_raises_the_jax_message(tmp_path, jax_config):
    """An MP4 of HEVC cut inside picture 6's data: both readers report 8
    frames, read 5 alike, and raise the same message for 6 and 7."""
    src = FIXTURES / "hevc_main.mp4"
    t = containers.open_track(src)
    path = tmp_path / "cut.mp4"
    path.write_bytes(src.read_bytes()[:int(t.offsets[6] + t.sizes[6] // 2)])
    dt, dj = TD.load_dataset(str(path), jax_config), JD.load_dataset(str(path))
    assert len(dt) == len(dj) == 8
    np.testing.assert_array_equal(dt[5][1], dj[5][1])
    for i in (6, 7):
        with pytest.raises(ValueError) as want:
            dj[i]
        with pytest.raises(ValueError) as got:
            dt[i]
        assert str(got.value) == str(want.value) == f"failed to decode frame {i} of {path}"
