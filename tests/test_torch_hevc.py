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
timestamps, strides, frames) and on a file cut short. The small streams
of pictures the decoder puts out of decode order, of a RADL picture and of
a picture sent with pic_output_flag 0 (``torch_hevc_writer.READ``), HM's
and x265's GOPs with pictures sent with pic_output_flag 0 and with an end
of sequence before a CRA picture, are read against cv2 in every order;
the JAX ``MP4Dataset`` and the port's read the hierarchical-B CLI clip
alike at subsample 1 and 2, and fail alike on a file that starts at a CRA
picture (its RASL pictures skipped). The writer's tool groups, the plain
numpy arithmetic against the compiled entries and the refusals are in
``tests/test_torch_hevc_tools.py``; the GOP structures' seeks in every
container in ``tests/test_torch_hevc_gop.py``."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import torch_hevc_writer as W  # noqa: E402
from mast3r_slam_tpu.data import datasets as JD  # noqa: E402
from test_torch_hevc_gop import assert_reads, orders, write  # noqa: E402
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
    (a 640x480 clip of it with the loop filters in every slice; x265's,
    HM's and the BLA structures out of decode order), the 1080p clip
    (coded 1088), the CLI's 640x480 clips (P pictures; hierarchical B
    pictures with a CRA picture) and a 640x480 one of low-delay B pictures
    are committed, every frame at 0 LSB from cv2's when they were written;
    HM's last picture is not put out, and cv2 reads one frame fewer."""
    assert len(HEVC) == 13
    assert {n.rsplit(".", 1)[1] for n in HEVC} == {"mp4", "mkv", "mov"}
    assert {DIGESTS[n]["fourcc"] for n in HEVC} == {"hvc1", "hev1"}
    assert DIGESTS["hevc_1920x1080.mp4"]["hw"] == [1080, 1920]
    assert DIGESTS["cli_640x480_hevc.mp4"]["frame_count"] == 16
    gop = DIGESTS["cli_640x480_hevc_gop.mp4"]
    assert gop["frame_count"] == 32 and gop["hw"] == [480, 640]
    assert DIGESTS["hevc_sao_640x480.mp4"]["hw"] == [480, 640]
    holes = {n: [i for i, f in enumerate(DIGESTS[n]["frames"]) if f is None] for n in HEVC}
    assert {n: h for n, h in holes.items() if h} == {"hevc_hm.mkv": [27]}
    assert all(f["max_abs"] == 0 for n in HEVC for f in DIGESTS[n]["frames"] if f)


def test_fixtures_carry_their_tools(tmp_path):
    """Each random fixture's parameter sets hold the tools its name
    promises (rebuilt from make_fixtures' table). The GOP fixtures are what
    the table writes (written again, byte for byte), and between them carry
    NAL unit types 6-9 (RADL, RASL) and 16-18 (BLA), POCs out of decode
    order (presentation times out of order), a picture sent with
    pic_output_flag 0, and B slices whose TMVP reads list 1's collocated
    picture."""
    import sys
    sys.path.insert(0, str(FIXTURES))
    import make_fixtures as MF
    got = {}
    for name, (group, seed, n, opts, _) in MF.HEVC_RANDOM.items():
        opts = {k: v for k, v in opts.items()
                if k not in ("cuts", "gop", "reorder", "irap", "filters", "hidden")}
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
    assert got["hevc_x265.mp4"].weighted_pred and got["hevc_x265.mp4"].weighted_bipred
    names = [n for n, e in MF.HEVC_RANDOM.items() if isinstance(e[3].get("gop"), str)]
    assert sorted(names) == ["hevc_bla.mp4", "hevc_hm.mkv", "hevc_x265.mp4"]
    info, nals = [], set()
    for name in names:
        clip = MF.write_hevc(tmp_path / name, name)
        assert (tmp_path / name).read_bytes() == (FIXTURES / name).read_bytes(), name
        info += clip.info
        r = video.VideoReader(FIXTURES / name)
        for k in range(len(r)):
            nals |= set(video._nal_types(r._sample_data(k), r._nal_len, True))
        assert np.any(np.diff(r.track.pts) < 0), name
    assert {6, 7, 8, 9, 16, 17, 18, 19, 21} <= nals
    assert any(not i["output"] for i in info)
    assert any(i["type"] == 0 and i["tmvp"] and not i["col_from_l0"] for i in info)
    assert containers.open_track(FIXTURES / "cli_640x480_hevc_gop.mp4").pts[1] == \
        8 * containers.open_track(FIXTURES / "cli_640x480_hevc_gop.mp4").pts[4]


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
        if rec["frames"][i] is None:  # a frame cv2 does not read
            with pytest.raises(ValueError, match=f"failed to decode frame {i} of "):
                r.read(i)
            continue
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

    def irap(k):
        return any(16 <= t <= 23 for t in video._nal_types(r._sample_data(k), r._nal_len, True))
    assert all(irap(int(k)) for k in keys) and not irap(1)


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


@pytest.mark.parametrize("mux", ["mp4", "hev1", "mkv", "avi"])
@pytest.mark.parametrize("feature", W.READ)
def test_read_streams_match_cv2(tmp_path, feature, mux):
    """The small streams of a picture put out before one that precedes it
    in decode order, of a RADL_R picture and of a picture sent with
    pic_output_flag 0 (which cv2 does not put out: the last read fails)
    read as cv2 reads them, in order, backwards and shuffled."""
    clip = W.refused_clip(feature)
    path = write(tmp_path, clip, mux)
    n = len(clip.pictures)
    missing = [assert_reads(path, o) for o in orders(n, 1)]
    assert missing == [int(feature == "pic_output_flag")] * 3


@pytest.mark.parametrize("kind", ["x265", "hm", "radl", "bla"])
def test_hidden_pictures_match_cv2(tmp_path, kind):
    """A quarter of the pictures sent with pic_output_flag 0 (references
    among them): cv2 numbers frames by presentation time, so a seek counts
    from the first frame it decodes and reads on past the places of the
    pictures not put out; the port reads what cv2 reads, in every order."""
    seed = 580 + ["x265", "hm", "radl", "bla"].index(kind)
    clip = W.random_stream(seed, "inter", frames=32, gop=kind, hidden=0.25)
    assert not all(i["output"] for i in clip.info)
    path = write(tmp_path, clip, "mp4" if kind != "bla" else "mkv")
    for o in orders(32, seed):
        assert_reads(path, o)


@pytest.mark.parametrize("mux", ["mp4", "avi"])
def test_end_of_sequence_before_a_cra(tmp_path, mux):
    """An end of sequence NAL unit before HM's first CRA picture: that CRA
    picture starts a coded video sequence (its RASL pictures skipped, the
    pictures still waiting dropped as FFmpeg drops them: no output of
    prior pictures)."""
    clip = W.random_stream({"mp4": 590, "avi": 591}[mux], "inter", frames=32, gop="hm", eos=True)
    path = write(tmp_path, clip, mux)
    missing = [assert_reads(path, o) for o in orders(32, 2)]
    assert missing[0] > 0


@pytest.mark.parametrize("k", [1, 2])
def test_gop_clip_dataset_matches_jax(k, jax_config):
    """The port's MP4Dataset and the JAX one on the hierarchical-B CLI clip
    (GOPs of 8, a CRA picture with RASL pictures at frame 16, ``ctts``):
    length, timestamps and every frame (read_img through resize); at
    subsample 2 every read is a seek, some across the open GOP."""
    JCfg.config["dataset"]["subsample"] = k
    cfg = {**jax_config, "dataset": {**jax_config["dataset"], "subsample": k}}
    path = str(FIXTURES / "cli_640x480_hevc_gop.mp4")
    dt, dj = TD.load_dataset(path, cfg), JD.load_dataset(path)
    assert isinstance(dt, TD.MP4Dataset) and dt.stride == dj.stride == k
    assert len(dt) == len(dj) == 32 // k
    np.testing.assert_array_equal(np.asarray(dt.timestamps), np.asarray(dj.timestamps))
    for i in range(len(dj)):
        (tt, it), (tj, ij) = dt[i], dj[i]
        assert tt == tj
        np.testing.assert_array_equal(it, ij)


@pytest.mark.parametrize("k", [1, 2])
def test_cra_first_clip_fails_as_jax(tmp_path, k, jax_config):
    """A file that starts at a CRA picture: FFmpeg skips its RASL pictures,
    so there are fewer frames than samples; both datasets read the same
    frames and fail at the same indices with the same message."""
    JCfg.config["dataset"]["subsample"] = k
    cfg = {**jax_config, "dataset": {**jax_config["dataset"], "subsample": k}}
    clip = W.random_stream(600, "inter", frames=24, gop="cra_first")
    path = str(write(tmp_path, clip, "mp4"))
    dt, dj = TD.load_dataset(path, cfg), JD.load_dataset(path)
    assert len(dt) == len(dj) == 24 // k
    failed = []
    for i in range(len(dj)):
        try:
            tj, ij = dj[i]
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                dt[i]
            assert str(got.value) == str(e) == f"failed to decode frame {i * k} of {path}"
            failed.append(i)
            continue
        tt, it = dt[i]
        assert tt == tj
        np.testing.assert_array_equal(it, ij)
    assert failed and failed == list(range(failed[0], len(dj)))
