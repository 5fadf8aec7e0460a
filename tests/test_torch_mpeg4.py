"""Port parity of MPEG-4 Part 2 as Xvid and DivX write it: the C++ decoder
of ``data/video.py`` against ``cv2.VideoCapture`` (OpenCV's FFmpeg backend,
avcodec 62.28) and the JAX package's ``MP4Dataset`` at 0 LSB.

- The encoder's build and what FFmpeg does with it: the committed
  fixtures' user data rewritten (``XviD0064``; none, under the codec tags
  ``XVID`` and ``FMP4``; ``DivX503b1393`` and its packed ``p``), which
  switch FFmpeg to the Xvid IDCT and its FF_BUG_EDGE / FF_BUG_DC_CLIP
  workarounds, or leave it as it is.
- The test writer's streams (``tests/torch_mpeg4_writer.py``), one tool
  group each, in AVI, MP4 and Matroska at 33x26 to 176x144: AC prediction,
  DQUANT, intra DC as a VLC or a TCOEF and the three escapes (I-VOPs);
  1MV, 4MV, intra macroblocks in P-VOPs, skips and vectors over the edges
  at every f_code; MPEG quantisation with loaded matrices (one cut short);
  not-coded VOPs (FFmpeg puts no frame out for them, but for the last);
  B-VOPs in every mode with MODB, CBPB, DBQUANT and both f_codes, over
  1MV and 4MV references (direct's one and four vectors); DivX's packed
  bitstreams in AVI; every build's user data; Matroska's BlockGroups and
  V_MS/VFW/FOURCC. Read in order, backwards, shuffled and as the JAX
  reader seeks, with cv2's frame count.
- The refusals by name, and the plain numpy Xvid IDCT and B-VOP average
  against their compiled entries.
"""

import collections
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import torch_mpeg4_writer as M4  # noqa: E402
from mast3r_slam_tpu.data import datasets as JD  # noqa: E402
from mast3r_slam_tpu.utils import config as JCfg  # noqa: E402
from mast3r_slam_tpu_torch.data import video  # noqa: E402
from mast3r_slam_tpu_torch.data import datasets as TD  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "data" / "video"
RNG = np.random.default_rng(26)


def _cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            return out, int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        out.append(bgr[..., ::-1])


def _same_as_cv2(path, frames=None):
    """Every frame cv2 reads, read in order by the port's reader, equal at
    0 LSB; cv2's frame count and the port's; the frames read."""
    want, count = _cv2_frames(path)
    if frames is not None:
        assert len(want) == frames
    r = video.VideoReader(path)
    assert len(r) == count
    for i, w in enumerate(want):
        got = r.read(i)
        assert got.shape == w.shape, (path.name, i)
        d = int(np.abs(got.astype(np.int16) - w.astype(np.int16)).max())
        assert d == 0, (path.name, i, d)
    if len(want) < count:  # cv2 has no frame for the rest: neither has the port
        with pytest.raises(ValueError, match=f"failed to decode frame {len(want)}"):
            r.read(len(want))
    return r


# --- the encoder's build ----------------------------------------------------------------------

XVID64 = b"XviD0064" + b"\x01" * 5
BLANK = b" " * 13
# file, the 13 bytes written over "Lavc62.28.101", the codec tag patch
# (all: strh and strf; strf: the BITMAPINFOHEADER's alone), what FFmpeg
# makes of it
REWRITES = {
    "xvid64": ("xvid_busy.avi", XVID64, None, dict(xvid_build=64, xvid_idct=True, bugs=set())),
    "blank_xvid": ("xvid_busy.avi", BLANK, None,
                   dict(xvid_build=0, xvid_idct=True, bugs={"EDGE", "DC_CLIP", "QPEL_CHROMA"})),
    "blank_fmp4": ("xvid_busy.avi", BLANK, ("all", b"FMP4"), dict(xvid_build=-1, xvid_idct=False)),
    "blank_strf_fmp4": ("xvid_busy.avi", BLANK, ("strf", b"FMP4"),
                        dict(xvid_build=0, xvid_idct=True)),
    "divx": ("xvid_busy.avi", b"DivX503b1393\x01", None,
             dict(divx_version=503, divx_build=1393, xvid_idct=False, packed=False)),
    "divx_packed": ("xvid_busy.avi", b"DivX503b1393p", None,
                    dict(divx_version=503, xvid_idct=False, packed=True)),
    "lavc": ("xvid_busy.avi", b"Lavc62.28.101", None,
             dict(lavc_build=4070501, xvid_idct=False, bugs=set())),
    "xvid64_mp4": ("mp4v_152x104.mp4", XVID64, None, dict(xvid_build=64, xvid_idct=True)),
    "xvid64_cli": ("cli_640x480.mp4", XVID64, None, dict(xvid_build=64, xvid_idct=True)),
}


@pytest.mark.parametrize("case", list(REWRITES))
def test_rewritten_user_data_matches_cv2(tmp_path, case):
    """The committed fixtures with their encoder's build rewritten: each
    frame as cv2 decodes it (Xvid's IDCT and workarounds where FFmpeg takes
    them: the build says Xvid, or says nothing under an Xvid codec tag,
    which FFmpeg's AVI demuxer takes from the stream header's handler too),
    and the build and flags FFmpeg's tables give."""
    name, user, tag, want = REWRITES[case]
    data = (FIXTURES / name).read_bytes()
    assert b"Lavc62.28.101" in data
    data = data.replace(b"Lavc62.28.101", user)
    if tag == ("all", b"FMP4"):
        data = data.replace(b"XVID", b"FMP4")
    elif tag is not None:
        strf = data.index(b"strf")
        i = data.index(b"XVID", strf)
        data = data[:i] + tag[1] + data[i + 4:]
    path = tmp_path / f"{case}_{name}"
    path.write_bytes(data)
    r = _same_as_cv2(path)
    info = r._dec.mpeg4_info()
    for k, v in want.items():
        assert info[k] == v, (k, info)


# --- the writer's streams ---------------------------------------------------------------------

# group: (containers, size, frames, build); each container's options
STREAMS = {
    "intra": ("avi mp4 mkv", (33, 26), 4, "xvid"),
    "inter": ("avi mp4 mkv", (48, 32), 8, "xvid"),
    "4mv": ("avi mp4 mkv", (66, 50), 8, "xvid"),
    "mpeg": ("avi mp4 mkv", (48, 32), 6, "xvid"),
    "nvop": ("avi mp4 mkv", (48, 32), 8, "xvid"),
    "b": ("avi mp4 mkv", (176, 144), 6, "xvid"),
    "b4mv": ("avi mp4 mkv", (48, 32), 10, "xvid"),
    "packed": ("avi", (48, 32), 10, "xvid"),
}
MUX_OPTS = {"avi": {}, "mp4": {}, "mkv": dict(groups=True)}
CASES = [(g, c, seed) for g, (cs, *_) in STREAMS.items() for c in cs.split() for seed in (0, 1)]
BUILDS = [("divx", "avi", {}), ("divx_packed", "mkv", dict(inband=True)),
          ("lavc", "mkv", dict(vfw=b"XVID")), ("ffmpeg", "avi", {}),
          ("none", "avi", {}), ("none", "mkv", {}), ("xvid0", "mp4", {})]


def _stream(group, seed=0, **kw):
    _, (w, h), frames, build = STREAMS[group]
    return M4.random_stream(seed, group, **{"width": w, "height": h, "frames": frames,
                                            "build": build, **kw})


@pytest.mark.parametrize("group,container,seed", CASES)
def test_writer_streams_match_cv2(tmp_path, group, container, seed):
    """One tool group's random stream in one container: cv2's frames (as
    many as FFmpeg puts out: a not-coded VOP puts none, but for the last,
    which repeats the frame before) and cv2's frame count."""
    clip = _stream(group, seed)
    path = tmp_path / f"{group}.{container}"
    M4.MUX[container](path, clip, **MUX_OPTS[container])
    _same_as_cv2(path, clip.frames)


@pytest.mark.parametrize("build,container,opts", BUILDS)
def test_builds_match_cv2(tmp_path, build, container, opts):
    """P-VOPs under each encoder build's user data at 33x26 (edges at an
    odd size where FF_BUG_EDGE puts them), in AVI (codec tag XVID) and
    Matroska (no tag, or a VFW XVID): what FFmpeg chose by the build and
    the tag, frame for frame."""
    clip = M4.random_stream(3, "inter", width=33, height=26, frames=6, build=build)
    path = tmp_path / f"{build}.{container}"
    M4.MUX[container](path, clip, **opts)
    r = _same_as_cv2(path, clip.frames)
    info = r._dec.mpeg4_info()
    tagged = container == "avi" or opts.get("vfw")
    assert info["xvid_idct"] == (build in ("xvid", "xvid0") or (build == "none" and bool(tagged)))
    assert ("EDGE" in info["bugs"]) == (build in ("ffmpeg", "xvid0")
                                        or (build == "none" and bool(tagged)))
    assert info["packed"] == (build == "divx_packed")


def test_writer_streams_write_every_tool():
    """The groups' streams above write every tool they stand for."""
    tools = collections.Counter()
    for group in STREAMS:
        tools.update(_stream(group).tools)
    for k in ("intra", "intra_p", "ac_pred", "no_ac_pred", "dquant", "dc_vlc", "dc_tcoef",
              "esc1", "esc2", "esc3", "stuffing", "skip", "1mv", "4mv", "over_edge", "nvop",
              "b_direct", "b_direct4", "b_direct_delta", "b_interpolate", "b_backward",
              "b_forward", "b_modb_1", "b_modb_01", "b_cbpb", "dbquant", "b_colocated_skip",
              "packed"):
        assert tools[k] > 0, k
    seek = M4.random_stream(0, "b", frames=14, gop=6, gov=True, time_res=7).tools
    assert seek["gov"] and seek["modulo_time_base"]


def _cv2_reads(path, order):
    cap = cv2.VideoCapture(str(path))
    nxt, out = 0, []
    for i in order:
        if i != nxt:
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(i))
        ok, bgr = cap.read()
        nxt = i + 1
        out.append(bgr[..., ::-1].copy() if ok else None)
    return out


SEEKS = [("b", "avi"), ("b", "mp4"), ("b", "mkv"), ("b4mv", "mkv"), ("packed", "avi"),
         ("nvop", "mp4"), ("nvop", "avi"), ("inter", "mkv")]


@pytest.mark.parametrize("group,container", SEEKS)
def test_seeks_match_cv2(tmp_path, group, container):
    """Open GOPs (an I-VOP every 6 frames, the B-VOPs before it after it in
    decode order), GOV headers and modulo_time_base across seconds: reads
    backwards, shuffled and as the JAX reader seeks (CAP_PROP_POS_FRAMES
    only off the next frame) give cv2's frames, and fail where cv2's do."""
    clip = M4.random_stream(1, group, width=32, height=32, frames=14, gop=6, gov=True,
                            time_res=7)
    path = tmp_path / f"seek_{group}.{container}"
    M4.MUX[container](path, clip)
    n = int(cv2.VideoCapture(str(path)).get(cv2.CAP_PROP_FRAME_COUNT))
    for order in (list(range(n - 1, -1, -1)), [int(i) for i in RNG.permutation(n)],
                  [13, 2, 14, 12, 11, 0, 7]):
        want = _cv2_reads(path, order)
        r = video.VideoReader(path)
        for i, w in zip(order, want):
            if w is None:
                with pytest.raises(ValueError):
                    r.read(i)
            else:
                np.testing.assert_array_equal(r.read(i), w, err_msg=f"{order} frame {i}")


@pytest.fixture
def jax_config():
    saved = dict(JCfg.config)
    JCfg.config.clear()
    JCfg.config.update({"dataset": {"img_size": 512}, "use_calib": False})
    yield {"dataset": {"img_size": 512}, "use_calib": False}
    JCfg.config.clear()
    JCfg.config.update(saved)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("group,container", [("b", "mp4"), ("packed", "avi"),
                                             ("b4mv", "mkv")])
def test_dataset_matches_jax(tmp_path, jax_config, group, container, k):
    """The writer's B and packed streams through both MP4Datasets at
    subsample k: length, timestamps and every frame equal."""
    JCfg.config["dataset"]["subsample"] = k
    cfg = {**jax_config, "dataset": {**jax_config["dataset"], "subsample": k}}
    clip = M4.random_stream(2, group, width=48, height=32, frames=12, gop=6)
    path = tmp_path / f"ds_{group}.{container}"
    M4.MUX[container](path, clip)
    dt, dj = TD.load_dataset(str(path), cfg), JD.load_dataset(str(path))
    assert isinstance(dt, TD.MP4Dataset) and len(dt) == len(dj)
    np.testing.assert_array_equal(np.asarray(dt.timestamps), np.asarray(dj.timestamps))
    for i in range(len(dj)):
        (tt, it), (tj, ij) = dt[i], dj[i]
        assert tt == tj
        np.testing.assert_array_equal(it, ij)


# --- refusals -------------------------------------------------------------------------------

@pytest.mark.parametrize("feature", M4.REFUSED)
def test_refuses_by_name(tmp_path, feature):
    """A VOL (or a short video header sample) asking a tool the decoder
    does not decode: a ValueError naming it, in AVI (the headers in the
    first sample: the frame fails with it as the cause) and MP4 (the
    headers in esds: the reader refuses them at its first read)."""
    clip = M4.refused_clip(feature)
    for container in ("avi", "mp4"):
        path = tmp_path / f"refused.{container}"
        M4.MUX[container](path, clip)
        with pytest.raises(ValueError) as e:
            video.VideoReader(path).read(0)
        assert feature in str(e.value) + str(e.value.__cause__), (container, e.value)


def test_refuses_a_size_change(tmp_path):
    """A second clip's VOL of another size spliced into an AVI: the frames
    before it read, the frame after it raises naming the size change."""
    a = M4.random_stream(0, "intra", width=32, height=32, frames=2)
    b = M4.random_stream(1, "intra", width=48, height=32, frames=2)
    clip = M4.Clip(32, 32, a.samples + [b.headers + b.samples[0]], [True] * 3,
                   headers=a.headers, frames=3)
    path = tmp_path / "resized.avi"
    M4.write_avi(path, clip)
    r = video.VideoReader(path)
    r.read(0)
    r.read(1)
    with pytest.raises(ValueError, match="failed to decode frame 2") as e:
        r.read(2)
    assert "size change" in str(e.value.__cause__)


# --- the plain versions ---------------------------------------------------------------------

@pytest.mark.parametrize("add", [0, 1])
def test_xvid_idct_matches_plain(add):
    """The compiled Xvid IDCT equals xvid_idct_ref (its SSE2 saturation
    included) on DC rows, sparse, dense and saturating blocks."""
    for trial in range(400):
        blk = np.zeros(64, np.int16)
        kind = trial % 4
        if kind == 0:
            blk[::8] = RNG.integers(-2048, 2048, 8)
        elif kind == 1:
            k = RNG.integers(1, 10)
            blk[RNG.integers(0, 64, k)] = RNG.integers(-300, 300, k)
        elif kind == 2:
            blk[:] = RNG.integers(-2048, 2048, 64)
        else:
            blk[RNG.integers(0, 64, 3)] = RNG.integers(-32768, 32768, 3)
        base = RNG.integers(0, 256, (8, 8)).astype(np.uint8)
        want = np.clip(base.astype(np.int64) * add + video.xvid_idct_ref(blk), 0, 255)
        np.testing.assert_array_equal(video.xvid_idct(blk, add, base), want)


def test_bipred_matches_plain():
    """A B-VOP block's forward and backward half-pel predictions and their
    average: the compiled entry equals mpeg4_bipred_ref, 8 and 16 wide,
    every half-pel position, over the planes' edges."""
    p0 = RNG.integers(0, 256, (21, 27)).astype(np.uint8)
    p1 = RNG.integers(0, 256, (21, 27)).astype(np.uint8)
    for trial in range(300):
        n = 8 if trial % 2 else 16
        fwd = (int(RNG.integers(-20, 30)), int(RNG.integers(-20, 25)), trial % 4)
        bwd = (int(RNG.integers(-20, 30)), int(RNG.integers(-20, 25)), (trial // 4) % 4)
        np.testing.assert_array_equal(video.mpeg4_bipred(p0, p1, fwd, bwd, n),
                                      video.mpeg4_bipred_ref(p0, p1, fwd, bwd, n))
