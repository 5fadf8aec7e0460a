"""Port parity of the VP9 reader: ``native/vp9_decode.cpp`` behind
``data/video.py`` against ``cv2.VideoCapture`` (OpenCV's FFmpeg backend),
with tolerance 0 (``FRAME_TOL``).

The committed fixtures of ``tests/data/video`` (``make_fixtures.py vp9``:
cv2's own VP9 files, from libvpx, and the test writer's) are read backwards
and in a shuffled order to the digests of cv2's frames
(``tests/test_torch_video.py`` reads every fixture in order against cv2 and
the JAX package's ``MP4Dataset``); fresh streams of random legal syntax from
the test writer (``tests/torch_vp9_writer.py``), one per tool group and
container, are decoded at test time by both; the writer's streams are
checked to carry the tools they are for; the port's ``MP4Dataset`` is held
against the JAX one on strides; the compiled transform, prediction and loop
filter entries against their plain numpy versions, bit for bit; a damaged
stream fails with ValueError; and each refused feature is refused by
name."""

import functools
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import torch_vp9_writer as W  # noqa: E402
from mast3r_slam_tpu.data import datasets as JD  # noqa: E402
from mast3r_slam_tpu.utils import config as JCfg  # noqa: E402
from mast3r_slam_tpu_torch.data import containers, video  # noqa: E402
from mast3r_slam_tpu_torch.data import datasets as TD  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "data" / "video"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
VP9 = sorted(n for n, d in DIGESTS.items() if d["fourcc"] in ("VP90", "vp09"))
FRAME_TOL = 0  # max |port - cv2| in LSB of the RGB frames (measured: 0)
# the writer's fixture streams: name -> (tool group, seed, frames), as
# make_fixtures.py writes them
WRITER_FIXTURES = {"vp9_hidden.mkv": ("hidden", 101, 8), "vp9_compound.mp4": ("compound", 100, 8),
                   "vp9_adapt.avi": ("adapt", 103, 8), "vp9_seg.mkv": ("seg", 101, 8),
                   "vp9_tiles.mp4": ("tiles", 100, 8)}


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            return out
        out.append(bgr[..., ::-1])


@functools.lru_cache(maxsize=None)
def _writer_stream(group, seed, frames):
    return W.random_stream(seed, group, frames=frames)


@pytest.fixture
def jax_config():
    saved = dict(JCfg.config)
    JCfg.config.clear()
    JCfg.config.update({"dataset": {"img_size": 512}, "use_calib": False})
    yield {"dataset": {"img_size": 512}, "use_calib": False}
    JCfg.config.clear()
    JCfg.config.update(saved)


def test_fixtures_cover_the_slice():
    """cv2's VP9 in MKV, MP4 (vp09) and AVI, the busy clip (cv2 codes its
    131x99 frames at 130x98), the CLI clip with two tile columns, the 1080p
    clip with four, and the writer's five tool groups are all committed,
    together under 400 KB."""
    assert len(VP9) == 11
    assert {n.rsplit(".", 1)[1] for n in VP9} == {"mp4", "mkv", "avi"}
    assert DIGESTS["vp9_busy_131x99.mkv"]["hw"] == [98, 130]
    assert DIGESTS["cli_640x480_vp9.mkv"]["frame_count"] == 16
    assert DIGESTS["vp9_1920x1080.mkv"]["hw"] == [1080, 1920]
    assert sum((FIXTURES / n).stat().st_size for n in VP9) < 400_000
    assert set(WRITER_FIXTURES) <= set(VP9)


@pytest.mark.parametrize("name", VP9)
def test_fixture_reads_backwards_and_shuffled(name):
    """Every frame read backwards, then in a shuffled order, gives cv2's
    frame (the SHA-256 recorded beside the fixture); each seek decodes from
    the key frame before it."""
    rec = DIGESTS[name]
    r = video.VideoReader(FIXTURES / name)
    n = rec["frame_count"]
    assert len(r) == n and r.fps == rec["fps"]
    order = list(range(n - 1, -1, -1)) + \
        [int(i) for i in np.random.default_rng(len(name)).permutation(n)]
    for i in order:
        img = r.read(i)
        assert list(img.shape[:2]) == rec["hw"]
        assert _sha(img) == rec["frames"][i]["cv2"], (name, i)


@pytest.mark.parametrize("mux", ["mkv", "mp4", "avi"])
@pytest.mark.parametrize("group", W.GROUPS)
def test_random_syntax_matches_cv2(tmp_path, group, mux):
    """A fresh stream of random legal syntax of one tool group decodes to
    cv2's frames in each container: the frame count, and every frame in
    order, then backwards."""
    seed = 7 * W.GROUPS.index(group) + ("mkv", "mp4", "avi").index(mux) + 1
    clip = W.random_stream(seed, group, frames=6 if group != "tiles" else 3)
    path = tmp_path / f"random.{mux}"
    W.MUX[mux](path, clip)
    want = _cv2_frames(path)
    r = video.VideoReader(path)
    assert len(want) == len(r) == len(clip.samples)
    for i in list(range(len(want))) + list(range(len(want) - 1, -1, -1)):
        got = r.read(i)
        assert got.shape == want[i].shape
        d = np.abs(got.astype(np.int16) - want[i].astype(np.int16))
        assert d.max() <= FRAME_TOL, (group, mux, i, int(d.max()))


def _flags(name):
    group, seed, frames = WRITER_FIXTURES[name]
    return _writer_stream(group, seed, frames).flags


@pytest.mark.parametrize("name", sorted(WRITER_FIXTURES))
def test_writer_streams_carry_their_tools(name):
    """The header flags of each tool group's fixture stream (the writer is
    deterministic in its seed): hidden frames and show_existing_frame;
    compound and reference_select, with ALTREF, GOLDEN and LAST each the
    fixed compound reference; backward
    adaptation, all four contexts, reset_frame_context 2 and 3 on
    intra-only frames, error-resilient frames; every segmentation feature
    with temporal prediction, lossless and delta-q frames; tile columns and
    rows. The committed fixture holds the same samples."""
    group, seed, frames = WRITER_FIXTURES[name]
    t = containers.open_track(FIXTURES / name)
    data = (FIXTURES / name).read_bytes()
    assert [data[int(o):int(o) + int(n)] for o, n in zip(t.offsets, t.sizes)] == \
        _writer_stream(group, seed, frames).samples
    fl = _flags(name)
    inter = [f for f in fl if f.get("kind") == "inter"]
    if group == "hidden":
        assert any(f.get("show_existing") for f in fl)
        assert any(f.get("show") is False and f["kind"] == "inter" for f in fl)
    elif group == "compound":
        assert {f["ref_mode"] for f in inter} >= {1, 2}
        # ALTREF, GOLDEN and LAST each the fixed reference of compound frames
        assert {f["sign_bias"] for f in inter if f["ref_mode"]} >= {(0, 0, 1), (0, 1, 0), (0, 1, 1)}
    elif group == "adapt":
        assert any(f.get("intra_only") for f in fl) and any(f.get("error_res") for f in fl)
        assert any(f.get("refresh_ctx") and not f.get("parallel") for f in fl)
        assert {f["reset_ctx"] for f in fl if f.get("intra_only")} >= {2, 3}
        assert {f["ctx_idx"] for f in fl if "ctx_idx" in f} == {0, 1, 2, 3}
    elif group == "seg":
        feats = set().union(*(f.get("seg_features", []) for f in fl))
        assert feats == {0, 1, 2, 3} and any(f.get("seg_temporal") for f in fl)
        assert any(f.get("lossless") for f in fl) and any(f.get("dq") for f in fl)
    else:
        assert any(f.get("tile_cols") for f in fl)
        assert {f.get("tile_rows") for f in fl if "tile_rows" in f} >= {1, 2}


@pytest.mark.parametrize("kind", ["partition", "block", "tx", "tx_type", "intra_mode",
                                  "uv_mode", "inter_mode", "filter", "token", "compound"])
def test_writer_streams_carry_every_block_tool(kind):
    """Together the fixture streams write every partition, block size
    (sub-8x8 too), tx size, tx type of each size (and the WHT), intra and
    inter mode, interpolation filter (bilinear too), token category and
    compound blocks."""
    stats = {}
    for group, seed, frames in WRITER_FIXTURES.values():
        for k, v in _writer_stream(group, seed, frames).stats.items():
            stats[k] = stats.get(k, 0) + v
    want = {"partition": [(v,) for v in range(4)], "block": [(v,) for v in range(13)],
            "tx": [(v,) for v in range(4)],
            "tx_type": [(tx, t) for tx in range(4) for t in (range(4) if tx < 3 else [0])] + [(0, 4)],
            "intra_mode": [(v,) for v in range(10)], "uv_mode": [(v,) for v in range(10)],
            "inter_mode": [(v,) for v in range(10, 14)], "filter": [(v,) for v in range(4)],
            "token": [(v,) for v in range(1, 11)], "compound": [(v,) for v in (1, 2, 3)]}[kind]
    if kind == "compound":
        assert sum(v for k, v in stats.items() if k[0] == "compound") > 0
        return
    assert all(stats.get((kind,) + w, 0) > 0 for w in want), \
        [w for w in want if not stats.get((kind,) + w)]


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", ["vp9.mkv", "vp9_hidden.mkv", "vp9_adapt.avi"])
def test_subsample_matches_jax(name, k, jax_config):
    """Strides over a clip with one key frame, hidden frames and
    show_existing_frame, or intra-only frames: the port's MP4Dataset gives
    the JAX reader's length, timestamps and frames."""
    JCfg.config["dataset"]["subsample"] = k
    cfg = {**jax_config, "dataset": {**jax_config["dataset"], "subsample": k}}
    path = str(FIXTURES / name)
    dt, dj = TD.load_dataset(path, cfg), JD.load_dataset(path)
    assert isinstance(dt, TD.MP4Dataset) and dt.stride == dj.stride == k
    assert len(dt) == len(dj)
    np.testing.assert_array_equal(np.asarray(dt.timestamps), np.asarray(dj.timestamps))
    for i in range(len(dj)):
        (tt, it), (tj, ij) = dt[i], dj[i]
        assert tt == tj
        np.testing.assert_array_equal(it, ij)


def test_bare_samples_and_superframes():
    """On bare samples: a superframe of a hidden frame and a shown one puts
    out the shown one; a sample of the hidden frame alone puts out
    nothing, and a show_existing_frame after it shows the hidden frame."""
    sw = W.StreamWriter(48, 32, seed=3)
    key = sw.frame(W.FrameSpec(kind="key"))
    hidden = sw.frame(W.FrameSpec(show=False, refresh=1 << 5))
    shown = sw.frame(W.FrameSpec())
    existing = sw.frame(None, show_existing=5)
    dec = video.Decoder(video.VP9)
    assert dec.decode(key, 0) and dec.size == (48, 32)
    assert not dec.decode(hidden, 1)
    assert dec.decode(shown, 2) and dec.tag == 2
    assert dec.decode(existing, 3) and dec.tag == 3
    ref = video.Decoder(video.VP9)
    ref.decode(key, 0)
    assert ref.decode(W.superframe([hidden, existing]), 1)
    assert np.array_equal(ref.rgb(), dec.rgb())


@pytest.mark.parametrize("tx", [0, 1, 2, 3])
def test_transform_equals_plain(tx):
    """The compiled inverse transforms of every type (and the WHT) on
    random coefficients equal ``vp9_itx_ref``."""
    rng = np.random.default_rng(tx)
    n = 4 << tx
    for tx_type in ([0, 1, 2, 3, 4] if tx == 0 else [0, 1, 2, 3] if tx < 3 else [0]):
        for _ in range(12):
            c = np.zeros((n, n), np.int64)
            k = int(rng.integers(1, min(n * n, 64)))
            c.flat[rng.choice(n * n, k, replace=False)] = rng.integers(-400, 401, k)
            pred = rng.integers(0, 256, (n, n)).astype(np.uint8)
            np.testing.assert_array_equal(video.vp9_itx(c, tx, tx_type, pred),
                                          video.vp9_itx_ref(c, tx, tx_type, pred))


@pytest.mark.parametrize("filt", [0, 1, 2, 3], ids=["regular", "smooth", "sharp", "bilinear"])
def test_prediction_equals_plain(filt):
    """Every 1/16 fraction, put and averaged, at positions past each edge."""
    rng = np.random.default_rng(filt)
    plane = rng.integers(0, 256, (21, 27)).astype(np.uint8)
    for fx in range(16):
        for fy in range(0, 16, 3):
            w, h = [(4, 4), (8, 4), (16, 8), (4, 8)][(fx + fy) % 4]
            x, y = int(rng.integers(-12, 32)), int(rng.integers(-12, 26))
            dst = rng.integers(0, 256, (h, w)).astype(np.uint8) if fx & 1 else None
            np.testing.assert_array_equal(video.vp9_mc(plane, x, y, fx, fy, w, h, filt, dst),
                                          video.vp9_mc_ref(plane, x, y, fx, fy, w, h, filt, dst))


@pytest.mark.parametrize("wd", [4, 8, 16])
def test_loop_filter_equals_plain(wd):
    """One edge at every level and sharpness, over flat, stepped and busy
    lines (each of the filter's branches)."""
    rng = np.random.default_rng(wd)
    for level in range(1, 64, 3):
        for sharp in range(8):
            base = rng.integers(60, 200, (8, 1)) + rng.integers(-2, 3, (8, 16)) * int(rng.integers(0, 3))
            base[:, 8:] += int(rng.integers(-10, 11))
            lines = np.clip(base, 0, 255).astype(np.uint8)
            np.testing.assert_array_equal(video.vp9_lf(lines, wd, level, sharp),
                                          video.vp9_lf_ref(lines, wd, level, sharp))


@pytest.mark.parametrize("feature", W.REFUSED)
def test_refuses_by_name(tmp_path, feature):
    """Each refused feature raises ValueError naming it, at the frame that
    uses it (the error naming the frame, caused by the refusal)."""
    path = tmp_path / "refused.mkv"
    W.write_mkv(path, W.refused_clip(feature))
    r = video.VideoReader(path)
    with pytest.raises(ValueError) as e:
        for i in range(len(r)):
            r.read(i)
    msg = str(e.value.__cause__ or e.value)
    assert f"VP9 with {feature}" in msg and "is not supported" in msg


@pytest.mark.parametrize("seed", [1, 2])
def test_damaged_streams_fail_cleanly(seed):
    """Samples cut short, flipped bytes, a superframe index naming more
    data than its sample: each sample decodes or raises ValueError, never
    more."""
    rng = np.random.default_rng(seed)
    clip = W.random_stream(seed, ("hidden", "adapt")[seed - 1], frames=5)
    for trial in range(24):
        dec = video.Decoder(video.VP9)
        for k, s in enumerate(clip.samples):
            b = bytearray(s)
            if k and trial % 3 == 0:
                b = b[:int(rng.integers(1, len(b) + 1))]
            elif k and trial % 3 == 1:
                for _ in range(3):
                    b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
            elif k:
                b += bytes([0xC1, 0xFF, 0xFF, 0xC1])
            try:
                dec.decode(bytes(b), k)
            except ValueError:
                pass


@pytest.mark.parametrize("mux", ["mkv", "mp4", "avi"])
def test_lone_hidden_sample(tmp_path, mux, jax_config):
    """A sample holding only a hidden frame (not in a superframe): cv2
    counts the container's samples (9) but puts out 8 frames; read in
    order, after seeks, and at the missing ninth, the port's MP4Dataset
    gives what the JAX one gives."""
    sw = W.StreamWriter(48, 32, seed=3)
    s = [sw.frame(W.FrameSpec(kind="key")), sw.frame(W.FrameSpec()),
         sw.frame(W.FrameSpec(show=False, refresh=1 << 5))]
    s += [sw.frame(W.FrameSpec()) for _ in range(3)]
    s += [sw.frame(None, show_existing=5)] + [sw.frame(W.FrameSpec()) for _ in range(2)]
    path = tmp_path / f"lone.{mux}"
    W.MUX[mux](path, W.Clip(48, 32, s, [True] + [False] * 8))
    assert len(_cv2_frames(path)) == 8
    dt, dj = TD.load_dataset(str(path), jax_config), JD.load_dataset(str(path))
    assert len(dt) == len(dj) == 9
    for i in [0, 1, 2, 3, 4, 5, 6, 7, 6, 3, 5, 0, 7]:
        np.testing.assert_array_equal(dt[i][1], dj[i][1])
    for d in (dt, dj):
        with pytest.raises(ValueError, match="failed to decode frame 8"):
            d[8]


@pytest.mark.parametrize("color_range", [0, 1], ids=["limited", "full"])
@pytest.mark.parametrize("color_space", range(6))
def test_colour_spaces_match_cv2(tmp_path, color_space, color_range):
    """Each colour space of profile 0 (unknown, BT.601, BT.709, SMPTE 170M,
    SMPTE 240M, BT.2020) in each range, at an odd width: cv2 converts with
    the matrix and range the key frame names."""
    sw = W.StreamWriter(63, 40, seed=color_space)
    s = [sw.frame(W.FrameSpec(kind="key", color=(color_space, color_range)))]
    s += [sw.frame(W.FrameSpec()) for _ in range(2)]
    path = tmp_path / "colour.mkv"
    W.write_mkv(path, W.Clip(63, 40, s, [True, False, False]))
    want = _cv2_frames(path)
    r = video.VideoReader(path)
    assert len(want) == 3
    for i, w in enumerate(want):
        np.testing.assert_array_equal(r.read(i), w)


def test_intra_only_frame_switches_to_bt601(tmp_path):
    """A key frame in BT.709 full range, then an intra-only frame (hidden,
    in a superframe with an inter frame): from then on cv2 converts as
    BT.601 limited range, as FFmpeg sets an intra-only frame of profile 0,
    and the reader does the same."""
    sw = W.StreamWriter(48, 32, seed=9)
    s = [sw.frame(W.FrameSpec(kind="key", color=(2, 1)))]
    s.append(sw.frame(W.FrameSpec()))
    io = sw.frame(W.FrameSpec(kind="intra_only", show=False, refresh=1 << 3))
    s.append(W.superframe([io, sw.frame(W.FrameSpec())]))
    s.append(sw.frame(W.FrameSpec()))
    path = tmp_path / "intra_only.mkv"
    W.write_mkv(path, W.Clip(48, 32, s, [True, False, False, False]))
    want = _cv2_frames(path)
    dec = video.Decoder(video.VP9)
    for i, w in enumerate(want):
        assert dec.decode(s[i], i)
        np.testing.assert_array_equal(dec.rgb(), w)
        y, cb, cr = dec.planes()
        full, matrix = (True, 1) if i < 2 else (False, 5)
        np.testing.assert_array_equal(video.yuv_to_rgb(y, cb, cr, full, matrix), w)
