"""Port parity of the H.264 reader: ``native/h264_decode.cpp`` behind
``data/video.py`` against ``cv2.VideoCapture`` (OpenCV's FFmpeg backend),
with tolerance 0 (``FRAME_TOL``).

The committed fixtures of ``tests/data/video`` (``make_fixtures.py``;
``tests/test_torch_video.py`` reads them in order against cv2 and against
the JAX package's ``MP4Dataset``) are read here backwards and in a
shuffled order (each seek decodes from the IDR picture before it) to the
digests of cv2's frames; fresh streams of random legal syntax from the test
writer (``tests/torch_h264_writer.py``: every I and P macroblock type,
MMCOs, list modifications, weights, scaling lists, the 8x8 transform,
several slices, cropping) are decoded at test time by both; the port's
``MP4Dataset`` is held against the JAX one on strides and on a file cut
short; the compiled transforms, interpolation and deblocking edge against
their plain numpy versions, bit for bit; and each feature the decoder
leaves out is refused by name."""

import hashlib
import json
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
H264 = sorted(n for n, d in DIGESTS.items() if d["fourcc"] in ("avc1", "H264"))
FRAME_TOL = 0  # max |port - cv2| in LSB of the RGB frames (measured: 0)
MUX = {"mp4": W.write_mp4, "mkv": W.write_mkv, "avi": W.write_avi}


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


@pytest.fixture
def jax_config():
    saved = dict(JCfg.config)
    JCfg.config.clear()
    JCfg.config.update({"dataset": {"img_size": 512}, "use_calib": False})
    yield {"dataset": {"img_size": 512}, "use_calib": False}
    JCfg.config.clear()
    JCfg.config.update(saved)


def test_fixtures_cover_the_slice():
    """CAVLC and CABAC random syntax in MP4, Matroska and AVI, the cropped
    clip, the 1080p clip and the CLI clip are all committed."""
    assert len(H264) == 16
    assert {n.rsplit(".", 1)[1] for n in H264} == {"mp4", "mkv", "avi"}
    assert DIGESTS["h264_1920x1080.mp4"]["hw"] == [1080, 1920]
    assert DIGESTS["h264_152x104.mp4"]["hw"] == [104, 152]
    assert DIGESTS["cli_640x480_h264.mp4"]["frame_count"] == 16


@pytest.mark.parametrize("name", H264)
def test_fixture_reads_backwards_and_shuffled(name):
    """Every frame read backwards, then in a shuffled order, gives cv2's
    frame (the SHA-256 recorded beside the fixture)."""
    rec = DIGESTS[name]
    r = video.VideoReader(FIXTURES / name)
    n = rec["frame_count"]
    order = list(range(n - 1, -1, -1)) + \
        [int(i) for i in np.random.default_rng(len(name)).permutation(n)]
    for i in order:
        img = r.read(i)
        assert list(img.shape[:2]) == rec["hw"]
        assert _sha(img) == rec["frames"][i]["cv2"], (name, i)


@pytest.mark.parametrize("cabac", [False, True], ids=["cavlc", "cabac"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_syntax_matches_cv2(tmp_path, seed, cabac):
    """A fresh stream of random legal syntax (its options drawn from the
    seed too) decodes to cv2's frames, in the container the seed picks."""
    clip = W.random_stream(1000 * seed + cabac, cabac=cabac, frames=5)
    mux = ("mp4", "mkv", "avi")[seed % 3]
    path = tmp_path / f"random.{mux}"
    MUX[mux](path, clip)
    want = _cv2_frames(path)
    r = video.VideoReader(path)
    assert len(want) == len(r) == 5
    for i, w in enumerate(want):
        got = r.read(i)
        assert got.shape == w.shape
        d = np.abs(got.astype(np.int16) - w.astype(np.int16))
        assert d.max() <= FRAME_TOL, (seed, cabac, i, int(d.max()))


def test_real_encoder_stream_matches_cv2(tmp_path):
    """The writer's encoder on a fresh pan (CAVLC, bottom crop, deblocking
    on): every frame is cv2's."""
    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (40, 72, 3)).astype(np.float64)
    frames = [np.clip(np.roll(base, (i, 2 * i), (0, 1)) * 0.8 + 20, 0, 255)
              .astype(np.uint8) for i in range(4)]
    clip = W.encode(frames, cabac=False, qp=30, crop=(0, 8, 0, 8))
    path = tmp_path / "pan.mp4"
    W.write_mp4(path, clip)
    want = _cv2_frames(path)
    r = video.VideoReader(path)
    assert len(want) == 4
    for i, w in enumerate(want):
        np.testing.assert_array_equal(r.read(i), w)


@pytest.mark.parametrize("entry,length_size", [(b"avc1", 1), (b"avc1", 2),
                                               (b"avc3", 4)])
def test_nal_length_sizes_and_avc3(tmp_path, entry, length_size):
    """avcC's 1- and 2-byte NAL lengths, and an avc3 entry whose IDR
    samples carry the parameter sets too."""
    clip = W.random_stream(77, cabac=True, width=32, height=32, frames=3,
                           pcm=False)
    path = tmp_path / "lengths.mp4"
    W.write_mp4(path, clip, length_size=length_size, entry=entry)
    want = _cv2_frames(path)
    r = video.VideoReader(path)
    assert r.track.fourcc == entry.decode() and len(want) == len(r) == 3
    for i, w in enumerate(want):
        np.testing.assert_array_equal(r.read(i), w)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", ["h264_cabac.mkv", "h264_cavlc.avi"])
def test_subsample_matches_jax(name, k, jax_config):
    """Strides over a clip whose only sync sample is its first."""
    JCfg.config["dataset"]["subsample"] = k
    cfg = {**jax_config, "dataset": {**jax_config["dataset"], "subsample": k}}
    path = str(FIXTURES / name)
    dt, dj = TD.load_dataset(path, cfg), JD.load_dataset(path)
    assert isinstance(dt, TD.MP4Dataset) and dt.stride == dj.stride == k
    assert len(dt) == len(dj)
    np.testing.assert_array_equal(np.asarray(dt.timestamps),
                                  np.asarray(dj.timestamps))
    for i in range(len(dj)):
        (tt, it), (tj, ij) = dt[i], dj[i]
        assert tt == tj
        np.testing.assert_array_equal(it, ij)


def test_truncated_clip_raises_the_jax_message(tmp_path, jax_config):
    """An MP4 of H.264 cut inside picture 6's data: both readers report 8
    frames, read 5 alike, and raise the same message for 6 and 7."""
    src = FIXTURES / "h264_cabac.mp4"
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
        assert str(got.value) == str(want.value) == \
            f"failed to decode frame {i} of {path}"


@pytest.mark.parametrize("n", [4, 8])
def test_transform_equals_plain(n):
    """The compiled scaling + inverse transform of random levels under
    random scaling lists at every QP equals ``h264_idct_ref``."""
    rng = np.random.default_rng(n)
    for qp in range(52):
        for _ in range(4):
            lv = np.zeros((n, n), np.int64)
            k = int(rng.integers(1, n * n))
            lv.flat[rng.choice(n * n, k, replace=False)] = rng.integers(-6, 7, k)
            w = rng.integers(4, 40, (n, n))
            pred = rng.integers(0, 256, (n, n)).astype(np.uint8)
            np.testing.assert_array_equal(video.h264_idct(lv, w, qp, pred),
                                          video.h264_idct_ref(lv, w, qp, pred))


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_interpolation_equals_plain(chroma):
    """Every fraction, partition size and a position past each edge."""
    rng = np.random.default_rng(7)
    plane = rng.integers(0, 256, (20, 28)).astype(np.uint8)
    ref = video.h264_chroma_mc_ref if chroma else video.h264_luma_mc_ref
    fracs = 8 if chroma else 4
    for fy in range(fracs):
        for fx in range(fracs):
            for w, h in ((16, 16), (16, 8), (8, 16), (8, 8), (8, 4), (4, 8), (4, 4)):
                if chroma:
                    w, h = w // 2, h // 2
                x, y = int(rng.integers(-40, 50)), int(rng.integers(-40, 40))
                np.testing.assert_array_equal(
                    video.h264_mc(plane, x, y, fx, fy, w, h, chroma),
                    ref(plane, x, y, fx, fy, w, h))


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("bs", [1, 2, 3, 4])
def test_deblocking_edge_equals_plain(bs, chroma):
    """One edge of 16 lines (bS < 4 and bS = 4) over every indexA / indexB
    pair of a grid, on lines smooth enough to be filtered."""
    rng = np.random.default_rng(bs + 10 * chroma)
    changed = 0
    for ia in range(0, 52, 3):
        for ib in range(0, 52, 5):
            lines = np.clip(rng.integers(60, 190) + rng.integers(-9, 10, (16, 8)),
                            0, 255).astype(np.uint8)
            got = video.h264_edge(lines, bs, ia, ib, chroma)
            np.testing.assert_array_equal(
                got, video.h264_edge_ref(lines, bs, ia, ib, chroma))
            changed += not np.array_equal(got, lines)
    assert changed > 20


@pytest.mark.parametrize("matrix", [2, 1, 4, 7, 9])
def test_converter_matrices_equal_plain(matrix):
    """The converter under the VUI matrices cv2 honours, both ranges."""
    rng = np.random.default_rng(matrix)
    y = rng.integers(0, 256, (10, 14)).astype(np.uint8)
    cb = rng.integers(0, 256, (5, 7)).astype(np.uint8)
    cr = rng.integers(0, 256, (5, 7)).astype(np.uint8)
    for full in (False, True):
        np.testing.assert_array_equal(video.yuv_to_rgb(y, cb, cr, full, matrix),
                                      video.yuv_to_rgb_ref(y, cb, cr, full, matrix))


@pytest.mark.parametrize("feature", W.REFUSED)
def test_refuses_by_name(tmp_path, feature):
    """Each feature the decoder leaves out raises ValueError naming it: at
    the parameter sets when the reader opens the stream, else at the
    picture that uses it (the error naming the frame, caused by the
    refusal)."""
    path = tmp_path / "refused.mp4"
    W.write_mp4(path, W.refused_clip(feature))
    r = video.VideoReader(path)
    with pytest.raises(ValueError) as e:
        for i in range(len(r)):
            r.read(i)
    msg = str(e.value.__cause__ or e.value)
    assert f"H.264 with {feature}" in msg and "is not supported" in msg


@pytest.mark.parametrize("between", ["SPS", "PPS"])
def test_fails_on_parameter_set_inside_a_picture(tmp_path, between):
    """An SPS (here of a larger picture, same id) or a PPS written between
    two slices of one picture: an SPS or PPS starts a new access unit, so
    the second slice is malformed and the read raises ValueError rather
    than decode it under parameter sets its picture was not sized for."""
    p = W.Params(width=64, height=48)
    sw = W.StreamWriter(p)
    chooser = W.RandomChooser(np.random.default_rng(0), p, pcm=False)
    total = p.mbw * p.mbh
    sw.picture([W.SliceSpec(0, total, type=2)], chooser, idr=True)
    half = total // 2
    sw.picture([W.SliceSpec(0, half, type=0, num_ref=1),
                W.SliceSpec(half, total - half, type=0, num_ref=1)], chooser)
    clip = sw.clip()
    other = W.Params(width=128, height=96, cabac=True)
    inside = W.write_sps(other) if between == "SPS" else W.write_pps(other)
    clip.pictures[1].insert(1, inside)
    path = tmp_path / "inside.mp4"
    W.write_mp4(path, clip)
    r = video.VideoReader(path)
    r.read(0)
    with pytest.raises(ValueError) as e:
        r.read(1)
    msg = str(e.value.__cause__ or e.value)
    assert "an SPS or PPS NAL unit between two slices of one picture" in msg
