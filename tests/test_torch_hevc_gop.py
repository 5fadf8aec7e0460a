"""HEVC as encoders write it, held against ``cv2.VideoCapture`` (OpenCV's
FFmpeg backend) at 0 LSB (``FRAME_TOL``): fresh streams of the test
writer's GOP structures (``torch_hevc_writer.GOPS``: x265's mini-GOPs of
four B pictures with a pyramid and an open-GOP CRA picture, HM's
hierarchical GOPs of 8 with CRA pictures every 16-32 pictures, RADL
pictures after IDR_W_RADL and CRA pictures, the three BLA types, a file
that starts at a CRA picture whose RASL pictures reference pictures it
lacks) read in order, backwards and shuffled as the JAX reader reads (a
seek where a read is not the next frame), in MP4 (``hvc1`` and ``hev1``
with ``ctts``), Matroska (block timecodes) and AVI; CRA pictures that are
not sync samples, ``ctts`` without ``elst`` and of version 1. Where cv2
reads no frame (RASL pictures skipped, the last pictures not put out), the
port fails at the same reads. Decoding starts over at every seek, so
these reads also hold FFmpeg's RASL gate after a seek to a CRA picture.
The streams the decoder used to refuse, pictures sent with
pic_output_flag 0, an end of sequence before a CRA picture and the JAX
datasets are in ``tests/test_torch_hevc.py``."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import torch_hevc_writer as W  # noqa: E402
from mast3r_slam_tpu_torch.data import video  # noqa: E402

FRAME_TOL = 0  # max |port - cv2| in LSB of the RGB frames (measured: 0)
FRAMES = 40    # long enough that OpenCV's seeks (16 frames back) reach the CRA pictures


def cv2_reads(path, order):
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


def assert_reads(path, order):
    """The port's reads ``order`` of ``path``: cv2's frames, and a failure
    naming the frame where cv2 reads none."""
    want = cv2_reads(path, order)
    r = video.VideoReader(path)
    for i, w in zip(order, want):
        if w is None:
            with pytest.raises(ValueError, match=f"failed to decode frame {i} of "):
                r.read(i)
            continue
        got = r.read(i)
        assert got.shape == w.shape
        d = np.abs(got.astype(np.int16) - w.astype(np.int16))
        assert d.max() <= FRAME_TOL, (path.name, i, int(d.max()))
    return sum(w is None for w in want)


def orders(n, seed):
    """In order, backwards, shuffled."""
    rng = np.random.default_rng(seed)
    return list(range(n)), list(range(n))[::-1], [int(i) for i in rng.permutation(n)]


def write(tmp_path, clip, mux, **kw):
    """The clip as mp4 (hvc1), hev1 (MP4 with the parameter sets in band),
    mkv or avi."""
    path = tmp_path / f"clip.{'mp4' if mux == 'hev1' else mux}"
    if mux in ("mp4", "hev1"):
        W.write_mp4(path, clip, entry=b"hev1" if mux == "hev1" else b"hvc1", **kw)
    else:
        W.MUX[mux](path, clip)
    return path


@pytest.mark.parametrize("mux", ["mp4", "hev1", "mkv", "avi"])
@pytest.mark.parametrize("kind", W.GOPS)
def test_gop_reads_match_cv2(tmp_path, kind, mux):
    """Every read of a fresh stream of the structure, in order, backwards
    and shuffled, is cv2's: B pictures whose lists hold pictures on both
    sides (TMVP from either list, scaled over negative POC distances,
    combined bi-predictive merge candidates, mvd_l1_zero_flag), leading
    pictures decoded or skipped as FFmpeg decides."""
    seed = 500 + 7 * W.GOPS.index(kind) + ["mp4", "hev1", "mkv", "avi"].index(mux)
    n = 48 if kind == "bla" else FRAMES  # the fifth IRAP picture: BLA_W_LP with RASL
    clip = W.random_stream(seed, "inter", frames=n, gop=kind)
    assert clip.display != sorted(clip.display)
    path = write(tmp_path, clip, mux)
    skipped = sum(assert_reads(path, o) for o in orders(n, seed))
    # a file that starts at a CRA picture, or a BLA_W_LP picture's RASL
    # pictures: fewer frames than samples, read in order too
    assert (skipped > 0) == (kind in ("cra_first", "bla"))


def test_seeks_start_at_cra_pictures(tmp_path, monkeypatch):
    """OpenCV's seeks into HM's stream start decoding at its CRA pictures
    (whose RASL pictures FFmpeg then skips) as well as at its IDR picture,
    and every read is cv2's."""
    starts = []
    restart = video.VideoReader._restart

    def record(self, k):
        starts.append(k)
        return restart(self, k)
    monkeypatch.setattr(video.VideoReader, "_restart", record)
    clip = W.random_stream(533, "inter", frames=FRAMES, gop="hm")
    cra = [k for k, units in enumerate(clip.info) if units["nal"] == 21]
    path = write(tmp_path, clip, "mp4")
    for o in orders(FRAMES, 5):
        assert_reads(path, o)
    assert 0 in starts and set(cra) & set(starts)


@pytest.mark.parametrize("mux", ["mp4", "mkv", "avi"])
@pytest.mark.parametrize("kind", ["x265", "hm"])
def test_cra_not_a_sync_sample(tmp_path, kind, mux):
    """CRA pictures left out of ``stss`` (and of Matroska's and AVI's
    keyframe flags): seeks start at the IDR picture, as FFmpeg's demuxers
    start them."""
    seed = 540 + 3 * ["x265", "hm"].index(kind) + ["mp4", "mkv", "avi"].index(mux)
    clip = W.random_stream(seed, "inter", frames=FRAMES, gop=kind, cra_sync=False)
    assert clip.sync == [i == 0 for i in range(FRAMES)]
    path = write(tmp_path, clip, mux)
    for o in orders(FRAMES, seed):
        assert_reads(path, o)


@pytest.mark.parametrize("form", [dict(elst=False), dict(ctts_version=1)],
                         ids=["no_elst", "ctts_v1"])
def test_ctts_forms(tmp_path, form):
    """``ctts`` offsets that start presentation late (no edit list) or that
    are negative (version 1): frames numbered by presentation time as
    OpenCV numbers them."""
    clip = W.random_stream(560 + len(form), "inter", frames=FRAMES, gop="hm")
    path = write(tmp_path, clip, "mp4", **form)
    for o in orders(FRAMES, 3):
        assert_reads(path, o)


def test_matroska_without_keyframes_refuses_seeks(tmp_path):
    """A Matroska file cut at a CRA picture that is not flagged a keyframe
    has no keyframe at all: FFmpeg's seek leaves the demuxer where it was,
    so the port reads on in order and refuses a seek by name."""
    clip = W.random_stream(570, "inter", frames=24, gop="cra_first", cra_sync=False)
    assert not any(clip.sync)
    path = write(tmp_path, clip, "mkv")
    r = video.VideoReader(path)
    want = cv2_reads(path, [0, 1])
    np.testing.assert_array_equal(r.read(0), want[0])
    np.testing.assert_array_equal(r.read(1), want[1])
    with pytest.raises(ValueError, match="a seek in a Matroska track without a keyframe"):
        r.read(5)


@pytest.mark.parametrize("kind", W.GOPS)
def test_structures_are_what_they_name(kind):
    """The writer's structures: pictures out of decode order, each IRAP
    picture's leading pictures of the types the structure names, and a
    DPB that puts them out in presentation order when decoded from the
    start."""
    pics = W.gop_pictures(kind, FRAMES, np.random.default_rng(1))
    nals = {q.nal for q in pics}
    want = {"x265": {8, 9, 21}, "hm": {8, 9, 21}, "radl": {6, 7},
            "bla": {6, 7, 16, 17, 18}, "cra_first": {8, 9, 21}}[kind]
    assert want <= nals
    assert [q.display for q in pics] != sorted(q.display for q in pics)
    assert sorted(q.display for q in pics) == list(range(FRAMES))
    reorder, max_dec = W.dpb_params(pics)
    assert W._bumped(pics, reorder, max_dec) == list(range(FRAMES))
    for q in pics:
        used = {q.poc + d for d, u in q.rps if u}
        assert len(used) == len(q.used) and len(q.rps) <= 16
        assert (16 <= q.nal <= 21) == (not used)
