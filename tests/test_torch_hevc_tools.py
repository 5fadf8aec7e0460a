"""The HEVC decoder by tool: fresh streams of the test writer
(``tests/torch_hevc_writer.py``, random legal syntax by tool group: intra,
inter (merge, AMVP, AMP, TMVP), low-delay B, explicit weights, tiles, WPP,
long-term pictures with slice-level RPS and list modification, PCM and
transquant bypass, SAO with deblocking overrides, units a base-layer
decoder skips) in MP4, Matroska and AVI against ``cv2.VideoCapture`` at 0
LSB; IRAP pictures whose RPS names pictures the stream lacks (FFmpeg's
generated pictures hold places of the DPB) and a trailing picture that
does (it fails); the plain numpy versions of ``data/video.py`` (inverse transforms,
interpolation and weighting, intra prediction, one deblocking edge, SAO of a
block) against the compiled entries on random inputs, bit for bit; and each
feature the decoder leaves out refused by name."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import torch_hevc_writer as W  # noqa: E402
from mast3r_slam_tpu_torch.data import video  # noqa: E402
from test_torch_hevc_gop import assert_reads, orders  # noqa: E402

FRAME_TOL = 0  # max |port - cv2| in LSB of the RGB frames (measured: 0)


def _cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            return out
        out.append(bgr[..., ::-1])


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mux", ["mp4", "mkv", "avi"])
@pytest.mark.parametrize("group", W.GROUPS)
def test_tool_group_matches_cv2(tmp_path, group, mux, seed):
    """A fresh stream of the group's random syntax (its other parameters
    drawn from the seed) decodes to cv2's frames."""
    clip = W.random_stream(1000 + 17 * seed + W.GROUPS.index(group), group, frames=4)
    path = tmp_path / f"random.{mux}"
    W.MUX[mux](path, clip)
    want = _cv2_frames(path)
    r = video.VideoReader(path)
    assert len(want) == len(r) == 4
    for i, w in enumerate(want):
        got = r.read(i)
        assert got.shape == w.shape
        d = np.abs(got.astype(np.int16) - w.astype(np.int16))
        assert d.max() <= FRAME_TOL, (group, mux, seed, i, int(d.max()))


@pytest.mark.parametrize("group", W.GROUPS)
def test_tool_group_out_of_decode_order(tmp_path, group):
    """The group's random syntax in HM's or x265's GOPs (pictures on both
    sides of B pictures in their lists, which list modification reorders),
    in Matroska, read in order and then with three seeks: cv2's frames. Between them
    the groups carry explicit weights and TMVP from list 1's collocated
    picture toward future references, and mvd_l1_zero_flag."""
    k = W.GROUPS.index(group)
    clip = W.random_stream(720 + k, group, frames=24, gop=("hm", "x265")[k % 2], lists_mod=True)
    b = [i for i in clip.info if i["type"] == 0]
    assert group == "intra" or any(i["mods"][1] is not None for i in b)
    if group == "weights":
        assert any(i["weights"] for i in b) and any(i["mvd_l1_zero"] for i in b)
        assert any(i["tmvp"] and not i["col_from_l0"] for i in b)
    path = tmp_path / "gop.mkv"
    W.write_mkv(path, clip)
    assert_reads(path, list(range(24)) + [23, 12, 3])


@pytest.mark.parametrize("kind", ["hm", "cra_first", "bla"])
def test_temporal_sub_layers_out_of_decode_order(tmp_path, kind):
    """HM's temporal sub-layers (each picture's depth in its GOP its
    TemporalId, so only anchors and IRAP pictures are prevTid0Pic) with a
    32-value POC LSB that wraps: read in order, backwards and shuffled,
    cv2's frames."""
    clip = W.random_stream(810 + ["hm", "cra_first", "bla"].index(kind), "inter", frames=48,
                           gop=kind, temporal=True, log2_max_poc_lsb=5)
    assert max(i["poc"] for i in clip.info) >= 32
    path = tmp_path / "temporal.mp4"
    W.write_mp4(path, clip)
    for o in orders(48, 1):
        assert_reads(path, o)


def test_real_encoder_stream_matches_cv2(tmp_path):
    """The writer's encoder on a fresh pan with sub-sample motion and a
    bottom crop: every frame is cv2's, and its reconstruction is what it
    meant (PSNR against the source well above noise)."""
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:56, 0:80].astype(np.float64)
    frames = []
    for i in range(4):
        img = np.stack([np.sin(0.11 * (xx + 2.25 * i) + 0.07 * yy + k) for k in range(3)], -1)
        frames.append(((img * 0.45 + 0.5) * 255 + rng.normal(0, 0, img.shape)).astype(np.uint8))
    clip = W.encode(frames, qp=26, crop=(0, 0, 0, 8), motion=[(0, 0)] + [(-9, 0)] * 3)
    path = tmp_path / "pan.mp4"
    W.write_mp4(path, clip)
    want = _cv2_frames(path)
    r = video.VideoReader(path)
    assert len(want) == 4
    for i, w in enumerate(want):
        got = r.read(i)
        np.testing.assert_array_equal(got, w)
        mse = ((got.astype(np.float64) - frames[i]) ** 2).mean()
        assert 10 * np.log10(255 ** 2 / mse) > 30


@pytest.mark.parametrize("feature", sorted(W.REFUSED))
def test_refuses_by_name(tmp_path, feature):
    """Each feature the decoder leaves out raises ValueError naming it."""
    clip = W.refused_clip(feature)
    path = tmp_path / "refused.mkv"
    W.write_mkv(path, clip)
    with pytest.raises(ValueError) as e:
        r = video.VideoReader(path)
        for i in range(len(clip.pictures)):
            r.read(i)
    msg = str(e.value.__cause__ or e.value)
    assert "HEVC with" in msg and W.REFUSED[feature] in msg and "is not supported" in msg


def test_fails_on_parameter_set_inside_a_picture(tmp_path):
    """A PPS written between two slices of one picture: a parameter set
    ends an access unit, so the second slice is malformed and the read
    raises ValueError rather than decode it under other parameters."""
    p = W.Params(width=64, height=48)
    sw = W.StreamWriter(p, W.RandomChooser(np.random.default_rng(0), p))
    n = sw.lay.nctb
    sw.picture(W.PicPlan(19, 0, 2, [W.Segment(0, n)]))
    sw.picture(W.PicPlan(1, 1, 1, [W.Segment(0, n // 2), W.Segment(n // 2, n - n // 2)],
                         rps=[(-1, 1)], num_ref=(1, 0)))
    clip = sw.clip()
    clip.pictures[1].insert(1, W.write_pps(p))
    path = tmp_path / "inside.mp4"
    W.write_mp4(path, clip)
    r = video.VideoReader(path)
    r.read(0)
    with pytest.raises(ValueError) as e:
        r.read(1)
    assert "a VPS, SPS or PPS NAL unit between two slices of one picture" in \
        str(e.value.__cause__ or e.value)


@pytest.mark.parametrize("missing", [0, 4])
@pytest.mark.parametrize("nal", [21, 16, 17], ids=["CRA", "BLA_W_LP", "BLA_W_RADL"])
def test_missing_references_hold_places_in_the_dpb(tmp_path, nal, missing):
    """An IRAP picture that starts the stream with pictures before it left
    in its RPS: FFmpeg makes a picture for each (generate_missing_ref),
    which holds a place of the DPB while the IRAP picture bumps, so with
    four of them (sps_max_dec_pic_buffering 4) the IRAP picture comes out
    before its RADL pictures; with none they come first."""
    p = W.Params(width=64, height=48, num_reorder=2, max_dec=4)
    sw = W.StreamWriter(p, W.RandomChooser(np.random.default_rng(nal), p))
    n = sw.lay.nctb
    sw.picture(W.PicPlan(nal, 8, 2, [W.Segment(0, n)],
                         rps=[(-k, 0) for k in range(5, 5 + missing)]))
    sw.picture(W.PicPlan(7, 6, 1, [W.Segment(0, n)], rps=[(2, 1)], num_ref=(1, 0)))
    sw.picture(W.PicPlan(6, 7, 0, [W.Segment(0, n)], rps=[(-1, 1), (1, 1)], num_ref=(1, 1)))
    sw.picture(W.PicPlan(1, 12, 1, [W.Segment(0, n)], rps=[(-4, 1)], num_ref=(1, 0)))
    sw.picture(W.PicPlan(0, 10, 1, [W.Segment(0, n)], rps=[(-2, 1), (2, 1)], num_ref=(1, 0)))
    path = tmp_path / "missing.mkv"
    W.write_mkv(path, sw.clip())
    want = _cv2_frames(path)
    r = video.VideoReader(path)
    assert len(want) == len(r) == 5
    tags = []
    for i, w in enumerate(want):
        np.testing.assert_array_equal(r.read(i), w)
        tags.append(r._dec.tag)
    assert tags == ([0, 1, 2, 4, 3] if missing else [1, 2, 0, 4, 3])


def test_fails_on_a_missing_reference_of_a_trailing_picture(tmp_path):
    """A P picture whose RPS keeps a picture the stream never had (not one
    it predicts from): FFmpeg fails the picture there ("Error constructing
    the frame RPS"), and so does the port."""
    p = W.Params(width=64, height=48)
    sw = W.StreamWriter(p, W.RandomChooser(np.random.default_rng(3), p))
    n = sw.lay.nctb
    sw.picture(W.PicPlan(19, 0, 2, [W.Segment(0, n)]))
    sw.picture(W.PicPlan(1, 4, 1, [W.Segment(0, n)], rps=[(-4, 1), (-5, 0)], num_ref=(1, 0)))
    path = tmp_path / "missing.mkv"
    W.write_mkv(path, sw.clip())
    assert len(_cv2_frames(path)) == 1
    r = video.VideoReader(path)
    r.read(0)
    with pytest.raises(ValueError) as e:
        r.read(1)
    assert "a reference picture is missing (POC -1)" in str(e.value.__cause__ or e.value)


def _p_picture(sw, poc, delta=-1):
    n = sw.lay.nctb
    sw.picture(W.PicPlan(1, poc, 1, [W.Segment(0, n)], rps=[(delta, 1)], num_ref=(1, 0)))


def test_fails_on_new_sps_within_a_sequence(tmp_path):
    """An SPS of another coded size (its output size kept by a right crop)
    sent in band before a P picture: the P picture would predict from
    references of the old size, so the read raises ValueError (FFmpeg
    forgets its references there)."""
    p = W.Params(width=64, height=48)
    sw = W.StreamWriter(p, W.RandomChooser(np.random.default_rng(0), p))
    sw.picture(W.PicPlan(19, 0, 2, [W.Segment(0, sw.lay.nctb)]))
    _p_picture(sw, 1)
    q = W.Params(width=64, height=48, crop=(0, 16, 0, 0))
    sw2 = W.StreamWriter(q, W.RandomChooser(np.random.default_rng(1), q))
    _p_picture(sw2, 2)
    clip = sw.clip()
    clip.pictures.append([sw2.sps, sw2.pps] + sw2.pictures[0])
    clip.sync.append(False)
    path = tmp_path / "new_sps.mkv"
    W.write_mkv(path, clip)
    r = video.VideoReader(path)
    r.read(0)
    with pytest.raises(ValueError) as e:
        for i in range(1, len(clip.pictures)):
            r.read(i)
    assert "a new SPS within a coded video sequence" in str(e.value.__cause__ or e.value)


def test_delayed_pictures_keep_their_sequence_crop_and_colour(tmp_path):
    """Two coded video sequences with an output delay, of one output size
    but another crop (bottom, then top) and another VUI range and matrix:
    the first sequence's last pictures come out after the second SPS is
    active. cv2 crops them and takes their range as their own SPS says,
    and their matrix from the active SPS."""
    rng = np.random.default_rng(7)
    seqs = [W.Params(width=64, height=48, crop=(0, 0, 0, 16), num_reorder=2, max_dec=6),
            W.Params(width=64, height=48, crop=(0, 0, 16, 0), num_reorder=2, max_dec=6,
                     vui=dict(full_range=1, matrix=1))]
    clip = None
    for p in seqs:
        sw = W.StreamWriter(p, W.RandomChooser(rng, p))
        sw.picture(W.PicPlan(19, 0, 2, [W.Segment(0, sw.lay.nctb)]))
        for poc in (1, 2, 3):
            _p_picture(sw, poc)
        c = sw.clip()
        if clip is None:
            clip = c
        else:
            clip.pictures += [[c.vps, c.sps, c.pps] + c.pictures[0]] + c.pictures[1:]
            clip.sync += c.sync
    path = tmp_path / "two_sequences.mkv"
    W.write_mkv(path, clip)
    want = _cv2_frames(path)
    r = video.VideoReader(path)
    assert len(want) == len(r) == 8
    for i, w in enumerate(want):
        np.testing.assert_array_equal(r.read(i), w)


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_transform_equals_plain(log2):
    """The compiled inverse DCT (and the 4x4 DST and transform skip) of
    random scaled coefficients, sparse and saturated, equals the plain one
    bit for bit."""
    rng = np.random.default_rng(log2)
    n = 1 << log2
    for t in range(40):
        c = rng.integers(-400, 400, (n, n)) * (rng.random((n, n)) < 0.2)
        if t % 10 == 0:
            c = rng.integers(-32768, 32768, (n, n))
        for trtype, skip in ([(0, False), (1, False), (0, True)] if log2 == 2 else [(0, False)]):
            np.testing.assert_array_equal(video.hevc_idct(c, log2, trtype, skip),
                                          video.hevc_idct_ref(c, log2, trtype, skip))


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
@pytest.mark.parametrize("weighted", [False, True], ids=["default", "explicit"])
def test_interpolation_equals_plain(chroma, weighted):
    """Uni- and bi-prediction of random blocks at every fraction, reaching
    past the plane's edges, with default or explicit weights."""
    rng = np.random.default_rng(2 * chroma + weighted)
    for _ in range(60):
        h, w = 24, 32
        p0 = rng.integers(0, 256, (h, w)).astype(np.uint8)
        p1 = rng.integers(0, 256, (h, w)).astype(np.uint8)
        mv = rng.integers(-96, 96, 4)
        pred = int(rng.integers(1, 4))
        bw, bh = int(rng.choice([4, 8, 16])), int(rng.choice([4, 8, 12, 16]))
        x, y = int(rng.integers(-12, w)), int(rng.integers(-12, h))
        wt = None
        if weighted:
            wt = (int(rng.integers(6, 14)), int(rng.integers(-128, 256)),
                  int(rng.integers(-128, 256)), int(rng.integers(-128, 128)),
                  int(rng.integers(-128, 128)))
        np.testing.assert_array_equal(
            video.hevc_mc(p0, p1, chroma, x, y, mv, pred, bw, bh, wt),
            video.hevc_mc_ref(p0, p1, chroma, x, y, mv, pred, bw, bh, wt))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_intra_equals_plain(log2):
    """All 35 modes of luma and chroma blocks from random and smooth
    references with random availability (substitution, filtering, strong
    smoothing, the edge filters)."""
    rng = np.random.default_rng(10 + log2)
    n = 1 << log2
    for mode in range(35):
        for _ in range(3):
            ref = rng.integers(0, 256, 4 * n + 1)
            if rng.random() < 0.5:
                ref = np.clip(100 + np.cumsum(rng.integers(-2, 3, 4 * n + 1)), 0, 255)
            av = rng.random(4 * n + 1) < rng.choice([0.0, 0.5, 1.0])
            c = int(rng.integers(0, 2))
            strong = bool(rng.random() < 0.7)
            np.testing.assert_array_equal(video.hevc_intra(ref, av, log2, c, mode, strong),
                                          video.hevc_intra_ref(ref, av, log2, c, mode, strong))


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_deblocking_edge_equals_plain(chroma):
    """One luma or chroma edge segment over every bS, QPs, offsets and kept
    sides, on steps the filters act on."""
    rng = np.random.default_rng(20 + chroma)
    for _ in range(400):
        base = int(rng.integers(40, 216))
        lines = np.clip(base + rng.integers(-6, 7, (4, 8)) +
                        np.array([0] * 4 + [1] * 4) * int(rng.integers(-24, 25)), 0, 255)
        args = (chroma, int(rng.integers(0, 3)), int(rng.integers(0, 52)), int(rng.integers(-6, 7)),
                int(rng.integers(-6, 7)), int(rng.integers(-12, 13)), bool(rng.random() < 0.1),
                bool(rng.random() < 0.1))
        np.testing.assert_array_equal(video.hevc_deblock(lines, *args),
                                      video.hevc_deblock_ref(lines, *args))


@pytest.mark.parametrize("typ", [1, 2], ids=["band", "edge"])
def test_sao_equals_plain(typ):
    """Band and edge offsets over blocks of every size to a CTB, with
    neighbours usable or not."""
    rng = np.random.default_rng(30 + typ)
    for _ in range(60):
        h, w = int(rng.integers(1, 33)), int(rng.integers(1, 33))
        pad = rng.integers(0, 256, (h + 2, w + 2)).astype(np.uint8)
        off = rng.integers(-7, 8, 4)
        args = (typ, int(rng.integers(0, 32)), int(rng.integers(0, 4)), off, rng.random(8) < 0.7)
        np.testing.assert_array_equal(video.hevc_sao(pad, *args), video.hevc_sao_ref(pad, *args))
