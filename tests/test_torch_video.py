"""Port parity of the video reader: ``data/containers.py`` and the C++
decoder of ``data/video.py`` against ``cv2.VideoCapture`` (OpenCV's FFmpeg
backend) and the JAX package's ``MP4Dataset``, on the committed fixtures
of ``tests/data/video`` (``make_fixtures.py``).

Every fixture's frames equal cv2's bit for bit (``FRAME_TOL`` is 0 for
every codec; ``digests.json`` records the measurement): MPEG-4 Part 2 in
MP4, MOV, AVI and Matroska (I- and P-VOPs over a GOP boundary, a size that
is not a multiple of 16, a single I-VOP, intra macroblocks in P-VOPs and
all three TCOEF escapes; and the test writer's Xvid clips: B-VOPs, packed
bitstreams, 4MV and AC prediction), Motion JPEG, H.264, VP9 and HEVC. The
MPEG-4 tools FFmpeg's encoder under cv2 never writes (AC prediction,
DQUANT, 4MV, MPEG quantisation, not-coded VOPs, B-VOPs, the encoders'
builds and their workarounds) are held against cv2 on the test writer's
streams in ``tests/test_torch_mpeg4.py``."""

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from mast3r_slam_tpu.data import datasets as JD  # noqa: E402
from mast3r_slam_tpu.utils import config as JCfg  # noqa: E402
from mast3r_slam_tpu_torch.data import containers, video  # noqa: E402
from mast3r_slam_tpu_torch.data import datasets as TD  # noqa: E402

FIXTURES = Path(__file__).resolve().parent / "data" / "video"
DIGESTS = json.loads((FIXTURES / "digests.json").read_text())
NAMES = sorted(DIGESTS)
# max |port - cv2| per codec, in LSB of the RGB frames (measured: 0)
FRAME_TOL = {"mp4v": 0, "XVID": 0, "MJPG": 0, "avc1": 0, "H264": 0, "VP90": 0,
             "vp09": 0, "hvc1": 0, "hev1": 0}
RNG = np.random.default_rng(22)


def _cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            return out
        out.append(bgr[..., ::-1])


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.fixture
def jax_config():
    saved = dict(JCfg.config)
    JCfg.config.clear()
    JCfg.config.update({"dataset": {"img_size": 512}, "use_calib": False})
    yield {"dataset": {"img_size": 512}, "use_calib": False}
    JCfg.config.clear()
    JCfg.config.update(saved)


def _subsample(cfg, k):
    JCfg.config["dataset"]["subsample"] = k
    return {**cfg, "dataset": {**cfg["dataset"], "subsample": k}}


def _same_dataset(dt, dj, path, cfg):
    """As tests/test_torch_data.py's: the same length, timestamps, frames
    and model crop. The crop is read from fresh readers: cv2 cannot seek
    back to frame 0 of a one-frame file, so the JAX reader that has read
    it cannot read it again (the port's can)."""
    assert type(dt).__name__ == type(dj).__name__
    assert len(dt) == len(dj)
    np.testing.assert_array_equal(np.asarray(dt.timestamps),
                                  np.asarray(dj.timestamps))
    for i in range(len(dj)):
        try:
            tj, ij = dj[i]
        except ValueError as e:  # a frame cv2 does not read: the same failure
            with pytest.raises(ValueError) as got:
                dt[i]
            assert str(got.value) == str(e)
            continue
        tt, it = dt[i]
        assert tt == tj and it.dtype == np.float32 and it.shape == ij.shape
        np.testing.assert_array_equal(it, ij)
    assert dt.get_img_shape() == TD.load_dataset(path, cfg).get_img_shape() \
        == JD.load_dataset(path).get_img_shape()


@pytest.mark.parametrize("name", NAMES)
def test_container_matches_cv2(name):
    """fps, frame count and size as cv2 reports them (Matroska's count
    from its duration), and the digests' record of them."""
    path = FIXTURES / name
    t = containers.open_track(path)
    cap = cv2.VideoCapture(str(path))
    assert t.fps == cap.get(cv2.CAP_PROP_FPS) == DIGESTS[name]["fps"]
    assert t.frame_count == cap.get(cv2.CAP_PROP_FRAME_COUNT) \
        == DIGESTS[name]["frame_count"]
    assert [t.height, t.width] == DIGESTS[name]["hw"]
    assert t.fourcc == DIGESTS[name]["fourcc"]
    assert len(t.sizes) == t.frame_count and t.sync[0]


@pytest.mark.parametrize("name", NAMES)
def test_frames_match_cv2_and_digests(name):
    """Every frame as cv2 decodes it, within FRAME_TOL (0: bit for bit),
    and at the digests recorded beside the fixtures (what chip_smoke.py's
    video phase checks on the card machine); where the file's last
    pictures are not put out, cv2 reads fewer frames than its count, and
    the port fails to read the rest as cv2 does."""
    rec = DIGESTS[name]
    want = _cv2_frames(FIXTURES / name)
    assert len(rec["frames"]) == rec["frame_count"]
    assert len(want) == sum(f is not None for f in rec["frames"])
    r = video.VideoReader(FIXTURES / name)
    for i, w in enumerate(want):
        got = r.read(i)
        assert got.shape == w.shape and got.dtype == np.uint8
        d = np.abs(got.astype(np.int16) - w.astype(np.int16))
        assert d.max() <= FRAME_TOL[rec["fourcc"]], (name, i, d.max())
        assert _sha(w) == rec["frames"][i]["cv2"]
        assert _sha(got) == rec["frames"][i]["port"]
    for i in range(len(want), rec["frame_count"]):
        with pytest.raises(ValueError, match=f"failed to decode frame {i} of "):
            r.read(i)


@pytest.mark.parametrize("name", NAMES)
def test_dataset_matches_jax(name, jax_config):
    """load_dataset gives MP4Dataset with the JAX reader's length,
    timestamps (exact), fps, frames and model crop."""
    path = str(FIXTURES / name)
    dt, dj = TD.load_dataset(path, jax_config), JD.load_dataset(path)
    assert isinstance(dt, TD.MP4Dataset)
    assert dt.fps == dj.fps
    _same_dataset(dt, dj, path, jax_config)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("name", ["mp4v.mov", "mp4v.mkv", "xvid.avi"])
def test_subsample_matches_jax(name, k, jax_config):
    """Strides whose seeks cross the GOP boundary at frame 12."""
    cfg = _subsample(jax_config, k)
    path = str(FIXTURES / name)
    dt, dj = TD.load_dataset(path, cfg), JD.load_dataset(path)
    assert dt.stride == dj.stride == k
    _same_dataset(dt, dj, path, cfg)


@pytest.mark.parametrize("name", ["mp4v.mov", "mp4v.mkv", "xvid.avi",
                                  "mjpg.avi"])
def test_out_of_order_reads_match_jax(name, jax_config):
    path = str(FIXTURES / name)
    dt, dj = TD.load_dataset(path, jax_config), JD.load_dataset(path)
    for i in (13, 2, 14, 12, 11, 0, 7):
        if i < len(dj):
            (tt, it), (tj, ij) = dt[i], dj[i]
            assert tt == tj
            np.testing.assert_array_equal(it, ij)


def test_truncated_clip_raises_the_jax_message(tmp_path, jax_config):
    """A Matroska file cut inside frame 14's data: both readers report 16
    frames, read 13, and raise the same message for 14 and 15."""
    src = FIXTURES / "mp4v.mkv"
    t = containers.open_track(src)
    path = tmp_path / "cut.mkv"
    path.write_bytes(src.read_bytes()[:int(t.offsets[14] + t.sizes[14] // 2)])
    dt, dj = TD.load_dataset(str(path), jax_config), JD.load_dataset(str(path))
    assert len(dt) == len(dj) == 16
    np.testing.assert_array_equal(dt[13][1], dj[13][1])
    for i in (14, 15):
        with pytest.raises(ValueError) as want:
            dj[i]
        with pytest.raises(ValueError) as got:
            dt[i]
        assert str(got.value) == str(want.value) == \
            f"failed to decode frame {i} of {path}"


def test_unopenable_path_matches_jax(tmp_path, jax_config):
    """A missing file: cv2 cannot open it, and both readers report what an
    unopened capture gives (-1 frames at -1 fps, no timestamps, len
    raising)."""
    path = str(tmp_path / "missing.mp4")
    dt, dj = TD.load_dataset(path, jax_config), JD.load_dataset(path)
    assert (dt.total_frames, dt.fps) == (dj.total_frames, dj.fps) == (-1, -1.0)
    assert len(dt.timestamps) == len(dj.timestamps) == 0
    for ds in (dt, dj):
        with pytest.raises(ValueError):
            len(ds)


def _edit(tmp_path, name, old, new, count=1, after=0):
    data = bytearray((FIXTURES / name).read_bytes())
    i = data.index(old, after)
    for _ in range(count - 1):
        i = data.index(old, i + 1)
    data[i:i + len(new)] = new
    path = tmp_path / f"edited_{name}"
    path.write_bytes(bytes(data))
    return path


def test_refuses_other_codecs_by_name(tmp_path, jax_config):
    """An MP4 whose sample entry says av01 (AV1): the codec is named."""
    path = _edit(tmp_path, "mp4v_one.mp4", b"mp4v", b"av01")
    with pytest.raises(ValueError, match="'av01'"):
        TD.load_dataset(str(path), jax_config)


class _Bits:
    def __init__(self, data):
        self.bits = "".join(f"{b:08b}" for b in data)
        self.pos = 0

    def take(self, n):
        v = self.bits[self.pos:self.pos + n]
        self.pos += n
        return v


def _vol_with_quarter_sample(vol: bytes) -> bytes:
    """The VOL (from its start code on) rewritten at the same length: the
    layer identifier's version 1 -> 2, vol_control_parameters dropped (4
    bits), and the version-2 fields added (2-bit sprite_enable,
    quarter_sample = 1, newpred and reduced-resolution flags: 4 bits)."""
    b = _Bits(vol[4:])
    head = b.take(1 + 8)
    assert b.take(1) == "1"            # is_object_layer_identifier
    b.take(4 + 3)
    aspect = b.take(4)
    assert b.take(1) == "1"            # vol_control_parameters
    b.take(2 + 1 + 1)                  # chroma, low_delay, vbv = 0
    mid = b.take(2 + 1 + 16 + 1 + 1 + 1 + 13 + 1 + 13 + 1 + 1 + 1)
    assert b.take(1) == "0"            # sprite_enable (version 1)
    not8, quant = b.take(1), b.take(1)
    assert quant == "0"
    tail = b.take(1 + 1 + 1)           # complexity, resync, partitioning
    assert b.take(1) == "0"            # scalability
    bits = (head + "1" + "0010" + "001" + aspect + "0" + mid + "00" + not8
            + quant + "1" + tail + "0" + "0" + "0")
    assert len(bits) == b.pos
    bits += b.bits[b.pos:]
    return vol[:4] + bytes(int(bits[i:i + 8], 2)
                           for i in range(0, len(bits), 8))


def test_refuses_quarter_pel_by_name(tmp_path):
    """The MP4's VOL (in its esds) with quarter_sample set."""
    data = (FIXTURES / "mp4v_one.mp4").read_bytes()
    i = data.index(b"\x00\x00\x01\x20")
    j = data.index(b"\x00\x00\x01", i + 4)
    path = tmp_path / "qpel.mp4"
    path.write_bytes(data[:i] + _vol_with_quarter_sample(data[i:j])
                     + data[j:])
    with pytest.raises(ValueError, match="quarter-pel"):
        video.VideoReader(path).read(0)


def test_refuses_b_vops_by_name(tmp_path, jax_config):
    """The first P-VOP of an AVI marked a B-VOP. B-VOPs are decoded (no
    longer refused), but this one comes before the stream has two
    references, and FFmpeg skips such a B-VOP: no frame for its sample, so
    frame 1 is the P-VOP after it (predicted from the I-VOP) and the last
    frame the container counts cannot be read. Both readers give cv2's 15
    frames and raise the JAX reader's message for frame 15."""
    data = bytearray((FIXTURES / "xvid.avi").read_bytes())
    i = data.index(b"\x00\x00\x01\xb6")
    i = data.index(b"\x00\x00\x01\xb6", i + 4)  # frame 1's VOP
    assert data[i + 4] >> 6 == 1                 # a P-VOP
    data[i + 4] = (data[i + 4] & 0x3F) | (2 << 6)
    path = tmp_path / "bvop.avi"
    path.write_bytes(bytes(data))
    want = _cv2_frames(path)
    assert len(want) == 15
    r = video.VideoReader(path)
    for k, w in enumerate(want):
        np.testing.assert_array_equal(r.read(k), w)
    dt, dj = TD.load_dataset(str(path), jax_config), JD.load_dataset(str(path))
    assert len(dt) == len(dj) == 16
    for k in range(15):
        np.testing.assert_array_equal(dt[k][1], dj[k][1])
    for ds in (dj, dt):
        with pytest.raises(ValueError, match=f"failed to decode frame 15 of {path}"):
            ds[15]


def test_avi_opendml_index(tmp_path):
    """An AVI whose samples are found through an OpenDML super index (its
    idx1 renamed away, the ``indx`` written over strl's reserved JUNK, one
    ``ix00`` standard index appended): the frames and counts of the
    idx1 read."""
    import struct

    src = FIXTURES / "xvid.avi"
    t = containers.open_track(src)
    data = bytearray(src.read_bytes())
    n = len(t.sizes)
    ix = struct.pack("<HBBI4sQI", 2, 0, 1, n, b"00dc", 0, 0) + b"".join(
        struct.pack("<II", int(o), int(z) | (0 if k else 0x80000000))
        for o, z, k in zip(t.offsets, t.sizes, t.sync))
    ix_at = len(data)
    data += b"ix00" + struct.pack("<I", len(ix)) + ix
    junk = data.index(b"JUNK", data.index(b"strf"))
    size = struct.unpack("<I", data[junk + 4:junk + 8])[0]
    indx = struct.pack("<HBBI4s12xQII", 4, 0, 0, 1, b"00dc", ix_at,
                       len(ix) + 8, n)
    data[junk:junk + 8 + size] = (b"indx" + struct.pack("<I", size) + indx
                                  + bytes(size - len(indx)))
    i = data.rindex(b"idx1")
    data[i:i + 4] = b"JUNK"
    path = tmp_path / "odml.avi"
    path.write_bytes(bytes(data))
    t2 = containers.open_track(path)
    assert (t2.fps, t2.frame_count) == (t.fps, t.frame_count)
    np.testing.assert_array_equal(t2.offsets, t.offsets)
    np.testing.assert_array_equal(t2.sync, t.sync)
    r = video.VideoReader(path)
    for i, want in enumerate(_cv2_frames(src)):
        np.testing.assert_array_equal(r.read(i), want)


def test_refusals_of_the_containers(tmp_path):
    bad = tmp_path / "clip.mp4"
    bad.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="not an MP4/MOV, AVI or Matroska"):
        containers.open_track(bad)
    t = containers.open_track(FIXTURES / "mjpg.mkv")
    data = bytearray((FIXTURES / "mjpg.mkv").read_bytes())
    data[int(t.offsets[0]) - 1] |= 0x02  # the first SimpleBlock Xiph-laced
    laced = tmp_path / "laced.mkv"
    laced.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="laced blocks"):
        containers.open_track(laced)
    cut = tmp_path / "cut.mp4"  # moov comes after mdat in cv2's files
    cut.write_bytes((FIXTURES / "mp4v.mov").read_bytes()[:3000])
    with pytest.raises(ValueError, match="no complete moov"):
        containers.open_track(cut)


def test_av_reduce():
    assert containers.av_reduce(1_000_000_000, 33_333_333, 30000) == 30
    assert containers.av_reduce(30000, 1001, 60000) * 1001 == 30000
    assert containers.av_reduce(15360 * 16, 8192, 2**31 - 1) == 30


# ---------------------------------------------------------------------------
# The compiled arithmetic against its plain numpy versions
# ---------------------------------------------------------------------------

def _lib():
    return video.load_library()


def _ptr(a, ctype):
    import ctypes
    return a.ctypes.data_as(ctypes.POINTER(ctype))


@pytest.mark.parametrize("add", [0, 1])
def test_idct_matches_plain(add):
    import ctypes
    lib = _lib()
    for trial in range(400):
        blk = np.zeros(64, np.int16)
        kind = trial % 4
        if kind == 0:    # DC only rows (the row pass's shortcut)
            blk[::8] = RNG.integers(-2048, 2048, 8)
        elif kind == 1:  # sparse, as a quantized block is
            k = RNG.integers(1, 10)
            blk[RNG.integers(0, 64, k)] = RNG.integers(-300, 300, k)
        elif kind == 2:  # dense, large
            blk[:] = RNG.integers(-2048, 2048, 64)
        else:
            blk[0] = RNG.integers(-4096, 4096)
        base = RNG.integers(0, 256, 64).astype(np.uint8)
        dst = base.copy()
        lib.vd_idct(_ptr(blk, ctypes.c_int16), add, _ptr(dst, ctypes.c_uint8))
        res = video.simple_idct_ref(blk).reshape(-1)
        want = np.clip(base.astype(np.int64) * add + res, 0, 255)
        np.testing.assert_array_equal(dst, want.astype(np.uint8))


def test_hpel_matches_plain():
    import ctypes
    lib = _lib()
    plane = RNG.integers(0, 256, (40, 56)).astype(np.uint8)
    for trial in range(300):
        n = 16 if trial % 2 else 8
        x, y = RNG.integers(-30, 70), RNG.integers(-30, 50)
        dxy, rnd = trial % 4, (trial // 4) % 2
        dst = np.zeros((n, n), np.uint8)
        lib.vd_hpel(_ptr(plane, ctypes.c_uint8), 56, 56, 40, int(x), int(y),
                    dxy, rnd, n, _ptr(dst, ctypes.c_uint8))
        np.testing.assert_array_equal(
            dst, video.hpel_ref(plane, int(x), int(y), dxy, rnd, n))


@pytest.mark.parametrize("full_range", [False, True])
def test_converter_matches_plain(full_range):
    h, w = 46, 62
    y = RNG.integers(0, 256, (h, w)).astype(np.uint8)
    cb = RNG.integers(0, 256, ((h + 1) // 2, (w + 1) // 2)).astype(np.uint8)
    cr = RNG.integers(0, 256, ((h + 1) // 2, (w + 1) // 2)).astype(np.uint8)
    np.testing.assert_array_equal(video.yuv_to_rgb(y, cb, cr, full_range),
                                  video.yuv_to_rgb_ref(y, cb, cr, full_range))


@pytest.mark.parametrize("name", ["mp4v_152x104.mp4", "mjpg.mkv"])
def test_decoded_planes_convert_as_plain(name):
    """The decoder's own frames: the plain converter on its planes gives
    the RGB it returns (limited range for MPEG-4, full for MJPEG)."""
    r = video.VideoReader(FIXTURES / name)
    for i in range(len(r)):
        y, cb, cr = r.planes(i)
        np.testing.assert_array_equal(
            r.read(i), video.yuv_to_rgb_ref(y, cb, cr, r.codec == video.MJPEG))


def test_decoder_on_bare_samples():
    """The Decoder takes the samples a demuxer hands it: a JPEG as one
    MJPEG frame (what chip_smoke.py times at 480x640), and the MPEG-4
    samples after the VOL in the container's extradata."""
    t = containers.open_track(FIXTURES / "mjpg.avi")
    with open(FIXTURES / "mjpg.avi", "rb") as f:
        f.seek(int(t.offsets[3]))
        frame = f.read(int(t.sizes[3]))
    dec = video.Decoder(video.MJPEG)
    dec.decode(frame)
    np.testing.assert_array_equal(dec.rgb(), _cv2_frames(FIXTURES
                                                         / "mjpg.avi")[3])
    t = containers.open_track(FIXTURES / "mp4v.mov")
    dec = video.Decoder(video.MPEG4, t.extradata)
    want = _cv2_frames(FIXTURES / "mp4v.mov")
    with open(FIXTURES / "mp4v.mov", "rb") as f:
        for k in range(3):
            f.seek(int(t.offsets[k]))
            dec.decode(f.read(int(t.sizes[k])))
            np.testing.assert_array_equal(dec.rgb(), want[k])
    with pytest.raises(ValueError, match="without a VOP"):
        dec.decode(b"\x00\x00\x01\xb3\x00\x00")


def test_reader_is_not_a_fallback(tmp_path, monkeypatch):
    """Without the compiled decoder, opening a video raises."""
    monkeypatch.setattr(video, "_lib", None)
    monkeypatch.setattr(video, "_BUILD", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++
    shutil.rmtree(tmp_path / "build", ignore_errors=True)
    with pytest.raises(RuntimeError, match="video decoder"):
        video.VideoReader(FIXTURES / "mp4v_one.mp4")
