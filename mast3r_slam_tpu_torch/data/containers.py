"""Video containers: the demuxers of the video reader (``data/video.py``).

Three demuxers, each returning the first video track of a file as a
:class:`Track`: ISO-BMFF (``.mp4``, ``.mov``; ``moov`` before or after
``mdat``), RIFF AVI (``idx1``, else the OpenDML ``indx``) and Matroska
(``.mkv``; an EBML walk of ``Segment/Info/Tracks/Cluster`` with
``SimpleBlock`` and ``BlockGroup``). Any other layout, and laced Matroska
blocks, raise ``ValueError`` naming what they are.

A track's ``fps`` and ``frame_count`` are what OpenCV's FFmpeg backend
reports as ``CAP_PROP_FPS`` and ``CAP_PROP_FRAME_COUNT``: the stream's
average frame rate as FFmpeg's demuxer derives it (MP4: the sample count
over the ``stts`` duration; AVI: ``dwRate / dwScale``; Matroska: 1e9 over
``DefaultDuration``, reduced as ``av_reduce`` reduces it), and the
stream's frame count where the container has one (MP4: the ``stts``
samples; AVI: ``strh.dwLength``), else the duration times the frame rate,
rounded (Matroska's ``Info/Duration``).

A track also gives each sample's presentation time where the container
has one, which a reader of B pictures needs to number frames as OpenCV
does: MP4 the ``stts`` decode times plus the ``ctts`` offsets (version 0,
or version 1 with negative offsets), moved by a one-entry ``elst`` edit;
Matroska the block timecodes. AVI has none (samples in decode order).
For an MP4 H.264 track with ``ctts``, ``video_delay`` is the reorder depth
FFmpeg's demuxer estimates from them (``mov_estimate_video_delay``), where
its decoder's reorder buffer starts.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
from fractions import Fraction

import numpy as np


@dataclasses.dataclass
class Track:
    """A video track: its codec, size, headers and samples.

    ``fourcc`` names the codec as the container does (``mp4v``, ``XVID``,
    ``VP90`` (Matroska's ``V_VP9``, AVI), ``vp09`` (MP4),
    ``MJPG``, ``avc1``, ``hvc1`` (MP4's and Matroska's HEVC), ...);
    ``extradata`` holds the decoder headers the container keeps apart from
    the samples (MP4 ``esds``' DecoderSpecificInfo, ``avcC`` or ``hvcC``,
    Matroska ``CodecPrivate``, AVI ``strf`` bytes
    past the BITMAPINFOHEADER), empty where they are in-band. Sample ``i``
    is ``sizes[i]`` bytes at file offset ``offsets[i]``; ``sync[i]`` marks
    the samples a decoder may start from."""

    fourcc: str
    width: int
    height: int
    extradata: bytes
    offsets: np.ndarray
    sizes: np.ndarray
    sync: np.ndarray
    fps: float
    frame_count: int
    # each sample's presentation time in units of time_base seconds, or
    # None; MP4 also its decode time from the stts (OpenCV's seek finds
    # an MP4 track's sync sample by these, from 0);
    # and the reorder depth the demuxer estimates (MP4)
    pts: np.ndarray = None
    time_base: Fraction = None
    video_delay: int = 0
    dts: np.ndarray = None
    # the codec tag FFmpeg's demuxer hands the decoder, where it is not
    # ``fourcc``: "" for a Matroska codec ID (no tag); and an AVI stream
    # header's handler (strh fccHandler), which FFmpeg's AVI demuxer makes
    # the tag of an MPEG-4 stream when it says XVID
    codec_tag: str = None
    handler: str = ""


def av_reduce(num: int, den: int, limit: int) -> Fraction:
    """FFmpeg's ``av_reduce``: num / den, or its best continued-fraction
    approximation with numerator and denominator at most ``limit``."""
    g = math.gcd(num, den)
    if g:
        num, den = num // g, den // g
    if num <= limit and den <= limit:
        return Fraction(num, den) if den else Fraction(0)
    a0n, a0d, a1n, a1d = 0, 1, 1, 0
    while den:
        x = num // den
        nxt = num - den * x
        a2n, a2d = x * a1n + a0n, x * a1d + a0d
        if a2n > limit or a2d > limit:
            if a1n:
                x = (limit - a0n) // a1n
            if a1d:
                x = min(x, (limit - a0d) // a1d)
            if den * (2 * x * a1d + a0d) > num * a1d:
                a1n, a1d = x * a1n + a0n, x * a1d + a0d
            break
        a0n, a0d, a1n, a1d = a1n, a1d, a2n, a2d
        num, den = den, nxt
    return Fraction(a1n, a1d)


def open_track(path) -> Track:
    """The first video track of the file at ``path``; ``ValueError`` for a
    layout this module does not read, ``OSError`` where the file cannot be
    read."""
    with open(path, "rb") as f:
        head = f.read(12)
        size = os.fstat(f.fileno()).st_size
        if head[:4] == b"RIFF" and head[8:12] in (b"AVI ", b"AVIX"):
            return _avi(f, size)
        if head[:4] == b"\x1a\x45\xdf\xa3":
            return _matroska(f, size)
        if head[4:8] in (b"ftyp", b"moov", b"mdat", b"free", b"wide",
                         b"skip", b"pnot"):
            return _isobmff(f, size)
    raise ValueError(f"{path}: not an MP4/MOV, AVI or Matroska file "
                     f"(first bytes {head[:12].hex()})")


# ---------------------------------------------------------------------------
# ISO-BMFF (.mp4, .mov)
# ---------------------------------------------------------------------------

def _boxes(buf: bytes, start: int, end: int):
    i = start
    while i + 8 <= end:
        sz, typ = struct.unpack(">I4s", buf[i:i + 8])
        hdr = 8
        if sz == 1:
            sz = struct.unpack(">Q", buf[i + 8:i + 16])[0]
            hdr = 16
        elif sz == 0:
            sz = end - i
        if sz < hdr or i + sz > end:
            raise ValueError(f"MP4: bad {typ!r} box size {sz}")
        yield typ, i + hdr, i + sz
        i += sz


def _child(buf, start, end, typ):
    for t, s, e in _boxes(buf, start, end):
        if t == typ:
            return s, e
    return None


def _descriptor(buf, i):
    """An MPEG-4 descriptor at i: (tag, payload start, payload end)."""
    tag = buf[i]
    i += 1
    n = 0
    for _ in range(4):
        b = buf[i]
        i += 1
        n = (n << 7) | (b & 0x7F)
        if not b & 0x80:
            break
    return tag, i, i + n


def _esds_dsi(buf, s, e) -> bytes:
    """The DecoderSpecificInfo of an ``esds`` box (the VOS/VOL headers)."""
    tag, ps, pe = _descriptor(buf, s + 4)
    if tag != 3:
        raise ValueError("MP4: esds without an ES descriptor")
    flags = buf[ps + 2]
    i = ps + 3
    if flags & 0x80:
        i += 2
    if flags & 0x40:
        i += 1 + buf[i]
    if flags & 0x20:
        i += 2
    tag, ds, de = _descriptor(buf, i)
    if tag != 4:
        raise ValueError("MP4: esds without a decoder config descriptor")
    i = ds + 13
    while i < de:
        tag, ss, se = _descriptor(buf, i)
        if tag == 5:
            return bytes(buf[ss:se])
        i = se
    return b""


def _isobmff(f, size) -> Track:
    # the top-level boxes, read header by header; moov whole
    moov = None
    pos = 0
    while pos + 8 <= size:
        f.seek(pos)
        hdr = f.read(16)
        sz, typ = struct.unpack(">I4s", hdr[:8])
        if sz == 1:
            sz = struct.unpack(">Q", hdr[8:16])[0]
        elif sz == 0:
            sz = size - pos
        if sz < 8:
            raise ValueError(f"MP4: bad top-level box size {sz}")
        if typ == b"moov":
            f.seek(pos)
            moov = f.read(sz)
            break
        pos += sz
    if moov is None or len(moov) < 8:
        raise ValueError("MP4: no complete moov box")
    buf = moov
    body = 16 if struct.unpack(">I", buf[:4])[0] == 1 else 8
    for typ, ts, te in _boxes(buf, body, len(buf)):
        if typ != b"trak":
            continue
        mdia = _child(buf, ts, te, b"mdia")
        if mdia is None:
            continue
        hdlr = _child(buf, *mdia, b"hdlr")
        if hdlr is None or buf[hdlr[0] + 8:hdlr[0] + 12] != b"vide":
            continue
        return _mp4_track(buf, mdia, (ts, te))
    raise ValueError("MP4: no video track")


def _mp4_track(buf, mdia, trak) -> Track:
    mdhd = _child(buf, *mdia, b"mdhd")
    ver = buf[mdhd[0]]
    timescale = struct.unpack(">I", buf[mdhd[0] + (20 if ver == 1 else 12):][:4])[0]
    stbl = None
    minf = _child(buf, *mdia, b"minf")
    if minf is not None:
        stbl = _child(buf, *minf, b"stbl")
    if stbl is None:
        raise ValueError("MP4: video track without a sample table")
    box = {t: (s, e) for t, s, e in _boxes(buf, *stbl)}
    for need in (b"stsd", b"stsz", b"stsc", b"stts"):
        if need not in box:
            raise ValueError(f"MP4: sample table without {need.decode()}")
    s, e = box[b"stsd"]
    if struct.unpack(">I", buf[s + 4:s + 8])[0] < 1:
        raise ValueError("MP4: empty sample description")
    ent = s + 8
    esz, fourcc = struct.unpack(">I4s", buf[ent:ent + 8])
    width, height = struct.unpack(">HH", buf[ent + 32:ent + 36])
    extradata = b""
    esds = _child(buf, ent + 86, ent + esz, b"esds")
    if esds is not None:
        extradata = _esds_dsi(buf, *esds)
    avcc = _child(buf, ent + 86, ent + esz, b"avcC")
    if avcc is not None:  # H.264: the AVCDecoderConfigurationRecord
        extradata = bytes(buf[avcc[0]:avcc[1]])
    hvcc = _child(buf, ent + 86, ent + esz, b"hvcC")
    if hvcc is not None:  # HEVC: the HEVCDecoderConfigurationRecord
        extradata = bytes(buf[hvcc[0]:hvcc[1]])

    s, _ = box[b"stsz"]
    fixed, count = struct.unpack(">II", buf[s + 4:s + 12])
    sizes = (np.full(count, fixed, np.int64) if fixed else
             np.frombuffer(buf, ">u4", count, s + 12).astype(np.int64))
    if b"stco" in box:
        s, _ = box[b"stco"]
        n = struct.unpack(">I", buf[s + 4:s + 8])[0]
        chunks = np.frombuffer(buf, ">u4", n, s + 8).astype(np.int64)
    elif b"co64" in box:
        s, _ = box[b"co64"]
        n = struct.unpack(">I", buf[s + 4:s + 8])[0]
        chunks = np.frombuffer(buf, ">u8", n, s + 8).astype(np.int64)
    else:
        raise ValueError("MP4: sample table without stco or co64")
    s, _ = box[b"stsc"]
    n = struct.unpack(">I", buf[s + 4:s + 8])[0]
    stsc = np.frombuffer(buf, ">u4", 3 * n, s + 8).reshape(n, 3)
    offsets = np.empty(count, np.int64)
    k = 0
    for j in range(n):
        first = int(stsc[j, 0]) - 1
        last = int(stsc[j + 1, 0]) - 1 if j + 1 < n else len(chunks)
        per = int(stsc[j, 1])
        for c in range(first, last):
            off = chunks[c]
            for _ in range(per):
                if k >= count:
                    break
                offsets[k] = off
                off += sizes[k]
                k += 1
    if k != count:
        raise ValueError("MP4: chunk table does not cover the samples")
    sync = np.ones(count, bool)
    if b"stss" in box:
        s, _ = box[b"stss"]
        n = struct.unpack(">I", buf[s + 4:s + 8])[0]
        sync[:] = False
        idx = np.frombuffer(buf, ">u4", n, s + 8).astype(np.int64) - 1
        sync[idx[(idx >= 0) & (idx < count)]] = True
    s, _ = box[b"stts"]
    n = struct.unpack(">I", buf[s + 4:s + 8])[0]
    stts = np.frombuffer(buf, ">u4", 2 * n, s + 8).reshape(n, 2).astype(np.int64)
    frames = int(stts[:, 0].sum())
    duration = int((stts[:, 0] * stts[:, 1]).sum())
    fps = float(av_reduce(timescale * frames, duration, 2**31 - 1)) if duration else 0.0
    dts = np.concatenate([[0], np.cumsum(np.repeat(stts[:, 1], stts[:, 0]))])[:count]
    pts, delay = dts.copy(), 0
    if b"ctts" in box:
        s, _ = box[b"ctts"]
        n = struct.unpack(">I", buf[s + 4:s + 8])[0]
        ctts = np.frombuffer(buf, ">i4" if buf[s] else ">u4", 2 * n,
                             s + 8).reshape(n, 2).astype(np.int64)
        off = np.repeat(ctts[:, 1], ctts[:, 0].astype(np.int64))[:count]
        pts[:len(off)] += off
        if fourcc in (b"avc1", b"avc3"):
            delay = _reorder_depth(pts)
    edit = _mp4_edit(buf, trak)
    return Track(fourcc.decode("latin-1"), width, height, extradata, offsets,
                 sizes, sync, fps, frames, pts - edit, Fraction(1, timescale), delay,
                 dts)


def _reorder_depth(pts) -> int:
    """FFmpeg's mov_estimate_video_delay: the most samples among the 16
    before one whose presentation time is later than its."""
    depth = 0
    for i in range(len(pts)):
        depth = max(depth, int((pts[max(0, i - 16):i] > pts[i]).sum()))
    return depth


def _mp4_edit(buf, trak) -> int:
    """The media time at which a one-entry edit list (``trak/edts/elst``)
    starts the track, by which FFmpeg moves its timestamps; 0 without."""
    edts = _child(buf, *trak, b"edts")
    elst = edts and _child(buf, *edts, b"elst")
    if not elst:
        return 0
    s = elst[0]
    ver = buf[s]
    if struct.unpack(">I", buf[s + 4:s + 8])[0] != 1:
        return 0
    media = struct.unpack_from(">q" if ver == 1 else ">i", buf, s + (16 if ver == 1 else 12))[0]
    return max(int(media), 0)


# ---------------------------------------------------------------------------
# RIFF AVI
# ---------------------------------------------------------------------------

def _riff_chunks(buf, start, end):
    i = start
    while i + 8 <= end:
        cid, sz = struct.unpack("<4sI", buf[i:i + 8])
        yield cid, i + 8, min(i + 8 + sz, end)
        i += 8 + sz + (sz & 1)


def _avi(f, size) -> Track:
    f.seek(0)
    riff = f.read(12)
    end = min(8 + struct.unpack("<I", riff[4:8])[0], size)
    # the RIFF's top-level chunks: hdrl and idx1 read, movi located
    hdrl = idx1 = None
    movi = None
    pos = 12
    while pos + 8 <= end:
        f.seek(pos)
        cid, sz = struct.unpack("<4sI", f.read(8))
        if cid == b"LIST":
            kind = f.read(4)
            if kind == b"hdrl":
                hdrl = f.read(sz - 4)
            elif kind == b"movi":
                movi = pos + 8  # the 'movi' fourcc
        elif cid == b"idx1":
            idx1 = f.read(sz)
        pos += 8 + sz + (sz & 1)
    if hdrl is None or movi is None:
        raise ValueError("AVI: no hdrl or movi list")
    stream = 0
    for cid, s, e in _riff_chunks(hdrl, 0, len(hdrl)):
        if cid != b"LIST" or hdrl[s:s + 4] != b"strl":
            continue
        info = {c: (cs, ce) for c, cs, ce in _riff_chunks(hdrl, s + 4, e)}
        strh = hdrl[info[b"strh"][0]:info[b"strh"][1]]
        if strh[:4] == b"vids":
            return _avi_track(f, hdrl, info, stream, idx1, movi)
        stream += 1
    raise ValueError("AVI: no video stream")


def _avi_track(f, hdrl, info, stream, idx1, movi) -> Track:
    strh = hdrl[info[b"strh"][0]:info[b"strh"][1]]
    scale, rate, _start, length = struct.unpack("<IIII", strh[20:36])
    s, e = info[b"strf"]
    strf = hdrl[s:e]
    width, height = struct.unpack("<ii", strf[4:12])
    fourcc = strf[16:20].decode("latin-1")
    extradata = bytes(strf[40:]) if len(strf) > 40 else b""
    tag = b"%02d" % stream
    if idx1 is not None:
        ent = np.frombuffer(idx1, "<u4", len(idx1) // 16 * 4).reshape(-1, 4)
        ids = ent[:, 0].astype("<u4").tobytes()
        keep = np.array([ids[4 * i:4 * i + 2] == tag
                         and ids[4 * i + 2:4 * i + 4] in (b"dc", b"db")
                         for i in range(len(ent))], bool)
        ent = ent[keep].astype(np.int64)
        base = 0  # offsets from the 'movi' fourcc, or from the file's start
        if len(ent):
            f.seek(movi + int(ent[0, 2]))
            base = movi if f.read(2) == tag else 0
        offsets = ent[:, 2] + base + 8  # the chunk's data, past its header
        sizes, sync = ent[:, 3], (ent[:, 1] & 0x10) != 0
    elif b"indx" in info:
        offsets, sizes, sync = _odml_index(f, hdrl[info[b"indx"][0]:info[b"indx"][1]])
    else:
        raise ValueError("AVI: no idx1 and no OpenDML indx (an unindexed "
                         "AVI is not read)")
    fps = float(av_reduce(rate, scale, 60000)) if scale and rate else 0.0
    count = length if length else len(sizes)
    return Track(fourcc, width, abs(height), extradata, offsets, sizes,
                 sync, fps, int(count),
                 handler=strh[4:8].decode("latin-1").rstrip("\0"))


def _odml_index(f, indx):
    per, _sub, kind, n = struct.unpack("<HBBI", indx[:8])
    if kind != 0 or per != 4:
        raise ValueError("AVI: OpenDML indx that is not a super index")
    offsets, sizes, sync = [], [], []
    for k in range(n):
        qoff, _sz, _dur = struct.unpack("<QII", indx[24 + 16 * k:40 + 16 * k])
        f.seek(qoff)
        _cid, csz = struct.unpack("<4sI", f.read(8))
        ix = f.read(csz)
        per2, _sub2, kind2, m = struct.unpack("<HBBI", ix[:8])
        if kind2 != 1 or per2 != 2:
            raise ValueError("AVI: OpenDML standard index of an unread kind")
        base = struct.unpack("<Q", ix[12:20])[0]
        e = np.frombuffer(ix, "<u4", 2 * m, 24).reshape(m, 2).astype(np.int64)
        offsets.append(base + e[:, 0])
        sizes.append(e[:, 1] & 0x7FFFFFFF)
        sync.append((e[:, 1] & 0x80000000) == 0)
    return (np.concatenate(offsets), np.concatenate(sizes),
            np.concatenate(sync))


# ---------------------------------------------------------------------------
# Matroska
# ---------------------------------------------------------------------------

_SEGMENT, _INFO, _TRACKS, _CLUSTER = 0x18538067, 0x1549A966, 0x1654AE6B, 0x1F43B675
_MKV_CODECS = {
    "V_MPEG4/ISO/ASP": "mp4v", "V_MPEG4/ISO/SP": "mp4v",
    "V_MPEG4/ISO/AP": "mp4v", "V_MJPEG": "MJPG", "V_MPEG4/ISO/AVC": "avc1",
    "V_MPEGH/ISO/HEVC": "hvc1", "V_VP8": "VP80", "V_VP9": "VP90",
    "V_AV1": "av01", "V_FFV1": "FFV1", "V_MPEG2": "mp2v",
    "V_THEORA": "theo",
}


class _Ebml:
    """EBML elements of a file, read header by header: (id, payload start,
    payload end), the end clipped to the file (a file cut short keeps its
    declared sizes in ``declared``)."""

    def __init__(self, f, size):
        self.f, self.size = f, size

    def vint(self, pos, strip=True):
        self.f.seek(pos)
        head = self.f.read(8)
        if not head:
            raise ValueError("Matroska: file ends inside an element header")
        b = head[0]
        n = 1
        while n <= 8 and not b & (0x80 >> (n - 1)):
            n += 1
        if n > 8 or len(head) < n:
            raise ValueError("Matroska: bad EBML variable-length integer")
        v = b & (0xFF >> n) if strip else b
        for k in range(1, n):
            v = (v << 8) | head[k]
        if strip and v == (1 << (7 * n)) - 1:
            return None, pos + n
        return v, pos + n

    def elements(self, start, end):
        i = start
        while i < min(end, self.size):
            eid, j = self.vint(i, strip=False)
            sz, j = self.vint(j)
            declared = end if sz is None else j + sz
            yield eid, j, min(declared, end, self.size), declared
            i = declared

    def read(self, s, e):
        self.f.seek(s)
        return self.f.read(e - s)

    def uint(self, s, e):
        return int.from_bytes(self.read(s, e), "big")


def _matroska(f, size) -> Track:
    m = _Ebml(f, size)
    seg = None
    for eid, s, e, _ in m.elements(0, size):
        if eid == _SEGMENT:
            seg = (s, e)
            break
    if seg is None:
        raise ValueError("Matroska: no Segment")
    timescale = 1_000_000
    duration = None
    track = None
    blocks = []  # (offset, size, key, timecode)
    for eid, s, e, _ in m.elements(*seg):
        if eid == _INFO:
            for cid, cs, ce, _ in m.elements(s, e):
                if cid == 0x2AD7B1:
                    timescale = m.uint(cs, ce)
                elif cid == 0x4489:
                    duration = struct.unpack(">f" if ce - cs == 4 else ">d",
                                             m.read(cs, ce))[0]
        elif eid == _TRACKS and track is None:
            track = _mkv_video_track(m, s, e)
        elif eid == _CLUSTER:
            if track is None:
                raise ValueError("Matroska: Cluster before Tracks")
            _mkv_cluster(m, s, e, track["number"], blocks)
    if track is None:
        raise ValueError("Matroska: no video track")
    codec = track["codec"]
    extradata = track["private"]
    tag = ""
    if codec == "V_MS/VFW/FOURCC":
        priv = track["private"]
        if len(priv) < 40:
            raise ValueError("Matroska: V_MS/VFW/FOURCC without a "
                             "BITMAPINFOHEADER")
        fourcc = tag = priv[16:20].decode("latin-1")
        extradata = priv[40:]
    else:
        fourcc = _MKV_CODECS.get(codec, codec)
    offsets = np.array([b[0] for b in blocks], np.int64)
    sizes = np.array([b[1] for b in blocks], np.int64)
    sync = np.array([b[2] for b in blocks], bool)
    dd = track["default_duration"]
    if dd:
        fps = float(av_reduce(1_000_000_000, dd, 30000))
    elif len(blocks) > 1:  # the blocks' timecodes, as FFmpeg's probe
        span = (blocks[-1][3] - blocks[0][3]) * timescale
        fps = float(av_reduce((len(blocks) - 1) * 1_000_000_000, span, 60000))
    else:
        fps = 0.0
    if duration is not None:
        # AVFormatContext.duration: microseconds, truncated
        us = int(duration * timescale * 1000 / 1_000_000)
        count = int(math.floor(us / 1e6 * fps + 0.5))
    else:
        count = len(blocks)
    pts = np.array([b[3] for b in blocks], np.int64)
    return Track(fourcc, track["width"], track["height"], bytes(extradata),
                 offsets, sizes, sync, fps, count, pts,
                 Fraction(timescale, 1_000_000_000), codec_tag=tag)


def _mkv_video_track(m, s, e):
    for eid, ts, te, _ in m.elements(s, e):
        if eid != 0xAE:
            continue
        t = {"number": None, "type": None, "codec": "", "private": b"",
             "default_duration": 0, "width": 0, "height": 0}
        for cid, cs, ce, _ in m.elements(ts, te):
            if cid == 0xD7:
                t["number"] = m.uint(cs, ce)
            elif cid == 0x83:
                t["type"] = m.uint(cs, ce)
            elif cid == 0x86:
                t["codec"] = m.read(cs, ce).rstrip(b"\0").decode("latin-1")
            elif cid == 0x63A2:
                t["private"] = m.read(cs, ce)
            elif cid == 0x23E383:
                t["default_duration"] = m.uint(cs, ce)
            elif cid == 0x6D80:
                raise ValueError("Matroska: compressed or encrypted track "
                                 "(ContentEncodings) is not read")
            elif cid == 0xE0:
                for vid, vs, ve, _ in m.elements(cs, ce):
                    if vid == 0xB0:
                        t["width"] = m.uint(vs, ve)
                    elif vid == 0xBA:
                        t["height"] = m.uint(vs, ve)
        if t["type"] == 1:
            return t
    return None


def _mkv_cluster(m, s, e, number, blocks):
    tc0 = 0
    for eid, cs, ce, declared in m.elements(s, e):
        if eid == 0xE7:
            tc0 = m.uint(cs, ce)
        elif eid == 0xA3:
            _mkv_block(m, cs, declared, number, tc0, None, blocks)
        elif eid == 0xA0:
            key = True
            block = None
            for gid, gs, _, gd in m.elements(cs, ce):
                if gid == 0xA1:
                    block = (gs, gd)
                elif gid == 0xFB:
                    key = False
            if block is not None:
                _mkv_block(m, *block, number, tc0, key, blocks)


def _mkv_block(m, s, e, number, tc0, key, blocks):
    """A (Simple)Block's frame: its data may run past the end of a file
    cut short, which the reader finds when it reads that frame."""
    tn, i = m.vint(s)
    if tn != number:
        return
    head = m.read(i, i + 3)
    if len(head) < 3:
        raise ValueError("Matroska: file ends inside a block header")
    tc = struct.unpack(">h", head[:2])[0]
    flags = head[2]
    if flags & 0x06:
        raise ValueError("Matroska: laced blocks are not read")
    if key is None:
        key = bool(flags & 0x80)
    blocks.append((i + 3, e - i - 3, key, tc0 + tc))
