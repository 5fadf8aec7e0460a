"""Video files for the dataset readers: the container demuxers of
``data/containers.py`` and a C++ frame decoder (``native/video_decode.cpp``
with ``native/h264_decode.cpp``, ``native/vp9_decode.cpp`` and
``native/hevc_decode.cpp``) bound with ctypes.

:class:`VideoReader` reads a file as the JAX package's ``MP4Dataset`` reads
it through ``cv2.VideoCapture``: the same frame count and frame rate
(``CAP_PROP_FRAME_COUNT``, ``CAP_PROP_FPS``) and the same RGB frames,
which the decoder reproduces by following FFmpeg's decode arithmetic (its
simple IDCT, its motion compensation) and the conversion of swscale's
unscaled YUV -> RGB path that OpenCV asks for (with the stream's range and
matrix where it states them). It reads H.264 (``avc1``, ``avc3``, ``H264``,
...; progressive 8-bit 4:2:0 I, P and B pictures, CAVLC and CABAC, up to
the High profile's tools, in any decode order), VP9 (``VP90``, ``vp09``;
profile 0 with every tool of it: superframes, hidden frames and
``show_existing_frame``, intra-only frames, compound prediction,
segmentation, backward adaptation, tiles), HEVC (``hvc1``, ``hev1``,
``HEVC``, ...: the Main and Main Still Picture profiles, I, P and B
pictures with every CTU tool, tiles, WPP, dependent slice segments,
long-term pictures, in any order of decoding and output: hierarchical B
pictures, IDR, CRA and BLA pictures with their RADL and RASL pictures,
pictures sent with pic_output_flag 0), MPEG-4 Part 2
(``mp4v``, ``XVID``, ``DIVX``, ``FMP4``, ...) and Motion JPEG (``MJPG``)
tracks of MP4/MOV, AVI and Matroska files; a track of another codec (VP8,
AV1, FFV1, ...) raises ``ValueError`` naming its fourcc, and an H.264,
VP9 or HEVC stream that needs what the decoder leaves out (H.264: fields,
4:2:2 / 4:4:4, more than 8 bits, FMO, data partitioning, SP/SI slices,
...; VP9: profiles 1-3, scaled references, a size change, an odd frame
height; HEVC: profiles other than Main, slices of one picture that
differ in their deblocking, ...) raises one naming that.
HEVC reconstruction is exact in the standard, and its frames are FFmpeg's;
where FFmpeg's deblocking and SAO order departs from the standard's
arithmetic the decoder follows FFmpeg (``native/hevc_decode.cpp`` marks
where), and its pictures come out as FFmpeg bumps them and skip the RASL
pictures FFmpeg skips. VP9 reconstruction is integer arithmetic too: its
frames are FFmpeg's, and where FFmpeg departs from libvpx the decoder
follows FFmpeg (``native/vp9_decode.cpp`` marks where). H.264 reconstruction is exact in the standard, so its frames are
FFmpeg's for every stream the decoder reads; the decoder also follows the
places where FFmpeg departs from it (``native/h264_decode.cpp`` lists
them). H.264 pictures come out in FFmpeg's output order, through its
reorder buffer (whose delay starts where FFmpeg's stream probe and, for
MP4, its demuxer's ``ctts`` estimate leave it); frame ``i`` is the frame
cv2 gives for it, read in order or after ``cap.set(CAP_PROP_POS_FRAMES,
i)`` (:class:`VideoReader` says how). MPEG-4 Part 2 is decoded as FFmpeg
decodes what FFmpeg, Xvid and DivX write: I-, P-, B- and not-coded VOPs,
packed bitstreams, the IDCT and workarounds FFmpeg picks by the encoder's
build in the stream's user data and by the container's codec tag (Xvid's
IDCT for an Xvid build, or for no build under an ``XVID`` tag), frames in
FFmpeg's output order. A frame that cannot be decoded raises
``ValueError(f"failed to decode frame {i} of {path}")``, as the JAX reader
does.

The decoder is compiled with ``g++`` at first use into the package's
``build/`` (git-ignored), keyed by a hash of its sources, and loaded under
a lock. When it cannot be built, reading raises: there is no fallback.

Beside it are the plain numpy versions of its arithmetic (the MPEG-4
simple and Xvid IDCTs, half-pel interpolation and B-VOP average, H.264's scaled 4x4 / 8x8 inverse transforms,
quarter-sample luma and eighth-sample chroma interpolation, one deblocking
edge, bi-prediction, implicit weights and temporal direct's scaling, VP9's
inverse transforms, 8-tap prediction and loop-filter edge, HEVC's inverse
transforms, interpolation and weighting, intra prediction, deblocking
edge and SAO of a block, and the colour converter), which only the tests
and chip_smoke.py use: the compiled entries must equal them bit for bit.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading

import numpy as np

from mast3r_slam_tpu_torch import _build
from mast3r_slam_tpu_torch.data import containers

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC = _PKG / "native" / "video_decode.cpp"
_DEPS = (_PKG / "native" / "jpeg_decode.cpp", _PKG / "native" / "h264_decode.cpp",
         _PKG / "native" / "vp9_decode.cpp", _PKG / "native" / "hevc_decode.cpp")
_BUILD = _PKG / "build"
_LOCK = threading.Lock()
_ERRLEN = 256
_lib = None

MPEG4, MJPEG, H264, VP9, HEVC = 1, 2, 3, 4, 5
# fourccs of MPEG-4 Part 2 and of Motion JPEG (one baseline or
# progressive JPEG a sample) that FFmpeg gives its mpeg4 and mjpeg decoders
CODECS = {
    **{c: MPEG4 for c in ("mp4v", "MP4V", "XVID", "xvid", "DIVX", "divx",
                          "DX50", "dx50", "FMP4", "fmp4", "M4S2", "MP4S")},
    **{c: MJPEG for c in ("MJPG", "mjpg", "jpeg")},
    **{c: H264 for c in ("avc1", "avc3", "H264", "h264", "X264", "x264")},
    **{c: VP9 for c in ("VP90", "vp90", "vp09")},
    **{c: HEVC for c in ("hvc1", "hev1", "HEVC", "hevc", "H265", "h265", "X265", "x265")},
}


def load_library() -> ctypes.CDLL:
    """The compiled decoder, built at first use; raises when it cannot be
    built."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host(
                _SRC, _BUILD, "video decoder", deps=_DEPS)))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i16p = ctypes.POINTER(ctypes.c_int16)
            i32p = ctypes.POINTER(ctypes.c_int32)
            cint, i64 = ctypes.c_int, ctypes.c_int64
            lib.vd_open.restype = ctypes.c_void_p
            lib.vd_open.argtypes = [cint, u8p, i64, ctypes.c_uint32,
                                    ctypes.c_char_p, cint]
            lib.vd_close.restype = None
            lib.vd_close.argtypes = [ctypes.c_void_p]
            lib.vd_decode.restype = cint
            lib.vd_decode.argtypes = [ctypes.c_void_p, u8p, i64, i64, i32p,
                                      ctypes.c_char_p, cint]
            lib.vd_flush.restype = cint
            lib.vd_flush.argtypes = [ctypes.c_void_p, i32p]
            lib.vd_tag.restype = i64
            lib.vd_tag.argtypes = [ctypes.c_void_p]
            lib.vd_delay.restype = cint
            lib.vd_delay.argtypes = [ctypes.c_void_p, cint, i32p]
            lib.vd_reset.restype = None
            lib.vd_reset.argtypes = [ctypes.c_void_p]
            lib.vd_mpeg4_info.restype = None
            lib.vd_mpeg4_info.argtypes = [ctypes.c_void_p, i32p]
            lib.vd_frame.restype = cint
            lib.vd_frame.argtypes = [ctypes.c_void_p, u8p, u8p, u8p, u8p]
            lib.vd_idct.restype = None
            lib.vd_idct.argtypes = [i16p, cint, u8p]
            lib.vd_xvid_idct.restype = None
            lib.vd_xvid_idct.argtypes = [i16p, cint, u8p]
            lib.vd_mpeg4_bipred.restype = None
            lib.vd_mpeg4_bipred.argtypes = [u8p, u8p] + [cint] * 9 + [u8p]
            lib.vd_hpel.restype = None
            lib.vd_hpel.argtypes = [u8p, cint, cint, cint, cint, cint, cint,
                                    cint, cint, u8p]
            lib.vd_yuv_to_rgb.restype = None
            lib.vd_yuv_to_rgb.argtypes = [u8p, u8p, u8p, cint, cint, cint,
                                          cint, u8p]
            lib.vd_h264_idct.restype = None
            lib.vd_h264_idct.argtypes = [i16p, u8p, cint, cint, u8p]
            lib.vd_h264_mc.restype = None
            lib.vd_h264_mc.argtypes = [u8p, cint, cint, cint, cint, cint,
                                       cint, cint, cint, cint, u8p]
            lib.vd_h264_edge.restype = None
            lib.vd_h264_edge.argtypes = [u8p, cint, cint, cint, cint, cint,
                                         cint]
            lib.vd_h264_bipred.restype = None
            lib.vd_h264_bipred.argtypes = [u8p, u8p, cint, cint, cint, cint,
                                           cint, cint, u8p]
            lib.vd_h264_temporal.restype = cint
            lib.vd_h264_temporal.argtypes = [cint, cint, cint, cint, i16p, i32p]
            lib.vd_h264_implicit.restype = cint
            lib.vd_h264_implicit.argtypes = [cint, cint, cint, cint, cint]
            lib.vd_vp9_itx.restype = None
            lib.vd_vp9_itx.argtypes = [i16p, cint, cint, u8p]
            lib.vd_vp9_mc.restype = None
            lib.vd_vp9_mc.argtypes = [u8p, cint, cint, cint, cint, cint, cint,
                                      cint, cint, cint, cint, u8p]
            lib.vd_vp9_lf.restype = None
            lib.vd_vp9_lf.argtypes = [u8p, cint, cint, cint, cint, cint, cint]
            lib.vd_hevc_idct.restype = None
            lib.vd_hevc_idct.argtypes = [i16p, cint, cint, cint, i16p]
            lib.vd_hevc_mc.restype = None
            lib.vd_hevc_mc.argtypes = [u8p, u8p, cint, cint, cint, cint, cint, i32p, cint,
                                       cint, i32p, cint, cint, u8p]
            lib.vd_hevc_intra.restype = None
            lib.vd_hevc_intra.argtypes = [u8p, u8p, cint, cint, cint, cint, u8p]
            lib.vd_hevc_deblock.restype = None
            lib.vd_hevc_deblock.argtypes = [u8p] + [cint] * 10
            lib.vd_hevc_sao.restype = None
            lib.vd_hevc_sao.argtypes = [u8p, cint, u8p, cint, cint, cint, cint, cint, i32p, u8p]
            _lib = lib
    return _lib


def _u8(a):
    return None if a is None else a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class Decoder:
    """One stream's decoder state (``MPEG4``, ``MJPEG``, ``H264``, ``VP9`` or
    ``HEVC`` (pictures out in FFmpeg's bumping order, extradata the hvcC
    record or nothing for Annex B samples);
    a VP9 sample of frames that are not shown puts out nothing):
    samples in decode order in, frames in output order out (an H.264
    picture waits in a reorder buffer until its turn, as FFmpeg's decoder
    holds it; an MPEG-4 I- or P-VOP of a VOL that is not low delay until
    the next one; a not-coded VOP puts nothing out). ``extradata`` holds
    the headers a container keeps apart from the samples (for H.264 the
    avcC record, or nothing for Annex B samples); ``tag`` is the codec tag
    FFmpeg's demuxer gives the track (MPEG-4: ``XVID`` and a few others
    choose Xvid's IDCT and workarounds where the stream names no build)."""

    def __init__(self, codec: int, extradata: bytes = b"", tag: str = ""):
        self._lib = load_library()
        self.codec = codec
        self._handle = None
        extra = np.frombuffer(extradata, np.uint8)
        err = ctypes.create_string_buffer(_ERRLEN)
        tag32 = int.from_bytes(tag.encode("latin-1")[:4].ljust(4, b"\0"), "little")
        h = self._lib.vd_open(codec, _u8(extra), extra.size, tag32, err, _ERRLEN)
        if not h:
            raise ValueError(err.value.decode())
        self._handle = h
        self.size = None  # (width, height) of the last frame

    def decode(self, data, tag: int = -1) -> bool:
        """Decodes one sample, tagged ``tag``; True when a frame is ready
        (``rgb``, ``planes``, ``tag``); ``ValueError`` naming why it cannot
        decode the sample."""
        buf = np.frombuffer(data, np.uint8)
        wh = (ctypes.c_int32 * 2)()
        err = ctypes.create_string_buffer(_ERRLEN)
        got = self._lib.vd_decode(self._handle, _u8(buf), buf.size, int(tag),
                                  wh, err, _ERRLEN)
        if got < 0:
            raise ValueError(err.value.decode())
        if got:
            self.size = (int(wh[0]), int(wh[1]))
        return bool(got)

    def flush(self) -> bool:
        """At the end of the stream: True when one more frame (an H.264 or
        HEVC picture still waiting) is ready."""
        wh = (ctypes.c_int32 * 2)()
        if not self._lib.vd_flush(self._handle, wh):
            return False
        self.size = (int(wh[0]), int(wh[1]))
        return True

    @property
    def tag(self) -> int:
        """The tag of the sample the ready frame was coded in."""
        return int(self._lib.vd_tag(self._handle))

    def reset(self):
        """MPEG-4: a seek, as ``avcodec_flush_buffers`` leaves FFmpeg's
        decoder (the pictures and a held VOP go; the headers, the encoder's
        build and its workarounds stay)."""
        self._lib.vd_reset(self._handle)

    def mpeg4_info(self) -> dict:
        """MPEG-4: what FFmpeg made of the encoder (``decode_user_data``,
        ``ff_mpeg4_workaround_bugs``): the Xvid build, DivX version and
        build, Lavc build (-1 where none), the workaround flags by FFmpeg's
        names, whether the Xvid IDCT is on, packed bitstreams, and the VOL's
        low delay."""
        info = (ctypes.c_int32 * 8)()
        self._lib.vd_mpeg4_info(self._handle, info)
        names = ("EDGE", "DC_CLIP", "HPEL_CHROMA", "DIRECT_BLOCKSIZE", "QPEL_CHROMA",
                 "QPEL_CHROMA2", "STD_QPEL", "IEDGE", "XVID_ILACE", "UMP4")
        return {"xvid_build": info[0], "divx_version": info[1], "divx_build": info[2],
                "lavc_build": info[3],
                "bugs": {n for k, n in enumerate(names) if info[4] >> k & 1},
                "xvid_idct": bool(info[5]), "packed": bool(info[6]),
                "low_delay": bool(info[7])}

    def delay(self, start: int = -1):
        """H.264's reorder delay (FFmpeg's has_b_frames), first set to
        ``start`` where it is not negative; with the active SPS's
        bitstream_restriction_flag and reorder depth, and the number of
        pictures dropped so far for arriving out of order."""
        info = (ctypes.c_int32 * 3)()
        d = self._lib.vd_delay(self._handle, int(start), info)
        return int(d), bool(info[0]), int(info[1]), int(info[2])

    def rgb(self) -> np.ndarray:
        """The last frame, uint8 RGB ``(H, W, 3)``."""
        w, h = self.size
        out = np.empty((h, w, 3), np.uint8)
        self._lib.vd_frame(self._handle, _u8(out), None, None, None)
        return out

    def planes(self):
        """The last frame's Y ``(H, W)``, Cb and Cr ``((H+1)/2, (W+1)/2)``
        planes as decoded."""
        w, h = self.size
        y = np.empty((h, w), np.uint8)
        cb = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
        cr = np.empty_like(cb)
        self._lib.vd_frame(self._handle, None, _u8(y), _u8(cb), _u8(cr))
        return y, cb, cr

    def close(self):
        if self._handle is not None:
            self._lib.vd_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


def yuv_to_rgb(y, cb, cr, full_range: bool, matrix: int = 2) -> np.ndarray:
    """The decoder's converter on 4:2:0 planes (``yuv_to_rgb_ref`` is its
    plain version); ``matrix`` is H.264's matrix_coefficients."""
    lib = load_library()
    y, cb, cr = (np.ascontiguousarray(p, np.uint8) for p in (y, cb, cr))
    h, w = y.shape
    if cb.shape != ((h + 1) // 2, (w + 1) // 2) or cr.shape != cb.shape:
        raise ValueError(f"chroma planes {cb.shape} / {cr.shape} for a "
                         f"{h}x{w} luma plane")
    out = np.empty((h, w, 3), np.uint8)
    lib.vd_yuv_to_rgb(_u8(y), _u8(cb), _u8(cr), w, h, int(full_range),
                      int(matrix), _u8(out))
    return out


class _Refused(ValueError):
    """What the reader raises as it is, not as a frame that failed to
    decode: headers it refuses, a seek it does not make."""


class _End(ValueError):
    """The stream ended before the frame: cv2's capture stays at its end,
    and its next read without a seek fails too."""


def _nal_types(data: bytes, length_size: int, hevc: bool = False):
    """The NAL unit types of an H.264 (or, with ``hevc``, an HEVC base
    layer's) sample: length-prefixed NAL units (1, 2 or 4 bytes), or an
    Annex B byte stream (length_size 0)."""
    def typ(b0, b1):
        if not hevc:
            return b0 & 31
        return -1 if ((b0 & 1) << 5 | b1 >> 3) else (b0 >> 1) & 63
    out, i, n = [], 0, len(data)
    if length_size:
        while i + length_size < n:
            size = int.from_bytes(data[i:i + length_size], "big")
            i += length_size
            if i + 1 < n:
                out.append(typ(data[i], data[i + 1]))
            i += size
        return out
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0 or j + 4 >= n:
            return out
        out.append(typ(data[j + 3], data[j + 4]))
        i = j + 3


class VideoReader:
    """Frames of the first video track of ``path`` as uint8 RGB
    ``(H, W, 3)``. ``len`` is the frame count cv2 reports; ``fps`` its
    frame rate (0.0 where the container gives none).

    Frame ``i`` is the frame ``cv2.VideoCapture`` returns for it, as the
    JAX reader reads: the next frame it decodes, or after
    ``cap.set(CAP_PROP_POS_FRAMES, i)`` the one OpenCV's seek reaches. Read
    in order, frames come in output order, which for H.264 with B pictures
    is not decode order: a picture waits in the decoder's reorder buffer,
    whose depth starts where FFmpeg's stream probe leaves it (for MP4 the
    depth its demuxer estimates from ``ctts``, then what decoding the first
    pictures shows) and grows as FFmpeg's does; a picture that comes too
    late is dropped, as FFmpeg drops it. A seek decodes from an IDR picture
    (a sync sample); while no picture was dropped, frame i is then the
    i-th picture in output order. After a drop, the seek is OpenCV's: to
    the sync sample 16 frames or more before, numbering the first frame by
    its presentation time and counting on from it (MP4 and Matroska). A
    seek that OpenCV would start at a sync sample that is not an IDR picture
    (an open GOP, whose leading pictures FFmpeg does not put out after a
    seek) raises ``ValueError`` naming it. MPEG-4 Part 2 always seeks as
    OpenCV does: a VOP may put out no frame (not coded; a B-VOP whose past
    reference a seek dropped) and a VOL that is not low delay puts each I-
    or P-VOP out a sample late, so counting from the sync sample does not
    give OpenCV's frame; the decoder keeps its headers and the encoder's
    build over a seek, as FFmpeg's does. HEVC always seeks as OpenCV does
    too: pictures come out of decode order, the RASL pictures of the CRA
    picture a seek starts at are skipped (FFmpeg's gate) and a picture
    sent with pic_output_flag 0 leaves its place in presentation order
    empty, so counting from the sync sample does not give OpenCV's frame
    (cv2 with frame threads, its default on more than one core; with one
    decoder thread its seeks into skipped RASL pictures come out
    otherwise). A read that runs past the end of the stream leaves the
    reader there, as it leaves cv2's capture: the next read without a seek
    fails too. A seek in a Matroska track that flags no keyframe (FFmpeg's
    demuxer then does not move) raises ``ValueError`` naming it."""

    def __init__(self, path):
        self.path = str(path)
        self.track = containers.open_track(self.path)
        codec = CODECS.get(self.track.fourcc)
        if codec is None:
            raise ValueError(
                f"{self.path}: video codec {self.track.fourcc!r} is not "
                "decoded (H.264, HEVC, VP9, MPEG-4 Part 2 and MJPEG are)")
        self.codec = codec
        t = self.track
        self._tag = t.fourcc if t.codec_tag is None else t.codec_tag
        if codec == MPEG4 and t.handler == "XVID":
            self._tag = "XVID"  # FFmpeg's AVI demuxer
        self.fps = float(self.track.fps)
        load_library()
        self._dec = None
        self._sample = 0    # the sample the decoder reads next
        self._pos = None    # the frame a read without a seek gives
        self._delay = None  # H.264: FFmpeg's has_b_frames, once probed
        self._dropped = False
        self._first = None  # OpenCV's number of the first frame, and the
        self._first_delay = None  # reorder delay it came out under
        self._num = None    # OpenCV's number of the frame just decoded
        self._start = 0     # the sample the decoder started from
        self._outputs = 0   # and the frames it put out
        self._idr = {}
        self._end = False   # the last read ran past the end of the stream
        extra = self.track.extradata
        self._nal_len = 0
        if extra[:1] == b"\x01":  # avcC / hvcC: length-prefixed NAL units
            self._nal_len = (extra[21 if codec == HEVC else 4] & 3) + 1

    def __len__(self):
        return int(self.track.frame_count)

    def _sample_data(self, k):
        with open(self.path, "rb") as f:
            f.seek(int(self.track.offsets[k]))
            data = f.read(int(self.track.sizes[k]))
        if len(data) != int(self.track.sizes[k]):
            raise ValueError("the file ends inside the sample")
        return data

    def _is_idr(self, k):
        """Whether sample k starts a stream an H.264 decoder may start from
        (an IDR picture); True for the other codecs, whose seeks start at
        any sync sample."""
        if self.codec != H264:
            return True
        if k not in self._idr:
            self._idr[k] = 5 in _nal_types(self._sample_data(k), self._nal_len)
        return self._idr[k]

    def _probe(self):
        """The reorder delay cv2's decoder starts with: the one FFmpeg's
        stream probe leaves (avformat_find_stream_info decodes until seven
        frames are out, or more while the delay is 3 or more, or until the
        delay equals the SPS's reorder depth), from the MP4 demuxer's
        estimate."""
        dec = Decoder(H264, self.track.extradata)
        dec.delay(self.track.video_delay)
        out = 0
        for k in range(len(self.track.sizes)):
            d, _, reorder, _ = dec.delay()
            if (d and d == reorder) or (d < 3 and out >= 7) or \
                    (d < 4 and out >= 18) or out >= 20:
                break
            try:
                out += dec.decode(self._sample_data(k), k)
            except ValueError:
                break
        return dec.delay()[0]

    def _restart(self, k):
        """A fresh decoder (OpenCV's seek flushes its decoder, which keeps
        its reorder delay) reading from sample k."""
        if self.codec == H264 and self._delay is None:
            self._delay = self._probe()
        if self.codec == MPEG4 and self._dec is not None:
            self._dec.reset()  # the headers and the encoder's build stay
        else:
            self._dec = None
            try:
                self._dec = Decoder(self.codec, self.track.extradata, self._tag)
            except ValueError as e:
                raise _Refused(str(e)) from None
        if self.codec == H264:
            self._dec.delay(self._delay)
        self._sample = self._start = k
        self._outputs = 0

    def _grab(self):
        """Decodes on to the next frame; False at the end of the stream."""
        dec = self._dec
        while True:
            end = self._sample >= len(self.track.sizes)
            if not end:
                k = self._sample
                self._sample += 1
                got = dec.decode(self._sample_data(k), k)
            else:
                got = dec.flush()
            if self.codec == H264:
                d, _, _, dropped = dec.delay()
                self._delay = max(self._delay, d)
                self._dropped |= dropped > 0
            if got:
                self._num = self._number(None if end else k)
                if self._first is None and self._start == 0 and not self._outputs:
                    self._first, self._first_delay = self._num, self._delay
                self._outputs += 1
            if got or end:
                return got

    def _number(self, k):
        """OpenCV's number of the frame just put out (sample k decoded, or
        None at the end of the stream): its presentation time in frames
        since the stream's first; AVI has none, and OpenCV takes the decode
        time of sample k (none at the end)."""
        t = self.track
        if t.pts is None:
            return k
        sec = float((int(t.pts[self._dec.tag]) - int(t.pts.min())) * t.time_base)
        return int(self.fps * sec + 0.5)

    def _keyframe(self, j):
        """The sync sample OpenCV's seek to frame j lands on: the last one at
        or before frame j's time (decode times for MP4, presentation times
        for Matroska, sample indices for AVI)."""
        t = self.track
        keys = np.flatnonzero(t.sync)
        if t.pts is None:
            at = keys[keys <= j]
        else:
            frame = float(1 / (self.fps * t.time_base)) if self.fps else 1.0
            times = t.pts - t.pts.min() if t.dts is None else t.dts
            at = keys[times[keys] <= int(j * frame + 0.5)]
        return int(at[-1]) if len(at) else 0

    def _seek(self, i):
        if self.codec in (MPEG4, HEVC):
            # a VOP may put out no frame (not coded; a B-VOP without its
            # references after a seek) and an I-/P-VOP comes out a sample
            # late; HEVC pictures come out of decode order, and a CRA
            # picture's RASL pictures are skipped where decoding starts at
            # it: OpenCV's own seek, always; a fresh reader of frame 0
            # reads on from the start, as a fresh capture does
            if self._dec is None and i == 0:
                self._restart(0)
                self._pos = 0
                return
            return self._seek_opencv(i)
        # counting from an IDR picture gives OpenCV's frame while no picture
        # was dropped and (AVI) the reorder delay is the first frame's
        if self._dropped or (self.track.pts is None and self._first is not None
                             and self._delay != self._first_delay):
            return self._seek_opencv(i)
        self._open_gop(i, self._keyframe(max(i - 16, 0)))
        start = i
        while start > 0 and not (self.track.sync[start] and self._is_idr(start)):
            start -= 1
        # on from the last frame read when no IDR picture lies between it
        # and frame i (the same frames: an H.264 GOP can be long)
        if self._dec is None or self._pos is None or not start <= self._pos <= i:
            self._restart(start)
            self._pos = start
        while self._pos < i:
            if not self._grab():
                raise _End("the stream ends before the frame")
            self._pos += 1

    def _open_gop(self, i, k):
        if not self._is_idr(k):
            raise _Refused(
                f"H.264 with a seek into an open GOP (frame {i}: OpenCV "
                f"starts at sample {k}, an I picture that is not IDR) is not "
                "supported")

    def _seek_opencv(self, i):
        """cap.set(CAP_PROP_POS_FRAMES, i) as OpenCV's FFmpeg backend does
        it (CvCapture_FFMPEG::seek): the decoder positioned so that the
        next frame it puts out is frame i's."""
        if self._first is None:
            self._restart(0)
            if not self._grab():
                raise ValueError("the stream has no frame")
        delta = 16
        while True:
            t = max(i - delta, 0)
            k = self._keyframe(t)
            self._open_gop(i, k)
            self._restart(k)
            if i <= 1:
                if i == 1 and not self._grab():
                    raise _End("the stream ends before the frame")
                return
            if not self._grab():
                raise _End("the stream ends before the frame")
            n = -1 if self._num is None else self._num - self._first
            if n < 0 or n > i - 1:
                if t == 0:
                    return
                delta = delta * 2 if delta < 16 else delta * 3 // 2
                continue
            while n < i - 1 and self._grab():
                n += 1
            return

    def read(self, i: int) -> np.ndarray:
        """Frame ``i``; ``ValueError`` where it cannot be decoded."""
        i = int(i)
        if not 0 <= i < len(self.track.sizes):
            raise ValueError(f"failed to decode frame {i} of {self.path}")
        if self._end and i == self._pos:  # still at the end, as cv2's capture
            self._pos = i + 1
            raise ValueError(f"failed to decode frame {i} of {self.path}")
        t = self.track
        if i != (self._pos or 0) and t.dts is None and t.pts is not None and not t.sync.any():
            raise _Refused(
                f"a seek in a Matroska track without a keyframe (frame {i}: FFmpeg's "
                "demuxer does not move, and cv2 reads on from where it was) is not "
                "supported")
        try:
            if self._dec is None or i != self._pos:
                self._seek(i)
            if not self._grab():
                raise _End("the stream ends before the frame")
        except _Refused:
            self._dec = None
            raise
        except ValueError as e:
            self._dec = None
            self._end, self._pos = isinstance(e, _End), i + 1
            raise ValueError(f"failed to decode frame {i} of {self.path}") from e
        self._end = False
        self._pos = i + 1
        return self._dec.rgb()

    def planes(self, i: int):
        """Frame ``i``'s Y, Cb and Cr planes as decoded (for the tests)."""
        self.read(i)
        return self._dec.planes()


# ---------------------------------------------------------------------------
# The arithmetic in plain numpy (tests only)
# ---------------------------------------------------------------------------

_W = (22725, 21407, 19266, 16383, 12873, 8867, 4520)  # W1..W7


def _wrap32(x):
    """A sum as the signed 32-bit value of its unsigned wrap."""
    return ((np.asarray(x, np.int64) + 2**31) % 2**32) - 2**31


def simple_idct_ref(block: np.ndarray) -> np.ndarray:
    """FFmpeg's 8-bit simple IDCT of one 8x8 block of int16 coefficients
    (natural order): the int32 residual before it is put or added."""
    W1, W2, W3, W4, W5, W6, W7 = _W
    b = np.asarray(block, np.int16).reshape(8, 8).astype(np.int64)
    rows = np.empty((8, 8), np.int64)
    for r in range(8):
        x = b[r]
        if not x[1:].any():
            rows[r] = np.int16(np.uint16((int(x[0]) << 3) & 0xFFFF).view(np.int16))
            continue
        a0 = W4 * x[0] + (1 << 10)
        a1, a2, a3 = a0, a0, a0
        a0 += W2 * x[2] + W4 * x[4] + W6 * x[6]
        a1 += W6 * x[2] - W4 * x[4] - W2 * x[6]
        a2 += -W6 * x[2] - W4 * x[4] + W2 * x[6]
        a3 += -W2 * x[2] + W4 * x[4] - W6 * x[6]
        b0 = W1 * x[1] + W3 * x[3] + W5 * x[5] + W7 * x[7]
        b1 = W3 * x[1] - W7 * x[3] - W1 * x[5] - W5 * x[7]
        b2 = W5 * x[1] - W1 * x[3] + W7 * x[5] + W3 * x[7]
        b3 = W7 * x[1] - W5 * x[3] + W3 * x[5] - W1 * x[7]
        v = _wrap32([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3, a2 - b2,
                     a1 - b1, a0 - b0]) >> 11
        rows[r] = v.astype(np.int32).astype(np.int16)  # stored in 16 bits
    c = rows
    a0 = W4 * (c[0] + ((1 << 19) // W4))
    a1, a2, a3 = a0, a0, a0
    a0 = a0 + W2 * c[2] + W4 * c[4] + W6 * c[6]
    a1 = a1 + W6 * c[2] - W4 * c[4] - W2 * c[6]
    a2 = a2 - W6 * c[2] - W4 * c[4] + W2 * c[6]
    a3 = a3 - W2 * c[2] + W4 * c[4] - W6 * c[6]
    b0 = W1 * c[1] + W3 * c[3] + W5 * c[5] + W7 * c[7]
    b1 = W3 * c[1] - W7 * c[3] - W1 * c[5] - W5 * c[7]
    b2 = W5 * c[1] - W1 * c[3] + W7 * c[5] + W3 * c[7]
    b3 = W7 * c[1] - W5 * c[3] + W3 * c[5] - W1 * c[7]
    out = _wrap32(np.stack([a0 + b0, a1 + b1, a2 + b2, a3 + b3, a3 - b3,
                            a2 - b2, a1 - b1, a0 - b0])) >> 20
    return out.astype(np.int32)


def hpel_ref(src: np.ndarray, x: int, y: int, dxy: int, rounding: int,
             n: int) -> np.ndarray:
    """An n x n block (n 8 or 16) at full-pel (x, y) plus the half-pel
    offsets of dxy (bit 0: x, bit 1: y) of plane ``src``, its coordinates
    clamped into the plane (the reference's replicated edges);
    ``rounding`` is the VOP's rounding type. As cv2's FFmpeg computes it on
    x86: with rounding, an 8-wide average in one direction is pavgb(a - 1,
    b), a - 1 saturating at 0 (a: the left sample, or the one on the
    block's odd row)."""
    h, w = src.shape
    ys = np.clip(np.arange(y, y + n + 1), 0, h - 1)
    xs = np.clip(np.arange(x, x + n + 1), 0, w - 1)
    p = src[np.ix_(ys, xs)].astype(np.int32)
    a, b, c, d = p[:n, :n], p[:n, 1:], p[1:, :n], p[1:, 1:]
    rnd = 1 - rounding
    approx = rounding and n == 8

    def pavg_dec(u, v):  # pavgb(u - 1, v)
        return (np.maximum(u - 1, 0) + v + 1) >> 1
    if dxy == 0:
        out = a
    elif dxy == 1:
        out = pavg_dec(a, b) if approx else (a + b + rnd) >> 1
    elif dxy == 2:
        odd = (np.arange(n) % 2 == 1)[:, None]
        out = np.where(odd, pavg_dec(a, c), pavg_dec(c, a)) if approx else (a + c + rnd) >> 1
    else:
        out = (a + b + c + d + 1 + rnd) >> 2
    return out.astype(np.uint8)


def mpeg4_bipred_ref(p0: np.ndarray, p1: np.ndarray, fwd, bwd, n: int) -> np.ndarray:
    """A B-VOP's bidirectional prediction of an n x n block: ``fwd`` and
    ``bwd`` are (x, y, dxy) in planes p0 and p1 (``hpel_ref``'s read), each
    averaged with rounding, then the two averaged as FFmpeg's avg_pixels
    does ((a + b + 1) >> 1)."""
    a = hpel_ref(p0, *fwd, 0, n).astype(np.int32)
    b = hpel_ref(p1, *bwd, 0, n).astype(np.int32)
    return ((a + b + 1) >> 1).astype(np.uint8)


def mpeg4_bipred(p0, p1, fwd, bwd, n: int) -> np.ndarray:
    """The compiled ``mpeg4_bipred_ref`` (planes of one size)."""
    lib = load_library()
    p0 = np.ascontiguousarray(p0, np.uint8)
    p1 = np.ascontiguousarray(p1, np.uint8)
    if n not in (8, 16) or p0.ndim != 2 or p1.shape != p0.shape:
        raise ValueError(f"blocks of 8 or 16 from two planes of one size, not {n} from "
                         f"{p0.shape} and {p1.shape}")
    h, w = p0.shape
    out = np.empty((n, n), np.uint8)
    lib.vd_mpeg4_bipred(_u8(p0), _u8(p1), w, h, *[int(v) for v in fwd],
                        *[int(v) for v in bwd], int(n), _u8(out))
    return out


# FFmpeg's xvididct.c: each row's cosine table (rows 0-7: 04 17 26 35 04
# 35 26 17) and rounder
_XVID_TABS = ((22725, 21407, 19266, 16384, 12873, 8867, 4520),
              (31521, 29692, 26722, 22725, 17855, 12299, 6270),
              (29692, 27969, 25172, 21407, 16819, 11585, 5906),
              (26722, 25172, 22654, 19266, 15137, 10426, 5315))
_XVID_ROWS = (0, 1, 2, 3, 0, 3, 2, 1)
_XVID_RND = (65536, 3597, 2260, 1203, 0, 120, 512, 512)


def xvid_idct_ref(block: np.ndarray) -> np.ndarray:
    """FFmpeg's Xvid IDCT of one 8x8 block of int16 coefficients (natural
    order) as its x86 SSE2 version computes it (rows in 32 bits, saturated
    to 16; columns in saturating 16-bit arithmetic): the residual before it
    is put or added."""
    b = np.asarray(block, np.int16).reshape(8, 8).astype(np.int64)

    def s16(v):
        return np.clip(v, -32768, 32767)
    rows = np.empty((8, 8), np.int64)
    for r in range(8):
        c1, c2, c3, c4, c5, c6, c7 = _XVID_TABS[_XVID_ROWS[r]]
        x = b[r]
        k = c4 * x[0] + _XVID_RND[r]
        a = (k + c2 * x[2] + c4 * x[4] + c6 * x[6], k + c6 * x[2] - c4 * x[4] - c2 * x[6],
             k - c6 * x[2] - c4 * x[4] + c2 * x[6], k - c2 * x[2] + c4 * x[4] - c6 * x[6])
        o = (c1 * x[1] + c3 * x[3] + c5 * x[5] + c7 * x[7],
             c3 * x[1] - c7 * x[3] - c1 * x[5] - c5 * x[7],
             c5 * x[1] - c1 * x[3] + c7 * x[5] + c3 * x[7],
             c7 * x[1] - c5 * x[3] + c3 * x[5] - c1 * x[7])
        rows[r] = s16(np.array([a[0] + o[0], a[1] + o[1], a[2] + o[2], a[3] + o[3],
                                a[3] - o[3], a[2] - o[2], a[1] - o[1], a[0] - o[0]]) >> 11)
    x = rows

    def mult(c, v):  # pmulhw (tan3 > 1/2: by tan3 - 1, plus v)
        return (c * v) >> 16
    tan1, tan2, tan3, sqrt2 = 0x32EC, 0x6A0A, 0xAB0E, 0x5A82
    t17 = s16(mult(tan1, x[7]) + x[1])
    m17 = s16(mult(tan1, x[1]) - x[7])
    t35 = s16(mult(tan3, x[5]) + x[3])
    m35 = s16(mult(tan3, x[3]) - x[5])
    b0, b3 = s16(t17 + t35), s16(m17 - m35)
    u, v = s16(t17 - t35), s16(m17 + m35)
    b1 = s16(2 * mult(sqrt2, s16(u + v)))
    b2 = s16(2 * mult(sqrt2, s16(u - v)))
    t26 = s16(mult(tan2, x[6]) + x[2])
    m26 = s16(mult(tan2, x[2]) - x[6])
    e0, e1 = s16(x[0] + x[4]), s16(x[0] - x[4])
    a0, a3 = s16(e0 + t26), s16(e0 - t26)
    a1, a2 = s16(e1 + m26), s16(e1 - m26)
    out = np.stack([s16(a0 + b0), s16(a1 + b1), s16(a2 + b2), s16(a3 + b3),
                    s16(a3 - b3), s16(a2 - b2), s16(a1 - b1), s16(a0 - b0)]) >> 6
    return out.astype(np.int32)


def xvid_idct(block, add: int, dst) -> np.ndarray:
    """The compiled ``xvid_idct_ref``, put into (add 0) or added to (add 1)
    the 8x8 uint8 block ``dst``."""
    lib = load_library()
    blk = np.ascontiguousarray(block, np.int16).reshape(64)
    out = np.ascontiguousarray(dst, np.uint8).reshape(64).copy()
    lib.vd_xvid_idct(blk.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), int(add), _u8(out))
    return out.reshape(8, 8)


# swscale's ff_yuv2rgb_coeffs (crv, cbu, cgu, cgv) by H.264
# matrix_coefficients; BT.601 for the values not listed
_MATRICES = {1: (117489, 138438, 13975, 34925), 4: (104448, 132798, 24759, 53109),
             7: (117579, 136230, 16907, 35559), 9: (110013, 140363, 12277, 42626),
             10: (110013, 140363, 12277, 42626)}


def _coeffs(full_range: bool, matrix: int = 2):
    crv, cbu, cgu, cgv = _MATRICES.get(matrix, (104597, 132201, 25675, 53279))
    cgu, cgv = -cgu, -cgv
    cy, oy = 1 << 16, 0
    if not full_range:
        cy, oy = cy * 255 // 219, 16 << 16
    else:  # C's integer division, which truncates toward zero
        crv, cbu, cgu, cgv = (-(-c * 224 // 255) if c < 0 else c * 224 // 255
                              for c in (crv, cbu, cgu, cgv))

    def r16(f):
        return int(np.clip((f + (1 << 15)) >> 16, -0x8000, 0x7FFF))

    return (r16(cy * 8192), r16(oy * 8), r16(crv * 8192), r16(cbu * 8192),
            r16(cgu * 8192), r16(cgv * 8192))


def yuv_to_rgb_ref(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                   full_range: bool, matrix: int = 2) -> np.ndarray:
    """4:2:0 planes -> uint8 RGB as swscale's unscaled SIMD YUV -> RGB
    converts them (I420 limited range, or J420 full range; BT.601 unless
    ``matrix`` names another)."""
    yc, yo, vr, ub, ug, vg = _coeffs(full_range, matrix)
    h, w = y.shape

    def mul(a, k):  # pmulhw of a saturated 16-bit lane
        a = np.clip(a, -32768, 32767)
        return (a * k) >> 16

    u = cb[np.arange(h) // 2][:, np.arange(w) // 2].astype(np.int64)
    v = cr[np.arange(h) // 2][:, np.arange(w) // 2].astype(np.int64)
    yy = mul(y.astype(np.int64) * 8 - yo, yc)
    uu, vv = u * 8 - 1024, v * 8 - 1024
    g = np.clip(mul(uu, ug) + mul(vv, vg), -32768, 32767)
    rgb = [yy + mul(vv, vr), yy + g, yy + mul(uu, ub)]
    return np.stack([np.clip(np.clip(c, -32768, 32767), 0, 255)
                     for c in rgb], -1).astype(np.uint8)


# --- H.264 ---------------------------------------------------------------------

_NORM4 = ((10, 16, 13), (11, 18, 14), (13, 20, 16), (14, 23, 18), (16, 25, 20),
          (18, 29, 23))
_NORM8 = ((20, 18, 32, 19, 25, 24), (22, 19, 35, 21, 28, 26),
          (26, 23, 42, 24, 33, 31), (28, 25, 45, 26, 35, 33),
          (32, 28, 51, 30, 40, 38), (36, 32, 58, 34, 46, 43))


def _norm(n: int, m: int) -> np.ndarray:
    """normAdjust4x4 / normAdjust8x8 (raster) for qP % 6 == m."""
    i, j = np.mgrid[0:n, 0:n]
    if n == 4:
        v = _NORM4[m]
        return np.where((i % 2 == 0) & (j % 2 == 0), v[0],
                        np.where((i % 2 == 1) & (j % 2 == 1), v[1], v[2]))
    v = _NORM8[m]
    out = np.full((8, 8), v[5])
    out[((i % 4 == 0) & (j % 4 == 2)) | ((i % 4 == 2) & (j % 4 == 0))] = v[4]
    out[((i % 4 == 0) & (j % 2 == 1)) | ((i % 2 == 1) & (j % 4 == 0))] = v[3]
    out[(i % 4 == 2) & (j % 4 == 2)] = v[2]
    out[(i % 2 == 1) & (j % 2 == 1)] = v[1]
    out[(i % 4 == 0) & (j % 4 == 0)] = v[0]
    return out


def _idct4_1d(d):
    e0, e1 = d[0] + d[2], d[0] - d[2]
    e2, e3 = (d[1] >> 1) - d[3], d[1] + (d[3] >> 1)
    return [e0 + e3, e1 + e2, e1 - e2, e0 - e3]


def _idct8_1d(d):
    a0, a4 = d[0] + d[4], d[0] - d[4]
    a2, a6 = (d[2] >> 1) - d[6], d[2] + (d[6] >> 1)
    b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
    a1 = -d[3] + d[5] - d[7] - (d[7] >> 1)
    a3 = d[1] + d[7] - d[3] - (d[3] >> 1)
    a5 = -d[1] + d[7] + d[5] + (d[5] >> 1)
    a7 = d[3] + d[5] + d[1] + (d[1] >> 1)
    b1, b7 = a1 + (a7 >> 2), a7 - (a1 >> 2)
    b3, b5 = a3 + (a5 >> 2), (a3 >> 2) - a5
    return [b0 + b7, b2 + b5, b4 + b3, b6 + b1, b6 - b1, b4 - b3, b2 - b5,
            b0 - b7]


def h264_idct_ref(levels: np.ndarray, weights: np.ndarray, qp: int,
                  pred: np.ndarray) -> np.ndarray:
    """H.264's scaling (8.5.12.1 / 8.5.13.1) and inverse transform (8.5.12.2 /
    8.5.13.2) of an n x n block of levels (raster, n 4 or 8) under the
    scaling list ``weights`` (raster) and QP ``qp``, added to ``pred``
    (uint8 n x n) and clipped."""
    c = np.asarray(levels, np.int64)
    n = c.shape[0]
    ls = np.asarray(weights, np.int64) * _norm(n, qp % 6)
    q6 = qp // 6
    if n == 4:
        d = (c * ls) << (q6 - 4) if qp >= 24 else \
            (c * ls + (1 << (3 - q6))) >> (4 - q6)
        one = _idct4_1d
    else:
        d = (c * ls) << (q6 - 6) if qp >= 36 else \
            (c * ls + (1 << (5 - q6))) >> (6 - q6)
        one = _idct8_1d
    rows = np.stack(one([d[:, k] for k in range(n)]), 1)    # each row
    cols = np.stack(one([rows[k] for k in range(n)]), 0)    # each column
    r = (cols + 32) >> 6
    return np.clip(np.asarray(pred, np.int64) + r, 0, 255).astype(np.uint8)


def _clamped(plane, x, y, w, h):
    ph, pw = plane.shape
    ys = np.clip(np.arange(y, y + h), 0, ph - 1)
    xs = np.clip(np.arange(x, x + w), 0, pw - 1)
    return plane[np.ix_(ys, xs)].astype(np.int64)


def h264_luma_mc_ref(plane: np.ndarray, x: int, y: int, fx: int, fy: int,
                     w: int, h: int) -> np.ndarray:
    """A w x h luma block at integer (x, y) plus the quarter-sample
    fraction (fx, fy) (8.4.2.2.1), the plane's samples outside it those of
    its nearest edge."""
    g = _clamped(plane, x - 2, y - 2, w + 6, h + 6)  # G at [2 + r, 2 + c]

    def tap(a):  # the 6-tap filter along axis 0 of a stack of 6
        return a[0] - 5 * a[1] + 20 * a[2] + 20 * a[3] - 5 * a[4] + a[5]

    b1 = tap([g[:, k:k + w + 1] for k in range(6)])        # (h+6, w+1) at x+k+1/2
    h1 = tap([g[k:k + h + 1, :] for k in range(6)])        # (h+1, w+6) at y+k+1/2
    j1 = tap([b1[k:k + h + 1] for k in range(6)])          # (h+1, w+1)
    clip = lambda v: np.clip(v, 0, 255)  # noqa: E731
    G = g[2:2 + h + 1, 2:2 + w + 1]
    b = clip((b1[2:2 + h + 1] + 16) >> 5)                 # b at rows 0..h
    hh = clip((h1[:, 2:2 + w + 1] + 16) >> 5)             # h at cols 0..w
    j = clip((j1 + 512) >> 10)
    avg = lambda p, q: (p + q + 1) >> 1  # noqa: E731
    B, Bd = b[:h, :w], b[1:, :w]           # b(x, y), b(x, y+1)
    Hh, Hr = hh[:h, :w], hh[:h, 1:]        # h(x, y), h(x+1, y)
    J = j[:h, :w]
    Gc, Gr, Gd = G[:h, :w], G[:h, 1:], G[1:, :w]
    out = {
        (0, 0): Gc, (1, 0): avg(Gc, B), (2, 0): B, (3, 0): avg(B, Gr),
        (0, 1): avg(Gc, Hh), (1, 1): avg(B, Hh), (2, 1): avg(B, J),
        (3, 1): avg(B, Hr), (0, 2): Hh, (1, 2): avg(Hh, J), (2, 2): J,
        (3, 2): avg(J, Hr), (0, 3): avg(Hh, Gd), (1, 3): avg(Hh, Bd),
        (2, 3): avg(J, Bd), (3, 3): avg(Hr, Bd),
    }[(fx, fy)]
    return out.astype(np.uint8)


def h264_chroma_mc_ref(plane: np.ndarray, x: int, y: int, fx: int, fy: int,
                       w: int, h: int) -> np.ndarray:
    """A w x h chroma block at integer (x, y) plus the eighth-sample
    fraction (fx, fy) (8.4.2.2.2), edges as in ``h264_luma_mc_ref``."""
    p = _clamped(plane, x, y, w + 1, h + 1)
    a, b, c, d = p[:h, :w], p[:h, 1:], p[1:, :w], p[1:, 1:]
    return (((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b + (8 - fx) * fy * c +
             fx * fy * d + 32) >> 6).astype(np.uint8)


_ALPHA = (0,) * 16 + (4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28,
                      32, 36, 40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127,
                      144, 162, 182, 203, 226, 255, 255)
_BETA = (0,) * 16 + (2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10,
                     10, 11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
                     17, 18, 18)
_TC0 = ((0, 0, 0),) * 17 + (
    (0, 0, 1), (0, 0, 1), (0, 0, 1), (0, 0, 1), (0, 1, 1), (0, 1, 1), (1, 1, 1),
    (1, 1, 1), (1, 1, 1), (1, 1, 1), (1, 1, 2), (1, 1, 2), (1, 1, 2), (1, 1, 2),
    (1, 2, 3), (1, 2, 3), (2, 2, 3), (2, 2, 4), (2, 3, 4), (2, 3, 4), (3, 3, 5),
    (3, 4, 6), (3, 4, 6), (4, 5, 7), (4, 5, 8), (4, 6, 9), (5, 7, 10),
    (6, 8, 11), (6, 8, 13), (7, 10, 14), (8, 11, 16), (9, 12, 18),
    (10, 13, 20), (11, 15, 23), (13, 17, 25))


def h264_edge_ref(lines: np.ndarray, bs: int, index_a: int, index_b: int,
                  chroma: bool) -> np.ndarray:
    """The deblocking filter (8.7.2.3 / 8.7.2.4) on lines of 8 samples
    p3..p0 q0..q3 across one edge (uint8 (n, 8)) under bS 1..4, indexA
    and indexB; a luma edge, or a chroma one."""
    s = np.asarray(lines, np.int64).copy()
    p3, p2, p1, p0, q0, q1, q2, q3 = (s[:, k].copy() for k in range(8))
    alpha, beta = _ALPHA[index_a], _BETA[index_b]
    on = (np.abs(p0 - q0) < alpha) & (np.abs(p1 - p0) < beta) & \
        (np.abs(q1 - q0) < beta)
    ap, aq = np.abs(p2 - p0), np.abs(q2 - q0)
    if bs < 4:
        tc0 = _TC0[index_a][bs - 1]
        tc = tc0 + 1 if chroma else tc0 + (ap < beta) + (aq < beta)
        d = np.clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
        new = {3: np.clip(p0 + d, 0, 255), 4: np.clip(q0 - d, 0, 255)}
        if not chroma:
            avg = (p0 + q0 + 1) >> 1
            new[2] = np.where(ap < beta, p1 + np.clip((p2 + avg - 2 * p1) >> 1,
                                                      -tc0, tc0), p1)
            new[5] = np.where(aq < beta, q1 + np.clip((q2 + avg - 2 * q1) >> 1,
                                                      -tc0, tc0), q1)
    elif chroma:
        new = {3: (2 * p1 + p0 + q1 + 2) >> 2, 4: (2 * q1 + q0 + p1 + 2) >> 2}
    else:
        small = np.abs(p0 - q0) < ((alpha >> 2) + 2)
        sp, sq = (ap < beta) & small, (aq < beta) & small
        new = {
            3: np.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                        (2 * p1 + p0 + q1 + 2) >> 2),
            2: np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1),
            1: np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2),
            4: np.where(sq, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3,
                        (2 * q1 + q0 + p1 + 2) >> 2),
            5: np.where(sq, (p0 + q0 + q1 + q2 + 2) >> 2, q1),
            6: np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2),
        }
    for k, v in new.items():
        s[:, k] = np.where(on, v, s[:, k])
    return s.astype(np.uint8)


def h264_idct(levels, weights, qp: int, pred) -> np.ndarray:
    """The compiled ``h264_idct_ref``."""
    lib = load_library()
    c = np.ascontiguousarray(levels, np.int16)
    n = c.shape[0]
    w = np.ascontiguousarray(weights, np.uint8)
    out = np.ascontiguousarray(pred, np.uint8).copy()
    lib.vd_h264_idct(c.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), _u8(w),
                     int(qp), n, _u8(out))
    return out


def h264_mc(plane, x: int, y: int, fx: int, fy: int, w: int, h: int,
            chroma: bool) -> np.ndarray:
    """The compiled ``h264_luma_mc_ref`` / ``h264_chroma_mc_ref``."""
    lib = load_library()
    src = np.ascontiguousarray(plane, np.uint8)
    out = np.empty((h, w), np.uint8)
    lib.vd_h264_mc(_u8(src), src.shape[1], src.shape[0], int(chroma), int(x),
                   int(y), int(fx), int(fy), int(w), int(h), _u8(out))
    return out


def h264_edge(lines, bs: int, index_a: int, index_b: int,
              chroma: bool) -> np.ndarray:
    """The compiled ``h264_edge_ref``."""
    lib = load_library()
    s = np.ascontiguousarray(lines, np.uint8).copy()
    q0 = ctypes.cast(s.ctypes.data + 4, ctypes.POINTER(ctypes.c_uint8))
    lib.vd_h264_edge(q0, 8, s.shape[0], int(bs), int(index_a), int(index_b),
                     int(chroma))
    return s


def h264_bipred_ref(a, b, w0=None, w1=None, logwd=5, offset=0,
                    x86=True) -> np.ndarray:
    """Bi-prediction (8.4.2.3) of two uint8 predictions of one block: the
    default average where ``w0`` is None, else weights w0 / w1 with
    denominator ``logwd`` and offset ``offset`` (o0 + o1), as FFmpeg's x86
    routine computes it (``x86``: 16-bit lanes with saturation, a weight of
    128 halved with the denominator, which it takes for blocks 4 or more
    samples wide) or as the standard's formula (its C routine, for 2-wide
    chroma)."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    if w0 is None:
        return ((a + b + 1) >> 1).astype(np.uint8)
    off = (offset + 1) | 1
    if not x86:
        return np.clip((a * w0 + b * w1 + (off << logwd)) >> (logwd + 1), 0,
                       255).astype(np.uint8)
    sh = logwd + 1
    if w0 == 128 or w1 == 128:
        w0, w1, off, sh = w0 >> 1, w1 >> 1, off >> 1, sh - 1
    o16 = ((((off << sh) & 0xFFFFFFFF) >> 1) + 0x8000) % 0x10000 - 0x8000
    sat = lambda v: np.clip(v, -32768, 32767)  # noqa: E731
    return np.clip(sat(sat(a * w0 + b * w1) + o16) >> sh, 0, 255).astype(np.uint8)


def _clip8(v):
    return max(-128, min(127, v))


def _tx(td):
    """(16384 + |td / 2|) / td, truncated toward zero as C divides."""
    q = (16384 + abs(td) // 2) // abs(td)
    return q if td > 0 else -q


def h264_temporal_scale_ref(cur_poc: int, poc0: int, poc1: int, long0: bool,
                            mv_col) -> tuple:
    """Temporal direct (8.4.1.2.3): DistScaleFactor of list 0 picture POC
    ``poc0`` (long-term ``long0``) against list 1's first at ``poc1`` for
    the current picture at ``cur_poc``, and mvL0, mvL1 from the co-located
    motion vector ``mv_col``."""
    td = _clip8(poc1 - poc0)
    if td == 0 or long0:
        sc = 256
    else:
        tb = _clip8(cur_poc - poc0)
        sc = max(-1024, min(1023, (tb * _tx(td) + 32) >> 6))
    mv0 = tuple(((sc * int(c) + 128) >> 8) for c in mv_col)
    return sc, mv0, tuple(m - int(c) for m, c in zip(mv0, mv_col))


def h264_implicit_weights_ref(cur_poc: int, pocs0, pocs1, long0=None,
                              long1=None) -> np.ndarray:
    """Implicit bi-prediction weights (8.4.2.3.1): w0 of every pair of a
    list 0 and a list 1 picture (w1 is 64 - w0), 32 where a picture is
    long-term, the POCs are equal or the scale leaves [-64, 128]."""
    long0 = long0 or [False] * len(pocs0)
    long1 = long1 or [False] * len(pocs1)
    out = np.full((len(pocs0), len(pocs1)), 32, np.int64)
    for i, (p0, l0) in enumerate(zip(pocs0, long0)):
        for j, (p1, l1) in enumerate(zip(pocs1, long1)):
            td = _clip8(p1 - p0)
            if l0 or l1 or not td:
                continue
            d = (_clip8(cur_poc - p0) * _tx(td) + 32) >> 8
            if -64 <= d <= 128:
                out[i, j] = 64 - d
    return out


def h264_bipred(a, b, w0=None, w1=None, logwd=5, offset=0,
                x86=True) -> np.ndarray:
    """The compiled ``h264_bipred_ref``."""
    lib = load_library()
    a = np.ascontiguousarray(a, np.uint8)
    b = np.ascontiguousarray(b, np.uint8)
    out = np.empty_like(a)
    lib.vd_h264_bipred(_u8(a), _u8(b), a.size, int(logwd), int(w0 or 0),
                       int(w1 or 0), int(offset),
                       0 if w0 is None else 2 if x86 else 1, _u8(out))
    return out


def h264_temporal_scale(cur_poc: int, poc0: int, poc1: int, long0: bool,
                        mv_col) -> tuple:
    """The compiled ``h264_temporal_scale_ref``."""
    lib = load_library()
    mc = (ctypes.c_int16 * 2)(*[int(v) for v in mv_col])
    mv = (ctypes.c_int32 * 4)()
    sc = lib.vd_h264_temporal(int(cur_poc), int(poc0), int(poc1), int(long0), mc, mv)
    return int(sc), (int(mv[0]), int(mv[1])), (int(mv[2]), int(mv[3]))


def h264_implicit_weights(cur_poc: int, pocs0, pocs1, long0=None,
                          long1=None) -> np.ndarray:
    """The compiled ``h264_implicit_weights_ref``."""
    lib = load_library()
    long0 = long0 or [False] * len(pocs0)
    long1 = long1 or [False] * len(pocs1)
    return np.array([[lib.vd_h264_implicit(int(cur_poc), int(p0), int(p1), int(l0), int(l1))
                      for p1, l1 in zip(pocs1, long1)] for p0, l0 in zip(pocs0, long0)],
                    np.int64).reshape(len(pocs0), len(pocs1))


# --- VP9's arithmetic in plain numpy (tests only) -----------------------------

_COSPI = (16384, 16364, 16305, 16207, 16069, 15893, 15679, 15426, 15137, 14811,
          14449, 14053, 13623, 13160, 12665, 12140, 11585, 11003, 10394, 9760,
          9102, 8423, 7723, 7005, 6270, 5520, 4756, 3981, 3196, 2404, 1606, 804)
_SINPI = (0, 5283, 9929, 13377, 15212)


def _r14(x):
    return (x + (1 << 13)) >> 14


def _idct4_vp9(x):
    c = _COSPI
    s0, s1 = _r14((x[0] + x[2]) * c[16]), _r14((x[0] - x[2]) * c[16])
    s2, s3 = _r14(x[1] * c[24] - x[3] * c[8]), _r14(x[1] * c[8] + x[3] * c[24])
    return [s0 + s3, s1 + s2, s1 - s2, s0 - s3]


def _idct_vp9(x):
    """libvpx's n-point inverse DCT (n = 4, 8, 16, 32) of a list of int64
    arrays: the even half an n/2-point IDCT, the odd half its butterflies."""
    n, c = len(x), _COSPI
    if n == 4:
        return _idct4_vp9(x)
    e = _idct_vp9(x[0::2])
    if n == 8:
        s4, s7 = _r14(x[1] * c[28] - x[7] * c[4]), _r14(x[1] * c[4] + x[7] * c[28])
        s5, s6 = _r14(x[5] * c[12] - x[3] * c[20]), _r14(x[5] * c[20] + x[3] * c[12])
        t4, t5, t6, t7 = s4 + s5, s4 - s5, -s6 + s7, s6 + s7
        o = [t7, _r14((t5 + t6) * c[16]), _r14((t6 - t5) * c[16]), t4]
        return [e[i] + o[i] for i in range(4)] + [e[3 - i] - o[3 - i] for i in range(4)]
    if n == 16:
        a = {8: x[1], 9: x[9], 10: x[5], 11: x[13], 12: x[3], 13: x[11], 14: x[7], 15: x[15]}
        b = {}
        for lo, hi, k1, k2 in ((8, 15, 30, 2), (9, 14, 14, 18), (10, 13, 22, 10), (11, 12, 6, 26)):
            b[lo] = _r14(a[lo] * c[k1] - a[hi] * c[k2])
            b[hi] = _r14(a[lo] * c[k2] + a[hi] * c[k1])
        a = {8: b[8] + b[9], 9: b[8] - b[9], 10: -b[10] + b[11], 11: b[10] + b[11],
             12: b[12] + b[13], 13: b[12] - b[13], 14: -b[14] + b[15], 15: b[14] + b[15]}
        b = {8: a[8], 15: a[15], 11: a[11], 12: a[12],
             9: _r14(-a[9] * c[8] + a[14] * c[24]), 14: _r14(a[9] * c[24] + a[14] * c[8]),
             10: _r14(-a[10] * c[24] - a[13] * c[8]), 13: _r14(-a[10] * c[8] + a[13] * c[24])}
        a = {8: b[8] + b[11], 9: b[9] + b[10], 10: b[9] - b[10], 11: b[8] - b[11],
             12: -b[12] + b[15], 13: -b[13] + b[14], 14: b[13] + b[14], 15: b[12] + b[15]}
        b = {8: a[8], 9: a[9], 14: a[14], 15: a[15],
             10: _r14((-a[10] + a[13]) * c[16]), 13: _r14((a[10] + a[13]) * c[16]),
             11: _r14((-a[11] + a[12]) * c[16]), 12: _r14((a[11] + a[12]) * c[16])}
        return [e[i] + b[15 - i] for i in range(8)] + [e[7 - i] - b[8 + i] for i in range(8)]
    s = {}
    for k, a_ in enumerate((1, 17, 9, 25, 5, 21, 13, 29)):
        b_ = 32 - a_
        s[16 + k] = _r14(x[a_] * c[32 - a_] - x[b_] * c[a_])
        s[31 - k] = _r14(x[a_] * c[a_] + x[b_] * c[32 - a_])
    t = {}
    for k in range(16, 32, 4):
        t[k], t[k + 1] = s[k] + s[k + 1], s[k] - s[k + 1]
        t[k + 2], t[k + 3] = -s[k + 2] + s[k + 3], s[k + 2] + s[k + 3]
    s = dict(t)
    for lo, hi, k1, k2, neg in ((17, 30, 4, 28, False), (18, 29, 28, 4, True),
                                (21, 26, 20, 12, False), (22, 25, 12, 20, True)):
        if not neg:
            s[lo], s[hi] = _r14(-t[lo] * c[k1] + t[hi] * c[k2]), _r14(t[lo] * c[k2] + t[hi] * c[k1])
        else:
            s[lo], s[hi] = _r14(-t[lo] * c[k1] - t[hi] * c[k2]), _r14(-t[lo] * c[k2] + t[hi] * c[k1])
    t = {16: s[16] + s[19], 17: s[17] + s[18], 18: s[17] - s[18], 19: s[16] - s[19],
         20: -s[20] + s[23], 21: -s[21] + s[22], 22: s[21] + s[22], 23: s[20] + s[23],
         24: s[24] + s[27], 25: s[25] + s[26], 26: s[25] - s[26], 27: s[24] - s[27],
         28: -s[28] + s[31], 29: -s[29] + s[30], 30: s[29] + s[30], 31: s[28] + s[31]}
    s = dict(t)
    for lo, hi in ((18, 29), (19, 28)):
        s[lo], s[hi] = _r14(-t[lo] * c[8] + t[hi] * c[24]), _r14(t[lo] * c[24] + t[hi] * c[8])
    for lo, hi in ((20, 27), (21, 26)):
        s[lo], s[hi] = _r14(-t[lo] * c[24] - t[hi] * c[8]), _r14(-t[lo] * c[8] + t[hi] * c[24])
    t = {}
    for i in range(4):
        t[16 + i] = s[16 + i] + s[23 - i]
        t[23 - i] = s[16 + i] - s[23 - i]
        t[24 + i] = -s[24 + i] + s[31 - i]
        t[31 - i] = s[24 + i] + s[31 - i]
    s = dict(t)
    for k in range(4):
        lo, hi = 20 + k, 27 - k
        s[lo], s[hi] = _r14((-t[lo] + t[hi]) * c[16]), _r14((t[lo] + t[hi]) * c[16])
    return [e[i] + s[31 - i] for i in range(16)] + [e[15 - i] - s[16 + i] for i in range(16)]


def _iadst_vp9(x):
    """libvpx's iadst4 / iadst8 / iadst16 (a zero input gives zeros)."""
    n, c, s9 = len(x), _COSPI, _SINPI
    zero = ~np.any(np.stack(x) != 0, axis=0)
    if n == 4:
        x0, x1, x2, x3 = x
        s0, s1, s2 = s9[1] * x0, s9[2] * x0, s9[3] * x1
        s3, s4, s5, s6 = s9[4] * x2, s9[1] * x2, s9[2] * x3, s9[4] * x3
        s7 = x0 - x2 + x3
        s0, s1, s3, s2 = s0 + s3 + s5, s1 - s4 - s6, s2, s9[3] * s7
        out = [_r14(s0 + s3), _r14(s1 + s3), _r14(s2), _r14(s0 + s1 - s3)]
    elif n == 8:
        x0, x1, x2, x3, x4, x5, x6, x7 = (x[7], x[0], x[5], x[2], x[3], x[4], x[1], x[6])
        s = [c[2] * x0 + c[30] * x1, c[30] * x0 - c[2] * x1, c[10] * x2 + c[22] * x3,
             c[22] * x2 - c[10] * x3, c[18] * x4 + c[14] * x5, c[14] * x4 - c[18] * x5,
             c[26] * x6 + c[6] * x7, c[6] * x6 - c[26] * x7]
        x0, x1, x2, x3 = (_r14(s[i] + s[i + 4]) for i in range(4))
        x4, x5, x6, x7 = (_r14(s[i] - s[i + 4]) for i in range(4))
        s4, s5 = c[8] * x4 + c[24] * x5, c[24] * x4 - c[8] * x5
        s6, s7 = -c[24] * x6 + c[8] * x7, c[8] * x6 + c[24] * x7
        x0, x1, x2, x3 = x0 + x2, x1 + x3, x0 - x2, x1 - x3
        x4, x5, x6, x7 = _r14(s4 + s6), _r14(s5 + s7), _r14(s4 - s6), _r14(s5 - s7)
        x2, x3 = _r14(c[16] * (x2 + x3)), _r14(c[16] * (x2 - x3))
        x6, x7 = _r14(c[16] * (x6 + x7)), _r14(c[16] * (x6 - x7))
        out = [x0, -x4, x6, -x2, x3, -x7, x5, -x1]
    else:
        v = [x[i] for i in (15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14)]
        ks = (1, 5, 9, 13, 17, 21, 25, 29)
        s = []
        for j, k in enumerate(ks):
            a, b = v[2 * j], v[2 * j + 1]
            s += [a * c[k] + b * c[32 - k], a * c[32 - k] - b * c[k]]
        v = [_r14(s[i] + s[i + 8]) for i in range(8)] + [_r14(s[i] - s[i + 8]) for i in range(8)]
        s = v[:8] + [v[8] * c[4] + v[9] * c[28], v[8] * c[28] - v[9] * c[4],
                     v[10] * c[20] + v[11] * c[12], v[10] * c[12] - v[11] * c[20],
                     -v[12] * c[28] + v[13] * c[4], v[12] * c[4] + v[13] * c[28],
                     -v[14] * c[12] + v[15] * c[20], v[14] * c[20] + v[15] * c[12]]
        v = [s[i] + s[i + 4] for i in range(4)] + [s[i] - s[i + 4] for i in range(4)] + \
            [_r14(s[8 + i] + s[12 + i]) for i in range(4)] + [_r14(s[8 + i] - s[12 + i]) for i in range(4)]
        def rot(a, b):
            return [a * c[8] + b * c[24], a * c[24] - b * c[8]]

        def rot2(a, b):
            return [-a * c[24] + b * c[8], a * c[8] + b * c[24]]
        s = v[0:4] + rot(v[4], v[5]) + rot2(v[6], v[7]) + v[8:12] + rot(v[12], v[13]) + rot2(v[14], v[15])
        v = [s[0] + s[2], s[1] + s[3], s[0] - s[2], s[1] - s[3],
             _r14(s[4] + s[6]), _r14(s[5] + s[7]), _r14(s[4] - s[6]), _r14(s[5] - s[7]),
             s[8] + s[10], s[9] + s[11], s[8] - s[10], s[9] - s[11],
             _r14(s[12] + s[14]), _r14(s[13] + s[15]), _r14(s[12] - s[14]), _r14(s[13] - s[15])]
        x2, x3 = _r14(-c[16] * (v[2] + v[3])), _r14(c[16] * (v[2] - v[3]))
        x6, x7 = _r14(c[16] * (v[6] + v[7])), _r14(c[16] * (-v[6] + v[7]))
        x10, x11 = _r14(c[16] * (v[10] + v[11])), _r14(c[16] * (-v[10] + v[11]))
        x14, x15 = _r14(-c[16] * (v[14] + v[15])), _r14(c[16] * (v[14] - v[15]))
        out = [v[0], -v[8], v[12], -v[4], x6, x14, x10, x2, x3, x11, x15, x7,
               v[5], -v[13], v[9], -v[1]]
    return [np.where(zero, 0, o) for o in out]


def vp9_transform_1d(x, adst: bool):
    """One 1-D inverse transform of libvpx's (the plain version's) over the
    rows of the int64 array x (n inputs a row)."""
    cols = [x[:, k].astype(np.int64) for k in range(x.shape[1])]
    return np.stack((_iadst_vp9 if adst else _idct_vp9)(cols), axis=1)


def vp9_itx_ref(coef: np.ndarray, tx: int, tx_type: int, pred: np.ndarray) -> np.ndarray:
    """VP9's inverse transform of one n x n block (n = 4 << tx) of
    dequantised coefficients (raster order), added to the uint8 prediction:
    ``tx_type`` 0-3 (DCT_DCT, ADST_DCT: ADST down the columns, DCT_ADST,
    ADST_ADST; 32x32 is DCT only) or 4, the WHT of lossless frames (tx 0).
    Rows first, then columns, then the rounding shift of the size; no
    16-bit wrap (FFmpeg's arithmetic, equal on a conforming stream)."""
    c = np.asarray(coef, np.int64).reshape(4 << tx, 4 << tx)
    p = np.asarray(pred, np.int64)
    if tx_type == 4:
        def wht(a, c_, d, b):  # vpx_iwht4x4_16_add_c's butterflies
            a = a + c_
            d = d - b
            e = (a - d) >> 1
            b, c_ = e - b, e - c_
            return a - b, b, c_, d + c_
        rows = np.stack(wht(*(c[:, k] >> 2 for k in range(4))), axis=1)
        res = np.stack(wht(*(rows[k] for k in range(4))), axis=0)
        return np.clip(p + res, 0, 255).astype(np.uint8)
    row_adst = tx < 3 and tx_type in (2, 3)
    col_adst = tx < 3 and tx_type in (1, 3)
    t = vp9_transform_1d(c, row_adst)
    t = vp9_transform_1d(t.T, col_adst).T
    shift = 4 if tx == 0 else 5 if tx == 1 else 6
    return np.clip(p + ((t + (1 << (shift - 1))) >> shift), 0, 255).astype(np.uint8)


def _vp9_taps(filt: int) -> np.ndarray:
    if filt == 3:
        k = np.arange(16)
        t = np.zeros((16, 8), np.int64)
        t[:, 3], t[:, 4] = 128 - 8 * k, 8 * k
        return t
    return _VP9_FILTERS[filt]


# libvpx's vp9_filter.c kernels: regular, smooth (lp), sharp; row 0 is the copy
_VP9_FILTERS = np.array([
    [[0, 0, 0, 128, 0, 0, 0, 0], [0, 1, -5, 126, 8, -3, 1, 0],
     [-1, 3, -10, 122, 18, -6, 2, 0], [-1, 4, -13, 118, 27, -9, 3, -1],
     [-1, 4, -16, 112, 37, -11, 4, -1], [-1, 5, -18, 105, 48, -14, 4, -1],
     [-1, 5, -19, 97, 58, -16, 5, -1], [-1, 6, -19, 88, 68, -18, 5, -1],
     [-1, 6, -19, 78, 78, -19, 6, -1], [-1, 5, -18, 68, 88, -19, 6, -1],
     [-1, 5, -16, 58, 97, -19, 5, -1], [-1, 4, -14, 48, 105, -18, 5, -1],
     [-1, 4, -11, 37, 112, -16, 4, -1], [-1, 3, -9, 27, 118, -13, 4, -1],
     [0, 2, -6, 18, 122, -10, 3, -1], [0, 1, -3, 8, 126, -5, 1, 0]],
    [[0, 0, 0, 128, 0, 0, 0, 0], [-3, -1, 32, 64, 38, 1, -3, 0],
     [-2, -2, 29, 63, 41, 2, -3, 0], [-2, -2, 26, 63, 43, 4, -4, 0],
     [-2, -3, 24, 62, 46, 5, -4, 0], [-2, -3, 21, 60, 49, 7, -4, 0],
     [-1, -4, 18, 59, 51, 9, -4, 0], [-1, -4, 16, 57, 53, 12, -4, -1],
     [-1, -4, 14, 55, 55, 14, -4, -1], [-1, -4, 12, 53, 57, 16, -4, -1],
     [0, -4, 9, 51, 59, 18, -4, -1], [0, -4, 7, 49, 60, 21, -3, -2],
     [0, -4, 5, 46, 62, 24, -3, -2], [0, -4, 4, 43, 63, 26, -2, -2],
     [0, -3, 2, 41, 63, 29, -2, -2], [0, -3, 1, 38, 64, 32, -1, -3]],
    [[0, 0, 0, 128, 0, 0, 0, 0], [-1, 3, -7, 127, 8, -3, 1, 0],
     [-2, 5, -13, 125, 17, -6, 3, -1], [-3, 7, -17, 121, 27, -10, 5, -2],
     [-4, 9, -20, 115, 37, -13, 6, -2], [-4, 10, -23, 108, 48, -16, 8, -3],
     [-4, 10, -24, 100, 59, -19, 9, -3], [-4, 11, -24, 90, 70, -21, 10, -4],
     [-4, 11, -23, 80, 80, -23, 11, -4], [-4, 10, -21, 70, 90, -24, 11, -4],
     [-3, 9, -19, 59, 100, -24, 10, -4], [-3, 8, -16, 48, 108, -23, 10, -4],
     [-2, 6, -13, 37, 115, -20, 9, -4], [-2, 5, -10, 27, 121, -17, 7, -3],
     [-1, 3, -6, 17, 125, -13, 5, -2], [0, 1, -3, 8, 127, -7, 3, -1]]], np.int64)


def vp9_mc_ref(plane: np.ndarray, x: int, y: int, fx: int, fy: int, w: int,
               h: int, filt: int, dst=None) -> np.ndarray:
    """One w x h inter prediction of uint8 ``plane`` at full-sample (x, y)
    plus the 1/16 fraction (fx, fy), samples outside the plane those of its
    edge: the 8-tap filter ``filt`` (0 regular, 1 smooth, 2 sharp, 3
    bilinear) across the rows the vertical pass needs, rounded and clipped
    to 8 bits, then down the columns; where ``dst`` is given, the rounded
    average with it (a compound block's second prediction)."""
    ph, pw = plane.shape
    ys = np.clip(np.arange(y - 3, y + h + 4), 0, ph - 1)
    xs = np.clip(np.arange(x - 3, x + w + 4), 0, pw - 1)
    src = plane[np.ix_(ys, xs)].astype(np.int64)
    taps = _vp9_taps(filt)
    if fx:
        t = sum(taps[fx][k] * src[:, k:k + w] for k in range(8))
        t = np.clip((t + 64) >> 7, 0, 255)
    else:
        t = src[:, 3:3 + w]
    if fy:
        o = sum(taps[fy][k] * t[k:k + h] for k in range(8))
        o = np.clip((o + 64) >> 7, 0, 255)
    else:
        o = t[3:3 + h]
    if dst is not None:
        o = (np.asarray(dst, np.int64) + o + 1) >> 1
    return o.astype(np.uint8)


def _vp9_limits(level: int, sharp: int):
    limit = level
    if sharp > 0:
        limit = min(limit >> ((sharp + 3) >> 2), 9 - sharp)
    limit = max(limit, 1)
    return 2 * (level + 2) + limit, limit, level >> 4


def vp9_lf_ref(lines: np.ndarray, wd: int, level: int, sharp: int) -> np.ndarray:
    """One VP9 loop-filter edge (FFmpeg's vp9dsp loop_filter) across uint8
    ``lines`` (n x 16: p7..p0 | q0..q7, the edge between columns 7 and 8),
    filter width ``wd`` (4, 8, 16) at ``level`` and ``sharpness``."""
    E, I, H = _vp9_limits(level, sharp)
    out = np.array(lines, np.int64)
    for v in out:
        p = v[7::-1]  # p0, p1, ...
        q = v[8:]
        if not (max(abs(p[3] - p[2]), abs(p[2] - p[1]), abs(p[1] - p[0]), abs(q[1] - q[0]),
                    abs(q[2] - q[1]), abs(q[3] - q[2])) <= I and
                abs(p[0] - q[0]) * 2 + (abs(p[1] - q[1]) >> 1) <= E):
            continue
        flat8in = wd >= 8 and all(abs(p[k] - p[0]) <= 1 and abs(q[k] - q[0]) <= 1
                                  for k in (1, 2, 3))
        flat8out = wd >= 16 and flat8in and all(abs(p[k] - p[0]) <= 1 and
                                                abs(q[k] - q[0]) <= 1 for k in range(4, 8))
        if flat8out or flat8in:
            m = 16 if flat8out else 8
            lo = 8 - m // 2
            seg = v[lo:lo + m].copy()
            half = m // 2 - 1
            for k in range(1, m - 1):
                idx = np.clip(np.arange(k - half, k + half + 1), 0, m - 1)
                v[lo + k] = (seg[idx].sum() + seg[k] + m // 2) >> (4 if m == 16 else 3)
            continue
        p0, p1, q0, q1 = p[0], p[1], q[0], q[1]
        hev = abs(p1 - p0) > H or abs(q1 - q0) > H
        f = np.clip(p1 - q1, -128, 127) if hev else 0
        f = int(np.clip(3 * (q0 - p0) + f, -128, 127))
        f1, f2 = min(f + 4, 127) >> 3, min(f + 3, 127) >> 3
        v[7], v[8] = np.clip(p0 + f2, 0, 255), np.clip(q0 - f1, 0, 255)
        if not hev:
            f = (f1 + 1) >> 1
            v[6], v[9] = np.clip(p1 + f, 0, 255), np.clip(q1 - f, 0, 255)
    return out.astype(np.uint8)


def vp9_itx(coef, tx: int, tx_type: int, pred) -> np.ndarray:
    """The compiled ``vp9_itx_ref``."""
    lib = load_library()
    c = np.ascontiguousarray(coef, np.int16)
    out = np.array(pred, np.uint8, order="C", copy=True)
    lib.vd_vp9_itx(c.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), int(tx),
                   int(tx_type), _u8(out))
    return out


def vp9_mc(plane, x: int, y: int, fx: int, fy: int, w: int, h: int, filt: int,
           dst=None) -> np.ndarray:
    """The compiled ``vp9_mc_ref``."""
    lib = load_library()
    p = np.ascontiguousarray(plane, np.uint8)
    out = np.zeros((h, w), np.uint8) if dst is None else np.array(dst, np.uint8, order="C", copy=True)
    lib.vd_vp9_mc(_u8(p), p.shape[1], p.shape[0], int(x), int(y), int(fx), int(fy),
                  int(w), int(h), int(filt), int(dst is not None), _u8(out))
    return out


def vp9_lf(lines, wd: int, level: int, sharp: int) -> np.ndarray:
    """The compiled ``vp9_lf_ref``."""
    lib = load_library()
    out = np.array(lines, np.uint8, order="C", copy=True)
    ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    edge = ctypes.cast(ctypes.addressof(ptr.contents) + 8, ctypes.POINTER(ctypes.c_uint8))
    lib.vd_vp9_lf(edge, out.shape[1], 1, out.shape[0], int(wd), int(level), int(sharp))
    return out


# --- HEVC's arithmetic in plain numpy (tests only) -------------------------------

def _hevc_dct_matrix() -> np.ndarray:
    """The standard's 32-point DCT matrix (8.6.4.2): row k, column n is
    64 sqrt(2) cos((2n + 1) k pi / 64) as the standard rounds it; an
    N-point transform takes rows 0, 32 / N, ... and the first N columns."""
    odd32 = (90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4)
    odd16 = (90, 87, 80, 70, 57, 43, 25, 9)
    odd8 = (89, 75, 50, 18)

    def mag(t):
        if t == 0 or t == 16:
            return 64
        if t == 32:
            return 0
        if t & 1:
            return odd32[t >> 1]
        if t & 2:
            return odd16[t >> 2]
        if t & 4:
            return odd8[t >> 3]
        return 83 if t == 8 else 36
    m = np.zeros((32, 32), np.int64)
    for k in range(32):
        for n in range(32):
            t, sign = (k * (2 * n + 1)) % 128, 1
            if t > 64:
                t = 128 - t
            if t > 32:
                t, sign = 64 - t, -1
            m[k, n] = 64 if k == 0 else sign * mag(t)
    return m


HEVC_DCT = _hevc_dct_matrix()
HEVC_DST = np.array([[29, 55, 74, 84], [74, 74, 0, -74], [84, -29, -74, 55],
                     [55, -84, 74, -29]], np.int64)


def hevc_idct_ref(coef: np.ndarray, log2: int, trtype: int = 0,
                  skip: bool = False) -> np.ndarray:
    """HEVC's inverse transform of an n x n block (n = 1 << log2) of scaled
    coefficients (8.6.4.2): the DCT, or the 4x4 DST (trtype 1), columns then
    rows, each stage's result clipped to 16 bits (the first after >> 7, the
    second after >> 12); transform skip (``skip``) is (d << 7) through the
    second stage's rounding. Returns the int16 residual."""
    n = 1 << log2
    d = np.asarray(coef, np.int64).reshape(n, n)
    if skip:
        return (((d << 7) + 2048) >> 12).astype(np.int16)
    t = HEVC_DST if trtype else HEVC_DCT[::32 // n, :n]
    e = t.T @ d                                  # columns: e[y, x] = sum_k t[k, y] d[k, x]
    g = np.clip((e + 64) >> 7, -32768, 32767)
    r = g @ t                                    # rows: r[y, x] = sum_k g[y, k] t[k, x]
    return np.clip((r + 2048) >> 12, -32768, 32767).astype(np.int16)


_HEVC_LUMA_TAPS = np.array([[0, 0, 0, 64, 0, 0, 0, 0], [-1, 4, -10, 58, 17, -5, 1, 0],
                            [-1, 4, -11, 40, 40, -11, 4, -1], [0, 1, -5, 17, 58, -10, 4, -1]],
                           np.int64)
_HEVC_CHROMA_TAPS = np.array([[0, 64, 0, 0], [-2, 58, 10, -2], [-4, 54, 16, -2],
                              [-6, 46, 28, -4], [-4, 36, 36, -4], [-4, 28, 46, -6],
                              [-2, 16, 54, -4], [-2, 10, 58, -2]], np.int64)


def _hevc_pred(plane, chroma, x, y, mvx, mvy, bw, bh):
    """One list's prediction samples (8.5.3.3.3), 14 bits."""
    h, w = plane.shape
    sh, mask = (3, 7) if chroma else (2, 3)
    taps = _HEVC_CHROMA_TAPS if chroma else _HEVC_LUMA_TAPS
    half = 1 if chroma else 3
    nt = taps.shape[1]
    xi, yi, fx, fy = x + (mvx >> sh), y + (mvy >> sh), mvx & mask, mvy & mask
    ys = np.clip(np.arange(yi - half, yi + bh + nt - 1 - half), 0, h - 1)
    xs = np.clip(np.arange(xi - half, xi + bw + nt - 1 - half), 0, w - 1)
    p = plane.astype(np.int64)[np.ix_(ys, xs)]
    if not fx and not fy:
        return p[half:half + bh, half:half + bw] << 6
    if not fy:
        return sum(taps[fx, t] * p[half:half + bh, t:t + bw] for t in range(nt))
    if not fx:
        return sum(taps[fy, t] * p[t:t + bh, half:half + bw] for t in range(nt))
    tmp = sum(taps[fx, t] * p[:, t:t + bw] for t in range(nt))
    return sum(taps[fy, t] * tmp[t:t + bh] for t in range(nt)) >> 6


def hevc_mc_ref(src0, src1, chroma: bool, x: int, y: int, mv, pred: int, bw: int,
                bh: int, weights=None) -> np.ndarray:
    """HEVC inter prediction of one bw x bh block at (x, y) of a plane
    (luma, or 4:2:0 chroma with mv in eighth samples): from src0 with
    mv[0:2] (pred 1), src1 with mv[2:4] (pred 2) or both (pred 3); the
    default weighting, or ``weights`` = (log2wd, w0, w1, o0, o1) explicit
    (8.5.3.3.4)."""
    a = _hevc_pred(np.asarray(src0, np.uint8), chroma, x, y, int(mv[0]), int(mv[1]), bw, bh) \
        if pred & 1 else None
    b = _hevc_pred(np.asarray(src1, np.uint8), chroma, x, y, int(mv[2]), int(mv[3]), bw, bh) \
        if pred & 2 else None
    if a is None:
        a, b = b, None
    if weights is None:
        v = (a + b + 64) >> 7 if b is not None else (a + 32) >> 6
    else:
        lwd, w0, w1, o0, o1 = (int(v) for v in weights)
        if b is not None:
            v = (a * w0 + b * w1 + ((o0 + o1 + 1) << lwd)) >> (lwd + 1)
        elif lwd >= 1:
            v = ((a * w0 + (1 << (lwd - 1))) >> lwd) + o0
        else:
            v = a * w0 + o0
    return np.clip(v, 0, 255).astype(np.uint8)


_HEVC_ANGLE = (0, 0, 32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
               -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32)
_HEVC_INV_ANGLE = {11: -4096, 12: -1638, 13: -910, 14: -630, 15: -482, 16: -390, 17: -315,
                   18: -256, 19: -315, 20: -390, 21: -482, 22: -630, 23: -910, 24: -1638,
                   25: -4096}


def hevc_intra_ref(ref, avail, log2: int, c: int, mode: int, strong: bool) -> np.ndarray:
    """HEVC intra prediction of an n x n block (8.4.4.2) from its references
    ``ref`` = p[-1][-1], the 2n left samples p[-1][0..2n-1] downwards, then
    the 2n top samples p[0..2n-1][-1] rightwards, and their availability:
    substitution, the luma filter (strong: the bilinear 32x32 smoothing),
    planar / DC / angular with the DC and pure horizontal / vertical edge
    filters of luma blocks under 32x32."""
    n = 1 << log2
    ref = [int(v) for v in ref]
    av = [bool(v) for v in avail]
    order = list(range(2 * n, 0, -1)) + [0] + list(range(2 * n + 1, 4 * n + 1))
    if not any(av):
        p = [128] * (4 * n + 1)
    else:
        p = list(ref)
        first = next(k for k in order if av[k])
        p[order[0]] = ref[first]
        for i in range(1, len(order)):
            if not av[order[i]]:
                p[order[i]] = p[order[i - 1]]

    def left(q, k):
        return q[0] if k < 0 else q[1 + k]

    def top(q, k):
        return q[0] if k < 0 else q[1 + 2 * n + k]
    q = p
    if c == 0 and mode != 1 and n > 4 and \
            min(abs(mode - 26), abs(mode - 10)) > {8: 7, 16: 1, 32: 0}[n]:
        if strong and n == 32 and abs(p[0] + top(p, 63) - 2 * top(p, 31)) < 8 and \
                abs(p[0] + left(p, 63) - 2 * left(p, 31)) < 8:
            f = [p[0]] + [((63 - k) * p[0] + (k + 1) * left(p, 63) + 32) >> 6 for k in range(63)]
            f += [left(p, 63)]
            f += [((63 - k) * p[0] + (k + 1) * top(p, 63) + 32) >> 6 for k in range(63)]
            f += [top(p, 63)]
        else:
            f = [(left(p, 0) + 2 * p[0] + top(p, 0) + 2) >> 2]
            f += [(left(p, k + 1) + 2 * left(p, k) + left(p, k - 1) + 2) >> 2
                  for k in range(2 * n - 1)] + [left(p, 2 * n - 1)]
            f += [(top(p, k + 1) + 2 * top(p, k) + top(p, k - 1) + 2) >> 2
                  for k in range(2 * n - 1)] + [top(p, 2 * n - 1)]
        q = f
    out = np.zeros((n, n), np.int64)
    yy, xx = np.mgrid[0:n, 0:n]
    lv = np.array([left(q, k) for k in range(n + 1)], np.int64)
    tv = np.array([top(q, k) for k in range(n + 1)], np.int64)
    if mode == 0:
        out = ((n - 1 - xx) * lv[yy] + (xx + 1) * tv[n] + (n - 1 - yy) * tv[xx] +
               (yy + 1) * lv[n] + n) >> (log2 + 1)
        return out.astype(np.uint8)
    if mode == 1:
        dc = (int(tv[:n].sum() + lv[:n].sum()) + n) >> (log2 + 1)
        out[:] = dc
        if c == 0 and n < 32:
            out[0, 0] = (lv[0] + 2 * dc + tv[0] + 2) >> 2
            out[0, 1:] = (tv[1:n] + 3 * dc + 2) >> 2
            out[1:, 0] = (lv[1:n] + 3 * dc + 2) >> 2
        return out.astype(np.uint8)
    angle = _HEVC_ANGLE[mode]
    vert = mode >= 18
    main = (lambda k: top(q, k)) if vert else (lambda k: left(q, k))
    side = (lambda k: left(q, k)) if vert else (lambda k: top(q, k))
    refa = {x: main(x - 1) for x in range(n + 1)}
    if angle < 0:
        if (n * angle) >> 5 < -1:
            for x in range((n * angle) >> 5, 0):
                refa[x] = side(-1 + ((x * _HEVC_INV_ANGLE[mode] + 128) >> 8))
    else:
        for x in range(n + 1, 2 * n + 1):
            refa[x] = main(x - 1)
    for j in range(n):
        idx, fact = ((j + 1) * angle) >> 5, ((j + 1) * angle) & 31
        for i in range(n):
            v = ((32 - fact) * refa[i + idx + 1] + fact * refa[i + idx + 2] + 16) >> 5 \
                if fact else refa[i + idx + 1]
            if vert:
                out[j, i] = v
            else:
                out[i, j] = v
    if c == 0 and n < 32:
        if mode == 26:
            out[:, 0] = np.clip(top(q, 0) + ((lv[:n] - q[0]) >> 1), 0, 255)
        if mode == 10:
            out[0, :] = np.clip(left(q, 0) + ((tv[:n] - q[0]) >> 1), 0, 255)
    return out.astype(np.uint8)


_HEVC_BETA = (0,) * 16 + tuple(range(6, 19)) + tuple(range(20, 65, 2))
_HEVC_TC = (0,) * 18 + (1,) * 9 + (2,) * 4 + (3,) * 4 + (4,) * 3 + (5, 5, 6, 6, 7, 8, 9, 10,
                                                                    11, 13, 14, 16, 18, 20, 22, 24)


def _hevc_chroma_qp(qpi):
    if qpi < 30:
        return qpi
    if qpi > 43:
        return qpi - 6
    return (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37)[qpi - 30]


def hevc_deblock_ref(lines: np.ndarray, chroma: bool, bs: int, qp: int, beta_offset: int,
                     tc_offset: int, pps_offset: int = 0, no_p: bool = False,
                     no_q: bool = False) -> np.ndarray:
    """One HEVC deblocking edge segment (8.7.2.5): ``lines`` is 4 x 8 uint8,
    p3..p0 | q0..q3 along each line; luma decisions (strong / weak, dEp /
    dEq) from lines 0 and 3, or the chroma filter where bS is 2 (its QpC
    from the average QpY plus the PPS offset, clipped into [0, 57] first as
    FFmpeg's chroma_tc does); offsets are the slice's div2 values; no_p /
    no_q keep a side (PCM without the loop filter, transquant bypass)."""
    s = np.array(lines, np.int64).reshape(4, 8)
    out = s.copy()
    if chroma:
        if bs != 2:
            return out.astype(np.uint8)
        qpc = _hevc_chroma_qp(min(max(qp + pps_offset, 0), 57))
        tc = _HEVC_TC[min(max(qpc + 2 + 2 * tc_offset, 0), 53)]
        p1, p0, q0, q1 = s[:, 2], s[:, 3], s[:, 4], s[:, 5]
        d = np.clip((((q0 - p0) * 4) + p1 - q1 + 4) >> 3, -tc, tc)
        if not no_p:
            out[:, 3] = np.clip(p0 + d, 0, 255)
        if not no_q:
            out[:, 4] = np.clip(q0 - d, 0, 255)
        return out.astype(np.uint8)
    if bs == 0:
        return out.astype(np.uint8)
    beta = _HEVC_BETA[min(max(qp + 2 * beta_offset, 0), 51)]
    tc = _HEVC_TC[min(max(qp + 2 * (bs - 1) + 2 * tc_offset, 0), 53)]
    P = lambda k, i: int(s[k, 3 - i])  # noqa: E731
    Q = lambda k, i: int(s[k, 4 + i])  # noqa: E731
    dp0, dp3 = abs(P(0, 2) - 2 * P(0, 1) + P(0, 0)), abs(P(3, 2) - 2 * P(3, 1) + P(3, 0))
    dq0, dq3 = abs(Q(0, 2) - 2 * Q(0, 1) + Q(0, 0)), abs(Q(3, 2) - 2 * Q(3, 1) + Q(3, 0))
    if dp0 + dq0 + dp3 + dq3 >= beta:
        return out.astype(np.uint8)

    def dsam(k, dpq):
        return (2 * dpq < (beta >> 2) and abs(P(k, 3) - P(k, 0)) + abs(Q(k, 0) - Q(k, 3)) <
                (beta >> 3) and abs(P(k, 0) - Q(k, 0)) < ((5 * tc + 1) >> 1))
    strong = dsam(0, dp0 + dq0) and dsam(3, dp3 + dq3)
    lim = (beta + (beta >> 1)) >> 3
    dep, deq = dp0 + dp3 < lim, dq0 + dq3 < lim
    for k in range(4):
        p0, p1, p2, p3 = (P(k, i) for i in range(4))
        q0, q1, q2, q3 = (Q(k, i) for i in range(4))
        if strong:
            if not no_p:
                out[k, 3] = np.clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - 2 * tc, p0 + 2 * tc)
                out[k, 2] = np.clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tc, p1 + 2 * tc)
                out[k, 1] = np.clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - 2 * tc, p2 + 2 * tc)
            if not no_q:
                out[k, 4] = np.clip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0 - 2 * tc, q0 + 2 * tc)
                out[k, 5] = np.clip((p0 + q0 + q1 + q2 + 2) >> 2, q1 - 2 * tc, q1 + 2 * tc)
                out[k, 6] = np.clip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2 - 2 * tc, q2 + 2 * tc)
            continue
        d = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
        if abs(d) >= tc * 10:
            continue
        d = min(max(d, -tc), tc)
        if not no_p:
            out[k, 3] = min(max(p0 + d, 0), 255)
        if not no_q:
            out[k, 4] = min(max(q0 - d, 0), 255)
        if dep and not no_p:
            out[k, 2] = min(max(p1 + min(max((((p2 + p0 + 1) >> 1) - p1 + d) >> 1, -(tc >> 1)),
                                         tc >> 1), 0), 255)
        if deq and not no_q:
            out[k, 5] = min(max(q1 + min(max((((q2 + q0 + 1) >> 1) - q1 - d) >> 1, -(tc >> 1)),
                                         tc >> 1), 0), 255)
    return out.astype(np.uint8)


def hevc_sao_ref(padded: np.ndarray, typ: int, band: int, eo: int, offsets,
                 usable=(True,) * 8) -> np.ndarray:
    """HEVC SAO of a block (8.7.3): ``padded`` is the deblocked block with
    one sample round it; typ 1 band (band position ``band``), 2 edge (class
    ``eo``); offsets signed; ``usable`` says whether the neighbour blocks
    left, right, above, below, above-left, above-right, below-left and
    below-right may be read (an edge-offset sample whose neighbour lies in
    one that may not is left). Returns the h x w result."""
    src = np.asarray(padded, np.int64)
    h, w = src.shape[0] - 2, src.shape[1] - 2
    cur = src[1:-1, 1:-1]
    off = [int(v) for v in offsets]
    if typ == 1:
        table = np.zeros(32, np.int64)
        for k in range(4):
            table[(k + band) & 31] = k + 1
        idx = table[cur >> 3]
        vals = np.array([0] + off, np.int64)
        return np.clip(cur + vals[idx], 0, 255).astype(np.uint8)
    pos = (((-1, 0), (1, 0)), ((0, -1), (0, 1)), ((-1, -1), (1, 1)), ((1, -1), (-1, 1)))[eo]
    out = cur.copy()
    blocks = ((4, 2, 5), (0, -1, 1), (6, 3, 7))
    for y in range(h):
        for x in range(w):
            ok = True
            nb = []
            for dx, dy in pos:
                xx, yy = x + dx, y + dy
                b = blocks[0 if yy < 0 else 2 if yy >= h else 1][0 if xx < 0 else 2 if xx >= w else 1]
                if b >= 0 and not usable[b]:
                    ok = False
                    break
                nb.append(int(src[yy + 1, xx + 1]))
            if not ok:
                continue
            v = int(cur[y, x])
            sgn = lambda a: (a > 0) - (a < 0)  # noqa: E731
            e = 2 + sgn(v - nb[0]) + sgn(v - nb[1])
            if e <= 2:
                e = 0 if e == 2 else e + 1
            if e:
                out[y, x] = min(max(v + off[e - 1], 0), 255)
    return out.astype(np.uint8)


def _i16p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))


def _i32(values):
    return (ctypes.c_int32 * len(values))(*[int(v) for v in values])


def hevc_idct(coef, log2: int, trtype: int = 0, skip: bool = False) -> np.ndarray:
    """The compiled ``hevc_idct_ref``."""
    lib = load_library()
    n = 1 << log2
    c = np.ascontiguousarray(np.asarray(coef).reshape(n, n), np.int16)
    out = np.zeros((n, n), np.int16)
    lib.vd_hevc_idct(_i16p(c), int(log2), int(trtype), int(bool(skip)), _i16p(out))
    return out


def hevc_mc(src0, src1, chroma: bool, x: int, y: int, mv, pred: int, bw: int, bh: int,
            weights=None) -> np.ndarray:
    """The compiled ``hevc_mc_ref`` (planes of one size)."""
    lib = load_library()
    a = np.ascontiguousarray(src0, np.uint8)
    b = np.ascontiguousarray(src1 if src1 is not None else src0, np.uint8)
    if a.shape != b.shape:
        raise ValueError(f"planes {a.shape} and {b.shape} differ")
    out = np.zeros((bh, bw), np.uint8)
    wt = (0, 0, 0, 0, 0) if weights is None else weights
    lib.vd_hevc_mc(_u8(a), _u8(b), a.shape[1], a.shape[0], int(bool(chroma)), int(x), int(y),
                   _i32(mv), int(pred), int(weights is not None), _i32(wt), int(bw), int(bh),
                   _u8(out))
    return out


def hevc_intra(ref, avail, log2: int, c: int, mode: int, strong: bool) -> np.ndarray:
    """The compiled ``hevc_intra_ref``."""
    lib = load_library()
    n = 1 << log2
    r = np.ascontiguousarray(ref, np.uint8)
    a = np.ascontiguousarray(np.asarray(avail, bool).astype(np.uint8))
    if r.size != 4 * n + 1 or a.size != 4 * n + 1:
        raise ValueError(f"{4 * n + 1} references for a {n}x{n} block, not {r.size}")
    out = np.zeros((n, n), np.uint8)
    lib.vd_hevc_intra(_u8(r), _u8(a), int(log2), int(c), int(mode), int(bool(strong)), _u8(out))
    return out


def hevc_deblock(lines, chroma: bool, bs: int, qp: int, beta_offset: int, tc_offset: int,
                 pps_offset: int = 0, no_p: bool = False, no_q: bool = False) -> np.ndarray:
    """The compiled ``hevc_deblock_ref``."""
    lib = load_library()
    out = np.array(lines, np.uint8, order="C", copy=True).reshape(4, 8)
    ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    edge = ctypes.cast(ctypes.addressof(ptr.contents) + 4, ctypes.POINTER(ctypes.c_uint8))
    lib.vd_hevc_deblock(edge, 8, 1, int(bool(chroma)), int(bs), int(qp), int(beta_offset),
                        int(tc_offset), int(pps_offset), int(bool(no_p)), int(bool(no_q)))
    return out


def hevc_sao(padded, typ: int, band: int, eo: int, offsets, usable=(True,) * 8) -> np.ndarray:
    """The compiled ``hevc_sao_ref``."""
    lib = load_library()
    src = np.ascontiguousarray(padded, np.uint8)
    h, w = src.shape[0] - 2, src.shape[1] - 2
    out = np.zeros((h, w), np.uint8)
    ptr = src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    first = ctypes.cast(ctypes.addressof(ptr.contents) + src.shape[1] + 1,
                        ctypes.POINTER(ctypes.c_uint8))
    lib.vd_hevc_sao(first, src.shape[1], _u8(out), w, h, int(typ), int(band), int(eo),
                    _i32(offsets), _u8(np.asarray(usable, bool).astype(np.uint8)))
    return out
