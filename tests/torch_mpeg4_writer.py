"""MPEG-4 Part 2 test streams for the port's video reader, as Xvid and DivX
write them.

A bit writer of ISO/IEC 14496-2 syntax (VOS, VO, VOL with H.263 or MPEG
quantisation and loaded matrices, user data, GOV, I-, P-, B- and not-coded
VOPs) and two sources of macroblocks:

- :func:`random_stream`: random legal syntax from a seed, by tool: AC
  prediction on and off per macroblock, DQUANT in I and P macroblocks, 1MV
  and 4MV with intra macroblocks among them and vectors over the edges
  (every f_code), the intra DC as a VLC or as a TCOEF, all three TCOEF
  escapes, not-coded macroblocks and VOPs, and B-VOPs in every mode
  (direct with its delta, interpolate, backward, forward), MODB / CBPB,
  DBQUANT and both f_codes, with the VOP times (``modulo_time_base``
  too) that direct mode scales by. The frames are whatever the syntax
  decodes to.
- :func:`encode`: a small real encoder (the CLI's clips): the frames'
  global motion and a 4MV refinement, intra macroblocks with DC and AC
  prediction where prediction fails, IBBP with direct mode, references
  taken from the port's own decoder (which cv2 then checks).

The encoder's build goes in user data (``XviD0064``, ``DivX503b1393`` /
``DivX503b1393p`` for packed bitstreams, ``Lavc...``, ``FFmpeg...b4600``
or none), and FFmpeg chooses its IDCT and workarounds by it. Samples go
into MP4 (``mp4v`` + ``esds``, B-VOPs through ``ctts``), Matroska
(``V_MPEG4/ISO/ASP`` with CodecPrivate, or ``V_MS/VFW/FOURCC`` with a
BITMAPINFOHEADER; SimpleBlocks or BlockGroups with ReferenceBlock) and AVI
(one VOP a chunk, or packed: a P-VOP and the B-VOP after it in one chunk,
then a placeholder not-coded VOP) with ``tests/torch_h264_writer.py``'s
muxers. cv2 (FFmpeg) is the reference that decodes these streams in the
tests; every stream this writes is one it decodes. The VLC tables are read
from the decoder's source (``native/video_decode.cpp``); a table wrong in
both would still show, since cv2 decodes with its own. This module is a
test tool: the port never imports it.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import struct
from pathlib import Path

import numpy as np

import torch_h264_writer as H

_SRC = Path(__file__).resolve().parents[1] / "mast3r_slam_tpu_torch" / "native" / "video_decode.cpp"


def _load_tables():
    text = _SRC.read_text()
    out = {}
    for name in ("kIntraMcbpc", "kInterMcbpc", "kCbpy", "kMvtab", "kDcLum", "kDcChrom",
                 "kZigzag", "kAltHorizontal", "kAltVertical", "kDefIntraMatrix",
                 "kDefInterMatrix", "kYDcScale", "kCDcScale", "kDcThreshold", "kMbTypeB",
                 "kRlInter", "kRlIntra"):
        m = re.search(r"\b" + name + r"\b[^=;]*= \{(.*?)\};", text, re.S)
        out[name] = [int(v, 0) for v in re.findall(r"-?(?:0x[0-9a-fA-F]+|\d+)", m.group(1))]
    return out


_T = _load_tables()


def _pairs(v):
    return [tuple(v[i:i + 2]) for i in range(0, len(v), 2)]


INTRA_MCBPC, INTER_MCBPC = _pairs(_T["kIntraMcbpc"]), _pairs(_T["kInterMcbpc"])
CBPY, MVTAB = _pairs(_T["kCbpy"]), _pairs(_T["kMvtab"])
DC_VLC = (_pairs(_T["kDcLum"]), _pairs(_T["kDcChrom"]))
MB_TYPE_B = _pairs(_T["kMbTypeB"])  # direct, interpolate, backward, forward
ZIGZAG, ALT_H, ALT_V = _T["kZigzag"], _T["kAltHorizontal"], _T["kAltVertical"]
DEF_INTRA, DEF_INTER = _T["kDefIntraMatrix"], _T["kDefInterMatrix"]
Y_DC_SCALE, C_DC_SCALE, DC_THRESHOLD = _T["kYDcScale"], _T["kCDcScale"], _T["kDcThreshold"]
DQUANT = {-1: 0, -2: 1, 1: 2, 2: 3}


class _Rl:
    """A TCOEF table: (last, run, level) -> code, and the escapes' LMAX /
    RMAX."""

    def __init__(self, v):
        vlc = _pairs(v[:206])
        run, level, last0 = v[206:308], v[308:410], v[410]
        self.code = {}
        self.max_level = {(0, r): 0 for r in range(64)} | {(1, r): 0 for r in range(64)}
        self.max_run = {}
        for i in range(102):
            last = int(i >= last0)
            self.code[(last, run[i], level[i])] = vlc[i]
            self.max_level[(last, run[i])] = max(self.max_level[(last, run[i])], level[i])
            self.max_run[(last, level[i])] = max(self.max_run.get((last, level[i]), 0), run[i])
        self.esc = vlc[102]

    def put(self, bw, last, run, level):
        """One TCOEF: its code, else escape 1 (level - LMAX), 2 (run - RMAX
        - 1) or 3 (fixed length), the first that fits."""
        a, s = abs(level), int(level < 0)
        c = self.code.get((last, run, a))
        if c:
            bw.u(c[1], c[0])
            bw.u(1, s)
            return None
        la = a - self.max_level[(last, run)]
        c = self.code.get((last, run, la)) if la > 0 else None
        if c:
            bw.u(self.esc[1], self.esc[0])
            bw.u(1, 0)
            bw.u(c[1], c[0])
            bw.u(1, s)
            return "esc1"
        r2 = run - self.max_run.get((last, a), -99) - 1
        c = self.code.get((last, r2, a)) if r2 >= 0 else None
        if c:
            bw.u(self.esc[1], self.esc[0])
            bw.u(2, 2)
            bw.u(c[1], c[0])
            bw.u(1, s)
            return "esc2"
        assert 0 < a <= 2047 and run < 64
        bw.u(self.esc[1], self.esc[0])
        bw.u(2, 3)
        bw.u(1, last)
        bw.u(6, run)
        bw.u(1, 1)
        bw.u(12, level & 0xFFF)
        bw.u(1, 1)
        return "esc3"


RL_INTER, RL_INTRA = _Rl(_T["kRlInter"]), _Rl(_T["kRlIntra"])


def put_coefs(bw, rl, pairs):
    """(run, level) pairs of one block, the last flagged; the escapes
    used."""
    return [e for k, (run, level) in enumerate(pairs)
            if (e := rl.put(bw, int(k == len(pairs) - 1), run, level))]


def put_mv(bw, diff, f_code):
    """ff_h263_encode_motion: a vector difference (wrapped into the f_code
    range) as its VLC, sign and residual bits."""
    bits = f_code - 1
    n = 5 + f_code
    val = ((diff + (1 << (n - 1))) % (1 << n)) - (1 << (n - 1))
    if val == 0:
        bw.u(MVTAB[0][1], MVTAB[0][0])
        return
    sign, val = int(val < 0), abs(val) - 1
    code = (val >> bits) + 1
    bw.u(MVTAB[code][1], MVTAB[code][0])
    bw.u(1, sign)
    bw.u(bits, val & ((1 << bits) - 1))


def wrap_mv(v, f_code):
    """A vector as the decoder holds it (sign_extend to 5 + f_code bits)."""
    n = 5 + f_code
    return ((v + (1 << (n - 1))) % (1 << n)) - (1 << (n - 1))


def put_dc(bw, diff, chroma):
    size = abs(diff).bit_length()
    code = DC_VLC[chroma][size]
    bw.u(code[1], code[0])
    if size:
        bw.u(size, diff if diff > 0 else diff + (1 << size) - 1)
        if size > 8:
            bw.u(1, 1)


def stuffing(bw):
    """next_start_code: a 0, then 1s to the byte boundary."""
    bw.u(1, 0)
    while not bw.aligned():
        bw.u(1, 1)


def start(bw, code):
    assert bw.aligned()
    bw.u(24, 1)
    bw.u(8, code)


# --- headers ---------------------------------------------------------------------------------

@dataclasses.dataclass
class Vol:
    """The VOL's fields this writer sets. ``intra_matrix`` /
    ``inter_matrix``: the values to load in zigzag order (fewer than 64:
    cut short by a 0, the last repeated), or None for the default."""
    width: int
    height: int
    vo_type: int = 17             # 1 simple, 17 advanced simple
    verid: int = 1
    vol_control: bool = True
    low_delay: bool = True
    time_res: int = 30
    fixed_inc: int = 0            # fixed_vop_time_increment, 0: not fixed
    mpeg_quant: bool = False
    intra_matrix: list = None
    inter_matrix: list = None
    refuse: str = None            # one of REFUSED's VOL features, set

    @property
    def time_bits(self):
        return max(1, (self.time_res - 1).bit_length())


def vol_bytes(v: Vol, user=b"", vos=True):
    """VOS + VO (when ``vos``), the VOL and its user data (``user``, one or
    more strings), each from its start code."""
    bw = H.BitWriter()
    if vos:
        start(bw, 0xB0)
        bw.u(8, 0xF5 if v.vo_type == 17 else 0x03)  # profile_and_level
        start(bw, 0xB5)
        bw.u(1, 0)       # is_visual_object_identifier
        bw.u(4, 1)       # video object
        bw.u(1, 0)       # video_signal_type
        stuffing(bw)
        start(bw, 0x00)  # video_object_start_code
    start(bw, 0x20)
    bw.u(1, 0)
    bw.u(8, v.vo_type)
    bw.u(1, 1)           # is_object_layer_identifier
    bw.u(4, v.verid)
    bw.u(3, 1)
    bw.u(4, 1)           # square pixels
    bw.u(1, int(v.vol_control))
    if v.vol_control:
        bw.u(2, 1)
        bw.u(1, int(v.low_delay))
        bw.u(1, 0)
    bw.u(2, 0)           # rectangular
    bw.u(1, 1)
    bw.u(16, v.time_res)
    bw.u(1, 1)
    bw.u(1, int(bool(v.fixed_inc)))
    if v.fixed_inc:
        bw.u(v.time_bits, v.fixed_inc)
    bw.u(1, 1)
    bw.u(13, v.width)
    bw.u(1, 1)
    bw.u(13, v.height)
    bw.u(1, 1)
    on = v.refuse
    bw.u(1, int(on == "interlaced"))
    if on == "interlaced":
        bw.u(1, 1)       # top_field_first
        bw.u(1, 0)       # alternate_vertical_scan
    bw.u(1, 1)           # obmc_disable
    bw.u(1 if v.verid == 1 else 2, 2 if on == "GMC" else 0)
    bw.u(1, 0)           # 8 bits
    bw.u(1, int(v.mpeg_quant))
    if v.mpeg_quant:
        for load in (v.intra_matrix, v.inter_matrix):
            bw.u(1, int(load is not None))
            if load is not None:
                for x in load:
                    bw.u(8, x)
                if len(load) < 64:
                    bw.u(8, 0)
    if v.verid != 1:
        bw.u(1, int(on == "quarter-pel"))
    bw.u(1, 1)           # complexity_estimation_disable
    bw.u(1, int(on != "resync markers"))
    bw.u(1, int(on == "data partitioning"))
    if on == "data partitioning":
        bw.u(1, 0)       # reversible_vlc
    if v.verid != 1:
        bw.u(1, int(on == "NEWPRED"))
        bw.u(1, int(on == "reduced-resolution"))
    bw.u(1, int(on == "scalability"))
    stuffing(bw)
    out = bw.bytes()
    for u in ([user] if isinstance(user, bytes) else user):
        if u:
            out += b"\x00\x00\x01\xb2" + u
    return out


def gov_bytes(seconds):
    bw = H.BitWriter()
    start(bw, 0xB3)
    bw.u(5, seconds // 3600)
    bw.u(6, seconds // 60 % 60)
    bw.u(1, 1)
    bw.u(6, seconds % 60)
    bw.u(1, 0)           # closed_gov
    bw.u(1, 0)           # broken_link
    stuffing(bw)
    return bw.bytes()


# --- the VOP writer -----------------------------------------------------------------------

I_VOP, P_VOP, B_VOP = 0, 1, 2


class VopWriter:
    """One VOP's syntax, with the decoder's prediction state so that what
    is written parses and predicts as meant: the motion vectors per luma
    block (ff_h263_pred_motion), B-VOP vector predictors, and the intra
    DC / AC predictors (only the real encoder needs their values)."""

    def __init__(self, vol: Vol, typ, q, *, fcode=1, bcode=1, rounding=0, dc_thr=0,
                 modulo=0, inc=0, coded=True, colocated=None, dc_clip=True):
        self.v, self.type, self.q = vol, typ, q
        self.fcode, self.bcode, self.rounding = fcode, bcode, rounding
        self.mbw, self.mbh = (vol.width + 15) // 16, (vol.height + 15) // 16
        self.bw = H.BitWriter()
        self.dc_vlc_q = DC_THRESHOLD[dc_thr]
        self.dc_clip = dc_clip
        self.colocated = colocated  # B: the future reference's (mv, four, skip)
        self.mv = np.zeros((2 * self.mbh, 2 * self.mbw, 2), np.int64)
        self.four = np.zeros((self.mbh, self.mbw), bool)
        self.skip = np.zeros((self.mbh, self.mbw), bool)
        self.last_mv = [[0, 0], [0, 0]]
        self.tools = collections.Counter()  # what this VOP wrote, by tool
        n = 4 * self.mbw * self.mbh + 2 * self.mbw * self.mbh
        self.dc = np.full(n, 1024, np.int64)
        self.ac = np.zeros((n, 16), np.int64)
        self.mb_intra = np.zeros((self.mbh, self.mbw), bool)
        self.mb_q = np.zeros((self.mbh, self.mbw), np.int64)
        bw = self.bw
        start(bw, 0xB6)
        bw.u(2, typ)
        for _ in range(modulo):
            bw.u(1, 1)
        bw.u(1, 0)
        bw.u(1, 1)
        bw.u(vol.time_bits, inc)
        bw.u(1, 1)
        bw.u(1, int(coded))
        if not coded:
            return
        if typ == P_VOP:
            bw.u(1, rounding)
        bw.u(3, dc_thr)
        bw.u(5, q)
        if typ != I_VOP:
            bw.u(3, fcode)
        if typ == B_VOP:
            bw.u(3, bcode)

    def finish(self):
        stuffing(self.bw)
        return self.bw.bytes()

    # --- predictors ---

    def _mv_at(self, bx, by):
        if bx < 0 or by < 0 or bx >= 2 * self.mbw:
            return 0, 0
        return tuple(self.mv[by, bx])

    def pred_mv(self, mx, my, k):
        bx, by = 2 * mx + (k & 1), 2 * my + (k >> 1)
        a = self._mv_at(bx - 1, by)
        if my == 0 and k < 2:
            return (0, 0) if (k == 0 and mx == 0) else a
        b = self._mv_at(bx, by - 1)
        c = self._mv_at(bx + (2, 1, 1, -1)[k], by - 1)
        return tuple(int(sorted((a[i], b[i], c[i]))[1]) for i in range(2))

    def _blk(self, n, bx, by, intra_only=True):
        if n < 4:
            if bx < 0 or by < 0 or bx >= 2 * self.mbw or by >= 2 * self.mbh:
                return -1
            if intra_only and not self.mb_intra[by >> 1, bx >> 1]:
                return -1
            return by * 2 * self.mbw + bx
        if bx < 0 or by < 0 or bx >= self.mbw or by >= self.mbh:
            return -1
        if intra_only and not self.mb_intra[by, bx]:
            return -1
        return 4 * self.mbw * self.mbh + (n - 4) * self.mbw * self.mbh + by * self.mbw + bx

    def dc_pred(self, n, mx, my, q):
        """The DC predictor, its direction (0 left, 1 top), the scale and
        the AC predictor's neighbour (index, its macroblock's q) as
        mpeg4_pred_dc / ff_mpeg4_pred_ac find them."""
        bx, by = (2 * mx + (n & 1), 2 * my + (n >> 1)) if n < 4 else (mx, my)
        scale = (Y_DC_SCALE if n < 4 else C_DC_SCALE)[q]
        ia, ib, ic = self._blk(n, bx - 1, by), self._blk(n, bx - 1, by - 1), self._blk(n, bx, by - 1)
        a, b, c = (1024 if i < 0 else int(self.dc[i]) for i in (ia, ib, ic))
        top = abs(a - b) < abs(b - c)
        pred = ((c if top else a) + (scale >> 1)) // scale
        nb = ic if top else ia
        if nb >= 0:
            nbx, nby = (bx, by - 1) if top else (bx - 1, by)
            qn = int(self.mb_q[nby >> 1, nbx >> 1] if n < 4 else self.mb_q[nby, nbx])
        else:
            qn = q
        return pred, int(top), scale, nb, qn, self._blk(n, bx, by, False)

    # --- macroblocks ---

    def intra_mb(self, mx, my, make_block, *, ac_pred, dquant=0, p_vop=False, stuff=0):
        """An intra macroblock. ``make_block(n, use_vlc)`` gives block n as
        ``(dc_diff, pairs)``, (run, level) pairs of its TCOEFs (with the
        DC as the first where ``use_vlc`` is False, the DC then coded as a
        TCOEF: the VOP's q at or over the DC threshold); it is called
        after the macroblock's DQUANT and intra flag are in place, and
        stores the block's predictors (``store_intra``)."""
        bw = self.bw
        use_vlc = self.q < self.dc_vlc_q
        if dquant:
            self.q = min(max(self.q + dquant, 1), 31)
        self.mb_intra[my, mx] = True
        self.mb_q[my, mx] = self.q
        blocks = [make_block(n, use_vlc) for n in range(6)]
        cbp = sum(32 >> i for i, (_, pairs) in enumerate(blocks) if pairs)
        self.tools.update(["intra_p" if p_vop else "intra", "ac_pred" if ac_pred else "no_ac_pred",
                           "dc_vlc" if use_vlc else "dc_tcoef"] + ["dquant"] * bool(dquant)
                          + ["stuffing"] * bool(stuff))
        if p_vop:
            bw.u(1, 0)
            for _ in range(stuff):  # MCBPC stuffing, then not_coded again
                bw.u(INTER_MCBPC[20][1], INTER_MCBPC[20][0])
                bw.u(1, 0)
            idx = (cbp & 3) | 4 | (8 if dquant else 0)
            bw.u(INTER_MCBPC[idx][1], INTER_MCBPC[idx][0])
        else:
            for _ in range(stuff):
                bw.u(INTRA_MCBPC[8][1], INTRA_MCBPC[8][0])
            idx = (cbp & 3) | (4 if dquant else 0)
            bw.u(INTRA_MCBPC[idx][1], INTRA_MCBPC[idx][0])
        bw.u(1, int(ac_pred))
        c = CBPY[cbp >> 2]
        bw.u(c[1], c[0])
        if dquant:
            bw.u(2, DQUANT[dquant])
        for i, (dc, pairs) in enumerate(blocks):
            if use_vlc:
                put_dc(bw, dc, i >= 4)
            if pairs:
                self.tools.update(put_coefs(bw, RL_INTRA, pairs))

    def intra_block(self, n, mx, my, dc_level, final, ac_pred, use_vlc):
        """Block n of an intra macroblock whose levels after AC prediction
        are ``final`` (8x8, natural order, DC level ``dc_level`` >= 0):
        the DC differential and TCOEF pairs that give them, its
        predictors stored."""
        pred, top, _, nb, qn, _ = self.dc_pred(n, mx, my, self.q)
        resid = np.array(final, np.int64)
        resid[0, 0] = 0
        if ac_pred and nb >= 0:
            pa = self.ac[nb]
            for k in range(1, 8):
                if top:
                    p = int(pa[8 + k])
                    p = p if (qn == self.q or n in (2, 3)) else _rdiv(p * qn, self.q)
                    resid[0, k] -= p
                else:
                    p = int(pa[k])
                    p = p if (qn == self.q or n in (1, 3)) else _rdiv(p * qn, self.q)
                    resid[k, 0] -= p
        scan = (ALT_H if top else ALT_V) if ac_pred else ZIGZAG
        pairs, _ = _levels(resid, scan, 1, lambda x: x)
        dc = dc_level - pred
        self.store_intra(n, mx, my, dc_level, np.asarray(final)[1:8, 0], np.asarray(final)[0, 1:8])
        return dc, (pairs if use_vlc else _dc_first(dc, pairs))

    def store_intra(self, n, mx, my, dc_level, first_col, first_row):
        """The decoder's stored predictors of block n: its DC (scaled,
        clipped to [0, 2047] or, under FF_BUG_DC_CLIP, only at 0) and the
        first column / row of its levels after AC prediction."""
        _, _, scale, _, _, self_i = self.dc_pred(n, mx, my, self.q)
        v = dc_level * scale
        if v < 0 or v > 2047:
            v = 0 if v < 0 else (v if not self.dc_clip else 2047)
        v = ((v + 32768) % 65536) - 32768
        self.dc[self_i] = v
        self.ac[self_i, 1:8] = first_col
        self.ac[self_i, 9:16] = first_row

    def skip_mb(self, mx, my):
        self.bw.u(1, 1)
        self.skip[my, mx] = True
        self.tools["skip"] += 1

    def inter_mb(self, mx, my, mvs, blocks, *, dquant=0, stuff=0):
        """A P-VOP's inter macroblock: one vector or four (``mvs``, as the
        decoder will hold them: in range), six coefficient lists."""
        bw = self.bw
        four = len(mvs) == 4
        assert not (four and dquant)
        cbp = sum(32 >> i for i, p in enumerate(blocks) if p)
        bw.u(1, 0)
        for _ in range(stuff):
            bw.u(INTER_MCBPC[20][1], INTER_MCBPC[20][0])
            bw.u(1, 0)
        idx = (cbp & 3) | (8 if dquant else 0) | (16 if four else 0)
        bw.u(INTER_MCBPC[idx][1], INTER_MCBPC[idx][0])
        c = CBPY[(cbp >> 2) ^ 15]
        bw.u(c[1], c[0])
        if dquant:
            bw.u(2, DQUANT[dquant])
            self.q = min(max(self.q + dquant, 1), 31)
        self.mb_q[my, mx] = self.q
        for k in range(4 if four else 1):
            px, py = self.pred_mv(mx, my, k)
            vx, vy = mvs[k]
            put_mv(bw, vx - px, self.fcode)
            put_mv(bw, vy - py, self.fcode)
            if four:
                self.mv[2 * my + (k >> 1), 2 * mx + (k & 1)] = (vx, vy)
        if not four:
            self.mv[2 * my:2 * my + 2, 2 * mx:2 * mx + 2] = mvs[0]
        self.four[my, mx] = four
        over = any(not (0 <= mx * 16 + (v[0] >> 1) and mx * 16 + 16 + (v[0] >> 1) <= self.v.width
                        and 0 <= my * 16 + (v[1] >> 1) and my * 16 + 16 + (v[1] >> 1) <= self.v.height)
                   for v in mvs)
        self.tools.update(["4mv" if four else "1mv"] + ["dquant"] * bool(dquant)
                          + ["stuffing"] * bool(stuff) + ["over_edge"] * over)
        for p in blocks:
            if p:
                self.tools.update(put_coefs(bw, RL_INTER, p))

    def b_mb(self, mx, my, mode, *, fwd=None, bwd=None, delta=None, blocks=None,
             dbquant=0, modb_skip=False):
        """A B-VOP's macroblock. ``mode``: "direct" (``delta``: the vector
        delta; ``modb_skip``: MODB 1, no delta and no coefficients),
        "interpolate", "backward" or "forward" with the vectors (as the
        decoder will hold them); ``blocks``: None for MODB '01' (no CBPB),
        else six lists (CBPB, possibly 0). Nothing is written for a
        macroblock the future reference did not code."""
        bw = self.bw
        if mx == 0:
            self.last_mv = [[0, 0], [0, 0]]
        if self.colocated[2][my, mx]:
            self.tools["b_colocated_skip"] += 1
            return False
        direct4 = mode == "direct" and bool(self.colocated[1][my, mx])
        self.tools.update([f"b_{mode}"] + ["b_direct4"] * direct4)
        if modb_skip:
            assert mode == "direct"
            bw.u(1, 1)
            self.tools["b_modb_1"] += 1
            return True
        bw.u(1, 0)
        bw.u(1, int(blocks is None))
        t = MB_TYPE_B[("direct", "interpolate", "backward", "forward").index(mode)]
        bw.u(t[1], t[0])
        cbp = 0
        if blocks is not None:
            cbp = sum(32 >> i for i, p in enumerate(blocks) if p)
            bw.u(6, cbp)
        self.tools["b_modb_01" if blocks is None else "b_cbpb"] += 1
        if mode != "direct" and cbp:
            bw.u(1, int(dbquant != 0))
            if dbquant:
                bw.u(1, int(dbquant > 0))
                self.q = min(max(self.q + dbquant, 1), 31)
                self.tools["dbquant"] += 1
        if mode in ("interpolate", "forward"):
            for c in range(2):
                put_mv(bw, fwd[c] - self.last_mv[0][c], self.fcode)
            self.last_mv[0] = list(fwd)
        if mode in ("interpolate", "backward"):
            for c in range(2):
                put_mv(bw, bwd[c] - self.last_mv[1][c], self.bcode)
            self.last_mv[1] = list(bwd)
        if mode == "direct":
            put_mv(bw, delta[0], 1)
            put_mv(bw, delta[1], 1)
            self.tools["b_direct_delta"] += any(delta)
        for p in blocks or ():
            if p:
                self.tools.update(put_coefs(bw, RL_INTER, p))
        return True


def nvop(vol: Vol, modulo=0, inc=0):
    """A not-coded P-VOP."""
    return VopWriter(vol, P_VOP, 1, modulo=modulo, inc=inc, coded=False).finish()


# --- clips ----------------------------------------------------------------------------------

@dataclasses.dataclass
class Clip:
    """Samples (one a container chunk, decode order) of one stream:
    ``headers`` (VOS/VO/VOL/user data) lead sample 0 unless a container
    keeps them apart (``extradata``); ``display`` is each sample's
    presentation index (None: decode order); ``sync`` marks I-VOPs."""
    width: int
    height: int
    samples: list
    sync: list
    display: list = None
    headers: bytes = b""
    vol: Vol = None
    frames: int = 0  # the frames cv2 puts out
    tools: collections.Counter = None  # what the stream writes, by tool

    def shown(self):
        return list(range(len(self.samples))) if self.display is None else self.display

    def inband(self):
        """Samples with the headers in sample 0 (AVI, a Matroska or MP4
        file without them apart)."""
        return [self.headers + self.samples[0]] + self.samples[1:]


def esds(dsi: bytes) -> bytes:
    """An MP4 esds box: ES_Descriptor > DecoderConfigDescriptor (MPEG-4
    Visual) > DecoderSpecificInfo (the VOL), SLConfigDescriptor."""
    def desc(tag, payload):
        n = len(payload)
        return bytes([tag] + [0x80 | (n >> s) & 0x7F for s in (21, 14, 7)] + [n & 0x7F]) + payload
    dci = desc(4, bytes([0x20, 0x11]) + b"\0\0\0" + struct.pack(">II", 0, 0) + desc(5, dsi))
    return H._full(b"esds", 0, 0, desc(3, b"\0\x01\0" + dci + desc(6, b"\x02")))


def write_mp4(path, clip: Clip, fps=30):
    H.write_mp4(path, clip, fps=fps, samples=clip.samples, entry=b"mp4v",
                config=esds(clip.headers))


def write_mkv(path, clip: Clip, fps=30, vfw=None, groups=False, inband=False):
    """Matroska: V_MPEG4/ISO/ASP with the headers as CodecPrivate (or in
    sample 0: ``inband``), or V_MS/VFW/FOURCC with fourcc ``vfw`` and the
    headers after the BITMAPINFOHEADER; ``groups``: BlockGroups (a
    ReferenceBlock on every frame but I-VOPs) in place of SimpleBlocks."""
    if vfw:
        bih = struct.pack("<IiiHH4sIiiII", 40, clip.width, clip.height, 1, 24, vfw,
                          clip.width * clip.height * 3, 0, 0, 0, 0)
        private, codec = bih + clip.headers, b"V_MS/VFW/FOURCC"
    else:
        private, codec = (b"" if inband else clip.headers), b"V_MPEG4/ISO/ASP"
    samples = clip.inband() if inband else clip.samples
    H.write_mkv(path, clip, fps=fps, samples=samples, codec=codec, private=private,
                groups=groups)


def write_avi(path, clip: Clip, fps=30, fourcc=b"XVID"):
    H.write_avi(path, clip, fps=fps, fourcc=fourcc, samples=clip.inband())


MUX = {"mp4": write_mp4, "mkv": write_mkv, "avi": write_avi}


# --- the random writer ---------------------------------------------------------------------

GROUPS = ("intra", "inter", "4mv", "mpeg", "nvop", "b", "b4mv", "packed")


def _gop(rng, frames, bframes, packed, gop):
    """Display order -> decode order: (types per decode index, display
    index per decode index); a reference at a multiple of ``gop`` is an
    I-VOP (the B-VOPs before it in display order follow it: open GOPs)."""
    order, types = [0], [I_VOP]
    d = 0
    while d + 1 < frames:
        nb = 1 if packed else int(rng.integers(0, bframes + 1))
        a = min(d + nb + 1, frames - 1)
        order.append(a)
        types.append(I_VOP if gop and a % gop == 0 else P_VOP)
        for b_ in range(d + 1, a):
            order.append(b_)
            types.append(B_VOP)
        d = a
    return types, order


class _Random:
    """Random macroblock choices by tool group."""

    def __init__(self, rng, vol, group, dc_unclipped=False):
        self.rng, self.vol, self.g = rng, vol, group
        self.dc_unclipped = dc_unclipped  # FF_BUG_DC_CLIP: DCs over 2047 stay

    def q(self):
        return int(self.rng.choice([2, 3, 4, 6, 9, 14, 20, 31]))

    def coefs(self, intra, q):
        amp = max(41, 1800 // (2 * q + 1))
        return _pairs_random(self.rng, 1 if intra else 0, amp) if self.rng.random() < 0.6 else []

    def levels(self, q, intra, budget=1000):
        """Random sparse levels (8x8) whose dequantised sum stays within
        ``budget``, as an encoder's of 8-bit pictures does."""
        rng = self.rng
        out = np.zeros(64, np.int64)
        if rng.random() < 0.35:
            return out.reshape(8, 8)
        scan = ZIGZAG
        pos, left = (0 if intra else -1), budget
        for _ in range(int(rng.integers(1, 7))):
            pos += int(rng.choice([1, 1, 1, 2, 3, 4, 6, 10, 15, 26]))
            if pos > 63:
                break
            r = rng.random()
            mag = (int(rng.integers(1, 3)) if r < 0.6 else int(rng.integers(3, 13)) if r < 0.85
                   else int(rng.integers(13, 41)) if r < 0.97 else int(rng.integers(41, 301)))
            mag = min(mag, left // (2 * q + 1))
            if mag <= 0:
                break
            left -= mag * (2 * q + 1)
            out[scan[pos]] = mag if rng.random() < 0.5 else -mag
        return out.reshape(8, 8)

    def intra(self, vw, mx, my, p_vop):
        rng = self.rng
        dquant = int(rng.choice([0, 0, -1, -2, 1, 2])) if self.g in ("intra", "inter", "mpeg") else 0
        ac_pred = bool(rng.random() < 0.5)

        def block(n, use_vlc):
            scale = (Y_DC_SCALE if n < 4 else C_DC_SCALE)[vw.q]
            top = 2047 + (8 * scale if self.dc_unclipped else 0)
            dc = int(np.clip(rng.normal(1024, 500), 0, top)) // scale
            scale_m = 1 if not self.vol.mpeg_quant else 4
            return vw.intra_block(n, mx, my, dc, self.levels(vw.q * scale_m, True), ac_pred,
                                  use_vlc)
        vw.intra_mb(mx, my, block, ac_pred=ac_pred, dquant=dquant, p_vop=p_vop,
                    stuff=int(rng.random() < 0.05))

    def coefs(self, q):
        """An inter block's (run, level) pairs."""
        lv = self.levels(q * (1 if not self.vol.mpeg_quant else 4), False, 1200)
        return _levels(lv, ZIGZAG, 0, lambda x: x)[0]

    def vector(self, f_code, near=(0, 0)):
        rng = self.rng
        lim = 32 << (f_code - 1)
        if rng.random() < 0.3:  # over the picture's edge
            v = [int(rng.integers(-lim, lim)), int(rng.integers(-lim, lim))]
        else:
            v = [near[0] + int(rng.integers(-6, 7)), near[1] + int(rng.integers(-6, 7))]
        return tuple(wrap_mv(c, f_code) for c in v)

    def p_mb(self, vw, mx, my):
        rng = self.rng
        r = rng.random()
        if r < 0.15:
            vw.skip_mb(mx, my)
        elif r < 0.3:
            self.intra(vw, mx, my, True)
        else:
            four = self.g in ("4mv", "b4mv") and rng.random() < 0.5
            dquant = 0 if four else int(rng.choice([0, 0, 0, -1, -2, 1, 2]))
            near = vw.pred_mv(mx, my, 0)
            mvs = [self.vector(vw.fcode, near) for _ in range(4 if four else 1)]
            vw.inter_mb(mx, my, mvs, [self.coefs(vw.q) for _ in range(6)],
                        dquant=dquant, stuff=int(rng.random() < 0.03))

    def b_mb(self, vw, mx, my):
        rng = self.rng
        mode = str(rng.choice(["direct", "direct", "interpolate", "backward", "forward"]))
        modb = rng.random()
        if mode == "direct" and modb < 0.25:
            return vw.b_mb(mx, my, mode, modb_skip=True)
        blocks = None if modb < 0.5 else [self.coefs(vw.q) for _ in range(6)]
        kw = {}
        if mode == "direct":
            kw["delta"] = (int(rng.integers(-8, 9)), int(rng.integers(-8, 9))) \
                if rng.random() < 0.6 else (0, 0)
        if mode in ("interpolate", "forward"):
            kw["fwd"] = self.vector(vw.fcode, vw.last_mv[0] if mx else (0, 0))
        if mode in ("interpolate", "backward"):
            kw["bwd"] = self.vector(vw.bcode, vw.last_mv[1] if mx else (0, 0))
        return vw.b_mb(mx, my, mode, blocks=blocks,
                       dbquant=int(rng.choice([0, -2, 2])), **kw)


BUILDS = {"xvid": b"XviD0064", "xvid0": b"XviD0000", "divx": b"DivX503b1393",
          "divx_packed": b"DivX503b1393p", "lavc": b"Lavc62.28.101",
          "ffmpeg": b"FFmpeg0.4.9-pre1b4600", "none": b""}


def random_stream(seed, group, *, width=48, height=32, frames=8, build="xvid",
                  gov=False, time_res=30, gop=0):
    """A stream of random legal syntax exercising ``group`` (GROUPS): intra
    (I-VOPs: AC prediction, DQUANT, DC VLC and TCOEF DC, escapes), inter
    (P-VOPs: 1MV, intra among inter, DQUANT, skips, vectors over the edge,
    every f_code), 4mv, mpeg (MPEG quantisation with loaded matrices, one
    cut short), nvop (not-coded VOPs, and a not-coded last VOP), b (IBBP:
    every B mode, MODB, CBPB, DBQUANT, f_codes), b4mv (B-VOPs over 4MV
    P-VOPs: direct's four vectors) and packed (IBP with B-VOPs packed after
    their P-VOP, the placeholder a not-coded VOP). ``build``: BUILDS' user
    data key."""
    rng = np.random.default_rng(seed)
    b = group in ("b", "b4mv", "packed")
    vol = Vol(width, height, time_res=time_res, low_delay=not b,
              vo_type=17 if b or group == "mpeg" else int(rng.choice([1, 17])),
              verid=int(rng.choice([1, 2])))
    if group == "mpeg":
        vol.mpeg_quant = True
        vol.intra_matrix = [int(x) for x in rng.integers(8, 60, 64)]
        vol.intra_matrix[0] = 8
        vol.inter_matrix = [int(x) for x in rng.integers(10, 50, int(rng.integers(5, 40)))]
    user = [BUILDS[build]]
    if group == "packed" and build == "xvid":  # Xvid's packed mode names DivX's too
        user = [BUILDS["xvid"], BUILDS["divx_packed"]]
    headers = vol_bytes(vol, user)
    types, order = _gop(rng, frames, 2 if b else 0, group == "packed", gop)
    if not b:
        types = [I_VOP if i == 0 or group == "intra" or (gop and i % gop == 0) else P_VOP
                 for i in range(frames)]
        order = list(range(frames))
    # XviD0000: FF_BUG_DC_CLIP whatever the container; the other builds
    # keep DC predictors in range, where the flag changes nothing
    rnd = _Random(rng, vol, group, dc_unclipped=build == "xvid0")
    sync, disp, vops = [], [], []
    clock = _Clock(time_res)
    colocated = None
    n_frames = 0
    tools = collections.Counter()
    for k, (typ, d) in enumerate(zip(types, order)):
        head = b""
        if gov and typ == I_VOP:
            # the GOV's time code: the seconds of the first VOP shown after it
            nxt = [j for j in range(k + 1, len(types)) if types[j] == I_VOP]
            end = nxt[0] if nxt else len(types)
            first = min(order[k:end]) // time_res
            head = gov_bytes(first)
            clock.base = first
            tools["gov"] += 1
        modulo, inc = clock.vop(typ, d)
        tools["modulo_time_base"] += modulo > 0
        if group == "nvop" and k and (k % 3 == 2 or k == len(types) - 1):
            tools["nvop"] += 1
            vops.append(head + nvop(vol, modulo, inc))
            sync.append(False)
            disp.append(d)
            if k == len(types) - 1:
                n_frames += 1   # FFmpeg puts the last frame out again
            continue
        q = rnd.q()
        fcode = int(rng.integers(1, 8)) if typ != I_VOP else 1
        bcode = int(rng.integers(1, 8)) if typ == B_VOP else 1
        vw = VopWriter(vol, typ, q, fcode=fcode, bcode=bcode, rounding=int(rng.integers(0, 2)),
                       dc_thr=int(rng.integers(0, 8)), modulo=modulo, inc=inc,
                       colocated=colocated, dc_clip=build != "xvid0")
        for my in range(vw.mbh):
            for mx in range(vw.mbw):
                if typ == I_VOP:
                    rnd.intra(vw, mx, my, False)
                elif typ == P_VOP:
                    rnd.p_mb(vw, mx, my)
                else:
                    rnd.b_mb(vw, mx, my)
        if typ != B_VOP:
            colocated = (vw.mv, vw.four, vw.skip)
        tools.update(vw.tools)
        vops.append(head + vw.finish())
        sync.append(typ == I_VOP)
        disp.append(d)
        n_frames += 1
    if group == "packed":
        # a P-VOP and the B-VOP after it in one chunk, then a placeholder
        out_s, out_sync = [], []
        k = 0
        while k < len(vops):
            if k + 1 < len(vops) and types[k] == P_VOP and types[k + 1] == B_VOP:
                out_s += [vops[k] + vops[k + 1], nvop(vol)]
                out_sync += [False, False]
                tools["packed"] += 1
                k += 2
            else:
                out_s.append(vops[k])
                out_sync.append(sync[k])
                k += 1
        vops, sync = out_s, out_sync
        disp = None
    return Clip(width, height, vops, sync, disp if b and disp else None, headers, vol,
                n_frames, tools)


# --- a small real encoder -----------------------------------------------------------------

def _dct_matrix():
    k = np.arange(8)
    c = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) * 0.5
    c[0] /= np.sqrt(2)
    return c


_C8 = _dct_matrix()


def fdct(block):
    """The 8x8 DCT whose inverse the IDCTs compute (DC = 8 x mean)."""
    return _C8 @ np.asarray(block, np.float64) @ _C8.T


def hpel(plane, x, y, dxy, n, rnd=1):
    """An n x n half-pel block of ``plane`` at (x, y), edges replicated."""
    h, w = plane.shape
    ys = np.clip(np.arange(y, y + n + 1), 0, h - 1)
    xs = np.clip(np.arange(x, x + n + 1), 0, w - 1)
    p = plane[np.ix_(ys, xs)].astype(np.int64)
    a, b, c, d = p[:n, :n], p[:n, 1:], p[1:, :n], p[1:, 1:]
    return {0: a, 1: (a + b + rnd) >> 1, 2: (a + c + rnd) >> 1,
            3: (a + b + c + d + 1 + rnd) >> 2}[dxy]


def round_chroma(x):
    return (0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2)[x & 15] + ((x >> 3) & ~1)


def predict(ref, mx, my, mvs, rnd=1):
    """The 16x16 luma and two 8x8 chroma predictions of a macroblock from
    reference planes (y, cb, cr) for one vector or four."""
    y, cb, cr = ref
    out = np.zeros((16, 16), np.int64)
    if len(mvs) == 1:
        vx, vy = mvs[0]
        out[:] = hpel(y, mx * 16 + (vx >> 1), my * 16 + (vy >> 1), (vx & 1) | ((vy & 1) << 1),
                      16, rnd)
        cdxy = (vx & 1) | ((vy & 1) << 1) | (vy & 2) | ((vx & 2) >> 1)
        cx, cy = (mx * 16 + (vx >> 1)) >> 1, (my * 16 + (vy >> 1)) >> 1
    else:
        for k, (vx, vy) in enumerate(mvs):
            out[(k >> 1) * 8:(k >> 1) * 8 + 8, (k & 1) * 8:(k & 1) * 8 + 8] = hpel(
                y, mx * 16 + (k & 1) * 8 + (vx >> 1), my * 16 + (k >> 1) * 8 + (vy >> 1),
                (vx & 1) | ((vy & 1) << 1), 8, rnd)
        sx, sy = round_chroma(sum(v[0] for v in mvs)), round_chroma(sum(v[1] for v in mvs))
        cdxy = (sx & 1) | ((sy & 1) << 1)
        cx, cy = mx * 8 + (sx >> 1), my * 8 + (sy >> 1)
    return out, hpel(cb, cx, cy, cdxy, 8, rnd), hpel(cr, cx, cy, cdxy, 8, rnd)


def direct_mvs(colocated, mx, my, trb, trd, delta=(0, 0)):
    """ff_mpeg4_set_direct_mv for |vector| < 32 and larger alike: the
    forward and backward vectors (one or four each) of a direct B
    macroblock."""
    mv, four, _ = colocated
    n = 4 if four[my, mx] else 1
    fw, bw = [], []
    for i in range(n):
        pv = mv[2 * my + (i >> 1), 2 * mx + (i & 1)]
        f, b = [], []
        for c in range(2):
            p, d = int(pv[c]), delta[c]
            m0 = int(p * trb / trd) + d  # C division truncates toward zero
            m1 = m0 - p if d else int(p * (trb - trd) / trd)
            f.append(m0)
            b.append(m1)
        fw.append(tuple(f))
        bw.append(tuple(b))
    return fw, bw


def _levels(coefs, scan, first, quant):
    """(run, level) pairs of a coefficient block along ``scan``."""
    lv = quant(coefs)
    out, run = [], 0
    for i in range(first, 64):
        v = int(lv.flat[scan[i]])
        if v:
            out.append((run, v))
            run = 0
        else:
            run += 1
    return out, lv


class Encoder:
    """The real encoder: YUV frames in display order in, a Clip out, as
    Xvid writes (XviD0064): IBBP with an I-VOP every GOP frames, q Q, two
    B-VOPs between references (direct mode where the direct vectors
    predict well, else the better of forward, backward and interpolated),
    4MV on one macroblock in FOUR_EVERY (its vectors refined per block),
    intra macroblocks where inter prediction fails, AC prediction on.
    References come from the port's decoder."""

    Q, BFRAMES, GOP, FOUR_EVERY = 8, 2, 12, 3

    def __init__(self, width, height):
        self.vol = Vol(width, height, low_delay=False)
        user = BUILDS["xvid"]
        self.headers = vol_bytes(self.vol, user)
        from mast3r_slam_tpu_torch.data import video
        self._video = video
        lowdelay = dataclasses.replace(self.vol, low_delay=True)
        self.recon = video.Decoder(video.MPEG4, vol_bytes(lowdelay, user), "XVID")
        self.tools = collections.Counter()
        self.mbw, self.mbh = (width + 15) // 16, (height + 15) // 16

    def _reconstruct(self, vop):
        assert self.recon.decode(vop)
        return tuple(p.astype(np.int64) for p in self.recon.planes())

    def _plane_blocks(self, yuv, mx, my):
        y, cb, cr = (np.pad(p, ((0, 16 * self.mbh // (1 if i == 0 else 2) - p.shape[0]),
                                (0, 16 * self.mbw // (1 if i == 0 else 2) - p.shape[1])),
                            mode="edge") for i, p in enumerate(yuv))
        blk = [y[my * 16 + (k >> 1) * 8:my * 16 + (k >> 1) * 8 + 8,
                 mx * 16 + (k & 1) * 8:mx * 16 + (k & 1) * 8 + 8] for k in range(4)]
        return blk + [cb[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8], cr[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8]]

    def _intra(self, vw, mx, my, yuv, p_vop):
        src = self._plane_blocks(yuv, mx, my)

        def block(n, use_vlc):
            c = fdct(np.asarray(src[n], np.float64))
            scale = (Y_DC_SCALE if n < 4 else C_DC_SCALE)[vw.q]
            final = (np.sign(c) * np.floor(np.abs(c) / (2 * vw.q))).astype(np.int64)
            return vw.intra_block(n, mx, my, max(int(np.rint(c[0, 0] / scale)), 0), final,
                                  True, use_vlc)
        vw.intra_mb(mx, my, block, ac_pred=True, p_vop=p_vop)

    def _residual(self, src, pred, q):
        blocks = []
        for n in range(6):
            p = pred[0][(n >> 1) * 8:(n >> 1) * 8 + 8, (n & 1) * 8:(n & 1) * 8 + 8] if n < 4 \
                else pred[n - 3]
            c = fdct(np.asarray(src[n], np.float64) - p)
            pairs, _ = _levels(c, ZIGZAG, 0, lambda x: (np.sign(x) * np.floor(
                np.maximum(np.abs(x) - q / 2, 0) / (2 * q))).astype(np.int64))
            blocks.append(pairs)
        return blocks

    @staticmethod
    def _sad(src, pred):
        return sum(float(np.abs(np.asarray(src[n], np.float64) - (
            pred[0][(n >> 1) * 8:(n >> 1) * 8 + 8, (n & 1) * 8:(n & 1) * 8 + 8] if n < 4
            else pred[n - 3])).sum()) for n in range(6))

    def _search(self, src, ref, mx, my, gm, fcode, four):
        """The best vector near the global one gm (one, or four refined)."""
        lim = (32 << (fcode - 1)) - 1
        cands = [(gm[0] + dx, gm[1] + dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
        cands = [c for c in cands if -lim <= c[0] <= lim and -lim <= c[1] <= lim]
        best = min(cands, key=lambda c: self._sad(src, predict(ref, mx, my, [c])))
        if not four:
            return [best]
        mvs = []
        for k in range(4):
            def cost(c, k=k):
                p = hpel(ref[0], mx * 16 + (k & 1) * 8 + (c[0] >> 1),
                         my * 16 + (k >> 1) * 8 + (c[1] >> 1), (c[0] & 1) | ((c[1] & 1) << 1), 8)
                return float(np.abs(np.asarray(src[k], np.float64) - p).sum())
            mvs.append(min(cands, key=cost))
        return mvs

    def encode(self, frames, motion):
        """``frames``: RGB frames in display order; ``motion(a, b)``: the
        global vector (half-pels) from display frame b to frame a."""
        yuvs = [H.rgb_to_yuv420(f) for f in frames]
        n = len(yuvs)
        order, types = [], []
        d = 0
        order.append(0)
        types.append(I_VOP)
        while d + 1 < n:
            a = min(d + self.BFRAMES + 1, n - 1)
            order.append(a)
            types.append(I_VOP if a % self.GOP == 0 else P_VOP)
            order += list(range(d + 1, a))
            types += [B_VOP] * (a - d - 1)
            d = a
        refs = {}
        samples, sync = [], []
        prev_ref, last_ref, colocated = None, None, None
        clock = _Clock(self.vol.time_res)
        for typ, di in zip(types, order):
            modulo, inc = clock.vop(typ, di)
            yuv = yuvs[di]
            if typ == B_VOP:
                fwd_i, bwd_i = prev_ref, last_ref
                gf, gb = motion(di, fwd_i), motion(di, bwd_i)
                fc = _fcode(gf)
                bc = _fcode(gb)
                vw = VopWriter(self.vol, B_VOP, self.Q, fcode=fc, bcode=bc, modulo=modulo,
                               inc=inc, colocated=colocated)
                trd, trb = last_ref - prev_ref, di - prev_ref
                for my in range(self.mbh):
                    for mx in range(self.mbw):
                        src = self._plane_blocks(yuv, mx, my)
                        if colocated[2][my, mx]:
                            vw.b_mb(mx, my, "forward")
                            continue
                        opts = []
                        dfw, dbw = direct_mvs(colocated, mx, my, trb, trd)
                        pf = predict(refs[fwd_i], mx, my, dfw)
                        pb = predict(refs[bwd_i], mx, my, dbw)
                        opts.append(("direct", tuple((a + b + 1) >> 1 for a, b in zip(pf, pb)), {}))
                        f = [wrap_mv(c, fc) for c in gf]
                        b_ = [wrap_mv(c, bc) for c in gb]
                        pf1 = predict(refs[fwd_i], mx, my, [tuple(f)])
                        pb1 = predict(refs[bwd_i], mx, my, [tuple(b_)])
                        opts.append(("forward", pf1, {"fwd": tuple(f)}))
                        opts.append(("backward", pb1, {"bwd": tuple(b_)}))
                        opts.append(("interpolate", tuple((a + b + 1) >> 1 for a, b in zip(pf1, pb1)),
                                     {"fwd": tuple(f), "bwd": tuple(b_)}))
                        costs = [self._sad(src, p) - (64 if m == "direct" else 0) for m, p, _ in opts]
                        mode, pred, kw = opts[int(np.argmin(costs))]
                        blocks = self._residual(src, pred, vw.q)
                        if not any(blocks):
                            blocks = None
                        if mode == "direct":
                            kw["delta"] = (0, 0)
                            if blocks is None:
                                vw.b_mb(mx, my, mode, modb_skip=True)
                                continue
                        vw.b_mb(mx, my, mode, blocks=blocks, **kw)
                self.tools.update(vw.tools)
                samples.append(vw.finish())
                sync.append(False)
                continue
            if typ == I_VOP:
                vw = VopWriter(self.vol, I_VOP, self.Q, modulo=modulo, inc=inc,)
                for my in range(self.mbh):
                    for mx in range(self.mbw):
                        self._intra(vw, mx, my, yuv, False)
            else:
                gm = motion(di, last_ref)
                fc = _fcode(gm)
                vw = VopWriter(self.vol, P_VOP, self.Q, fcode=fc, modulo=modulo, inc=inc,)
                ref = refs[last_ref]
                for my in range(self.mbh):
                    for mx in range(self.mbw):
                        src = self._plane_blocks(yuv, mx, my)
                        four = (my * self.mbw + mx) % self.FOUR_EVERY == 0
                        mvs = self._search(src, ref, mx, my, [wrap_mv(c, fc) for c in gm],
                                           fc, four)
                        pred = predict(ref, mx, my, mvs)
                        if self._sad(src, pred) > 6000:
                            self._intra(vw, mx, my, yuv, True)
                            continue
                        blocks = self._residual(src, pred, vw.q)
                        if len(mvs) == 1 and mvs[0] == (0, 0) and not any(blocks):
                            vw.skip_mb(mx, my)
                            continue
                        vw.inter_mb(mx, my, mvs, blocks)
            vop = vw.finish()
            self.tools.update(vw.tools)
            samples.append(vop)
            sync.append(typ == I_VOP)
            refs[di] = self._reconstruct(vop)
            colocated = (vw.mv, vw.four, vw.skip)
            prev_ref, last_ref = last_ref, di
        return Clip(self.vol.width, self.vol.height, samples, sync,
                    order, self.headers, self.vol, n, self.tools)


class _Clock:
    """The decoder's VOP clock (time_base, last_time_base in seconds):
    each VOP's modulo_time_base and vop_time_increment for a time in
    ticks; a B-VOP counts from its past reference's seconds."""

    def __init__(self, res):
        self.res, self.base, self.last_base = res, 0, 0

    def vop(self, typ, t):
        sec, inc = divmod(t, self.res)
        if typ != B_VOP:
            modulo = sec - self.base
            self.last_base, self.base = self.base, sec
        else:
            modulo = sec - self.last_base
        assert modulo >= 0
        return modulo, inc


def _rdiv(a, b):
    return (a + (b >> 1)) // b if a >= 0 else -((-a + (b >> 1)) // b)


def _dc_first(dc, pairs):
    """AC pairs from scan position 1 with the DC differential as the first
    TCOEF (run 0), or, a zero DC not coded, the first run one longer."""
    if dc:
        return [(0, dc)] + pairs
    return [(pairs[0][0] + 1, pairs[0][1])] + pairs[1:] if pairs else []


def _fcode(v):
    """The smallest f_code whose range holds vector v (half-pels) and a
    search step around it."""
    m = max(abs(v[0]), abs(v[1])) + 2
    f = 1
    while (32 << (f - 1)) <= m:
        f += 1
    return f


def encode(frames, motion):
    """A real-encoder clip of RGB ``frames`` (display order); ``motion(a,
    b)`` gives the global vector in half-pels from frame b to frame a."""
    frames = list(frames)
    h, w = frames[0].shape[:2]
    return Encoder(w, h).encode(frames, motion)


# --- what the port's decoder refuses -------------------------------------------------------

REFUSED = ("quarter-pel", "GMC", "interlaced", "data partitioning", "resync markers",
           "NEWPRED", "reduced-resolution", "scalability", "short video header")


def refused_clip(feature):
    """A clip of one I-VOP (32x32) whose VOL (or, for the short video
    header, whose sample) asks ``feature``; the port refuses it by name."""
    clip = random_stream(0, "intra", width=32, height=32, frames=1)
    if feature == "short video header":
        sv = bytes([0, 0, 0x80, 0x02, 0x08]) + b"\0" * 8
        return dataclasses.replace(clip, samples=[sv], headers=b"")
    vol = dataclasses.replace(clip.vol, verid=2, refuse=feature)
    return dataclasses.replace(clip, headers=vol_bytes(vol, BUILDS["xvid"]), vol=vol)
