"""HEVC / H.265 test streams for the port's video reader.

cv2's FFmpeg here decodes HEVC but writes none, so this module writes the
streams the tests and fixtures need: NAL units with emulation prevention,
VPS / SPS / PPS (short-term RPS sets with inter RPS prediction, long-term
pictures, scaling lists default and explicit with prediction, VUI colour
fields, conformance window, PCM, AMP, TMVP, strong intra smoothing, sign
data hiding, transform skip, cu_qp_delta, chroma QP offsets, transquant
bypass, constrained intra prediction, uniform and explicit tiles, WPP,
weighted prediction, deblocking control and overrides, SAO, list
modification, extra slice header bits, header extensions), slice segment
headers with entry points, and the CABAC encoder of H.265 9.3.4 with the
standard's binarisations and context selection for every syntax element
of a CTU (SAO, the coding quadtree, CU / PU / TU, merge and AMVP indices,
residual coding with sub-blocks, greater1 / greater2, Rice parameters and
sign hiding). Its CABAC initialisation values and context layout are read
from the port's decoder (``native/hevc_decode.cpp``, which took them from
FFmpeg's ``hevc_cabac.c``).

Two sources of coding decisions:

- :func:`random_stream`: random legal syntax from a seed, by tool group
  (``GROUPS``), at tiny sizes with odd CTB counts; its pictures are
  whatever they decode to; in decode order, or in a GOP structure of
  ``GOPS`` as encoders write them (x265's and HM's hierarchical B
  pictures, CRA pictures with RASL pictures, RADL pictures, BLA
  pictures, a file cut at a CRA picture; pictures sent with
  pic_output_flag 0, an end of sequence, temporal sub-layers);
- :func:`encode`: a small real encoder of uint8 RGB frames: an intra
  picture (planar / DC / horizontal / vertical by SAD), then P pictures
  predicted with a known global motion (or B pictures, low-delay or in
  HM's hierarchical GOPs with a CRA picture), the residual transformed and
  quantised at a fixed QP. It reconstructs through the port's plain numpy
  versions (``data/video.py``) with the loop filters off, so its
  reconstruction is what a decoder puts out.

Muxers: MP4 / MOV with an ``hvcC`` record under ``hvc1`` (parameter sets in
``hvcC`` only) or ``hev1`` (in band too), Matroska ``V_MPEGH/ISO/HEVC``
with ``hvcC`` as CodecPrivate, AVI under ``HEVC`` (Annex B samples); a
clip out of presentation order gets ``ctts`` in MP4 and its presentation
times as Matroska timecodes.

cv2 (FFmpeg) is the reference that decodes these streams in the tests. This
module is a test tool: the port never imports it.
"""

from __future__ import annotations

import dataclasses
import re
import struct
from pathlib import Path

import numpy as np

import torch_h264_writer as W264
from torch_h264_writer import BitWriter

_SRC = Path(__file__).resolve().parents[1] / "mast3r_slam_tpu_torch" / "native" / "hevc_decode.cpp"


def _tables():
    text = _SRC.read_text()
    enum = re.search(r"enum Ctx \{(.*?)\};", text, re.S).group(1)
    ctx = {k: int(v) for k, v in re.findall(r"k(\w+) = (\d+)", enum)}
    body = re.search(r"const uint8_t kInit\[3\]\[kNumCtx\] = \{(.*?)\};", text, re.S).group(1)
    vals = [int(v) for v in re.findall(r"\d+", body)]
    n = ctx["NumCtx"]
    return ctx, [vals[i * n:(i + 1) * n] for i in range(3)]


CTX, INIT = _tables()
SAO_MERGE, SAO_TYPE, SPLIT_CU, BYPASS_FLAG, SKIP = (CTX[k] for k in (
    "SaoMerge", "SaoType", "SplitCu", "BypassFlag", "Skip"))
QP_DELTA, PRED_MODE, PART_MODE, PREV_INTRA, CHROMA_MODE = (CTX[k] for k in (
    "QpDelta", "PredMode", "PartMode", "PrevIntra", "ChromaMode"))
MERGE_FLAG, MERGE_IDX, INTER_DIR, REF_IDX0 = (CTX[k] for k in (
    "MergeFlag", "MergeIdx", "InterDir", "RefIdx0"))
MVD_G0, MVD_G1, MVP_FLAG, ROOT_CBF, SPLIT_TU = (CTX[k] for k in (
    "MvdG0", "MvdG1", "MvpFlag", "RootCbf", "SplitTu"))
CBF_LUMA, CBF_CHROMA, TS_FLAG, LAST_X, LAST_Y = (CTX[k] for k in (
    "CbfLuma", "CbfChroma", "TsFlag", "LastX", "LastY"))
CSBF, SIG, GT1, GT2 = (CTX[k] for k in ("Csbf", "Sig", "Gt1", "Gt2"))

# the standard's scans (6.5.3-6.5.5): [log2 size][scanIdx] -> (x, y) list


def _scans():
    out = {}
    for lg in (1, 2, 3):
        n = 1 << lg
        diag, x, y = [], 0, 0
        while len(diag) < n * n:
            while y >= 0:
                if x < n and y < n:
                    diag.append((x, y))
                y -= 1
                x += 1
            y, x = x, 0
        hor = [(x, y) for y in range(n) for x in range(n)]
        ver = [(x, y) for x in range(n) for y in range(n)]
        out[lg] = (diag, hor, ver)
    return out


SCANS = _scans()
CTX_MAP4 = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)


# --- NAL units and the arithmetic coder -------------------------------------------------

def escape(data):
    """Emulation prevention over bytes that follow a nonzero byte; returns
    the escaped bytes and, for each input offset, its escaped offset."""
    out, pos, zeros = bytearray(), [], 0
    for b in data:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        pos.append(len(out))
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    pos.append(len(out))
    return bytes(out), pos


def nal_unit(typ, rbsp, layer=0, tid=0):
    """A NAL unit: its two-byte header (the second byte is never zero) and
    the RBSP with emulation prevention."""
    head = bytes([(typ << 1) | (layer >> 5), ((layer & 31) << 3) | (tid + 1)])
    return head + escape(rbsp)[0]


class Cabac(W264.Cabac):
    """H.264's arithmetic encoder (the same engine) with HEVC's contexts."""

    def init_contexts(self, init_type, qp):
        qp = min(max(qp, 0), 51)
        self.st, self.mps = [], []
        for v in INIT[init_type]:
            m, n = (v >> 4) * 5 - 45, ((v & 15) << 3) - 16
            pre = min(126, max(1, ((m * qp) >> 4) + n))
            self.st.append(pre - 64 if pre > 63 else 63 - pre)
            self.mps.append(1 if pre > 63 else 0)

    def states(self):
        return (list(self.st), list(self.mps))

    def load(self, s):
        self.st, self.mps = list(s[0]), list(s[1])

    def bits(self, v, n):
        for k in range(n - 1, -1, -1):
            self.bypass((v >> k) & 1)

    def finish(self):
        """terminate(1) and the flush; the last bit written is the stop /
        alignment bit; then zero bits to the byte boundary."""
        self.terminate(1)
        self.bw.align(0)


# --- parameter sets -------------------------------------------------------------------

@dataclasses.dataclass
class Params:
    """A stream's parameter sets (what the SPS and PPS carry)."""
    width: int = 64
    height: int = 48
    crop: tuple = (0, 0, 0, 0)   # left, right, top, bottom in luma samples (even)
    ctb_log2: int = 4
    min_cb_log2: int = 3
    min_tb_log2: int = 2
    max_tb_log2: int = 4
    max_th_inter: int = 1
    max_th_intra: int = 1
    log2_max_poc_lsb: int = 8
    max_dec: int = 5             # sps_max_dec_pic_buffering
    num_reorder: int = 0
    sub_layers: int = 1          # temporal sub-layers (the same ordering values in each)
    scaling: str = "off"         # off, default, sps (explicit), pps (explicit)
    amp: bool = False
    sao: bool = False
    pcm: tuple = None            # (bd_y, bd_c, log2 min, log2 max, loop filter disabled)
    st_sets: list = None         # SPS short-term RPS sets: lists of (delta, used)
    lt_sps: list = None          # long-term pictures in the SPS: (poc lsb, used)
    long_term: bool = False
    tmvp: bool = False
    strong_intra: bool = False
    vui: dict = None             # full_range, matrix, field_seq
    profile: int = 1
    chroma_format: int = 1       # what the SPS says (the syntax is 4:2:0's)
    bit_depth: int = 8
    # PPS
    dependent_slices: bool = False
    output_flag_present: bool = False
    extra_bits: int = 0
    sign_hiding: bool = False
    cabac_init_present: bool = False
    num_ref_default: tuple = (1, 1)
    init_qp: int = 30
    constrained_intra: bool = False
    transform_skip: bool = False
    cu_qp_delta: int = None      # diff_cu_qp_delta_depth, or None
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_offsets: bool = False
    weighted_pred: bool = False
    weighted_bipred: bool = False
    bypass: bool = False
    tiles: tuple = None          # (cols, rows) uniform, or ([widths], [heights]) in CTBs
    wpp: bool = False
    lf_across_tiles: bool = True
    lf_across_slices: bool = True
    deblock: tuple = None        # (override enabled, disabled, beta, tc) or None
    lists_mod: bool = False
    par_mrg_log2: int = 2
    slice_ext: bool = False
    seed: int = 0                # explicit scaling lists

    @property
    def coded_w(self):
        return self.width + self.crop[0] + self.crop[1]

    @property
    def coded_h(self):
        return self.height + self.crop[2] + self.crop[3]

    @property
    def ctb_w(self):
        return -(-self.coded_w // (1 << self.ctb_log2))

    @property
    def ctb_h(self):
        return -(-self.coded_h // (1 << self.ctb_log2))


def _ptl(bw, profile=1, level=93, sub_layers=1):
    bw.u(2, 0)
    bw.u(1, 0)
    bw.u(5, profile)
    compat = 0
    if profile in (1, 2, 3):
        compat |= 1 << (31 - profile)
        if profile == 1:
            compat |= 1 << (31 - 2)
    else:
        compat |= 1 << (31 - profile) if profile < 32 else 0
    bw.u(32, compat)
    bw.u(4, 0b1001)  # progressive, not interlaced, not non-packed, frame only
    bw.u(32, 0)
    bw.u(12, 0)
    bw.u(8, level)
    for _ in range(sub_layers - 1):  # no sub-layer profile or level
        bw.u(2, 0)
    if sub_layers > 1:
        for _ in range(sub_layers - 1, 8):
            bw.u(2, 0)


def _sub_layer_ordering(bw, p: Params):
    """sub_layer_ordering_info_present_flag 1, each sub-layer alike."""
    bw.u(1, 1)
    for _ in range(p.sub_layers):
        bw.ue(p.max_dec - 1)
        bw.ue(p.num_reorder)
        bw.ue(0)


def write_vps(p: Params):
    bw = BitWriter()
    bw.u(4, 0)
    bw.u(1, 1)
    bw.u(1, 1)
    bw.u(6, 0)
    bw.u(3, p.sub_layers - 1)
    bw.u(1, p.sub_layers == 1)  # temporal_id_nesting_flag
    bw.u(16, 0xFFFF)
    _ptl(bw, p.profile, sub_layers=p.sub_layers)
    _sub_layer_ordering(bw, p)
    bw.u(6, 0)
    bw.ue(0)
    bw.u(1, 0)
    bw.u(1, 0)
    bw.trailing()
    return nal_unit(32, bw.bytes())


def scaling_lists(seed):
    """Explicit scaling lists: (sizeId, matrixId) -> ("pred", delta) or
    ("coded", dc, values)."""
    rng = np.random.default_rng(seed + 77)
    out = {}
    for s in range(4):
        for m in range(0, 6, 3 if s == 3 else 1):
            n = min(64, 1 << (4 + 2 * s))
            mstep = 3 if s == 3 else 1
            r = rng.random()
            if r < 0.25:
                out[(s, m)] = ("pred", 0)
            elif r < 0.5 and m >= mstep:
                out[(s, m)] = ("pred", int(rng.integers(1, m // mstep + 1)))
            else:
                vals = [int(v) for v in rng.integers(8, 40, n)]
                out[(s, m)] = ("coded", int(rng.integers(8, 40)), vals)
    return out


def _write_scaling(bw, lists):
    for s in range(4):
        for m in range(0, 6, 3 if s == 3 else 1):
            e = lists[(s, m)]
            if e[0] == "pred":
                bw.u(1, 0)
                bw.ue(e[1])
                continue
            bw.u(1, 1)
            nxt = 8
            if s > 1:
                bw.se(e[1] - 8)
                nxt = e[1]
            for v in e[2]:
                d = (v - nxt) % 256
                if d > 127:
                    d -= 256
                bw.se(d)
                nxt = v


def _write_st_rps(bw, rps, idx, sets, in_slice, pred=None):
    """An explicit set [(delta, used)], or with ``pred`` = (ref index
    delta, delta_rps, [(used, use_delta)] per entry of the reference set
    plus one)."""
    if idx != 0:
        bw.u(1, 1 if pred else 0)
    if pred:
        delta_idx, drps, flags = pred
        if in_slice:
            bw.ue(delta_idx - 1)
        bw.u(1, 1 if drps < 0 else 0)
        bw.ue(abs(drps) - 1)
        for used, use in flags:
            bw.u(1, used)
            if not used:
                bw.u(1, use)
        return
    neg = sorted([d for d, _ in rps if d < 0], reverse=True)
    pos = sorted([d for d, _ in rps if d > 0])
    used = dict(rps)
    bw.ue(len(neg))
    bw.ue(len(pos))
    prev = 0
    for d in neg:
        bw.ue(prev - d - 1)
        bw.u(1, used[d])
        prev = d
    prev = 0
    for d in pos:
        bw.ue(d - prev - 1)
        bw.u(1, used[d])
        prev = d


def derive_rps(ref, pred):
    """An inter-predicted set as FFmpeg derives it: [(delta, used)], the
    negative ones closest first, then the positive ones."""
    _, drps, flags = pred
    out = []
    for j, (used, use) in enumerate(flags):
        if not (used or use):
            continue
        d = (ref[j][0] if j < len(ref) else 0) + drps
        out.append((d, used))
    out.sort(key=lambda e: e[0])
    neg = [e for e in out if e[0] < 0][::-1]
    return neg + [e for e in out if e[0] >= 0]


def sorted_rps(rps):
    neg = sorted([e for e in rps if e[0] < 0], key=lambda e: -e[0])
    return neg + sorted([e for e in rps if e[0] > 0])


def write_sps(p: Params):
    bw = BitWriter()
    bw.u(4, 0)
    bw.u(3, p.sub_layers - 1)
    bw.u(1, p.sub_layers == 1)  # temporal_id_nesting_flag
    _ptl(bw, p.profile, 120 if p.coded_w * p.coded_h > 1 << 20 else 93, p.sub_layers)
    bw.ue(0)
    bw.ue(p.chroma_format)
    if p.chroma_format == 3:
        bw.u(1, 0)
    bw.ue(p.coded_w)
    bw.ue(p.coded_h)
    if any(p.crop):
        bw.u(1, 1)
        for v in p.crop:
            bw.ue(v // 2)
    else:
        bw.u(1, 0)
    bw.ue(p.bit_depth - 8)
    bw.ue(p.bit_depth - 8)
    bw.ue(p.log2_max_poc_lsb - 4)
    _sub_layer_ordering(bw, p)
    bw.ue(p.min_cb_log2 - 3)
    bw.ue(p.ctb_log2 - p.min_cb_log2)
    bw.ue(p.min_tb_log2 - 2)
    bw.ue(p.max_tb_log2 - p.min_tb_log2)
    bw.ue(p.max_th_inter)
    bw.ue(p.max_th_intra)
    bw.u(1, p.scaling != "off")
    if p.scaling != "off":
        bw.u(1, p.scaling == "sps")
        if p.scaling == "sps":
            _write_scaling(bw, scaling_lists(p.seed))
    bw.u(1, p.amp)
    bw.u(1, p.sao)
    bw.u(1, p.pcm is not None)
    if p.pcm:
        bdy, bdc, lmin, lmax, lf = p.pcm
        bw.u(4, bdy - 1)
        bw.u(4, bdc - 1)
        bw.ue(lmin - 3)
        bw.ue(lmax - lmin)
        bw.u(1, lf)
    sets = p.st_sets or []
    bw.ue(len(sets))
    for i, s in enumerate(sets):
        _write_st_rps(bw, s, i, sets, False)
    bw.u(1, p.long_term)
    if p.long_term:
        lt = p.lt_sps or []
        bw.ue(len(lt))
        for lsb, used in lt:
            bw.u(p.log2_max_poc_lsb, lsb)
            bw.u(1, used)
    bw.u(1, p.tmvp)
    bw.u(1, p.strong_intra)
    v = p.vui
    bw.u(1, v is not None)
    if v is not None:
        bw.u(1, 0)  # aspect ratio
        bw.u(1, 0)  # overscan
        signal = "full_range" in v or "matrix" in v
        bw.u(1, signal)
        if signal:
            bw.u(3, 5)
            bw.u(1, v.get("full_range", 0))
            bw.u(1, "matrix" in v)
            if "matrix" in v:
                bw.u(8, 2)
                bw.u(8, 2)
                bw.u(8, v["matrix"])
        bw.u(1, 0)  # chroma loc
        bw.u(1, 0)  # neutral chroma
        bw.u(1, v.get("field_seq", 0))
        bw.u(1, 0)  # frame field info
        bw.u(1, 1 if v.get("window") else 0)
        if v.get("window"):
            for k in v["window"]:
                bw.ue(k)
        bw.u(1, 1 if v.get("timing") else 0)
        if v.get("timing"):
            bw.u(32, 1001)
            bw.u(32, 30000)
            bw.u(1, 0)
            bw.u(1, 0)
        bw.u(1, 0)  # bitstream restriction
    bw.u(1, 1 if p.profile == 4 else 0)
    if p.profile == 4:
        bw.u(1, 1)
        bw.u(7, 0)
        bw.u(9, 0)  # an empty range extension
    bw.trailing()
    return nal_unit(33, bw.bytes())


def tile_sizes(p: Params):
    """Column widths and row heights in CTBs."""
    if not p.tiles:
        return [p.ctb_w], [p.ctb_h]
    a, b = p.tiles
    if isinstance(a, int):
        cw = [(i + 1) * p.ctb_w // a - i * p.ctb_w // a for i in range(a)]
        rh = [(j + 1) * p.ctb_h // b - j * p.ctb_h // b for j in range(b)]
        return cw, rh
    return list(a) + [p.ctb_w - sum(a)], list(b) + [p.ctb_h - sum(b)]


def write_pps(p: Params, pps_id=0):
    bw = BitWriter()
    bw.ue(pps_id)
    bw.ue(0)
    bw.u(1, p.dependent_slices)
    bw.u(1, p.output_flag_present)
    bw.u(3, p.extra_bits)
    bw.u(1, p.sign_hiding)
    bw.u(1, p.cabac_init_present)
    bw.ue(p.num_ref_default[0] - 1)
    bw.ue(p.num_ref_default[1] - 1)
    bw.se(p.init_qp - 26)
    bw.u(1, p.constrained_intra)
    bw.u(1, p.transform_skip)
    bw.u(1, p.cu_qp_delta is not None)
    if p.cu_qp_delta is not None:
        bw.ue(p.cu_qp_delta)
    bw.se(p.cb_qp_offset)
    bw.se(p.cr_qp_offset)
    bw.u(1, p.slice_chroma_offsets)
    bw.u(1, p.weighted_pred)
    bw.u(1, p.weighted_bipred)
    bw.u(1, p.bypass)
    bw.u(1, p.tiles is not None)
    bw.u(1, p.wpp)
    if p.tiles:
        cw, rh = tile_sizes(p)
        bw.ue(len(cw) - 1)
        bw.ue(len(rh) - 1)
        uniform = isinstance(p.tiles[0], int)
        bw.u(1, uniform)
        if not uniform:
            for v in cw[:-1]:
                bw.ue(v - 1)
            for v in rh[:-1]:
                bw.ue(v - 1)
        bw.u(1, p.lf_across_tiles)
    bw.u(1, p.lf_across_slices)
    bw.u(1, p.deblock is not None)
    if p.deblock is not None:
        ov, dis, beta, tc = p.deblock
        bw.u(1, ov)
        bw.u(1, dis)
        if not dis:
            bw.se(beta)
            bw.se(tc)
    bw.u(1, p.scaling == "pps")
    if p.scaling == "pps":
        _write_scaling(bw, scaling_lists(p.seed + 1))
    bw.u(1, p.lists_mod)
    bw.ue(p.par_mrg_log2 - 2)
    bw.u(1, p.slice_ext)
    bw.u(1, 0)
    bw.trailing()
    return nal_unit(34, bw.bytes())


# --- a picture's layout -------------------------------------------------------------------

class Layout:
    """CTB raster <-> tile scan, tile ids and the z-scan order of 4x4
    blocks (6.5.1 / 6.5.2)."""

    def __init__(self, p: Params):
        self.p = p
        self.W, self.H = p.coded_w, p.coded_h
        self.W4, self.H4 = self.W // 4, self.H // 4
        self.lg = p.ctb_log2
        cw_, rh_ = tile_sizes(p)
        cw, rh = p.ctb_w, p.ctb_h
        self.col_bd = np.concatenate([[0], np.cumsum(cw_)]).astype(int).tolist()
        self.row_bd = np.concatenate([[0], np.cumsum(rh_)]).astype(int).tolist()
        n = cw * rh
        self.rs2ts, self.ts2rs, self.tile = [0] * n, [0] * n, [0] * n
        for rs in range(n):
            tx, ty = rs % cw, rs // cw
            ci = max(i for i in range(len(cw_)) if tx >= self.col_bd[i])
            ri = max(j for j in range(len(rh_)) if ty >= self.row_bd[j])
            v = sum(rh_[ri] * cw_[i] for i in range(ci)) + sum(cw * rh_[j] for j in range(ri))
            v += (ty - self.row_bd[ri]) * cw_[ci] + tx - self.col_bd[ci]
            self.rs2ts[rs], self.ts2rs[v] = v, rs
            self.tile[v] = ri * len(cw_) + ci
        sub = self.lg - 2
        ys, xs = np.mgrid[0:self.H4, 0:self.W4]
        rs = (ys >> sub) * cw + (xs >> sub)
        z = np.asarray(self.rs2ts)[rs] << (2 * sub)
        for i in range(sub):
            m = 1 << i
            z = z + np.where(xs & m, m * m, 0) + np.where(ys & m, 2 * m * m, 0)
        self.zs = z
        self.ncol, self.nrow, self.nctb = cw, rh, n

    def col_start(self, rx):
        return rx in self.col_bd


# --- coding one picture ----------------------------------------------------------------------

@dataclasses.dataclass
class Segment:
    """One slice segment: its first CTB in tile scan, its CTB count, and
    its header's fields (a dependent segment takes its slice's)."""
    start: int
    count: int
    dependent: bool = False
    qp_delta: int = 0
    sao: tuple = (False, False)
    deblock: tuple = None       # override: (disabled, beta, tc)
    lf_across: bool = None
    cb_cr: tuple = (0, 0)
    cabac_init: bool = False
    max_merge: int = 5


class PictureCoder:
    """The CTU syntax of one picture's slice segments, its decisions from a
    chooser (random or an encoder)."""

    def __init__(self, p: Params, lay: Layout, pic, chooser):
        self.p, self.lay, self.pic, self.ch = p, lay, pic, chooser
        W4, H4 = lay.W4, lay.H4
        self.flags = np.zeros((H4, W4), np.uint8)  # 1 intra 2 skip 4 pcm 8 bypass
        self.depth = np.zeros((H4, W4), np.uint8)
        self.ipm = np.ones((H4, W4), np.uint8)
        self.ctb_slice = [-1] * lay.nctb
        self.sao = [None] * lay.nctb
        self.wpp_state = None

    # availability (6.4.1)
    def avail(self, xc, yc, xn, yn):
        lay = self.lay
        if xn < 0 or yn < 0 or xn >= lay.W or yn >= lay.H:
            return False
        if lay.zs[yn >> 2, xn >> 2] > lay.zs[yc >> 2, xc >> 2]:
            return False
        lg = lay.lg
        cn = (yn >> lg) * lay.ncol + (xn >> lg)
        cc = (yc >> lg) * lay.ncol + (xc >> lg)
        if self.ctb_slice[cn] != self.ctb_slice[cc] or self.ctb_slice[cn] < 0:
            return False
        return lay.tile[lay.rs2ts[cn]] == lay.tile[lay.rs2ts[cc]]

    def segment(self, seg: Segment, header_bits):
        """The slice data of one segment, after its header (written by
        ``header_bits(entry_offsets)``); returns the NAL payload."""
        p, lay = self.p, self.lay
        sh = self.pic.slice_of(seg)
        self.sh = sh
        streams = []
        bw = BitWriter()
        cab = Cabac(bw)
        cab.init_engine()
        ts = seg.start
        rs0 = lay.ts2rs[ts]
        tile_start = ts == 0 or lay.tile[ts] != lay.tile[ts - 1]
        self.ctb_slice[rs0] = sh["slice_addr"]
        fresh = True
        lg = lay.lg
        if not tile_start and p.wpp and lay.col_start(rs0 % lay.ncol):
            x0, y0 = (rs0 % lay.ncol) << lg, (rs0 // lay.ncol) << lg
            if self.wpp_state and self.avail(x0, y0, x0 + (1 << lg), y0 - (1 << lg)):
                cab.load(self.wpp_state)
                fresh = False
        elif not tile_start and seg.dependent:
            cab.load(self.pic.ds_state)
            fresh = False
        if fresh:
            cab.init_contexts(sh["init_type"], sh["qp"])
        if not seg.dependent or tile_start:
            self.first_qg = True
        if p.wpp and lay.col_start(rs0 % lay.ncol):
            self.first_qg = True
        self.cab = cab
        for k in range(seg.count):
            rs = lay.ts2rs[ts]
            self.ctb_slice[rs] = sh["slice_addr"]
            rx, ry = rs % lay.ncol, rs // lay.ncol
            if sh["sao"][0] or sh["sao"][1]:
                self.sao_syntax(rx, ry, rs)
            self.quadtree(rx << lg, ry << lg, lg, 0)
            last = k == seg.count - 1
            if p.wpp and rx > 0 and lay.col_start(rx - 1) and not lay.col_start(rx):
                self.wpp_state = cab.states()
            ts += 1
            if last:
                cab.finish()
                break
            cab.terminate(0)
            nrs = lay.ts2rs[ts]
            new_tile = p.tiles is not None and lay.tile[ts] != lay.tile[ts - 1]
            new_row = p.wpp and lay.col_start(nrs % lay.ncol)
            if new_tile or new_row:
                cab.finish()
                streams.append(len(bw.out))
                cab.init_engine()
                self.first_qg = True
                synced = False
                if not new_tile and new_row:
                    x0, y0 = (nrs % lay.ncol) << lg, (nrs // lay.ncol) << lg
                    self.ctb_slice[nrs] = sh["slice_addr"]
                    if self.wpp_state and self.avail(x0, y0, x0 + (1 << lg), y0 - (1 << lg)):
                        cab.load(self.wpp_state)
                        synced = True
                    self.ctb_slice[nrs] = -1
                if not synced:
                    cab.init_contexts(sh["init_type"], sh["qp"])
        self.pic.ds_state = cab.states()
        data = bw.bytes()
        esc, pos = escape(data)
        bounds = [0] + [pos[b] for b in streams] + [len(esc)]
        offsets = [bounds[i + 1] - bounds[i] for i in range(len(bounds) - 2)]
        hb = header_bits(offsets)
        return hb + data

    # -- SAO (7.3.8.3)
    def sao_syntax(self, rx, ry, rs):
        lay, cab, sh = self.lay, self.cab, self.sh
        ts = lay.rs2ts[rs]
        left = up = False
        par = self.ch.sao(rx, ry)
        if rx > 0 and rs - 1 >= sh["slice_addr"] and lay.tile[ts] == lay.tile[lay.rs2ts[rs - 1]]:
            left = par == "left"
            cab.bin(SAO_MERGE, left)
        if ry > 0 and not left and rs - lay.ncol >= sh["slice_addr"] and \
                lay.tile[ts] == lay.tile[lay.rs2ts[rs - lay.ncol]]:
            up = par == "up"
            cab.bin(SAO_MERGE, up)
        if left or up:
            return
        if not isinstance(par, dict):
            par = {"type": [0, 0, 0]}
        for c in range(3):
            if not (sh["sao"][0] if c == 0 else sh["sao"][1]):
                continue
            t = par["type"][c if c < 2 else 1]
            if c < 2:
                cab.bin(SAO_TYPE, t != 0)
                if t:
                    cab.bypass(1 if t == 2 else 0)
            if not t:
                continue
            offs = par["off"][c]
            for k in range(4):
                a = abs(offs[k])
                for _ in range(a):
                    cab.bypass(1)
                if a < 7:
                    cab.bypass(0)
            if t == 1:
                for k in range(4):
                    if offs[k]:
                        cab.bypass(1 if offs[k] < 0 else 0)
                cab.bits(par["band"][c], 5)
            elif c < 2:
                cab.bits(par["eo"][c], 2)

    # -- the coding quadtree (7.3.8.4)
    def quadtree(self, x0, y0, lg, depth):
        p, lay, cab = self.p, self.lay, self.cab
        size = 1 << lg
        if x0 + size <= lay.W and y0 + size <= lay.H and lg > p.min_cb_log2:
            split = self.ch.split(x0, y0, lg, depth)
            ctx = 0
            if self.avail(x0, y0, x0 - 1, y0) and self.depth[y0 >> 2, (x0 - 1) >> 2] > depth:
                ctx += 1
            if self.avail(x0, y0, x0, y0 - 1) and self.depth[(y0 - 1) >> 2, x0 >> 2] > depth:
                ctx += 1
            cab.bin(SPLIT_CU + ctx, split)
        else:
            split = lg > p.min_cb_log2
        qg_log2 = p.ctb_log2 - (p.cu_qp_delta or 0)
        if lg >= qg_log2:
            self.qp_delta_coded = False
            self.ch.new_qg()
        if split:
            h = size >> 1
            self.quadtree(x0, y0, lg - 1, depth + 1)
            if x0 + h < lay.W:
                self.quadtree(x0 + h, y0, lg - 1, depth + 1)
            if y0 + h < lay.H:
                self.quadtree(x0, y0 + h, lg - 1, depth + 1)
            if x0 + h < lay.W and y0 + h < lay.H:
                self.quadtree(x0 + h, y0 + h, lg - 1, depth + 1)
        else:
            n4 = size >> 2
            self.depth[y0 >> 2:(y0 >> 2) + n4, x0 >> 2:(x0 >> 2) + n4] = depth
            self.coding_unit(x0, y0, lg)

    # -- coding units (7.3.8.5)
    def coding_unit(self, x0, y0, lg):
        p, cab, sh = self.p, self.cab, self.sh
        n = 1 << lg
        cu = self.ch.cu(x0, y0, lg, sh, self)
        self.cu = cu
        self.cu_x, self.cu_y, self.cu_lg = x0, y0, lg
        if p.bypass:
            cab.bin(BYPASS_FLAG, cu["bypass"])
        if sh["type"] != 2:
            ctx = 0
            if self.avail(x0, y0, x0 - 1, y0) and self.flags[y0 >> 2, (x0 - 1) >> 2] & 2:
                ctx += 1
            if self.avail(x0, y0, x0, y0 - 1) and self.flags[(y0 - 1) >> 2, x0 >> 2] & 2:
                ctx += 1
            cab.bin(SKIP + ctx, cu["skip"])
        intra = cu["intra"]
        part = cu["part"]
        if not cu["skip"] and sh["type"] != 2:
            cab.bin(PRED_MODE, intra)
        if not cu["skip"] and (not intra or lg == p.min_cb_log2):
            self.part_mode(part, intra, lg)
        fl = (1 if intra else 0) | (2 if cu["skip"] else 0) | (8 if cu["bypass"] else 0)
        sl = np.s_[y0 >> 2:(y0 + n) >> 2, x0 >> 2:(x0 + n) >> 2]
        self.flags[sl] = fl
        self.ch.cu_start(self, cu)
        if cu["skip"]:
            self.prediction_unit(x0, y0, n, n, 0, cu["pus"][0], True)
            return self.ch.cu_end(self, cu)
        pcm = False
        if intra:
            if part == 0 and p.pcm and p.pcm[2] <= lg <= p.pcm[3]:
                pcm = cu.get("pcm", False)
                cab.terminate(1 if pcm else 0)
            if pcm:
                self.pcm_sample(x0, y0, lg)
                self.flags[sl] |= 4
                self.ipm[sl] = 1
                return self.ch.cu_end(self, cu)
            nb = 4 if part == 3 else 1
            pb = n // 2 if part == 3 else n
            modes = cu["modes"]
            codes = []
            for k in range(nb):
                xp, yp = x0 + (k & 1) * pb, y0 + (k >> 1) * pb
                cand = self.mpm(xp, yp)
                m = modes[k]
                codes.append(("mpm", cand.index(m)) if m in cand else ("rem", m, cand))
                self.ipm[yp >> 2:(yp + pb) >> 2, xp >> 2:(xp + pb) >> 2] = m
            for c in codes:
                cab.bin(PREV_INTRA, c[0] == "mpm")
            for c in codes:
                if c[0] == "mpm":
                    idx = c[1]
                    for i in range(idx):
                        cab.bypass(1)
                    if idx < 2:
                        cab.bypass(0)
                else:
                    v = c[1] - sum(1 for q in c[2] if q < c[1])
                    cab.bits(v, 5)
            cm = cu["chroma"]
            cab.bin(CHROMA_MODE, cm != 4)
            if cm != 4:
                cab.bits(cm, 2)
        else:
            h, q = n // 2, n // 4
            geo = {0: [(0, 0, n, n)], 1: [(0, 0, n, h), (0, h, n, h)],
                   2: [(0, 0, h, n), (h, 0, h, n)],
                   3: [(0, 0, h, h), (h, 0, h, h), (0, h, h, h), (h, h, h, h)],
                   4: [(0, 0, n, q), (0, q, n, n - q)], 5: [(0, 0, n, n - q), (0, n - q, n, q)],
                   6: [(0, 0, q, n), (q, 0, n - q, n)], 7: [(0, 0, n - q, n), (n - q, 0, q, n)]}[part]
            for k, (dx, dy, w, hh) in enumerate(geo):
                self.prediction_unit(x0 + dx, y0 + dy, w, hh, k, cu["pus"][k], False)
        root = True
        if not intra and not (part == 0 and cu["pus"][0].get("merge") is not None):
            root = cu["root"]
            cab.bin(ROOT_CBF, root)
        if root:
            isplit = intra and part == 3
            maxd = p.max_th_intra + (1 if isplit else 0) if intra else p.max_th_inter
            self.transform_tree(x0, y0, x0, y0, lg, 0, 0, maxd, isplit, 0, 0)
        self.ch.cu_end(self, cu)

    def part_mode(self, part, intra, lg):
        p, cab = self.p, self.cab
        cab.bin(PART_MODE, part == 0)
        if part == 0:
            return
        if intra:
            return
        if lg == p.min_cb_log2:
            cab.bin(PART_MODE + 1, part == 1)
            if part == 1 or lg == 3:
                return
            cab.bin(PART_MODE + 2, part == 2)
            return
        if not p.amp:
            cab.bin(PART_MODE + 1, part == 1)
            return
        hor = part in (1, 4, 5)
        cab.bin(PART_MODE + 1, hor)
        if hor:
            cab.bin(PART_MODE + 3, part == 1)
            if part != 1:
                cab.bypass(part == 5)
        else:
            cab.bin(PART_MODE + 3, part == 2)
            if part != 2:
                cab.bypass(part == 7)

    def mpm(self, xp, yp):
        a = b = 1
        if self.avail(xp, yp, xp - 1, yp) and self.flags[yp >> 2, (xp - 1) >> 2] & 1 and \
                not self.flags[yp >> 2, (xp - 1) >> 2] & 4:
            a = int(self.ipm[yp >> 2, (xp - 1) >> 2])
        lg = self.lay.lg
        if self.avail(xp, yp, xp, yp - 1) and self.flags[(yp - 1) >> 2, xp >> 2] & 1 and \
                not self.flags[(yp - 1) >> 2, xp >> 2] & 4 and yp - 1 >= ((yp >> lg) << lg):
            b = int(self.ipm[(yp - 1) >> 2, xp >> 2])
        if a == b:
            if a < 2:
                return [0, 1, 26]
            return [a, 2 + ((a + 29) % 32), 2 + ((a - 2 + 1) % 32)]
        c = 0 if a != 0 and b != 0 else (1 if a != 1 and b != 1 else 26)
        return [a, b, c]

    def pcm_sample(self, x0, y0, lg):
        bw = self.cab.bw
        bw.align(0)
        bdy, bdc = self.p.pcm[0], self.p.pcm[1]
        ys, cb, cr = self.cu["pcm_samples"]
        for v in ys.ravel():
            bw.u(bdy, int(v))
        for v in cb.ravel():
            bw.u(bdc, int(v))
        for v in cr.ravel():
            bw.u(bdc, int(v))
        self.cab.init_engine()

    # -- prediction units (7.3.8.6)
    def prediction_unit(self, x, y, w, h, k, pu, skip):
        cab, sh = self.cab, self.sh
        if not skip:
            cab.bin(MERGE_FLAG, pu.get("merge") is not None)
        if pu.get("merge") is not None:
            if sh["max_merge"] > 1:
                idx = pu["merge"]
                cab.bin(MERGE_IDX, idx > 0)
                if idx > 0:
                    for i in range(1, idx):
                        cab.bypass(1)
                    if idx < sh["max_merge"] - 1:
                        cab.bypass(0)
            self.ch.pu_done(self, x, y, w, h, k, pu)
            return
        d = pu["dir"]
        if sh["type"] == 0:
            if w + h != 12:
                cab.bin(INTER_DIR + int(self.depth[self.cu_y >> 2, self.cu_x >> 2]), d == 3)
            if d != 3:
                cab.bin(INTER_DIR + 4, d == 2)
        for li in range(2):
            if not (d >> li) & 1:
                continue
            nref = sh["num_ref"][li]
            if nref > 1:
                r = pu["ref"][li]
                ctx = REF_IDX0  # ref_idx_l0 and ref_idx_l1 share their contexts
                for i in range(min(r + 1, nref - 1)):
                    b = 1 if i < r else 0
                    if i < 2:
                        cab.bin(ctx + i, b)
                    else:
                        cab.bypass(b)
            if li == 1 and sh["mvd_l1_zero"] and d == 3:
                pass
            else:
                mvd = pu["mvd"][li]
                g0 = [int(mvd[0] != 0), int(mvd[1] != 0)]
                g1 = [int(abs(mvd[0]) > 1), int(abs(mvd[1]) > 1)]
                cab.bin(MVD_G0, g0[0])
                cab.bin(MVD_G0, g0[1])
                if g0[0]:
                    cab.bin(MVD_G1 + 1, g1[0])
                if g0[1]:
                    cab.bin(MVD_G1 + 1, g1[1])
                for c in range(2):
                    if not g0[c]:
                        continue
                    if g1[c]:
                        cab.eg(abs(mvd[c]) - 2, 1)
                    cab.bypass(1 if mvd[c] < 0 else 0)
            cab.bin(MVP_FLAG, pu["mvp"][li])
        self.ch.pu_done(self, x, y, w, h, k, pu)

    # -- the transform tree (7.3.8.8 - 7.3.8.10)
    def transform_tree(self, x0, y0, xb, yb, lg, depth, blk, maxd, isplit, pcb, pcr):
        p, cab, cu = self.p, self.cab, self.cu
        intra, part = cu["intra"], cu["part"]
        if lg <= p.max_tb_log2 and lg > p.min_tb_log2 and depth < maxd and \
                not (isplit and depth == 0):
            split = self.ch.tu_split(x0, y0, lg, depth)
            cab.bin(SPLIT_TU + 5 - lg, split)
        else:
            inter_split = p.max_th_inter == 0 and not intra and part != 0 and depth == 0
            split = lg > p.max_tb_log2 or (isplit and depth == 0) or inter_split
        cb, cr = pcb, pcr
        if lg > 2:
            want = self.ch.cbf_chroma(x0, y0, lg, depth)
            cb = cr = 0
            if depth == 0 or pcb:
                cb = want[0]
                cab.bin(CBF_CHROMA + depth, cb)
            if depth == 0 or pcr:
                cr = want[1]
                cab.bin(CBF_CHROMA + depth, cr)
        if split:
            h = 1 << (lg - 1)
            for k, (dx, dy) in enumerate(((0, 0), (h, 0), (0, h), (h, h))):
                self.transform_tree(x0 + dx, y0 + dy, x0, y0, lg - 1, depth + 1, k, maxd, isplit,
                                    cb, cr)
            return
        cbf_l = True
        if intra or depth != 0 or cb or cr:
            cbf_l = self.ch.cbf_luma(x0, y0, lg, depth)
            cab.bin(CBF_LUMA + (1 if depth == 0 else 0), cbf_l)
        self.transform_unit(x0, y0, xb, yb, lg, blk, cbf_l, cb, cr)

    def transform_unit(self, x0, y0, xb, yb, lg, blk, cbf_l, cb, cr):
        p, cab, cu = self.p, self.cab, self.cu
        intra = cu["intra"]
        lmode = int(self.ipm[y0 >> 2, x0 >> 2]) if intra else -1
        if intra:
            self.ch.intra(x0, y0, lg, 0, lmode)
        if (cbf_l or cb or cr) and p.cu_qp_delta is not None and not self.qp_delta_coded:
            v = self.ch.qp_delta()
            a = abs(v)
            for i in range(min(a, 5)):
                cab.bin(QP_DELTA + (1 if i else 0), 1)
            if a < 5:
                cab.bin(QP_DELTA + (1 if a else 0), 0)
            else:
                cab.eg(a - 5, 0)
            if a:
                cab.bypass(1 if v < 0 else 0)
            self.qp_delta_coded = True
        if cbf_l:
            self.residual(x0, y0, lg, 0, lmode)
        cmode = self.chroma_mode() if intra else -1
        if lg > 2:
            for c in (1, 2):
                if intra:
                    self.ch.intra(x0 // 2, y0 // 2, lg - 1, c, cmode)
                if (cb, cr)[c - 1]:
                    self.residual(x0 // 2, y0 // 2, lg - 1, c, cmode)
        elif blk == 3:
            for c in (1, 2):
                if intra:
                    self.ch.intra(xb // 2, yb // 2, 2, c, cmode)
                if (cb, cr)[c - 1]:
                    self.residual(xb // 2, yb // 2, 2, c, cmode)

    def chroma_mode(self):
        luma = int(self.ipm[self.cu_y >> 2, self.cu_x >> 2])
        cm = self.cu["chroma"]
        if cm == 4:
            return luma
        v = (0, 26, 10, 1)[cm]
        return 34 if v == luma else v

    # -- residual coding (7.3.8.11)
    def residual(self, x0, y0, lg, c, mode):
        p, cab, cu = self.p, self.cab, self.cu
        n = 1 << lg
        ts_ok = p.transform_skip and not cu["bypass"] and lg == 2
        levels, ts = self.ch.levels(x0, y0, lg, c, mode, ts_ok)
        levels = np.array(levels, np.int64).reshape(n, n)
        assert levels.any()
        if ts_ok:
            cab.bin(TS_FLAG + (1 if c else 0), ts)
        scan = 0
        if mode >= 0 and (lg == 2 or (lg == 3 and c == 0)):
            scan = 2 if 6 <= mode <= 14 else 1 if 22 <= mode <= 30 else 0
        lsb = lg - 2
        nsb = 1 << lsb
        sbscan = [(0, 0)] if lsb == 0 else SCANS[lsb][scan]
        cscan = SCANS[2][scan]
        hide_ok = p.sign_hiding and not cu["bypass"]
        # sign hiding: each hidden sign must match the parity of its sub-block
        if hide_ok:
            for xs, ys in sbscan:
                pos = [k for k, (xp, yp) in enumerate(cscan)
                       if levels[(ys << 2) + yp, (xs << 2) + xp]]
                if pos and max(pos) - min(pos) > 3:
                    xp, yp = cscan[min(pos)]
                    yy, xx = (ys << 2) + yp, (xs << 2) + xp
                    tot = int(np.abs(levels[ys * 4:ys * 4 + 4, xs * 4:xs * 4 + 4]).sum())
                    if (tot & 1) != (levels[yy, xx] < 0):
                        levels[yy, xx] += 1 if levels[yy, xx] > 0 else -1
        # the last significant coefficient in scan order
        order = []
        for i, (xs, ys) in enumerate(sbscan):
            for k, (xp, yp) in enumerate(cscan):
                order.append((i, k, (xs << 2) + xp, (ys << 2) + yp))
        last = max(o for o in order if levels[o[3], o[2]])
        last_sb, last_pos, lx, ly = last
        if scan == 2:
            lx, ly = ly, lx
        if c == 0:
            off, shift = 3 * (lg - 2) + ((lg - 1) >> 2), (lg + 1) >> 2
        else:
            off, shift = 15, lg - 2
        maxp = (lg << 1) - 1

        def prefix_of(v):
            if v < 4:
                return v, 0, 0
            for pre in range(4, maxp + 1):
                k = (pre >> 1) - 1
                base = (1 << k) * (2 + (pre & 1))
                if base <= v < base + (1 << k):
                    return pre, v - base, k
            raise ValueError(v)
        px, sx, kx = prefix_of(lx)
        py, sy, ky = prefix_of(ly)
        for ctx0, pre in ((LAST_X, px), (LAST_Y, py)):
            for i in range(pre):
                cab.bin(ctx0 + off + (i >> shift), 1)
            if pre < maxp:
                cab.bin(ctx0 + off + (pre >> shift), 0)
        if px > 3:
            cab.bits(sx, kx)
        if py > 3:
            cab.bits(sy, ky)
        csbf = np.zeros((nsb, nsb), np.uint8)
        g1ctx = 1
        for i in range(last_sb, -1, -1):
            xs, ys = sbscan[i]
            blkv = levels[ys * 4:ys * 4 + 4, xs * 4:xs * 4 + 4]
            infer_dc = False
            if 0 < i < last_sb:
                r = csbf[xs + 1, ys] if xs + 1 < nsb else 0
                b = csbf[xs, ys + 1] if ys + 1 < nsb else 0
                csbf[xs, ys] = 1 if blkv.any() else 0
                cab.bin(CSBF + min(1, int(r) + int(b)) + (2 if c else 0), csbf[xs, ys])
                infer_dc = True
            else:
                csbf[xs, ys] = 1
            prev = (int(csbf[xs + 1, ys]) if xs + 1 < nsb else 0) | \
                ((int(csbf[xs, ys + 1]) if ys + 1 < nsb else 0) << 1)
            pos = []
            start = 15
            if i == last_sb:
                pos.append(last_pos)
                start = last_pos - 1
            if csbf[xs, ys]:
                for k in range(start, -1, -1):
                    xp, yp = cscan[k]
                    xc, yc = (xs << 2) + xp, (ys << 2) + yp
                    sig = int(levels[yc, xc] != 0)
                    if k == 0 and infer_dc:
                        assert sig
                        pos.append(0)
                        break
                    if lg == 2:
                        sc = CTX_MAP4[(yc << 2) + xc]
                    elif xc + yc == 0:
                        sc = 0
                    else:
                        if prev == 0:
                            sc = 2 if xp + yp == 0 else 1 if xp + yp < 3 else 0
                        elif prev == 1:
                            sc = 2 if yp == 0 else 1 if yp == 1 else 0
                        elif prev == 2:
                            sc = 2 if xp == 0 else 1 if xp == 1 else 0
                        else:
                            sc = 2
                        if c == 0:
                            if xs + ys > 0:
                                sc += 3
                            sc += (9 if scan == 0 else 15) if lg == 3 else 21
                        else:
                            sc += 9 if lg == 3 else 12
                    cab.bin(SIG + (27 + sc if c else sc), sig)
                    if sig:
                        pos.append(k)
                        infer_dc = False
            if not pos:
                continue
            vals = [int(levels[(ys << 2) + cscan[k][1], (xs << 2) + cscan[k][0]]) for k in pos]
            absv = [abs(v) for v in vals]
            ctx_set = 2 if (i > 0 and c == 0) else 0
            if i != last_sb and g1ctx == 0:
                ctx_set += 1
            g1ctx = 1
            first_g1 = -1
            for m in range(min(len(pos), 8)):
                g = int(absv[m] > 1)
                cab.bin(GT1 + ctx_set * 4 + g1ctx + (16 if c else 0), g)
                if g:
                    g1ctx = 0
                    if first_g1 < 0:
                        first_g1 = m
                elif 0 < g1ctx < 3:
                    g1ctx += 1
            if first_g1 >= 0:
                cab.bin(GT2 + ctx_set + (4 if c else 0), int(absv[first_g1] > 2))
            hidden = hide_ok and pos[0] - pos[-1] > 3
            for m in range(len(pos) - (1 if hidden else 0)):
                cab.bypass(1 if vals[m] < 0 else 0)
            rice = 0
            for m in range(len(pos)):
                if m < 8:
                    base = 1 + int(absv[m] > 1) + (int(absv[m] > 2) if m == first_g1 else 0)
                    thr = 3 if m == first_g1 else 2
                else:
                    base, thr = 1, 1
                if base == thr:
                    rem = absv[m] - base
                    self.remaining(rem, rice)
                    if absv[m] > 3 * (1 << rice):
                        rice = min(rice + 1, 4)
        self.ch.residual_done(x0, y0, lg, c, levels, ts)

    def remaining(self, rem, rice):
        cab = self.cab
        if rem < (3 << rice):
            for _ in range(rem >> rice):
                cab.bypass(1)
            cab.bypass(0)
            cab.bits(rem & ((1 << rice) - 1), rice)
            return
        pm3 = 0
        while rem >= (((1 << (pm3 + 1)) + 2) << rice):
            pm3 += 1
        for _ in range(pm3 + 3):
            cab.bypass(1)
        cab.bypass(0)
        cab.bits(rem - (((1 << pm3) + 2) << rice), pm3 + rice)


# --- pictures, slice headers and the DPB ----------------------------------------------------

@dataclasses.dataclass
class PicPlan:
    """One picture: its NAL unit type, POC, slice type and segments, its
    reference picture set and the lists its slices build."""
    nal_type: int
    poc: int
    type: int                  # 0 B, 1 P, 2 I
    segments: list
    rps: list = dataclasses.field(default_factory=list)   # [(delta, used)] short-term
    rps_sps: int = None        # the SPS set used (index), else coded in the header
    rps_pred: tuple = None     # (delta_idx, delta_rps, flags) against SPS set -delta_idx
    lt: list = dataclasses.field(default_factory=list)    # [(poc, used, msb, sps index)]
    num_ref: tuple = (0, 0)
    mods: tuple = (None, None)
    tmvp: bool = False
    col_from_l0: bool = True
    col_ref: int = 0
    mvd_l1_zero: bool = False
    weights: dict = None
    pic_output: bool = True
    tid: int = 0               # TemporalId
    extra_nals: list = dataclasses.field(default_factory=list)   # (position, bytes)
    ds_state: tuple = None
    header_ext: bytes = b""

    def total_curr(self):
        return sum(u for _, u in self.rps) + sum(u for _, u, _, _ in self.lt)


class StreamWriter:
    """Pictures of one stream in decode order, coded by a chooser."""

    def __init__(self, p: Params, chooser):
        self.p, self.ch = p, chooser
        self.lay = Layout(p)
        self.vps, self.sps, self.pps = write_vps(p), write_sps(p), write_pps(p)
        self.pictures, self.sync, self.info = [], [], []

    def header(self, plan: PicPlan, seg: Segment, first: bool, offsets):
        p, lay = self.p, self.lay
        bw = BitWriter()
        bw.u(1, first)
        irap = 16 <= plan.nal_type <= 23
        if irap:
            bw.u(1, 0)
        bw.ue(0)
        if not first:
            if p.dependent_slices:
                bw.u(1, seg.dependent)
            bw.u(max(1, (lay.nctb - 1).bit_length()) if lay.nctb > 1 else 0,
                 lay.ts2rs[seg.start])
        if not seg.dependent:
            for k in range(p.extra_bits):
                bw.u(1, (plan.poc + k) & 1)
            bw.ue(plan.type)
            if p.output_flag_present:
                bw.u(1, plan.pic_output)
            if plan.nal_type not in (19, 20):
                bw.u(p.log2_max_poc_lsb, plan.poc & ((1 << p.log2_max_poc_lsb) - 1))
                sets = p.st_sets or []
                bw.u(1, plan.rps_sps is not None)
                if plan.rps_sps is None:
                    if plan.rps_pred:
                        _write_st_rps(bw, None, len(sets), sets, True, plan.rps_pred)
                    else:
                        _write_st_rps(bw, plan.rps, len(sets), sets, True)
                elif len(sets) > 1:
                    bw.u((len(sets) - 1).bit_length(), plan.rps_sps)
                if p.long_term:
                    nsps = len(p.lt_sps or [])
                    n_from_sps = sum(1 for e in plan.lt if e[3] is not None)
                    if nsps:
                        bw.ue(n_from_sps)
                    bw.ue(len(plan.lt) - n_from_sps)
                    prev_msb = 0
                    for i, (poc, used, msb, sidx) in enumerate(plan.lt):
                        if sidx is not None:
                            if nsps > 1:
                                bw.u((nsps - 1).bit_length(), sidx)
                        else:
                            bw.u(p.log2_max_poc_lsb, poc & ((1 << p.log2_max_poc_lsb) - 1))
                            bw.u(1, used)
                        bw.u(1, msb)
                        if msb:
                            cyc = ((plan.poc - (plan.poc & ((1 << p.log2_max_poc_lsb) - 1))) -
                                   (poc - (poc & ((1 << p.log2_max_poc_lsb) - 1)))) >> p.log2_max_poc_lsb
                            if i and i != n_from_sps:
                                bw.ue(cyc - prev_msb)
                            else:
                                bw.ue(cyc)
                            prev_msb = cyc
                if p.tmvp:
                    bw.u(1, plan.tmvp)
            if p.sao:
                bw.u(1, seg.sao[0])
                bw.u(1, seg.sao[1])
            if plan.type != 2:
                default = (p.num_ref_default[0], p.num_ref_default[1] if plan.type == 0 else 0)
                over = tuple(plan.num_ref) != default
                bw.u(1, over)
                if over:
                    bw.ue(plan.num_ref[0] - 1)
                    if plan.type == 0:
                        bw.ue(plan.num_ref[1] - 1)
                total = plan.total_curr()
                if p.lists_mod and total > 1:
                    for li in range(2 if plan.type == 0 else 1):
                        m = plan.mods[li]
                        bw.u(1, m is not None)
                        if m is not None:
                            for e in m:
                                bw.u((total - 1).bit_length(), e)
                if plan.type == 0:
                    bw.u(1, plan.mvd_l1_zero)
                if p.cabac_init_present:
                    bw.u(1, seg.cabac_init)
                if plan.tmvp:
                    if plan.type == 0:
                        bw.u(1, plan.col_from_l0)
                    if plan.num_ref[0 if plan.col_from_l0 else 1] > 1:
                        bw.ue(plan.col_ref)
                if (p.weighted_pred and plan.type == 1) or (p.weighted_bipred and plan.type == 0):
                    w = plan.weights
                    bw.ue(w["luma_wd"])
                    bw.se(w["chroma_wd"] - w["luma_wd"])
                    for li in range(2 if plan.type == 0 else 1):
                        ent = w["lists"][li]
                        for e in ent:
                            bw.u(1, e["luma"] is not None)
                        for e in ent:
                            bw.u(1, e["chroma"] is not None)
                        for e in ent:
                            if e["luma"] is not None:
                                bw.se(e["luma"][0] - (1 << w["luma_wd"]))
                                bw.se(e["luma"][1])
                            if e["chroma"] is not None:
                                for wt, dof in e["chroma"]:
                                    bw.se(wt - (1 << w["chroma_wd"]))
                                    bw.se(dof)
                bw.ue(5 - seg.max_merge)
            bw.se(seg.qp_delta)
            if p.slice_chroma_offsets:
                bw.se(seg.cb_cr[0])
                bw.se(seg.cb_cr[1])
            dis = p.deblock[1] if p.deblock else False
            if p.deblock and p.deblock[0]:
                bw.u(1, seg.deblock is not None)
                if seg.deblock is not None:
                    bw.u(1, seg.deblock[0])
                    dis = seg.deblock[0]
                    if not seg.deblock[0]:
                        bw.se(seg.deblock[1])
                        bw.se(seg.deblock[2])
            if p.lf_across_slices and (seg.sao[0] or seg.sao[1] or not dis):
                bw.u(1, seg.lf_across if seg.lf_across is not None else 1)
        if p.tiles or p.wpp:
            bw.ue(len(offsets))
            if offsets:
                ln = max(max(offsets) - 1, 1).bit_length()
                bw.ue(ln - 1)
                for o in offsets:
                    bw.u(ln, o - 1)
        if p.slice_ext:
            bw.ue(len(plan.header_ext))
            for b in plan.header_ext:
                bw.u(8, b)
        bw.u(1, 1)
        bw.align(0)
        return bw.bytes()

    def slice_fields(self, plan: PicPlan, seg: Segment, indep: Segment):
        """What the CTU coder needs of a segment's slice."""
        p = self.p
        ci = indep.cabac_init and p.cabac_init_present
        init = 0 if plan.type == 2 else (2 if ci else 1) if plan.type == 1 else (1 if ci else 2)
        return {"type": plan.type, "qp": p.init_qp + indep.qp_delta, "init_type": init,
                "sao": indep.sao, "num_ref": plan.num_ref, "max_merge": indep.max_merge,
                "mvd_l1_zero": plan.mvd_l1_zero, "slice_addr": self.lay.ts2rs[indep.start],
                "cb_cr": indep.cb_cr if p.slice_chroma_offsets else (0, 0)}

    def picture(self, plan: PicPlan, sync=None):
        coder = PictureCoder(self.p, self.lay, plan, self.ch)
        self.ch.picture_start(self, plan, coder)
        fields = {}
        indep = None
        nals = []
        for k, seg in enumerate(plan.segments):
            if not seg.dependent:
                indep = seg
            fields[id(seg)] = self.slice_fields(plan, seg, indep)
            plan.slice_of = lambda s, f=fields: f[id(s)]
            first = k == 0
            data = coder.segment(seg, lambda offs, s=seg, f=first: self.header(plan, s, f, offs))
            nals.append(nal_unit(plan.nal_type, data, tid=plan.tid))
        # extra NAL units: position 0 before the picture's slices, -1 after
        nals = ([u for pos, u in plan.extra_nals if pos == 0] + nals +
                [u for pos, u in plan.extra_nals if pos < 0])
        self.ch.picture_end(self, plan, coder)
        self.pictures.append(nals)
        self.info.append({"nal": plan.nal_type, "poc": plan.poc, "type": plan.type,
                          "tmvp": plan.tmvp, "col_from_l0": plan.col_from_l0,
                          "output": plan.pic_output, "num_ref": tuple(plan.num_ref),
                          "rps": list(plan.rps), "mods": plan.mods,
                          "mvd_l1_zero": plan.mvd_l1_zero, "weights": plan.weights is not None})
        self.sync.append(16 <= plan.nal_type <= 23 if sync is None else sync)

    def clip(self):
        return Clip(self.p.width, self.p.height, self.vps, self.sps, self.pps,
                    self.pictures, self.sync, info=self.info)


@dataclasses.dataclass
class Clip:
    """An HEVC stream: its parameter sets and, per picture, its NAL units;
    ``sync`` marks the sync samples (IRAP pictures), ``display`` each
    picture's place in presentation order (None: decode order) and
    ``info`` what each picture's slices say (NAL unit type, POC, slice
    type, TMVP and its collocated list, pic_output_flag, list sizes, RPS,
    list modification, mvd_l1_zero_flag, explicit weights)."""
    width: int
    height: int
    vps: bytes
    sps: bytes
    pps: bytes
    pictures: list
    sync: list
    display: list = None
    info: list = None

    def shown(self):
        """Each sample's place in presentation order."""
        return list(range(len(self.pictures))) if self.display is None else list(self.display)

    def param_sets(self):
        return [self.vps, self.sps, self.pps]

    def samples(self, length_size=4, inband=False):
        """Length-prefixed samples; ``inband`` (hev1) leads each sync sample
        with the parameter sets."""
        out = []
        for nals, key in zip(self.pictures, self.sync):
            units = (self.param_sets() if inband and key else []) + list(nals)
            out.append(b"".join(len(u).to_bytes(length_size, "big") + u for u in units))
        return out

    def annexb_samples(self):
        out = []
        for nals, key in zip(self.pictures, self.sync):
            units = (self.param_sets() if key else []) + list(nals)
            out.append(b"".join(b"\x00\x00\x00\x01" + u for u in units))
        return out

    def hvcc(self, length_size=4, arrays=True):
        """The HEVCDecoderConfigurationRecord (ISO/IEC 14496-15 8.3.3.1)."""
        out = bytes([1, 1]) + struct.pack(">I", 0x60000000) + bytes([0x90, 0, 0, 0, 0, 0])
        out += bytes([93, 0xF0, 0x00, 0xFC, 0xFD, 0xF8, 0xF8, 0, 0])
        out += bytes([(1 << 3) | (1 << 2) | (length_size - 1)])
        sets = [(32, self.vps), (33, self.sps), (34, self.pps)] if arrays else []
        out += bytes([len(sets)])
        for typ, u in sets:
            out += bytes([0x80 | typ]) + struct.pack(">H", 1) + struct.pack(">H", len(u)) + u
        return out


def write_mp4(path, clip: Clip, entry=b"hvc1", length_size=4, fps=30, **kw):
    """MP4 / MOV with one hvc1 (parameter sets in hvcC only) or hev1
    (also in band at each sync sample) track; a clip out of presentation
    order gets ``ctts`` (``kw``: ``elst``, ``ctts_version``, as the
    H.264 writer's ``write_mp4``)."""
    W264.write_mp4(path, clip, fps=fps, entry=entry, **kw,
                   samples=clip.samples(length_size, inband=entry == b"hev1"),
                   config=W264._box(b"hvcC", clip.hvcc(length_size)))


def write_mkv(path, clip: Clip, fps=30):
    W264.write_mkv(path, clip, fps=fps, samples=clip.samples(), codec=b"V_MPEGH/ISO/HEVC",
                   private=clip.hvcc())


def write_avi(path, clip: Clip, fps=30, fourcc=b"HEVC"):
    W264.write_avi(path, clip, fps=fps, fourcc=fourcc, samples=clip.annexb_samples())


MUX = {"mp4": write_mp4, "mkv": write_mkv, "avi": write_avi,
       "mov": write_mp4}


# --- random legal syntax ----------------------------------------------------------------------

class RandomChooser:
    """Random decisions for every syntax element, legal for where they
    are; ``prob`` biases the tools of a group."""

    def __init__(self, rng, p: Params, **prob):
        self.rng, self.p = rng, p
        self.prob = {"split": 0.5, "skip": 0.25, "intra": 0.15, "nxn": 0.4, "pcm": 0.3,
                     "bypass": 0.3, "merge": 0.5, "tu_split": 0.4, "cbf": 0.55, "ts": 0.5,
                     "big": 0.08, "sao_merge": 0.2, **prob}

    def r(self, key):
        return self.rng.random() < self.prob[key]

    def picture_start(self, sw, plan, coder):
        pass

    def picture_end(self, sw, plan, coder):
        pass

    def sao(self, rx, ry):
        rng = self.rng
        if rng.random() < self.prob["sao_merge"]:
            return "left" if rng.random() < 0.5 else "up"
        par = {"type": [int(rng.integers(0, 3)), int(rng.integers(0, 3)), 0],
               "off": [], "band": [int(rng.integers(0, 32)) for _ in range(3)],
               "eo": [int(rng.integers(0, 4)), int(rng.integers(0, 4)), 0]}
        par["type"][2] = par["type"][1]
        for c in range(3):
            t = par["type"][c]
            a = [int(v) for v in rng.integers(0, 8, 4)]
            if t == 1:
                par["off"].append([v * (1 if rng.random() < 0.5 else -1) for v in a])
            else:
                par["off"].append([a[0], a[1], -a[2], -a[3]])
        return par

    def split(self, x0, y0, lg, depth):
        return self.r("split")

    def new_qg(self):
        pass

    def cu(self, x0, y0, lg, sh, coder):
        p, rng = self.p, self.rng
        cu = {"bypass": p.bypass and self.r("bypass"), "skip": False, "intra": True,
              "part": 0, "pus": [], "root": True}
        if sh["type"] != 2:
            cu["skip"] = self.r("skip")
            cu["intra"] = not cu["skip"] and self.r("intra")
        n = 1 << lg
        if cu["intra"]:
            if lg == p.min_cb_log2 and self.r("nxn"):
                cu["part"] = 3
            if cu["part"] == 0 and p.pcm and p.pcm[2] <= lg <= p.pcm[3] and self.r("pcm"):
                cu["pcm"] = True
                bdy, bdc = p.pcm[0], p.pcm[1]
                cu["pcm_samples"] = (rng.integers(0, 1 << bdy, (n, n)),
                                     rng.integers(0, 1 << bdc, (n // 2, n // 2)),
                                     rng.integers(0, 1 << bdc, (n // 2, n // 2)))
            nb = 4 if cu["part"] == 3 else 1
            cu["modes"] = [int(rng.integers(0, 35)) for _ in range(nb)]
            cu["chroma"] = int(rng.integers(0, 5))
            return cu
        if cu["skip"]:
            cu["pus"] = [{"merge": int(rng.integers(0, sh["max_merge"]))}]
            return cu
        parts = [0, 1, 2]
        if lg == p.min_cb_log2 and lg > 3:
            parts.append(3)
        if lg > p.min_cb_log2 and p.amp:
            parts += [4, 5, 6, 7]
        cu["part"] = part = int(rng.choice(parts))
        npu = {0: 1, 3: 4}.get(part, 2)
        small = lg == 3 and part in (1, 2)
        for _ in range(npu):
            if self.r("merge"):
                cu["pus"].append({"merge": int(rng.integers(0, sh["max_merge"]))})
                continue
            if sh["type"] == 1:
                d = 1
            else:
                d = int(rng.choice([1, 2] if small else [1, 2, 3]))
            pu = {"dir": d, "ref": [0, 0], "mvd": [(0, 0), (0, 0)], "mvp": [0, 0]}
            for li in range(2):
                if (d >> li) & 1:
                    pu["ref"][li] = int(rng.integers(0, sh["num_ref"][li]))
                    big = rng.random() < 0.1
                    lim = 200 if big else 12
                    pu["mvd"][li] = (int(rng.integers(-lim, lim + 1)), int(rng.integers(-lim, lim + 1)))
                    pu["mvp"][li] = int(rng.integers(0, 2))
            cu["pus"].append(pu)
        cu["root"] = rng.random() < 0.7
        return cu

    def cu_start(self, coder, cu):
        pass

    def cu_end(self, coder, cu):
        pass

    def pu_done(self, coder, x, y, w, h, k, pu):
        pass

    def tu_split(self, x0, y0, lg, depth):
        return self.r("tu_split")

    def cbf_chroma(self, x0, y0, lg, depth):
        return int(self.r("cbf")), int(self.r("cbf"))

    def cbf_luma(self, x0, y0, lg, depth):
        return int(self.r("cbf"))

    def intra(self, x0, y0, lg, c, mode):
        pass

    def qp_delta(self):
        rng = self.rng
        if rng.random() < 0.1:
            return int(rng.choice([-26, 25, -12, 12]))
        return int(rng.integers(-4, 5))

    def levels(self, x0, y0, lg, c, mode, ts_ok):
        rng = self.rng
        n = 1 << lg
        lv = np.zeros((n, n), np.int64)
        k = int(rng.integers(1, min(n * n, 14) + 1))
        span = n if rng.random() < 0.3 else max(2, n // 2)
        for _ in range(k):
            x, y = int(rng.integers(0, span)), int(rng.integers(0, span))
            mag = int(rng.integers(1, 4))
            if self.r("big"):
                mag = int(rng.integers(4, 300))
            lv[y, x] = mag * (1 if rng.random() < 0.5 else -1)
        if not lv.any():
            lv[0, 0] = 1
        return lv, bool(ts_ok and self.r("ts"))

    def residual_done(self, x0, y0, lg, c, levels, ts):
        pass


def _segments(rng, p: Params, lay: Layout, cuts=3, dependent=0.5, filters=False):
    """Random slice segments over the picture, legal for its tiles (each
    segment inside one tile) and WPP (a slice or segment that starts
    inside a CTB row ends in it); ``filters``: no slice turns deblocking
    off, and every slice runs SAO on luma and chroma where the SPS has it."""
    n = lay.nctb
    starts = {0}
    tile_starts = [ts for ts in range(1, n) if lay.tile[ts] != lay.tile[ts - 1]]
    starts.update(tile_starts)
    for _ in range(int(rng.integers(0, cuts + 1))):
        starts.add(int(rng.integers(1, n)) if n > 1 else 0)
    # a segment may hold several whole tiles (its entry points then part
    # them): drop some boundaries between tiles cut nowhere else
    bounds = [0] + tile_starts + [n]
    whole = [not any(bounds[k] < s < bounds[k + 1] for s in starts)
             for k in range(len(bounds) - 1)]
    for k, ts in enumerate(tile_starts):
        if whole[k] and whole[k + 1] and rng.random() < 0.5:
            starts.discard(ts)
    if p.wpp:
        for s in sorted(starts):
            rs = lay.ts2rs[s]
            if rs % lay.ncol:  # starts mid-row: ends in the row
                row_end = (rs // lay.ncol + 1) * lay.ncol
                if row_end < n:
                    starts.add(row_end)
    starts = sorted(starts)
    segs = []
    slice_mid_row = None
    # one deblocking override for the picture's slices (the port refuses
    # slices that differ in it)
    deblock = None
    if p.deblock and p.deblock[0] and rng.random() < 0.5:
        deblock = (bool(rng.random() < 0.3), int(rng.integers(-6, 7)), int(rng.integers(-6, 7)))
        if filters:
            deblock = (False,) + deblock[1:]
    for k, s in enumerate(starts):
        end = starts[k + 1] if k + 1 < len(starts) else n
        rs = lay.ts2rs[s]
        tile_start = s == 0 or lay.tile[s] != lay.tile[s - 1]
        dep = k > 0 and p.dependent_slices and not tile_start and rng.random() < dependent
        if p.wpp and dep and slice_mid_row is not None and rs // lay.ncol != slice_mid_row:
            dep = False
        seg = Segment(s, end - s, dependent=dep)
        if not dep:
            slice_mid_row = rs // lay.ncol if rs % lay.ncol else None
            seg.qp_delta = int(rng.integers(-4, 5))
            seg.sao = (bool(rng.random() < 0.7), bool(rng.random() < 0.7)) if p.sao else (False, False)
            if filters:
                seg.sao = (p.sao, p.sao)
            seg.deblock = deblock
            seg.lf_across = bool(rng.random() < 0.5)
            if p.slice_chroma_offsets:
                seg.cb_cr = (int(rng.integers(-6, 7)), int(rng.integers(-6, 7)))
            seg.cabac_init = bool(rng.random() < 0.5)
            seg.max_merge = int(rng.integers(1, 6))
        segs.append(seg)
    return segs


GROUPS = ("intra", "inter", "ldb", "weights", "tiles", "wpp", "ltr", "pcm", "sao", "layers")


def _group_params(rng, group):
    """A group's parameter sets: its tools on, the rest at random."""
    ctb = int(rng.choice([4, 5, 6]))
    sizes = {4: [(80, 48), (48, 80), (64, 48), (112, 48)], 5: [(96, 64), (80, 96), (96, 96)],
             6: [(144, 80), (80, 144)]}[ctb]
    if group in ("tiles", "wpp"):  # enough CTBs for tiles and rows of several
        sizes = {4: [(112, 64), (96, 80), (144, 48)], 5: [(160, 96), (224, 64)],
                 6: [(320, 128), (192, 192)]}[ctb]
    w, h = sizes[int(rng.integers(0, len(sizes)))]
    p = Params(width=w, height=h, ctb_log2=ctb, seed=int(rng.integers(0, 1 << 20)))
    p.min_cb_log2 = int(rng.integers(3, min(ctb, 5) + 1)) if ctb > 4 else 3
    while w % (1 << p.min_cb_log2) or h % (1 << p.min_cb_log2):
        p.min_cb_log2 -= 1
    p.max_tb_log2 = int(rng.integers(p.min_tb_log2 + 1, min(ctb, 5) + 1))
    p.max_th_inter = int(rng.integers(0, 3))
    p.max_th_intra = int(rng.integers(0, 3))
    p.init_qp = int(rng.integers(22, 40))
    p.sign_hiding = bool(rng.random() < 0.5)
    p.cabac_init_present = bool(rng.random() < 0.5)
    p.amp = bool(rng.random() < 0.5)
    p.tmvp = bool(rng.random() < 0.5)
    p.strong_intra = bool(rng.random() < 0.5)
    p.transform_skip = bool(rng.random() < 0.4)
    p.cu_qp_delta = int(rng.integers(0, ctb - p.min_cb_log2 + 1)) if rng.random() < 0.5 else None
    p.cb_qp_offset, p.cr_qp_offset = int(rng.integers(-6, 7)), int(rng.integers(-6, 7))
    p.slice_chroma_offsets = bool(rng.random() < 0.4)
    p.deblock = (bool(rng.random() < 0.6), bool(rng.random() < 0.2), int(rng.integers(-6, 7)),
                 int(rng.integers(-6, 7))) if rng.random() < 0.6 else None
    p.lf_across_slices = bool(rng.random() < 0.5)
    p.sao = bool(rng.random() < 0.5)
    p.scaling = str(rng.choice(["off", "off", "default", "sps", "pps"]))
    p.dependent_slices = bool(rng.random() < 0.5)
    p.par_mrg_log2 = int(rng.integers(2, 5))
    p.num_ref_default = (int(rng.integers(1, 3)), int(rng.integers(1, 3)))
    if group == "intra":
        p.strong_intra = bool(rng.random() < 0.8)
        p.constrained_intra = bool(rng.random() < 0.5)
    elif group == "inter":
        p.constrained_intra = bool(rng.random() < 0.3)
    elif group == "tiles":
        cols = min(3, p.ctb_w)
        rows = min(2, p.ctb_h)
        if rng.random() < 0.5:
            p.tiles = (cols, rows)
        else:
            p.tiles = ([1] * (cols - 1), [1] * (rows - 1))
        p.lf_across_tiles = bool(rng.random() < 0.5)
        p.dependent_slices = True
    elif group == "wpp":
        p.wpp = True
        p.dependent_slices = True
    elif group == "ltr":
        p.long_term = True
        p.log2_max_poc_lsb = 4
        p.lists_mod = True
        p.extra_bits = int(rng.integers(0, 3))
        p.output_flag_present = True
        p.slice_ext = True
        p.st_sets = [[(-1, 1)], [(-1, 1), (-2, 1)], [(-2, 1), (-1, 0)]]
        p.lt_sps = [(2, 1), (3, 0)]
    elif group == "pcm":
        p.ctb_log2, p.min_cb_log2 = 4, 3
        p.max_tb_log2 = min(p.max_tb_log2, 4)
        p.cu_qp_delta = None if p.cu_qp_delta is None else min(p.cu_qp_delta, 1)
        p.pcm = (int(rng.integers(5, 9)), int(rng.integers(5, 9)), 3, 4, bool(rng.random() < 0.5))
        p.bypass = True
    elif group == "sao":
        p.sao = True
        p.deblock = (True, False, int(rng.integers(-6, 7)), int(rng.integers(-6, 7)))
    elif group in ("weights", "ldb"):
        p.weighted_pred = group == "weights"
        p.weighted_bipred = group == "weights"
        p.tmvp = True
    if p.ctb_log2 != ctb:
        p.width, p.height = 80, 48
    return p


# --- GOP structures as encoders write them ----------------------------------------------------

# x265's defaults (--bframes 4 --b-pyramid --open-gop: mini-GOPs of five
# pictures, the middle B picture a reference, a CRA picture whose mini-GOP
# before it in presentation order follows it as RASL pictures); HM's
# random-access configuration (hierarchical GOPs of 8, a CRA picture every
# 16-32 pictures with RASL pictures); leading pictures that reference no
# picture before their IRAP picture (RADL after IDR_W_RADL and CRA
# pictures); the three BLA types (BLA_W_LP first with RADL pictures, later
# with RASL pictures, which a decoder skips); and HM's stream cut at its
# first CRA picture (whose RASL pictures reference pictures the file lacks)
GOPS = ("x265", "hm", "radl", "bla", "cra_first")


@dataclasses.dataclass
class GopPic:
    """A picture of a GOP structure, in decode order: its NAL unit type, its
    place in presentation order, the places of the pictures it predicts
    from (those it may not reference are dropped), whether it stays a
    reference picture; its POC and RPS are derived (``_gop_rps``)."""
    nal: int
    display: int
    used: list
    ref: bool = True
    output: bool = True
    eos: bool = False      # an end of sequence NAL unit follows it
    tid: int = 0           # its depth in the hierarchy (TemporalId where asked)
    poc: int = 0           # from the last IDR picture
    rps: list = None       # [(delta, used)]


def _hier(lo, hi, levels, kind, lo_ok=True, extra=(), depth=1):
    """The pictures strictly between lo and hi, which are decoded before
    them: the middle one first (a reference picture while ``levels`` > 1
    and pictures lie on both its sides), then each half, one level deeper;
    all of them where ``levels`` is 1. ``kind`` trail / rasl / radl names
    their NAL unit types; ``lo_ok`` False: lo may not be referenced."""
    if hi - lo < 2:
        return []
    types = {"trail": (0, 1), "rasl": (8, 9), "radl": (6, 7)}[kind]
    refs = ([lo] if lo_ok else []) + [hi] + list(extra)
    if levels <= 1:
        return [GopPic(types[0], d, refs, False, tid=depth) for d in range(lo + 1, hi)]
    mid = (lo + hi) // 2
    ref = hi - lo > 2
    return ([GopPic(types[ref], mid, refs, ref, tid=depth)] +
            _hier(lo, mid, levels - 1, kind, lo_ok, extra, depth + 1) +
            _hier(mid, hi, levels - 1, kind, True, extra, depth + 1))


def gop_pictures(kind, frames, rng):
    """The pictures of a ``frames``-picture stream of GOP structure
    ``kind`` (GOPS) in decode order, with their POCs and RPSs: an IDR
    picture, then per anchor (every GOP-size pictures, and the last
    picture) the anchor and the pictures before it, hierarchically. An
    anchor may be an IRAP picture whose pictures before it are RASL
    (open: they follow it), RADL (they follow it and reference none
    before it) or none (closed: they precede it, under an anchor of their
    own)."""
    g, levels = {"x265": (5, 2), "hm": (8, 3), "cra_first": (8, 3)}.get(kind, (4, 2))
    n = frames + (9 if kind == "cra_first" else 0)
    anchors = list(range(0, n, g))
    if anchors[-1] != n - 1:
        anchors.append(n - 1)
    iraps = {}  # anchor index: (NAL unit type, leading)
    if kind == "x265":
        iraps[int(rng.integers(2, max(3, len(anchors) - 1)))] = (21, "rasl")
    elif kind in ("hm", "cra_first"):
        k = 2 if kind == "cra_first" else int(rng.integers(2, 5))
        while k < len(anchors) - 1:
            iraps[k] = (21, "rasl")
            k += int(rng.integers(2, 5))
    elif kind == "radl":
        order = [(19, "radl"), (21, "radl"), (20, "none")]
        for j, k in enumerate(range(2, len(anchors) - 1, 2)):
            iraps[k] = order[(j + int(rng.integers(0, 3))) % 3]
    elif kind == "bla":
        order = [(16, "radl"), (17, "radl"), (18, "none"), (21, "rasl"), (16, "rasl")]
        for j, k in enumerate(range(2, len(anchors) - 1, 2)):
            iraps[k] = order[j % 5]
    pics = [GopPic(int(rng.choice([19, 20])), 0, [])]
    for k in range(1, len(anchors)):
        p, a = anchors[k - 1], anchors[k]
        far = [p - g] if p >= g and rng.random() < 0.6 else []
        if k in iraps:
            nal, lead = iraps[k]
            if lead == "none":
                pics.append(GopPic(1, a - 1, [p] + far))
                pics += _hier(p, a - 1, levels, "trail")
                pics.append(GopPic(nal, a, []))
            else:
                pics.append(GopPic(nal, a, []))
                pics += _hier(p, a, levels, lead, lo_ok=lead == "rasl",
                              extra=[q for q in far if lead == "rasl"])
        else:
            pics.append(GopPic(1, a, [p] + far))
            pics += _hier(p, a, levels, "trail", extra=[q for q in far if rng.random() < 0.5])
    _gop_rps(pics)
    if kind == "cra_first":  # the file starts at the first CRA picture
        start = next(j for j, q in enumerate(pics) if q.nal == 21)
        pics = pics[start:]
        first = min(q.display for q in pics)
        for q in pics:
            q.display -= first
            q.used = [r - first for r in q.used]
    return pics


def _gop_rps(pics):
    """Fills each picture's POC (its place from the last IDR picture), drops
    the references it may not use (an IRAP picture uses none; a RADL
    picture only its IRAP picture and that one's RADL pictures; a trailing
    picture none before its IRAP picture nor any leading picture), and its
    RPS: every reference picture decoded before it that it or a later
    picture uses."""
    idr = 0
    irap_at = irap_disp = 0
    seen = {}  # display: (decode index, NAL unit type)
    for j, q in enumerate(pics):
        if q.nal in (19, 20):
            idr = q.display
            seen = {}
        if 16 <= q.nal <= 21:
            irap_at, irap_disp = j, q.display
        q.poc = q.display - idr

        def ok(r):
            if r not in seen or 16 <= q.nal <= 21:
                return False
            at, nal = seen[r]
            if q.nal in (8, 9):
                return True
            if q.nal in (6, 7):
                return at >= irap_at and nal not in (8, 9)
            return at >= irap_at and r >= irap_disp and not 6 <= nal <= 9
        q.used = list(dict.fromkeys(r for r in q.used if ok(r)))
        if not 16 <= q.nal <= 21 and not q.used:
            raise ValueError(f"picture {q.display} references nothing")
        if q.ref:
            seen[q.display] = (j, q.nal)
    idr_at = 0
    for j, q in enumerate(pics):
        if q.nal in (19, 20):
            idr_at = j
            q.rps = []
            continue
        later = {r for k in range(j, len(pics)) for r in pics[k].used}
        q.rps = sorted_rps([(pics[k].poc - q.poc, int(pics[k].display in q.used))
                            for k in range(idr_at, j)
                            if pics[k].ref and pics[k].display in later])


def dpb_params(pics):
    """sps_max_num_reorder_pics of a structure, and the least
    sps_max_dec_pic_buffering under which FFmpeg's bumping puts its
    pictures out in presentation order when it is decoded from the start."""
    shown = [q for q in pics if q.output]
    reorder = max((sum(1 for r in shown[:j] if r.display > q.display)
                   for j, q in enumerate(shown)), default=0)
    want = sorted(q.display for q in shown)
    for max_dec in range(reorder + 1, 17):
        if _bumped(pics, reorder, max_dec) == want:
            return reorder, max_dec
    raise ValueError("no DPB size puts the structure out in order")


def _bumped(pics, reorder, max_dec):
    """The presentation places in the order FFmpeg's bumping puts them out
    (every picture decoded: no RASL picture is skipped from the start)."""
    dpb, out = [], []  # [poc, display, waiting, reference]

    def bump(max_out, max_n):
        while True:
            waiting = [e for e in dpb if e[2]]
            if not (len(waiting) > max_out or (waiting and len(dpb) > max_n)):
                return
            e = min(waiting, key=lambda e: e[0])
            out.append(e[1])
            e[2] = False
            dpb[:] = [f for f in dpb if f[2] or f[3]]
    for q in pics:
        if q.nal in (16, 17, 18, 19, 20):
            bump(0, 0)
            dpb.clear()
        keep = {q.poc + d for d, _ in q.rps}
        for e in dpb:
            e[3] = e[0] in keep
        dpb[:] = [e for e in dpb if e[2] or e[3]]
        dpb.append([q.poc, q.display, q.output, True])
        bump(reorder, max_dec)
    bump(0, 0)
    return out


def random_stream(seed, group="inter", frames=5, crop=None, prob=None, cuts=3, gop=None,
                  reorder=0, irap=None, filters=False, hidden=0.0, cra_sync=True, eos=False,
                  temporal=False, **over):
    """A stream of random legal syntax of tool group ``group`` (GROUPS):
    an IRAP picture, then P pictures (B pictures for "ldb" and
    "weights"), each of random slice segments over random CTBs; ``over``
    sets parameters after the group's draw. ``gop``: an IRAP picture (CRA
    or IDR, the RPS emptied; ``irap`` names its NAL unit type) every that
    many pictures, a sync sample; ``reorder``: sps_max_num_reorder_pics
    (output delay, no reordering); ``filters``: every slice deblocks and
    runs SAO (see ``_segments``).

    ``gop`` may instead name a structure of GOPS (pictures out of decode
    order, leading pictures, BLA pictures): its non-IRAP pictures are B
    pictures (P pictures one in five; every list may hold pictures on
    either side), sps_max_num_reorder_pics and sps_max_dec_pic_buffering
    are the structure's (``dpb_params``; at least ``reorder``) and the
    clip's ``display`` its presentation order. ``hidden``: the share of
    its non-IRAP pictures sent with pic_output_flag 0 (or a tuple of the
    presentation places of those); ``cra_sync`` False:
    only IDR and BLA pictures are sync samples; ``eos``: an end of sequence
    NAL unit before the first CRA picture; ``temporal``: each picture's
    depth in the hierarchy is its TemporalId (HM's temporal sub-layers:
    the anchors and IRAP pictures 0), the SPS's sub-layers as many."""
    rng = np.random.default_rng(seed)
    p = _group_params(rng, group)
    if crop:
        p.crop = crop
    if isinstance(gop, str):
        p.log2_max_poc_lsb = int(rng.choice([6, 8]))
    for k, v in over.items():
        setattr(p, k, v)
    if isinstance(gop, str):
        return _gop_stream(rng, p, group, gop, frames, prob, cuts, reorder, filters, hidden,
                           cra_sync, eos, temporal)
    if reorder:
        p.num_reorder = reorder
        p.max_dec = max(p.max_dec, reorder + 4)
    sw = StreamWriter(p, RandomChooser(rng, p, **(prob or {})))
    lay = sw.lay
    refs = []       # short-term reference POCs, newest last
    lts = []        # long-term reference POCs
    bframes = group in ("ldb", "weights")
    poc = 0
    for i in range(frames):
        segs = _segments(rng, p, lay, cuts, filters=filters)
        if i == 0 or (gop and i % gop == 0):
            nt = int(rng.choice([19, 20, 21]))
            if i and irap:
                nt = irap
            if i and nt == 21:
                poc += int(rng.integers(1, 3))
            else:
                poc = 0
            plan = PicPlan(nt, poc, 2, segs)
            refs, lts = [poc], []
        else:
            poc += int(rng.integers(1, 3))
            nonref = rng.random() < 0.2 and i < frames - 1
            nt = 0 if nonref else 1
            if group == "intra" and rng.random() < 0.3:
                nt = 1
            typ = 2 if group == "intra" else (0 if bframes and rng.random() < 0.8 else 1)
            # the reference picture set: the newest refs, some long-term
            keep = refs[-int(rng.integers(1, 4)):]
            plan = PicPlan(nt, poc, typ, segs)
            if group == "ltr" and len(keep) > 1 and not lts and rng.random() < 0.6:
                lts.append(keep.pop(0))
            if lts and rng.random() < 0.2:
                lts = []
            st = [(r - poc, 1) for r in keep]
            st = [(d, int(u if rng.random() < 0.8 else 0)) for d, u in st]
            if not any(u for _, u in st) and not lts:
                st[-1] = (st[-1][0], 1)
            plan.rps = sorted_rps(st)
            for lp in lts:
                lsb = lp & ((1 << p.log2_max_poc_lsb) - 1)
                sidx = next((k for k, (l, u) in enumerate(p.lt_sps or []) if l == lsb and u), None)
                amb = any((r & ((1 << p.log2_max_poc_lsb) - 1)) == lsb for r in keep)
                msb = amb or rng.random() < 0.3 or (poc - lp) >= (1 << p.log2_max_poc_lsb) // 2
                plan.lt.append((lp, 1, bool(msb), sidx if not msb and rng.random() < 0.5 else None))
            if p.st_sets and rng.random() < 0.5:
                want = [(d, u) for d, u in plan.rps]
                for k, s in enumerate(p.st_sets):
                    if sorted_rps(s) == want:
                        plan.rps_sps = k
                if plan.rps_sps is None and rng.random() < 0.5:
                    # predicted from the last SPS set, one picture on
                    ref_set = sorted_rps(p.st_sets[-1])
                    drps = -int(rng.integers(1, 3))
                    flags = []
                    for j in range(len(ref_set) + 1):
                        d = (ref_set[j][0] if j < len(ref_set) else 0) + drps
                        ok = (poc + d) in keep
                        flags.append((int(ok and rng.random() < 0.8), int(ok)))
                    derived = derive_rps(ref_set, (1, drps, flags))
                    if derived and (any(u for _, u in derived) or lts):
                        plan.rps_pred = (1, drps, flags)
                        plan.rps = derived
            # the pictures the coded RPS keeps (a predicted one may keep fewer)
            keep = sorted(poc + d for d, _ in plan.rps)
            if typ != 2:
                _random_lists(rng, p, plan)
                typ = plan.type
            if p.slice_ext:
                plan.header_ext = bytes(rng.integers(0, 256, int(rng.integers(0, 3))).tolist())
            if nt == 1 or i == frames - 1:
                refs = keep + [poc]
            else:
                refs = keep
        if group == "layers":
            plan.extra_nals = _layer_nals(rng, plan)
        sw.picture(plan)
    return sw.clip()


def _gop_stream(rng, p, group, kind, frames, prob, cuts, reorder, filters, hidden, cra_sync,
                eos, temporal):
    """random_stream's pictures in a GOP structure of GOPS."""
    pics = gop_pictures(kind, frames, rng)
    if hidden:
        p.output_flag_present = True
        for q in pics:
            q.output = (q.display not in hidden if isinstance(hidden, tuple) else
                        16 <= q.nal <= 21 or rng.random() >= hidden)
    if eos:
        at = next((j for j, q in enumerate(pics) if q.nal == 21 and j), None)
        if at is None:
            raise ValueError("no CRA picture to send an end of sequence before")
        pics[at - 1].eos = True
    nr, md = dpb_params(pics)
    p.num_reorder, p.max_dec = max(nr, reorder), max(md, reorder + 1)
    if temporal:
        p.sub_layers = max(q.tid for q in pics) + 1
    sw = StreamWriter(p, RandomChooser(rng, p, **(prob or {})))
    for q in pics:
        segs = _segments(rng, p, sw.lay, cuts, filters=filters)
        typ = 2 if 16 <= q.nal <= 21 or group == "intra" else \
            (1 if rng.random() < 0.2 else 0)
        plan = PicPlan(q.nal, q.poc, typ, segs, rps=list(q.rps))
        plan.pic_output = q.output
        plan.tid = q.tid if temporal else 0
        if typ != 2:
            _random_lists(rng, p, plan)
        if p.slice_ext:
            plan.header_ext = bytes(rng.integers(0, 256, int(rng.integers(0, 3))).tolist())
        if group == "layers":
            plan.extra_nals = _layer_nals(rng, plan)
        if q.eos:
            plan.extra_nals.append((-1, nal_unit(36, b"")))
        sw.picture(plan, sync=q.nal in (16, 17, 18, 19, 20) or (q.nal == 21 and cra_sync))
    clip = sw.clip()
    clip.display = [q.display for q in pics]
    return clip


def _random_lists(rng, p, plan):
    """A P or B picture's reference lists at random (list sizes to one
    past its references, modification, TMVP's collocated picture,
    mvd_l1_zero_flag, weights); an I picture where it references none."""
    typ, total = plan.type, plan.total_curr()
    if total == 0:
        plan.type = 2
        return
    n0 = int(rng.integers(1, min(4, total + 1) + 1))
    n1 = int(rng.integers(1, min(4, total + 1) + 1)) if typ == 0 else 0
    plan.num_ref = (n0, n1)
    if p.lists_mod and total > 1:
        plan.mods = tuple(
            [int(v) for v in rng.integers(0, total, plan.num_ref[li])]
            if li < (2 if typ == 0 else 1) and rng.random() < 0.6 else None
            for li in range(2))
    plan.tmvp = p.tmvp and rng.random() < 0.8
    plan.col_from_l0 = typ != 0 or rng.random() < 0.5
    plan.col_ref = int(rng.integers(0, plan.num_ref[0 if plan.col_from_l0 else 1]))
    plan.mvd_l1_zero = typ == 0 and rng.random() < 0.3
    if (p.weighted_pred and typ == 1) or (p.weighted_bipred and typ == 0):
        plan.weights = _random_weights(rng, plan)


def _random_weights(rng, plan):
    lwd = int(rng.integers(0, 8))
    cwd = int(rng.integers(max(0, lwd - 2), min(7, lwd + 2) + 1))
    w = {"luma_wd": lwd, "chroma_wd": cwd, "lists": []}
    for li in range(2 if plan.type == 0 else 1):
        ent = []
        for _ in range(plan.num_ref[li]):
            e = {"luma": None, "chroma": None}
            if rng.random() < 0.7:
                e["luma"] = ((1 << lwd) + int(rng.integers(-20, 21)), int(rng.integers(-30, 31)))
            if rng.random() < 0.7:
                e["chroma"] = [((1 << cwd) + int(rng.integers(-20, 21)), int(rng.integers(-60, 61)))
                               for _ in range(2)]
            ent.append(e)
        w["lists"].append(ent)
    return w


def _layer_nals(rng, plan):
    """NAL units a base-layer decoder skips: an access unit delimiter and
    a prefix SEI (user data unregistered) ahead of the slices, units of
    nuh_layer_id 1 (an SEI ahead, a slice after), and a suffix SEI."""
    uuid = bytes(rng.integers(0, 256, 16).tolist())
    sei = bytes([5, 18]) + uuid + b"hi" + b"\x80"
    out = [(0, nal_unit(35, bytes([0x50])))]  # AUD: pic_type 2, then the stop bit
    out.append((0, nal_unit(39, sei)))
    out.append((0, nal_unit(39, sei, layer=1)))
    out.append((-1, nal_unit(1, bytes(rng.integers(1, 256, 8).tolist()), layer=1)))
    out.append((-1, nal_unit(40, sei)))
    return out


# --- a small real encoder ---------------------------------------------------------------------

_LEVEL_SCALE = (40, 45, 51, 57, 64, 72)


def rgb_to_yuv420(rgb):
    """BT.601 limited-range Y, Cb, Cr planes (4:2:0, chroma the mean of each
    2x2) of a uint8 RGB image with even sides."""
    f = np.asarray(rgb, np.float64)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    cb = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    cr = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255
    h, w = y.shape

    def sub(p):
        return p.reshape(h // 2, 2, w // 2, 2).mean((1, 3))
    return [np.clip(np.rint(p), 0, 255).astype(np.uint8) for p in (y, sub(cb), sub(cr))]


class PanEncoder:
    """The decisions of :func:`encode`: one CU a CTB, one TU a CU; intra
    pictures by the best of planar, DC, horizontal and vertical; P and B
    pictures by the known motion of each picture to its references
    (``plan.refs``: the POCs of the list 0 and list 1 pictures it averages,
    ``plan.ref1``: the list 1 index of the second; merge index 0, which is
    that motion, AMVP from zero for the picture's first CU; skipped where
    the residual quantises to nothing). It reconstructs with the port's
    plain numpy versions (``data/video.py``), loop filters off."""

    def __init__(self, p: Params, qp: int):
        from mast3r_slam_tpu_torch.data import video
        self.V, self.p, self.qp = video, p, qp
        self.rec = None
        self.recs = {}  # the reconstructions by POC

    def picture_start(self, sw, plan, coder):
        self.src = plan.source
        self.mv = plan.motion
        self.mv2 = getattr(plan, "motion2", None)  # B: to the list 1 picture
        refs = getattr(plan, "refs", ())
        self.ref = self.recs[refs[0]] if refs else None
        self.ref2 = self.recs[refs[1]] if len(refs) > 1 else None
        self.ref1 = getattr(plan, "ref1", 0)
        self.rec = [np.zeros_like(q) for q in self.src]
        self.first = True

    def picture_end(self, sw, plan, coder):
        self.recs[plan.poc] = self.rec

    def sao(self, rx, ry):
        return None

    def split(self, *a):
        return False

    def new_qg(self):
        pass

    def _qp(self, c):
        if c == 0:
            return self.qp
        q = min(max(self.qp + (self.p.cb_qp_offset if c == 1 else self.p.cr_qp_offset), 0), 57)
        return q if q < 30 else q - 6 if q > 43 else (29, 30, 31, 32, 33, 33, 34, 34, 35, 35,
                                                      36, 36, 37, 37)[q - 30]

    def _intra_pred(self, coder, x0, y0, lg, c, mode):
        """The prediction the decoder makes from this reconstruction."""
        n, s = 1 << lg, 1 if c else 0
        unit = 4 >> s
        pl = self.rec[c]
        ref = np.zeros(4 * n + 1, np.uint8)
        av = np.zeros(4 * n + 1, bool)

        def ok(xn, yn):
            return coder.avail(x0 << s, y0 << s, xn << s, yn << s)
        if ok(x0 - 1, y0 - 1):
            av[0], ref[0] = True, pl[y0 - 1, x0 - 1]
        for k in range(0, 2 * n, unit):
            if ok(x0 - 1, y0 + k):
                av[1 + k:1 + k + unit] = True
                ref[1 + k:1 + k + unit] = pl[y0 + k:y0 + k + unit, x0 - 1]
            if ok(x0 + k, y0 - 1):
                av[1 + 2 * n + k:1 + 2 * n + k + unit] = True
                ref[1 + 2 * n + k:1 + 2 * n + k + unit] = pl[y0 - 1, x0 + k:x0 + k + unit]
        return self.V.hevc_intra_ref(ref, av, lg, c, mode, self.p.strong_intra)

    def _quantise(self, resid, lg, c, intra):
        """Forward transform (the inverse of the standard's, in floats) and
        dead-zone quantisation to levels."""
        n = 1 << lg
        t = (self.V.HEVC_DST if (intra and c == 0 and lg == 2) else
             self.V.HEVC_DCT[::32 // n, :n]).astype(np.float64)
        coef = t @ resid.astype(np.float64) @ t.T / (32.0 * n * n)
        qp = self._qp(c)
        step = 2.0 * _LEVEL_SCALE[qp % 6] * (1 << (qp // 6)) / n
        dz = 1 / 3 if intra else 1 / 6
        return (np.sign(coef) * np.floor(np.abs(coef) / step + dz)).astype(np.int64)

    def _reconstruct(self, levels, lg, c, intra, pred):
        n = 1 << lg
        qp = self._qp(c)
        bd = lg + 3
        d = np.clip((levels * 16 * (_LEVEL_SCALE[qp % 6] << (qp // 6)) + (1 << (bd - 1))) >> bd,
                    -32768, 32767)
        r = self.V.hevc_idct_ref(d, lg, 1 if (intra and c == 0 and lg == 2) else 0)
        return np.clip(pred.astype(np.int64) + r, 0, 255).astype(np.uint8)

    def cu(self, x0, y0, lg, sh, coder):
        n = 1 << lg
        cu = {"bypass": False, "skip": False, "intra": sh["type"] == 2, "part": 0, "pus": [],
              "root": True, "preds": {}, "levels": {}}
        planes = [(x0, y0, lg, 0), (x0 // 2, y0 // 2, lg - 1, 1), (x0 // 2, y0 // 2, lg - 1, 2)]
        if cu["intra"]:
            src = self.src[0][y0:y0 + n, x0:x0 + n].astype(np.int64)
            best = None
            for mode in (0, 1, 10, 26):
                pr = self._intra_pred(coder, x0, y0, lg, 0, mode)
                cost = int(np.abs(src - pr).sum())
                if best is None or cost < best[0]:
                    best = (cost, mode, pr)
            cu["modes"], cu["chroma"] = [best[1]], 4
            cu["preds"][0] = best[2]
            for xx, yy, ll, c in planes:
                if c:
                    cu["preds"][c] = self._intra_pred(coder, xx, yy, ll, c, best[1])
        else:
            mvx, mvy = self.mv
            bi = self.mv2 is not None
            mv4 = (mvx, mvy) + (tuple(self.mv2) if bi else (0, 0))
            for xx, yy, ll, c in planes:
                cu["preds"][c] = self.V.hevc_mc_ref(
                    self.ref[c], self.ref2[c] if bi else None, bool(c), xx, yy, mv4,
                    3 if bi else 1, 1 << ll, 1 << ll)
        for xx, yy, ll, c in planes:
            s = self.src[c][yy:yy + (1 << ll), xx:xx + (1 << ll)].astype(np.int64)
            cu["levels"][c] = self._quantise(s - cu["preds"][c], ll, c, cu["intra"])
        if not cu["intra"]:
            coded = any(cu["levels"][c].any() for c in range(3))
            if self.first and self.mv2 is not None:
                cu["pus"] = [{"dir": 3, "ref": [0, self.ref1], "mvd": [self.mv, self.mv2],
                              "mvp": [0, 0]}]
                cu["root"] = coded
            elif self.first:
                cu["pus"] = [{"dir": 1, "ref": [0, 0], "mvd": [self.mv, (0, 0)], "mvp": [0, 0]}]
                cu["root"] = coded
            elif coded:
                cu["pus"] = [{"merge": 0}]
            else:
                cu["skip"] = True
                cu["pus"] = [{"merge": 0}]
            # depth 0 of an inter CU without chroma infers cbf_luma: code it
            # where it is, else the luma must carry a level
            if coded and not cu["levels"][1].any() and not cu["levels"][2].any() \
                    and not cu["levels"][0].any():
                cu["levels"][0][0, 0] = 1
        self.first = False
        self.cur = cu
        return cu

    def cu_start(self, coder, cu):
        pass

    def cu_end(self, coder, cu):
        pass

    def pu_done(self, coder, x, y, w, h, k, pu):
        for xx, yy, ll, c in ((x, y, 0, 0), (x // 2, y // 2, 0, 1), (x // 2, y // 2, 0, 2)):
            pr = self.cur["preds"][c]
            self.rec[c][yy:yy + pr.shape[0], xx:xx + pr.shape[1]] = pr

    def tu_split(self, *a):
        return False

    def cbf_chroma(self, x0, y0, lg, depth):
        lv = self.cur["levels"]
        return int(lv[1].any()), int(lv[2].any())

    def cbf_luma(self, x0, y0, lg, depth):
        return int(self.cur["levels"][0].any())

    def intra(self, x0, y0, lg, c, mode):
        pr = self.cur["preds"][c]
        self.rec[c][y0:y0 + pr.shape[0], x0:x0 + pr.shape[1]] = pr

    def qp_delta(self):
        return 0

    def levels(self, x0, y0, lg, c, mode, ts_ok):
        return self.cur["levels"][c], False

    def residual_done(self, x0, y0, lg, c, levels, ts):
        pr = self.cur["preds"][c]
        n = pr.shape[0]
        self.rec[c][y0:y0 + n, x0:x0 + n] = self._reconstruct(
            np.asarray(levels, np.int64), lg, c, self.cur["intra"], pr)


def encode(frames, qp=30, crop=(0, 0, 0, 0), motion=None, ctb_log2=4, bframes=False, gop=None,
           cra=None):
    """Encodes uint8 RGB frames (H, W, 3): an IDR picture, then P pictures
    each referencing the one before, predicted with ``motion[i]`` (frame
    i's content at x is frame i-1's at x + motion, in quarter samples; zero
    where not given). With ``bframes`` the pictures from the third on are
    low-delay B pictures, each block the average of the last picture
    (list 0) and the one before it (list 1, index 1, moved by both
    motions). With ``gop`` the pictures are HM's hierarchical GOPs of that
    size out of decode order (``motion(a, b)``: frame a's content at x is
    frame b's at x + motion): each anchor a P picture of the anchor
    before, each picture between two decoded ones a B picture averaging
    them (forward and backward motion), the picture at ``cra`` a CRA
    picture whose GOP before it follows it as RASL pictures; the clip's
    ``display`` is its presentation order. One CU a CTB (16x16, or 32x32
    with ``ctb_log2`` 5), the loop filters off. The coded size is the frame
    size plus ``crop`` (left, right, top, bottom)."""
    frames = list(frames)
    hgt, wid = frames[0].shape[:2]
    pics = _pan_gops(len(frames), gop, cra) if gop else None
    reorder, max_dec = dpb_params(pics) if gop else (0, 3 if bframes else 2)
    p = Params(width=wid, height=hgt, crop=tuple(crop), ctb_log2=ctb_log2, min_cb_log2=ctb_log2,
               min_tb_log2=2, max_tb_log2=min(ctb_log2, 5), max_th_inter=0, max_th_intra=0,
               init_qp=qp, deblock=(False, True, 0, 0), lf_across_slices=False,
               max_dec=max_dec, num_reorder=reorder,
               num_ref_default=(1, 2 if bframes else 1))
    enc = PanEncoder(p, qp)
    sw = StreamWriter(p, enc)
    cw, ch = p.coded_w, p.coded_h

    def source(i):
        f = frames[i]
        return rgb_to_yuv420(np.pad(f, ((crop[2], ch - hgt - crop[2]),
                                        (crop[0], cw - wid - crop[0]), (0, 0)), mode="edge"))
    if gop:
        for q in pics:
            plan = PicPlan(q.nal, q.poc, 2, [Segment(0, sw.lay.nctb)], rps=list(q.rps))
            plan.motion = (0, 0)
            if q.used:
                plan.refs = sorted(q.used, key=lambda r: (r > q.display, abs(r - q.display)))
                plan.motion = motion(q.display, plan.refs[0])
                if len(plan.refs) > 1:
                    plan.type, plan.num_ref, plan.ref1 = 0, (1, 1), 0
                    plan.motion2 = motion(q.display, plan.refs[1])
                else:
                    plan.type, plan.num_ref = 1, (1, 0)
                plan.refs = [r - (q.display - q.poc) for r in plan.refs]
            plan.source = source(q.display)
            sw.picture(plan)
        clip = sw.clip()
        clip.display = [q.display for q in pics]
        return clip
    for i in range(len(frames)):
        mv = tuple(motion[i]) if motion is not None and i > 0 else (0, 0)
        seg = Segment(0, sw.lay.nctb)
        if i == 0:
            plan = PicPlan(19, 0, 2, [seg])
        elif bframes and i >= 2:
            plan = PicPlan(1, i, 0, [seg], rps=[(-1, 1), (-2, 1)], num_ref=(1, 2))
            prev = tuple(motion[i - 1]) if motion is not None else (0, 0)
            plan.motion2 = (mv[0] + prev[0], mv[1] + prev[1])
            plan.refs, plan.ref1 = (i - 1, i - 2), 1
        else:
            plan = PicPlan(1, i, 1, [seg], rps=[(-1, 1)], num_ref=(1, 0))
            if i:
                plan.refs = (i - 1,)
        plan.source = source(i)
        plan.motion = mv
        sw.picture(plan)
    return sw.clip()


def _pan_gops(n, gop, cra):
    """encode()'s structure: an IDR picture, anchors every ``gop``
    pictures and at the last, each picture between two decoded ones
    referencing just them (list 0 the one before it, list 1 the one
    after); the anchor at ``cra`` a CRA picture with RASL pictures."""
    anchors = list(range(0, n, gop)) + ([n - 1] if (n - 1) % gop else [])
    pics = [GopPic(19, 0, [])]
    for p, a in zip(anchors, anchors[1:]):
        if a == cra:
            pics.append(GopPic(21, a, []))
            pics += _hier(p, a, 3, "rasl")
        else:
            pics.append(GopPic(1, a, [p]))
            pics += _hier(p, a, 3, "trail")
    _gop_rps(pics)
    return pics


# --- what the port's decoder refuses ------------------------------------------------------

# feature: the message's words
REFUSED = {
    "Main 10": "the Main 10 profile (general_profile_idc 2)",
    "RExt": "the Format Range Extensions profile (general_profile_idc 4)",
    "SCC": "the Screen Content Coding profile (general_profile_idc 9)",
    "multiview": "the Multiview Main profile (general_profile_idc 6)",
    "4:2:2": "chroma_format_idc 2 (only 4:2:0)",
    "10 bits": "bit depth 10 (only 8 bits)",
    "field_seq_flag": "field-coded sequences (field_seq_flag)",
    "size change": "a size change mid-stream (64x48 to 80x48)",
    "left crop": "a left crop of 2 luma samples (not a multiple of 64)",
    "slice deblocking": "slices of one picture that differ in their deblocking",
    "layer parameter sets": "parameter sets of nuh_layer_id > 0 (multi-layer streams)",
    "matrix": "matrix_coeffs 8 (swscale converts no such frame)",
}


# refused_clip's streams of features the decoder reads: a picture put out
# before one that precedes it in decode order, a RADL_R picture after its
# IDR picture's first trailing picture, a picture sent with pic_output_flag 0
READ = ("reordered B pictures", "leading pictures", "pic_output_flag")


def refused_clip(feature, seed=0):
    """A small stream (an IDR picture, then P pictures, 64x48) that uses
    ``feature`` of REFUSED (or of READ): in its parameter sets or its
    second or third picture."""
    rng = np.random.default_rng(seed)
    over = {"Main 10": dict(profile=2), "RExt": dict(profile=4), "SCC": dict(profile=9),
            "multiview": dict(profile=6), "4:2:2": dict(chroma_format=2),
            "10 bits": dict(bit_depth=10), "field_seq_flag": dict(vui=dict(field_seq=1)),
            "left crop": dict(width=62, crop=(2, 0, 0, 0)),
            "slice deblocking": dict(deblock=(True, False, 0, 0)),
            "pic_output_flag": dict(output_flag_present=True),
            "matrix": dict(vui=dict(matrix=8))}.get(feature, {})
    p = Params(**{"width": 64, "height": 48, "init_qp": 30, **over})
    sw = StreamWriter(p, RandomChooser(rng, p, intra=0.3))
    n = sw.lay.nctb

    def plan(nt, poc, typ, rps=(), segs=None):
        pl = PicPlan(nt, poc, typ, segs or [Segment(0, n)], rps=list(rps),
                     num_ref=(1, 0) if typ == 1 else (0, 0))
        return pl
    sw.picture(plan(19, 0, 2))
    sw.picture(plan(1, 2, 1, [(-2, 1)]))
    third = plan(1, 4, 1, [(-2, 1), (-4, 0)])
    if feature == "reordered B pictures":
        third = plan(1, 1, 1, [(-1, 1), (1, 0)])
    elif feature == "leading pictures":
        third = plan(7, 1, 2, [(-1, 0), (1, 0)])
    elif feature == "pic_output_flag":
        third.pic_output = False
    elif feature == "slice deblocking":
        half = n // 2
        third.segments = [Segment(0, half, deblock=(False, 2, 2)),
                          Segment(half, n - half, deblock=(False, -2, -2))]
    elif feature == "layer parameter sets":
        pps = write_pps(p)
        third.extra_nals = [(0, pps[:1] + bytes([pps[1] | (1 << 3)]) + pps[2:])]
    sw.picture(third)
    clip = sw.clip()
    if feature == "size change":
        q = Params(width=80, height=48, init_qp=30)
        sw2 = StreamWriter(q, RandomChooser(rng, q))
        sw2.picture(PicPlan(19, 0, 2, [Segment(0, sw2.lay.nctb)]))
        clip.pictures.append([sw2.vps, sw2.sps, sw2.pps] + sw2.pictures[0])
        clip.sync.append(True)
    return clip
