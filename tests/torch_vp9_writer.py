"""VP9 test streams for the port's video reader.

A boolean encoder (libvpx's vpx_writer), the uncompressed and compressed
frame headers, and a block writer of random legal syntax from a seed with
the decoder's contexts, MV reference search, segment-id prediction and
backward adaptation, so that what it writes parses as it meant it to; the
frames are whatever the syntax decodes to. It writes the tools that
libvpx-through-cv2 never emits:

- frames that are not shown (a hidden ALTREF in a superframe with the
  frame after it) and ``show_existing_frame``;
- compound prediction (ALTREF sign bias 1, ``reference_select``, compound
  only);
- backward adaptation (``frame_parallel_decoding_mode`` 0), the four saved
  contexts, ``reset_frame_context``, error-resilient and intra-only frames;
- segmentation: the tree and temporal prediction of segment ids and the
  four features (absolute and delta), lossless frames and the delta-q's;
- tile columns and rows, every colour space and full range, odd sizes;

and, in every stream, every partition, intra and inter mode, sub-8x8 block,
tx size and type, interpolation filter (bilinear too) and forward
probability update. Coefficients are those an encoder would code: the
forward transform of a bounded residual, quantised (small levels of the WHT
in lossless frames), so the inverse transform's intermediate values keep
the range the standard asks for.

Samples go into Matroska (``V_VP9``), MP4 (``vp09`` + ``vpcC``) and AVI
(``VP90``) with :func:`write_mkv`, :func:`write_mp4` and :func:`write_avi`.
cv2 (FFmpeg) is the reference that decodes these streams in the tests. This
module is a test tool: the port never imports it. It reads libvpx's default
probabilities, scans and quantisers from the decoder's source
(``native/vp9_decode.cpp``), where they were taken from libvpx; a table
wrong in both would still show, since cv2 decodes with its own.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import struct
from pathlib import Path

import numpy as np

import torch_h264_writer as H
from mast3r_slam_tpu_torch.data import video

_SRC = Path(__file__).resolve().parents[1] / "mast3r_slam_tpu_torch" / "native" / "vp9_decode.cpp"


def _load_tables():
    text = _SRC.read_text()
    out = {}
    for m in re.finditer(r"const (?:uint8_t|int16_t|int8_t) (k\w+)((?:\[\d+\])+) = \{(.*?)\};",
                         text, re.S):
        dims = [int(d) for d in re.findall(r"\[(\d+)\]", m.group(2))]
        body = m.group(3)
        if re.search(r"[A-Za-z_]", body):
            continue
        vals = [int(v) for v in re.findall(r"-?\d+", body)]
        if len(vals) == int(np.prod(dims)):
            out[m.group(1)] = np.array(vals, np.int64).reshape(dims)
    return out


T = _load_tables()

# block sizes (libvpx order) and their geometry
B4X4, B4X8, B8X4, B8X8 = 0, 1, 2, 3
NUM4W = (1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16)
NUM4H = (1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16)
NUM8W = (1, 1, 1, 1, 1, 2, 2, 2, 4, 4, 4, 8, 8)
NUM8H = (1, 1, 1, 1, 2, 1, 2, 4, 2, 4, 8, 4, 8)
MAX_TX = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3)
UV_MAX_TX = (0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 3)
SIZE_GROUP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3)
PART_ABOVE = (15, 15, 14, 14, 14, 12, 12, 12, 8, 8, 8, 0, 0)
PART_LEFT = (15, 14, 15, 14, 12, 14, 12, 8, 12, 8, 0, 8, 0)
SUBSIZE = ((3, 6, 9, 12), (2, 5, 8, 11), (1, 4, 7, 10), (0, 3, 6, 9))
MODE_TX = (0, 1, 2, 0, 3, 1, 2, 2, 1, 3)
BIGGEST_TX = (0, 1, 2, 3, 3)
NEARESTMV, NEARMV, ZEROMV, NEWMV = 10, 11, 12, 13
DC_PRED, TM_PRED = 0, 9

INTRA_MODE_TREE = (0, 2, -9, 4, -1, 6, 8, 12, -2, 10, -4, -5, -3, 14, -8, 16, -6, -7)
SEGMENT_TREE = (2, 4, 6, 8, 10, 12, 0, -1, -2, -3, -4, -5, -6, -7)
PARTITION_TREE = (0, 2, -1, 4, -2, -3)
INTER_MODE_TREE = (-2, 2, 0, 4, -1, -3)
INTERP_TREE = (0, 2, -1, -2)
MV_JOINT_TREE = (0, 2, -1, 4, -2, -3)
MV_CLASS_TREE = (0, 2, -1, 4, 6, 8, -2, -3, 10, 12, -4, -5, -6, 14, 16, 18, -7, -8, -9, -10)
MV_FP_TREE = (0, 2, -1, 4, -2, -3)
TOKEN_TREE = (2, 6, -2, 4, -3, -4, 8, 10, -5, -6, 12, 14, -7, -8, -9, -10)
BAND4 = (0, 1, 1, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 5)
BAND8 = (0, 1, 1, 2, 2, 2, 3, 3, 3, 3) + (4,) * 11
ENERGY = (0, 1, 2, 3, 3, 4, 4, 5, 5, 5, 5)
CATS = ((5, T["kCat1"]), (7, T["kCat2"]), (11, T["kCat3"]), (19, T["kCat4"]),
        (35, T["kCat5"]), (67, T["kCat6"]))
MODE_COUNTER = (9,) * 10 + (0, 0, 3, 1)
COUNTER_TO_CTX = (2, 3, 4, 1, 3, 9, 0, 9, 9, 5, 5, 9, 5, 9, 9, 9, 9, 9, 6)
SUB_OF_COL = ((1, 2), (1, 3), (3, 2), (3, 3))
MV_REF_BLOCKS = T["kMvRefBlocks"]
SCANS = {(0, 0): T["kScan4Default"], (0, 1): T["kScan4Row"], (0, 2): T["kScan4Col"],
         (1, 0): T["kScan8Default"], (1, 1): T["kScan8Row"], (1, 2): T["kScan8Col"],
         (2, 0): T["kScan16Default"], (2, 1): T["kScan16Row"], (2, 2): T["kScan16Col"],
         (3, 0): T["kScan32Default"], (3, 1): T["kScan32Default"], (3, 2): T["kScan32Default"]}


def _tree_paths(tree):
    """leaf -> [(probability index, bit), ...] from the root."""
    paths = {}

    def walk(i, path):
        for b in (0, 1):
            n = tree[i + b]
            step = path + [(i >> 1, b)]
            if n > 0:
                walk(n, step)
            else:
                paths[-n] = step
    walk(0, [])
    return paths


PATHS = {t: _tree_paths(t) for t in (INTRA_MODE_TREE, SEGMENT_TREE, PARTITION_TREE,
                                     INTER_MODE_TREE, INTERP_TREE, MV_JOINT_TREE,
                                     MV_CLASS_TREE, MV_FP_TREE, TOKEN_TREE)}


def _kind(tx, tx_type):
    return 0 if tx == 3 else 1 if tx_type == 1 else 2 if tx_type == 2 else 0


def _neighbours(tx, kind):
    scan, l = SCANS[(tx, kind)], 4 << tx
    nb = np.zeros((l * l, 2), np.int64)
    for n, rc in enumerate(scan):
        i, j = divmod(int(rc), l)
        if i > 0 and j > 0:
            if tx < 3 and kind == 2:
                a = b = (i - 1) * l + j
            elif tx < 3 and kind == 1:
                a = b = i * l + j - 1
            else:
                a, b = (i - 1) * l + j, i * l + j - 1
        elif i > 0:
            a = b = (i - 1) * l + j
        else:
            a = b = max(i * l + j - 1, 0)
        nb[n] = a, b
    return nb


NEIGHBOURS = {(tx, k): _neighbours(tx, k) for tx in range(4) for k in range(3)}


# --- coders ----------------------------------------------------------------------

class BoolEncoder:
    """libvpx's vpx_writer."""

    def __init__(self):
        self.buf = bytearray()
        self.low, self.range, self.count = 0, 255, -24
        self.write(0, 128)  # the marker bit

    def write(self, bit, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        rng = split
        low = self.low
        if bit:
            low = (low + split) & 0xFFFFFFFF
            rng = self.range - split
        shift = 8 - rng.bit_length() if rng < 128 else 0
        rng <<= shift
        count = self.count + shift
        if count >= 0:
            offset = shift - count
            if (low << (offset - 1)) & 0x80000000:
                x = len(self.buf) - 1
                while x >= 0 and self.buf[x] == 0xFF:
                    self.buf[x] = 0
                    x -= 1
                self.buf[x] += 1
            self.buf.append((low >> (24 - offset)) & 0xFF)
            low = (low << offset) & 0xFFFFFF
            shift = count
            count -= 8
        self.low = (low << shift) & 0xFFFFFFFF
        self.count = count
        self.range = rng

    def literal(self, v, n):
        for i in range(n - 1, -1, -1):
            self.write((v >> i) & 1, 128)

    def tree(self, tree, probs, leaf):
        for i, b in PATHS[tree][leaf]:
            self.write(b, int(probs[i]))

    def finish(self):
        for _ in range(32):
            self.write(0, 128)
        if (self.buf[-1] & 0xE0) == 0xC0:
            self.buf.append(0)
        return bytes(self.buf)


class BitWriter:
    def __init__(self):
        self.bits = []

    def f(self, v, n):
        self.bits += [(v >> i) & 1 for i in range(n - 1, -1, -1)]

    def s(self, v, n):  # magnitude then sign
        self.f(abs(v), n)
        self.f(1 if v < 0 else 0, 1)

    def bytes(self):
        b = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, b[i:i + 8])), 2) for i in range(0, len(b), 8))


# --- probabilities, counts and their adaptation ------------------------------------

def default_probs():
    mv = T["kMvCompProbs"]
    return {
        "coef": T["kCoefProbs"].copy(), "skip": T["kSkipProbs"].copy(),
        "tx8": T["kTx8Probs"].copy(), "tx16": T["kTx16Probs"].copy(), "tx32": T["kTx32Probs"].copy(),
        "inter_mode": T["kInterModeProbs"].copy(), "interp": T["kInterpProbs"].copy(),
        "intra_inter": T["kIntraInterProbs"].copy(), "comp_inter": T["kCompInterProbs"].copy(),
        "single_ref": T["kSingleRefProbs"].copy(), "comp_ref": T["kCompRefProbs"].copy(),
        "y_mode": T["kYModeProbs"].copy(), "uv_mode": T["kUvModeProbs"].copy(),
        "partition": T["kPartitionProbs"].copy(), "mv_joint": T["kMvJointProbs"].copy(),
        "mv_sign": mv[:, 0].copy(), "mv_classes": mv[:, 1:11].copy(), "mv_class0": mv[:, 11:12].copy(),
        "mv_bits": mv[:, 12:22].copy(), "mv_class0_fp": mv[:, 22:28].reshape(2, 2, 3).copy(),
        "mv_fp": mv[:, 28:31].copy(), "mv_class0_hp": mv[:, 31].copy(), "mv_hp": mv[:, 32].copy(),
    }


def copy_probs(p):
    return {k: v.copy() for k, v in p.items()}


def new_counts():
    z = np.zeros
    return {
        "coef": z((4, 2, 2, 6, 6, 3), np.int64), "eob": z((4, 2, 2, 6, 6, 2), np.int64),
        "skip": z((3, 2), np.int64), "tx8": z((2, 2), np.int64), "tx16": z((2, 3), np.int64),
        "tx32": z((2, 4), np.int64), "inter_mode": z((7, 4), np.int64), "interp": z((4, 3), np.int64),
        "intra_inter": z((4, 2), np.int64), "comp_inter": z((5, 2), np.int64),
        "single_ref": z((5, 2, 2), np.int64), "comp_ref": z((5, 2), np.int64),
        "y_mode": z((4, 10), np.int64), "uv_mode": z((10, 10), np.int64),
        "partition": z((16, 4), np.int64), "mv_joint": z(4, np.int64), "mv_sign": z((2, 2), np.int64),
        "mv_classes": z((2, 11), np.int64), "mv_class0": z((2, 2), np.int64),
        "mv_bits": z((2, 10, 2), np.int64), "mv_class0_fp": z((2, 2, 4), np.int64),
        "mv_fp": z((2, 4), np.int64), "mv_class0_hp": z((2, 2), np.int64), "mv_hp": z((2, 2), np.int64),
    }


def _adapt(p, idx, ct0, ct1, max_count=20, uf=128):
    ct = int(ct0) + int(ct1)
    if not ct:
        return
    uf = uf * min(ct, max_count) // max_count
    p1 = int(p[idx])
    p2 = min(max(((int(ct0) << 8) + (ct >> 1)) // ct, 1), 255)
    p[idx] = p1 + (((p2 - p1) * uf + 128) >> 8)


def _tree_merge(tree, probs, counts, i=0):
    l, r = tree[i], tree[i + 1]
    cl = _tree_merge(tree, probs, counts, l) if l > 0 else int(counts[-l])
    cr = _tree_merge(tree, probs, counts, r) if r > 0 else int(counts[-r])
    _adapt(probs, i >> 1, cl, cr)
    return cl + cr


# --- inv_remap_prob ------------------------------------------------------------------

def _inv_map():
    m = [7 + 13 * i for i in range(20)]
    m += [v for v in range(1, 254) if v < 7 or (v - 7) % 13]
    return m


INV_MAP = _inv_map()


def _recenter(v, m):
    if v > 2 * m:
        return v
    return m - ((v + 1) >> 1) if v & 1 else m + (v >> 1)


def inv_remap(d, m):
    v = INV_MAP[d]
    return 1 + _recenter(v, m - 1) if m <= 128 else 255 - _recenter(v, 255 - m)


def write_prob_delta(bw, old, new):
    """The subexponential code of the delta that takes ``old`` to ``new``."""
    d = next(i for i in range(254) if inv_remap(i, old) == new)
    if d < 16:
        bw.write(0, 128)
        bw.literal(d, 4)
    elif d < 32:
        bw.write(1, 128)
        bw.write(0, 128)
        bw.literal(d - 16, 4)
    elif d < 64:
        bw.write(1, 128)
        bw.write(1, 128)
        bw.write(0, 128)
        bw.literal(d - 32, 5)
    else:
        for _ in range(3):
            bw.write(1, 128)
        u = d - 64
        if u < 65:
            bw.literal(u, 7)
        else:
            bw.literal((u + 65) >> 1, 7)
            bw.write((u + 65) & 1, 128)


# --- the forward transforms --------------------------------------------------------

def _inverse_matrix(n, adst):
    eye = np.eye(n, dtype=np.int64) * 4096
    return video.vp9_transform_1d(eye, adst).T.astype(np.float64) / 4096


_FWD = {}


def forward(res, tx, tx_type):
    """Coefficients whose inverse transform is near the residual ``res``."""
    key = (tx, tx_type)
    if key not in _FWD:
        n = 4 << tx
        ra, ca = tx < 3 and tx_type in (2, 3), tx < 3 and tx_type in (1, 3)
        mr, mc = _inverse_matrix(n, ra), _inverse_matrix(n, ca)
        shift = 4 if tx == 0 else 5 if tx == 1 else 6
        _FWD[key] = (np.linalg.inv(mc) * (1 << shift), np.linalg.inv(mr).T)
    a, b = _FWD[key]
    return a @ res @ b


# --- mode info ---------------------------------------------------------------------------

class MI:
    __slots__ = ("sb", "mode", "bmode", "uv", "ref", "mv", "bmv", "tx", "skip", "seg", "filter")

    def __init__(self):
        self.sb, self.mode, self.uv, self.tx, self.skip, self.seg, self.filter = 0, 0, 0, 0, 0, 0, 0
        self.bmode = [0] * 4
        self.ref = [0, -1]
        self.mv = [(0, 0), (0, 0)]
        self.bmv = [[(0, 0), (0, 0)] for _ in range(4)]

    @property
    def inter(self):
        return self.ref[0] > 0

    @property
    def comp(self):
        return self.ref[1] > 0


@dataclasses.dataclass
class FrameSpec:
    """One frame's header choices; the rest of the syntax is drawn at
    random. ``kind``: "key", "inter" or "intra_only"."""
    kind: str = "inter"
    show: bool = True
    error_res: bool = False
    reset_ctx: int = 0
    refresh: int = 1
    ref_idx: tuple = (0, 1, 2)
    sign_bias: tuple = (0, 0, 0)
    size_from_ref: int = -1
    allow_hp: bool = True
    interp: int = 4  # 0 regular, 1 smooth, 2 sharp, 3 bilinear, 4 switchable
    refresh_ctx: bool = True
    parallel: bool = True
    ctx_idx: int = 0
    lf_level: int = 20
    lf_sharp: int = 0
    lf_delta: bool = True
    lf_update: dict = None  # {"ref": {i: v}, "mode": {i: v}}
    base_q: int = 60
    dq: tuple = (0, 0, 0)
    seg: dict = None  # see _write_segmentation
    tile_cols: int = 0
    tile_rows: int = 0
    color: tuple = (0, 0)  # key frames: color_space, color_range
    render: tuple = None
    tx_mode: int = 4
    ref_mode: int = 0  # 0 single, 1 compound, 2 select
    updates: float = 0.02  # the share of probabilities given a forward update
    p_intra: float = 0.2
    p_skip: float = 0.15
    p_split: float = 0.5
    p_coef: float = 0.7
    amp: int = 40


class StreamWriter:
    """Frames of one stream, with the decoder's state kept beside them."""

    def __init__(self, width, height, seed=0):
        self.w, self.h = width, height
        self.cols, self.rows = (width + 7) >> 3, (height + 7) >> 3
        self.sb_cols, self.sb_rows = (self.cols + 7) >> 3, (self.rows + 7) >> 3
        self.rng = np.random.default_rng(seed)
        self.saved = [default_probs() for _ in range(4)]
        self.slots = [False] * 8
        self.seg_last = np.zeros((self.rows, self.cols), np.int64)
        self.seg_cur = np.zeros_like(self.seg_last)
        self.prev_mvs = None
        self.lf_ref = [1, 0, -1, -1]
        self.lf_mode = [0, 0]
        self.seg = dict(enabled=False, update_map=False, temporal=False, abs=False,
                        tree=[255] * 7, pred=[255] * 3,
                        feature=[[False] * 4 for _ in range(8)], data=[[0] * 4 for _ in range(8)])
        self.last_show, self.last_key, self.have_prev = False, False, False
        self.frame_type = 0
        self.flags = []  # each frame's header flags, for the tests
        self.stats = collections.Counter()  # the block syntax written, for the tests

    # --- frame --------------------------------------------------------------------

    def frame(self, spec: FrameSpec, show_existing=None) -> bytes:
        """One frame; ``show_existing``: the slot shown by a header-only
        frame."""
        bw = BitWriter()
        bw.f(2, 2)
        bw.f(0, 2)  # profile 0
        if show_existing is not None:
            bw.f(1, 1)
            bw.f(show_existing, 3)
            self.flags.append(dict(show_existing=True))
            return bw.bytes()
        bw.f(0, 1)
        s = spec
        key, intra_only = s.kind == "key", s.kind == "intra_only"
        self.last_key = self.frame_type == 0 and self.have_prev
        self.frame_type = 0 if key else 1
        bw.f(self.frame_type, 1)
        bw.f(int(s.show), 1)
        bw.f(int(s.error_res), 1)
        self.use_prev = not s.error_res and self.have_prev and self.last_show
        self.intra = key or intra_only
        self.error_res = s.error_res
        refresh = 0xFF if key else s.refresh

        def sync():
            bw.f(0x49, 8)
            bw.f(0x83, 8)
            bw.f(0x42, 8)

        def sizes():
            bw.f(self.w - 1, 16)
            bw.f(self.h - 1, 16)

        def render():
            if s.render:
                bw.f(1, 1)
                bw.f(s.render[0] - 1, 16)
                bw.f(s.render[1] - 1, 16)
            else:
                bw.f(0, 1)
        if key:
            sync()
            bw.f(s.color[0], 3)
            bw.f(s.color[1], 1)
            sizes()
            render()
        else:
            if not s.show:
                bw.f(int(intra_only), 1)
            else:
                assert not intra_only, "an intra-only frame is never shown directly"
            if not s.error_res:
                bw.f(s.reset_ctx, 2)
            if intra_only:
                sync()
                bw.f(refresh, 8)
                sizes()
                render()
            else:
                bw.f(refresh, 8)
                for i in range(3):
                    assert self.slots[s.ref_idx[i]]
                    bw.f(s.ref_idx[i], 3)
                    bw.f(s.sign_bias[i], 1)
                if s.size_from_ref >= 0:
                    for i in range(s.size_from_ref):
                        bw.f(0, 1)
                    bw.f(1, 1)
                else:
                    bw.f(0, 3)
                    sizes()
                render()
                bw.f(int(s.allow_hp), 1)
                if s.interp == 4:
                    bw.f(1, 1)
                else:
                    bw.f(0, 1)
                    bw.f((1, 0, 2, 3)[s.interp], 2)
        self.interp = 4 if self.intra else s.interp
        self.allow_hp = s.allow_hp and not self.intra
        self.sign_bias = [0] + (list(s.sign_bias) if not self.intra else [0, 0, 0])
        self.ref_idx = s.ref_idx
        refresh_ctx, parallel = (s.refresh_ctx, s.parallel) if not s.error_res else (False, True)
        if not s.error_res:
            bw.f(int(refresh_ctx), 1)
            bw.f(int(parallel), 1)
        bw.f(s.ctx_idx, 2)
        ctx_idx = s.ctx_idx
        reset = 0 if key or s.error_res else s.reset_ctx
        if self.intra or s.error_res:
            self._past_independence(key, s.error_res, reset, ctx_idx)
        # loop filter
        bw.f(s.lf_level, 6)
        bw.f(s.lf_sharp, 3)
        bw.f(int(s.lf_delta), 1)
        if s.lf_delta:
            up = s.lf_update
            bw.f(int(bool(up)), 1)
            if up:
                for i in range(4):
                    if i in up.get("ref", {}):
                        bw.f(1, 1)
                        bw.s(up["ref"][i], 6)
                        self.lf_ref[i] = up["ref"][i]
                    else:
                        bw.f(0, 1)
                for i in range(2):
                    if i in up.get("mode", {}):
                        bw.f(1, 1)
                        bw.s(up["mode"][i], 6)
                        self.lf_mode[i] = up["mode"][i]
                    else:
                        bw.f(0, 1)
        # quantisation
        bw.f(s.base_q, 8)
        for d in s.dq:
            if d:
                bw.f(1, 1)
                bw.s(d, 4)
            else:
                bw.f(0, 1)
        self.lossless = s.base_q == 0 and not any(s.dq)
        self._write_segmentation(bw, s.seg)
        # tiles
        min_log2 = 0
        while (64 << min_log2) < self.sb_cols:
            min_log2 += 1
        max_log2 = 1
        while (self.sb_cols >> max_log2) >= 4:
            max_log2 += 1
        max_log2 -= 1
        tc = min(max(s.tile_cols, min_log2), max_log2)
        for _ in range(tc - min_log2):
            bw.f(1, 1)
        if tc < max_log2:
            bw.f(0, 1)
        bw.f(int(s.tile_rows > 0), 1)
        if s.tile_rows > 0:
            bw.f(int(s.tile_rows > 1), 1)
        self.tile_cols_log2, self.tile_rows_log2 = tc, s.tile_rows
        # the probabilities: FFmpeg loads the named context, saves into 0
        # on intra frames
        self.fc = copy_probs(self.saved[ctx_idx])
        if self.intra or s.error_res:
            ctx_idx = 0
        self.counts = new_counts()
        self.spec = s
        comp_hdr = self._compressed_header(s)
        self._setup_quant_and_lf(s)
        tiles = self._tiles()
        bw.f(len(comp_hdr), 16)
        data = bw.bytes() + comp_hdr + tiles
        # after the frame
        if refresh_ctx:
            if parallel:
                p = self.saved[ctx_idx]
                keep = p["coef"].copy()
                self.saved[ctx_idx] = copy_probs(self.fc)
                top = BIGGEST_TX[self.tx_mode]
                self.saved[ctx_idx]["coef"][top + 1:] = keep[top + 1:]
            else:
                self._adapt(ctx_idx, key, intra_only)
        for i in range(8):
            if refresh & (1 << i):
                self.slots[i] = True
        self.prev_mvs = self.cur_mvs
        if self.seg["enabled"]:
            self.seg_last, self.seg_cur = self.seg_cur, self.seg_last
        self.have_prev = True
        self.last_show = s.show
        self.flags.append(dict(
            kind=s.kind, show=s.show, error_res=s.error_res, reset_ctx=reset,
            refresh_ctx=refresh_ctx, parallel=parallel, ctx_idx=s.ctx_idx,
            intra_only=intra_only, lossless=self.lossless, dq=any(s.dq),
            seg=bool(self.seg["enabled"]), seg_temporal=bool(self.seg["temporal"]),
            seg_features=sorted({j for i in range(8) for j in range(4)
                                 if self.seg["enabled"] and self.seg["feature"][i][j]}),
            ref_mode=self.ref_mode, sign_bias=tuple(self.sign_bias[1:]),
            tile_cols=self.tile_cols_log2, tile_rows=self.tile_rows_log2,
            interp=self.interp, color=s.color if key else None))
        return data

    def _past_independence(self, key, error_res, reset, ctx_idx):
        sg = self.seg
        sg["feature"] = [[False] * 4 for _ in range(8)]
        sg["data"] = [[0] * 4 for _ in range(8)]
        sg["abs"] = False
        self.seg_last[:] = 0
        self.lf_ref = [1, 0, -1, -1]
        self.lf_mode = [0, 0]
        if key or error_res or reset == 3:
            self.saved = [default_probs() for _ in range(4)]
        elif reset == 2:
            self.saved[ctx_idx] = default_probs()

    def _write_segmentation(self, bw, seg):
        sg = self.seg
        if not seg:
            bw.f(0, 1)
            sg["enabled"], sg["update_map"], sg["temporal"] = False, False, False
            return
        bw.f(1, 1)
        sg["enabled"] = True
        sg["update_map"] = bool(seg.get("update_map", True))
        sg["temporal"] = False
        bw.f(int(sg["update_map"]), 1)
        if sg["update_map"]:
            tree = seg.get("tree", [255] * 7)
            for p in tree:
                bw.f(int(p != 255), 1)
                if p != 255:
                    bw.f(p, 8)
            sg["tree"] = list(tree)
            sg["temporal"] = bool(seg.get("temporal", False)) and not self.intra
            bw.f(int(sg["temporal"]), 1)
            pred = seg.get("pred", [255] * 3) if sg["temporal"] else [255] * 3
            if sg["temporal"]:
                for p in pred:
                    bw.f(int(p != 255), 1)
                    if p != 255:
                        bw.f(p, 8)
            sg["pred"] = list(pred)
        data = seg.get("data")
        bw.f(int(data is not None), 1)
        if data is not None:
            sg["abs"] = bool(seg.get("abs", False))
            bw.f(int(sg["abs"]), 1)
            sg["feature"] = [[False] * 4 for _ in range(8)]
            sg["data"] = [[0] * 4 for _ in range(8)]
            for i in range(8):
                for j, (bits, signed) in enumerate(((8, True), (6, True), (2, False), (0, False))):
                    v = data.get((i, j))
                    bw.f(int(v is not None), 1)
                    if v is not None:
                        sg["feature"][i][j] = True
                        sg["data"][i][j] = v
                        bw.f(abs(v), bits)
                        if signed:
                            bw.f(int(v < 0), 1)

    def _setup_quant_and_lf(self, s):
        sg = self.seg
        shift = s.lf_level >> 5
        self.qmul = []
        for i in range(8):
            q = s.base_q
            if sg["enabled"] and sg["feature"][i][0]:
                q = sg["data"][i][0] if sg["abs"] else s.base_q + sg["data"][i][0]
            q = min(max(q, 0), 255)

            def look(t, d):
                return int(t[min(max(q + d, 0), 255)])
            self.qmul.append(((look(T["kDcQLookup"], s.dq[0]), look(T["kAcQLookup"], 0)),
                              (look(T["kDcQLookup"], s.dq[1]), look(T["kAcQLookup"], s.dq[2]))))

    # --- the compressed header --------------------------------------------------------

    def _update(self, bw, arr, idx):
        """diff_update of one probability: a random new value at the
        spec's rate."""
        if self.rng.random() < self.spec.updates:
            old = int(arr[idx])
            new = old
            while new == old:
                new = int(self.rng.integers(1, 256))
            bw.write(1, 252)
            write_prob_delta(bw, old, new)
            arr[idx] = new
        else:
            bw.write(0, 252)

    def _compressed_header(self, s):
        fc = self.fc
        bw = BoolEncoder()
        self.tx_mode = 0 if self.lossless else s.tx_mode
        if not self.lossless:
            bw.literal(min(self.tx_mode, 3), 2)
            if self.tx_mode >= 3:
                bw.write(int(self.tx_mode == 4), 128)
        if self.tx_mode == 4:
            for i in range(2):
                self._update(bw, fc["tx8"][i], 0)
            for i in range(2):
                for j in range(2):
                    self._update(bw, fc["tx16"][i], j)
            for i in range(2):
                for j in range(3):
                    self._update(bw, fc["tx32"][i], j)
        for t in range(BIGGEST_TX[self.tx_mode] + 1):
            upd = self.rng.random() < 0.5 and s.updates > 0
            bw.write(int(upd), 128)
            if upd:
                for i in range(2):
                    for j in range(2):
                        for k in range(6):
                            for c in range(3 if k == 0 else 6):
                                for m in range(3):
                                    self._update(bw, fc["coef"][t, i, j, k, c], m)
        for i in range(3):
            self._update(bw, fc["skip"], i)
        self.ref_mode = 0
        if self.intra:
            return bw.finish()
        for i in range(7):
            for j in range(3):
                self._update(bw, fc["inter_mode"][i], j)
        if self.interp == 4:
            for j in range(4):
                for i in range(2):
                    self._update(bw, fc["interp"][j], i)
        for i in range(4):
            self._update(bw, fc["intra_inter"], i)
        sb = self.sign_bias
        allowed = sb[2] != sb[1] or sb[3] != sb[1]
        self.ref_mode = s.ref_mode if allowed else 0
        if allowed:
            bw.write(int(self.ref_mode > 0), 128)
            if self.ref_mode > 0:
                bw.write(int(self.ref_mode == 2), 128)
        if self.ref_mode:
            if sb[1] == sb[2]:
                self.comp_fixed, self.comp_var = 3, (1, 2)
            elif sb[1] == sb[3]:
                self.comp_fixed, self.comp_var = 2, (1, 3)
            else:
                self.comp_fixed, self.comp_var = 1, (2, 3)
        if self.ref_mode == 2:
            for i in range(5):
                self._update(bw, fc["comp_inter"], i)
        if self.ref_mode != 1:
            for i in range(5):
                self._update(bw, fc["single_ref"][i], 0)
                self._update(bw, fc["single_ref"][i], 1)
        if self.ref_mode != 0:
            for i in range(5):
                self._update(bw, fc["comp_ref"], i)
        for j in range(4):
            for i in range(9):
                self._update(bw, fc["y_mode"][j], i)
        for j in range(16):
            for i in range(3):
                self._update(bw, fc["partition"][j], i)

        def mv_update(arr, idx):
            if self.rng.random() < s.updates:
                bw.write(1, 252)
                v = int(self.rng.integers(0, 128))
                bw.literal(v, 7)
                arr[idx] = (v << 1) | 1
            else:
                bw.write(0, 252)
        for i in range(3):
            mv_update(fc["mv_joint"], i)
        for c in range(2):
            mv_update(fc["mv_sign"], c)
            for i in range(10):
                mv_update(fc["mv_classes"][c], i)
            mv_update(fc["mv_class0"][c], 0)
            for i in range(10):
                mv_update(fc["mv_bits"][c], i)
        for c in range(2):
            for j in range(2):
                for i in range(3):
                    mv_update(fc["mv_class0_fp"][c, j], i)
            for i in range(3):
                mv_update(fc["mv_fp"][c], i)
        if self.allow_hp:
            for c in range(2):
                mv_update(fc["mv_class0_hp"], c)
                mv_update(fc["mv_hp"], c)
        return bw.finish()

    # --- tiles and blocks --------------------------------------------------------------

    def _tiles(self):
        self.mi = [None] * (self.rows * self.cols)
        self.cur_mvs = [(0, -1, (0, 0), (0, 0))] * (self.rows * self.cols)
        self.above_part = [0] * (self.sb_cols * 8 + 8)
        self.above_segpred = [0] * (self.sb_cols * 8 + 8)
        self.above_nnz = [[0] * (self.sb_cols * 16 + 16) for _ in range(3)]
        tc, tr = 1 << self.tile_cols_log2, 1 << self.tile_rows_log2

        def offset(i, mis, log2):
            sbs = (mis + 7) >> 3
            return min(((i * sbs) >> log2) << 3, mis)
        out = b""
        for t_r in range(tr):
            r0, r1 = offset(t_r, self.rows, self.tile_rows_log2), offset(t_r + 1, self.rows, self.tile_rows_log2)
            for t_c in range(tc):
                self.c0 = offset(t_c, self.cols, self.tile_cols_log2)
                self.c1 = offset(t_c + 1, self.cols, self.tile_cols_log2)
                self.bw = BoolEncoder()
                for r in range(r0, r1, 8):
                    self.left_part = [0] * 8
                    self.left_segpred = [0] * 8
                    self.left_nnz = [[0] * 16 for _ in range(3)]
                    for c in range(self.c0, self.c1, 8):
                        self._partition(r, c, 3)
                data = self.bw.finish()
                last = t_r == tr - 1 and t_c == tc - 1
                out += (b"" if last else struct.pack(">I", len(data))) + data
        return out

    def _partition(self, r, c, bsl):
        if r >= self.rows or c >= self.cols:
            return
        hbs = (1 << bsl) >> 1
        has_rows, has_cols = r + hbs < self.rows, c + hbs < self.cols
        above = (self.above_part[c] >> bsl) & 1
        left = (self.left_part[r & 7] >> bsl) & 1
        ctx = bsl * 4 + left * 2 + above
        probs = T["kKfPartitionProbs"][ctx] if self.intra else self.fc["partition"][ctx]
        rng, s = self.rng, self.spec
        split = rng.random() < s.p_split * (0.8 if bsl < 3 else 1.0)
        if bsl == 0 and self._forced_skip_segment(r, c):
            split = False
        if has_rows and has_cols:
            p = 3 if split else int(rng.choice([0, 1, 2], p=[0.5, 0.25, 0.25]))
            if bsl == 0 and p != 0 and self._forced_skip_segment(r, c):
                p = 0
            self.bw.tree(PARTITION_TREE, probs, p)
        elif has_cols:
            p = 3 if split or bsl == 0 else 1
            self.bw.write(int(p == 3), int(probs[1]))
        elif has_rows:
            p = 3 if split or bsl == 0 else 2
            self.bw.write(int(p == 3), int(probs[2]))
        else:
            p = 3
        self.counts["partition"][ctx, p] += 1
        self.stats["partition", p] += 1
        sub = SUBSIZE[p][bsl]
        if bsl == 0 or p == 0:
            self._block(r, c, sub)
        elif p == 1:
            self._block(r, c, sub)
            if has_rows:
                self._block(r + hbs, c, sub)
        elif p == 2:
            self._block(r, c, sub)
            if has_cols:
                self._block(r, c + hbs, sub)
        else:
            for dr, dc in ((0, 0), (0, hbs), (hbs, 0), (hbs, hbs)):
                self._partition(r + dr, c + dc, bsl - 1)
        if bsl == 0 or p != 3:
            n8 = NUM8W[SUBSIZE[0][bsl]]
            for i in range(n8):
                if c + i < len(self.above_part):
                    self.above_part[c + i] = PART_ABOVE[sub]
                if (r & 7) + i < 8:
                    self.left_part[(r & 7) + i] = PART_LEFT[sub]

    def _forced_skip_segment(self, r, c):
        """An inter frame whose segment of (r, c) is forced (no map update)
        to one with the skip feature: its blocks must be 8x8 or more."""
        sg = self.seg
        if self.intra or not sg["enabled"] or sg["update_map"]:
            return False
        pred = 0 if self.error_res else int(self.seg_last[r, c])
        return sg["feature"][pred][3]

    def _pred_seg(self, r, c, bs):
        xm, ym = min(NUM8W[bs], self.cols - c), min(NUM8H[bs], self.rows - r)
        return int(self.seg_last[r:r + ym, c:c + xm].min())

    def _tx_size(self, above, left, bs, allow_select):
        max_tx = MAX_TX[bs]
        if not (allow_select and self.tx_mode == 4 and bs >= B8X8):
            return min(max_tx, BIGGEST_TX[self.tx_mode])
        a = above.tx if above and not above.skip else max_tx
        l = left.tx if left and not left.skip else max_tx
        if not left:
            l = a
        if not above:
            a = l
        ctx = int(a + l > max_tx)
        tx = int(self.rng.integers(0, max_tx + 1))
        fc, bw = self.fc, self.bw
        if max_tx == 1:
            bw.write(tx, int(fc["tx8"][ctx, 0]))
            self.counts["tx8"][ctx, tx] += 1
        elif max_tx == 2:
            bw.write(int(tx > 0), int(fc["tx16"][ctx, 0]))
            if tx:
                bw.write(int(tx > 1), int(fc["tx16"][ctx, 1]))
            self.counts["tx16"][ctx, tx] += 1
        else:
            bw.write(int(tx > 0), int(fc["tx32"][ctx, 0]))
            if tx:
                bw.write(int(tx > 1), int(fc["tx32"][ctx, 1]))
                if tx > 1:
                    bw.write(int(tx > 2), int(fc["tx32"][ctx, 2]))
            self.counts["tx32"][ctx, tx] += 1
        return tx

    def _block(self, r, c, bs):
        m = MI()
        m.sb = bs
        cols = self.cols
        above = self.mi[(r - 1) * cols + c] if r > 0 else None
        left = self.mi[r * cols + c - 1] if c > self.c0 else None
        if self.intra:
            self._intra_frame_mode_info(m, above, left, r, c, bs)
        else:
            self._inter_frame_mode_info(m, above, left, r, c, bs)
        bw8, bh8 = NUM8W[bs], NUM8H[bs]
        xm, ym = min(bw8, cols - c), min(bh8, self.rows - r)
        sg = self.seg
        if sg["enabled"]:
            if sg["update_map"] or self.intra:
                self.seg_cur[r:r + ym, c:c + xm] = m.seg
            else:
                self.seg_cur[r:r + ym, c:c + xm] = self.seg_last[r:r + ym, c:c + xm]
        if not m.skip:
            if not self._write_coefs(m, r, c, bs) and m.inter and bs >= B8X8:
                m.skip = 1
        else:
            for p in range(3):
                ss = int(p > 0)
                a0, l0 = (c * 2) >> ss, ((r & 7) * 2) >> ss
                for i in range((bw8 * 2) >> ss):
                    self.above_nnz[p][a0 + i] = 0
                for i in range((bh8 * 2) >> ss):
                    self.left_nnz[p][l0 + i] = 0
        st = self.stats
        st["block", bs] += 1
        st["tx", m.tx] += 1
        if m.inter:
            st["inter_mode", m.mode] += 1
            st["filter", m.filter] += 1
            st["compound" if m.comp else "single", m.ref[0]] += 1
        else:
            for b in m.bmode if bs < B8X8 else (m.mode,):
                st["intra_mode", b] += 1
            st["uv_mode", m.uv] += 1
        if self.seg["enabled"]:
            for j in range(4):
                if self.seg["feature"][m.seg][j]:
                    st["seg_feature", j] += 1
        for y in range(ym):
            for x in range(xm):
                i = (r + y) * cols + c + x
                self.mi[i] = m
                self.cur_mvs[i] = (m.ref[0], m.ref[1], m.mv[0], m.mv[1])

    def _choose_seg(self):
        return int(self.rng.integers(0, 8))

    def _write_seg(self, s):
        self.bw.tree(SEGMENT_TREE, self.seg["tree"], s)

    def _skip(self, m, above, left):
        sg = self.seg
        if sg["enabled"] and sg["feature"][m.seg][3]:
            m.skip = 1
            return
        ctx = (above.skip if above else 0) + (left.skip if left else 0)
        m.skip = int(self.rng.random() < self.spec.p_skip)
        self.bw.write(m.skip, int(self.fc["skip"][ctx]))
        self.counts["skip"][ctx, m.skip] += 1

    def _intra_frame_mode_info(self, m, above, left, r, c, bs):
        sg = self.seg
        m.seg = 0
        if sg["enabled"] and sg["update_map"]:
            m.seg = self._choose_seg()
            self._write_seg(m.seg)
        self._skip(m, above, left)
        m.tx = self._tx_size(above, left, bs, True)
        m.ref = [0, -1]

        def above_mode(b):
            if b >= 2:
                return m.bmode[b - 2]
            if not above or above.inter:
                return DC_PRED
            return above.bmode[b + 2] if above.sb < B8X8 else above.mode

        def left_mode(b):
            if b & 1:
                return m.bmode[b - 1]
            if not left or left.inter:
                return DC_PRED
            return left.bmode[b + 1] if left.sb < B8X8 else left.mode

        def mode(b):
            v = int(self.rng.integers(0, 10))
            self.bw.tree(INTRA_MODE_TREE, T["kKfYModeProbs"][above_mode(b), left_mode(b)], v)
            return v
        self._intra_modes(m, bs, mode)
        m.uv = int(self.rng.integers(0, 10))
        self.bw.tree(INTRA_MODE_TREE, T["kKfUvModeProbs"][m.mode], m.uv)

    @staticmethod
    def _intra_modes(m, bs, mode):
        if bs == B4X4:
            for i in range(4):
                m.bmode[i] = mode(i)
        elif bs == B4X8:
            m.bmode[0] = m.bmode[2] = mode(0)
            m.bmode[1] = m.bmode[3] = mode(1)
        elif bs == B8X4:
            m.bmode[0] = m.bmode[1] = mode(0)
            m.bmode[2] = m.bmode[3] = mode(2)
        else:
            v = mode(0)
            m.bmode = [v] * 4
        m.mode = m.bmode[3]

    def _inter_frame_mode_info(self, m, above, left, r, c, bs):
        sg, rng, bw, fc, k = self.seg, self.rng, self.bw, self.fc, self.counts
        m.seg = 0
        if sg["enabled"]:
            pred = 0 if self.error_res else self._pred_seg(r, c, bs)
            if not sg["update_map"]:
                m.seg = pred
            else:
                while True:
                    use_pred = sg["temporal"] and rng.random() < 0.5
                    m.seg = pred if use_pred else self._choose_seg()
                    if not (bs < B8X8 and sg["feature"][m.seg][3]):
                        break
                if sg["temporal"]:
                    ctx = self.above_segpred[c] + self.left_segpred[r & 7]
                    bw.write(int(use_pred), sg["pred"][ctx])
                    xm, ym = min(NUM8W[bs], self.cols - c), min(NUM8H[bs], self.rows - r)
                    for x in range(xm):
                        self.above_segpred[c + x] = int(use_pred)
                    for y in range(ym):
                        self.left_segpred[(r & 7) + y] = int(use_pred)
                if not use_pred:
                    self._write_seg(m.seg)
        self._skip(m, above, left)
        feat = sg["feature"][m.seg] if sg["enabled"] else [False] * 4
        data = sg["data"][m.seg]
        if feat[2]:
            inter = data[2] != 0
        else:
            inter = not (rng.random() < self.spec.p_intra)
            if bs < B8X8 and feat[3]:
                inter = False
            if above and left:
                ai, li = not above.inter, not left.inter
                ctx = 3 if (li and ai) else int(li or ai)
            elif above or left:
                ctx = 2 * int(not (above or left).inter)
            else:
                ctx = 0
            bw.write(int(inter), int(fc["intra_inter"][ctx]))
            k["intra_inter"][ctx, int(inter)] += 1
        if bs < B8X8 and feat[3] and inter:
            raise AssertionError("a sub-8x8 inter block in a skip segment")
        m.tx = self._tx_size(above, left, bs, not m.skip or not inter)
        if not inter:
            def mode_y(group):
                def f(_b):
                    v = int(rng.integers(0, 10))
                    bw.tree(INTRA_MODE_TREE, fc["y_mode"][group], v)
                    k["y_mode"][group, v] += 1
                    return v
                return f
            self._intra_modes(m, bs, mode_y(0 if bs < B8X8 else SIZE_GROUP[bs]))
            m.uv = int(rng.integers(0, 10))
            bw.tree(INTRA_MODE_TREE, fc["uv_mode"][m.mode], m.uv)
            k["uv_mode"][m.mode, m.uv] += 1
            m.ref = [0, -1]
            m.filter = 3
            return
        self._write_refs(m, above, left, feat, data)
        comp = m.comp
        nearest, nearv, best = [None, None], [None, None], [None, None]
        mode_ctx = 0
        for j in range(1 + comp):
            lst, mode_ctx = self._find_mv_refs(r, c, bs, m.ref[j], -1)
            nearest[j] = self._lower(lst[0])
            nearv[j] = self._lower(lst[1])
            best[j] = nearest[j]

        def inter_mode():
            v = int(rng.choice([0, 1, 2, 3], p=[0.3, 0.2, 0.2, 0.3]))
            bw.tree(INTER_MODE_TREE, fc["inter_mode"][mode_ctx], v)
            k["inter_mode"][mode_ctx, v] += 1
            return NEARESTMV + v
        if feat[3]:
            m.mode = ZEROMV
        elif bs >= B8X8:
            m.mode = inter_mode()
        if self.interp == 4:
            lt = left.filter if left and left.inter else 3
            at = above.filter if above and above.inter else 3
            ctx = lt if lt == at else at if lt == 3 else lt if at == 3 else 3
            m.filter = int(rng.integers(0, 3))
            bw.tree(INTERP_TREE, fc["interp"][ctx], m.filter)
            k["interp"][ctx, m.filter] += 1
        else:
            m.filter = self.interp

        def assign(mode, nst, nr):
            out = []
            for j in range(1 + comp):
                if mode == NEWMV:
                    out.append(self._write_mv(best[j]))
                elif mode == NEARESTMV:
                    out.append(nst[j])
                elif mode == NEARMV:
                    out.append(nr[j])
                else:
                    out.append((0, 0))
            return out + [(0, 0)] * (2 - len(out))
        if bs < B8X8:
            n4w, n4h = NUM4W[bs], NUM4H[bs]
            b_mode = NEARESTMV
            for idy in range(0, 2, n4h):
                for idx in range(0, 2, n4w):
                    j = idy * 2 + idx
                    b_mode = inter_mode()
                    nst, nr = [(0, 0)] * 2, [(0, 0)] * 2
                    if b_mode in (NEARESTMV, NEARMV):
                        for q in range(1 + comp):
                            lst, _ = self._find_mv_refs(r, c, bs, m.ref[q], j)
                            nr[q] = (0, 0)
                            if j == 0:
                                nst[q], nr[q] = lst[0], lst[1]
                            elif j in (1, 2):
                                nst[q] = m.bmv[0][q]
                                for cand in lst:
                                    if cand != nst[q]:
                                        nr[q] = cand
                                        break
                            else:
                                nst[q] = m.bmv[2][q]
                                for cand in (m.bmv[1][q], m.bmv[0][q], lst[0], lst[1]):
                                    if cand != nst[q]:
                                        nr[q] = cand
                                        break
                    mv = assign(b_mode, nst, nr)
                    m.bmv[j] = list(mv)
                    m.bmode[j] = b_mode
                    if n4h == 2:
                        m.bmv[j + 2] = list(mv)
                        m.bmode[j + 2] = b_mode
                    if n4w == 2:
                        m.bmv[j + 1] = list(mv)
                        m.bmode[j + 1] = b_mode
            m.mode = b_mode
            m.mv = list(m.bmv[3])
        else:
            m.mv = assign(m.mode, nearest, nearv)
            m.bmv = [list(m.mv) for _ in range(4)]
            m.bmode = [m.mode] * 4
        if not comp:
            m.mv[1] = (0, 0)

    def _lower(self, mv):
        hp = self.allow_hp and abs(mv[0]) < 64 and abs(mv[1]) < 64
        if hp:
            return mv
        return tuple(v + (-1 if v > 0 else 1) if v & 1 else v for v in mv)

    def _write_mv(self, ref):
        rng, bw, fc, k = self.rng, self.bw, self.fc, self.counts
        hp = self.allow_hp and abs(ref[0]) < 64 and abs(ref[1]) < 64
        while True:
            j = int(rng.integers(1, 4))
            diff = [0, 0]
            comps = []
            for ci in (0, 1):
                if (ci == 0 and j in (2, 3)) or (ci == 1 and j in (1, 3)):
                    cls = int(rng.choice(11, p=[0.35, 0.2, 0.15, 0.1, 0.08, 0.05, 0.03, 0.02, 0.01, 0.005, 0.005]))
                    d = int(rng.integers(0, 2 if cls == 0 else 1 << cls))
                    fr = int(rng.integers(0, 4))
                    h = int(rng.integers(0, 2)) if hp else 1
                    sign = int(rng.integers(0, 2))
                    mag = (0 if cls == 0 else 2 << (cls + 2)) + ((d << 3) | (fr << 1) | h) + 1
                    diff[ci] = -mag if sign else mag
                    comps.append((ci, sign, cls, d, fr, h))
            mv = (ref[0] + diff[0], ref[1] + diff[1])
            if all(-(1 << 14) < v < (1 << 14) for v in mv):
                break
        bw.tree(MV_JOINT_TREE, fc["mv_joint"], j)
        k["mv_joint"][j] += 1
        for ci, sign, cls, d, fr, h in comps:
            bw.write(sign, int(fc["mv_sign"][ci]))
            k["mv_sign"][ci, sign] += 1
            bw.tree(MV_CLASS_TREE, fc["mv_classes"][ci], cls)
            k["mv_classes"][ci, cls] += 1
            if cls == 0:
                bw.write(d, int(fc["mv_class0"][ci, 0]))
                k["mv_class0"][ci, d] += 1
                bw.tree(MV_FP_TREE, fc["mv_class0_fp"][ci, d], fr)
                k["mv_class0_fp"][ci, d, fr] += 1
                if hp:
                    bw.write(h, int(fc["mv_class0_hp"][ci]))
                k["mv_class0_hp"][ci, h] += 1
            else:
                for i in range(cls):
                    bit = (d >> i) & 1
                    bw.write(bit, int(fc["mv_bits"][ci, i]))
                    k["mv_bits"][ci, i, bit] += 1
                bw.tree(MV_FP_TREE, fc["mv_fp"][ci], fr)
                k["mv_fp"][ci, fr] += 1
                if hp:
                    bw.write(h, int(fc["mv_hp"][ci]))
                k["mv_hp"][ci, h] += 1
        return mv

    def _write_refs(self, m, above, left, feat, data):
        rng, bw, fc, k = self.rng, self.bw, self.fc, self.counts
        if feat[2]:
            m.ref = [data[2], -1]
            return
        ha, hl = above is not None, left is not None
        mode = self.ref_mode
        if mode == 2:
            if ha and hl:
                if not above.comp and not left.comp:
                    ctx = int(above.ref[0] == self.comp_fixed) ^ int(left.ref[0] == self.comp_fixed)
                elif not above.comp:
                    ctx = 2 + int(above.ref[0] == self.comp_fixed or not above.inter)
                elif not left.comp:
                    ctx = 2 + int(left.ref[0] == self.comp_fixed or not left.inter)
                else:
                    ctx = 4
            elif ha or hl:
                e = above if ha else left
                ctx = int(e.ref[0] == self.comp_fixed) if not e.comp else 3
            else:
                ctx = 1
            mode = int(rng.random() < 0.5)
            bw.write(mode, int(fc["comp_inter"][ctx]))
            k["comp_inter"][ctx, mode] += 1
        if mode == 1:
            fix_idx = self.sign_bias[self.comp_fixed]
            var_idx = 1 - fix_idx
            cv = self.comp_var
            if ha and hl:
                ai, li = not above.inter, not left.inter
                if ai and li:
                    ctx = 2
                elif ai or li:
                    e = left if ai else above
                    ctx = 1 + 2 * int((e.ref[0] if not e.comp else e.ref[var_idx]) != cv[1])
                else:
                    l_sg, a_sg = not left.comp, not above.comp
                    vrfa = above.ref[0] if a_sg else above.ref[var_idx]
                    vrfl = left.ref[0] if l_sg else left.ref[var_idx]
                    if vrfa == vrfl and cv[1] == vrfa:
                        ctx = 0
                    elif l_sg and a_sg:
                        if (vrfa == self.comp_fixed and vrfl == cv[0]) or \
                                (vrfl == self.comp_fixed and vrfa == cv[0]):
                            ctx = 4
                        elif vrfa == vrfl:
                            ctx = 3
                        else:
                            ctx = 1
                    elif l_sg or a_sg:
                        vrfc = vrfa if l_sg else vrfl
                        rfs = vrfa if a_sg else vrfl
                        if vrfc == cv[1] and rfs != cv[1]:
                            ctx = 1
                        elif rfs == cv[1] and vrfc != cv[1]:
                            ctx = 2
                        else:
                            ctx = 4
                    elif vrfa == vrfl:
                        ctx = 4
                    else:
                        ctx = 2
            elif ha or hl:
                e = above if ha else left
                if not e.inter:
                    ctx = 2
                elif e.comp:
                    ctx = 4 * int(e.ref[var_idx] != cv[1])
                else:
                    ctx = 3 * int(e.ref[0] != cv[1])
            else:
                ctx = 2
            bit = int(rng.integers(0, 2))
            bw.write(bit, int(fc["comp_ref"][ctx]))
            k["comp_ref"][ctx, bit] += 1
            m.ref = [0, 0]
            m.ref[fix_idx] = self.comp_fixed
            m.ref[var_idx] = cv[bit]
            return
        ref = int(rng.integers(1, 4))
        LAST, GOLDEN, ALTREF = 1, 2, 3
        if ha and hl:
            ai, li = not above.inter, not left.inter
            if ai and li:
                ctx = 2
            elif ai or li:
                e = left if ai else above
                ctx = 4 * int(e.ref[0] == LAST) if not e.comp else 1 + int(LAST in e.ref)
            else:
                a2, l2 = above.comp, left.comp
                a0, a1, l0, l1 = above.ref[0], above.ref[1], left.ref[0], left.ref[1]
                if a2 and l2:
                    ctx = 1 + int(LAST in (a0, a1, l0, l1))
                elif a2 or l2:
                    rfs = a0 if not a2 else l0
                    crf1, crf2 = (a0, a1) if a2 else (l0, l1)
                    if rfs == LAST:
                        ctx = 3 + int(LAST in (crf1, crf2))
                    else:
                        ctx = int(LAST in (crf1, crf2))
                else:
                    ctx = 2 * int(a0 == LAST) + 2 * int(l0 == LAST)
        elif ha or hl:
            e = above if ha else left
            if not e.inter:
                ctx = 2
            elif not e.comp:
                ctx = 4 * int(e.ref[0] == LAST)
            else:
                ctx = 1 + int(LAST in e.ref)
        else:
            ctx = 2
        bit0 = int(ref != LAST)
        bw.write(bit0, int(fc["single_ref"][ctx, 0]))
        k["single_ref"][ctx, 0, bit0] += 1
        m.ref = [ref, -1]
        if not bit0:
            return
        if ha and hl:
            ai, li = not above.inter, not left.inter
            if ai and li:
                ctx = 2
            elif ai or li:
                e = left if ai else above
                if not e.comp:
                    ctx = 3 if e.ref[0] == LAST else 4 * int(e.ref[0] == GOLDEN)
                else:
                    ctx = 1 + 2 * int(GOLDEN in e.ref)
            else:
                a2, l2 = above.comp, left.comp
                a0, a1, l0, l1 = above.ref[0], above.ref[1], left.ref[0], left.ref[1]
                if a2 and l2:
                    if a0 == l0 and a1 == l1:
                        ctx = 3 * int(GOLDEN in (a0, a1, l0, l1))
                    else:
                        ctx = 2
                elif a2 or l2:
                    rfs = a0 if not a2 else l0
                    crf1, crf2 = (a0, a1) if a2 else (l0, l1)
                    if rfs == GOLDEN:
                        ctx = 3 + int(GOLDEN in (crf1, crf2))
                    elif rfs == ALTREF:
                        ctx = int(GOLDEN in (crf1, crf2))
                    else:
                        ctx = 1 + 2 * int(GOLDEN in (crf1, crf2))
                else:
                    if a0 == LAST and l0 == LAST:
                        ctx = 3
                    elif a0 == LAST or l0 == LAST:
                        edge0 = l0 if a0 == LAST else a0
                        ctx = 4 * int(edge0 == GOLDEN)
                    else:
                        ctx = 2 * int(a0 == GOLDEN) + 2 * int(l0 == GOLDEN)
        elif ha or hl:
            e = above if ha else left
            if not e.inter or (e.ref[0] == LAST and not e.comp):
                ctx = 2
            elif not e.comp:
                ctx = 4 * int(e.ref[0] == GOLDEN)
            else:
                ctx = 3 * int(GOLDEN in e.ref)
        else:
            ctx = 2
        bit1 = int(ref == ALTREF)
        bw.write(bit1, int(fc["single_ref"][ctx, 1]))
        k["single_ref"][ctx, 1, bit1] += 1

    def _find_mv_refs(self, r, c, bs, ref_frame, block):
        """find_mv_refs: the two candidates (clamped) and the mode context."""
        lst = []
        done = False
        counter = 0
        found = False

        def add(mv):
            nonlocal done
            if lst:
                if mv != lst[0]:
                    lst.append(mv)
                    done = True
            else:
                lst.append(mv)

        def inside(rr, cc):
            return not (rr < 0 or cc < self.c0 or rr >= self.rows or cc >= self.c1)
        pos = MV_REF_BLOCKS[bs]
        for i in range(2):
            rr, cc = r + int(pos[i][0]), c + int(pos[i][1])
            if not inside(rr, cc):
                continue
            cand = self.mi[rr * self.cols + cc]
            counter += MODE_COUNTER[cand.mode]
            found = True
            if done:
                continue
            for w in (0, 1):
                if cand.ref[w] == ref_frame:
                    mv = cand.mv[w]
                    if block >= 0 and cand.sb < B8X8:
                        mv = cand.bmv[SUB_OF_COL[block][int(pos[i][1] == 0)]][w]
                    add(mv)
                    break
        for i in range(2, 8):
            if done:
                break
            rr, cc = r + int(pos[i][0]), c + int(pos[i][1])
            if not inside(rr, cc):
                continue
            cand = self.mi[rr * self.cols + cc]
            found = True
            if cand.ref[0] == ref_frame:
                add(cand.mv[0])
            elif cand.ref[1] == ref_frame:
                add(cand.mv[1])
        prev = self.prev_mvs[r * self.cols + c] if self.use_prev and self.prev_mvs else None
        if prev and not done:
            if prev[0] == ref_frame:
                add(prev[2])
            elif prev[1] == ref_frame:
                add(prev[3])

        def scaled(rf, mv):
            if self.sign_bias[rf] != self.sign_bias[ref_frame]:
                return (-mv[0], -mv[1])
            return mv
        if found and not done:
            for i in range(8):
                if done:
                    break
                rr, cc = r + int(pos[i][0]), c + int(pos[i][1])
                if not inside(rr, cc):
                    continue
                cand = self.mi[rr * self.cols + cc]
                if not cand.inter:
                    continue
                if cand.ref[0] != ref_frame:
                    add(scaled(cand.ref[0], cand.mv[0]))
                if not done and cand.comp and cand.ref[1] != ref_frame and cand.mv[1] != cand.mv[0]:
                    add(scaled(cand.ref[1], cand.mv[1]))
        if prev and not done:
            if prev[0] != ref_frame and prev[0] > 0:
                add(scaled(prev[0], prev[2]))
            if not done and prev[1] > 0 and prev[1] != ref_frame and prev[3] != prev[2]:
                add(scaled(prev[1], prev[3]))
        while len(lst) < 2:
            lst.append((0, 0))
        bw8, bh8 = NUM8W[bs], NUM8H[bs]
        le, re_ = -(c * 64) - 128, (self.cols - bw8 - c) * 64 + 128
        te, be = -(r * 64) - 128, (self.rows - bh8 - r) * 64 + 128
        lst = [(min(max(mv[0], te), be), min(max(mv[1], le), re_)) for mv in lst[:2]]
        return lst, COUNTER_TO_CTX[counter]

    # --- coefficients ------------------------------------------------------------------

    def _write_coefs(self, m, r, c, bs):
        w4, h4 = NUM8W[bs] * 2, NUM8H[bs] * 2
        end_x, end_y = min(2 * (self.cols - c), w4), min(2 * (self.rows - r), h4)
        ref = int(m.inter)
        anyc = False
        for p in range(3):
            ss = int(p > 0)
            tx = (0 if bs < B8X8 else min(m.tx, UV_MAX_TX[bs])) if ss else m.tx
            step, n = 1 << tx, 4 << tx
            ex, ey = end_x >> ss, end_y >> ss
            a0, l0 = (c * 2) >> ss, ((r & 7) * 2) >> ss
            a, l = self.above_nnz[p], self.left_nnz[p]
            for y in range(0, ey, step):
                for x in range(0, ex, step):
                    tx_type = 0
                    if not ss and not ref and not self.lossless and tx != 3:
                        mode = m.bmode[y * 2 + x] if (bs < B8X8 and tx == 0) else m.mode
                        tx_type = MODE_TX[mode]
                    actx = any(a[a0 + x + i] for i in range(step))
                    lctx = any(l[l0 + y + i] for i in range(step))
                    levels = self._levels(tx, tx_type, self.qmul[m.seg][ss])
                    self.stats["tx_type", tx, 4 if self.lossless else tx_type] += 1
                    eob = self._tokens(p, ref, tx, tx_type, int(actx) + int(lctx), levels)
                    anyc |= eob > 0
                    for i in range(step):
                        a[a0 + x + i] = int(eob > 0) if x + i < ex else 0
                        l[l0 + y + i] = int(eob > 0) if y + i < ey else 0
        return anyc

    def _levels(self, tx, tx_type, q):
        """Quantised levels (raster) of one tx block: the forward transform
        of a random bounded residual, or small WHT levels (lossless); all
        zero at the spec's rate."""
        rng, n = self.rng, 4 << tx
        if rng.random() > self.spec.p_coef:
            return np.zeros(n * n, np.int64)
        if self.lossless:
            lv = np.zeros(n * n, np.int64)
            k = int(rng.integers(1, 9))
            lv[rng.choice(16, k, replace=False)] = rng.integers(-20, 21, k)
            return lv
        amp = int(rng.integers(1, self.spec.amp + 1))
        res = rng.integers(-amp, amp + 1, (n, n)).astype(np.float64)
        if rng.random() < 0.5:  # smooth it
            k = np.ones(3) / 3
            res = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 0, res)
            res = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), 1, res)
        coef = forward(res, tx, tx_type).ravel()
        div = np.array([q[0]] + [q[1]] * (n * n - 1), np.float64)
        if tx == 3:
            div = div / 2
        lv = np.round(coef / div).astype(np.int64)
        # keep the first positions of the scan (an encoder's low frequencies)
        scan = SCANS[(tx, _kind(tx, tx_type))]
        keep = int(rng.integers(1, min(n * n, 64) + 1))
        mask = np.zeros(n * n, bool)
        mask[scan[:keep]] = True
        lv[~mask] = 0
        return np.clip(lv, -16000, 16000)

    def _tokens(self, plane, ref, tx, tx_type, ctx, levels):
        bw, fc, k = self.bw, self.fc, self.counts
        pt = int(plane > 0)
        probs = fc["coef"][tx, pt, ref]
        cnt, eobc = k["coef"][tx, pt, ref], k["eob"][tx, pt, ref]
        kind = _kind(tx, tx_type)
        scan, nb = SCANS[(tx, kind)], NEIGHBOURS[(tx, kind)]
        max_eob = 16 << (tx << 1)
        nz = np.flatnonzero(levels[scan])
        eob = int(nz[-1]) + 1 if len(nz) else 0
        cache = np.zeros(1024, np.int64)
        band_of = (lambda i: BAND4[i]) if tx == 0 else (lambda i: BAND8[i] if i < 21 else 5)
        c = 0
        check_eob = True
        while c < max_eob:
            band = band_of(c)
            p = probs[band, ctx]
            if check_eob:
                more = int(c < eob)
                bw.write(more, int(p[0]))
                eobc[band, ctx, more] += 1
                if not more:
                    break
            v = int(levels[scan[c]])
            rc = int(scan[c])
            if v == 0:
                bw.write(0, int(p[1]))
                cnt[band, ctx, 0] += 1
                cache[rc] = 0
                check_eob = False
            else:
                bw.write(1, int(p[1]))
                a = abs(v)
                if a == 1:
                    bw.write(0, int(p[2]))
                    cnt[band, ctx, 1] += 1
                    tok = 1
                else:
                    bw.write(1, int(p[2]))
                    cnt[band, ctx, 2] += 1
                    if a <= 4:
                        tok = a
                        bw.tree(TOKEN_TREE, T["kPareto"][p[2] - 1], tok)
                    else:
                        ci = max(i for i, (base, _) in enumerate(CATS) if a >= base)
                        base, cp = CATS[ci]
                        tok = 5 + ci
                        bw.tree(TOKEN_TREE, T["kPareto"][p[2] - 1], tok)
                        extra = a - base
                        nbits = len(cp)
                        for i in range(nbits):
                            bw.write((extra >> (nbits - 1 - i)) & 1, int(cp[i]))
                bw.write(int(v < 0), 128)
                self.stats["token", tok] += 1
                cache[rc] = ENERGY[tok]
                check_eob = True
            c += 1
            if c < max_eob:
                ctx = (1 + cache[nb[c][0]] + cache[nb[c][1]]) >> 1
        return eob

    # --- adaptation ----------------------------------------------------------------------

    def _adapt(self, ctx_idx, key, intra_only):
        p, k = self.saved[ctx_idx], self.counts
        uf = 112 if (key or intra_only or not self.last_key) else 128
        for t in range(4):
            for i in range(2):
                for j in range(2):
                    for b in range(6):
                        for c in range(3 if b == 0 else 6):
                            pp, e, n = p["coef"][t, i, j, b, c], k["eob"][t, i, j, b, c], k["coef"][t, i, j, b, c]
                            _adapt(pp, 0, e[0], e[1], 24, uf)
                            _adapt(pp, 1, n[0], n[1] + n[2], 24, uf)
                            _adapt(pp, 2, n[1], n[2], 24, uf)
        if self.intra:
            for name in ("skip", "tx32", "tx16", "tx8"):
                p[name] = self.fc[name].copy()
            return
        for i in range(3):
            _adapt(p["skip"], i, *k["skip"][i])
        for i in range(4):
            _adapt(p["intra_inter"], i, *k["intra_inter"][i])
        if self.ref_mode == 2:
            for i in range(5):
                _adapt(p["comp_inter"], i, *k["comp_inter"][i])
        if self.ref_mode != 0:
            for i in range(5):
                _adapt(p["comp_ref"], i, *k["comp_ref"][i])
        if self.ref_mode != 1:
            for i in range(5):
                for j in range(2):
                    _adapt(p["single_ref"][i], j, *k["single_ref"][i, j])
        for i in range(16):
            _tree_merge(PARTITION_TREE, p["partition"][i], k["partition"][i])
        if self.tx_mode == 4:
            for i in range(2):
                c8, c16, c32 = k["tx8"][i], k["tx16"][i], k["tx32"][i]
                _adapt(p["tx8"][i], 0, c8[0], c8[1])
                _adapt(p["tx16"][i], 0, c16[0], c16[1] + c16[2])
                _adapt(p["tx16"][i], 1, c16[1], c16[2])
                _adapt(p["tx32"][i], 0, c32[0], c32[1] + c32[2] + c32[3])
                _adapt(p["tx32"][i], 1, c32[1], c32[2] + c32[3])
                _adapt(p["tx32"][i], 2, c32[2], c32[3])
        if self.interp == 4:
            for i in range(4):
                _tree_merge(INTERP_TREE, p["interp"][i], k["interp"][i])
        for i in range(7):
            _tree_merge(INTER_MODE_TREE, p["inter_mode"][i], k["inter_mode"][i])
        _tree_merge(MV_JOINT_TREE, p["mv_joint"], k["mv_joint"])
        for i in range(2):
            _adapt(p["mv_sign"], i, *k["mv_sign"][i])
            _tree_merge(MV_CLASS_TREE, p["mv_classes"][i], k["mv_classes"][i])
            _adapt(p["mv_class0"][i], 0, *k["mv_class0"][i])
            for j in range(10):
                _adapt(p["mv_bits"][i], j, *k["mv_bits"][i, j])
            for j in range(2):
                _tree_merge(MV_FP_TREE, p["mv_class0_fp"][i, j], k["mv_class0_fp"][i, j])
            _tree_merge(MV_FP_TREE, p["mv_fp"][i], k["mv_fp"][i])
            if self.allow_hp:
                _adapt(p["mv_class0_hp"], i, *k["mv_class0_hp"][i])
                _adapt(p["mv_hp"], i, *k["mv_hp"][i])
        for i in range(4):
            _tree_merge(INTRA_MODE_TREE, p["y_mode"][i], k["y_mode"][i])
        for i in range(10):
            _tree_merge(INTRA_MODE_TREE, p["uv_mode"][i], k["uv_mode"][i])


def superframe(frames) -> bytes:
    """A sample of several frames with the superframe index after them."""
    sizes = [len(f) for f in frames]
    mag = max(1, (max(sizes).bit_length() + 7) // 8)
    marker = 0xC0 | ((mag - 1) << 3) | (len(frames) - 1)
    idx = bytes([marker]) + b"".join(s.to_bytes(mag, "little") for s in sizes) + bytes([marker])
    return b"".join(frames) + idx


@dataclasses.dataclass
class Clip:
    """A VP9 stream: its samples (each shows one frame, but for a lone
    hidden frame), which are key frames, and the writer's record of the
    header flags and block syntax it wrote."""
    width: int
    height: int
    samples: list
    sync: list
    flags: list = None
    stats: dict = None
    display = None  # frames come out in decode order

    def shown(self):
        return list(range(len(self.samples)))


# --- containers: the H.264 writer's muxers ------------------------------------------

def write_mkv(path, clip: Clip, fps=30):
    """Matroska with one V_VP9 track in SimpleBlocks, key frames flagged."""
    H.write_mkv(path, clip, fps, samples=clip.samples, codec=b"V_VP9")


def write_mp4(path, clip: Clip, fps=30):
    """ISO-BMFF with one vp09 track (vpcC: profile 0, level 1.0, 8 bits,
    4:2:0 colocated, BT.709 primaries, transfer and matrix)."""
    vpcc = H._full(b"vpcC", 1, 0, bytes([0, 10, (8 << 4) | (1 << 1), 1, 1, 1]) + b"\0\0")
    H.write_mp4(path, clip, fps, entry=b"vp09", samples=clip.samples, config=vpcc)


def write_avi(path, clip: Clip, fps=30):
    """RIFF AVI with one VP90 stream and an idx1 index (key frames flagged)."""
    H.write_avi(path, clip, fps, fourcc=b"VP90", samples=clip.samples)


MUX = {"mkv": write_mkv, "mp4": write_mp4, "avi": write_avi}


# --- random streams ----------------------------------------------------------------------

GROUPS = ("basic", "hidden", "compound", "adapt", "seg", "tiles")


def _random_spec(rng, kind="inter", **over):
    """A frame spec with random header choices of the basic tools."""
    s = FrameSpec(kind=kind)
    s.allow_hp = bool(rng.integers(0, 2))
    s.interp = int(rng.integers(0, 5))
    s.lf_level = int(rng.integers(0, 64))
    s.lf_sharp = int(rng.integers(0, 8))
    s.lf_delta = bool(rng.integers(0, 2))
    if s.lf_delta and rng.random() < 0.5:
        s.lf_update = {"ref": {int(i): int(rng.integers(-63, 64)) for i in rng.choice(4, 2, replace=False)},
                       "mode": {int(rng.integers(0, 2)): int(rng.integers(-63, 64))}}
    s.base_q = int(rng.integers(1, 256))
    s.tx_mode = int(rng.integers(0, 5))
    s.updates = float(rng.choice([0.0, 0.01, 0.05]))
    s.p_split = float(rng.uniform(0.3, 0.8))
    s.p_intra = float(rng.uniform(0.0, 0.4))
    s.p_skip = float(rng.uniform(0.0, 0.4))
    s.ref_idx = tuple(int(v) for v in rng.choice(8, 3, replace=False))
    s.refresh = int(rng.integers(0, 256))
    s.ctx_idx = int(rng.integers(0, 4))
    s.color = (int(rng.integers(0, 6)), int(rng.integers(0, 2)))
    if s.base_q % 5 == 0:  # a render size (FFmpeg puts out the frame size)
        s.render = (s.base_q + 1, s.lf_level + 1)
    for k, v in over.items():
        setattr(s, k, v)
    return s


def random_stream(seed, group="basic", width=None, height=None, frames=6):
    """A stream of random legal syntax exercising one tool group (see
    GROUPS): every sample shows one frame."""
    rng = np.random.default_rng(seed)
    if width is None:
        width, height = ((520, 72) if group == "tiles" else
                         (int(rng.integers(33, 97)), 2 * int(rng.integers(13, 37))))
    sw = StreamWriter(width, height, seed=seed + 1)
    samples, sync = [], []

    def emit(data, key=False):
        samples.append(data)
        sync.append(key)
    key = _random_spec(rng, "key")
    if group == "tiles":
        key.tile_cols, key.tile_rows = int(rng.integers(0, 2)), int(rng.integers(0, 3))
    if group == "adapt":
        key.parallel = False
    if group == "seg":
        key.seg = _random_seg(rng, intra=True)
    emit(sw.frame(key), True)
    hidden_slot = None
    for i in range(1, frames):
        s = _random_spec(rng)
        if group == "tiles":
            s.tile_cols, s.tile_rows = int(rng.integers(0, 2)), int(rng.integers(0, 3))
            s.size_from_ref = int(rng.integers(-1, 3))
        if group == "hidden":
            s.size_from_ref = int(rng.integers(-1, 3))
            if hidden_slot is not None and rng.random() < 0.4:
                emit(sw.frame(None, show_existing=hidden_slot))
                hidden_slot = None
                continue
            if rng.random() < 0.6:
                arf = _random_spec(rng, show=False, refresh=1 << 6)
                a = sw.frame(arf)
                emit(superframe([a, sw.frame(s)]))
                hidden_slot = 6
                continue
        if group == "compound":
            # ALTREF, GOLDEN or LAST as the fixed compound reference
            s.sign_bias = ((0, 0, 1), (0, 1, 0), (0, 1, 1), (1, 0, 0))[int(rng.integers(0, 4))]
            s.ref_mode = int(rng.integers(0, 3))
        if group == "adapt":
            s.parallel = bool(rng.random() < 0.3)
            s.refresh_ctx = bool(rng.random() < 0.8)
            s.reset_ctx = int(rng.integers(0, 4))
            s.error_res = bool(rng.random() < 0.25)
            if rng.random() < 0.35:
                io = _random_spec(rng, "intra_only", show=False, parallel=bool(rng.random() < 0.3),
                                  reset_ctx=int(rng.integers(0, 4)), refresh=int(rng.integers(1, 256)))
                a = sw.frame(io)
                emit(superframe([a, sw.frame(s)]))
                continue
        if group == "seg":
            s.seg = _random_seg(rng)
            if rng.random() < 0.3:
                s.base_q, s.dq = 0, (0, 0, 0)
            elif rng.random() < 0.5:
                s.dq = tuple(int(v) for v in rng.integers(-15, 16, 3))
        if group == "compound" and rng.random() < 0.5:
            arf = _random_spec(rng, show=False, refresh=1 << int(rng.integers(0, 8)))
            if group == "compound":
                arf.sign_bias = (0, 0, 1)
                arf.ref_mode = int(rng.integers(0, 3))
            a = sw.frame(arf)
            emit(superframe([a, sw.frame(s)]))
            continue
        emit(sw.frame(s))
    return Clip(width, height, samples, sync, sw.flags, sw.stats)


def _random_seg(rng, intra=False):
    seg = {"update_map": intra or rng.random() < 0.7,
           "tree": [int(v) if rng.random() < 0.7 else 255 for v in rng.integers(1, 256, 7)],
           "temporal": rng.random() < 0.6,
           "pred": [int(v) if rng.random() < 0.7 else 255 for v in rng.integers(1, 256, 3)]}
    if intra or rng.random() < 0.6:
        absolute = bool(rng.random() < 0.3)
        data = {}
        for i in range(8):
            if rng.random() < 0.5:
                data[(i, 0)] = int(rng.integers(0, 256)) if absolute else int(rng.integers(-255, 256))
            if rng.random() < 0.4:
                data[(i, 1)] = int(rng.integers(0, 64)) if absolute else int(rng.integers(-63, 64))
            if rng.random() < 0.3:
                data[(i, 2)] = int(rng.integers(0, 4))
            if rng.random() < 0.2:
                data[(i, 3)] = 0
        seg["data"], seg["abs"] = data, absolute
    return seg


# --- what the port's decoder refuses -------------------------------------------------

REFUSED = ("profile 1", "profile 2", "profile 3", "scaled reference frames",
           "a frame size change mid-stream", "an odd frame height",
           "the reserved colour space 6", "the RGB colour space in profile 0")


def refused_clip(feature, seed=0):
    """A small stream whose first or second frame uses one of REFUSED."""
    sw = StreamWriter(64, 48, seed=seed)
    if feature.startswith("profile"):
        p = int(feature[-1])
        bw = BitWriter()
        bw.f(2, 2)
        bw.f(p & 1, 1)
        bw.f(p >> 1, 1)
        if p == 3:
            bw.f(0, 1)
        bw.f(0, 4)
        return Clip(64, 48, [bw.bytes() + b"\0" * 16], [True])
    if feature == "an odd frame height":
        sw = StreamWriter(64, 47, seed=seed)
        return Clip(64, 47, [sw.frame(FrameSpec(kind="key"))], [True])
    if feature.startswith("the "):
        cs = 6 if "reserved" in feature else 7
        return Clip(64, 48, [sw.frame(FrameSpec(kind="key", color=(cs, 0)))], [True])
    first = sw.frame(FrameSpec(kind="key"))
    if feature == "scaled reference frames":
        sw.w, sw.h = 80, 48  # the header names a size its references lack
        second = sw.frame(FrameSpec(kind="inter"))
    else:
        second = StreamWriter(80, 48, seed=seed).frame(FrameSpec(kind="key"))
    return Clip(64, 48, [first, second], [True, False])
