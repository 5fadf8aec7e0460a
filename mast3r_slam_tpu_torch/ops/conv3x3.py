"""3x3 stride-1 SAME convolution (kernel K2) and its plain version.

Counterpart of ``mast3r_slam_tpu/ops/conv3x3.py::conv3x3``: NHWC
activations, HWIO weights ``(3, 3, Cin, Cout)``, optional bias, f32
accumulation, the result cast to x's dtype. On a CUDA tensor
:func:`conv3x3` launches a hand-written kernel in ``csrc/conv3x3.cu`` for
any channel counts (the TPU kernel's lane-alignment gate does not apply),
on one of four paths picked by type and shape (:func:`conv3x3_path`):

- ``"igemm"``: bfloat16 with Cin and Cout multiples of 8 (every DPT conv),
  the implicit GEMM on ``wgmma`` with a cp.async ring, split over K by
  :func:`plan` where the output tiles alone do not fill the card;
- ``"mma"``: other bfloat16 shapes, the first tensor-core design;
- ``"tf32x3"``: float32 with Cin and Cout multiples of 8 (every DPT conv
  of an f32 head), the implicit GEMM on ``wgmma`` in 3xTF32 (each operand
  split into TF32 hi and lo parts, three products), float32-accurate, split
  over K by :func:`plan` with its own tile;
- ``"fma"``: other float32 shapes, the first design on the CUDA cores.

On a CPU tensor it returns :func:`conv3x3_ref`. :func:`conv3x3_split_ref`
is the plain version of the split-K order, :func:`conv3x3_tf32x3_ref` of
the 3xTF32 arithmetic.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from mast3r_slam_tpu_torch import _build
from mast3r_slam_tpu_torch.ops.tf32 import tf32_split

KERNEL = "conv3x3"
PATHS = ("igemm", "mma", "tf32x3", "fma")
counter = _build.LaunchCounter()
path_counters = {p: _build.LaunchCounter() for p in PATHS}

# the implicit GEMM's output tile (rows x columns x Cout) and K step (input
# channels of one tap), as in csrc/conv3x3.cu
TILE_H, TILE_W, TILE_N, TILE_K = 8, 16, 128, 64
# (Cout, K step) of each split-K path's tile (rows x columns as above)
TILES = {"igemm": (TILE_N, TILE_K), "tf32x3": (64, 32)}


@dataclasses.dataclass(frozen=True)
class Plan:
    """Grid of the implicit GEMM: ``tiles_m x tiles_n`` output tiles, each
    split into ``splits`` blocks over the ``kiters`` K chunks."""

    tiles_m: int
    tiles_n: int
    kiters: int
    splits: int

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.splits

    def k_range(self, split: int) -> tuple[int, int]:
        """K chunks ``[lo, hi)`` of split ``split`` (the kernel's formula)."""
        return (split * self.kiters // self.splits,
                (split + 1) * self.kiters // self.splits)


def plan(bsz, h, w, cin, cout, n_sm, tile_n=TILE_N, tile_k=TILE_K) -> Plan:
    """Split K only where the output tiles give fewer blocks than the card
    has SMs: then aim at 4/3 blocks an SM (one wave at two resident blocks
    an SM) with at least 6 K steps a block, and never fall under one block
    an SM. ``tile_n`` / ``tile_k``: the path's tile (:data:`TILES`)."""
    tiles_m = bsz * -(-h // TILE_H) * -(-w // TILE_W)
    tiles_n = -(-cout // tile_n)
    kiters = 9 * -(-cin // tile_k)
    tiles = tiles_m * tiles_n
    splits = 1
    if tiles < n_sm:
        splits = min(-(-4 * n_sm // (3 * tiles)), max(1, kiters // 6))
        if tiles * splits < n_sm:
            splits = min(-(-n_sm // tiles), kiters)
    return Plan(tiles_m, tiles_n, kiters, splits)


def conv3x3_path(dtype, cin, cout) -> str:
    """The kernel path a CUDA call takes, by type and channel counts."""
    aligned = cin % 8 == 0 and cout % 8 == 0
    if dtype == torch.float32:
        return "tf32x3" if aligned else "fma"
    return "igemm" if aligned else "mma"


def conv3x3_ref(x, w, b=None):
    """Plain version: nine shifted ``(pixels, Cin) @ (Cin, Cout)`` products
    of the zero-padded input, accumulated in f32; the bias (cast to x's
    dtype, as the kernel reads it) is added in f32 before one cast."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.to(x.dtype).float()
    acc = torch.zeros(bsz * h * wd, cout, dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            xs = xp[:, dy:dy + h, dx:dx + wd, :].reshape(-1, cin)
            acc = acc + xs @ wf[dy, dx]
    if b is not None:
        acc = acc + b.to(x.dtype).float()
    return acc.to(x.dtype).reshape(bsz, h, wd, cout)


def conv3x3_split_ref(x, w, b, p: Plan):
    """Plain version of the split-K order: the K steps (step ``9 * chunk +
    tap``: ``TILE_K`` input channels of one tap) cut as ``p.k_range``; each
    split's f32 partial sum, the partials added in split order, the bias in
    f32, one cast."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.to(x.dtype).float()
    total = None
    for s in range(p.splits):
        part = torch.zeros(bsz * h * wd, cout, dtype=torch.float32,
                           device=x.device)
        for it in range(*p.k_range(s)):
            chunk, tap = divmod(it, 9)
            dy, dx = divmod(tap, 3)
            c0 = chunk * TILE_K
            c1 = min(c0 + TILE_K, cin)
            xs = xp[:, dy:dy + h, dx:dx + wd, c0:c1].reshape(-1, c1 - c0)
            part = part + xs @ wf[dy, dx, c0:c1]
        total = part if total is None else total + part
    if b is not None:
        total = total + b.to(x.dtype).float()
    return total.to(x.dtype).reshape(bsz, h, wd, cout)


def conv3x3_tf32x3_ref(x, w, b=None):
    """Plain version of the ``"tf32x3"`` arithmetic (float32 ``x``, ``w``):
    x and w split into TF32 parts (:func:`~.tf32.tf32_split`), the nine
    shifted products ``lo_x hi_w + hi_x lo_w + hi_x hi_w`` of the
    zero-padded input summed in float64 (each product of TF32 values is
    exact there) and rounded to float32 once; the bias added in f32."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    xh, xl = (F.pad(t, (0, 0, 1, 1, 1, 1)).double()
              for t in tf32_split(x.float()))
    wh, wl = (t.double() for t in tf32_split(w.float()))
    acc = torch.zeros(bsz * h * wd, cout, dtype=torch.float64,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            sh, sl = (t[:, dy:dy + h, dx:dx + wd, :].reshape(-1, cin)
                      for t in (xh, xl))
            acc += sl @ wh[dy, dx] + sh @ wl[dy, dx] + sh @ wh[dy, dx]
    out = acc.float()
    if b is not None:
        out = out + b.float()
    return out.reshape(bsz, h, wd, cout)


def conv3x3(x, w, b=None, *, path=None):
    """NHWC 3x3 stride-1 SAME conv (see module docstring). ``path`` forces
    one kernel path (kernel timing and tests); by default the shape picks
    it."""
    if x.device.type == "cpu":
        return conv3x3_ref(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    bsz, h, wd, cin = x.shape
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got "
                         f"{tuple(w.shape)}")
    cout = w.shape[-1]
    path = path or conv3x3_path(x.dtype, cin, cout)
    if path not in PATHS or ((path in ("fma", "tf32x3"))
                             != (x.dtype == torch.float32)):
        raise ValueError(f"path {path!r} does not take {x.dtype}")
    if path in TILES and (cin % 8 or cout % 8):
        raise ValueError(f"the implicit GEMM takes Cin, Cout multiples of "
                         f"8, got {cin}, {cout}")
    x = x.contiguous()
    w = w.to(x.dtype).contiguous()
    if b is not None:
        if b.shape != (cout,):
            raise ValueError(f"bias must be ({cout},), got {tuple(b.shape)}")
        b = b.to(x.dtype).contiguous()
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("x, w and b must be on one device")
    x, w, b = (_build.aligned(t) for t in (x, w, b))
    y = torch.empty(bsz, h, wd, cout, dtype=x.dtype, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bias = None if b is None else b.data_ptr()
    ws = wsplit = None
    if path in TILES:
        p = plan(bsz, h, wd, cin, cout, _build.sm_count(x.device),
                 *TILES[path])
        if p.splits > 1:
            ws = torch.empty(p.splits, bsz * h * wd, cout,
                             dtype=torch.float32, device=x.device)
        if path == "tf32x3":
            wsplit = torch.empty(2, 9, cout, cin, dtype=torch.float32,
                                 device=x.device)
    ws_ptr = None if ws is None else ws.data_ptr()
    # the C launchers run on the current device: make it the tensors'
    with torch.cuda.device(x.device):
        if path == "igemm":
            err = lib.conv3x3_igemm(
                x.data_ptr(), w.data_ptr(), bias, y.data_ptr(), ws_ptr, bsz,
                h, wd, cin, cout, p.splits, stream)
        elif path == "tf32x3":
            err = lib.conv3x3_tf32x3(
                x.data_ptr(), w.data_ptr(), bias, y.data_ptr(),
                wsplit.data_ptr(), ws_ptr, bsz, h, wd, cin, cout, p.splits,
                stream)
        else:
            err = lib.conv3x3_nhwc(
                0 if path == "fma" else 1, x.data_ptr(), w.data_ptr(), bias,
                y.data_ptr(), bsz, h, wd, cin, cout, stream)
    _build.check(lib, KERNEL, err)
    counter.add()
    path_counters[path].add()
    return y


def tf32_split_weights(w):
    """The ``"tf32x3"`` path's weight pre-pass alone on a CUDA tensor (for
    timing; no launch counter): float32 ``(2, 9, Cout, Cin)``, the TF32 hi
    and lo parts of ``w (3, 3, Cin, Cout)`` by (tap, Cout, Cin)."""
    if w.device.type != "cuda" or w.dtype != torch.float32 or w.ndim != 4:
        raise ValueError("w must be a float32 (3, 3, Cin, Cout) CUDA tensor")
    _, _, cin, cout = w.shape
    w = _build.aligned(w.contiguous())
    out = torch.empty(2, 9, cout, cin, dtype=torch.float32, device=w.device)
    lib = _lib()
    with torch.cuda.device(w.device):
        err = lib.conv3x3_tf32_split(
            w.data_ptr(), out.data_ptr(), cin, cout,
            torch.cuda.current_stream(w.device).cuda_stream)
    _build.check(lib, KERNEL, err)
    return out


def tf32_round_on_card(x):
    """``cvt.rna.tf32.f32`` of a float32 CUDA tensor by the card itself
    (test support: :func:`~.tf32.tf32_round` is held against it)."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError("x must be a float32 CUDA tensor")
    x = _build.aligned(x.contiguous())
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.conv3x3_tf32_round(
            x.data_ptr(), y.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, KERNEL, err)
    return y


_P, _I = ctypes.c_void_p, ctypes.c_int
# ctypes signatures of csrc/conv3x3.cu's C entries
ENTRIES = {
    "conv3x3_nhwc": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "conv3x3_igemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "conv3x3_tf32x3": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "conv3x3_tf32_split": [_P, _P, _I, _I, _P],
    "conv3x3_tf32_round": [_P, _P, _I, _P],
}


def _lib():
    return _build.load(KERNEL, ENTRIES)
