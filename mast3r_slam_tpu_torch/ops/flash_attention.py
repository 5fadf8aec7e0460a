"""Flash attention with in-kernel 2D RoPE (kernel K1), flash attention
without RoPE (kernel K3), and their plain versions.

Counterpart of ``mast3r_slam_tpu/ops/flash_attention.py::
flash_attention_rope`` and ``flash_attention``. On a CUDA tensor
:func:`flash_attention_rope` and :func:`flash_attention` launch the
hand-written kernels in ``csrc/flash_attention_rope.cu`` (K3 is their
instance with RoPE switched off at compile time); on a CPU tensor they
return :func:`flash_attention_rope_ref` / :func:`flash_attention_ref`, which
do the same f32 math with ordinary torch ops. The TPU kernels' tiling
(single-block vs 128x128 configs) is not carried over: the CUDA kernels mask
ragged lengths, so any Nq and Nk work.

Layouts: q, k and v are ``(B, H, N, 64)`` tensors of any strides; in bf16
the kernel reads them through their strides (the model's head split stays
a view) and the result is a ``(B, H, N, 64)`` view of a token-major
``(B, N, H, 64)`` buffer, so merging the heads back is a view too. The
plain versions return the same layout; the f32 kernel path (CUDA cores)
takes contiguous copies and returns a contiguous ``(B, H, N, 64)`` tensor.
"""

from __future__ import annotations

import ctypes
import math

import torch

from mast3r_slam_tpu_torch import _build

KERNEL = "flash_attention_rope"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
counter = _build.LaunchCounter()          # K1
attn_counter = _build.LaunchCounter()     # K3
# q rows a block of the pipelined kernel (csrc/flash_attention_rope.cu)
BLOCK_Q = 48


def rope_tables(pos, d, base=100.0):
    """Full-width 2D-RoPE cos/sin tables: ``pos (B, N, 2)`` integer (y, x)
    → ``(cos, sin)`` each ``(B, N, D)`` f32, quarters ``[y, y, x, x]``."""
    half = d // 2
    quarter = half // 2
    inv_freq = 1.0 / (base ** (
        torch.arange(0, quarter, dtype=torch.float32, device=pos.device)
        * 2.0 / half))
    fy = pos[..., 0:1].to(torch.float32) * inv_freq
    fx = pos[..., 1:2].to(torch.float32) * inv_freq
    cos = torch.cat([fy.cos(), fy.cos(), fx.cos(), fx.cos()], dim=-1)
    sin = torch.cat([fy.sin(), fy.sin(), fx.sin(), fx.sin()], dim=-1)
    return cos, sin


def rope_rotate(t, cos, sin):
    """2D-RoPE rotation of f32 ``t (..., D)`` by full-width tables
    broadcastable to it: ``t * cos + rot * sin`` with
    ``rot = [-t2, t1, -t4, t3]`` over D/4 quarters."""
    t1, t2, t3, t4 = t.chunk(4, dim=-1)
    rot = torch.cat([-t2, t1, -t4, t3], dim=-1)
    return t * cos + rot * sin


def flash_attention_rope_ref(q, k, v, cos_q, sin_q, cos_k, sin_k):
    """Plain version of the kernel: ``q (B, H, Nq, D)``, ``k, v (B, H, Nk,
    D)`` un-rotated, tables ``(B, N, D)`` f32 shared across heads. Rotates
    in f32, scales q by 1/sqrt(D), softmax in f32, output in q's dtype."""
    d = q.shape[-1]
    sm_scale = 1.0 / math.sqrt(d)
    qr = rope_rotate(q.float(), cos_q[:, None], sin_q[:, None]) * sm_scale
    kr = rope_rotate(k.float(), cos_k[:, None], sin_k[:, None])
    s = qr @ kr.transpose(-1, -2)
    p = torch.softmax(s, dim=-1)
    return token_major((p @ v.float()).to(q.dtype))


def token_major(o):
    """``o (B, H, N, D)`` as a view of a token-major ``(B, N, H, D)``
    buffer (the layout the bf16 kernel writes)."""
    return o.transpose(1, 2).contiguous().transpose(1, 2)


def _check_qkv(q, k, v):
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d != 64:
        raise ValueError(f"the CUDA kernel takes head dim 64, got {d}")
    if k.shape != (b, h, nk, d) or v.shape != k.shape:
        raise ValueError(f"bad k/v shapes {tuple(k.shape)}/{tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("all inputs must be on one device")
    return b, h, nq, nk, d


def _strided(t):
    """``t`` itself when the kernel can read it through its strides (last
    dimension contiguous, 16-byte aligned rows), else a contiguous copy."""
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in t.stride()[:-1])):
        return t
    return _build.aligned(t.contiguous())


def _pipelined(q, k, v, tables):
    """Launch the pipelined bf16 body (RoPE when ``tables`` is given) and
    return the token-major output as a ``(B, H, Nq, 64)`` view."""
    b, h, nq, nk, d = _check_qkv(q, k, v)
    q, k, v = (_strided(t) for t in (q, k, v))
    out = torch.empty(b, nq, h, d, dtype=q.dtype, device=q.device)
    o = out.transpose(1, 2)
    k_rot = (torch.empty(b * h, nk, d, dtype=q.dtype, device=q.device)
             if tables is not None else None)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    lib = _lib()
    tables = [] if tables is None else [_build.aligned(t.contiguous())
                                        for t in tables]
    tabs = [t.data_ptr() for t in tables] or [None] * 4
    # the C launcher runs on the current device: make it the tensors'
    with torch.cuda.device(q.device):
        err = lib.flash_attention_bf16(
            int(bool(tables)), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *tabs, out.data_ptr(),
            None if k_rot is None else k_rot.data_ptr(), strides, b, h, nq,
            nk, d, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, KERNEL, err)
    return o


def _contiguous(entry, q, k, v, tables):
    """The f32 CUDA-core body, or with bf16 inputs the first tensor-core
    design (K rotated by every q tile): contiguous copies in, a contiguous
    ``(B, H, Nq, 64)`` tensor out."""
    b, h, nq, nk, d = _check_qkv(q, k, v)
    tensors = [_build.aligned(t.contiguous()) for t in (q, k, v)]
    out = torch.empty_like(tensors[0])
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    tabs = ([_build.aligned(t.contiguous()) for t in tables]
            if entry == "rope" else [])
    with torch.cuda.device(q.device):
        if entry == "rope":
            err = lib.flash_attention_rope(
                _DTYPES[q.dtype], *(t.data_ptr() for t in tensors + tabs),
                out.data_ptr(), b * h, h, nq, nk, d, 1.0 / math.sqrt(d),
                stream)
        else:
            err = lib.flash_attention(
                _DTYPES[q.dtype], *(t.data_ptr() for t in tensors),
                out.data_ptr(), b * h, nq, nk, d, 1.0 / math.sqrt(d), stream)
    _build.check(lib, KERNEL, err)
    return out


def first_design_rope(q, k, v, cos_q, sin_q, cos_k, sin_k):
    """K1's first bf16 kernel on CUDA tensors (timing only; no path and no
    launch counter)."""
    return _contiguous("rope", q, k, v, (cos_q, sin_q, cos_k, sin_k))


def first_design_attention(q, k, v):
    """K3's first bf16 kernel on CUDA tensors (timing only)."""
    return _contiguous("plain", q, k, v, None)


def flash_attention_rope(q, k, v, cos_q, sin_q, cos_k, sin_k):
    """Flash attention with in-kernel RoPE (see module docstring)."""
    if q.device.type == "cpu":
        return flash_attention_rope_ref(q, k, v, cos_q, sin_q, cos_k, sin_k)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, nq, nk, d = _check_qkv(q, k, v)
    tables = (cos_q, sin_q, cos_k, sin_k)
    for name, t, n in zip(("cos_q", "sin_q", "cos_k", "sin_k"), tables,
                          (nq, nq, nk, nk)):
        if t.shape != (b, n, d) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(b, n, d)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
    if q.dtype == torch.bfloat16:
        out = _pipelined(q, k, v, tables)
    else:
        out = _contiguous("rope", q, k, v, tables)
    counter.add()
    return out


def flash_attention_ref(q, k, v):
    """Plain version of K3 (the TPU ``_flash_kernel``'s math): ``q (B, H,
    Nq, D)``, ``k, v (B, H, Nk, D)``; q is scaled by 1/sqrt(D) before
    ``q kᵀ``, softmax and ``p v`` run in f32, the output is in q's dtype."""
    d = q.shape[-1]
    s = (q.float() * (1.0 / math.sqrt(d))) @ k.float().transpose(-1, -2)
    p = torch.softmax(s, dim=-1)
    return token_major((p @ v.float()).to(q.dtype))


def attention_reference(q, k, v):
    """Plain softmax attention as the JAX ``attention_reference``: logits
    accumulate in f32, the softmax weights are cast to v's dtype before
    ``p v`` (so in bf16 this is not :func:`flash_attention_ref`)."""
    d = q.shape[-1]
    logits = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return (weights.float() @ v.float()).to(v.dtype)


def flash_attention(q, k, v):
    """Flash attention without RoPE, kernel K3 (see module docstring):
    ``q (B, H, Nq, D)``, ``k, v (B, H, Nk, D)`` → ``(B, H, Nq, D)``."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype == torch.bfloat16:
        out = _pipelined(q, k, v, None)
    else:
        out = _contiguous("plain", q, k, v, None)
    attn_counter.add()
    return out


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ctypes signatures of csrc/flash_attention_rope.cu's C entries
ENTRIES = {
    "flash_attention_rope": [_I] + [_P] * 8 + [_I] * 5 + [_F, _P],
    "flash_attention": [_I] + [_P] * 4 + [_I] * 4 + [_F, _P],
    "flash_attention_bf16": ([_I] + [_P] * 9
                             + [ctypes.POINTER(ctypes.c_longlong)]
                             + [_I] * 5 + [_F, _P]),
}


def _lib():
    return _build.load(KERNEL, ENTRIES)
