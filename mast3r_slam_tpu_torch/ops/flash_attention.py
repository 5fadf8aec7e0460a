"""Flash attention with in-kernel 2D RoPE (kernel K1), flash attention
without RoPE (kernel K3), and their plain versions.

Counterpart of ``mast3r_slam_tpu/ops/flash_attention.py::
flash_attention_rope`` and ``flash_attention``. On a CUDA tensor
:func:`flash_attention_rope` and :func:`flash_attention` launch the
hand-written kernel in ``csrc/flash_attention_rope.cu`` (K3 is its instance
with RoPE switched off at compile time); on a CPU tensor they return
:func:`flash_attention_rope_ref` / :func:`flash_attention_ref`, which do the
same f32 math with ordinary torch ops. The TPU kernels' tiling (single-block
vs 128x128 configs) is not carried over: the CUDA kernel tiles 64 q rows per
block and masks ragged lengths, so any Nq and Nk work.
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
    return (p @ v.float()).to(q.dtype)


def flash_attention_rope(q, k, v, cos_q, sin_q, cos_k, sin_k):
    """Flash attention with in-kernel RoPE (see module docstring)."""
    if q.device.type == "cpu":
        return flash_attention_rope_ref(q, k, v, cos_q, sin_q, cos_k, sin_k)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d != 64:
        raise ValueError(f"the CUDA kernel takes head dim 64, got {d}")
    if k.shape != (b, h, nk, d) or v.shape != k.shape:
        raise ValueError(f"bad k/v shapes {tuple(k.shape)}/{tuple(v.shape)}")
    for name, t, n in (("cos_q", cos_q, nq), ("sin_q", sin_q, nq),
                       ("cos_k", cos_k, nk), ("sin_k", sin_k, nk)):
        if t.shape != (b, n, d) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {(b, n, d)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    tensors = [_build.aligned(t.contiguous())
               for t in (q, k, v, cos_q, sin_q, cos_k, sin_k)]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    out = torch.empty_like(tensors[0])
    lib = _lib()
    err = lib.flash_attention_rope(
        _DTYPES[q.dtype], *(t.data_ptr() for t in tensors), out.data_ptr(),
        b * h, h, nq, nk, d, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, KERNEL, err)
    counter.add()
    return out


def flash_attention_ref(q, k, v):
    """Plain version of K3 (the TPU ``_flash_kernel``'s math): ``q (B, H,
    Nq, D)``, ``k, v (B, H, Nk, D)``; q is scaled by 1/sqrt(D) before
    ``q kᵀ``, softmax and ``p v`` run in f32, the output is in q's dtype."""
    d = q.shape[-1]
    s = (q.float() * (1.0 / math.sqrt(d))) @ k.float().transpose(-1, -2)
    p = torch.softmax(s, dim=-1)
    return (p @ v.float()).to(q.dtype)


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
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if d != 64:
        raise ValueError(f"the CUDA kernel takes head dim 64, got {d}")
    if k.shape != (b, h, nk, d) or v.shape != k.shape:
        raise ValueError(f"bad k/v shapes {tuple(k.shape)}/{tuple(v.shape)}")
    tensors = [_build.aligned(t.contiguous()) for t in (q, k, v)]
    if any(t.device != q.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    out = torch.empty_like(tensors[0])
    lib = _lib()
    err = lib.flash_attention(
        _DTYPES[q.dtype], *(t.data_ptr() for t in tensors), out.data_ptr(),
        b * h, nq, nk, d, 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, KERNEL, err)
    attn_counter.add()
    return out


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.flash_attention_rope
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int, p, p, p, p, p, p, p, p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
        p3 = lib.flash_attention
        p3.argtypes = [ctypes.c_int, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, p]
        p3.restype = ctypes.c_int
    return lib
