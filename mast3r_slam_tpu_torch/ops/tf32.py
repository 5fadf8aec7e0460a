"""TF32 rounding and the 3xTF32 split of float32 operands, in plain form.

The tensor-core float32 paths (K2's ``"tf32x3"`` in
``csrc/conv3x3.cu``, the BA Gram's ``"tf32"`` in ``csrc/ba_gram.cu``) split
each float32 operand ``a`` into ``hi = cvt.rna.tf32.f32(a)`` and ``lo =
cvt.rna.tf32.f32(a - hi)`` and take a product ``a b`` as ``lo_a hi_b + hi_a
lo_b + hi_a hi_b``. :func:`tf32_round` is ``cvt.rna.tf32.f32`` as an
H100 computes it, on the float32 bits: the 10 explicit mantissa bits kept,
rounded to nearest with ties away from zero; subnormals round on the same
grid and a value past the largest TF32 rounds to infinity; an infinity or
a NaN has its 13 low bits cleared, so a NaN whose payload lies only there
becomes an infinity (the card's own result, checked bit for bit by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""

from __future__ import annotations

import torch

_HALF = 1 << 12          # half a TF32 ulp in float32 mantissa bits
_KEEP = -(1 << 13)       # the mask that clears the 13 dropped bits
_EXP_ALL = 0x7F800000    # the exponent field of infinities and NaN


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of float32 ``x``, as float32."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    b = x.contiguous().view(torch.int32)
    mag = b & 0x7FFFFFFF
    rounded = ((mag + _HALF) & _KEEP) | (b & (-(1 << 31)))
    return torch.where(mag >= _EXP_ALL, b & _KEEP,
                       rounded).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``: ``hi = tf32_round(x)``, ``lo = tf32_round(x - hi)``
    (``x - hi`` is exact in float32)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)
