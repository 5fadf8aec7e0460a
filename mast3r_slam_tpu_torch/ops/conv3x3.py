"""3x3 stride-1 SAME convolution (kernel K2) and its plain version.

Counterpart of ``mast3r_slam_tpu/ops/conv3x3.py::conv3x3``: NHWC
activations, HWIO weights ``(3, 3, Cin, Cout)``, optional bias, f32
accumulation, the result cast to x's dtype. On a CUDA tensor
:func:`conv3x3` launches the hand-written kernel in ``csrc/conv3x3.cu``
for any channel counts (the TPU kernel's lane-alignment gate does not
apply): CUDA cores for float32, tensor cores for bfloat16. On a CPU tensor
it returns :func:`conv3x3_ref`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from mast3r_slam_tpu_torch import _build

KERNEL = "conv3x3"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
counter = _build.LaunchCounter()


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


def conv3x3(x, w, b=None):
    """NHWC 3x3 stride-1 SAME conv (see module docstring)."""
    if x.device.type == "cpu":
        return conv3x3_ref(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    bsz, h, wd, cin = x.shape
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, cin):
        raise ValueError(f"w must be (3, 3, {cin}, Cout), got "
                         f"{tuple(w.shape)}")
    cout = w.shape[-1]
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
    err = lib.conv3x3_nhwc(
        _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(),
        None if b is None else b.data_ptr(), y.data_ptr(), bsz, h, wd, cin,
        cout, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, KERNEL, err)
    counter.add()
    return y


def _lib():
    lib = _build.load(KERNEL)
    fn = lib.conv3x3_nhwc
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [i, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib
