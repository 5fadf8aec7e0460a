"""Port parity for what surrounds the redesigned K1 and K2 kernels: the
split-K planner and the split order's plain version of K2 (against the JAX
Pallas ``conv3x3`` in interpret mode and ``lax.conv``), and K1's plain
version on the model's strided head-split views with its token-major
output (against the JAX Pallas ``flash_attention_rope`` in interpret mode).
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental.pallas import tpu as pltpu

from mast3r_slam_tpu.models import mast3r as JM
from mast3r_slam_tpu.ops import conv3x3 as JC3
from mast3r_slam_tpu.ops import flash_attention as JFA
from mast3r_slam_tpu_torch import _build
from mast3r_slam_tpu_torch.models import mast3r as TM
from mast3r_slam_tpu_torch.ops import ba_kernels as TBA
from mast3r_slam_tpu_torch.ops import conv3x3 as TC3
from mast3r_slam_tpu_torch.ops import device_loop as TDL
from mast3r_slam_tpu_torch.ops import flash_attention as TFA
from mast3r_slam_tpu_torch.ops import gram_variants as TGV
from torch_parity import torch_one_thread  # noqa: F401

RNG = np.random.default_rng(57)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
H100_SMS = 132
# the ten 3x3 conv shapes of one DPT head at 384x512 (H, W, Cin, Cout)
DPT = [(96, 128, 96, 256), (48, 64, 192, 256), (24, 32, 384, 256),
       (12, 16, 768, 256), (12, 16, 256, 256), (24, 32, 256, 256),
       (48, 64, 256, 256), (96, 128, 256, 256), (192, 256, 256, 128),
       (384, 512, 128, 128)]


def _tile_pixels(p, bsz, h, w, block):
    """Output pixels (img, y, x) of block ``block`` of the kernel's grid,
    decoded as csrc/conv3x3.cu decodes blockIdx.x."""
    tiles_h, tiles_w = -(-h // TC3.TILE_H), -(-w // TC3.TILE_W)
    mt = block % p.tiles_m
    img = mt // (tiles_h * tiles_w)
    oy0 = (mt // tiles_w) % tiles_h * TC3.TILE_H
    ox0 = mt % tiles_w * TC3.TILE_W
    return {(img, y, x) for y in range(oy0, min(oy0 + TC3.TILE_H, h))
            for x in range(ox0, min(ox0 + TC3.TILE_W, w))}


@pytest.mark.parametrize("bsz", [1, 2])
@pytest.mark.parametrize("shape", DPT + [(7, 9, 40, 24), (12, 16, 104, 72)])
def test_split_k_plan_covers_every_tile_once_and_partitions_k(shape, bsz):
    h, w, cin, cout = shape
    p = TC3.plan(bsz, h, w, cin, cout, H100_SMS)
    assert p.kiters == 9 * -(-cin // TC3.TILE_K)
    assert p.tiles_n == -(-cout // TC3.TILE_N)
    # the output tiles: every pixel of the batch in exactly one tile
    if h * w <= 96 * 128:
        seen = []
        for block in range(p.tiles_m):
            seen.extend(_tile_pixels(p, bsz, h, w, block))
        assert len(seen) == len(set(seen)) == bsz * h * w
    # the K steps: split ranges contiguous, non-empty, covering 9 * chunks
    ranges = [p.k_range(s) for s in range(p.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == p.kiters
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("shape", DPT)
def test_split_k_plan_fills_the_card(shape):
    """12x16 to 48x64 split K to at least one block an SM; the larger
    convs fill the card unsplit."""
    p = TC3.plan(1, *shape, H100_SMS)
    if shape[0] <= 48:
        assert p.splits > 1 and p.blocks >= H100_SMS
    else:
        assert p.splits == 1 and p.blocks >= H100_SMS


def test_conv3x3_path_by_shape():
    assert TC3.conv3x3_path(torch.bfloat16, 256, 128) == "igemm"
    assert TC3.conv3x3_path(torch.bfloat16, 40, 72) == "igemm"
    assert TC3.conv3x3_path(torch.bfloat16, 5, 3) == "mma"
    assert TC3.conv3x3_path(torch.bfloat16, 96, 16) == "igemm"
    assert TC3.conv3x3_path(torch.bfloat16, 96, 12) == "mma"
    assert TC3.conv3x3_path(torch.bfloat16, 20, 96) == "mma"
    assert TC3.conv3x3_path(torch.float32, 256, 256) == "tf32x3"


def _lax_conv(x, w, b):
    dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    y = lax.conv_general_dilated(x, w.astype(x.dtype), (1, 1), "SAME",
                                 dimension_numbers=dn)
    return y if b is None else y + b.astype(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_split_order_plain_version_matches_jax(dtype, bias):
    """The split-K order's plain version (partials over contiguous ranges
    of 32-channel tap steps, added in split order) at a 12x16 plan of 4+
    splits, against the Pallas kernel (interpret mode) and lax.conv."""
    b_, h, w, cin, cout = 1, 12, 16, 128, 128
    p = TC3.plan(b_, h, w, cin, cout, H100_SMS)
    assert p.splits >= 4
    x = RNG.normal(size=(b_, h, w, cin)).astype(np.float32)
    wt = (RNG.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    bv = RNG.normal(size=(cout,)).astype(np.float32) if bias else None
    jdt, tdt = DT[dtype]
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(wt, jdt)
    bj = None if bv is None else jnp.asarray(bv, jdt)
    got = TC3.conv3x3_split_ref(
        torch.from_numpy(x).to(tdt), torch.from_numpy(wt).to(tdt),
        None if bv is None else torch.from_numpy(bv).to(tdt), p)
    assert got.dtype == tdt and got.shape == (b_, h, w, cout)
    got = got.float().numpy()
    pallas = np.asarray(JC3.conv3x3(xj, wj, bj, interpret=True)
                        .astype(jnp.float32))
    ref = np.asarray(_lax_conv(xj, wj, bj).astype(jnp.float32))
    np.testing.assert_allclose(got, pallas, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


def _qkv_views(case, h, n, nk):
    """numpy projections and the port's q/k/v built from them as the model
    builds them (views), plus the JAX package's contiguous q/k/v."""
    c = 64 * h
    if case == "encoder self":
        proj = RNG.normal(size=(1, n, 3 * c)).astype(np.float32)
        views = [TM._split_heads(t, h)
                 for t in torch.from_numpy(proj).chunk(3, dim=-1)]
        arrays = [JM._split_heads(t, h)
                  for t in jnp.split(jnp.asarray(proj), 3, axis=-1)]
    elif case == "decoder self":
        proj = RNG.normal(size=(2, 1, n, 3 * c)).astype(np.float32)
        views = [TM._heads_s(t, h)
                 for t in torch.from_numpy(proj).chunk(3, dim=-1)]
        arrays = [JM._split_heads(t.reshape(2, n, c), h)
                  for t in jnp.split(jnp.asarray(proj), 3, axis=-1)]
    else:   # decoder cross: q from the stream, k / v from the memory
        projs = [RNG.normal(size=(2, 1, m, c)).astype(np.float32)
                 for m in (n, nk, nk)]
        views = [TM._heads_s(torch.from_numpy(t), h) for t in projs]
        arrays = [JM._split_heads(jnp.asarray(t.reshape(2, -1, c)), h)
                  for t in projs]
    return views, arrays


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,h,n,nk", [("encoder self", 4, 128, 128),
                                         ("decoder self", 3, 128, 128),
                                         ("decoder cross", 2, 128, 256)])
def test_rope_plain_version_on_model_views(dtype, case, h, n, nk):
    """K1's plain version takes the model's head-split views as they are
    and returns a token-major (B, N, H, D) buffer seen as (B, H, N, D), so
    ``_merge_heads`` is a view; values against the Pallas kernel."""
    jdt, tdt = DT[dtype]
    views, arrays = _qkv_views(case, h, n, nk)
    views = [t.to(tdt) for t in views]
    assert not views[0].is_contiguous()
    b = views[0].shape[0]
    grid_q = (8, n // 8)
    grid_k = (8, nk // 8)
    qpos = np.array(JM.patch_positions(*grid_q, b))
    kpos = np.array(JM.patch_positions(*grid_k, b))[:, ::-1].copy()
    cq, sq = JFA.rope_tables(jnp.asarray(qpos), 64)
    ck, sk = JFA.rope_tables(jnp.asarray(kpos), 64)
    with pltpu.force_tpu_interpret_mode():
        want = JFA.flash_attention_rope(*(a.astype(jdt) for a in arrays),
                                        cq, sq, ck, sk, h)
    tabs = [*TFA.rope_tables(torch.from_numpy(qpos), 64),
            *TFA.rope_tables(torch.from_numpy(kpos), 64)]
    got = TFA.flash_attention_rope(*views, *tabs)
    assert got.shape == (b, h, n, 64) and got.dtype == tdt
    assert got.transpose(1, 2).is_contiguous()
    merged = TM._merge_heads(got)
    assert merged.data_ptr() == got.data_ptr() and merged.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(
        merged.float().numpy(),
        np.asarray(JM._merge_heads(want).astype(jnp.float32)),
        rtol=TOL[dtype], atol=TOL[dtype])


def test_k3_plain_version_is_token_major():
    q, k, v = (torch.from_numpy(RNG.normal(size=(2, 3, n, 64)).astype(
        np.float32)) for n in (96, 160, 160))
    out = TFA.flash_attention(q, k, v)
    assert out.shape == (2, 3, 96, 64) and out.transpose(1, 2).is_contiguous()
    want = JFA.attention_reference(*(jnp.asarray(t.numpy()) for t in
                                     (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("bh", [16, 24, 48])
def test_attention_block_fills_whole_waves(bh):
    """At 768 tokens the pipelined kernel's 48-row blocks fill >= 96% of
    whole waves over 132 SMs for the encoder (16 heads), the decoder (2 x
    12) and the batched pairs (4 x 12)."""
    blocks = bh * -(-768 // TFA.BLOCK_Q)
    assert blocks / (-(-blocks // H100_SMS) * H100_SMS) >= 0.96


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float,
           "const long long*": ctypes.POINTER(ctypes.c_longlong)}


@pytest.mark.parametrize("module", [TC3, TFA, TBA, TGV, TDL])
def test_ctypes_signatures_match_the_c_entries(module):
    """Every C entry a wrapper binds has the parameter list the wrapper's
    ctypes signature declares (a mismatch passes garbage, e.g. as the
    stream, and only the card would show it)."""
    src = (_build.CSRC / f"{module.KERNEL}.cu").read_text()
    for name, argtypes in module.ENTRIES.items():
        m = re.search(r'extern "C" int ' + name + r"\((.*?)\)", src, re.S)
        assert m, name
        params = [" ".join(p.split()[:-1]).replace(" *", "*")
                  for p in m.group(1).split(",")]
        assert [_CTYPES[p] for p in params] == argtypes, name
