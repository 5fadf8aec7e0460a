"""Port parity: kernel K2's plain version (conv3x3_ref) vs the JAX Pallas
conv3x3 in interpret mode and vs the ``lax.conv_general_dilated`` branch of
the JAX package's ``layers.conv2d``; the plain form of the f32 path's
3xTF32 arithmetic (conv3x3_tf32x3_ref) and its TF32 rounding
(ops/tf32.py) against the Pallas kernel, float64 and edge values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from mast3r_slam_tpu.ops import conv3x3 as JC3
from mast3r_slam_tpu_torch.ops import conv3x3 as TC3
from mast3r_slam_tpu_torch.ops.tf32 import tf32_round, tf32_split
from torch_parity import torch_one_thread  # noqa: F401

RNG = np.random.default_rng(31)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _inputs(b, h, w, cin, cout, bias):
    x = RNG.normal(size=(b, h, w, cin)).astype(np.float32)
    wt = (RNG.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    bv = RNG.normal(size=(cout,)).astype(np.float32) if bias else None
    return x, wt, bv


def _lax_conv(x, w, b):
    dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    y = lax.conv_general_dilated(x, w.astype(x.dtype), (1, 1), "SAME",
                                 dimension_numbers=dn)
    return y if b is None else y + b.astype(x.dtype)


def _port(x, w, b, dt):
    tb = None if b is None else torch.from_numpy(b).to(dt)
    return TC3.conv3x3_ref(torch.from_numpy(x).to(dt),
                           torch.from_numpy(w).to(dt), tb)


@pytest.mark.parametrize("cin,cout", [(128, 128), (256, 128)])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_pallas_and_lax(cin, cout, bias, dtype):
    x, w, b = _inputs(2, 8, 16, cin, cout, bias)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    bj = None if b is None else jnp.asarray(b, jdt)
    got = _port(x, w, b, tdt)
    assert got.dtype == tdt and got.shape == (2, 8, 16, cout)
    got = got.float().numpy()
    pallas = np.asarray(JC3.conv3x3(xj, wj, bj, interpret=True)
                        .astype(jnp.float32))
    ref = np.asarray(_lax_conv(xj, wj, bj).astype(jnp.float32))
    tol = TOL[dtype]
    np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_matches_lax_on_widened_gate(dtype):
    """96 -> 256 (rn0): outside the TPU kernel's lane gate, so the JAX
    package sends it to lax.conv; the port sends every 3x3 SAME conv to K2."""
    x, w, b = _inputs(1, 12, 16, 96, 256, False)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert not JC3.conv3x3_qualifies(x.shape, w.shape, 1, "SAME")
    got = _port(x, w, b, tdt).float().numpy()
    ref = np.asarray(_lax_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt), None)
                     .astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


def test_ref_handles_ragged_shapes():
    """Any H, W and channel counts: odd sizes against lax.conv in f32."""
    x, w, b = _inputs(1, 7, 9, 5, 3, True)
    got = _port(x, w, b, torch.float32).numpy()
    ref = np.asarray(_lax_conv(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ``ops.tf32.tf32_round`` (cvt.rna.tf32.f32) on edge values: (input bits,
# rounded bits); ties go away from zero, subnormals round on the same grid,
# a value past the largest TF32 rounds to infinity, an infinity or NaN is
# truncated
TF32_EDGES = [
    (0x00000000, 0x00000000),    # +0
    (0x80000000, 0x80000000),    # -0
    (0x00000001, 0x00000000),    # the smallest subnormal rounds to 0
    (0x00001000, 0x00002000),    # a subnormal tie, away from zero
    (0x80001000, 0x80002000),    # ... negative
    (0x00000fff, 0x00000000),    # just under the tie
    (0x007fffff, 0x00800000),    # the largest subnormal up to FLT_MIN
    (0x3f801000, 0x3f802000),    # 1 + 2^-11: a tie, away from zero
    (0x3f803000, 0x3f804000),    # 1 + 3 2^-11: a tie, away (odd below)
    (0xbf801000, 0xbf802000),    # -(1 + 2^-11)
    (0x3f800fff, 0x3f800000),    # just under a tie
    (0x3f801001, 0x3f802000),    # just over a tie
    (0x7f7fefff, 0x7f7fe000),    # under the largest TF32's upper tie
    (0x7f7ff000, 0x7f800000),    # the largest TF32's upper tie: infinity
    (0x7f7fffff, 0x7f800000),    # the largest float32: infinity
    (0xff7fffff, 0xff800000),    # ... negative
    (0x7f800000, 0x7f800000),    # +inf
    (0xff800000, 0xff800000),    # -inf
    (0x7fc00000, 0x7fc00000),    # a quiet NaN stays itself
    (0x7fffffff, 0x7fffe000),    # a NaN keeps its top payload bits
    (0x7f800001, 0x7f800000),    # a NaN with only low payload bits:
    (0xff801fbe, 0xff800000),    # ... an infinity, as on the card
]


def _bits(b):
    return torch.from_numpy(np.array([b], np.uint32).view(np.float32).copy())


@pytest.mark.parametrize("bits,want", TF32_EDGES)
def test_tf32_round_edge_values(bits, want):
    got = tf32_round(_bits(bits)).view(torch.int32).item() & 0xFFFFFFFF
    assert got == want, (hex(bits), hex(got), hex(want))


def test_tf32_split_parts():
    """hi and lo are TF32 values (13 low bits clear), hi is the nearest
    TF32 to x, and hi + lo is x to 2^-22 |x|."""
    x = torch.from_numpy((RNG.normal(size=100_000)
                          * 10.0 ** RNG.integers(-30, 30, 100_000))
                         .astype(np.float32))
    hi, lo = tf32_split(x)
    for t in (hi, lo):
        assert not (t.view(torch.int32) & 0x1FFF).any()
    assert ((x.double() - hi.double()).abs()
            <= 2.0 ** -11 * x.double().abs()).all()
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()


def _conv_f64(x, w, b):
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    bsz, h, wd, _ = x.shape
    out = np.zeros((bsz, h, wd, w.shape[-1]))
    for dy in range(3):
        for dx in range(3):
            out += xp[:, dy:dy + h, dx:dx + wd] @ w[dy, dx].astype(np.float64)
    return out if b is None else out + b


@pytest.mark.parametrize("cin,cout", [(128, 128), (256, 128), (40, 72)])
@pytest.mark.parametrize("bias", [False, True])
def test_tf32x3_ref_matches_pallas(cin, cout, bias):
    """The 3xTF32 arithmetic of the ``"tf32x3"`` path in plain form against
    the JAX Pallas kernel (interpret mode, f32) at the f32 tolerance."""
    x, w, b = _inputs(2, 8, 16, cin, cout, bias)
    got = TC3.conv3x3_tf32x3_ref(torch.from_numpy(x), torch.from_numpy(w),
                                 None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (2, 8, 16, cout)
    pallas = np.asarray(JC3.conv3x3(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=TOL["float32"],
                               atol=TOL["float32"])


@pytest.mark.parametrize("cin,cout", [(96, 256), (256, 128)])
def test_tf32x3_ref_against_float64(cin, cout):
    """Its error against a float64 conv stays within its bound: each
    product off by at most about 3 2^-22 |x w| (the split keeps 22 bits of
    each operand, lo lo is dropped), one float32 rounding of the sum, one
    of the bias addition; and within 4x the plain f32 version's. Measured
    (these seeds, CPU): 9.3e-8 (96 -> 256) and 6.5e-8 (256 -> 128) of
    max|y|, against conv3x3_ref's 1.8e-7 and 2.6e-7."""
    rng = np.random.default_rng(31)
    x = rng.normal(size=(1, 12, 16, cin)).astype(np.float32)
    w = (rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(
        np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(t) for t in (x, w, b))
    got = TC3.conv3x3_tf32x3_ref(tx, tw, tb).double().numpy()
    plain = TC3.conv3x3_ref(tx, tw, tb).double().numpy()
    ref = _conv_f64(x, w, b)
    mag = _conv_f64(np.abs(x), np.abs(w), None)
    bound = 4 * 2.0 ** -22 * mag + 2.0 ** -23 * (np.abs(ref) + np.abs(b))
    assert (np.abs(got - ref) <= bound).all()
    err = np.abs(got - ref).max()
    assert err <= 1e-6 * np.abs(ref).max()
    assert err <= 4 * np.abs(plain - ref).max()
