"""Port parity: kernel K3's plain version (``flash_attention_ref``),
``attention_reference`` and the model's ``attention`` against the JAX
package (the Pallas ``flash_attention`` run in TPU interpret mode, as
tests/test_flash_attention.py runs it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mast3r_slam_tpu.ops import flash_attention as JFA
from mast3r_slam_tpu_torch.models import mast3r as TM
from mast3r_slam_tpu_torch.ops import flash_attention as TFA
from torch_parity import torch_one_thread  # noqa: F401

RNG = np.random.default_rng(23)
# f32: summation order only; bf16: the kernel and the plain version both
# round the output to bf16 (one ulp at |o| ~ 1 is 2^-7)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(b, h, nq, nk):
    return (RNG.normal(size=(b, h, nq, 64)).astype(np.float32),
            RNG.normal(size=(b, h, nk, 64)).astype(np.float32),
            RNG.normal(size=(b, h, nk, 64)).astype(np.float32))


def _both(arrs, dtype):
    jdt, tdt = DT[dtype]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(
        x) else x.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,nq,nk,blocks", [
    (2, 3, 256, 256, {}),                           # 128x128 tiles
    (1, 2, 256, 256, {"block_q": 256, "block_k": 256}),   # single block
    (1, 2, 128, 384, {}),                           # cross, Nq < Nk
    (1, 2, 384, 128, {})])                          # cross, Nq > Nk
def test_k3_plain_version_matches_pallas_kernel(dtype, b, h, nq, nk, blocks):
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(b, h, nq, nk), dtype)
    with pltpu.force_tpu_interpret_mode():
        want = JFA.flash_attention(qj, kj, vj, **blocks)
    got = TFA.flash_attention_ref(qt, kt, vt)
    assert got.dtype == DT[dtype][1] and got.shape == (b, h, nq, 64)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_reference_matches_jax(dtype):
    """The separate reference: softmax weights cast to v's dtype before
    ``p v``."""
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(1, 2, 96, 160), dtype)
    want = JFA.attention_reference(qj, kj, vj)
    got = TFA.attention_reference(qt, kt, vt)
    assert got.dtype == DT[dtype][1]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_attention_reference_differs_from_the_kernel_math_in_bf16():
    """In bf16 the two plain functions are not the same computation (the
    reference rounds the softmax weights to bf16); in f32 they agree."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 64, 64))
    assert not torch.equal(TFA.attention_reference(*(t.bfloat16() for t in
                                                    (q, k, v))),
                           TFA.flash_attention_ref(*(t.bfloat16() for t in
                                                    (q, k, v))))
    torch.testing.assert_close(TFA.attention_reference(q, k, v),
                               TFA.flash_attention_ref(q, k, v), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("nq,nk", [(64, 64), (48, 80)])
def test_model_attention_on_cpu_is_k3s_plain_version(nq, nk):
    """``models/mast3r.py::attention`` on CPU tensors: K3's plain version
    at any shape (no TPU dispatch gates), and no launch; against the JAX
    ``attention`` (its XLA path on the CPU)."""
    from mast3r_slam_tpu.models.mast3r import attention as j_attention

    q, k, v = _qkv(1, 2, nq, nk)
    before = TFA.attn_counter.launches
    got = TM.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert TFA.attn_counter.launches == before
    assert torch.equal(got, TFA.flash_attention_ref(
        *(torch.from_numpy(a) for a in (q, k, v))))
    want = j_attention(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
