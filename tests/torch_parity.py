"""Shared pieces of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX package
and the port; weights are JAX ``init_params`` carried over through the npz
format (``save_params_npz`` → the port's ``load_npz`` → ``params_from_jax``).
"""

from __future__ import annotations

import functools
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

# Tolerances by dtype: f32 work is held to f32 rounding (summation order
# differs between XLA and torch), bf16 to the bf16 rounding of activations.
TOL = {
    "float32": dict(rtol=1e-4, atol=1e-5),
    "bfloat16": dict(rtol=2e-2, atol=2e-2),
}


@pytest.fixture(autouse=True, scope="module")
def torch_one_thread():
    """The port's tests run tiny shapes: one torch thread per test worker
    avoids oversubscribing the cores that the parallel workers share.
    Test modules take it with ``from torch_parity import
    torch_one_thread``."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def to_np(x):
    if torch.is_tensor(x):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def assert_close(got, want, dtype="float32", **kw):
    tol = dict(TOL[dtype], **kw)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


@functools.lru_cache(maxsize=2)
def _jax_init(cfg):
    from mast3r_slam_tpu.models import mast3r as JM

    return jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                      cfg)


@functools.lru_cache(maxsize=4)
def tiny_weights(tie_streams: bool = False, **cfg_kw):
    """JAX tiny params and the same weights in the port (on the CPU).

    ``tie_streams`` gives the second decoder stream and head the first
    one's weights, so a frame decoded against itself predicts the same
    pointmap from both views (random weights otherwise predict unrelated
    ones, and nothing would match)."""
    from mast3r_slam_tpu.models import convert as JC
    from mast3r_slam_tpu.models import mast3r as JM
    from mast3r_slam_tpu_torch.models import convert as TC
    from mast3r_slam_tpu_torch.models import mast3r as TM

    cj = JM.tiny_config(**cfg_kw)
    ct = TM.tiny_config(**cfg_kw)
    # one init per width config: the dtype fields do not change the weights
    pj = dict(_jax_init(JM.tiny_config()))
    if tie_streams:
        pj["dec_blocks2"] = pj["dec_blocks"]
        pj["head2"] = pj["head1"]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tiny.npz")
        JC.save_params_npz(pj, path)
        pt = TC.params_from_jax(TC.load_npz(path), ct, device="cpu")
    return cj, pj, ct, pt


def crop_frame(frame_id, img, T_WC=None):
    """A CPU Frame of an image already at the model crop, ``img (H, W, 3)``
    ImgNorm'd to [-1, 1] (H, W multiples of 16): the model input is the
    image itself, bit for bit, with no resize. The display image is
    derived from it."""
    from mast3r_slam_tpu_torch.ops import lie
    from mast3r_slam_tpu_torch.slam.frame import Frame

    img = torch.as_tensor(np.asarray(img), dtype=torch.float32)
    h, w = int(img.shape[0]), int(img.shape[1])
    return Frame(frame_id=frame_id, img=img, img_shape=(h, w),
                 img_true_shape=(h, w),
                 uimg=((img.numpy() + 1.0) * 0.5).astype(np.float32),
                 T_WC=lie.identity() if T_WC is None else T_WC)


def ba_edges(seed, E=5, N=2048, cap=6):
    """Numpy-seeded BA edges (the ``tests/test_ba_fused.py`` recipe): poses
    ``T (cap, 8)``, pointmaps in front of the cameras, confidences, edge
    ends, random matches, valid masks, Q and an edge mask (edge 0 on)."""
    from mast3r_slam_tpu.ops import lie as JL

    rng = np.random.default_rng(seed)
    T = np.array(JL.exp(jax.numpy.asarray(
        rng.normal(size=(cap, 7)).astype(np.float32) * 0.1)))
    X = rng.uniform(-1, 1, (cap, N, 3)).astype(np.float32)
    X[..., 2] += 2.5
    Cavg = rng.uniform(0.0, 3.0, (cap, N, 1)).astype(np.float32)
    ii = rng.integers(0, cap, E).astype(np.int32)
    jj = ((ii + 1) % cap).astype(np.int32)
    idx = rng.integers(0, N, (E, N)).astype(np.int32)
    valid = rng.random((E, N, 1)) < 0.8
    Q = rng.uniform(0.0, 3.0, (E, N, 1)).astype(np.float32)
    mask = (rng.random(E) < 0.85).astype(np.float32)
    mask[0] = 1.0
    return T, X, Cavg, ii, jj, idx, valid, Q, mask


def keyframe_pair(X, C, T_WC, h, w):
    """One keyframe with the same pointmap ``X (h*w, 3)``, confidence ``C``
    and pose ``T_WC (8,)`` in a JAX and a port (CPU) ``KeyframeBuffer``."""
    import jax.numpy as jnp

    from mast3r_slam_tpu.slam.frame import Frame as JF, KeyframeBuffer as JK
    from mast3r_slam_tpu_torch.slam.frame import Frame as TF
    from mast3r_slam_tpu_torch.slam.frame import KeyframeBuffer as TK

    n = h * w
    jk = JK(h, w, capacity=4, feat_dim=8)
    tk = TK(h, w, capacity=4, feat_dim=8, device="cpu")
    jf = JF(frame_id=0, img=jnp.zeros((h, w, 3)), img_shape=(h, w),
            img_true_shape=(h, w), uimg=np.zeros((h, w, 3), np.float32))
    jf.X_canon = jnp.asarray(X)
    jf.C = jnp.asarray(C.reshape(n, 1))
    jf.feat = jnp.zeros((1, jk.num_patches, 8))
    jf.pos = jnp.zeros((1, jk.num_patches, 2), jnp.int32)
    jf.N = 1
    jf.T_WC = jnp.asarray(T_WC)
    jk.append(jf)
    tf = TF(frame_id=0, img=torch.zeros(h, w, 3), img_shape=(h, w),
            img_true_shape=(h, w), uimg=np.zeros((h, w, 3), np.float32),
            T_WC=torch.tensor(np.asarray(T_WC, np.float32)))
    tf.X_canon = torch.from_numpy(np.ascontiguousarray(X, np.float32))
    tf.C = torch.from_numpy(np.ascontiguousarray(C, np.float32).reshape(n, 1))
    tf.feat = torch.zeros(1, tk.num_patches, 8)
    tf.pos = torch.zeros(1, tk.num_patches, 2, dtype=torch.int32)
    tf.N = 1
    tk.append(tf)
    return jk, tk
