"""Port parity of models/convert.py: the reference-checkpoint converters
(MASt3R state dict, retrieval head, ASMK codebook) give arrays equal to the
JAX package's, and the JAX package's parameter files (model and retrieval
head with its residual flag) load into the port."""

import argparse
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import convert as JC
from mast3r_slam_tpu.models import mast3r as JM
from mast3r_slam_tpu_torch.models import convert as TC
from mast3r_slam_tpu_torch.models import mast3r as TM
from torch_parity import torch_one_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_convert import synthetic_torch_state_dict  # noqa: E402


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _assert_same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        if isinstance(la[k], bool) or isinstance(lb[k], bool):
            assert bool(la[k]) == bool(lb[k]), k
            continue
        np.testing.assert_array_equal(np.asarray(la[k]), np.asarray(lb[k]),
                                      err_msg=k)
        assert np.asarray(la[k]).dtype == np.asarray(lb[k]).dtype, k


@pytest.mark.parametrize("shared_decoder", [False, True])
def test_convert_state_dict_equals_jax(shared_decoder):
    cfg = JM.tiny_config()
    sd = synthetic_torch_state_dict(cfg)
    if shared_decoder:
        sd = {k: v for k, v in sd.items() if not k.startswith("dec_blocks2")}
    ju, tu = [], []
    want = JC.convert_state_dict(sd, cfg.enc_depth, cfg.dec_depth,
                                 unused_out=ju)
    got = TC.convert_state_dict(sd, cfg.enc_depth, cfg.dec_depth,
                                unused_out=tu)
    _assert_same_tree(got, want)
    assert tu == ju


def test_load_checkpoint_equals_jax_and_moves_to_torch(tmp_path):
    cfg = JM.tiny_config()
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in synthetic_torch_state_dict(cfg).items()}
    pth = tmp_path / "tiny.pth"
    torch.save({"model": sd, "args": {}}, pth)
    want = JC.load_checkpoint(pth, cfg.enc_depth, cfg.dec_depth)
    got = TC.load_checkpoint(pth, cfg.enc_depth, cfg.dec_depth)
    _assert_same_tree(got, want)
    params = TC.params_from_tree(got, TM.tiny_config(), device="cpu")
    assert params["enc_blocks"][0]["attn"]["qkv"]["w"].dtype == torch.float32
    with pytest.raises(ValueError, match="do not match"):
        TC.params_from_tree(got, TM.tiny_config(enc_depth=3), device="cpu")


def _retrieval_sd(rng, dim=16, hidden=(24,)):
    """A reference retrieval-head state dict: float64 whiteners, a
    Linear / LayerNorm / GELU projector and a final Linear; a backbone key
    the converter must skip."""
    sd = {"prewhiten.m": rng.normal(size=(1, dim)),
          "prewhiten.p": rng.normal(size=(dim, dim)),
          "backbone.x": rng.normal(size=(3,))}
    i, d = 0, dim
    for h in hidden:
        sd[f"projector.{i}.weight"] = rng.normal(size=(h, d))
        sd[f"projector.{i}.bias"] = rng.normal(size=(h,))
        sd[f"projector.{i + 1}.weight"] = rng.normal(size=(h,))
        sd[f"projector.{i + 1}.bias"] = rng.normal(size=(h,))
        i, d = i + 3, h
    sd[f"projector.{i}.weight"] = rng.normal(size=(dim, d))
    sd[f"projector.{i}.bias"] = rng.normal(size=(dim,))
    sd["postwhiten.m"] = rng.normal(size=(1, dim))
    sd["postwhiten.p"] = rng.normal(size=(dim, dim))
    return sd


@pytest.mark.parametrize("residual", [False, True])
def test_retrieval_converters_equal_jax(tmp_path, residual):
    rng = np.random.default_rng(11)
    sd = _retrieval_sd(rng)
    _assert_same_tree(TC.convert_retrieval_state_dict(sd, residual=residual),
                      JC.convert_retrieval_state_dict(sd, residual=residual))
    # without whiteners: identity transforms
    bare = {k: v for k, v in sd.items() if "whiten" not in k}
    _assert_same_tree(TC.convert_retrieval_state_dict(bare),
                      JC.convert_retrieval_state_dict(bare))

    args = argparse.Namespace(residual=residual, nfeat=128)
    pth = tmp_path / "retrieval.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": args}, pth)
    (hj, nj), (ht, nt) = (JC.load_retrieval_checkpoint(pth),
                          TC.load_retrieval_checkpoint(pth))
    assert nt == nj == 128
    _assert_same_tree(ht, hj)


def test_retrieval_codebook_loaders_equal_jax(tmp_path):
    cb = np.random.default_rng(12).normal(size=(8, 16)).astype(np.float32)
    np.save(tmp_path / "cb.npy", cb)
    np.savez(tmp_path / "cb.npz", centroids=cb)
    np.savez(tmp_path / "cb_other.npz", words=cb)
    with open(tmp_path / "cb.pkl", "wb") as f:
        pickle.dump({"state": {"centroids": cb}}, f)
    with open(tmp_path / "raw.pkl", "wb") as f:
        pickle.dump(cb, f)
    for name in ("cb.npy", "cb.npz", "cb_other.npz", "cb.pkl", "raw.pkl"):
        got = TC.load_retrieval_codebook(tmp_path / name)
        want = JC.load_retrieval_codebook(str(tmp_path / name))
        np.testing.assert_array_equal(got, want)


def test_jax_retrieval_head_npz_loads_into_the_port(tmp_path):
    """A head the JAX package saved (``save_params_npz``, residual flag and
    GELU markers included) gives the port the same head features."""
    from mast3r_slam_tpu.slam import retrieval as JR
    from mast3r_slam_tpu_torch.slam import retrieval as TR
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    head = JC.convert_retrieval_state_dict(_retrieval_sd(rng), residual=True)
    path = tmp_path / "head.npz"
    JC.save_params_npz(head, path)
    got = TC.retrieval_head_from_jax(TC.load_npz(path))
    assert got["residual"] is True
    jh = JC.load_params_npz(path)
    jh = {k: v for k, v in jh.items() if k != "residual"}
    feat = rng.normal(size=(30, 16)).astype(np.float32)
    want = JR.select_local_features(jnp.asarray(feat), jh, 10, True)
    th = {k: v for k, v in got.items() if k != "residual"}
    th = {k: ([{kk: torch.from_numpy(vv) for kk, vv in l.items()} for l in v]
              if isinstance(v, list) else torch.from_numpy(v))
          for k, v in th.items()}
    out = TR.select_local_features(torch.from_numpy(feat), th, 10, True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
