"""Port parity of slam/retrieval.py: the head's feature selection, the
ASMK quantization / aggregation, the Lloyd step and the database's
candidate lists (online codebook bootstrap and the retroactive indexing of
keyframes seen before it) against the JAX package."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.slam import retrieval as JR
from mast3r_slam_tpu_torch.slam import retrieval as TR
from torch_parity import torch_one_thread  # noqa: F401

D = 32
RNG = np.random.default_rng(41)


def _head(residual, rng):
    """A retrieval head in the converter's layout: whitening and a
    Linear → LayerNorm → GELU → Linear projector."""
    def lin(i, o):
        return {"w": (np.eye(i, o) + 0.1 * rng.normal(size=(i, o))).astype(
            np.float32), "b": (0.05 * rng.normal(size=o)).astype(np.float32)}

    return {
        "prewhiten_m": (0.1 * rng.normal(size=D)).astype(np.float32),
        "prewhiten_P": (np.eye(D) + 0.05 * rng.normal(size=(D, D))).astype(
            np.float32),
        "postwhiten_m": (0.1 * rng.normal(size=D)).astype(np.float32),
        "postwhiten_P": (np.eye(D) + 0.05 * rng.normal(size=(D, D))).astype(
            np.float32),
        "projector": [lin(D, D),
                      {"g": (1 + 0.1 * rng.normal(size=D)).astype(np.float32),
                       "b": (0.1 * rng.normal(size=D)).astype(np.float32)},
                      {"gelu": np.zeros((0,), np.float32)}, lin(D, D)],
        "residual": residual,
    }


def _split(head):
    head = dict(head)
    residual = head.pop("residual")
    jh = {k: (jnp.asarray(v) if not isinstance(v, list) else
              [{kk: jnp.asarray(vv) for kk, vv in l.items()} for l in v])
          for k, v in head.items()}
    th = {k: (torch.from_numpy(v) if not isinstance(v, list) else
              [{kk: torch.from_numpy(vv) for kk, vv in l.items()} for l in v])
          for k, v in head.items()}
    return jh, th, residual


@pytest.mark.parametrize("head", [None, False, True],
                         ids=["no-head", "head", "head+residual"])
def test_select_local_features_matches_jax(head):
    feat = RNG.normal(size=(60, D)).astype(np.float32)
    if head is None:
        jh = th = None
        residual = False
    else:
        jh, th, residual = _split(_head(head, np.random.default_rng(3)))
    want = np.asarray(JR.select_local_features(jnp.asarray(feat), jh, 20,
                                               residual))
    got = TR.select_local_features(torch.from_numpy(feat), th, 20,
                                   residual).numpy()
    assert got.shape == (20, D)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_select_local_features_ties_keep_index_order():
    """Tokens of equal norm (bf16-valued tokens give few distinct norms):
    both packages keep the lower index first, as a stable sort does."""
    base = RNG.normal(size=(6, D)).astype(np.float32)
    feat = np.repeat(base, 5, axis=0)[RNG.permutation(30)]
    feat = np.array(jnp.asarray(feat, jnp.bfloat16).astype(jnp.float32))
    want = np.array(JR.select_local_features(jnp.asarray(feat), None, 12))
    got = TR.select_local_features(torch.from_numpy(feat), None, 12).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ma", [1, 5])
def test_aggregate_binarize_matches_jax(ma):
    desc = RNG.normal(size=(40, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    cb = RNG.normal(size=(16, D)).astype(np.float32)   # not normalized
    sj, mj = JR.aggregate_binarize(jnp.asarray(desc), jnp.asarray(cb), ma=ma)
    st, mt = TR.aggregate_binarize(torch.from_numpy(desc),
                                   torch.from_numpy(cb), ma=ma)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_aggregate_binarize_top_k_ties_lower_index_first():
    """Two identical codewords: MA=5 takes both, the lower index first, as
    ``lax.top_k``."""
    desc = RNG.normal(size=(8, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    cb = RNG.normal(size=(12, D)).astype(np.float32)
    cb[7] = cb[2]
    sj, mj = JR.aggregate_binarize(jnp.asarray(desc), jnp.asarray(cb), ma=5)
    st, mt = TR.aggregate_binarize(torch.from_numpy(desc),
                                   torch.from_numpy(cb), ma=5)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_lloyd_step_matches_jax():
    desc = RNG.normal(size=(200, D)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    cb = desc[:16].copy()
    cj, ct = jnp.asarray(cb), torch.from_numpy(cb)
    for _ in range(4):
        cj = JR.lloyd_step(jnp.asarray(desc), cj)
        ct = TR.lloyd_step(torch.from_numpy(desc), ct)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-6)


def _places(n_places, n_tok, rng):
    return [rng.normal(size=(n_tok, D)).astype(np.float32)
            for _ in range(n_places)]


WALK = [0, 1, 2, 3, 4, 5, 4, 3, 2, 1, 0]


def _sequence(noise=0.05):
    """Keyframes walking out over 6 places and back (a revisit of each),
    each keyframe its place's tokens plus noise."""
    rng = np.random.default_rng(5)
    places = _places(6, 48, rng)
    return [places[p] + noise * rng.normal(size=places[p].shape).astype(
        np.float32) for p in WALK]


@pytest.mark.parametrize("head", [None, True], ids=["no-head", "head"])
def test_database_candidates_match_jax(head):
    """Candidate lists over the sequence, with the online bootstrap (a
    16-word codebook from the first keyframes) and the retroactive indexing
    of the keyframes seen before it; the inverted files hold the same
    signatures."""
    cfg = {}
    hj = ht = None
    if head:
        hj = _head(True, np.random.default_rng(7))
        ht = hj
    # every token kept (nfeat = 48): the top-nfeat cut of near-equal norms
    # is held by test_select_local_features_*
    dbj = JR.RetrievalDatabase(cfg, codebook_size=16, nfeat=48, desc_dim=D,
                               head_params=hj)
    dbt = TR.RetrievalDatabase(cfg, codebook_size=16, nfeat=48, desc_dim=D,
                               head_params=ht)
    got, want = [], []
    boot = None
    for i, tok in enumerate(_sequence()):
        fj = SimpleNamespace(frame_id=i, feat=jnp.asarray(tok)[None])
        ft = SimpleNamespace(frame_id=i, feat=torch.from_numpy(tok)[None])
        want.append(dbj.update(fj, add_after_query=True, k=3,
                               min_thresh=5e-3, kf_idx=i))
        got.append(dbt.update(ft, add_after_query=True, k=3,
                              min_thresh=5e-3, kf_idx=i))
        if boot is None and dbt.codebook is not None:
            boot = i
            assert dbj.codebook is not None
            np.testing.assert_allclose(dbt.codebook.numpy(),
                                       np.asarray(dbj.codebook), rtol=1e-5,
                                       atol=1e-6)
    assert boot is not None and boot >= 1        # keyframes were pending
    assert got == want
    assert sum(len(c) for c in got) >= 10       # the database answers
    assert dbt.id_to_kf == dbj.id_to_kf == list(range(11))
    # signatures: a word whose centroid is one descriptor aggregates a
    # residual of rounding noise, whose sign may differ; hold the bits to
    # 99% agreement (99.2% read with the head, 100% without)
    same = total = 0
    for w in range(16):
        assert dbt.ivf_ids[w] == dbj.ivf_ids[w]
        for a, b in zip(dbt.ivf_sig[w], dbj.ivf_sig[w]):
            same += int((np.unpackbits(a) == np.unpackbits(b)).sum())
            total += a.size * 8
    assert total > 0 and same / total >= 0.99


def test_database_loaded_codebook_flush_and_id_mapping():
    """A codebook set after two pending keyframes indexes them at once;
    query results map internal ids to buffer indices (here inserted out of
    order, as a resume or relocalization does); the signature cache serves
    a second call on the same frame."""
    rng = np.random.default_rng(9)
    cb = rng.normal(size=(16, D)).astype(np.float32)
    cb /= np.linalg.norm(cb, axis=1, keepdims=True)
    seq = _sequence()
    out = {}
    for name, R, arr in (("jax", JR, jnp.asarray),
                         ("port", TR, torch.from_numpy)):
        db = R.RetrievalDatabase({}, codebook_size=32, nfeat=24, desc_dim=D)
        res = []
        for i, kf in ((0, 10), (1, 3)):
            db.update(SimpleNamespace(frame_id=i, feat=arr(seq[i])[None]),
                      add_after_query=True, k=3, kf_idx=kf)
        db.set_codebook(cb)                    # 32 → 16 words, flushes
        assert db.kf_counter == 2 and db.id_to_kf == [10, 3]
        for i in range(2, 11):
            f = SimpleNamespace(frame_id=i, feat=arr(seq[i])[None])
            res.append(db.update(f, add_after_query=False, k=2))
            res.append(db.update(f, add_after_query=True, k=2, kf_idx=20 + i,
                                 skip_query=True))
        out[name] = res
    assert out["port"] == out["jax"]
    assert any(10 in r for r in out["port"])
