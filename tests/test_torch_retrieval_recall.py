"""The port's loop-closure recall study (``bench/retrieval_recall.py``)
against the JAX repo's ``scripts/retrieval_recall.py``: the same frames,
and the same recall@k through each package's encoder and retrieval
database on the tiny weights of the JAX package's ``init_params`` (carried
over by ``torch_parity.tiny_weights``; the encoder's final LayerNorm given
a seeded scale, see ``_seeded_enc_norm``), and ``tests/test_retrieval.py``'s
recall@2 floor on the port with the script's own weights."""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

from mast3r_slam_tpu_torch.bench import retrieval_recall as RR
from torch_parity import tiny_weights, torch_one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
N_HALF = 8          # tests/test_retrieval.py's trajectory


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location(
        "_jax_retrieval_recall", REPO / "scripts" / "retrieval_recall.py")
    mod = importlib.util.module_from_spec(spec)
    # its measure_recall defines a dataclass, which looks its module up
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    yield mod
    del sys.modules[spec.name]


@pytest.mark.parametrize("kw", [
    {}, dict(n_half=12), dict(shift_frac=0.25), dict(gain=0.6, bias=-0.25),
    dict(noise=0.2), dict(n_distractors=6), dict(H=384, W=512, n_half=3)])
def test_frames_equal_the_jax_script(script, kw):
    want, want_rev = script.build_loop_frames(**kw)
    got, got_rev = RR.build_loop_frames(**kw)
    assert got.dtype == want.dtype and got_rev == want_rev
    np.testing.assert_array_equal(got, want)


def test_stress_table_is_the_jax_scripts():
    """``scripts/retrieval_recall.py::stress``'s families and cells."""
    assert {f: [label for label, _ in cells]
            for f, cells in RR.STRESS.items()} == {
        "viewpoint shift (frac of W)": ["0.12", "0.25", "0.40"],
        "photometric drift (gain/bias)": ["0.9/+0.05", "0.75/+0.15",
                                          "0.6/-0.25"],
        "descriptor noise (sigma)": ["0.05", "0.10", "0.20"],
        "distractor scenes (count)": ["6", "12", "24"]}


def _seeded_enc_norm(pj, seed=5):
    """JAX's tiny init with the encoder's final LayerNorm given a seeded
    scale and shift. At the init (scale 1, shift 0) every token leaves the
    encoder with norm sqrt(D), so the retrieval head's attention ranking
    (the tokens' norms) is a tie that float32 rounding breaks, differently
    in XLA and in torch (``test_init_tokens_tie_in_norm``)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    d = pj["enc_norm"]["g"].shape[0]
    pj = dict(pj)
    pj["enc_norm"] = {
        "g": jnp.asarray(rng.uniform(0.5, 1.5, d).astype(np.float32)),
        "b": jnp.asarray(rng.normal(0.0, 0.1, d).astype(np.float32))}
    return pj


@pytest.fixture(scope="module")
def encoded():
    """The JAX package's tiny encoder and the port's on the same weights
    (``_seeded_enc_norm``), over the same frames."""
    import os
    import tempfile

    import jax
    import jax.numpy as jnp

    from mast3r_slam_tpu.models import convert as JC
    from mast3r_slam_tpu.models import mast3r as JM
    from mast3r_slam_tpu_torch.models import convert as TC

    imgs, revisit_of = RR.build_loop_frames(n_half=N_HALF)
    cj, pj, ct, _ = tiny_weights()
    pj = _seeded_enc_norm(pj)
    with tempfile.TemporaryDirectory() as d:
        JC.save_params_npz(pj, os.path.join(d, "w.npz"))
        pt = TC.params_from_jax(TC.load_npz(os.path.join(d, "w.npz")), ct,
                                device="cpu")
    enc = jax.jit(lambda img: JM.encode_image(pj, cj, img)[0])
    feats_j = [enc(jnp.asarray(im)[None]) for im in imgs]
    feats_t, ms = RR.encode_frames(imgs, pt, ct, "cpu")
    assert len(ms) == len(feats_t) == len(feats_j) == 2 * N_HALF
    return revisit_of, feats_j, feats_t, ct.enc_embed_dim


def test_encoder_tokens_agree(encoded):
    _, feats_j, feats_t, _ = encoded
    for fj, ft in zip(feats_j, feats_t):
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("case", ["production min_thresh", "no threshold",
                                  "projector head"])
def test_recall_equals_the_jax_script(script, encoded, case):
    revisit_of, feats_j, feats_t, d = encoded
    kw = {"production min_thresh": dict(min_thresh=5e-3),
          "no threshold": {},
          "projector head": dict(head_params=RR.projector_head(d))}[case]
    want, n_want = script.measure_recall(feats_j, revisit_of, N_HALF,
                                         desc_dim=d, **kw)
    got, n_got = RR.measure_recall(feats_t, revisit_of, N_HALF, desc_dim=d,
                                   **kw)
    assert n_got == n_want == N_HALF
    assert got == want


def test_init_tokens_tie_in_norm(script):
    """The witness for ``_seeded_enc_norm``: on the JAX script's own
    encoder every token's norm is sqrt(D) to within float32 rounding."""
    imgs, _ = RR.build_loop_frames(n_half=2)
    feats, cfg = script.encode_frames(imgs[:1])
    norms = np.linalg.norm(np.asarray(feats[0][0]), axis=-1)
    np.testing.assert_allclose(norms, np.sqrt(cfg.enc_embed_dim), rtol=1e-5)


def test_recall_floor_on_the_scripts_weights():
    """``tests/test_retrieval.py``'s pin on the port: the JAX script's
    tiny init weights, the production ``min_thresh``, recall@2 >= 0.6."""
    imgs, revisit_of = RR.build_loop_frames(n_half=N_HALF)
    _, _, ct, pt = tiny_weights()
    feats, _ = RR.encode_frames(imgs, pt, ct, "cpu")
    rec, total = RR.measure_recall(feats, revisit_of, N_HALF,
                                   desc_dim=ct.enc_embed_dim,
                                   min_thresh=5e-3)
    assert total == N_HALF
    assert rec[2] >= 0.6, f"loop recall@2 regressed: {rec}"


def test_main_runs_the_tables_on_the_cpu(capsys):
    out = RR.main(["--tiny"], device="cpu")
    text = capsys.readouterr().out
    assert out["frames"] == 2 * RR.N_HALF and out["encode_ms"] > 0
    assert set(out["bootstrap"]) == set(out["head"]) == {1, 2, 3}
    assert list(out["min_thresh"]) == [0.0, 1e-3, 5e-3, 2e-2, 5e-2]
    assert "bootstrap codebook: recall@k over 12 revisits" in text
    assert "retrieval recall on cpu" in text
