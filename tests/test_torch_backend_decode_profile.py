"""The port's decode + match stage profile (``bench/profile_backend_decode
.py``) against the JAX repo's ``scripts/profile_backend_decode.py`` and the
JAX package: the script's stages, each stage's output on the port's
synthetic inputs against JAX's ``decode_pair``, ``downstream_head`` and
``matching.match`` at the tiny config with tied weights, 32x48 (the f32
model tolerance of ``tests/test_torch_model.py``, the match agreement of
``tests/test_torch_matching.py``), and its main's JSON line on the
CPU."""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.models import mast3r as JM
from mast3r_slam_tpu.ops import matching as JMa
from mast3r_slam_tpu_torch.bench import profile_backend_decode as PD
from mast3r_slam_tpu_torch.models import mast3r as TM
from torch_parity import assert_close, tiny_weights, to_np
from torch_parity import torch_one_thread  # noqa: F401

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "profile_backend_decode.py"
HW = (32, 48)
AGREE = 0.999           # tests/test_torch_matching.py's match agreement

_j_decode = jax.jit(JM.decode_pair, static_argnums=(1,))
_j_head = jax.jit(JM.downstream_head, static_argnums=(1, 3))


@pytest.fixture(scope="module")
def both():
    """The tied tiny weights in both packages, the port's inputs and its
    stages."""
    cj, pj, ct, pt = tiny_weights(tie_streams=True)
    pj, pt = JM.prepare_params(pj, cj), TM.prepare_params(pt, ct)
    arrs = PD.make_inputs(ct, HW)
    t = PD.to_device(arrs, ct, HW, torch.device("cpu"))
    return dict(cj=cj, pj=pj, ct=ct, pt=pt, arrs=arrs, t=t,
                stages=PD.stages(pt, ct, t, HW))


def test_stages_are_the_scripts():
    src = SCRIPT.read_text()
    labels = set(re.findall(r'timed\(\s*f?"([^"]+)"', src))
    labels = {lab.replace("{ls}", str(ls)) for lab in labels
              for ls in (1, 2)}
    assert set(PD.STAGES) == labels
    assert (PD.HW, PD.REPS) == ((384, 512), 3)
    assert "MASt3RConfig()" in src and PD.CONFIG.name == "base.yaml"
    assert TM.MASt3RConfig().head_dtype == "float32"


def test_inputs_follow_the_scripts_recipe(both):
    a, cfg = both["arrs"], both["ct"]
    H, W = HW
    n_tok = (H // 16) * (W // 16)
    assert a["feat"].shape == (2, n_tok, cfg.enc_embed_dim)
    np.testing.assert_array_equal(a["X2"], np.roll(a["X1"], -3, axis=2))
    np.testing.assert_array_equal(a["D2"], np.roll(a["D1"], -3, axis=2))
    np.testing.assert_array_equal(a["X1"][0], a["X1"][1])
    assert a["D1"].shape == (2, H, W, 24)
    # unit descriptors, but in column u = 0, where every sin(u k) is 0
    norm = np.linalg.norm(a["D1"], axis=-1)
    np.testing.assert_allclose(norm[:, :, 1:], 1.0, rtol=1e-5)
    np.testing.assert_array_equal(norm[:, :, 0], 0.0)
    np.testing.assert_array_equal(a["init"], np.broadcast_to(
        np.arange(H * W), (2, H * W)))
    # the smooth surface through f 300 at the image centre
    u = np.arange(W, dtype=np.float32)
    z = a["X1"][0, 0, :, 2]
    np.testing.assert_allclose(a["X1"][0, 0, :, 0], (u - W / 2) / 300.0 * z,
                               rtol=1e-6)
    np.testing.assert_array_equal(
        both["t"]["pos"].numpy(), np.asarray(JM.patch_positions(
            H // 16, W // 16, 2)))


def _jax_inputs(both):
    a = both["arrs"]
    return {k: jnp.asarray(v) for k, v in a.items()}


@pytest.mark.parametrize("r", [0, 1])
def test_decode_and_heads_match_jax(both, r):
    j = _jax_inputs(both)
    cj, pj = both["cj"], both["pj"]
    pos = JM.patch_positions(HW[0] // 16, HW[1] // 16, 2)
    d1, d2 = _j_decode(pj, cj, j["feat"] + 1e-6 * r, pos, j["feat"][::-1],
                       pos)
    got = both["stages"][PD.STAGES[0]](r)
    for g, w in zip(got[0] + got[1], list(d1) + list(d2)):
        assert_close(g, w)
    d1_0, _ = _j_decode(pj, cj, j["feat"], pos, j["feat"][::-1], pos)
    want = _j_head(pj["head1"], cj, [x + 1e-6 * r for x in d1_0], HW)
    got = both["stages"][PD.STAGES[1]](r)
    for key in ("pts3d", "conf", "desc", "desc_conf"):
        assert_close(got[key], want[key])
    got = both["stages"][PD.STAGES[2]](r)
    for k, (g, d) in enumerate(zip(got, (d1, d2))):
        w = _j_head(pj[("head1", "head2")[k]], cj, d, HW)["pts3d"]
        assert_close(g, w)


@functools.lru_cache(maxsize=None)
def _j_match(level_step, rows):
    def run(X1, X2, D1, D2, init, r):
        return JMa.match(X1[rows] + 1e-6 * r, X2[rows], D1[rows], D2[rows],
                         idx_1_to_2_init=init[rows], level_step=level_step)
    return jax.jit(run)


def _agree(got, want):
    (gi, gv), (wi, wv) = got, want
    assert tuple(gi.shape) == tuple(wi.shape)
    assert (to_np(gi) == np.asarray(wi)).mean() >= AGREE
    assert (to_np(gv) == np.asarray(wv)).mean() >= AGREE


@pytest.mark.parametrize("stage,level_step", [(3, 1), (4, 2)])
def test_batched_match_matches_jax(both, stage, level_step):
    """At the script's timed reps (r = 1, 2). At r = 0 (its warm-up) X2 is
    X1 shifted by whole pixels, so every LM projection lands on a pixel
    edge and ``floor`` parts on float32 rounding (4% of the matches of
    this input then differ, in XLA and torch alike a tie); the occlusion
    gate still agrees."""
    j = _jax_inputs(both)
    args = (j["X1"], j["X2"], j["D1"], j["D2"], j["init"].astype(jnp.int32))
    for r in (1, 2):
        want = _j_match(level_step, slice(None))(*args, r)
        _agree(both["stages"][PD.STAGES[stage]](r), want)
        assert np.asarray(want[1]).mean() > 0.5      # the pair really matches
    want = np.asarray(_j_match(level_step, slice(None))(*args, 0)[1])
    got = to_np(both["stages"][PD.STAGES[stage]](0)[1])
    assert (got == want).mean() >= AGREE


def test_one_row_matches_match_jax(both):
    j = _jax_inputs(both)
    args = (j["X1"], j["X2"], j["D1"], j["D2"], j["init"].astype(jnp.int32))
    got = both["stages"][PD.STAGES[5]](1)
    m1 = _j_match(2, slice(0, 1))
    for g, r in zip(got, (1, 1.5)):
        want = m1(*args, r)[0]
        assert (to_np(g) == np.asarray(want)).mean() >= AGREE


def test_main_on_the_cpu(capsys):
    rec = PD.main(["--device", "cpu", "--tiny", "--hw", "32", "48",
                   "--reps", "1"])
    out = capsys.readouterr().out
    for name in PD.STAGES:
        assert name in out
    assert set(rec) == {"tool", "hw", "dtype", "head_dtype",
                        "enc_embed_dim", "reps", "ms", "launches",
                        "checksum", "stage_sum_ms", "match_symmetric",
                        "device"}
    assert set(rec["ms"]) == set(rec["launches"]) == set(PD.STAGES)
    assert all(v == 0 for counts in rec["launches"].values()
               for v in counts.values())          # no kernel on the CPU
    m = rec["match_symmetric"]
    assert m["ms"] is None and m["same_bits"] is None
    assert m["eager_ms"] > 0
    assert rec["device"].startswith("cpu")
