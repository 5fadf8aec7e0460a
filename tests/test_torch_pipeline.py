"""Port parity of slam/pipeline.py: ``relocalization`` and
``Backend.step`` against the JAX package on the oracle relocalization
episode of tests/test_oracle_reloc.py and on tests/test_pipeline.py's
stub-model scenes. Both must reach the same success or rollback, the same
keyframes and edges, and poses within 1e-4 (the BA's rows in float32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import lie as JL
from mast3r_slam_tpu.slam import factor_graph as JFG
from mast3r_slam_tpu.slam import frame as JFr
from mast3r_slam_tpu.slam import pipeline as JP
from mast3r_slam_tpu.slam.retrieval import RetrievalDatabase as JRDB
from mast3r_slam_tpu_torch.slam import factor_graph as TFG
from mast3r_slam_tpu_torch.slam import frame as TFr
from mast3r_slam_tpu_torch.slam import pipeline as TP
from mast3r_slam_tpu_torch.slam.retrieval import RetrievalDatabase as TRDB
from mast3r_slam_tpu_torch.utils.oracle_scene import OracleWorld
from torch_parity import torch_one_thread  # noqa: F401

POSE_TOL = 1e-4

# ---------------------------------------------------------------------------
# The stub-model scenes of tests/test_pipeline.py
# ---------------------------------------------------------------------------

H, W = 32, 48
N = H * W
CFG = {
    "use_calib": False,
    "local_opt": {"pin": 1, "C_conf": 0.0, "Q_conf": 0.0,
                  "min_match_frac": 0.0, "max_iters": 3, "sigma_ray": 0.003,
                  "sigma_dist": 0.1, "delta_norm": 1e-8,
                  "pixel_border": -10, "depth_eps": 1e-6,
                  "sigma_pixel": 1.0, "sigma_depth": 10.0,
                  "ba_compute_dtype": "float32"},
    "retrieval": {"k": 2, "min_thresh": 0.0},
    "reloc": {"min_match_frac": 0.0, "strict": True},
}


class JStub:
    def match_symmetric(self, feat_i, pos_i, feat_j, pos_j, img_hw,
                        init_i2j=None, init_j2i=None):
        b = feat_i.shape[0]
        idx = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[None], (b, N))
        valid = jnp.ones((b, N, 1), bool)
        Q = jnp.full((b, N, 1), 4.0)
        return idx, idx, valid, valid, Q, Q, Q, Q


class TStub:
    def match_symmetric(self, feat_i, pos_i, feat_j, pos_j, img_hw,
                        init_i2j=None, init_j2i=None):
        b = feat_i.shape[0]
        idx = torch.arange(N).expand(b, N)
        valid = torch.ones(b, N, 1, dtype=torch.bool)
        Q = torch.full((b, N, 1), 4.0)
        return idx, idx, valid, valid, Q, Q, Q, Q

    def match_oneway(self, feat_i, pos_i, feat_j, pos_j, img_hw,
                     init_i2j=None):
        return (torch.arange(N)[None], torch.ones(1, N, 1, dtype=torch.bool),
                torch.full((1, N), 4.0), torch.full((1, N), 4.0))


class StubRetrieval:
    """Proposes keyframe 0 once two keyframes were inserted."""

    def __init__(self):
        self.added = 0

    def update(self, frame, add_after_query, k, min_thresh=0.0, kf_idx=None,
               skip_query=False):
        hits = [0] if self.added > 1 else []
        if add_after_query:
            self.added += 1
        return hits


class NoRetrieval:
    def update(self, *a, **k):
        return []


class HitRetrieval:
    def update(self, *a, **k):
        return [0]


def _scene(n_kf, noise, seed=13):
    """Keyframes observing the same world points from poses along +x; all
    but keyframe 0 start from perturbed poses. Numpy arrays for both."""
    rng = np.random.default_rng(seed)
    X_shared = (rng.random((N, 3)) + [0, 0, 2.0]).astype(np.float32)
    out = []
    for i in range(n_kf):
        T_true = JL.exp(jnp.asarray([0.05 * i, 0, 0, 0, 0.02 * i, 0, 0.0]))
        X = np.array(JL.act(JL.inv(T_true)[None], jnp.asarray(X_shared)))
        xi = np.zeros(7, np.float32)
        if i > 0 and noise > 0:
            xi = (rng.normal(size=7) * noise).astype(np.float32)
        T0 = np.array(JL.compose(JL.exp(jnp.asarray(xi)), T_true))
        out.append((X, T0))
    return out


def _buffers(n_kf=3, noise=0.0):
    scene = _scene(n_kf, noise)
    kj = JFr.KeyframeBuffer(H, W, capacity=8, feat_dim=8)
    kt = TFr.KeyframeBuffer(H, W, capacity=8, feat_dim=8, device="cpu")
    for i, (X, T0) in enumerate(scene):
        fj = JFr.Frame(frame_id=i, img=jnp.zeros((H, W, 3)), img_shape=(H, W),
                       img_true_shape=(H, W),
                       uimg=np.zeros((H, W, 3), np.float32))
        fj.X_canon, fj.C, fj.N = jnp.asarray(X), jnp.ones((N, 1)), 1
        fj.feat = jnp.zeros((1, kj.num_patches, 8))
        fj.pos = jnp.zeros((1, kj.num_patches, 2), jnp.int32)
        fj.T_WC = jnp.asarray(T0)
        kj.append(fj)
        ft = TFr.Frame(frame_id=i, img=torch.zeros(H, W, 3), img_shape=(H, W),
                       img_true_shape=(H, W),
                       uimg=np.zeros((H, W, 3), np.float32))
        ft.X_canon, ft.C, ft.N = torch.from_numpy(X), torch.ones(N, 1), 1
        ft.feat = torch.zeros(1, kt.num_patches, 8)
        ft.pos = torch.zeros(1, kt.num_patches, 2, dtype=torch.int32)
        ft.T_WC = torch.from_numpy(T0)
        kt.append(ft)
    return kj, kt


def _same_graph_and_poses(gj, gt, kj, kt):
    np.testing.assert_array_equal(np.asarray(gt.ii), np.asarray(gj.ii))
    np.testing.assert_array_equal(np.asarray(gt.jj), np.asarray(gj.jj))
    assert len(kt) == len(kj)
    n = len(kt)
    np.testing.assert_allclose(kt.T_WC[:n].numpy(), np.asarray(kj.T_WC[:n]),
                               rtol=0, atol=POSE_TOL)
    np.testing.assert_array_equal(kt.version[:n], kj.version[:n])


def test_backend_steps_match_jax():
    """Two queued keyframes: retrieval edges, the consecutive edges and the
    global solve per step, then an empty queue."""
    kj, kt = _buffers(3, noise=0.02)
    res = {}
    for name, F, P, stub, kf in (("jax", JFr, JP, JStub, kj),
                                 ("port", TFr, TP, TStub, kt)):
        states = F.States()
        states.set_mode(F.Mode.TRACKING)
        FG = JFG if name == "jax" else TFG
        graph = FG.FactorGraph(stub(), kf, CFG)
        backend = P.Backend(stub(), kf, states, graph, StubRetrieval(), CFG)
        for idx in (1, 2):
            states.queue_global_optimization(idx)
        steps = [backend.step(), backend.step(), backend.step()]
        res[name] = (graph, steps, states)
    (gj, sj, stj), (gt, st, stt) = res["jax"], res["port"]
    assert sj == st == [True, True, False]
    _same_graph_and_poses(gj, gt, kj, kt)
    assert stt.edges_ii == [int(x) for x in stj.edges_ii]
    assert stt.edges_jj == [int(x) for x in stj.edges_jj]
    assert gt.n_edges() >= 2


def test_backend_consumes_only_this_keyframes_hint():
    """The hint of edge (idx - 1, idx) is taken by the step of keyframe
    idx; a hint for a later keyframe is left for its own step."""
    _, kt = _buffers(3)
    states = TFr.States()
    states.set_mode(TFr.Mode.TRACKING)
    graph = TFG.FactorGraph(TStub(), kt, CFG)
    backend = TP.Backend(TStub(), kt, states, graph, NoRetrieval(), CFG)
    hint = (1, 2, torch.arange(N), torch.ones(N, 1, dtype=torch.bool),
            torch.full((N, 1), 4.0))
    states.set_kf_match_hint(*hint)
    states.queue_global_optimization(1)
    assert backend.step()
    assert states.kf_match_hint is not None          # kf 2's, not taken
    states.queue_global_optimization(2)
    assert backend.step()
    assert states.kf_match_hint is None
    assert torch.equal(graph.idx_jj2ii[-1], hint[2])
    assert backend.idle()


@pytest.mark.parametrize("retrieval", ["none", "hit"])
def test_relocalization_outcomes_match_jax(retrieval):
    """No candidate: rolled back in both. A candidate (keyframe 0): accepted
    in both, with the same edges and solved poses."""
    kj, kt = _buffers(3)
    R = NoRetrieval if retrieval == "none" else HitRetrieval
    gj = JFG.FactorGraph(JStub(), kj, CFG)
    gt = TFG.FactorGraph(TStub(), kt, CFG)
    fj, ft = kj[1], kt[1]
    fj.frame_id = ft.frame_id = 99
    ok_j = JP.relocalization(fj, kj, gj, R(), CFG)
    ok_t = TP.relocalization(ft, kt, gt, R(), CFG)
    assert ok_j == ok_t == (retrieval == "hit")
    _same_graph_and_poses(gj, gt, kj, kt)


def test_reloc_success_clears_all_queued_counts():
    """One success resolves every reloc request queued in the episode and
    flips the mode back to tracking."""
    _, kt = _buffers(3)
    graph = TFG.FactorGraph(TStub(), kt, CFG)
    states = TFr.States()
    states.set_mode(TFr.Mode.RELOC)
    fr = kt[1]
    fr.frame_id = 99
    states.set_frame(fr)
    states.queue_reloc()
    states.queue_reloc()
    backend = TP.Backend(TStub(), kt, states, graph, HitRetrieval(), CFG)
    assert backend.step()
    assert states.get_mode() == TFr.Mode.TRACKING
    assert states.reloc_sem == 0 and backend.idle()
    states.set_mode(TFr.Mode.RELOC)
    states.queue_reloc()
    backend.retrieval = NoRetrieval()
    assert backend.step()                       # failure: one count less
    assert states.get_mode() == TFr.Mode.RELOC and states.reloc_sem == 0


# ---------------------------------------------------------------------------
# The oracle relocalization episode (tests/test_oracle_reloc.py)
# ---------------------------------------------------------------------------

RH, RW = 48, 64
RELOC_CFG = {
    "use_calib": False,
    "local_opt": {"pin": 1, "C_conf": 0.0, "Q_conf": 0.0,
                  "min_match_frac": 0.0, "max_iters": 30,
                  "sigma_ray": 0.003, "sigma_dist": 10.0,
                  "delta_norm": 1e-8, "ba_compute_dtype": "float32"},
    "matching": {"max_iter": 10, "radius": 2, "dilation_max": 5,
                 "level_step": 2},
    "retrieval": {"k": 3, "min_thresh": 5e-3},
    "reloc": {"min_match_frac": 0.3, "strict": True},
}
KF_X = [0.0, 0.6, 1.2, 1.8, 2.4, 3.0]


def _pose_tx(x, yaw=0.0):
    return np.asarray(JL.exp(jnp.asarray([x, 0.0, 0.0, 0.0, yaw, 0.0, 0.0],
                                         jnp.float32)))


@pytest.fixture(scope="module")
def episodes():
    """The JAX episode (its test's OracleWorld) and the port's, built from
    the same poses, drift and codebook."""
    import test_oracle_reloc as jtest

    jw = jtest.OracleWorld(seed=0)
    tw = OracleWorld((RH, RW), seed=0, device="cpu")
    kj = JFr.KeyframeBuffer(RH, RW, capacity=16, feat_dim=jtest.DESC)
    kt = TFr.KeyframeBuffer(RH, RW, capacity=16, feat_dim=tw.desc_dim,
                            device="cpu")
    rng = np.random.default_rng(4)
    for i, x in enumerate(KF_X):
        T = _pose_tx(x, yaw=0.02 * i)
        jw.observe(i, T)
        tw.observe(i, T)
        T_est = None
        if i > 0:
            xi = (rng.normal(size=7) * 0.004).astype(np.float32)
            T_est = np.asarray(JL.compose(JL.exp(jnp.asarray(xi)),
                                          jnp.asarray(T)))
        kj.append(jw.make_frame(i, T_est=T_est))
        kt.append(tw.make_frame(i, T_est=T_est))
    samp = jw.frames[0]["hits"][:: (RH * RW) // 64][:64]
    cb = jw.scene.descriptors(samp)[:16]
    dbj = JRDB(RELOC_CFG, codebook_size=16, nfeat=jtest.FEAT_TOKENS,
               desc_dim=jtest.DESC)
    dbt = TRDB(RELOC_CFG, codebook_size=16, nfeat=tw.n_tokens,
               desc_dim=tw.desc_dim)
    dbj.set_codebook(cb)
    dbt.set_codebook(cb)
    for i in range(len(KF_X)):
        dbj.update(kj[i], add_after_query=True, k=0, kf_idx=i)
        dbt.update(kt[i], add_after_query=True, k=0, kf_idx=i)
    return jw, kj, dbj, tw, kt, dbt


def test_oracle_reloc_recovers_like_jax(episodes):
    jw, kj, dbj, tw, kt, dbt = episodes
    T_tele = _pose_tx(0.05, yaw=0.01)
    jw.observe(100, T_tele)
    tw.observe(100, T_tele)
    gj = JFG.FactorGraph(jw, kj, RELOC_CFG)
    gt = TFG.FactorGraph(tw, kt, RELOC_CFG)
    ok_j = JP.relocalization(jw.make_frame(100, T_est=_pose_tx(1.5)), kj, gj,
                             dbj, RELOC_CFG)
    ok_t = TP.relocalization(tw.make_frame(100, T_est=_pose_tx(1.5)), kt, gt,
                             dbt, RELOC_CFG)
    assert ok_j and ok_t
    _same_graph_and_poses(gj, gt, kj, kt)
    T_rec = kt.T_WC[len(kt) - 1].numpy()
    assert np.linalg.norm(T_rec[:3] - T_tele[:3]) < 0.05
    assert min(np.linalg.norm(T_rec[3:7] - T_tele[3:7]),
               np.linalg.norm(T_rec[3:7] + T_tele[3:7])) < 0.05
    assert abs(float(T_rec[7]) - 1.0) < 0.12


def test_oracle_reloc_rejects_impostor_like_jax(episodes):
    jw, kj, _, tw, kt, _ = episodes

    class Forced:
        def update(self, frame, add_after_query, k, min_thresh=0.0,
                   kf_idx=None, skip_query=False):
            return [] if skip_query else [0, 1]

    T_far = _pose_tx(8.0)
    jw.observe(200, T_far)
    tw.observe(200, T_far)
    gj = JFG.FactorGraph(jw, kj, RELOC_CFG)
    gt = TFG.FactorGraph(tw, kt, RELOC_CFG)
    n_j, n_t = len(kj), len(kt)
    assert not JP.relocalization(jw.make_frame(200), kj, gj, Forced(),
                                 RELOC_CFG)
    assert not TP.relocalization(tw.make_frame(200), kt, gt, Forced(),
                                 RELOC_CFG)
    assert len(kj) == n_j and len(kt) == n_t
    assert gj.n_edges() == gt.n_edges() == 0
