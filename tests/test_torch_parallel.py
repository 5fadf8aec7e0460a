"""Port parity: the multi-device paths of the backend
(``_shard_edge_system``, the sharded pair decode, the mesh solve of
``FactorGraph`` and its placement, the loop that distinct cards run on
the host) and the port's CLI on a virtual device layout, on the CPU.

The port runs its slots on repeated CPU devices (``[cpu] * n``); the JAX
side runs on conftest's 8 virtual CPU devices, its Pallas Gram in
interpret mode as ``tests/test_parallel.py`` runs it. Tolerances:

- the sharded K4 / K5 system against one build of the same edges, and
  against JAX's sharded system: ``factor_graph.system_error`` (each entry
  of H against ``sqrt(H_aa H_bb)``, of g against ``sqrt(H_aa cost)``, the
  cost against itself) within ``test_torch_ba_kernels.py``'s Gram
  tolerances, 1e-5 with float32 rows and 1e-4 with bfloat16 rows;
- the sharded decode against the unsharded one and against JAX's sharded
  decode: ``torch_parity``'s float32 tolerance (rtol 1e-4, atol 1e-5);
- mesh solves against the one-device solve: 1e-5 (float32 rows, the
  systems differ only in the order of their f32 sums); against the old
  eager mesh loop and the host-driven loop of distinct cards: bit for bit;
  the placement against JAX's FactorGraph: the same ``solve_stats``, poses
  within 1e-4;
- the CLI on 8 slots against its one-slot run: the same modes, keyframes
  and edges, exactly.
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mast3r_slam_tpu.models import mast3r as JM
from mast3r_slam_tpu.models.inference import MASt3RInference as JInference
from mast3r_slam_tpu.ops import ba_kernels as JK
from mast3r_slam_tpu.parallel import sharding as JS
from mast3r_slam_tpu.parallel import topology as JT
from mast3r_slam_tpu.slam import factor_graph as JFG
from mast3r_slam_tpu_torch import main as tcli
from mast3r_slam_tpu_torch.models import mast3r as TM
from mast3r_slam_tpu_torch.models.inference import MASt3RInference
from mast3r_slam_tpu_torch.parallel import sharding as S
from mast3r_slam_tpu_torch.slam import factor_graph as TFG
from test_torch_ba_kernels import TOL
from test_torch_factor_graph import (CFG, StubModel, _buffers,
                                     _calib_scene, _lm_scene)
from torch_parity import torch_one_thread  # noqa: F401
from torch_parity import assert_close, ba_edges, tiny_weights

t_ = torch.from_numpy
CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parents[1]
SIGMAS_RAYS = (0.003, 10.0)
K = np.asarray([[40.0, 0.0, 16.0], [0.0, 40.0, 12.0], [0.0, 0.0, 1.0]],
               np.float32)
CALIB_ARGS = ((24, 32), 2.0, 1e-6, 1.0, 0.1)
CAP, E2 = 6, 8


def _cpu_mesh(n):
    """``n`` slots of the CPU, numbered 1..n as a backend's are."""
    return S.DeviceMesh((CPU,) * n, tuple(range(1, n + 1)))


def _problem(kind):
    """Eight one-way edges (``ba_edges``) and their JAX premeas channels."""
    T, X, Cavg, ii, jj, idx, valid, Q, mask = (jnp.asarray(a) for a in
                                                ba_edges(7, E=E2, N=768,
                                                         cap=CAP))
    if kind == "rays":
        meas = JFG._premeas_rays(X, Cavg, ii, jj, idx, valid, Q, 0.5, 0.5)
    else:
        meas = JFG._premeas_calib(X, Cavg, ii, jj, idx, valid, Q, 32, 1e-6,
                                  0.5, 0.5)
    free = np.arange(CAP) > 0
    return T, ii, jj, mask, meas, free


def _port_accum(kind, compute):
    if kind == "rays":
        def accum(T, meas, ii, jj, mask, free):
            return TFG._accumulate_rays(T, meas, ii, jj, mask, free, CAP,
                                        *SIGMAS_RAYS, compute_dtype=compute)
    else:
        def accum(T, meas, ii, jj, mask, free, K_):
            return TFG._accumulate_calib(T, meas, K_, ii, jj, mask, free,
                                         CAP, *CALIB_ARGS,
                                         compute_dtype=compute)
    return accum


def _jax_sharded(kind, compute, n, T, ii, jj, mask, meas, free):
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:n]), (JS.EDGE_AXIS,))
    cdt = jnp.dtype(compute)
    if kind == "rays":
        def accum(T_r, meas_l, ii_l, jj_l, mask_l, free_r):
            return JFG._accumulate_pallas_rays(
                T_r, meas_l, ii_l, jj_l, mask_l, free_r, CAP, *SIGMAS_RAYS,
                compute_dtype=cdt, interpret=True)
        extra = ()
    else:
        def accum(T_r, meas_l, ii_l, jj_l, mask_l, free_r, K_r):
            return JFG._accumulate_pallas_calib(
                T_r, meas_l, K_r, ii_l, jj_l, mask_l, free_r, CAP,
                *CALIB_ARGS, compute_dtype=cdt, interpret=True)
        extra = (JS.replicate(jnp.asarray(K), mesh),)
    # jitted, as gauss_newton_* run it (eagerly, the interpreted kernel
    # under shard_map takes ~30 s a call on the CPU)
    system = jax.jit(lambda *a: JFG._shard_edge_system(mesh, accum, *a))
    return system(
        JS.replicate(T, mesh), JS.replicate(jnp.asarray(free), mesh),
        JS.shard_leading(ii, mesh), JS.shard_leading(jj, mesh),
        JS.shard_leading(mask, mesh),
        tuple(JS.shard_leading(ch, mesh) for ch in meas), extra)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rays", "calib"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_edge_system_matches_single_and_jax(n, kind, compute,
                                                    monkeypatch):
    """The per-slot systems summed onto the first slot equal one build of
    all edges, and JAX's ``shard_map`` + ``psum`` of its Pallas kernel
    (interpret mode), within the Gram tolerances; each slot launched its
    own build (counted by the accumulate calls)."""
    monkeypatch.setattr(JK, "_TNL", 128)
    T, ii, jj, mask, meas, free = _problem(kind)
    tm = tuple(t_(np.array(ch)) for ch in meas)
    args = [t_(np.array(a)) for a in (T, ii, jj, mask)] + [t_(free)]
    T_t, ii_t, jj_t, mask_t, free_t = args
    extra = (t_(K),) if kind == "calib" else ()
    accum = _port_accum(kind, compute)
    calls = []

    def counted(*a):
        calls.append(a[2].shape[0])
        return accum(*a)

    single = accum(T_t, tm, ii_t, jj_t, mask_t, free_t, *extra)
    sharded = TFG._shard_edge_system(_cpu_mesh(n), counted, T_t, free_t,
                                     ii_t, jj_t, mask_t, tm, extra)
    assert calls == [E2 // n] * n
    assert float(single[2]) > 0
    err = TFG.system_error(sharded, single)
    assert err <= TOL[compute], err
    want = _jax_sharded(kind, compute, n, T, ii, jj, mask, meas, free)
    err_jax = TFG.system_error(sharded, tuple(t_(np.array(a)) for a in want))
    assert err_jax <= TOL[compute], err_jax


def test_system_error_sees_a_dropped_slot():
    """The check itself: a system missing one slot's edges fails it by far
    more than the tolerance."""
    T, ii, jj, mask, meas, free = _problem("rays")
    tm = tuple(t_(np.array(ch)) for ch in meas)
    T_t, ii_t, jj_t, mask_t = (t_(np.array(a)) for a in (T, ii, jj, mask))
    accum = _port_accum("rays", "float32")
    full = accum(T_t, tm, ii_t, jj_t, mask_t, t_(free))
    part = accum(T_t, tuple(ch[:6] for ch in tm), ii_t[:6], jj_t[:6],
                 mask_t[:6], t_(free))
    assert TFG.system_error(part, full) > 1e3 * TOL["float32"]
    assert TFG.system_error(full, full) == 0.0


@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_gauss_newton_on_a_mesh_matches_one_device(kind):
    """The LM solve with its systems built over 4 slots against the same
    solve on one device, on ``test_torch_factor_graph.py``'s LM scenes
    (float32 rows)."""
    if kind == "rays":
        T_in, meas, ii, jj, mask, free = _lm_scene()
        tm = tuple(t_(np.array(ch)) for ch in meas)

        def solve(mesh):
            return TFG.gauss_newton_rays(
                t_(T_in), tm, t_(ii), t_(jj), t_(mask), t_(free), 0.003,
                10.0, 12, 1e-9, compute_dtype="float32", mesh=mesh)
    else:
        T_in, meas, K_, ii, jj, mask, hw = _calib_scene()
        tm = tuple(t_(np.array(ch)) for ch in meas)
        free = np.asarray([False, True, True])

        def solve(mesh):
            return TFG.gauss_newton_calib(
                t_(T_in), tm, t_(K_), t_(ii), t_(jj), t_(mask), t_(free), hw,
                -10.0, 1e-6, 1.0, 10.0, 10, 1e-9, compute_dtype="float32",
                mesh=mesh)
    T1, it1 = solve(None)
    T4, it4 = solve(_cpu_mesh(4))
    assert it1 == it4 >= 1
    assert (T1 - t_(T_in)).abs().max() > 1e-3     # the solve moved
    assert (T4 - T1).abs().max() <= 1e-5


def _old_shard_edge_system(mesh, accum, T, free_mask, ii, jj, edge_mask,
                           meas, extra_arrays=()):
    """The mesh system build as the port ran it before a solve split its
    edges once: every build splits the edges and channels and replicates
    ``T``, ``free_mask`` and the extras anew (the reference of the
    restructured solve)."""
    parts = [S.shard_leading(a, mesh) for a in (ii, jj, edge_mask)]
    meas_parts = [S.shard_leading(ch, mesh) for ch in meas]
    reps = [S.replicate(a, mesh) for a in (T, free_mask, *extra_arrays)]
    outs = []
    for k in range(mesh.size):
        T_k, free_k, *extras = (r[k] for r in reps)
        ii_k, jj_k, mask_k = (p[k] for p in parts)
        outs.append(accum(T_k, tuple(m[k] for m in meas_parts), ii_k, jj_k,
                          mask_k, free_k, *extras))
    H, g, cost = outs[0]
    for H_k, g_k, cost_k in outs[1:]:
        H = H + H_k.to(mesh.first)
        g = g + g_k.to(mesh.first)
        cost = cost + cost_k.to(mesh.first)
    return H, g, cost


def _mesh_scene(kind):
    """The LM scene of ``kind`` as port tensors: the solver's arguments
    before the edges (``T_WC`` and, for calib, ``K``), the edges ``(ii, jj,
    mask, free)``, the channels, the positional settings after
    ``free_mask`` and the accumulate of :func:`TFG._accumulate_rays` /
    ``_calib`` at those settings."""
    if kind == "rays":
        T_in, meas, ii, jj, mask, free = _lm_scene()
        head = (t_(T_in),)
        args = (0.003, 10.0, 12, 1e-9)

        def accum(T, m, ii_, jj_, mask_, free_):
            return TFG._accumulate_rays(T, m, ii_, jj_, mask_, free_, 3,
                                        0.003, 10.0,
                                        compute_dtype=torch.float32)
    else:
        T_in, meas, K_, ii, jj, mask, hw = _calib_scene()
        free = np.asarray([False, True, True])
        head = (t_(T_in), t_(K_))
        args = (hw, -10.0, 1e-6, 1.0, 10.0, 10, 1e-9)

        def accum(T, m, ii_, jj_, mask_, free_, K__):
            return TFG._accumulate_calib(T, m, K__, ii_, jj_, mask_, free_,
                                         3, hw, -10.0, 1e-6, 1.0, 10.0,
                                         compute_dtype=torch.float32)
    edges = tuple(t_(np.asarray(a)) for a in (ii, jj, mask, free))
    return head, edges, tuple(t_(np.array(ch)) for ch in meas), args, accum


def _mesh_solve(kind, mesh, graphs=None):
    head, (ii, jj, mask, free), meas, args, _ = _mesh_scene(kind)
    fn = TFG.gauss_newton_rays if kind == "rays" else TFG.gauss_newton_calib
    if kind == "rays":
        return fn(head[0], meas, ii, jj, mask, free, *args,
                  compute_dtype="float32", mesh=mesh, graphs=graphs)
    return fn(head[0], meas, head[1], ii, jj, mask, free, *args,
              compute_dtype="float32", mesh=mesh, graphs=graphs)


@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_mesh_solve_with_its_split_inside_equals_the_old_mesh_path(kind):
    """The solve splits its edges over the slots once (inside the captured
    computation on a card); on a 4-slot CPU mesh its poses and iterations
    are bit for bit those of the old eager mesh loop, which split and
    replicated everything at every system build."""
    head, (ii, jj, mask, free), meas, args, accum = _mesh_scene(kind)
    mesh = _cpu_mesh(4)
    extra = head[1:]
    cap = head[0].shape[0]
    max_iter, delta = args[-2:]

    def system(T):
        return _old_shard_edge_system(mesh, accum, T, free, ii, jj, mask,
                                      meas, extra)

    T_old, it_old = TFG._lm_loop(system, head[0], free, cap, max_iter,
                                 delta, 1e-4)
    T_new, it_new = _mesh_solve(kind, mesh)
    assert int(it_new) == int(it_old) >= 1
    assert torch.equal(T_new, T_old)
    assert (T_new - head[0]).abs().max() > 1e-3


class _EagerPieces:
    """Runs what ``GraphCache.run`` would capture as a plain call, and
    records the keys."""

    def __init__(self):
        self.keys = []

    def run(self, key, fn, inputs, **kw):
        self.keys.append(key)
        return fn(*inputs)


@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_hosted_mesh_loop_equals_the_device_loop(kind):
    """The loop that a mesh over distinct cards runs as graphs (each slot's
    system build, the step's solve and its accept rules; the exit read on
    the host), its pieces run as plain calls: poses and iterations bit for
    bit those of the single-loop mesh solve, one build per slot and system
    build. Two names of the CPU make the mesh's devices distinct."""
    cpu0 = torch.device("cpu", 0)
    mesh = S.DeviceMesh((CPU, cpu0, CPU, cpu0), (1, 2, 3, 4))
    assert len(mesh.distinct()) == 2
    pieces = _EagerPieces()
    T_h, it_h = _mesh_solve(kind, mesh, graphs=pieces)
    T_m, it_m = _mesh_solve(kind, _cpu_mesh(4))
    n = int(it_h)
    assert n == int(it_m) >= 1
    assert torch.equal(T_h, T_m)
    parts = [k[-2] if k[-2] == "build" else k[-1] for k in pieces.keys]
    assert parts.count("build") == 4 * (1 + n)
    assert parts.count("sum") == 1
    assert parts.count("propose") == parts.count("accept") == n


def _placed(edges, slots):
    """``edges`` consecutive edges solved by the port's and JAX's
    FactorGraph on a ``slots``-slot backend mesh: (port graph, JAX graph,
    port poses, JAX poses)."""
    from jax.sharding import Mesh

    kj, kt = _buffers(edges + 1, noise=0.02)
    jmesh = Mesh(np.asarray(jax.devices()[1:slots + 1]), (JS.EDGE_AXIS,))
    gj = JFG.FactorGraph(StubModel(False), kj, CFG, mesh=jmesh,
                         home_device=jax.devices()[0])
    gt = TFG.FactorGraph(StubModel(True), kt, CFG, mesh=_cpu_mesh(slots),
                         home_device=CPU)
    for g in (gj, gt):
        assert g.add_factors(list(range(edges)), list(range(1, edges + 1)),
                             0.0)
        g.solve_GN_rays()
    return gt, gj, kt.T_WC, kj.T_WC


@pytest.mark.parametrize("edges,slots,placed", [
    (1, 4, "sharded"), (3, 3, "fallback_single_device"),
    (4, 3, "fallback_single_device"), (5, 2, "sharded")])
def test_factor_graph_mesh_placement_matches_jax(edges, slots, placed):
    """The JAX package's placement: the mesh shards the padded bucket (8
    two-way rows, 16 for five edges) when its size divides it, else the
    first backend slot solves alone; the same ``solve_stats`` as JAX's
    FactorGraph and its poses within 1e-4."""
    gt, gj, T_t, T_j = _placed(edges, slots)
    assert gt.solve_stats == gj.solve_stats
    assert gt.solve_stats[placed] == 1
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# The sharded pair decode
# ---------------------------------------------------------------------------

H, W = 32, 48


@pytest.fixture(scope="module")
def decode_inputs():
    cj, pj, ct, pt = tiny_weights()
    pj, pt = JM.prepare_params(pj, cj), TM.prepare_params(pt, ct)
    n_tok = (H // 16) * (W // 16)
    rng = np.random.default_rng(11)
    feats = [rng.normal(size=(3, n_tok, ct.enc_embed_dim)).astype(np.float32)
             for _ in range(2)]
    pos = TM.patch_positions(H // 16, W // 16, 3, "cpu")
    return cj, pj, ct, pt, feats, pos


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_decode_pads_and_matches(decode_inputs, n):
    """Three pairs on 2 and 4 slots (padded to 4): the same outputs as the
    unsharded decode and as JAX's sharded decode, trimmed back to 3 pairs,
    one decoder call per slot."""
    from jax.sharding import Mesh

    from mast3r_slam_tpu_torch.models import inference as TI

    cj, pj, ct, pt, feats, pos = decode_inputs
    fi, fj = t_(feats[0]), t_(feats[1])
    plain = MASt3RInference(pt, ct).decode_symmetric_batch(fi, pos, fj, pos,
                                                           (H, W))
    model = MASt3RInference(pt, ct, mesh=_cpu_mesh(n))
    # one device: every slot shares one replica, whose tensors are pt's
    assert len({id(p) for p in model.params_mesh}) == 1
    rn0 = model.params_mesh[-1]["head1"]["dpt"]["rn0"]["w"]
    assert rn0 is pt["head1"]["dpt"]["rn0"]["w"]
    core, batches = TI._decode_symmetric_core, []

    def counted(params, cfg, f_i, *a, **kw):
        batches.append(f_i.shape[0])
        return core(params, cfg, f_i, *a, **kw)

    TI._decode_symmetric_core = counted
    try:
        got = model.decode_symmetric_batch(fi, pos, fj, pos, (H, W))
    finally:
        TI._decode_symmetric_core = core
    assert batches == [S.pad_to_multiple(3, n) // n] * n
    jmesh = Mesh(np.asarray(jax.devices()[:n]), (JS.EDGE_AXIS,))
    jpos = jnp.asarray(pos.numpy())
    want = JInference(pj, cj, mesh=jmesh).decode_symmetric_batch(
        jnp.asarray(feats[0]), jpos, jnp.asarray(feats[1]), jpos, (H, W))
    for g, p, w in zip(got, plain, want):
        assert g.shape == p.shape and g.shape[:2] == (4, 3)
        assert_close(g, p)
        assert_close(g, w)


def test_match_symmetric_on_a_mesh_takes_frontend_warm_starts(
        decode_inputs):
    """Warm starts made on the frontend are moved to where the decode
    outputs are; on one physical device the mesh path gives the one-device
    path's matches."""
    _, _, ct, pt, feats, pos = decode_inputs
    fi, fj = t_(feats[0][:2]), t_(feats[1][:2])
    p2 = pos[:2]
    n = H * W
    init = torch.arange(n).flip(0).expand(2, n)
    kw = dict(init_i2j=init, init_j2i=init)
    cfg = {"radius": 1, "dilation_max": 2}
    one = MASt3RInference(pt, ct, cfg).match_symmetric(fi, p2, fj, p2,
                                                       (H, W), **kw)
    two = MASt3RInference(pt, ct, cfg, mesh=_cpu_mesh(2)).match_symmetric(
        fi, p2, fj, p2, (H, W), **kw)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# FactorGraph on a mesh
# ---------------------------------------------------------------------------

def test_factor_graph_mesh_fallback_on_three_slots():
    """A 3-slot backend with one edge (two two-way rows, fewer than the
    slots) solves on its first slot, twice (the second solve finds the
    poses homed on the frontend device), counts the fallback, and ends
    where the solve without a mesh ends."""
    _, kt = _buffers(5, noise=0.02)
    g = TFG.FactorGraph(StubModel(True), kt, CFG, mesh=_cpu_mesh(3),
                        home_device=CPU)
    assert g.add_factors([0], [1], 0.0)
    T0 = kt.T_WC[:5].clone()
    g.solve_GN_rays()
    g.solve_GN_rays()
    assert g.solve_stats == {"sharded": 0, "fallback_single_device": 2}
    assert (kt.T_WC[1] - T0[1]).abs().max() > 1e-6
    _, k2 = _buffers(5, noise=0.02)
    g2 = TFG.FactorGraph(StubModel(True), k2, CFG)
    assert g2.add_factors([0], [1], 0.0)
    g2.solve_GN_rays()
    g2.solve_GN_rays()
    assert torch.equal(kt.T_WC, k2.T_WC)


def test_factor_graph_mesh_solve_matches_one_device_and_jax():
    """Three edges (six two-way rows) on a 4-slot backend: a sharded solve,
    the poses of the one-device solve within 1e-5, and of JAX's
    FactorGraph on a 4-device mesh within 1e-4 (its XLA system build, as
    ``test_torch_factor_graph.py`` holds the one-device graphs)."""
    from jax.sharding import Mesh

    kj, kt = _buffers(noise=0.02)
    _, k1 = _buffers(noise=0.02)
    jmesh = Mesh(np.asarray(jax.devices()[1:5]), (JS.EDGE_AXIS,))
    gj = JFG.FactorGraph(StubModel(False), kj, CFG, mesh=jmesh,
                         home_device=jax.devices()[0])
    gt = TFG.FactorGraph(StubModel(True), kt, CFG, mesh=_cpu_mesh(4),
                         home_device=CPU)
    g1 = TFG.FactorGraph(StubModel(True), k1, CFG)
    for g in (gj, gt, g1):
        assert g.add_factors([0, 1, 2], [1, 2, 3], 0.0)
        g.solve_GN_rays()
    assert gt.solve_stats == {"sharded": 1, "fallback_single_device": 0}
    assert gj.solve_stats["sharded"] == 1
    assert (kt.T_WC - k1.T_WC).abs().max() <= 1e-5
    np.testing.assert_allclose(kt.T_WC.numpy(), np.asarray(kj.T_WC),
                               rtol=0, atol=1e-4)


def test_hint_warm_starts_the_symmetric_matcher_on_a_mesh():
    """Under a mesh a 5-tuple hint is not reused as the edge's j->i
    direction (the JAX package's mesh path): it becomes that direction's
    warm start, and every edge is decoded symmetrically."""
    class Recorder(StubModel):
        def __init__(self):
            super().__init__(True)
            self.inits = []

        def match_symmetric(self, *a, init_i2j=None, init_j2i=None):
            self.inits.append(init_j2i)
            return super().match_symmetric(*a)

        def match_oneway(self, *a, **kw):
            raise AssertionError("the hint was reused under a mesh")

    _, kt = _buffers(3, noise=0.0)
    n = kt.h * kt.w
    hint_idx = torch.arange(n).flip(0)
    hint = (0, 1, hint_idx, torch.ones(n, 1, dtype=torch.bool),
            torch.ones(n, 1))
    model = Recorder()
    cfg = {"local_opt": dict(CFG["local_opt"], warm_start_geo=False)}
    g = TFG.FactorGraph(model, kt, cfg, mesh=_cpu_mesh(2))
    assert g.add_factors([0, 1], [1, 2], 0.0, init_hint=hint)
    init = model.inits[0]
    assert torch.equal(init[0], hint_idx)
    assert torch.equal(init[1], torch.arange(n))


# ---------------------------------------------------------------------------
# The CLI on 8 virtual slots (the counterpart of test_e2e_multichip.py)
# ---------------------------------------------------------------------------

N_FRAMES = 9


def _clip(root):
    from mast3r_slam_tpu_torch.data import png

    (root / "rgb").mkdir(parents=True)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:64, 0:96].astype(np.float64)
    freqs = rng.uniform(0.01, 0.05, (3, 2))
    phases = rng.uniform(0, 2 * np.pi, 3)
    rows = []
    for i in range(N_FRAMES):
        p = min(i, N_FRAMES - 1 - i)
        x, y = xx + 2.0 * p, yy + 0.7 * p
        img = np.stack([np.sin(fx * x + fy * y + ph)
                        for (fx, fy), ph in zip(freqs, phases)], -1)
        png.write_png(root / "rgb" / f"{i:04d}.png",
                      ((0.9 * img + 1.0) * 127.5).astype(np.uint8))
        rows.append(f"{1e9 + i / 30.0:.6f} rgb/{i:04d}.png")
    (root / "rgb.txt").write_text("# ts file\n" + "\n".join(rows) + "\n")
    return root


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli_mesh")
    clip = _clip(base / "synth_tum_mesh")
    cfg = {
        "inherit": str(REPO / "config" / "base.yaml"),
        "single_thread": True,
        "dataset": {"img_size": 96},
        "model": {"preset": "tiny"},
        "tracking": {"min_match_frac": 0.0, "match_frac_thresh": 0.9,
                     "Q_conf": 0.0, "sigma_dist": 0.1},
        "local_opt": {"min_match_frac": 0.0, "Q_conf": 0.0,
                      "sigma_dist": 0.1, "meas_dtype": "float32",
                      "ba_compute_dtype": "float32"},
        "retrieval": {"k": 2, "min_thresh": 0.0},
        "quality": {"enabled": False},
        "tsdf_refine": {"enabled": False},
        "tsdf_global": {"enabled": False},
    }
    path = base / "tiny_mesh.yaml"
    path.write_text(yaml.safe_dump(cfg))
    _, _, ct, pt = tiny_weights(tie_streams=True)
    return base, clip, path, cfg, TM.prepare_params(pt, ct), ct


def _run_cli(cli_setup, tag, devices, **over):
    from mast3r_slam_tpu_torch.utils.config import merge_config

    base, clip, path, cfg, params, ct = cli_setup
    if over:
        path = base / f"{tag}.yaml"
        path.write_text(yaml.safe_dump(merge_config(cfg, over)))
    model = MASt3RInference(params, ct, cfg.get("matching", {}))
    cwd = os.getcwd()
    os.chdir(base)
    try:
        return tcli.main(["--dataset", str(clip), "--config", str(path),
                          "--no-viz", "--save-as", tag], device="cpu",
                         model=model, devices=devices)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def mesh_runs(cli_setup):
    return (_run_cli(cli_setup, "one", None),
            _run_cli(cli_setup, "eight", [CPU] * 8))


def test_cli_on_8_slots_matches_one_slot(mesh_runs):
    one, eight = mesh_runs
    assert one["topo"].backend_mesh is None
    assert eight["frames_processed"] == one["frames_processed"] == N_FRAMES
    assert eight["modes"] == one["modes"]
    n = len(one["keyframes"])
    assert len(eight["keyframes"]) == n >= 3
    np.testing.assert_array_equal(eight["keyframes"].dataset_idx[:n],
                                  one["keyframes"].dataset_idx[:n])
    for key in ("ii", "jj"):
        np.testing.assert_array_equal(getattr(eight["graph"], key),
                                      getattr(one["graph"], key))
    stats = eight["graph"].solve_stats
    assert stats["sharded"] >= 1, stats
    assert one["graph"].solve_stats == {"sharded": 0,
                                        "fallback_single_device": 0}


def test_cli_on_8_slots_plans_the_jax_topology(mesh_runs):
    topo = mesh_runs[1]["topo"]
    want = JT.plan_topology(jax.devices()[:8])
    assert topo.backend == tuple(d.id for d in want.backend_mesh.devices.flat)
    assert (topo.frontend, topo.quality, topo.tsdf_local,
            topo.tsdf_global) == tuple(d.id for d in (
                want.frontend_device, want.quality_device,
                want.tsdf_local_device, want.tsdf_global_device))
    assert mesh_runs[1]["graph"].mesh == topo.backend_mesh
    assert mesh_runs[1]["graph"].model.mesh == topo.backend_mesh


def test_cli_on_8_slots_threaded_with_services(cli_setup):
    """Threaded backend, the quality service, the refiner and the global
    TSDF on their planned slots (test_e2e_multichip.py's run): every
    frame, a mesh solve, the services drained, no worker alive."""
    out = _run_cli(
        cli_setup, "eight_threaded", [CPU] * 8, single_thread=False,
        quality={"enabled": True},
        tsdf_refine={"enabled": True, "window_size": 1, "ray_samples": 8,
                     "max_grid_dim": 16, "min_hit_rate": 0.0,
                     "max_displacement": 1.0, "quality_wait_ms": 5000,
                     "min_shutdown_wait_s": 1},
        tsdf_global={"enabled": True, "samples_per_kf": 64,
                     "max_points_per_kf": 256, "table_capacity": 65536})
    assert out["frames_processed"] == N_FRAMES
    st = out["states"]
    assert st.global_optimizer_tasks == [] and st.reloc_sem == 0
    stats = out["graph"].solve_stats
    assert stats["sharded"] + stats["fallback_single_device"] >= 1, stats
    assert out["quality"].processed_jobs >= 1
    assert not out["quality"].is_alive() and not out["refiner"].is_alive()
    m = out["tsdf_manager"]
    assert not m.integrator.is_alive() and not m.opt_thread.is_alive()
    traj = out["keyframes"].T_WC[:len(out["keyframes"])]
    assert bool(torch.isfinite(traj).all())

