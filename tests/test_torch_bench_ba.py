"""The port's deployment-scale BA benchmark (``bench/bench_ba.py``) against
the JAX repo's ``scripts/bench_ba.py``: the keyframe ring bit for bit (the
script run with its premeas and solve replaced by recorders hands over
what it built), the port's solve against the JAX package's on a small ring
(5 and 25 LM iterations, ``delta_thresh`` 0; the JAX Gram in Pallas
interpret mode under float32 rows, its XLA build under bf16 rows, as
``tests/test_torch_factor_graph.py`` holds them), the differencing
arithmetic and its main's JSON line on the CPU."""

import importlib.util
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import lie as JL
from mast3r_slam_tpu.slam import factor_graph as JFG
from mast3r_slam_tpu_torch.bench import ba_solve_microbench as MB
from mast3r_slam_tpu_torch.bench import bench_ba as BB
from mast3r_slam_tpu_torch.slam import factor_graph as TFG
from torch_parity import torch_one_thread  # noqa: F401

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "bench_ba.py"
SMALL = dict(cap=12, edges=16, hw=(24, 32))
# the port's distance to the JAX reference, in units of the distance
# between the JAX package's two builds (see test_solve_matches_jax)
SPREAD = 4.0


class _Stop(Exception):
    pass


@pytest.fixture
def jax_cache_elsewhere(tmp_path, monkeypatch):
    """Importing the script turns on JAX's persistent compile cache
    (``JAX_CACHE_DIR``): point it at a temporary directory, and put the
    process's settings back afterwards."""
    monkeypatch.setenv("JAX_CACHE_DIR", str(tmp_path / "jax_cache"))
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in before.items():
        jax.config.update(k, v)


def _script():
    spec = importlib.util.spec_from_file_location("_jax_bench_ba", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ring_equals_the_scripts(jax_cache_elsewhere, monkeypatch):
    """X, Cavg, ii, jj, idx, valid, Q, mask and free bit for bit; the poses
    (the port's ``lie.exp``) and their variants within 1e-6; the script's
    thresholds, sigmas and first iteration count."""
    mod = _script()
    seen = {}

    def premeas(*args):
        seen["premeas"] = [np.array(a) for a in args[:7]] + list(args[7:])
        return jnp.zeros(())

    def solve(*args, **kw):
        seen["solve"] = [np.array(a) if hasattr(a, "shape") else a
                         for a in args]
        raise _Stop

    monkeypatch.setattr("sys.argv", ["bench_ba.py"])
    with mock.patch.object(mod.FG, "precompute_meas_rays", premeas), \
            mock.patch.object(mod.FG.ba_kernels, "view_sublane_split",
                              lambda m: m), \
            mock.patch.object(mod.FG, "gauss_newton_rays", solve), \
            pytest.raises(_Stop):
        mod.main()
    X, Cavg, ii, jj, idx, valid, Q, c_thr, q_thr = seen["premeas"]
    T_in, _, ii2, jj2, mask, free, s_ray, s_dist, n_iter, delta = \
        seen["solve"]
    ring = BB.make_ring()
    for key, want in (("X", X), ("Cavg", Cavg), ("ii", ii), ("jj", jj),
                      ("idx", idx), ("valid", valid), ("Q", Q),
                      ("mask", mask), ("free", free)):
        got = ring[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    np.testing.assert_array_equal(ii2, ii)
    np.testing.assert_array_equal(jj2, jj)
    assert (c_thr, q_thr) == (BB.C_THRESH, BB.Q_THRESH)
    assert (s_ray, s_dist, n_iter, delta) == (BB.SIGMA_RAY, BB.SIGMA_DIST,
                                              BB.LO, 0.0)
    T, variants = BB.ring_poses(ring["xi"])
    np.testing.assert_allclose(T.numpy(), T_in, rtol=0, atol=1e-6)
    for r, Tv in enumerate(variants):
        want = jax.vmap(JL.retr)(jnp.asarray(T_in),
                                 jnp.full((BB.CAP, 7), 1e-4 * (r + 1)))
        np.testing.assert_allclose(Tv.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def small_ring():
    return BB.make_ring(**SMALL)


def _small_inputs(ring, calib):
    t = BB.to_device(ring, torch.device("cpu"))
    meas = tuple(ch.contiguous() for ch in BB.premeas(
        t, calib, 1, ring["hw"]))
    T, _ = BB.ring_poses(ring["xi"])
    return t, meas, T


def _jax_solve(kind, T, meas, ring, n, dtype, interpret):
    edges = [jnp.asarray(ring[k]) for k in ("ii", "jj", "mask", "free")]
    j_meas = tuple(jnp.asarray(ch.numpy()) for ch in meas)
    T = jnp.asarray(T.numpy())
    if kind == "calib":
        return np.asarray(JFG.gauss_newton_calib(
            T, j_meas, jnp.asarray(BB.intrinsics(ring["hw"]).numpy()),
            *edges, ring["hw"], BB.PIXEL_BORDER, BB.Z_EPS, BB.SIGMA_PIXEL,
            BB.SIGMA_DEPTH, n, 0.0, compute_dtype=dtype,
            pallas_interpret=interpret))
    return np.asarray(JFG.gauss_newton_rays(
        T, j_meas, *edges, BB.SIGMA_RAY, BB.SIGMA_DIST, n, 0.0,
        compute_dtype=dtype, pallas_interpret=interpret))


@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_first_system_and_step_match_jax(small_ring, kind):
    """The system at the ring's poses (float32 rows: the JAX Pallas Gram
    in interpret mode) within 1e-5 of each entry's own scale
    (``factor_graph.system_error``), and the LM's first damped step from
    it as close to the float64 solve of the same system as JAX's step
    (within twice its distance)."""
    t, meas, T = _small_inputs(small_ring, kind == "calib")
    r, hw = small_ring, small_ring["hw"]
    cap = T.shape[0]
    edges = (t["ii"], t["jj"], t["mask"], t["free"])
    j_edges = [jnp.asarray(r[k]) for k in ("ii", "jj", "mask", "free")]
    j_meas = tuple(jnp.asarray(ch.numpy()) for ch in meas)
    if kind == "calib":
        K = BB.intrinsics(hw)
        got = TFG._accumulate_calib(
            T, meas, K, *edges, cap, hw, BB.PIXEL_BORDER, BB.Z_EPS,
            BB.SIGMA_PIXEL, BB.SIGMA_DEPTH, compute_dtype=torch.float32)
        want = JFG._accumulate_pallas_calib(
            jnp.asarray(T.numpy()), j_meas, jnp.asarray(K.numpy()),
            *j_edges, cap, hw, BB.PIXEL_BORDER, BB.Z_EPS, BB.SIGMA_PIXEL,
            BB.SIGMA_DEPTH, compute_dtype=jnp.float32, interpret=True)
    else:
        got = TFG._accumulate_rays(T, meas, *edges, cap, BB.SIGMA_RAY,
                                   BB.SIGMA_DIST,
                                   compute_dtype=torch.float32)
        want = JFG._accumulate_pallas_rays(
            jnp.asarray(T.numpy()), j_meas, *j_edges, cap, BB.SIGMA_RAY,
            BB.SIGMA_DIST, compute_dtype=jnp.float32, interpret=True)
    want = tuple(torch.from_numpy(np.array(w)) for w in want)
    assert TFG.system_error(got, want) <= 1e-5
    dx_j, ok_j = JFG._solve_system(jnp.asarray(want[0].numpy()),
                                   jnp.asarray(want[1].numpy()),
                                   j_edges[3], cap, 1e-4)
    dx_t, ok_t = TFG._solve_system(want[0], want[1], t["free"], cap, 1e-4)
    assert bool(ok_j) and bool(ok_t)
    # the damped system has a condition number near 1e4 (poses held by one
    # edge, fixed and unused poses' identity rows): both float32 steps are
    # ~6e-4 from the float64 step of the same matrix, so the port's must be
    # as close to it as JAX's
    A = MB.solved_system(want[0], t["free"], cap, 1e-4).numpy()
    free7 = np.repeat(r["free"], 7)
    b = np.where(free7, want[1][:cap].reshape(-1).double().numpy(), 0.0)
    dx64 = np.linalg.solve(A, b).reshape(cap, 7)
    err_j = np.abs(np.asarray(dx_j) - dx64).max()
    err_t = np.abs(dx_t.numpy() - dx64).max()
    assert err_t <= max(2.0 * err_j, 1e-6 * np.abs(dx64).max()), (err_t,
                                                                  err_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_solve_matches_jax(small_ring, kind, dtype):
    """The benchmark's solve (``bench_ba.solver``) against the JAX
    package's ``gauss_newton_rays`` / ``gauss_newton_calib`` on the same
    channels, 5 and 25 LM iterations, every one run (``delta_thresh`` 0).
    The reference is the JAX Gram in Pallas interpret mode under float32
    rows and its XLA build under bf16 rows. On this ring (matches drawn
    within three image rows of the identity: noise to the BA) the LM moves
    poses by 2-7 units and its accept / reject decisions are float32
    near-ties, so the JAX package's own two builds of the same solve part
    by 2e-4 to 4e-2; the port's poses must lie within 1e-5 (float32 rows)
    or 1e-3 (bf16 rows) of the reference, or within ``SPREAD`` times the
    distance between those two builds, whichever is larger."""
    calib = kind == "calib"
    t, meas, T = _small_inputs(small_ring, calib)
    solve = BB.solver(t, meas, calib, dtype, small_ring["hw"])
    f32 = dtype == "float32"
    for n in (BB.LO, BB.HI):
        T_t, iters = solve(T, n)
        assert int(iters) == n
        assert torch.isfinite(T_t).all()
        want = _jax_solve(kind, T, meas, small_ring, n, dtype, f32)
        other = _jax_solve(kind, T, meas, small_ring, n, dtype, not f32)
        assert np.abs(want - T.numpy()).max() > 1e-2      # the solve moved
        spread = np.abs(want - other).max()
        err = np.abs(T_t.numpy() - want).max()
        assert err <= max(1e-5 if f32 else 1e-3, SPREAD * spread), (
            n, err, spread)


def test_premeas_matches_jax(small_ring):
    """The ring's channels are the JAX package's (rays; the calibrated
    ones on the ray-constrained points as ``FactorGraph`` takes them)."""
    t, meas, _ = _small_inputs(small_ring, False)
    r = small_ring
    want = JFG.precompute_meas_rays(
        *(jnp.asarray(r[k]) for k in ("X", "Cavg", "ii", "jj", "idx",
                                      "valid", "Q")), BB.C_THRESH,
        BB.Q_THRESH)
    for g, w in zip(meas, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-7,
                                   atol=0)


def test_differencing():
    """The script's arithmetic on set timings, from the medians."""
    assert BB.difference(10.0, 50.0) == (2.0, 0.0)
    assert BB.difference(12.0, 52.0, 5, 25) == (2.0, 2.0)
    per, pre = BB.difference(30.0, 20.0)
    assert per < 0 and pre == pytest.approx(30.0 - 5 * per)

    def runs(lo, hi):
        return {n: dict(first_ms=1.0, ms=ms, median_ms=float(np.median(ms)),
                        iterations=[n] * 3, launches=[{}] * 3,
                        poses=[torch.zeros(2, 8)])
                for n, ms in ((BB.LO, lo), (BB.HI, hi))}

    s = BB._summary(runs([9.0, 30.0, 10.0], [49.0, 52.0, 50.0]))
    assert s["median_ms"] == {"5": 10.0, "25": 50.0}
    assert (s["per_iter_ms"], s["pre_ms"]) == (2.0, 0.0)


@pytest.mark.parametrize("calib", [False, True])
def test_main_on_the_cpu(capsys, calib):
    argv = ["--cap", "12", "--edges", "16", "--hw", "24", "32", "--reps",
            "2", "--dtype", "float32"] + (["--calib"] if calib else [])
    rec = BB.main(argv, device="cpu")
    out = capsys.readouterr().out
    for line in ("premeas first call", "premeas (warm)", "[eager] solve(5 "
                 "iters)", "per-GN-iteration", "precompute+overhead"):
        assert line in out
    assert set(rec) == {"tool", "kind", "dtype", "cap", "edges", "pixels",
                        "pixel_step", "iters", "reps", "premeas_first_ms",
                        "premeas_ms", "graphed", "eager", "finite",
                        "same_bits", "pool_bytes", "buffer_bytes",
                        "meas_bytes", "trace", "peak_bytes", "device"}
    e = rec["eager"]
    assert set(e) == {"first_ms", "ms", "median_ms", "per_iter_ms",
                      "pre_ms", "iterations", "launches", "checksums"}
    assert e["iterations"] == {"5": [5, 5], "25": [25, 25]}
    assert rec["graphed"] is None and rec["same_bits"] is None
    assert rec["kind"] == ("calib" if calib else "rays") and rec["finite"]
    assert rec["device"].startswith("cpu")
    assert rec["meas_bytes"] == (7 if calib else 8) * 16 * 24 * 32 * 4
