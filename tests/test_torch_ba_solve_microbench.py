"""The port's BA solve microbenchmark (``bench/ba_solve_microbench.py``)
against the JAX repo's ``scripts/ba_solve_microbench.py``: the same inputs
(the script run with its timing helper ``amortized`` replaced by a recorder
hands over every piece's inputs), each piece against its JAX counterpart
on those inputs within 1e-5 relative, the K-rep arithmetic, and its main
at a small size on the CPU."""

import importlib.util
import inspect
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import jax.scipy.linalg
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import lie as JL
from mast3r_slam_tpu.slam import factor_graph as JFG
from mast3r_slam_tpu_torch.bench import ba_solve_microbench as MB
from mast3r_slam_tpu_torch.ops import lie as TL
from torch_parity import torch_one_thread  # noqa: F401

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "ba_solve_microbench.py"
REL = 1e-5


def _script():
    spec = importlib.util.spec_from_file_location("_jax_ba_solve_micro",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _closure(fn):
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__ or ())))


@pytest.fixture(scope="module")
def script_inputs():
    """Every piece's inputs as the script builds them: its ``amortized``
    records ``(step, args)`` and returns 0, so the script runs through."""
    mod = _script()
    calls = []

    def record(make_step, *args, reps=8):
        calls.append((make_step, [np.array(a) for a in args]))
        return 0.0

    with mock.patch.object(mod, "amortized", record):
        mod.main()
    assert len(calls) == 6
    scatter = _closure(_closure(calls[0][0])["step"])
    (_, He, ge), (_, Hpd, gs), (_, Hd), (_, Hd2, gd), (_, T, dx) = (
        calls[0][1], calls[2][1], calls[3][1], calls[4][1], calls[5][1])
    np.testing.assert_array_equal(Hd, Hd2)
    return dict(He=He, ge=ge, ii=np.asarray(scatter["ii"]),
                jj=np.asarray(scatter["jj"]),
                free=np.asarray(scatter["free"]), cap=scatter["cap"],
                Hpd=Hpd, gs=gs, Hd=Hd, gd=gd, T=T, dx=dx, mod=mod)


@pytest.fixture(scope="module")
def port_inputs():
    return MB.to_device(MB.make_inputs(), torch.device("cpu"))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_inputs_equal_the_scripts(script_inputs, port_inputs):
    s, t = script_inputs, port_inputs
    assert (MB.CAP, MB.EDGES) == (s["cap"], s["He"].shape[0])
    assert MB.K_REPS == s["mod"].K
    assert inspect.signature(s["mod"].amortized).parameters[
        "reps"].default == MB.REPS
    np.testing.assert_array_equal(t["ge"].numpy(), s["ge"])
    np.testing.assert_array_equal(t["ii"].numpy(), s["ii"])
    np.testing.assert_array_equal(t["jj"].numpy(), s["jj"])
    np.testing.assert_array_equal(t["free"].numpy(), s["free"])
    np.testing.assert_array_equal(t["dx"].numpy(), s["dx"])
    np.testing.assert_array_equal(t["gd"].numpy(), s["gd"])
    # products formed on each side: XLA's and torch's float32 sums
    assert _rel(t["He"].numpy(), s["He"]) <= 1e-6
    assert _rel(t["Hd"].numpy(), s["Hd"]) <= 1e-6
    assert _rel(t["T"].numpy(), s["T"]) <= 1e-6


def test_scatter_and_incidence_assemblies_match_jax(script_inputs):
    s = script_inputs
    cap = s["cap"]
    H0 = jnp.zeros((cap + 1, 7, cap + 1, 7), jnp.float32)
    g0 = jnp.zeros((cap + 1, 7), jnp.float32)
    Hj, gj = JFG._scatter_blocks(H0, g0, jnp.asarray(s["He"]),
                                 jnp.asarray(s["ge"]), jnp.asarray(s["ii"]),
                                 jnp.asarray(s["jj"]),
                                 jnp.asarray(s["free"]), cap)
    args = (torch.from_numpy(s["He"]), torch.from_numpy(s["ge"]),
            torch.from_numpy(s["ii"].astype(np.int64)),
            torch.from_numpy(s["jj"].astype(np.int64)),
            torch.from_numpy(s["free"]), cap)
    Ht, gt = MB.scatter_assembly(*args)
    assert _rel(Ht.numpy(), np.asarray(Hj)) <= REL
    assert _rel(gt.numpy(), np.asarray(gj)) <= REL
    Hm, gm = MB.incidence_assembly(*args)
    n = (cap + 1) * 7
    sym = np.asarray(Hj).reshape(n, n)
    sym = 0.5 * (sym + sym.T)
    assert _rel(MB.symmetrised(Hm).numpy(), sym) <= REL
    assert _rel(gm.numpy(), np.asarray(gj)) <= REL
    # the script's + 10 I on the block diagonal
    np.testing.assert_array_equal(MB.pd_system(torch.from_numpy(np.asarray(
        Hj))).numpy(), s["Hpd"])


def test_solve_system_matches_jax(script_inputs):
    s = script_inputs
    cap = s["cap"]
    dx_j, ok_j = JFG._solve_system(jnp.asarray(s["Hpd"]),
                                   jnp.asarray(s["gs"]),
                                   jnp.asarray(s["free"]), cap, 1e-4)
    from mast3r_slam_tpu_torch.slam import factor_graph as TFG

    dx_t, ok_t = TFG._solve_system(torch.from_numpy(s["Hpd"]),
                                   torch.from_numpy(s["gs"]),
                                   torch.from_numpy(s["free"]), cap, 1e-4)
    assert bool(ok_j) and bool(ok_t)
    assert _rel(dx_t.numpy(), np.asarray(dx_j)) <= REL


def test_cholesky_cho_solve_and_retr_match_jax(script_inputs):
    s = script_inputs
    L_j = jnp.linalg.cholesky(jnp.asarray(s["Hd"]))
    L_t, info = torch.linalg.cholesky_ex(torch.from_numpy(s["Hd"]))
    assert int(info) == 0
    assert _rel(L_t.numpy(), np.asarray(L_j)) <= REL
    x_j = jax.scipy.linalg.cho_solve((L_j, True), jnp.asarray(s["gd"]))
    x_t = torch.cholesky_solve(torch.from_numpy(s["gd"])[:, None], L_t)[:, 0]
    assert _rel(x_t.numpy(), np.asarray(x_j)) <= REL
    T_j = jax.vmap(JL.retr)(jnp.asarray(s["T"]), jnp.asarray(s["dx"]))
    T_t = TL.retr(torch.from_numpy(s["T"]), torch.from_numpy(s["dx"]))
    assert _rel(T_t.numpy(), np.asarray(T_j)) <= REL


def test_pieces_run_their_functions_on_perturbed_inputs(port_inputs):
    """Each piece at rep 0 is the function on the unperturbed input."""
    t = dict(port_inputs)
    steps = MB.pieces(t)
    assert tuple(steps) == MB.PIECES
    H, g = t["H_assembled"], t["g_assembled"]
    assert steps["scatter assembly"](0.0).item() == (H[0, 0, 0, 0]
                                                     + g[0, 0]).item()
    L, _ = torch.linalg.cholesky_ex(t["Hd"])
    assert steps["cholesky 770"](0.0).item() == L[0, 0].item()
    assert steps["lie.retr"](0.0).item() == TL.retr(t["T"], t["dx"])[
        0, 0].item()


def test_k_rep_arithmetic():
    assert MB.per_rep(10.0, 1.0, 32) == pytest.approx(9.0 / 31)
    calls = []

    def step(r):
        calls.append(r)
        return torch.tensor(r)

    assert MB.reps_fn(step, 4)().item() == 0 + 1 + 2 + 3
    assert calls == [0.0, 1.0, 2.0, 3.0]
    calls.clear()
    ms, t_k, t_1, how, why = MB.time_piece(step, 4, 3, torch.device("cpu"))
    assert how == "cpu" and why is None
    assert ms == pytest.approx(MB.per_rep(t_k, t_1, 4))
    # one warm call and 3 timed calls of 4 reps, then of 1 rep
    assert len(calls) == 4 * 4 + 4 * 1


def test_main_on_the_cpu(capsys):
    rec = MB.main(["--cap", "12", "--edges", "16", "--k", "3", "--reps",
                   "2"], device="cpu")
    out = capsys.readouterr().out
    for name in MB.PIECES:
        assert name in out
    assert set(rec) >= {"tool", "cap", "edges", "k", "reps", "ms", "t_k_ms",
                        "t_1_ms", "timing", "h_diff", "h_scale", "g_diff",
                        "solve_ok", "solve_residual", "g_norm", "device"}
    assert set(rec["ms"]) == set(MB.PIECES)
    assert set(rec["timing"].values()) == {"cpu"}
    assert rec["device"].startswith("cpu")
    assert rec["h_diff"] <= 1e-5 * rec["h_scale"]
    assert rec["solve_ok"] and rec["solve_residual"] <= 1e-4 * rec["g_norm"]
