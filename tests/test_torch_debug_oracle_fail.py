"""Port parity: ``bench/debug_oracle_fail.py`` against
``scripts/debug_oracle_fail.py``'s loop (``tests/torch_debug_oracle_jax.py``)
at 12 frames of 64x96, the script's draws.

- without a planted failure: the same per-frame ``ok`` record (no
  failure in 12 frames);
- with a NaN block planted in frame 7's pointmap: the same ``ok`` record,
  the same failing frame and keyframe, and the same LM rows (λ, Cholesky
  and accept flags equal; the costs NaN in both);
- the LM replay itself on the first tracked frame's solve, the same inputs
  to both: flags equal and costs within 1e-4 relative, up to the first row
  whose candidate cost is within 1e-4 of its cost (there the accept rule's
  ``1 + 1e-6`` slack may go either way in float32).
"""

import numpy as np
import pytest
import torch

import torch_debug_oracle_jax as J
from mast3r_slam_tpu_torch.bench import debug_oracle_fail as D
from torch_parity import torch_one_thread  # noqa: F401

FRAMES, HW = 12, (64, 96)
ROW_RTOL = 1e-4


def _quiet(*a):
    pass


@pytest.fixture(scope="module")
def planted():
    return (D.run(FRAMES, HW, "cpu", nan_frame=7, emit=_quiet),
            J.run(FRAMES, HW, nan_frame=7))


def test_unplanted_run_tracks_as_the_script():
    port = D.run(FRAMES, HW, "cpu", emit=_quiet)
    want = J.run(FRAMES, HW)
    assert port["ok"] == want["ok"] == [True] * (FRAMES - 1)
    assert port["failure"] is want["failure"] is None


def test_planted_failure_names_the_same_frame(planted):
    port, want = planted
    assert port["failure"] == want["failure"] == [7, 4]
    assert port["ok"] == want["ok"] == [True] * 6 + [False]
    assert port["H_finite"] is False


def test_planted_failure_lm_rows_match(planted):
    port, want = planted
    assert len(port["rows"]) == len(want["rows"]) == D.LM_ROWS
    for p, w in zip(port["rows"], want["rows"]):
        assert (p["lam"], p["chol"], p["acc"]) == (w[0], w[1], w[4])
        np.testing.assert_allclose([p["cost"], p["cost_cand"]], w[2:4],
                                   rtol=ROW_RTOL, equal_nan=True)
    assert np.isnan(port["init_cost"]) and np.isnan(want["init_cost"])


def test_lm_replay_rows_match_on_a_tracked_frame():
    want = J.run(2, HW)
    Xf, Xk, valid, T_prev, T_k = want["first_inputs"]
    init_w, rows_w = J.lm_rows(*want["first_inputs"])
    init_p, finite, rows_p = D.lm_rows(
        *(torch.from_numpy(np.array(a)) for a in (Xf, Xk, valid, T_prev,
                                                   T_k)))
    assert finite
    np.testing.assert_allclose(init_p, init_w, rtol=ROW_RTOL)
    compared = 0
    for p, w in zip(rows_p, rows_w):
        assert (p["chol"], p["acc"]) == (w[1], w[4])
        np.testing.assert_allclose([p["lam"], p["cost"], p["cost_cand"]],
                                   [w[0], w[2], w[3]], rtol=ROW_RTOL)
        compared += 1
        if abs(w[3] - w[2]) <= ROW_RTOL * abs(w[2]):
            break
    assert compared >= 2 and rows_p[0]["acc"]


def test_tool_prints_rows_and_its_record(capsys):
    rec = D.main([str(FRAMES), "--nan-frame", "7", "--device", "cpu"],
                 device="cpu")
    out = capsys.readouterr().out
    assert "first failure: frame 7 vs kf 4" in out
    assert out.count("\nit ") == D.LM_ROWS
    assert rec["failure"] == [7, 4] and rec["device"] == "cpu"
