"""Port parity for the slice as a whole: ``run_oracle_slam`` (tracking with
the port's matcher and pose solvers, then keyframe BA through
``slam/factor_graph.py`` and K4 / K5's plain versions) against the JAX
package's run on the same oracle scene, 32x48, 16 frames.

The JAX BA runs its Pallas Gram in interpret mode, the per-pixel formula
of the port's kernels. Keyframe ids and skips must be equal; the BA poses
agree to 1e-4 under the strict settings (float32 channels and rows) and to
1e-3 under the production ones (bf16 channels and rows, 1e-2 delta exit);
the ATE bounds are ``tests/test_oracle_modes.py``'s."""

import functools

import numpy as np
import pytest

from mast3r_slam_tpu.slam import factor_graph as JFG
from mast3r_slam_tpu.utils import oracle_scene as JO
from mast3r_slam_tpu_torch.utils import oracle_scene as TO
from torch_parity import torch_one_thread  # noqa: F401

HW = (32, 48)
N_FRAMES = 16
STRICT = dict(refine_mode="joint", level_step=1, plateau_frac=0.0,
              ba_pixel_step=1, ba_compute_dtype="float32",
              ba_delta_norm=1e-8)
FAST = dict(refine_mode="plus", level_step=2, plateau_frac=0.001,
            radius=2, proj_step=2, track_dilation_max=1,
            ba_pixel_step=2, ba_meas_dtype="bfloat16",
            ba_compute_dtype="bfloat16", ba_delta_norm=1e-2)
RUNS = {"strict": (STRICT, False, 1e-4), "fast": (FAST, False, 1e-3),
        "calib": (FAST, True, 1e-3)}


@pytest.fixture(scope="module")
def runs():
    poses = TO.make_trajectory(N_FRAMES)
    mp = pytest.MonkeyPatch()
    for name in ("gauss_newton_rays", "gauss_newton_calib"):
        mp.setattr(JFG, name, functools.partial(getattr(JFG, name),
                                                pallas_interpret=True))
    out = {}
    try:
        for key, (mode, calib, _) in RUNS.items():
            out[key] = (
                JO.run_oracle_slam(JO.OracleScene(seed=0), poses, HW, mode,
                                   use_calib=calib),
                TO.run_oracle_slam(TO.OracleScene(seed=0), poses, HW, mode,
                                   use_calib=calib, device="cpu"))
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("key", list(RUNS))
def test_oracle_run_matches_jax(runs, key):
    rj, rt = runs[key]
    tol = RUNS[key][2]
    assert rt["kf_ids"] == rj["kf_ids"] and len(rt["kf_ids"]) == 4
    assert rt["n_skipped"] == rj["n_skipped"] == 0
    assert rt["n_relocs"] == rj["n_relocs"]
    np.testing.assert_allclose(rt["T_kf_track"], rj["T_kf_track"], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(rt["T_kf_ba"], np.asarray(rj["T_kf_ba"]),
                               rtol=0, atol=tol)
    assert abs(rt["mean_pix_err"] - rj["mean_pix_err"]) < 1e-6


@pytest.mark.parametrize("key", list(RUNS))
def test_oracle_run_recovers_trajectory(runs, key):
    """``tests/test_oracle_modes.py``'s bounds on the port's runs."""
    r = runs[key][1]
    assert np.isfinite(r["T_kf_ba"]).all()
    assert r["ate_ba"] < 0.03, r["ate_ba"]
    if key == "strict":
        assert r["mean_pix_err"] < 1.0
        assert r["ate_ba"] <= r["ate_track"] * 1.05
    if key == "fast":
        s = runs["strict"][1]
        assert r["ate_ba"] < s["ate_ba"] * 2.0 + 1e-3
        assert r["mean_pix_err"] < s["mean_pix_err"] + 0.5


def test_oracle_ba_problem_rebuilds_its_system(runs):
    """The returned BA inputs rebuild a finite system whose first solve
    iterate count the run reports."""
    import torch

    from mast3r_slam_tpu_torch.slam import factor_graph as TFG

    p = runs["strict"][1]["ba_problem"]
    assert p["kind"] == "rays" and p["iters"] >= 1
    H, g, cost = TFG._accumulate_rays(
        p["T"], p["meas"], p["ii"], p["jj"], p["mask"], p["free"],
        p["T"].shape[0], *p["sigmas"], compute_dtype=torch.float32)
    assert torch.isfinite(H).all() and torch.isfinite(g).all()
    assert float(cost) > 0
    T, iters = TFG.gauss_newton_rays(
        p["T"], p["meas"], p["ii"], p["jj"], p["mask"], p["free"],
        *p["sigmas"], p["max_iter"], p["delta"],
        compute_dtype=p["compute_dtype"])
    assert iters == p["iters"]
    np.testing.assert_array_equal(T.numpy(), runs["strict"][1]["T_kf_ba"])
