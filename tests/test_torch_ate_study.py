"""The port's oracle ATE studies (``bench/ate_study.py``) against the JAX
repo's ``scripts/mode_ate_study.py``, ``scripts/ba_delta_study.py`` and
``scripts/matcher_cut_sweep.py``: the same tables, the same printed
arithmetic, and the driver's rows at 32x48, 16 frames, noise seed 0 against
the JAX package's ``run_oracle_slam`` for each knob set that
``tests/test_torch_oracle.py`` does not hold (the JAX BA's Pallas Gram in
interpret mode, as there). Keyframes and skips equal; the ATE before and
after BA within 1e-4 m under float32 BA rows, 1e-3 m under bf16 rows; the
matched-pixel error within 1e-6. Then the port's counterparts of
``tests/test_oracle_modes.py``'s chain and cost pins."""

import contextlib
import functools
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

from mast3r_slam_tpu.slam import factor_graph as JFG
from mast3r_slam_tpu.utils import oracle_scene as JO
from mast3r_slam_tpu_torch.bench import ate_study as AS
from mast3r_slam_tpu_torch.utils import oracle_scene as TO
from torch_parity import torch_one_thread  # noqa: F401

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
HW = (32, 48)
N_FRAMES = 16

# the knob sets of the three tables beyond test_torch_oracle.py's strict,
# base.yaml and calibrated runs
KNOBS = {
    "production matcher cuts only":
        AS.DELTA_MODES["production matcher cuts only (r4 baseline)"],
    "separable": AS.MODES["separable (ablation)"],
    "ba_delta 1e-4": AS.DELTA_MODES["prod-joint + ba_delta 1e-4"],
    "ba_delta 3e-2": AS.DELTA_MODES["prod-joint + ba_delta 3e-2"],
    "max_iter 6": AS.SWEEP["LM 6 iters (fewer iter_proj passes)"],
    "track_max_iter 6": AS.SWEEP["TRACK d_max 1 + LM 6 (max tracker cut)"],
    "track_proj_step 2": AS.SWEEP["TRACK proj_step 2 (backend full-res)"],
    "level_step 4": AS.SWEEP["step 4 -> levels d=5,1 (26 rows/px, -33%)"],
    "track_dilation_max 3":
        AS.SWEEP["TRACK d_max 3 (r2; 2 lvls, 18 rows/px -54%)"],
}


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script,attr,table", [
    ("mode_ate_study", "MODES", "modes"),
    ("ba_delta_study", "MODES", "delta"),
    ("matcher_cut_sweep", "SWEEP", "cuts")])
def test_tables_equal_the_jax_scripts(script, attr, table):
    want = getattr(_script(script), attr)
    got = AS.STUDIES[table]
    assert list(got) == list(want)
    for name in want:
        assert got[name] == want[name], name


def test_protocol_is_the_jax_scripts():
    assert (AS.HW, AS.FRAMES, AS.SEEDS, AS.KF_EVERY) == ((64, 96), 96,
                                                         (0, 1, 2), 4)
    assert AS.PROD_MATCH == _script("ba_delta_study").PROD_MATCH
    assert AS.PROD_BA == _script("ba_delta_study").PROD_BA


class _Runs:
    """Each knob set's row through the port's driver and through the JAX
    package's ``run_oracle_slam``, computed once."""

    def __init__(self):
        self.scene_t, self.scene_j = TO.OracleScene(seed=0), JO.OracleScene(
            seed=0)
        self.poses = TO.make_trajectory(N_FRAMES)
        self.rows = {}

    def __call__(self, key):
        if key not in self.rows:
            mode = KNOBS[key]
            port = functools.partial(TO.run_oracle_slam, device="cpu")
            mp = pytest.MonkeyPatch()
            for name in ("gauss_newton_rays", "gauss_newton_calib"):
                mp.setattr(JFG, name, functools.partial(
                    getattr(JFG, name), pallas_interpret=True))
            try:
                self.rows[key] = tuple(
                    AS.run_row("parity", key, mode, run, scene, self.poses,
                               HW, (0,), False, "cpu")
                    for run, scene in ((JO.run_oracle_slam, self.scene_j),
                                       (port, self.scene_t)))
            finally:
                mp.undo()
        return self.rows[key]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


@pytest.mark.parametrize("key", list(KNOBS))
def test_driver_row_matches_jax(runs, key):
    rj, rt = runs(key)
    tol = 1e-4 if KNOBS[key].get("ba_compute_dtype") == "float32" else 1e-3
    assert rt["keyframes"] == rj["keyframes"] == [4]
    assert rt["skips"] == rj["skips"] == [0]
    for k in ("ate_track", "ate_ba"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=0, atol=tol, err_msg=k)
    np.testing.assert_allclose(rt["pix_err"], rj["pix_err"], rtol=0,
                               atol=1e-6)
    # the CPU runs the plain versions: no kernel launched
    assert rt["lm_iters"][0] >= 1
    assert all(v == 0 for v in rt["launches"][0].values())


def _rows(ate_ba, pix, names=("strict", "b", "c")):
    return [dict(row=n, ate_ba_mean=a, ate_track_mean=2 * a, pix_err_mean=p,
                 skips=[0, 1])
            for n, a, p in zip(names, ate_ba, pix)]


def test_relative_to_strict_arithmetic():
    """The scripts' block: ``ab / strict_ab`` and ``pe - strict_pe`` after
    the first (strict) row, in their format."""
    rows = _rows((0.01779, 0.01521, 0.02), (0.397, 0.618, 0.3))
    rel = AS.relative_to_first(rows)
    assert [r[0] for r in rel] == ["b", "c"]
    np.testing.assert_allclose([r[1] for r in rel],
                               [0.01521 / 0.01779, 0.02 / 0.01779])
    np.testing.assert_allclose([r[2] for r in rel],
                               [0.618 - 0.397, 0.3 - 0.397])
    strict = ("strict", 0.0, 0.01779, 0.397)
    want = ["", "relative to strict:"] + [
        f"{name:48s} ate_ba {ab / strict[2]:5.2f}x  "
        f"pix_err {pe - strict[3]:+6.3f} px"
        for name, ab, pe in (("b", 0.01521, 0.618), ("c", 0.02, 0.3))]
    assert AS.relative_lines(rows) == want
    assert AS.row_line("modes", rows[1]) == (
        f"{'b':48s} ate_track {2 * 0.01521 * 1e3:7.2f} mm  "
        f"ate_ba {0.01521 * 1e3:7.2f} mm  pix_err {0.618:6.3f} px")
    # matcher_cut_sweep.py's line: the ratio to the first row, all skips
    assert AS.row_line("cuts", rows[1], rows[0]) == (
        f"{'b':46s} ate_ba {0.01521 * 1e3:6.2f} mm "
        f"({0.01521 / 0.01779:4.2f}x)  pix {0.618:5.3f}  skips 1")


@pytest.fixture(scope="module")
def modes_table():
    """The driver's ``modes`` table at 32x48, 16 frames, seed 0 on the CPU,
    and what it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rows = AS.main(["--study", "modes", "--hw", "32,48", "--frames",
                        str(N_FRAMES), "--seeds", "0"], device="cpu")
    lines = out.getvalue().splitlines()
    return rows, lines


def test_driver_prints_rows_json_and_relative_block(modes_table):
    rows, lines = modes_table
    assert [r["row"] for r in rows] == list(AS.MODES)
    records = [json.loads(l) for l in lines if l.startswith("{")]
    assert [r["row"] for r in records] == list(AS.MODES)
    for rec in records:
        assert rec["hw"] == [32, 48] and rec["frames"] == N_FRAMES
        assert rec["seeds"] == [0] and rec["calib"] is False
        assert len(rec["ate_ba"]) == len(rec["launches"]) == 1
        assert rec["ate_ba_mean"] == rec["ate_ba"][0]
        assert rec["device"].startswith("cpu") and rec["wall_s"] > 0
    i = lines.index("relative to strict:")
    assert lines[i + 1:] == AS.relative_lines(rows)[2:]


def test_fast_mode_ate_cost_is_bounded(modes_table):
    """``tests/test_oracle_modes.py``: base.yaml's cuts within 2x strict +
    1 mm ATE after BA, and +0.5 px matched-pixel error."""
    rows = {r["row"]: r for r in modes_table[0]}
    s = rows["strict (joint, ladder 5..1, no plateau exit)"]
    f = rows["production-defaults (all cuts, base.yaml)"]
    assert s["skips"] == f["skips"] == [0]
    assert f["ate_ba_mean"] < s["ate_ba_mean"] * 2.0 + 1e-3
    assert f["pix_err_mean"] < s["pix_err_mean"] + 0.5


def test_long_chain_stays_stable():
    """``tests/test_oracle_modes.py``'s 48-frame chain at 24x32 on the
    port: every keyframe promoted, quaternions unit, scale sane."""
    r = TO.run_oracle_slam(TO.OracleScene(seed=0), TO.make_trajectory(48),
                           (24, 32), AS.MODES[
                               "production-defaults (all cuts, base.yaml)"],
                           noise_seed=0, device="cpu")
    assert r["n_skipped"] == 0, r["n_skipped"]
    assert len(r["kf_ids"]) == 12
    T = r["T_kf_track"]
    assert np.isfinite(T).all()
    np.testing.assert_allclose(np.linalg.norm(T[:, 3:7], axis=-1), 1.0,
                               atol=1e-4)
    assert np.abs(T[:, 7] - 1.0).max() < 0.2
    assert r["ate_ba"] < 0.15, r["ate_ba"]
