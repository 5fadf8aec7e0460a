"""Oracle ATE studies of the matcher and BA settings, on the port.

    python -m mast3r_slam_tpu_torch.bench.ate_study [--study modes,delta,cuts]
        [--calib] [--device cuda]

The port's counterpart of the JAX repo's three oracle studies:
``scripts/mode_ate_study.py`` (``--study modes``: strict reference matcher
semantics against the production cuts), ``scripts/ba_delta_study.py``
(``--study delta``: the BA's early-exit threshold and the full production
stack) and ``scripts/matcher_cut_sweep.py`` (``--study cuts``: deeper
matcher cuts). Their protocol: the analytic oracle scene
(``utils/oracle_scene.py``, seed 0), a 96-frame loop trajectory, 64x96
pointmaps, a keyframe every 4 frames, a 30-iteration BA, noise seeds 0, 1
and 2; ``--calib`` runs the calibrated pose solve and BA (as
``ba_delta_study.py --calib``). Each row prints the JAX scripts' columns
(the mean over the seeds), then the "relative to strict" block (``modes``,
``delta``) or the ratio to the first row (``cuts``), and one JSON line: each
seed's and the mean ATE before and after BA and matched-pixel error, the
keyframes and skips per seed, the BA's LM iterations and K4 / K5 launches
by path per seed, the row's wall time and the device (on the card,
``nvidia-smi``'s name and power limit).

It runs on the CUDA card; ``--device cpu`` (or ``main(argv,
device="cpu")``) runs the plain versions, where no kernel launches. There
is no fallback from the card to the CPU. ``--hw``, ``--frames`` and
``--seeds`` only shrink the protocol for the tests.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

# scripts/mode_ate_study.py's MODES
MODES = {
    "strict (joint, ladder 5..1, no plateau exit)": dict(
        refine_mode="joint", level_step=1, plateau_frac=0.0,
        ba_pixel_step=1, ba_compute_dtype="float32", ba_delta_norm=1e-8),
    "production (plus, ladder 5,3,1, plateau 1e-3)": dict(
        refine_mode="plus", level_step=2, plateau_frac=0.001),
    # EXACTLY what config/base.yaml ships — matcher cuts AND BA cuts jointly
    # (pixel_step 2, bf16 meas storage, bf16 Gram, delta_norm 1e-2 exit)
    "production-defaults (all cuts, base.yaml)": dict(
        refine_mode="plus", level_step=2, plateau_frac=0.001,
        radius=2, proj_step=2, track_dilation_max=1,
        ba_pixel_step=2, ba_meas_dtype="bfloat16",
        ba_compute_dtype="bfloat16", ba_delta_norm=1e-2),
    "separable (ablation)": dict(
        refine_mode="separable", level_step=2, plateau_frac=0.001),
}

# scripts/ba_delta_study.py's PROD_MATCH, PROD_BA and MODES
PROD_MATCH = dict(refine_mode="plus", level_step=2, plateau_frac=0.001,
                  radius=2, proj_step=2, track_dilation_max=1)
PROD_BA = dict(ba_pixel_step=2, ba_meas_dtype="bfloat16",
               ba_compute_dtype="bfloat16")
DELTA_MODES = {
    "strict reference (all pins)": dict(
        refine_mode="joint", level_step=1, plateau_frac=0.0,
        ba_pixel_step=1, ba_compute_dtype="float32", ba_delta_norm=1e-8),
    "production matcher cuts only (r4 baseline)": dict(PROD_MATCH),
    "production-defaults JOINT (ships in base.yaml)": dict(
        **PROD_MATCH, **PROD_BA),
    "prod-joint + ba_delta 1e-4": dict(
        **PROD_MATCH, **PROD_BA, ba_delta_norm=1e-4),
    "prod-joint + ba_delta 1e-3": dict(
        **PROD_MATCH, **PROD_BA, ba_delta_norm=1e-3),
    "prod-joint + ba_delta 1e-2": dict(
        **PROD_MATCH, **PROD_BA, ba_delta_norm=1e-2),
    "prod-joint + ba_delta 3e-2": dict(
        **PROD_MATCH, **PROD_BA, ba_delta_norm=3e-2),
}

# scripts/matcher_cut_sweep.py's SWEEP
SWEEP = {
    "production (r3 d5 step2 plus, 10 LM iters)": dict(),
    "radius 2 (27 rows/px, -31% refine gather)": dict(radius=2),
    "step 4 -> levels d=5,1 (26 rows/px, -33%)": dict(level_step=4),
    "radius 2 + step 4 (18 rows/px, -54%)": dict(radius=2, level_step=4),
    "LM 6 iters (fewer iter_proj passes)": dict(max_iter=6),
    "radius 2 + step 4 + LM 6 (max cut)": dict(radius=2, level_step=4,
                                               max_iter=6),
    "TRACK d_max 3 (r2; 2 lvls, 18 rows/px -54%)": dict(
        radius=2, track_dilation_max=3),
    "TRACK d_max 1 (r2; 1 lvl, 9 rows/px -77%)": dict(
        radius=2, track_dilation_max=1),
    "TRACK d_max 1 + LM 6 (max tracker cut)": dict(
        radius=2, track_dilation_max=1, track_max_iter=6),
    "proj_step 2 (LM on 1/4 queries)": dict(radius=2, proj_step=2),
    "TRACK proj_step 2 (backend full-res)": dict(
        radius=2, track_proj_step=2),
    "TRACK proj_step 2 + d_max 3": dict(
        radius=2, track_proj_step=2, track_dilation_max=3),
}

STUDIES = {"modes": MODES, "delta": DELTA_MODES, "cuts": SWEEP}

# the JAX scripts' protocol
HW = (64, 96)
FRAMES = 96
SEEDS = (0, 1, 2)
KF_EVERY = 4


def _ba_counts():
    from mast3r_slam_tpu_torch.ops import ba_kernels as BA

    out = {"K4": BA.rays_counter.launches, "K5": BA.calib_counter.launches}
    out.update({p: c.launches for p, c in BA.path_counters.items()})
    return out


def _reset_ba_counts():
    from mast3r_slam_tpu_torch.ops import ba_kernels as BA

    for c in (BA.rays_counter, BA.calib_counter,
              *BA.path_counters.values()):
        c.launches = 0


def run_row(study, name, mode, run, scene, poses, hw, seeds, calib, label):
    """One table row: ``run(scene, poses, hw, mode, noise_seed=s,
    use_calib=calib)`` (the port's ``run_oracle_slam`` on a device, or the
    JAX package's in the tests) for each seed, with K4 / K5's launches by
    path counted per seed. Returns the row's JSON record."""
    rec = dict(study=study, row=name, mode=mode, calib=bool(calib),
               hw=list(hw), frames=len(poses), kf_every=KF_EVERY,
               seeds=list(seeds), ate_track=[], ate_ba=[], pix_err=[],
               keyframes=[], skips=[], lm_iters=[], launches=[])
    t0 = time.perf_counter()
    for s in seeds:
        _reset_ba_counts()
        r = run(scene, poses, hw, mode, noise_seed=s, use_calib=calib)
        p = r.get("ba_problem")
        rec["ate_track"].append(float(r["ate_track"]))
        rec["ate_ba"].append(float(r["ate_ba"]))
        rec["pix_err"].append(float(r["mean_pix_err"]))
        rec["keyframes"].append(len(r["kf_ids"]))
        rec["skips"].append(int(r["n_skipped"]))
        rec["lm_iters"].append(None if p is None else int(p["iters"]))
        rec["launches"].append(_ba_counts())
    rec["wall_s"] = time.perf_counter() - t0
    for k in ("ate_track", "ate_ba", "pix_err"):
        rec[f"{k}_mean"] = float(np.mean(rec[k]))
    rec["device"] = label
    return rec


def relative_to_first(rows):
    """``(row, ate_ba / first row's ate_ba, pix_err - first row's pix_err)``
    for each row after the first (the scripts' "relative to strict" block:
    the first row of ``modes`` and ``delta`` is strict)."""
    first = rows[0]
    return [(r["row"], r["ate_ba_mean"] / first["ate_ba_mean"],
             r["pix_err_mean"] - first["pix_err_mean"]) for r in rows[1:]]


def row_line(study, rec, first=None):
    """The JAX script's printed line for a row (``first``: the cuts
    table's first row, which its ratio is taken to)."""
    name = rec["row"]
    ab, pe = rec["ate_ba_mean"], rec["pix_err_mean"]
    if study == "cuts":
        base = (first or rec)["ate_ba_mean"]
        return (f"{name:46s} ate_ba {ab * 1e3:6.2f} mm ({ab / base:4.2f}x)  "
                f"pix {pe:5.3f}  skips {sum(rec['skips'])}")
    return (f"{name:48s} ate_track {rec['ate_track_mean'] * 1e3:7.2f} mm  "
            f"ate_ba {ab * 1e3:7.2f} mm  pix_err {pe:6.3f} px")


def relative_lines(rows):
    return ["", "relative to strict:"] + [
        f"{name:48s} ate_ba {ratio:5.2f}x  pix_err {dpe:+6.3f} px"
        for name, ratio, dpe in relative_to_first(rows)]


def run_study(study, run, scene, poses, hw=HW, seeds=SEEDS, calib=False,
              label="", modes=None, emit=print):
    """Every row of ``STUDIES[study]`` (or of ``modes``), printed as the
    JAX script prints it, each followed by its JSON line; then the
    relative block. Returns the rows' records."""
    table = STUDIES[study] if modes is None else modes
    emit(f"[{study}] oracle scene {tuple(hw)}, {len(poses)} frames, "
         f"kf_every={KF_EVERY}, calib={bool(calib)}, seeds {tuple(seeds)}; "
         f"on {label}")
    rows = []
    for name, mode in table.items():
        rec = run_row(study, name, mode, run, scene, poses, hw, seeds, calib,
                      label)
        rows.append(rec)
        emit(row_line(study, rec, rows[0]))
        emit(json.dumps(rec))
    if study != "cuts" and len(rows) > 1:
        for line in relative_lines(rows):
            emit(line)
    return rows


def _ints(text):
    return tuple(int(v) for v in text.split(","))


def main(argv=None, device="cuda"):
    """Run the studies; returns every row's record."""
    import functools

    from mast3r_slam_tpu_torch.bench.frame_profile import device_label
    from mast3r_slam_tpu_torch.main import _check_device
    from mast3r_slam_tpu_torch.utils.oracle_scene import (
        OracleScene, make_trajectory, run_oracle_slam)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--study", default="modes,delta,cuts",
                    help="comma-separated tables of " + ",".join(STUDIES))
    ap.add_argument("--calib", action="store_true",
                    help="the calibrated pose solve and BA")
    ap.add_argument("--device", default=device)
    ap.add_argument("--hw", type=_ints, default=HW)
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--seeds", type=_ints, default=SEEDS)
    args = ap.parse_args(argv)
    studies = args.study.split(",")
    unknown = set(studies) - set(STUDIES)
    if unknown:
        ap.error(f"unknown studies {sorted(unknown)}")
    dev = _check_device(args.device)
    run = functools.partial(run_oracle_slam, kf_every=KF_EVERY, device=dev)
    scene, poses = OracleScene(seed=0), make_trajectory(args.frames)
    label = device_label(dev)
    rows = []
    for study in studies:
        rows += run_study(study, run, scene, poses, args.hw, args.seeds,
                          args.calib, label,
                          emit=functools.partial(print, flush=True))
    return rows


if __name__ == "__main__":
    main()
