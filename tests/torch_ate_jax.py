"""The JAX package's rows of the port's oracle ATE studies, on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_ate_jax.py [--study modes,delta,cuts]
        [--calib]

Runs the tables of ``mast3r_slam_tpu_torch/bench/ate_study.py`` (the JAX
scripts' ``MODES`` / ``SWEEP`` dicts, held equal by
``tests/test_torch_ate_study.py``) through the JAX package's
``run_oracle_slam`` at the scripts' protocol, as ``scripts/mode_ate_study.py``,
``scripts/ba_delta_study.py`` and ``scripts/matcher_cut_sweep.py`` run it,
and prints the port driver's lines for them: the JAX rows beside which
PERF.md sets the port's. ``--calib`` covers the calibrated tables that only
``ba_delta_study.py`` has. These are trajectory errors, not times.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from mast3r_slam_tpu.utils import oracle_scene as JO  # noqa: E402
from mast3r_slam_tpu_torch.bench import ate_study  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--study", default="modes,delta,cuts")
    ap.add_argument("--calib", action="store_true")
    args = ap.parse_args(argv)
    label = f"JAX {jax.__version__} on the CPU ({jax.devices()[0]})"
    scene, poses = JO.OracleScene(seed=0), JO.make_trajectory(ate_study.FRAMES)
    for study in args.study.split(","):
        ate_study.run_study(study, JO.run_oracle_slam, scene, poses,
                            calib=args.calib, label=label,
                            emit=functools.partial(print, flush=True))


if __name__ == "__main__":
    main()
