"""Trajectory accuracy of the port's CLI on the evaluation datasets.

    python -m mast3r_slam_tpu_torch.bench.eval_datasets \\
        {tum,euroc,7-scenes,eth3d,replica} <root> [--no-calib] [--weights W] \\
        [--workdir DIR] [--device cuda] [extra CLI args]

One harness for the JAX repo's ``scripts/eval_tum.sh``, ``eval_euroc.sh``,
``eval_7_scenes.sh``, ``eval_eth3d.sh`` and ``eval_replica.sh``, with each
script's sequences, config, ``--save-as`` name and ground truth:

- TUM RGB-D: the nine freiburg1 sequences, ``config/eval_calib.yaml``
  (``eval_no_calib.yaml`` under ``--no-calib``), ``<seq>/groundtruth.txt``;
- EuRoC: the ten MH / V sequences, ``eval_no_calib.yaml``,
  ``groundtruths/euroc/<seq>.txt`` or else the sequence's
  ``mav0/state_groundtruth_estimate0/data.csv``;
- 7-Scenes: the seven scenes, ``eval_calib.yaml``,
  ``groundtruths/7-scenes/<seq>.txt``, derived from the scene's pose files
  (``data/seven_scenes_gt.py``) when absent;
- ETH3D: every subdirectory of ``<root>`` that has an ``rgb.txt``,
  ``eth3d.yaml``, ``<seq>/groundtruth.txt``;
- Replica: the eight office / room scenes, ``eval_replica.yaml``,
  ``<seq>/traj_tum.txt``.

A missing sequence is skipped with a line that names it. Each sequence runs
through ``mast3r_slam_tpu_torch.main.main`` in this process (``--weights``
and then the extra arguments appended after the script's own, so that a
later ``--config`` overrides the dataset's), and its keyframe trajectory
is scored as ``evo_ape tum <gt> <est> -as`` scores it
(``evaluation.main_ape``, which prints the APE block). ``logs/`` and
``groundtruths/`` are read and written under ``--workdir`` (default the
current directory), where relative paths among the extra arguments are
read too. The last line is a JSON summary: per sequence the ATE RMSE, the
frames, the keyframes and the medians of the tracked frame and the backend
step (host clock, synced), and the device (on the card, ``nvidia-smi``'s
name and power limit).

It runs on the CUDA card; ``--device cpu`` (or ``main(argv,
device="cpu")``) runs the plain versions. There is no fallback from the
card to the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import time
from pathlib import Path
from typing import Callable

from mast3r_slam_tpu_torch.data import seven_scenes_gt

CONFIG = Path(__file__).resolve().parents[2] / "config"


def _own_gt(name):
    return lambda root, seq, workdir: root / seq / name


def _euroc_gt(root, seq, workdir):
    gt = workdir / "groundtruths" / "euroc" / f"{seq}.txt"
    return gt if gt.is_file() else (
        root / seq / "mav0" / "state_groundtruth_estimate0" / "data.csv")


def _seven_scenes_gt(root, seq, workdir):
    gt = workdir / "groundtruths" / "7-scenes" / f"{seq}.txt"
    if not gt.is_file():
        n = seven_scenes_gt.convert(root / seq, gt)
        print(f"{n} poses → {gt}")
    return gt


@dataclasses.dataclass(frozen=True)
class Dataset:
    seqs: tuple | None          # None: every subdirectory with an rgb.txt
    config: str
    save_as: str
    gt: Callable[[Path, str, Path], Path]


DATASETS = {
    "tum": Dataset(
        ("rgbd_dataset_freiburg1_360", "rgbd_dataset_freiburg1_desk",
         "rgbd_dataset_freiburg1_desk2", "rgbd_dataset_freiburg1_floor",
         "rgbd_dataset_freiburg1_plant", "rgbd_dataset_freiburg1_room",
         "rgbd_dataset_freiburg1_rpy", "rgbd_dataset_freiburg1_teddy",
         "rgbd_dataset_freiburg1_xyz"),
        "eval_calib.yaml", "eval_tum", _own_gt("groundtruth.txt")),
    "euroc": Dataset(
        ("MH_01_easy", "MH_02_easy", "MH_03_medium", "MH_04_difficult",
         "MH_05_difficult", "V1_01_easy", "V1_02_medium", "V1_03_difficult",
         "V2_01_easy", "V2_02_medium"),
        "eval_no_calib.yaml", "eval_euroc", _euroc_gt),
    "7-scenes": Dataset(
        ("chess", "fire", "heads", "office", "pumpkin", "redkitchen",
         "stairs"),
        "eval_calib.yaml", "eval_7scenes", _seven_scenes_gt),
    "eth3d": Dataset(None, "eth3d.yaml", "eval_eth3d",
                     _own_gt("groundtruth.txt")),
    "replica": Dataset(
        ("office0", "office1", "office2", "office3", "office4", "room0",
         "room1", "room2"),
        "eval_replica.yaml", "eval_replica", _own_gt("traj_tum.txt")),
}


def sequences(dataset, root):
    """The dataset's sequence names (ETH3D: the subdirectories of ``root``
    that have an ``rgb.txt``, sorted)."""
    seqs = DATASETS[dataset].seqs
    if seqs is None:
        return sorted(p.name for p in Path(root).iterdir()
                      if (p / "rgb.txt").is_file())
    return list(seqs)


@contextlib.contextmanager
def timed_calls():
    """Within the block, the host ms of each ``FrameTracker.track`` and
    ``Backend.step`` call, with the device synced before and after it
    (``utils/tictoc.py::sync``), appended to ``ms["track"]`` /
    ``ms["step"]``."""
    from mast3r_slam_tpu_torch.slam.pipeline import Backend
    from mast3r_slam_tpu_torch.slam.tracker import FrameTracker
    from mast3r_slam_tpu_torch.utils.tictoc import sync

    ms = {"track": [], "step": []}
    saved = [(FrameTracker, "track"), (Backend, "step")]
    originals = [getattr(owner, name) for owner, name in saved]

    def timed(key, fn):
        def inner(*a, **kw):
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                sync()
                ms[key].append((time.perf_counter() - t0) * 1e3)
        return inner

    for (owner, name), fn in zip(saved, originals):
        setattr(owner, name, timed(name, fn))
    try:
        yield ms
    finally:
        for (owner, name), fn in zip(saved, originals):
            setattr(owner, name, fn)


@contextlib.contextmanager
def in_dir(path):
    """Run the block with ``path`` as the current directory."""
    before = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(before)


def _median(v):
    return statistics.median(v) if v else None


def main(argv=None, device="cuda"):
    """Run the harness; returns the summary (also printed as the last
    line)."""
    from mast3r_slam_tpu_torch import evaluation
    from mast3r_slam_tpu_torch import main as cli
    from mast3r_slam_tpu_torch.bench.frame_profile import device_label

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0], allow_abbrev=False,
        epilog="further arguments go to the CLI, after the harness's own")
    ap.add_argument("dataset", choices=sorted(DATASETS))
    ap.add_argument("root")
    ap.add_argument("--no-calib", action="store_true",
                    help="TUM: config/eval_no_calib.yaml")
    ap.add_argument("--weights", default="",
                    help="model weights (.npz), passed to the CLI")
    ap.add_argument("--workdir", default=".",
                    help="where logs/ and groundtruths/ are")
    ap.add_argument("--device", default=device)
    args, extra = ap.parse_known_args(argv)
    if args.no_calib and args.dataset != "tum":
        ap.error("--no-calib applies to tum only")
    dev = cli._check_device(args.device)
    spec = DATASETS[args.dataset]
    config = "eval_no_calib.yaml" if args.no_calib else spec.config
    root = Path(args.root).absolute()
    workdir = Path(args.workdir).absolute()
    weights = (["--weights", str(Path(args.weights).absolute())]
               if args.weights else [])
    label = device_label(dev)
    summary = {"dataset": args.dataset, "root": str(root),
               "config": config, "save_as": spec.save_as, "device": label,
               "sequences": {}, "skipped": []}
    for seq in sequences(args.dataset, root):
        if not (root / seq).is_dir():
            print(f"skip {seq} (not found)", flush=True)
            summary["skipped"].append(seq)
            continue
        print(f"=== {seq} ===", flush=True)
        argv_seq = ["--dataset", str(root / seq), "--config",
                    str(CONFIG / config), "--no-viz", "--save-as",
                    spec.save_as, *weights, *extra]
        with in_dir(workdir), timed_calls() as ms:
            out = cli.main(argv_seq, device=dev)
        est = workdir / "logs" / spec.save_as / seq / f"{seq}.txt"
        gt = spec.gt(root, seq, workdir)
        res = evaluation.main_ape([str(gt), str(est), "-as"])
        summary["sequences"][seq] = dict(
            ate_rmse=res["rmse"], pairs=res["n_pairs"],
            frames=out["frames_processed"], keyframes=len(out["keyframes"]),
            tracked_ms_median=_median(ms["track"]),
            step_ms_median=_median(ms["step"]), gt=str(gt), traj=str(est))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
