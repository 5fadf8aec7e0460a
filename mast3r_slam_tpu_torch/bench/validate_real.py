"""From a released MASt3R checkpoint to an ATE number, on the port.

    python -m mast3r_slam_tpu_torch.bench.validate_real <ckpt.pth> \\
        <tum_seq_dir> [--gt gt.txt] [--npz PATH] [--workdir DIR] \\
        [--device cuda] [extra CLI args]

The port's counterpart of the JAX repo's ``scripts/validate_real.sh``:

1. the ``.pth`` through ``models/convert.py::load_checkpoint`` (the depths
   are the checkpoint's own) to the parameter tree, saved as the ``.npz``
   that ``load_npz`` reads (``--npz``, default
   ``logs/real/<checkpoint name>.npz``);
3. the CLI on the TUM sequence with ``config/eval_calib.yaml`` and those
   weights (``--save-as validate_real``; the extra arguments appended last,
   so that a later ``--config`` overrides it);
4. the ATE RMSE of its keyframe trajectory against ``--gt`` (default
   ``<tum_seq_dir>/groundtruth.txt``; the shell script's third argument),
   as ``evo_ape tum <gt> <est> -as`` scores it (``evaluation.main_ape``).

Step 2 of the JAX script, the forward parity of the converted weights
against the reference PyTorch model at 384x512, is left out: it needs the
reference implementation and JAX, which the port's machine does not have.
The converter itself is held against the JAX package's by
``tests/test_torch_convert.py``.

``logs/`` is written under ``--workdir`` (default the current directory),
where relative paths among the extra arguments are read too. It runs on the
CUDA card; ``--device cpu`` (or ``main(argv, device="cpu")``) runs the plain
versions. There is no fallback from the card to the CPU.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from mast3r_slam_tpu_torch.bench.eval_datasets import CONFIG, in_dir

SAVE_AS = "validate_real"


def main(argv=None, device="cuda"):
    """Convert, run and score; returns the ATE record (also printed as the
    last line)."""
    from mast3r_slam_tpu_torch import evaluation
    from mast3r_slam_tpu_torch import main as cli
    from mast3r_slam_tpu_torch.bench.frame_profile import device_label
    from mast3r_slam_tpu_torch.models import convert

    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0], allow_abbrev=False,
        epilog="further arguments go to the CLI, after the script's own")
    ap.add_argument("ckpt")
    ap.add_argument("seq")
    ap.add_argument("--gt", default="",
                    help="ground truth (default <seq>/groundtruth.txt)")
    ap.add_argument("--npz", default="",
                    help="the converted weights (default "
                    "logs/real/<checkpoint name>.npz)")
    ap.add_argument("--workdir", default=".")
    ap.add_argument("--device", default=device)
    args, extra = ap.parse_known_args(argv)
    dev = cli._check_device(args.device)
    workdir = Path(args.workdir).absolute()
    ckpt, seq = Path(args.ckpt).absolute(), Path(args.seq).absolute()
    gt = Path(args.gt).absolute() if args.gt else seq / "groundtruth.txt"
    npz = (Path(args.npz).absolute() if args.npz else
           workdir / "logs" / "real" / f"{ckpt.stem}.npz")

    print(f"=== 1. convert ({ckpt}) ===", flush=True)
    npz.parent.mkdir(parents=True, exist_ok=True)
    convert.save_npz(convert.load_checkpoint(ckpt), npz)
    print(f"weights → {npz}", flush=True)

    print(f"=== 3. SLAM run on {seq} ===", flush=True)
    with in_dir(workdir):
        out = cli.main(["--dataset", str(seq), "--config",
                        str(CONFIG / "eval_calib.yaml"), "--no-viz",
                        "--save-as", SAVE_AS, "--weights", str(npz), *extra],
                       device=dev)
    est = workdir / "logs" / SAVE_AS / seq.name / f"{seq.name}.txt"

    print("=== 4. ATE ===", flush=True)
    res = evaluation.main_ape([str(gt), str(est), "-as"])
    rec = dict(ckpt=str(ckpt), npz=str(npz), seq=str(seq), gt=str(gt),
               traj=str(est), ate_rmse=res["rmse"], pairs=res["n_pairs"],
               frames=out["frames_processed"],
               keyframes=len(out["keyframes"]), device=device_label(dev))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
