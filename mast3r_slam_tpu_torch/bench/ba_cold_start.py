"""First-call cost of the BA Gram kernels (K4, K5) in a fresh process.

    python -m mast3r_slam_tpu_torch.bench.ba_cold_start --roots A B B A

Each root is a checkout of the repo (a directory holding
``mast3r_slam_tpu_torch``); the default is this one. The kernels of each
root are built first, then the roots are taken in the order given, each
``--runs`` times, every run in a new Python process that imports the port
from its root and times, with the card synchronized around each step:

  ctx       the CUDA context (a one-element tensor on the card),
  lib       loading ``ba_gram``'s library (``ba_kernels._lib``),
  occ       the occupancy query of the "mma" path's grid planner (roots
            whose wrapper has none: not timed),
  k4_first  the first ``gram_rays`` launch, bf16 channels and rows,
  k4_next   the second, same inputs,
  k5_first  the first ``gram_calib`` launch,
  k5_next   the second,

at the backend event's shape (E = 4 two-way edges, N = 384 x 512 pixels)
with inputs made on the card from a seed. It prints one JSON line per run,
then the median of each step per root (ms) and the library's size.
Giving the roots in turns (A B B A) spreads the host's drift over both.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

EDGES, PIXELS = 4, 384 * 512
STEPS = ("ctx", "lib", "occ", "k4_first", "k4_next", "k5_first", "k5_next")
HERE = Path(__file__).resolve()


def _child(root: str) -> dict:
    """One cold start of ``root``'s port: the steps' ms."""
    sys.path.insert(0, root)
    import torch

    from mast3r_slam_tpu_torch import _build
    from mast3r_slam_tpu_torch.ops import ba_kernels as BA

    dev = torch.device("cuda")
    ms = {}
    clock = [time.perf_counter()]

    def mark(step):
        torch.cuda.synchronize(dev)
        now = time.perf_counter()
        ms[step] = (now - clock[0]) * 1e3
        clock[0] = now

    torch.zeros(1, device=dev)
    mark("ctx")
    g = torch.Generator(device=dev).manual_seed(0)
    ray = [torch.rand(EDGES, PIXELS, device=dev, generator=g).add_(0.5).to(
        torch.bfloat16) for _ in range(8)]
    cal = [torch.rand(EDGES, PIXELS, device=dev, generator=g).add_(0.5).to(
        torch.bfloat16) for _ in range(7)]
    eye = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0.01, 0, 0, 1],
                       device=dev)
    rts = eye.repeat(EDGES, 1)
    rts_c = torch.cat([rts, torch.tensor([300.0, 300, 256, 192],
                                         device=dev).repeat(EDGES, 1)], 1)
    mark("data")
    BA._lib()
    mark("lib")
    if hasattr(BA, "mma_blocks_per_sm"):
        BA.mma_blocks_per_sm(dev, 0, True)
        BA.mma_blocks_per_sm(dev, 1, True)
        mark("occ")
    for step in ("k4_first", "k4_next"):
        BA.gram_rays(rts, ray, 0.003, 10.0)
        mark(step)
    for step in ("k5_first", "k5_next"):
        BA.gram_calib(rts_c, cal, (384, 512), 10, 0.1, 1.0, 0.1)
        mark(step)
    ms.pop("data")
    ms["lib_bytes"] = _build.library_path("ba_gram").stat().st_size
    ms["root"] = root
    return ms


def _build_root(root: str):
    sys.path.insert(0, root)
    from mast3r_slam_tpu_torch import _build

    _build.build_all(["ba_gram"])


def main(argv=None):
    """Run the cold starts; returns every run's steps."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--roots", nargs="+",
                    default=[str(HERE.parents[2])])
    ap.add_argument("--runs", type=int, default=2,
                    help="fresh processes per root at each turn")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--build", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(_child(args.child)), flush=True)
        return None
    if args.build:
        _build_root(args.build)
        return None
    roots = [str(Path(r).resolve()) for r in args.roots]
    for root in dict.fromkeys(roots):
        subprocess.run([sys.executable, str(HERE), "--build", root],
                       check=True, cwd=root)
    runs = []
    for root in roots:
        for _ in range(args.runs):
            out = subprocess.run([sys.executable, str(HERE), "--child", root],
                                 check=True, cwd=root, capture_output=True,
                                 text=True).stdout
            runs.append(json.loads(out.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    print(f"{'root':40s} " + " ".join(f"{s:>9s}" for s in STEPS)
          + "  lib bytes  (median ms)")
    for root in dict.fromkeys(roots):
        mine = [r for r in runs if r["root"] == root]
        cells = []
        for s in STEPS:
            vals = [r[s] for r in mine if s in r]
            cells.append(f"{statistics.median(vals):9.2f}" if vals
                         else f"{'-':>9s}")
        print(f"{root[-40:]:40s} " + " ".join(cells)
              + f"  {mine[0]['lib_bytes']}", flush=True)
    return runs


if __name__ == "__main__":
    main()
