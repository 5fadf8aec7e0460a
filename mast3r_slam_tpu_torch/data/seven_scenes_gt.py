"""TUM-format ground truth for a 7-Scenes sequence.

    python -m mast3r_slam_tpu_torch.data.seven_scenes_gt <scene_dir> [out.txt]

The port's copy of the JAX repo's ``scripts/make_7scenes_gt.py``: 7-Scenes
ships a 4x4 camera-to-world pose per frame (``seq-01/frame-XXXXXX.pose.txt``),
and this writes them as ``ts tx ty tz qx qy qz qw`` rows, the rotation as a
quaternion by Shepperd's method, timestamps ``frame_index / 30`` (as
``data/datasets.py::SevenScenesDataset`` times the frames). The default
output is ``groundtruths/7-scenes/<scene>.txt``, where
``bench/eval_datasets.py`` looks for it.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np


def mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → (qx, qy, qz, qw), Shepperd's method."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    return np.array([qx, qy, qz, qw])


def convert(scene_dir, out_path) -> int:
    """Write ``out_path`` from ``scene_dir``'s pose files (under
    ``seq-01/`` when it exists); returns the number of poses."""
    scene_dir, out_path = pathlib.Path(scene_dir), pathlib.Path(out_path)
    seq = scene_dir / "seq-01"
    if not seq.exists():
        seq = scene_dir
    poses = sorted(seq.glob("frame-*.pose.txt"))
    if not poses:
        raise FileNotFoundError(f"no frame-*.pose.txt under {seq}")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as f:
        f.write("# ts tx ty tz qx qy qz qw (from 7-Scenes pose files)\n")
        for i, p in enumerate(poses):
            T = np.loadtxt(p).reshape(4, 4)
            q = mat_to_quat(T[:3, :3])
            t = T[:3, 3]
            f.write(f"{i / 30.0:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")
    return len(poses)


def default_path(scene_dir) -> pathlib.Path:
    return (pathlib.Path("groundtruths") / "7-scenes"
            / f"{pathlib.Path(scene_dir).name}.txt")


if __name__ == "__main__":
    scene = pathlib.Path(sys.argv[1])
    out = pathlib.Path(sys.argv[2]) if len(sys.argv) > 2 else default_path(
        scene)
    n = convert(scene, out)
    print(f"{n} poses → {out}")
