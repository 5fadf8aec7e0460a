"""Writes the video fixtures of this folder with OpenCV (``cv2.VideoWriter``,
its FFmpeg backend) and ``digests.json``: for each file, cv2's
``CAP_PROP_FPS`` and ``CAP_PROP_FRAME_COUNT``, and per frame the SHA-256 of
``cv2.VideoCapture``'s RGB frame and of the port's (``data/video.py``),
with the largest and the mean absolute difference between the two.

    python tests/data/video/make_fixtures.py

The frames are a smooth texture panning out and back (the CLI tests'
clips), so that the P-VOPs carry real motion vectors; ``xvid_busy.avi``
cuts from it to moving noise halfway, which gives intra macroblocks in
P-VOPs and TCOEF escapes. ``tests/test_torch_video.py`` holds the port
against cv2 and the JAX reader on these files, and ``chip_smoke.py``'s
video phase holds it against the digests on the card machine, which has
no cv2. This script is a test tool: the port never imports it.
"""

import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))
from mast3r_slam_tpu_torch.data import video  # noqa: E402

# name: (fourcc, (height, width), frames, kind)
FILES = {
    "cli_640x480.mp4": ("mp4v", (480, 640), 16, "pan"),
    "mp4v.mov": ("mp4v", (120, 160), 16, "pan"),
    "mp4v.mkv": ("mp4v", (120, 160), 16, "pan"),
    "mp4v_152x104.mp4": ("mp4v", (104, 152), 12, "pan"),
    "mp4v_one.mp4": ("mp4v", (120, 160), 1, "pan"),
    "xvid.avi": ("XVID", (120, 160), 16, "pan"),
    "xvid_busy.avi": ("XVID", (88, 120), 10, "busy"),
    "mjpg.avi": ("MJPG", (120, 160), 8, "pan"),
    "mjpg.mkv": ("MJPG", (96, 128), 8, "pan"),
}


def pan_frames(n, hw, step=(6.0, 2.0), seed=0):
    """Smooth texture panning out and back: uint8 RGB ``(H, W, 3)``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float64)
    freqs = rng.uniform(0.01, 0.05, (3, 2))
    phases = rng.uniform(0, 2 * np.pi, 3)
    for i in range(n):
        p = min(i, n - 1 - i)
        x, y = xx + step[0] * p, yy + step[1] * p
        img = np.stack([np.sin(fx * x + fy * y + ph)
                        for (fx, fy), ph in zip(freqs, phases)], -1)
        yield ((0.9 * img + 1.0) * 127.5).astype(np.uint8)


def busy_frames(n, hw, seed=5):
    """The pan, then from frame n // 2 moving noise around a still patch."""
    noise = np.random.default_rng(seed).integers(0, 256, (*hw, 3),
                                                 dtype=np.uint8)
    h, w = hw
    for i, f in enumerate(pan_frames(n, hw, seed=3)):
        if i >= n // 2:
            g = np.roll(noise, (3 * i, 5 * i), (0, 1))
            g[h // 3:2 * h // 3, w // 3:2 * w // 3] = \
                f[h // 3:2 * h // 3, w // 3:2 * w // 3]
            f = g
        yield f


def write(path, fourcc, hw, n, kind):
    frames = (pan_frames(n, hw, step=(12.0, 4.0)) if hw[1] >= 640 else
              busy_frames(n, hw) if kind == "busy" else pan_frames(n, hw))
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 30,
                         (hw[1], hw[0]))
    if not wr.isOpened():
        raise RuntimeError(f"cv2 cannot write {path}")
    for f in frames:
        wr.write(np.ascontiguousarray(f[..., ::-1]))
    wr.release()


def sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    out = {}
    for name, (fourcc, hw, n, kind) in FILES.items():
        path = HERE / name
        write(path, fourcc, hw, n, kind)
        cap = cv2.VideoCapture(str(path))
        reader = video.VideoReader(path)
        frames = []
        for i in range(int(cap.get(cv2.CAP_PROP_FRAME_COUNT))):
            ok, bgr = cap.read()
            assert ok, (name, i)
            want = bgr[..., ::-1]
            got = reader.read(i)
            d = np.abs(got.astype(np.int16) - want.astype(np.int16))
            frames.append({"cv2": sha(want), "port": sha(got),
                           "max_abs": int(d.max()),
                           "mean_abs": float(d.mean())})
        out[name] = {"fourcc": fourcc, "hw": list(hw),
                     "fps": cap.get(cv2.CAP_PROP_FPS),
                     "frame_count": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
                     "frames": frames}
        print(name, path.stat().st_size, "bytes,",
              "max |port - cv2|", max(f["max_abs"] for f in frames))
    (HERE / "digests.json").write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
