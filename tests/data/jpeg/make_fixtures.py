"""Writes the JPEG fixtures of this folder and ``fixtures.json`` with
OpenCV: small ``cv2``-encoded files (one per sampling mode, one with
restart markers, one of odd size), the SHA-256 of ``cv2.imdecode``'s RGB
result for each, and ``K_undist`` (``cv2.getOptimalNewCameraMatrix`` at
alpha 0 with the principal point centred, as the JAX package's
``Intrinsics`` builds it) for EuRoC cam0 and TUM freiburg1 / freiburg2.

    python tests/data/jpeg/make_fixtures.py

``tests/test_torch_jpeg.py`` and ``tests/test_torch_undistort.py`` hold
the port's decoder and undistortion against these numbers here, and
``chip_smoke.py``'s data phase on the card machine, which has no cv2.
"""

import hashlib
import json
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent

# name: (height, width, sampling or None for gray, quality, restart MCUs)
FILES = {
    "s444.jpg": (48, 64, "444", 90, 0),
    "s422.jpg": (48, 64, "422", 90, 0),
    "s420.jpg": (48, 64, "420", 90, 0),
    "s440.jpg": (48, 64, "440", 90, 0),
    "gray.jpg": (48, 64, None, 90, 0),
    "rst3_420.jpg": (48, 64, "420", 75, 3),
    "odd_33x65_420.jpg": (33, 65, "420", 95, 0),
}

# (W, H, fx, fy, cx, cy, k1, k2, p1, p2, k3)
CAMERAS = {
    # EuRoC MAV cam0 (mav0/cam0/sensor.yaml of the MH sequences)
    "euroc_cam0": (752, 480, 458.654, 457.296, 367.215, 248.375,
                   -0.28340811, 0.07395907, 0.00019359, 1.76187114e-05,
                   0.0),
    # TUM RGB-D freiburg1 / freiburg2 (the dataset's published calibration)
    "tum_freiburg1": (640, 480, 517.3, 516.5, 318.6, 255.3,
                      0.2624, -0.9531, -0.0054, 0.0026, 1.1633),
    "tum_freiburg2": (640, 480, 520.9, 521.0, 325.1, 249.7,
                      0.2312, -0.7849, -0.0033, -0.0001, 0.9172),
}


def image(h, w, seed):
    """Smooth color texture plus noise, as uint8 RGB."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ch = [np.sin(rng.uniform(0.02, 0.3) * xx + rng.uniform(0.02, 0.3) * yy
                 + rng.uniform(0, 6)) for _ in range(3)]
    img = (0.9 * np.stack(ch, -1) + 1.0) * 127.5 + rng.normal(0, 12,
                                                             (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def digest(rgb):
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def k_undist(cam):
    W, H, fx, fy, cx, cy, *dist = cam
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    d = np.asarray(dist, np.float32)
    new_K, _ = cv2.getOptimalNewCameraMatrix(K, d, (W, H), 0, (W, H))
    new_K[0, 2], new_K[1, 2] = W / 2.0, H / 2.0
    return new_K.astype(np.float32)


def main():
    out = {"opencv": cv2.__version__, "decoded_sha256": {}, "shape": {},
           "cameras": {}}
    for i, (name, (h, w, samp, q, rst)) in enumerate(FILES.items()):
        rgb = image(h, w, i)
        params = [cv2.IMWRITE_JPEG_QUALITY, q,
                  cv2.IMWRITE_JPEG_RST_INTERVAL, rst]
        if samp is None:
            ok, enc = cv2.imencode(".jpg", rgb[..., 1], params)
        else:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                       getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{samp}")]
            ok, enc = cv2.imencode(".jpg", rgb[..., ::-1], params)
        assert ok
        (HERE / name).write_bytes(enc.tobytes())
        dec = cv2.imdecode(enc, cv2.IMREAD_UNCHANGED)
        dec = dec if dec.ndim == 2 else dec[..., ::-1]
        out["decoded_sha256"][name] = digest(dec)
        out["shape"][name] = list(dec.shape)
    for name, cam in CAMERAS.items():
        out["cameras"][name] = {"calib": list(cam),
                                "K_undist": k_undist(cam).tolist()}
    (HERE / "fixtures.json").write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
