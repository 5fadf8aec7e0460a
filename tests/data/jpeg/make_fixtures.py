"""Writes the JPEG fixtures of this folder and ``fixtures.json`` with
OpenCV and PIL: small files (one per sampling mode, one with restart
markers, one of odd size; progressive 4:2:0, 4:4:4 and gray files, one of
them with restarts; 4:1:1; CMYK as PIL writes it (Adobe, inverted) and
the same file marked YCCK (Adobe transform 2), which neither library
writes; an RGB-coded file (PIL ``keep_rgb``); three cuts of ``s420.jpg``;
``s420.jpg``'s image under each of the 8 EXIF orientations, little-endian
TIFF, and one big-endian), the SHA-256 of ``cv2.imdecode``'s RGB result
for the first seven, of ``cv2.imread``'s colour (RGB) and gray reads for
every file, and ``K_undist`` (``cv2.getOptimalNewCameraMatrix`` at alpha 0
with the principal point centred, as the JAX package's ``Intrinsics``
builds it) for EuRoC cam0 and TUM freiburg1 / freiburg2.

    python tests/data/jpeg/make_fixtures.py

``tests/test_torch_jpeg.py``, ``tests/test_torch_exif.py`` and
``tests/test_torch_undistort.py`` hold the port's decoder and
undistortion against these numbers here, and ``chip_smoke.py``'s data
phase on the card machine, which has no cv2.
"""

import hashlib
import io
import json
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
from torch_png_writer import exif_orientation  # noqa: E402

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
# name: (height, width, sampling or None for gray, quality, restart MCUs),
# written progressive by cv2 (libjpeg's jpeg_simple_progression)
PROGRESSIVE = {
    "prog420.jpg": (48, 64, "420", 90, 0),
    "prog444.jpg": (40, 56, "444", 85, 0),
    "prog_gray.jpg": (48, 64, None, 90, 0),
    "prog420_rst2.jpg": (48, 64, "420", 80, 2),
}
CUTS = (0.3, 0.55, 0.8)        # of s420.jpg's entropy-coded data

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


def encode(rgb, samp, q, rst, progressive=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    if samp is None:
        ok, enc = cv2.imencode(".jpg", rgb[..., 1], params)
    else:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{samp}")]
        ok, enc = cv2.imencode(".jpg", rgb[..., ::-1].copy(), params)
    assert ok
    return enc.tobytes()


def pil_encode(img, **kw):
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=90, **kw)
    return buf.getvalue()


def with_exif(data, tiff):
    """``data`` with an APP1 Exif segment of ``tiff`` after its APP0."""
    app0 = 4 + struct.unpack(">H", data[4:6])[0]
    body = b"Exif\0\0" + tiff
    return (data[:app0] + b"\xff\xe1" + struct.pack(">H", len(body) + 2)
            + body + data[app0:])


def extra_files():
    """name → bytes of the fixtures beyond the first seven."""
    files = {}
    for i, (name, (h, w, samp, q, rst)) in enumerate(PROGRESSIVE.items()):
        files[name] = encode(image(h, w, 20 + i), samp, q, rst, True)
    files["s411.jpg"] = encode(image(48, 64, 30), "411", 90, 0)
    cmyk = pil_encode(Image.fromarray(image(40, 48, 31)).convert("CMYK"))
    files["cmyk.jpg"] = cmyk
    adobe = cmyk.index(b"\xff\xeeAdobe"[:2] + b"\x00\x0eAdobe")
    transform = adobe + 4 + 11           # marker, length, then 11 bytes
    assert cmyk[transform] == 0
    files["ycck.jpg"] = cmyk[:transform] + b"\x02" + cmyk[transform + 1:]
    files["rgb.jpg"] = pil_encode(Image.fromarray(image(40, 48, 32)),
                                  keep_rgb=True)
    base = (HERE / "s420.jpg").read_bytes()
    sos = base.index(b"\xff\xda")
    start = sos + 2 + struct.unpack(">H", base[sos + 2:sos + 4])[0]
    for c in CUTS:
        files[f"cut{int(c * 100)}_420.jpg"] = base[:start + int(
            c * (len(base) - 2 - start))]
    for o in range(1, 9):
        files[f"exif{o}.jpg"] = with_exif(base, exif_orientation(o, "II"))
    files["exif6_mm.jpg"] = with_exif(base, exif_orientation(6, "MM"))
    return files


def read_digests(path):
    """SHA-256 and shape of cv2.imread's colour (as RGB) and gray reads."""
    rgb = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
    gray = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    return {"color_sha256": digest(rgb), "color_shape": list(rgb.shape),
            "gray_sha256": digest(gray), "gray_shape": list(gray.shape)}


def main():
    out = {"opencv": cv2.__version__, "decoded_sha256": {}, "shape": {},
           "reads": {}, "cameras": {}}
    for i, (name, (h, w, samp, q, rst)) in enumerate(FILES.items()):
        enc = np.frombuffer(encode(image(h, w, i), samp, q, rst), np.uint8)
        (HERE / name).write_bytes(enc.tobytes())
        dec = cv2.imdecode(enc, cv2.IMREAD_UNCHANGED)
        dec = dec if dec.ndim == 2 else dec[..., ::-1]
        out["decoded_sha256"][name] = digest(dec)
        out["shape"][name] = list(dec.shape)
    for name, data in extra_files().items():
        assert len(data) < 5000, name
        (HERE / name).write_bytes(data)
    for path in sorted(HERE.glob("*.jpg")):
        out["reads"][path.name] = read_digests(path)
    for name, cam in CAMERAS.items():
        out["cameras"][name] = {"calib": list(cam),
                                "K_undist": k_undist(cam).tolist()}
    (HERE / "fixtures.json").write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
