"""Writes the PNG fixtures of this folder and ``fixtures.json``: one file
for every colour type x bit depth x interlace that libpng reads (written
by ``tests/torch_png_writer.py``: neither OpenCV nor PIL writes them all),
a palette file with ``tRNS``, a gray and an RGB file with ``tRNS``, RGB
and palette files with a ``gAMA`` of 1/2.2 and an RGB file with ``sRGB``
(the gray read then goes through libpng's gamma tables), and an RGB image
under each of the 8 EXIF orientations in an ``eXIf`` chunk (little-endian
TIFF, one big-endian, one after the image data). For each file it records
the SHA-256 and shape of ``cv2.imread``'s colour (as RGB) and gray reads.

    python tests/data/png/make_fixtures.py

``tests/test_torch_png.py`` and ``tests/test_torch_exif.py`` hold the
port's reader against these numbers here, and ``chip_smoke.py``'s data
phase on the card machine, which has no cv2.
"""

import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
from torch_png_writer import (CHANNELS, DEPTHS, chunk,  # noqa: E402
                              encode_png, exif_orientation)

HW = (11, 13)          # odd: partial bytes at 1-4 bits, every Adam7 pass
EXIF_HW = (10, 14)


def samples(shape, depth, seed):
    """Seeded samples: a gradient plus noise over the depth's range."""
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    ramp = np.linspace(0, 1, int(np.prod(shape))).reshape(shape)
    v = ramp * top + rng.normal(0, top / 6 + 0.5, shape)
    return np.clip(np.round(v), 0, top).astype(np.int64)


def files():
    """name → PNG bytes."""
    out, seed = {}, 0
    for ct, depths in DEPTHS.items():
        for depth in depths:
            for il in (False, True):
                seed += 1
                shape = HW if CHANNELS[ct] == 1 else HW + (CHANNELS[ct],)
                kw = dict(color_type=ct, depth=depth, interlace=il)
                if ct == 3:
                    n = min(1 << depth, 40)
                    kw["palette"] = samples((n, 3), 8, seed + 100)
                    img = samples(shape, 8, seed) % n
                else:
                    img = samples(shape, depth, seed)
                out[f"t{ct}_d{depth}{'_adam7' if il else ''}.png"] = \
                    encode_png(img, **kw)
    rgb = samples(HW + (3,), 8, 200)
    pal = samples((16, 3), 8, 201)
    idx = samples(HW, 8, 202) % 16
    out["t3_trns.png"] = encode_png(idx, palette=pal, trns=range(0, 256, 17))
    out["t0_trns.png"] = encode_png(samples(HW, 8, 203), trns=[0, 77])
    out["t2_trns.png"] = encode_png(rgb, trns=[0, 1, 0, 2, 0, 3])
    out["t2_gamma.png"] = encode_png(rgb, gamma=45455)
    out["t3_gamma.png"] = encode_png(idx, palette=pal, gamma=45455)
    plain = encode_png(rgb)
    out["t2_srgb.png"] = plain[:33] + chunk(b"sRGB", b"\0") + plain[33:]
    img = samples(EXIF_HW + (3,), 8, 204)
    for o in range(1, 9):
        out[f"exif{o}.png"] = encode_png(img, exif=exif_orientation(o, "II"))
    out["exif6_mm.png"] = encode_png(img, exif=exif_orientation(6, "MM"))
    out["exif8_after_idat.png"] = encode_png(
        img, exif=exif_orientation(8, "II"), exif_after_idat=True)
    return out


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main():
    rec = {"opencv": cv2.__version__, "reads": {}}
    for name, data in files().items():
        assert len(data) < 5000, name
        path = HERE / name
        path.write_bytes(data)
        rgb = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
        gray = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
        rec["reads"][name] = {
            "color_sha256": digest(rgb), "color_shape": list(rgb.shape),
            "gray_sha256": digest(gray), "gray_shape": list(gray.shape)}
    (HERE / "fixtures.json").write_text(json.dumps(rec, indent=1) + "\n")


if __name__ == "__main__":
    main()
