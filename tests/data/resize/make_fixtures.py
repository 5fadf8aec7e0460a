"""Writes ``fixtures.json``: for each case of ``tests/torch_resize_inputs.py``
the SHA-256 and shape of ``cv2.resize(img, (w, h),
interpolation=cv2.INTER_AREA)`` on its seeded float32 input (the same size
is cv2's copy).

    python tests/data/resize/make_fixtures.py

``tests/test_torch_resize.py`` holds the port's compiled resize and its
plain version against these digests here, and ``chip_smoke.py``'s data
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
from torch_resize_inputs import CASES, seeded_image  # noqa: E402


def main():
    out = {"opencv": cv2.__version__, "resizes": {}}
    for i, (name, (shape, (h, w))) in enumerate(sorted(CASES.items())):
        img = seeded_image(shape, seed=i)
        r = np.ascontiguousarray(
            cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA),
            np.float32)
        out["resizes"][name] = {
            "input": list(shape), "seed": i, "out_hw": [h, w],
            "shape": list(r.shape),
            "input_sha256": hashlib.sha256(img.tobytes()).hexdigest(),
            "sha256": hashlib.sha256(r.tobytes()).hexdigest()}
    (HERE / "fixtures.json").write_text(json.dumps(out, indent=1) + "\n")


if __name__ == "__main__":
    main()
