"""The resize fixtures' inputs, made without cv2 and without numpy's random
generators (whose streams a numpy version may change): ``seeded_image``
is an integer hash of each element's index and the seed, so the machine
that checks the digests (``chip_smoke.py``'s data phase, on a machine
with no cv2) makes the same bits as the one that wrote them
(``tests/data/resize/make_fixtures.py``)."""

import numpy as np

# name → (input (H, W, C), output (h, w)): the main path's crops at
# 512 (TUM 480x640, EuRoC 480x752, Replica 680x1200, ETH3D 458x739), the
# CPU tests' 96 and the 224 square mode's sizes, the integer scale
# (resizeAreaFast_, one channel and three; 38x46 leaves columns after
# OpenCV's vector loop), an odd shrink and the same-size copy
CASES = {
    "tum_512": ((480, 640, 3), (384, 512)),
    "euroc_512": ((480, 752, 3), (327, 512)),
    "replica_512": ((680, 1200, 3), (290, 512)),
    "eth3d_512": ((458, 739, 3), (317, 512)),
    "tum_96": ((480, 640, 3), (72, 96)),
    "tum_224": ((480, 640, 3), (224, 299)),
    "gray_512": ((480, 640, 1), (384, 512)),
    "half_rgb": ((768, 1024, 3), (384, 512)),
    "half_gray": ((768, 1024, 1), (384, 512)),
    "half_gray_odd": ((38, 46, 1), (19, 23)),
    "third_rgb": ((90, 99, 3), (30, 33)),
    "odd_rgb": ((37, 53, 3), (19, 31)),
    "copy_512": ((384, 512, 3), (384, 512)),
}


def seeded_image(shape, seed):
    """float32 values in [0, 1) on a 2**-24 grid: a 32-bit integer hash
    (multiply, xor-shift, multiply) of each element's flat index and
    ``seed``. A one-channel shape gives a 2-D image."""
    H, W, C = shape
    x = np.arange(H * W * C, dtype=np.uint64) + np.uint64(seed) * np.uint64(
        0x9E3779B9)
    x = (x * np.uint64(0x85EBCA6B)) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    img = ((x >> np.uint64(8)).astype(np.float32)
           * np.float32(2.0 ** -24)).reshape(H, W, C)
    return img[..., 0].copy() if C == 1 else img
