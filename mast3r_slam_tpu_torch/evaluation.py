"""Trajectory scoring (counterpart of ``mast3r_slam_tpu/evaluation.py``).

Only the Umeyama alignment behind the ATE so far; trajectory files, PLY
export and the full ``ate_rmse`` come with the CLI. Plain numpy.
"""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src, dst, with_scale=True):
    """Least-squares Sim(3) (or SE(3)) aligning ``src (N, 3)`` onto
    ``dst (N, 3)`` (Umeyama 1991). Returns ``(s, R, t)`` with
    ``dst ≈ s R src + t``."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        s = float(np.trace(np.diag(d) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t
