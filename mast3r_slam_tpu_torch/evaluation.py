"""Trajectory and reconstruction export, and trajectory scoring
(counterpart of ``mast3r_slam_tpu/evaluation.py``).

``prepare_savedir`` / ``save_traj`` / ``save_reconstruction`` /
``save_ply_with_quality`` / ``save_keyframes`` write the CLI's results
(PLY written directly as binary little-endian, the quality grids resized
by ``data/image_ops.py``'s weights; keyframe PNGs through
``data/png.py``), and ``ate_rmse`` / ``rpe_rmse`` / ``main_ape`` are the
``evo_ape tum <gt> <est> -as`` equivalent: timestamp association, Umeyama
Sim(3) alignment and translational RMSE. Host numpy.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from mast3r_slam_tpu_torch.data import image_ops, png
from mast3r_slam_tpu_torch.ops import lie

_QUALITY_FIELDS = ("r", "delta_cov", "u", "class_id", "priority")


# ---------------------------------------------------------------------------
# Save directory / trajectory
# ---------------------------------------------------------------------------

def prepare_savedir(save_as: str, dataset):
    """``logs/<save_as>/<dataset_name>/``, created if missing."""
    name = pathlib.Path(str(getattr(dataset, "path", "live"))).name or "live"
    savedir = pathlib.Path("logs") / (save_as or "default") / name
    savedir.mkdir(parents=True, exist_ok=True)
    return savedir, name


def save_traj(savedir, filename: str, timestamps, keyframes) -> pathlib.Path:
    """TUM-format trajectory ``t x y z qx qy qz qw`` of the keyframe poses
    (the Sim(3) scale is dropped)."""
    path = pathlib.Path(savedir) / filename
    with keyframes.lock:
        n = len(keyframes)
        T = keyframes.T_WC[:n].cpu().numpy()
        ids = [int(keyframes.dataset_idx[i]) for i in range(n)]
    with open(path, "w") as f:
        for i in range(n):
            t = timestamps[ids[i]] if ids[i] < len(timestamps) else float(ids[i])
            tx, ty, tz, qx, qy, qz, qw = T[i, :7]
            f.write(f"{t:.6f} {tx:.9f} {ty:.9f} {tz:.9f} "
                    f"{qx:.9f} {qy:.9f} {qz:.9f} {qw:.9f}\n")
    return path


# ---------------------------------------------------------------------------
# PLY export
# ---------------------------------------------------------------------------

def _uimg_colors(uimg, h, w):
    """Display image → per-pointmap-pixel colors (h*w, 3) float [0, 255];
    a decimated display image is repeated back to the pointmap grid."""
    u = np.asarray(uimg, np.float32)
    if u.shape[0] != h or u.shape[1] != w:
        ry = int(np.ceil(h / u.shape[0]))
        rx = int(np.ceil(w / u.shape[1]))
        u = np.repeat(np.repeat(u, ry, 0), rx, 1)[:h, :w]
    u = u.reshape(-1, 3)
    if u.max() <= 1.0:
        u = u * 255.0
    return u


def write_ply(path, xyz: np.ndarray, rgb: np.ndarray | None = None,
              extra: dict[str, np.ndarray] | None = None):
    """Binary little-endian PLY with optional uchar colors and float / int
    properties."""
    n = xyz.shape[0]
    props = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    cols = [xyz[:, 0].astype("<f4"), xyz[:, 1].astype("<f4"),
            xyz[:, 2].astype("<f4")]
    names = ["float x", "float y", "float z"]
    if rgb is not None:
        for i, c in enumerate("red green blue".split()):
            props.append((c, "u1"))
            cols.append(rgb[:, i].astype("u1"))
            names.append(f"uchar {c}")
    for k, v in (extra or {}).items():
        if np.issubdtype(v.dtype, np.integer):
            props.append((k, "<i4"))
            cols.append(v.astype("<i4"))
            names.append(f"int {k}")
        else:
            props.append((k, "<f4"))
            cols.append(v.astype("<f4"))
            names.append(f"float {k}")
    rec = np.empty(n, dtype=props)
    for (name, _), col in zip(props, cols):
        rec[name] = col
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property {s}\n" for s in names)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


def _world_points(keyframes, i, conf_threshold):
    """Keyframe ``i``'s points in the world frame, kept by average
    confidence, and their colors."""
    X = keyframes.X[i]
    C = keyframes.C[i][:, 0].cpu().numpy()
    Nw = max(int(keyframes.N[i]), 1)
    keep = (C / Nw) > conf_threshold
    Xw = lie.act(keyframes.T_WC[i][None], X).cpu().numpy()[keep]
    rgb = _uimg_colors(keyframes.uimg[i], keyframes.h, keyframes.w)[keep]
    return Xw, rgb.astype(np.uint8), keep


def save_reconstruction(savedir, filename, keyframes, conf_threshold=0.0):
    """Dense colored point cloud of all keyframes in the world frame."""
    pts, cols = [], []
    with keyframes.lock:
        for i in range(len(keyframes)):
            Xw, rgb, _ = _world_points(keyframes, i, conf_threshold)
            pts.append(Xw)
            cols.append(rgb)
    if not pts:
        return None
    path = pathlib.Path(savedir) / filename
    write_ply(path, np.concatenate(pts), np.concatenate(cols))
    return path


def upsample_quality_grid(grid, h, w, nearest=False):
    """A quality grid ``(gh, gw)`` resized to the pointmap's ``(h, w)`` as
    ``cv2.resize`` does it: ``INTER_LINEAR``, or ``INTER_NEAREST`` for the
    categorical class id, applied as float32 weight matrices."""
    g = np.asarray(grid, np.float32)
    weights = image_ops.nearest_weights if nearest else image_ops.linear_weights
    Wy = weights(g.shape[0], h).astype(np.float32)
    Wx = weights(g.shape[1], w).astype(np.float32)
    return Wy @ (g @ Wx.T)


def save_ply_with_quality(savedir, filename, keyframes, quality_service,
                          conf_threshold=0.0):
    """Dense PLY with per-vertex quality fields ``r/delta_cov/u/class_id/
    priority``, upsampled from each keyframe's latest quality grids
    (zeros for a keyframe without a result, or without a service)."""
    pts, cols = [], []
    extras = {k: [] for k in _QUALITY_FIELDS}
    with keyframes.lock:
        h, w = keyframes.h, keyframes.w
        for i in range(len(keyframes)):
            Xw, rgb, keep = _world_points(keyframes, i, conf_threshold)
            pts.append(Xw)
            cols.append(rgb)
            q = quality_service.get_by_kf_id(i) if quality_service else None
            for k in extras:
                if q is None:
                    full = np.zeros(h * w, np.float32)
                else:
                    full = upsample_quality_grid(
                        q[k], h, w, nearest=k == "class_id").reshape(-1)
                extras[k].append(full[keep])
    if not pts:
        return None
    path = pathlib.Path(savedir) / filename
    extra = {k: np.concatenate(v) for k, v in extras.items()}
    extra["class_id"] = extra["class_id"].astype(np.int32)
    write_ply(path, np.concatenate(pts), np.concatenate(cols), extra)
    return path


def save_keyframes(savedir, timestamps, keyframes):
    """PNG dump of the keyframe display images, named by timestamp."""
    outdir = pathlib.Path(savedir) / "keyframes"
    outdir.mkdir(parents=True, exist_ok=True)
    with keyframes.lock:
        for i in range(len(keyframes)):
            uimg = np.asarray(keyframes.uimg[i])
            if uimg.dtype != np.uint8:
                uimg = np.clip(uimg * 255, 0, 255).astype(np.uint8)
            fid = int(keyframes.dataset_idx[i])
            ts = timestamps[fid] if fid < len(timestamps) else float(i)
            png.write_png(outdir / f"{ts:.6f}.png", uimg)


# ---------------------------------------------------------------------------
# ATE / RPE (evo_ape tum <gt> <est> -as equivalent)
# ---------------------------------------------------------------------------

def main_ape(argv=None):
    """CLI: ``python -m mast3r_slam_tpu_torch.evaluation <gt> <est>
    [-as|-a] [--rpe DELTA]``."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("gt")
    ap.add_argument("est")
    ap.add_argument("-a", "--align", action="store_true")
    ap.add_argument("-s", "--correct-scale", action="store_true")
    ap.add_argument("-as", dest="align_scale", action="store_true")
    ap.add_argument("--max-diff", type=float, default=0.02)
    ap.add_argument("--rpe", type=int, default=0, metavar="DELTA",
                    help="also report relative pose error over DELTA-step "
                         "pairs (evo_rpe equivalent)")
    args = ap.parse_args(argv)
    align = args.align or args.align_scale
    scale = args.correct_scale or args.align_scale
    res = ate_rmse(args.gt, args.est, align=align, scale=scale,
                   max_diff=args.max_diff)
    print("APE w.r.t. translation part (m)")
    for k in ("rmse", "mean", "median", "std", "min", "max"):
        print(f"  {k:>8s}  {res[k]:.6f}")
    print(f"  pairs: {res['n_pairs']}")
    if args.rpe > 0:
        rres = rpe_rmse(args.gt, args.est, delta=args.rpe,
                        align_scale=scale, max_diff=args.max_diff)
        print(f"RPE w.r.t. translation part (m), delta={args.rpe}")
        for k in ("rmse", "mean", "median", "std", "min", "max"):
            print(f"  {k:>8s}  {rres[k]:.6f}")
        print(f"  pairs: {rres['n_pairs']}")
        res["rpe"] = rres
    return res


def load_tum_traj(path):
    """Trajectory file → (timestamps (N,), t (N, 3), q (N, 4) xyzw). Reads
    the TUM format and EuRoC's ``data.csv`` (nanosecond timestamps,
    w-first quaternions), told apart by the timestamp magnitude."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("ts"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) >= 8:
                rows.append(vals[:8])
    arr = np.asarray(rows, np.float64)
    ts, t, q = arr[:, 0], arr[:, 1:4], arr[:, 4:8]
    if ts.size and ts.max() > 1e14:
        ts = ts / 1e9
        q = q[:, [1, 2, 3, 0]]
    return ts, t, q


def associate(ts_a, ts_b, max_diff=0.02):
    """Nearest-timestamp association (one-to-one, greedy in ``ts_a``
    order)."""
    ia, ib = [], []
    used = np.zeros(len(ts_b), bool)
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - t)))
        if not used[j] and abs(ts_b[j] - t) <= max_diff:
            ia.append(i)
            ib.append(j)
            used[j] = True
    return np.asarray(ia, int), np.asarray(ib, int)


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


def _stats(err):
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "std": float(err.std()),
        "min": float(err.min()),
        "max": float(err.max()),
        "n_pairs": int(len(err)),
    }


def ate_rmse(gt_file, est_file, align=True, scale=True, max_diff=0.02):
    """Absolute trajectory error after association (+ Sim(3) alignment):
    dict of rmse / mean / median / std / min / max / n_pairs."""
    ts_g, t_g, _ = load_tum_traj(gt_file)
    ts_e, t_e, _ = load_tum_traj(est_file)
    ie, ig = associate(ts_e, ts_g, max_diff)
    if len(ie) < 3:
        raise ValueError(f"only {len(ie)} associated pairs (need >= 3)")
    P = t_e[ie]
    G = t_g[ig]
    if align:
        s, R, t = umeyama_alignment(P, G, with_scale=scale)
        P = (s * (R @ P.T)).T + t
    return _stats(np.linalg.norm(P - G, axis=1))


def _quat_matrix(q):
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def rpe_rmse(gt_file, est_file, delta=1, align_scale=True, max_diff=0.02):
    """Relative pose error (translation part) over ``delta``-step pairs,
    with only the global scale aligned when ``align_scale``."""
    ts_g, t_g, q_g = load_tum_traj(gt_file)
    ts_e, t_e, q_e = load_tum_traj(est_file)
    ie, ig = associate(ts_e, ts_g, max_diff)
    if len(ie) < delta + 2:
        raise ValueError(f"only {len(ie)} associated pairs")
    P, G = t_e[ie], t_g[ig]
    if align_scale:
        s, _, _ = umeyama_alignment(P, G, with_scale=True)
        P = s * P

    def rel(tr, q, i, j):
        return _quat_matrix(q[i]).T @ (tr[j] - tr[i])

    errs = [np.linalg.norm(rel(P, q_e[ie], a, a + delta)
                           - rel(G, q_g[ig], a, a + delta))
            for a in range(len(ie) - delta)]
    return _stats(np.asarray(errs))


if __name__ == "__main__":
    main_ape()
