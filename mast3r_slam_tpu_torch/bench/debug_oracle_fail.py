"""Replay the oracle harness until its first tracking failure, then run
that solve again step by step, one printed row per LM iteration.

    python -m mast3r_slam_tpu_torch.bench.debug_oracle_fail [FRAMES]
        [--hw H W] [--nan-frame F] [--device cuda]

Counterpart of ``scripts/debug_oracle_fail.py``, the oracle harness's
debugging tool. The scene is ``utils/oracle_scene.py``'s (seed 0, 64x96,
:func:`make_trajectory` of ``FRAMES`` poses, 96 by default), and the
inputs are the script's draw for draw: one ``np.random.default_rng(0)``
adds the depth-scaled noise to every frame's pointmap and the noise to its
descriptors (frame by frame, before the loop), then, inside the loop, the
noise of each keyframe pointmap seen from the frame (``cross``). Every
frame is matched against the current keyframe (the joint 7x7 window, no
plateau exit, warm-started from the last frame's matches) and its pose
solved with ``slam/tracker.py``'s ``opt_pose_ray_dist_sim3``; a keyframe
every 4 frames. At the first frame whose solve is not ``ok`` it prints the
poses, the NaN counts, the valid share and the match range, then runs that
solve's system again from the same start with ``_solve_damped_7x7``, 25
LM iterations without an exit, one row each (λ, Cholesky, cost before and
after, accepted, step norm), and stops.

``--nan-frame F`` writes NaN into the top quarter of frame F's pointmap (a
failure planted on purpose, to see the tool catch it). On the card by
default; ``--device cpu`` (or ``main(argv, device="cpu")``) runs on the
CPU. Returns (and prints as its last line, with the card's ``nvidia-smi``
name and power limit) one JSON object: every frame's ``ok``, the failing
frame and keyframe (or None) and the LM rows.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

N_FRAMES = 96
HW = (64, 96)
KF_EVERY = 4
MODE = dict(radius=3, dilation_max=5, refine_mode="joint", level_step=1,
            plateau_frac=0.0)
# opt_pose_ray_dist_sim3's settings in the script: sigma_ray, sigma_dist,
# huber_k, max_iters, rel_error, delta_norm, and the keyframe confidence
SOLVE = (0.003, 10.0, 1.345, 50, 1e-3, 1e-3)
Q_KF = 2.0
LM_ROWS = 25


class Frames:
    """The script's scene and draws: ``Xs``, ``Ds`` (float32, ``(H*W, 3)``
    and ``(H*W, 24)``) and each frame's surface hits; :meth:`cross` draws
    a keyframe's pointmap seen from a frame from the same generator."""

    def __init__(self, n_frames, hw):
        from mast3r_slam_tpu_torch.utils.oracle_scene import (
            OracleScene, make_trajectory)

        self.scene = OracleScene(seed=0)
        self.poses = make_trajectory(n_frames)
        self.K = self.scene.intrinsics(hw)
        self.rng = np.random.default_rng(0)
        self.Xs, self.Ds, self.hits = [], [], []
        for T in self.poses:
            X, hits = self.scene.raycast(T, self.K, hw)
            self.Xs.append(X + (0.003 * X[:, 2:3] * self.rng.standard_normal(
                X.shape)).astype(np.float32))
            D = self.scene.descriptors(hits)
            D = D + 0.02 * self.rng.standard_normal(D.shape).astype(
                np.float32)
            self.Ds.append((D / (np.linalg.norm(D, axis=-1, keepdims=True)
                                 + 1e-12)).astype(np.float32))
            self.hits.append(hits)

    def cross(self, k, f):
        X = self.scene.world_to_cam(self.hits[k], self.poses[f]).astype(
            np.float32)
        return X + (0.003 * X[:, 2:3] * self.rng.standard_normal(
            X.shape)).astype(np.float32)


def plant_nan(Xs, frame):
    """NaN in the top quarter of frame ``frame``'s pointmap (rows of the
    flattened map), in place."""
    X = Xs[frame]
    X[:X.shape[0] // 4] = np.nan


def lm_rows(Xf, Xk, valid, T_prev, T_k, emit=None):
    """The failing solve again, step by step (the script's eager replay):
    its ray + distance system from the start ``T_k^-1 T_prev``, and
    ``LM_ROWS`` damped steps, accepting a step whose cost is at most
    ``cost (1 + 1e-6)``. Returns ``(init_cost, H_finite, rows)``."""
    from mast3r_slam_tpu_torch.ops import geometry, lie
    from mast3r_slam_tpu_torch.slam.tracker import (_normal_7x7,
                                                    _ray_dist_channels,
                                                    _solve_damped_7x7)

    sigma_ray, sigma_dist, huber_k = SOLVE[:3]
    n = Xf.shape[0]
    sq = (valid.float() * torch.sqrt(torch.full(
        (n, 1), Q_KF, device=Xf.device)))[:, 0]
    sqrt_info = torch.stack([(1 / sigma_ray) * sq] * 3
                            + [(1 / sigma_dist) * sq])
    rd_k, _ = _ray_dist_channels(Xk)

    def system(T):
        Xf_Ck = lie.act(T, Xf)
        rd_f, drd = _ray_dist_channels(Xf_Ck)
        J = geometry.compose_jac(drd, geometry.point_jac(Xf_Ck), negate=True)
        return _normal_7x7(sqrt_info, rd_k - rd_f, J, huber_k)

    T = lie.compose(lie.inv(T_k), T_prev)
    Hm, g, c = system(T)
    init = float(c)
    finite = bool(torch.isfinite(Hm).all())
    if emit:
        emit("init cost", init, "H finite", finite)
    lam, rows = 1e-8, []
    for it in range(LM_ROWS):
        tau, chol_ok = _solve_damped_7x7(Hm, g, lam)
        T_cand = lie.retr(T, tau)
        H2, g2, c2 = system(T_cand)
        acc = bool(chol_ok) and float(c2) <= float(c) * (1 + 1e-6)
        row = dict(it=it, lam=lam, chol=bool(chol_ok), cost=float(c),
                   cost_cand=float(c2), acc=acc,
                   taunorm=float(torch.linalg.norm(tau)))
        rows.append(row)
        if emit:
            emit(f"it {it:2d} lam {lam:9.1e} chol {row['chol']} cost "
                 f"{row['cost']:.2f} -> {row['cost_cand']:.2f} acc {acc} "
                 f"taunorm {row['taunorm']:.5f}")
        if acc:
            T, Hm, g, c = T_cand, H2, g2, c2
            lam = max(1e-8, lam * 0.25)
        else:
            lam *= 10
    return init, finite, rows


def run(n_frames=N_FRAMES, hw=HW, device="cuda", nan_frame=None,
        emit=print):
    """The replay (see the module docstring). Returns ``{"ok": [per frame
    1..], "failure": [frame, keyframe] or None, "init_cost", "H_finite",
    "rows", "ms"}``."""
    from mast3r_slam_tpu_torch.ops import matching
    from mast3r_slam_tpu_torch.slam.tracker import opt_pose_ray_dist_sim3

    dev = torch.device(device)
    H, W = hw
    n = H * W
    fr = Frames(n_frames, hw)
    if nan_frame is not None:
        plant_nan(fr.Xs, nan_frame)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    t0 = time.perf_counter()
    T_prev = T_k = t(fr.poses[0])
    k = 0
    idx_warm = torch.arange(n, device=dev)
    out = {"ok": [], "failure": None, "init_cost": None, "H_finite": None,
           "rows": []}
    for f in range(1, n_frames):
        Xkf = fr.cross(k, f)
        idx, valid = matching.match(
            t(fr.Xs[f]).reshape(1, H, W, 3), t(Xkf).reshape(1, H, W, 3),
            t(fr.Ds[f]).reshape(1, H, W, -1),
            t(fr.Ds[k]).reshape(1, H, W, -1),
            idx_1_to_2_init=idx_warm[None], **MODE)
        Xf = t(fr.Xs[f])[idx[0]]
        Xk = t(fr.Xs[k])
        T_new, _, ok = opt_pose_ray_dist_sim3(
            Xf, Xk, T_prev, T_k, torch.full((n, 1), Q_KF, device=dev),
            valid[0].float(), *SOLVE)
        out["ok"].append(bool(ok))
        if not out["ok"][-1]:
            out["failure"] = [f, k]
            emit(f"first failure: frame {f} vs kf {k}")
            emit("T_prev", T_prev.cpu().numpy())
            emit("T_k", T_k.cpu().numpy())
            emit("Xf nan", int(torch.isnan(Xf).sum()), "Xk nan",
                 int(torch.isnan(Xk).sum()), "valid frac",
                 float(valid.float().mean()), "idx min/max",
                 int(idx.min()), int(idx.max()))
            out["init_cost"], out["H_finite"], out["rows"] = lm_rows(
                Xf, Xk, valid[0], T_prev, T_k, emit)
            break
        T_prev = T_new
        idx_warm = idx[0]
        if f % KF_EVERY == 0:
            k = f
            T_k = T_new
            idx_warm = torch.arange(n, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["ms"] = (time.perf_counter() - t0) * 1e3
    if out["failure"] is None:
        emit(f"no tracking failure in {n_frames} frames")
    return out


def main(argv=None, device="cuda"):
    """Run the replay; returns its record (the JSON line)."""
    from mast3r_slam_tpu_torch.bench.frame_profile import smi
    from mast3r_slam_tpu_torch.main import _check_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("frames", type=int, nargs="?", default=N_FRAMES)
    ap.add_argument("--hw", type=int, nargs=2, default=HW)
    ap.add_argument("--nan-frame", type=int, default=None)
    ap.add_argument("--device", default=device)
    args = ap.parse_args(argv)
    dev = _check_device(args.device)
    rec = run(args.frames, tuple(args.hw), dev, args.nan_frame,
              emit=lambda *a: print(*a, flush=True))
    rec.update(frames=args.frames, hw=list(args.hw),
               nan_frame=args.nan_frame,
               device=smi() if dev.type == "cuda" else "cpu")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
