"""Global sparse TSDF volume: integration and pose-refinement threads
(counterpart of ``mast3r_slam_tpu/services/tsdf_global.py``).

- ``TSDFVolume``: the world-space sparse voxel store (the native hash of
  :mod:`native_tsdf`), lock-guarded.
- ``TSDFPoseOptimizer``: per-keyframe Sim(3) refinement minimizing TSDF
  values at sampled confident points; Jacobian ``[∇φ; p×∇φ; p·∇φ]`` in the
  7-dim Sim3 tangent, damped normal equations with Levenberg-Marquardt
  accept/reject, LEFT-multiplicative update ``Sim3.exp(δ) ∘ pose``.
- ``TSDFGlobalIntegrator``: a thread integrating new keyframes in order and
  re-integrating pose-updated keyframes from a deduplicated queue.
- ``TSDFGlobalOptThread``: the asynchronous pose-refinement worker.
- ``TSDFGlobalManager``: the wiring and the backend's
  ``on_after_backend_solve`` hook.

The volume lives on the host; keyframe reads copy to the host under the
buffer's lock (the buffers are written in place), and the pose math runs
on CPU tensors.
"""

from __future__ import annotations

import threading
import time
import traceback
from collections import deque

import numpy as np
import torch

from mast3r_slam_tpu_torch.ops import lie
from mast3r_slam_tpu_torch.services.native_tsdf import make_voxel_hash


def _act(T, X):
    """Sim(3) ``T (8,)`` applied to host points ``X (N, 3)`` (float32)."""
    return lie.act(torch.as_tensor(T)[None], torch.as_tensor(X)).numpy()


class TSDFVolume:
    """Lock-guarded world-space sparse TSDF."""

    def __init__(self, cfg):
        c = cfg.get("tsdf_global", {})
        self.voxel_size = float(c.get("voxel_size", 0.03))
        self.trunc = float(c.get("trunc_dist", 0.12))
        self.min_weight = float(c.get("min_tsdf_weight", 1e-3))
        self.hash = make_voxel_hash(
            capacity=int(c.get("table_capacity", 1 << 20)),
            voxel_size=self.voxel_size,
            trunc=self.trunc,
            max_weight=float(c.get("max_weight", 100.0)),
        )
        self.lock = threading.RLock()

    def integrate(self, points_w, conf, origin_w, min_conf=0.0) -> int:
        with self.lock:
            return self.hash.integrate(points_w, conf, origin_w, min_conf)

    def query(self, points_w):
        with self.lock:
            return self.hash.query(points_w, self.min_weight)

    def stats(self):
        with self.lock:
            return self.hash.stats()


def _snapshot(kf, idx):
    """Host copies of keyframe ``idx``'s pointmap, confidence, fusion count,
    pose and version, read under the buffer's lock."""
    with kf.lock:
        X = kf.X[idx].cpu().numpy()
        C = kf.C[idx][:, 0].cpu().numpy()
        n = max(int(kf.N[idx]), 1)
        T = kf.T_WC[idx].cpu().numpy()
        version = int(kf.version[idx])
    return X, C, n, T, version


class TSDFPoseOptimizer:
    """Sim(3) pose refinement against the global TSDF."""

    def __init__(self, volume: TSDFVolume, keyframes, cfg):
        c = cfg.get("tsdf_global", {})
        self.volume = volume
        self.keyframes = keyframes
        self.samples = int(c.get("samples_per_kf", 2000))
        self.lam = float(c.get("lambda", 0.15))
        self.max_iters = int(c.get("max_iterations", 3))
        self.damping = float(c.get("damping", 1e-4))
        self.min_conf = float(c.get("min_confidence", 0.05))
        self.refined = 0

    def _sample_points(self, kf_idx):
        X, C, n, T, version = _snapshot(self.keyframes, kf_idx)
        conf = C / n
        good = np.where(conf > self.min_conf)[0]
        if good.size == 0:
            return None, None, None, version
        if good.size > self.samples:
            good = np.random.default_rng(kf_idx).choice(
                good, self.samples, replace=False
            )
        return X[good], conf[good], T, version

    def optimize_single(self, kf_idx) -> bool:
        """LM on ``min Σ w φ(T∘p)²``; the pose is written back under the
        lock IFF the keyframe's version is unchanged (a concurrent backend
        BA write wins over a refinement computed from the stale pose)."""
        X_cam, w, T0, version = self._sample_points(kf_idx)
        if X_cam is None:
            return False
        T = T0.copy()

        def system(T_cur):
            """Weighted TSDF normal equations + cost at ``T_cur``."""
            Xw = _act(T_cur, X_cam)
            phi, grad, valid = self.volume.query(Xw)
            if valid.sum() < 32:
                return None
            p = Xw[valid]
            g = grad[valid]
            r = phi[valid]
            ww = w[valid] * self.lam
            # d(exp(eps) p)/d eps = [I | -skew(p) | p], so the Jacobian row
            # of φ is [g, p × g, g·p]
            J = np.concatenate(
                [g, np.cross(p, g), np.sum(g * p, axis=1, keepdims=True)],
                axis=1,
            )  # (M, 7)
            H = (J * ww[:, None]).T @ J
            b = (J * ww[:, None]).T @ r
            # mean (not sum) so accept/reject is insensitive to the number
            # of in-band samples changing between candidate poses
            cost = float(np.mean(ww * r * r))
            return H, b, cost

        # Levenberg-Marquardt accept/reject: a plain full-step GN overshoots
        # on curved geometry (the TSDF gradient is a noisy finite difference
        # and the band is thin)
        sysT = system(T)
        if sysT is None:
            return False
        H, b, cost = sysT
        lam = self.damping
        for _ in range(self.max_iters):
            Hd = H + lam * np.diag(np.maximum(np.diagonal(H), 1e-12))
            try:
                delta = np.linalg.solve(Hd, -b)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            step = lie.exp(torch.as_tensor(delta, dtype=torch.float32))
            T_cand = lie.compose(step, torch.as_tensor(T)).numpy()
            sysC = system(T_cand)
            if sysC is not None and sysC[2] <= cost * (1.0 + 1e-6):
                T = T_cand
                H, b, cost = sysC
                lam = max(self.damping, lam * 0.25)
                if np.linalg.norm(delta) < 1e-6:
                    break
            else:
                lam *= 10.0
                if lam > 1e8:
                    break
        kf = self.keyframes
        with kf.lock:
            if int(kf.version[kf_idx]) != version:
                return False  # pose moved under us (backend BA); discard
            kf.update_T_WCs(T[None], [kf_idx])
        self.refined += 1
        return True


class TSDFGlobalIntegrator(threading.Thread):
    def __init__(self, volume: TSDFVolume, keyframes, cfg):
        super().__init__(daemon=True, name="tsdf-global-integrate")
        c = cfg.get("tsdf_global", {})
        self.volume = volume
        self.keyframes = keyframes
        self.max_points = int(c.get("max_points_per_kf", 40000))
        self.min_conf = float(c.get("min_confidence", 0.05))
        self.poll_s = float(c.get("queue_check_interval", 0.1))
        self.log_interval = float(c.get("log_interval", 30))
        self.reint_cap = int(c.get("reintegration_queue", 256))
        self.reintegration_queue: deque = deque()
        self._pending: set = set()
        self._lock = threading.Lock()
        self.stop_flag = threading.Event()
        self.integrated_until = 0
        self._last_log = time.monotonic()

    def mark_pose_update(self, kf_indices):
        with self._lock:
            for i in kf_indices:
                i = int(i)
                if i not in self._pending and len(
                    self.reintegration_queue
                ) < self.reint_cap:
                    self._pending.add(i)
                    self.reintegration_queue.append(i)

    def _integrate_kf(self, idx):
        if idx >= len(self.keyframes):
            return
        X, C, n, T, _ = _snapshot(self.keyframes, idx)
        conf = C / n
        good = np.where(conf > self.min_conf)[0]
        if good.size > self.max_points:
            good = good[:: good.size // self.max_points + 1]
        self.volume.integrate(_act(T, X[good]), conf[good], T[:3],
                              self.min_conf)

    def run(self):
        while not self.stop_flag.is_set():
            did = False
            if self.integrated_until < len(self.keyframes):
                self._integrate_kf(self.integrated_until)
                self.integrated_until += 1
                did = True
            else:
                with self._lock:
                    idx = (self.reintegration_queue.popleft()
                           if self.reintegration_queue else None)
                    if idx is not None:
                        self._pending.discard(idx)
                if idx is not None:
                    self._integrate_kf(idx)
                    did = True
            now = time.monotonic()
            if now - self._last_log > self.log_interval:
                print(f"[tsdf-global] {self.volume.stats()}")
                self._last_log = now
            if not did:
                time.sleep(self.poll_s)


class TSDFGlobalOptThread(threading.Thread):
    def __init__(self, optimizer: TSDFPoseOptimizer, cfg):
        super().__init__(daemon=True, name="tsdf-global-opt")
        self.optimizer = optimizer
        self.queue: deque = deque()
        self._pending: set = set()
        self._lock = threading.Lock()
        self.stop_flag = threading.Event()
        self.cooldown_s = 0.05

    def enqueue(self, kf_indices):
        with self._lock:
            for i in kf_indices:
                i = int(i)
                if i not in self._pending:
                    self._pending.add(i)
                    self.queue.append(i)

    def run(self):
        while not self.stop_flag.is_set():
            with self._lock:
                idx = self.queue.popleft() if self.queue else None
                if idx is not None:
                    self._pending.discard(idx)
            if idx is None:
                time.sleep(0.1)
                continue
            try:
                self.optimizer.optimize_single(idx)
            except Exception as e:
                print(f"[tsdf-global-opt] kf {idx} failed: {e}")
                traceback.print_exc()
            time.sleep(self.cooldown_s)


class TSDFGlobalManager:
    """Wires volume + integrator + optimizer; the backend calls
    ``on_after_backend_solve`` after each solve. The volume, its threads
    and the pose math live on the host, whatever device the keyframes
    are on. Disabled, it builds none of them (the native hash included)."""

    def __init__(self, keyframes, cfg):
        self.enabled = bool(cfg.get("tsdf_global", {}).get("enabled", False))
        self.keyframes = keyframes
        self.cfg = cfg
        self.volume = self.integrator = self.optimizer = None
        self.opt_thread = None
        if self.enabled:
            self.volume = TSDFVolume(cfg)
            self.integrator = TSDFGlobalIntegrator(self.volume, keyframes,
                                                   cfg)
            self.optimizer = TSDFPoseOptimizer(self.volume, keyframes, cfg)
            self.opt_thread = TSDFGlobalOptThread(self.optimizer, cfg)
        self.pin = int(cfg.get("local_opt", {}).get("pin", 1))
        self._started = False

    def start(self):
        if self.enabled and not self._started:
            self.integrator.start()
            self.opt_thread.start()
            self._started = True
        return self

    def on_after_backend_solve(self, factor_graph):
        """Mark pose-updated keyframes for re-integration + refinement."""
        if not self._started:
            return
        unique = factor_graph.last_unique_kf_idx
        if unique is None:
            return
        moved = [int(i) for i in unique[self.pin:]]
        self.integrator.mark_pose_update(moved)
        self.opt_thread.enqueue(moved)

    def shutdown(self, timeout=10.0):
        if self._started:
            self.integrator.stop_flag.set()
            self.opt_thread.stop_flag.set()
            self.integrator.join(timeout=timeout)
            self.opt_thread.join(timeout=timeout)
            self._started = False
            print(f"[tsdf-global] final stats: {self.volume.stats()}")
