"""Asynchronous pointmap-quality service: a worker thread and bounded
queues (counterpart of ``mast3r_slam_tpu/services/quality_async.py``).

Drop-on-full job and result queues of 64, deadline-based micro-batching,
per-keyframe EWMA coverage state, results cached by keyframe and by frame,
a callback registry, sliding-window median/MAD statistics and sentinel
shutdown. The worker computes on ``device`` (the card unless the caller
asks for the CPU) with :mod:`quality_core`; a job's arrays may be numpy
arrays or tensors, and the published results are numpy arrays.
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from collections import deque

import numpy as np
import torch

from mast3r_slam_tpu_torch.parallel import sharding as S
from mast3r_slam_tpu_torch.services import quality_core

_QUIT = "__quit__"


class AsynchronousQualityService:
    def __init__(self, cfg: dict, device="cuda"):
        self.device = torch.device(device)
        q = cfg.get("quality", {})
        self.ps = int(q.get("patch_size", 16))
        self.batch_size = int(q.get("batch_size", 4))
        self.max_wait_ms = float(q.get("max_wait_ms", 10))
        metrics = q.get("metrics", {}).get("coverage", {})
        self.alpha = float(metrics.get("alpha_ema", 0.8))
        self.b0 = float(metrics.get("b0", 0.15))
        self.theta0 = float(np.deg2rad(metrics.get("theta0_deg", 10.0)))
        thr = q.get("thresholds", {})
        self.thr_zr = float(thr.get("z_r", 1.0))
        self.thr_zu = float(thr.get("z_u", 1.0))
        self.thr_dc = float(thr.get("d_cov", 0.02))
        # C_thr is used verbatim: with the default C_conf=0.0 the core's
        # C/(C_thr+1e-8) normalization saturates Cn to 1
        self.C_thr = float(cfg.get("tracking", {}).get("C_conf", 0.0))
        self.Q_thr = float(cfg.get("tracking", {}).get("Q_conf", 1.5))

        self.job_q: queue.Queue = queue.Queue(maxsize=64)
        self.res_q: queue.Queue = queue.Queue(maxsize=64)
        self._results_by_kf: dict[int, dict] = {}
        self._results_by_frame: dict[int, dict] = {}
        self._ewma_state: dict[int, np.ndarray] = {}
        self._callbacks: list = []
        self._stats_window: deque = deque(maxlen=256)
        self._lock = threading.RLock()
        self.dropped_jobs = 0
        self.processed_jobs = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="quality-worker")
        self._started = False

    # -- public API --------------------------------------------------------

    def start(self):
        if not self._started:
            self._worker.start()
            self._started = True
        return self

    def is_alive(self):
        """Worker health gate: the TSDF scheduler defers on a pending
        quality result only while the worker can still deliver one."""
        return self._started and self._worker.is_alive()

    def submit(self, job: dict) -> bool:
        """Enqueue a quality job; drops (returns False) when the queue is full."""
        if not self._started:
            self.start()
        try:
            self.job_q.put_nowait(job)
            return True
        except queue.Full:
            self.dropped_jobs += 1
            return False

    def poll(self):
        """Drain completed results; returns the newly ready ones."""
        out = []
        while True:
            try:
                res = self.res_q.get_nowait()
            except queue.Empty:
                break
            out.append(res)
        return out

    def get(self, kf_id: int):
        self.poll()
        with self._lock:
            return self._results_by_kf.get(kf_id)

    def get_by_kf_id(self, kf_id: int):
        return self.get(kf_id)

    def get_by_frame_id(self, frame_id: int):
        self.poll()
        with self._lock:
            return self._results_by_frame.get(frame_id)

    def register_callback(self, fn):
        with self._lock:
            self._callbacks.append(fn)

    def global_stats(self):
        """Sliding-window median/MAD of patch residual medians."""
        with self._lock:
            if not self._stats_window:
                return {"median": 0.0, "mad": 0.0, "n": 0}
            vals = np.asarray(self._stats_window)
        med = float(np.median(vals))
        mad = float(np.median(np.abs(vals - med)))
        return {"median": med, "mad": mad, "n": len(vals)}

    def shutdown(self):
        if self._started:
            self.job_q.put(_QUIT)
            self._worker.join(timeout=10.0)
            self._started = False

    # -- worker ------------------------------------------------------------

    def _collect_batch(self):
        """Block for one job, then batch up to batch_size within max_wait_ms."""
        try:
            first = self.job_q.get(timeout=0.25)
        except queue.Empty:
            return []
        if first is _QUIT:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1000.0
        while len(batch) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self.job_q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is _QUIT:
                self.job_q.put(_QUIT)  # re-post for the outer loop
                break
            batch.append(nxt)
        return batch

    def _run(self):
        S.bind_thread(self.device)
        while True:
            batch = self._collect_batch()
            if batch is None:
                break
            # one batched computation per same-shape run of jobs; per-job
            # retry on any batch failure: the service must never die
            # silently
            i = 0
            while i < len(batch):
                j = i + 1
                hw = (int(batch[i]["H"]), int(batch[i]["W"]))
                while (j < len(batch)
                       and (int(batch[j]["H"]), int(batch[j]["W"])) == hw):
                    j += 1
                group = batch[i:j]
                i = j
                try:
                    if len(group) == 1:
                        self._process(group[0])
                    else:
                        self._process_group(group)
                except Exception as e:
                    print(f"[quality] batch of {len(group)} failed: {e}")
                    traceback.print_exc()
                    for job in group:
                        try:
                            self._process(job)
                        except Exception as e2:
                            print(f"[quality] job failed: {e2}")
                            traceback.print_exc()

    def _dev(self, x, dtype=torch.float32):
        """A job's array on the service's device: the tracker's tensors live
        on the frontend device, and this is their copy."""
        return torch.as_tensor(x).to(self.device, dtype)

    def _args(self, H, W):
        return (H, W, self.ps, self.alpha, self.b0, self.theta0, self.C_thr,
                self.Q_thr, self.thr_zr, self.thr_zu, self.thr_dc)

    def _process_group(self, jobs):
        """All jobs of one same-shape group in one batched computation
        (:func:`quality_core.compute_quality_batch`), equal to the
        sequential per-job path; the EWMA chain across same-keyframe jobs
        runs inside it."""
        H, W = int(jobs[0]["H"]), int(jobs[0]["W"])
        gh, gw = H // self.ps, W // self.ps
        B = len(jobs)

        # The chain only carries state between ADJACENT same-keyframe
        # jobs; a stable sort by kf_id makes every same-kf run adjacent (in
        # arrival order within the run, so the chain follows frame order and
        # the last published result per kf is the newest — the sequential
        # path's semantics even for interleaved batches like [A, B, A]
        # after a relocalization).
        jobs = sorted(jobs, key=lambda j: int(j["kf_id"]))

        chain = np.zeros(B, bool)
        prev = np.zeros((B, gh, gw), np.float32)
        with self._lock:
            for k, job in enumerate(jobs):
                kf_id = int(job["kf_id"])
                if k > 0 and kf_id == int(jobs[k - 1]["kf_id"]):
                    chain[k] = True  # the chain carries job k-1's cov_ewma
                else:
                    p = self._ewma_state.get(kf_id)
                    if p is not None:
                        prev[k] = p

        def stack(key, dtype=torch.float32):
            return torch.stack([self._dev(j[key], dtype).reshape(-1)
                                for j in jobs])

        def scalars(key):
            return torch.stack([self._dev(j[key]).reshape(()) for j in jobs])

        res = quality_core.compute_quality_batch(
            stack("valid_kf", torch.bool), stack("r_pix"), stack("Ck"),
            stack("Qk"), scalars("t_norm"), scalars("theta"),
            self._dev(prev), chain, *self._args(H, W))
        res_np = {k: v.cpu().numpy() for k, v in res.items()}
        for k, job in enumerate(jobs):
            self._publish(job, {key: v[k] for key, v in res_np.items()})

    def _process(self, job):
        H, W = int(job["H"]), int(job["W"])
        gh, gw = H // self.ps, W // self.ps
        kf_id = int(job["kf_id"])
        prev = self._ewma_state.get(kf_id)
        if prev is None:
            prev = np.zeros((gh, gw), np.float32)
        res = quality_core.compute_quality(
            self._dev(job["valid_kf"], torch.bool).reshape(-1),
            self._dev(job["r_pix"]).reshape(-1),
            self._dev(job["Ck"]).reshape(-1),
            self._dev(job["Qk"]).reshape(-1),
            self._dev(job["t_norm"]).reshape(()),
            self._dev(job["theta"]).reshape(()),
            self._dev(prev), *self._args(H, W))
        self._publish(job, {k: v.cpu().numpy() for k, v in res.items()})

    def _publish(self, job, res_np):
        """Store one job's numpy results + EWMA state and notify consumers."""
        kf_id = int(job["kf_id"])
        packed = {
            "kf_id": kf_id,
            "frame_id": int(job.get("frame_id", -1)),
            "delta_cov": res_np["delta_cov"],
            "r": res_np["r"],
            "u": res_np["u"],
            "class_id": res_np["class_id"],
            "priority": res_np["priority"],
            "cov_ewma": res_np["cov_ewma"],
        }
        with self._lock:
            self._ewma_state[kf_id] = packed["cov_ewma"]
            self._results_by_kf[kf_id] = packed
            self._results_by_frame[packed["frame_id"]] = packed
            self._stats_window.append(float(np.median(packed["r"])))
            callbacks = list(self._callbacks)
        self.processed_jobs += 1
        try:
            self.res_q.put_nowait(packed)
        except queue.Full:
            pass  # the result stays reachable through the caches
        for fn in callbacks:
            try:
                fn(packed)
            except Exception as e:
                print(f"[quality] callback failed: {e}")
