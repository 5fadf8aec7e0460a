"""SLAM pipeline orchestration: frame staging, relocalization and the
backend loop (counterpart of ``mast3r_slam_tpu/slam/pipeline.py``).

The backend runs as a host thread (default) or inline via
:meth:`Backend.step` in ``single_thread`` mode. The thread's current CUDA
device is the backend's (the factor graph's device: the first backend slot
of a disjoint topology, else the frontend's); each service thread makes its
own role's device current. On one card every role shares the card and its
default stream, serialized, as every role shares the one chip in the JAX
package. Every read or write of keyframe tensors goes under
``keyframes.lock``.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from mast3r_slam_tpu_torch.data.image_ops import resize_img, resize_plan
from mast3r_slam_tpu_torch.ops import lie
from mast3r_slam_tpu_torch.parallel import sharding as S
from mast3r_slam_tpu_torch.slam.frame import Frame, KeyframeBuffer, Mode, States
from mast3r_slam_tpu_torch.utils.tictoc import STEPS


class _Staging:
    """A pinned host buffer a frame's model image is written into and
    uploaded from (``non_blocking``), and the event of that upload."""

    def __init__(self, shape):
        self.host = torch.empty(shape, dtype=torch.float32, pin_memory=True)
        self.event = None


_STAGING: dict = {}     # (shape, device) -> [_Staging, ...], least recent first
_STAGING_LOCK = threading.Lock()
_STAGING_DEPTH = 2      # buffers a shape; past that, wait for the oldest


def _upload_model_image(img_np, img_size, device):
    """``resize_img``'s pass writing the model image straight into a
    pinned staging buffer, then one ``non_blocking`` copy to ``device`` on
    its current stream. A buffer is written again only once the event of
    its last copy has completed. Returns the result dict and the device
    image."""
    _, (y0, y1, x0, x1), _ = resize_plan(*img_np.shape[:2], img_size)
    shape = (y1 - y0, x1 - x0, img_np.shape[2])
    with _STAGING_LOCK:
        ring = _STAGING.setdefault((shape, device), [])
        slot = next((b for b in ring
                     if b.event is None or b.event.query()), None)
        if slot is None and len(ring) < _STAGING_DEPTH:
            slot = _Staging(shape)
        elif slot is None:
            slot = ring[0]
            slot.event.synchronize()
        if slot in ring:
            ring.remove(slot)
        ring.append(slot)
        res = resize_img(img_np, img_size, model_out=slot.host.numpy())
        STEPS.lap("create_frame: resize")
        with torch.cuda.device(device):
            img = torch.empty(shape, dtype=torch.float32, device=device)
            img.copy_(slot.host, non_blocking=True)
            slot.event = torch.cuda.Event()
            slot.event.record()
    return res, img


def create_frame(frame_id: int, img_np: np.ndarray, T_WC=None,
                 img_size: int = 512, *, downsample: int = 1,
                 device="cuda") -> Frame:
    """Host image ``(H, W, 3) float32 [0, 1]`` → model-crop Frame on
    ``device``, resized and cropped by ``data/image_ops.py::resize_img``.

    On a card the model image is written by the resize's own pass into a
    pinned staging buffer and uploaded from there without a host wait (the
    buffer is reused once that copy's event has completed); on the CPU it
    is the resize's array itself.

    ``downsample`` (``dataset.img_downsample``) decimates the display image
    ``uimg`` and ``img_shape``; the working pointmaps are decimated by the
    same stride at the inference layer, and ``img_true_shape`` stays the
    model crop."""
    STEPS.mark()
    device = torch.device(device)
    if device.type == "cuda":
        res, img = _upload_model_image(img_np, img_size, device)
    else:
        res = resize_img(img_np, img_size)
        STEPS.lap("create_frame: resize")
        img = torch.as_tensor(res["img"][0], device=device)
    h, w = (int(v) for v in res["true_shape"][0])
    STEPS.lap("create_frame: upload")
    # astype(float32) / 255.0 in one pass: the same bits, one array
    uimg = np.divide(res["unnormalized_img"], np.float32(255.0),
                     dtype=np.float32)
    img_shape = (h, w)
    if downsample > 1:
        uimg = uimg[::downsample, ::downsample]
        img_shape = (h // downsample, w // downsample)
    STEPS.lap("create_frame: display")
    if T_WC is None:
        T_WC = lie.identity(device=device)
    frame = Frame(frame_id=frame_id, img=img, img_shape=img_shape,
                  img_true_shape=(h, w), uimg=uimg,
                  T_WC=torch.as_tensor(T_WC, dtype=torch.float32,
                                       device=device))
    STEPS.lap("create_frame: pose")
    return frame


def _retrieval_args(cfg):
    r = cfg.get("retrieval", {})
    return int(r.get("k", 3)), float(r.get("min_thresh", 5e-3))


def relocalization(frame: Frame, keyframes: KeyframeBuffer, factor_graph,
                   retrieval_database, cfg) -> bool:
    """Query retrieval → tentative keyframe append → strict factor check →
    adopt the best candidate's pose and solve globally, else roll back."""
    rcfg = cfg.get("reloc", {})
    k, min_thresh = _retrieval_args(cfg)
    with keyframes.lock:
        candidates = retrieval_database.update(
            frame, add_after_query=False, k=k, min_thresh=min_thresh)
        if not candidates:
            return False
        keyframes.append(frame)
        n_kf = len(keyframes)
        kf_idx = [c for c in candidates if c != n_kf - 1]
        frame_idx = [n_kf - 1] * len(kf_idx)
        if not kf_idx:
            keyframes.pop_last()
            return False
        # the NEW keyframe goes first (as ii), so the consecutive-edge
        # exemption (ii == jj - 1) can never let a candidate at n_kf - 2
        # bypass the strict check
        added = factor_graph.add_factors(
            frame_idx, kf_idx,
            float(rcfg.get("min_match_frac", 0.3)),
            is_reloc=bool(rcfg.get("strict", True)),
            allow_geo_init=False,   # candidate poses are what is in question
        )
        if not added:
            keyframes.pop_last()
            print("Relocalization failed")
            return False
        # the signature is cached from the query above
        retrieval_database.update(frame, add_after_query=True, k=k,
                                  min_thresh=min_thresh, kf_idx=n_kf - 1,
                                  skip_query=True)
        print(f"Relocalized against keyframe(s) {kf_idx}")
        best_T = keyframes.T_WC[kf_idx[0]].clone()
        frame.T_WC = best_T
        keyframes.T_WC[n_kf - 1] = best_T
    if cfg.get("use_calib", False):
        factor_graph.solve_GN_calib()
    else:
        factor_graph.solve_GN_rays()
    return True


class Backend:
    """Keyframe-graph backend: retrieval, factor growth, global BA. Runs as
    a thread (:meth:`start`) or inline through :meth:`step`; after each
    solve it hands the graph to ``tsdf_manager`` (the global TSDF), when
    there is one."""

    def __init__(self, model, keyframes: KeyframeBuffer, states: States,
                 factor_graph, retrieval_database, cfg, tsdf_manager=None):
        self.model = model
        self.keyframes = keyframes
        self.states = states
        self.graph = factor_graph
        self.retrieval = retrieval_database
        self.cfg = cfg
        self.tsdf_manager = tsdf_manager
        self.stop_flag = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="slam-backend")
        self._started = False
        self.error: BaseException | None = None

    def start(self):
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    def stop(self, timeout=30.0):
        self.stop_flag.set()
        if self._started:
            self._thread.join(timeout=timeout)

    def idle(self) -> bool:
        with self.states.lock:
            return (not self.states.global_optimizer_tasks
                    and self.states.reloc_sem == 0)

    def _loop(self):
        try:
            S.bind_thread(self.graph.device)
            while not self.stop_flag.is_set():
                if not self.step():
                    time.sleep(0.005)
        except BaseException as e:    # surfaced by the CLI at shutdown
            self.error = e
            raise

    def step(self) -> bool:
        """One backend action; returns True if any work was done."""
        mode = self.states.get_mode()
        if mode == Mode.INIT:
            return False
        if mode == Mode.RELOC:
            frame = self.states.get_frame()
            if frame is None or self.states.reloc_sem == 0:
                return False
            ok = relocalization(frame, self.keyframes, self.graph,
                                self.retrieval, self.cfg)
            if ok:
                # clear BEFORE the mode flip: once TRACKING is visible the
                # frontend may queue a new episode's first request
                self.states.clear_reloc()
                self.states.set_mode(Mode.TRACKING)
            else:
                self.states.dequeue_reloc()
            return True

        idx = self.states.pop_global_optimization()
        if idx is None:
            return False
        k, min_thresh = _retrieval_args(self.cfg)
        frame = self.keyframes[idx]
        retr = self.retrieval.update(frame, add_after_query=True, k=k,
                                     min_thresh=min_thresh, kf_idx=idx)
        kf_idx = set(int(r) for r in retr)
        if idx - 1 >= 0:
            kf_idx.add(idx - 1)              # consecutive edge
        kf_idx.discard(idx)
        kf_idx = sorted(kf_idx)
        if kf_idx:
            if retr:
                print(f"Database retrieval {idx}: {kf_idx}")
            self.graph.add_factors(
                kf_idx, [idx] * len(kf_idx),
                float(self.cfg.get("local_opt", {}).get("min_match_frac",
                                                        0.1)),
                # only the hint of THIS keyframe's consecutive edge: a
                # lagging backend must not burn keyframe N+1's hint
                init_hint=self.states.take_kf_match_hint(idx - 1, idx),
            )
        self.states.set_edges(list(self.graph.ii), list(self.graph.jj))
        if self.cfg.get("use_calib", False):
            self.graph.solve_GN_calib()
        else:
            self.graph.solve_GN_rays()
        if self.tsdf_manager is not None:
            self.tsdf_manager.on_after_backend_solve(self.graph)
        return True
