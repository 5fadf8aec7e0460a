"""Frames, the keyframe buffer and the controller state, on torch tensors.

Counterpart of ``mast3r_slam_tpu/slam/frame.py``: one controller process;
keyframe state lives in fixed-capacity device tensors, and service threads
coordinate through an ``RLock`` plus per-keyframe version counters. The
buffer writes its tensors in place (index assignment) where the JAX package
rebuilt immutable arrays.
"""

from __future__ import annotations

import dataclasses
import threading
from enum import IntEnum
from typing import Optional

import numpy as np
import torch

from mast3r_slam_tpu_torch.ops import lie


class Mode(IntEnum):
    INIT = 0
    TRACKING = 1
    RELOC = 2
    TERMINATED = 3


def median(x):
    """Median as the mean of the two middle values (``jnp.median``'s
    convention; ``torch.median`` returns the lower one)."""
    s = x.reshape(-1).sort().values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def get_score(C, filtering_score: str):
    return median(C) if filtering_score == "median" else C.mean()


def fuse_weighted_spherical(X0, C0, X, C):
    """Confidence-weighted average of two pointmaps in spherical coords."""
    def to_sph(P):
        r = torch.linalg.norm(P, dim=-1, keepdim=True)
        x, y, z = P.split(1, dim=-1)
        phi = torch.atan2(y, x)
        theta = torch.acos((z / r.clamp_min(1e-12)).clamp(-1.0, 1.0))
        return torch.cat([r, phi, theta], dim=-1)

    def to_cart(s):
        r, phi, theta = s.split(1, dim=-1)
        return torch.cat([r * torch.sin(theta) * torch.cos(phi),
                          r * torch.sin(theta) * torch.sin(phi),
                          r * torch.cos(theta)], dim=-1)

    sph = (C0 * to_sph(X0) + C * to_sph(X)) / (C0 + C)
    return to_cart(sph), C0 + C


@dataclasses.dataclass
class Frame:
    """Per-frame state. ``X_canon``/``C`` are flattened (H*W, 3)/(H*W, 1)."""

    frame_id: int
    img: torch.Tensor                # (H, W, 3) normalized to [-1, 1]
    img_shape: tuple                 # (H, W) working resolution
    img_true_shape: tuple            # (H, W) fed to the model
    uimg: Optional[np.ndarray] = None
    T_WC: Optional[torch.Tensor] = None   # (8,) Sim3
    X_canon: Optional[torch.Tensor] = None
    C: Optional[torch.Tensor] = None
    feat: Optional[torch.Tensor] = None
    pos: Optional[torch.Tensor] = None
    N: int = 0
    N_updates: int = 0
    K: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.T_WC is None:
            device = self.img.device if self.img is not None else None
            self.T_WC = lie.identity(device=device)

    def get_average_conf(self):
        return self.C / self.N if self.C is not None else None

    def get_score(self, C, filtering_score: str):
        return get_score(C, filtering_score)

    def update_pointmap(self, X, C, filtering_mode="weighted_pointmap",
                        filtering_score="median"):
        if self.N == 0:
            self.X_canon, self.C = X, C
            self.N = 1
            self.N_updates = 1
            if filtering_mode == "best_score":
                self.score = get_score(C, filtering_score)
            return
        if filtering_mode == "first":
            if self.N_updates == 1:
                self.X_canon, self.C, self.N = X, C, 1
        elif filtering_mode == "recent":
            self.X_canon, self.C, self.N = X, C, 1
        elif filtering_mode == "best_score":
            new_score = get_score(C, filtering_score)
            if bool(new_score > self.score):
                self.X_canon, self.C, self.N = X, C, 1
                self.score = new_score
        elif filtering_mode == "indep_conf":
            better = C > self.C
            self.X_canon = torch.where(better, X, self.X_canon)
            self.C = torch.where(better, C, self.C)
            self.N = 1
        elif filtering_mode == "weighted_pointmap":
            self.X_canon = (self.C * self.X_canon + C * X) / (self.C + C)
            self.C = self.C + C
            self.N += 1
        elif filtering_mode == "weighted_spherical":
            self.X_canon, self.C = fuse_weighted_spherical(
                self.X_canon, self.C, X, C)
            self.N += 1
        else:
            raise ValueError(f"unknown filtering_mode {filtering_mode}")
        self.N_updates += 1


class KeyframeBuffer:
    """Fixed-capacity keyframe store backed by device tensors, with the
    ``frame_id_to_index`` map and per-keyframe ``version`` counters. All
    mutation happens under ``lock``."""

    def __init__(self, h, w, capacity=110, feat_dim=1024, patch_size=16,
                 device="cuda", model_hw=None):
        self.lock = threading.RLock()
        # (h, w): working per-pixel resolution; model_hw: the model crop
        self.h, self.w = h, w
        self.model_hw = tuple(model_hw) if model_hw is not None else (h, w)
        self.capacity = capacity
        self.feat_dim = feat_dim
        self.device = torch.device(device)
        self.num_patches = ((self.model_hw[0] // patch_size)
                            * (self.model_hw[1] // patch_size))
        n = h * w
        self.n_size = 0
        self.frame_id_to_index: dict[int, int] = {}
        dev = self.device
        self.dataset_idx = np.zeros(capacity, dtype=np.int64)
        self.T_WC = lie.identity((capacity,), device=dev)
        self.X = torch.zeros(capacity, n, 3, device=dev)
        self.C = torch.zeros(capacity, n, 1, device=dev)
        self.N = np.zeros(capacity, dtype=np.int32)
        self.N_updates = np.zeros(capacity, dtype=np.int32)
        self.feat = torch.zeros(capacity, self.num_patches, feat_dim,
                                device=dev)
        self.pos = torch.zeros(capacity, self.num_patches, 2,
                               dtype=torch.int32, device=dev)
        self.is_dirty = np.zeros(capacity, dtype=bool)
        self.version = np.zeros(capacity, dtype=np.int64)
        # counts pointmap-content changes only (X/C/N writes)
        self.xc_version = np.zeros(capacity, dtype=np.int64)
        self.K: Optional[torch.Tensor] = None
        self.uimg = [None] * capacity
        self.img = [None] * capacity
        self.img_shapes = [None] * capacity

    def __len__(self):
        with self.lock:
            return self.n_size

    def set_intrinsics(self, K):
        self.K = torch.as_tensor(K, dtype=torch.float32, device=self.device)

    def get_intrinsics(self):
        return self.K

    def __setitem__(self, idx, frame: Frame):
        with self.lock:
            self.n_size = max(idx + 1, self.n_size)
            self.frame_id_to_index[frame.frame_id] = idx
            self.dataset_idx[idx] = frame.frame_id
            self.T_WC[idx] = frame.T_WC.reshape(8)
            self.X[idx] = frame.X_canon
            self.C[idx] = frame.C
            self.N[idx] = frame.N
            self.N_updates[idx] = frame.N_updates
            self.feat[idx] = frame.feat[0]
            self.pos[idx] = frame.pos[0]
            self.is_dirty[idx] = True
            self.xc_version[idx] += 1
            self.uimg[idx] = frame.uimg
            self.img[idx] = frame.img
            self.img_shapes[idx] = (frame.img_shape, frame.img_true_shape)

    def __getitem__(self, idx) -> Frame:
        with self.lock:
            shp, true_shp = self.img_shapes[idx]
            kf = Frame(frame_id=int(self.dataset_idx[idx]),
                       img=self.img[idx], img_shape=shp,
                       img_true_shape=true_shp, uimg=self.uimg[idx],
                       T_WC=self.T_WC[idx].clone())
            kf.X_canon = self.X[idx].clone()
            kf.C = self.C[idx].clone()
            kf.feat = self.feat[idx][None].clone()
            kf.pos = self.pos[idx][None].clone()
            kf.N = int(self.N[idx])
            kf.N_updates = int(self.N_updates[idx])
            kf.K = self.K
            return kf

    def append(self, frame: Frame):
        with self.lock:
            self[self.n_size] = frame

    def pop_last(self):
        with self.lock:
            self.n_size -= 1

    def last_keyframe(self) -> Optional[Frame]:
        with self.lock:
            if self.n_size == 0:
                return None
            return self[self.n_size - 1]

    def last_index(self) -> int:
        with self.lock:
            return self.n_size - 1

    def update_T_WCs(self, T_WCs, idx) -> None:
        """Pose-only write: bumps ``version``, not ``xc_version``."""
        with self.lock:
            idx = np.atleast_1d(np.asarray(idx))
            self.T_WC[torch.as_tensor(idx, device=self.device)] = (
                torch.as_tensor(T_WCs, dtype=self.T_WC.dtype,
                                device=self.device).reshape(-1, 8))
            for i in idx:
                self.version[int(i)] += 1

    def update_pointmap_inplace(self, idx, X, C, expected_version=None) -> bool:
        """Optimistic-concurrency pointmap write (the TSDF refiner's).

        Returns False and writes nothing if the keyframe's version changed
        since ``expected_version`` was read; otherwise writes X and C, marks
        the keyframe dirty and bumps ``version`` and ``xc_version`` (the BA
        channel cache's key)."""
        with self.lock:
            if (expected_version is not None
                    and self.version[idx] != expected_version):
                return False
            self.X[idx] = X
            self.C[idx] = C
            self.is_dirty[idx] = True
            self.version[idx] += 1
            self.xc_version[idx] += 1
            return True

    def get_dirty_idx(self):
        """Indices whose pointmap changed since the last call (appends,
        fusion and refiner write-backs; a pose-only write does not count),
        with the flags cleared under the lock: the viewer's incremental
        upload."""
        with self.lock:
            idx = np.where(self.is_dirty)[0]
            self.is_dirty[:] = False
            return idx


class States:
    """Controller-wide mutable state: the mode machine, the reloc signal
    (``reloc_sem`` counts queued reloc requests), the backend queue, the
    keyframe match hint and ``paused`` (the viewer's pause, which the CLI
    loop waits on), guarded by one lock."""

    def __init__(self):
        self.lock = threading.RLock()
        self.mode = Mode.INIT
        self.paused = False
        self.reloc_sem = 0
        self.global_optimizer_tasks: list[int] = []
        self.edges_ii: list[int] = []
        self.edges_jj: list[int] = []
        self.current_frame: Optional[Frame] = None
        # (i, j, idx_j2i, valid_i, Q_i): the tracker's converged match at
        # keyframe creation, consumed once by the backend, which reuses it
        # as the consecutive edge's j→i direction
        self.kf_match_hint: Optional[tuple] = None

    def set_frame(self, frame: Frame):
        with self.lock:
            self.current_frame = frame

    def set_kf_match_hint(self, i: int, j: int, idx_j2i, valid_i,
                          Q_i) -> None:
        with self.lock:
            self.kf_match_hint = (i, j, idx_j2i, valid_i, Q_i)

    def take_kf_match_hint(self, i=None, j=None):
        """Pop the stored hint. With ``(i, j)`` given, pop it only if it is
        for that edge: a lagging backend must not consume keyframe N+1's
        hint while it still processes keyframe N."""
        with self.lock:
            hint = self.kf_match_hint
            if hint is None:
                return None
            if i is not None and (int(hint[0]) != int(i)
                                  or int(hint[1]) != int(j)):
                return None
            self.kf_match_hint = None
            return hint

    def pop_global_optimization(self) -> Optional[int]:
        with self.lock:
            if self.global_optimizer_tasks:
                return self.global_optimizer_tasks.pop(0)
            return None

    def set_edges(self, ii, jj):
        with self.lock:
            self.edges_ii = list(ii)
            self.edges_jj = list(jj)

    def get_frame(self) -> Optional[Frame]:
        with self.lock:
            return self.current_frame

    def queue_global_optimization(self, idx: int):
        with self.lock:
            self.global_optimizer_tasks.append(idx)

    def queue_reloc(self):
        with self.lock:
            self.reloc_sem += 1

    def clear_reloc(self):
        """Drop every queued reloc count: after a successful
        relocalization the rest are stale attempts of the same lost-tracking
        episode, and a leaked count would keep the backend busy forever and
        fire a spurious relocalization on the next tracking failure."""
        with self.lock:
            self.reloc_sem = 0

    def dequeue_reloc(self):
        with self.lock:
            if self.reloc_sem > 0:
                self.reloc_sem -= 1

    def get_mode(self) -> Mode:
        with self.lock:
            return self.mode

    def set_mode(self, mode: Mode):
        with self.lock:
            self.mode = mode
