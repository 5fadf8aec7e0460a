"""Local per-keyframe TSDF refinement service (counterpart of
``mast3r_slam_tpu/services/tsdf_local.py``).

A daemon worker refines low-quality regions of recent keyframes: it fuses
each keyframe's pointmap into small dense local TSDF grids, raycasts a
refined surface, and writes back conservatively (confidence boost, optional
geometric blend) under an optimistic version check. Scheduling is driven by
the quality service's priorities (fallback: a confidence heuristic), with a
block state machine (IDLE→QUEUED→RUNNING→COOLDOWN), retries with backoff,
and a drain/stall-aware shutdown.

The device functions are plain PyTorch on the refiner's device (the card
unless the caller asks for the CPU):

- :func:`build_blocks_tsdf_projective`: every voxel projects into the
  keyframe (median-focal pinhole fit, ``ops/geometry.estimate_focal``),
  reads the hit pixel's range and confidence, and takes the projective
  signed distance; a gather, no scatter. :func:`build_block_tsdf`, the
  sample-scatter build for unordered point sets, stays beside it.
- :func:`raycast_blocks`: per block pixel, R samples in a ±band around the
  original depth, trilinear TSDF interpolation from corner-packed rows,
  the first +→− zero crossing with both samples valid, and the hit and
  displacement guards.

JAX behaviour kept as it is: the sample clamp ``G - 1.000001`` rounds to
``G - 1`` in float32, so a sample on the far face takes cell ``G - 1`` and
its +1 corners wrap to the opposite face (with trilinear weight 0, which a
non-finite corner still turns into NaN). The JAX package's cell-walk
raycast (``cell_walk_k``) is a TPU gather trick that gives the dense
gather's result; the port takes the dense gather.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
import traceback
from enum import Enum

import numpy as np
import torch

from mast3r_slam_tpu_torch.ops import geometry, lie
from mast3r_slam_tpu_torch.parallel import sharding as S

_F32 = np.float32


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------

def _linspace(start, stop, num, device):
    """``jnp.linspace(start, stop, num)`` as the JAX package computes it in
    float32: ``start*(1 - i·r) + i·(stop·r)`` with ``r = 1/(num-1)``, the
    last product fused into the sum (one rounding), and ``stop`` exactly at
    the end. Computed on the host: ``num`` values."""
    f64 = np.float64
    i = np.arange(num - 1, dtype=_F32)
    r = _F32(1) / _F32(num - 1)
    head = _F32(start) * (_F32(1) - i * r)
    out = (f64(i) * f64(_F32(stop) * r) + f64(head)).astype(_F32)
    return torch.as_tensor(np.append(out, _F32(stop)), device=device)


def _norm(x, keepdim=False):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def build_block_tsdf(points, conf, origin_cam, grid_origin, voxel_size,
                     trunc, grid_dim, n_samples):
    """Fuse points into a dense local TSDF (projective, per-ray samples).

    ``points (P, 3)`` world-frame surface points with ``conf (P,)``;
    ``origin_cam (3,)`` the camera center in the world frame. Each point's
    viewing ray is sampled at ``n_samples`` depths spanning ±trunc around
    the surface; each sample deposits ``sdf = (ray_len - t)/trunc`` with
    weight ``conf * (1 - |sdf|)`` into its nearest voxel. Returns
    ``(tsdf (G,G,G), weight (G,G,G))``; weight-0 voxels hold tsdf 1.0.
    """
    G = grid_dim
    dev = points.device
    dirs = points - origin_cam
    ray_len = _norm(dirs, keepdim=True)                              # (P, 1)
    dirs = dirs / ray_len.clamp_min(1e-9)

    ts = _linspace(-1.0, 1.0, n_samples, dev)                        # (S,)
    depth = ray_len + trunc * ts[None, :]                            # (P, S)
    samples = origin_cam + dirs[:, None, :] * depth[..., None]       # (P, S, 3)
    sdf = (ray_len - depth) / trunc                                  # (P, S)
    w = conf[:, None] * (1.0 - sdf.abs()).clamp_min(0.0)             # (P, S)

    # a NaN coordinate takes cell 0, as XLA's float-to-int conversion
    ijk = torch.floor((samples - grid_origin) / voxel_size).nan_to_num(0.0)
    inside = ((ijk >= 0) & (ijk < G)).all(-1)
    w = torch.where(inside, w, torch.zeros_like(w))
    ijk = ijk.clamp(0, G - 1).long()
    lin = ((ijk[..., 0] * G + ijk[..., 1]) * G + ijk[..., 2]).reshape(-1)
    zeros = torch.zeros(G * G * G, dtype=torch.float32, device=dev)
    flat_ws = zeros.index_add(0, lin, (w * sdf).reshape(-1))
    flat_w = zeros.index_add(0, lin, w.reshape(-1))
    tsdf = torch.where(flat_w > 0, flat_ws / flat_w.clamp_min(1e-12),
                       torch.ones_like(flat_w))
    return tsdf.reshape(G, G, G), flat_w.reshape(G, G, G)


def build_blocks_tsdf_projective(X_cam, conf, T_WC, grid_origins,
                                 voxel_sizes, trunc, grid_dim, img_size):
    """Projective voxel-parallel TSDF builds of B blocks of one keyframe.

    ``X_cam (H·W, 3)`` is the camera-frame pointmap in pixel order,
    ``conf (H·W,)``, ``T_WC (8,)`` the Sim3 world-from-camera pose;
    ``grid_origins (B, 3)``, ``voxel_sizes (B,)``. Every voxel center is
    projected into the camera, reads the hit pixel's range R and
    confidence, and takes ``sdf = (R - r)/trunc`` with weight
    ``conf·max(0, 1-|sdf|)``. Returns ``(tsdf (B,G,G,G), weight (B,G,G,G))``
    in :func:`build_block_tsdf`'s convention.
    """
    H, W = img_size
    G = grid_dim
    B = grid_origins.shape[0]
    f = geometry.estimate_focal(X_cam[None], img_size)[0]
    range_img = _norm(X_cam)                                         # (N,)

    ax = ((torch.arange(G, dtype=torch.float32, device=X_cam.device) + 0.5)
          * voxel_sizes[:, None])                                    # (B, G)
    vx = grid_origins[:, 0:1] + ax
    vy = grid_origins[:, 1:2] + ax
    vz = grid_origins[:, 2:3] + ax
    V = torch.stack([vx[:, :, None, None].expand(B, G, G, G),
                     vy[:, None, :, None].expand(B, G, G, G),
                     vz[:, None, None, :].expand(B, G, G, G)],
                    dim=-1).reshape(B, -1, 3)                        # (B, G³, 3)
    Xc = lie.act(lie.inv(T_WC), V)
    z = Xc[..., 2]
    r = _norm(Xc)
    z_safe = torch.where(z > 1e-6, z, torch.ones_like(z))
    u = f * Xc[..., 0] / z_safe + (W - 1) / 2.0
    v = f * Xc[..., 1] / z_safe + (H - 1) / 2.0
    inb = (z > 1e-6) & (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    # round half to even, as jnp.round; a voxel out of the image (or with a
    # non-finite projection) gathers any pixel and gets weight 0
    ui = torch.round(u).nan_to_num(0.0).clamp(0, W - 1).long()
    vi = torch.round(v).nan_to_num(0.0).clamp(0, H - 1).long()
    # one 2-channel row gather instead of two scalar-row gathers
    rc = torch.stack([range_img, conf], dim=-1)[vi * W + ui]         # (B, G³, 2)
    R, c = rc[..., 0], rc[..., 1]
    sdf = (R - r) / trunc
    w = torch.where(inb, c * (1.0 - sdf.abs()).clamp_min(0.0),
                    torch.zeros_like(sdf))
    tsdf = torch.where(w > 0, sdf, torch.ones_like(sdf))
    return tsdf.reshape(B, G, G, G), w.reshape(B, G, G, G)


def build_block_tsdf_projective(X_cam, conf, T_WC, grid_origin, voxel_size,
                                trunc, grid_dim, img_size):
    """One block of :func:`build_blocks_tsdf_projective`: ``grid_origin
    (3,)``, ``voxel_size`` a scalar. Returns ``(tsdf (G,G,G), weight
    (G,G,G))``."""
    vs = torch.as_tensor(voxel_size, dtype=torch.float32,
                         device=X_cam.device).reshape(1)
    tsdf, w = build_blocks_tsdf_projective(
        X_cam, conf, T_WC, grid_origin.reshape(1, 3), vs, trunc, grid_dim,
        img_size)
    return tsdf[0], w[0]


def _corner_stack(g):
    """``(B, G, G, G)`` → ``(B, G, G, G, 8)``: the 2x2x2 footprint of every
    cell, corner ``(dx, dy, dz)`` rolled in (it wraps at the far faces)."""
    return torch.stack([torch.roll(g, (-dx, -dy, -dz), dims=(1, 2, 3))
                        for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
                       dim=-1)


def raycast_blocks(tsdf, weight, points, mask, origin_cam, grid_origins,
                   voxel_sizes, band, min_weight, max_displacement,
                   n_samples):
    """Refine each point by raycasting its block's TSDF around its depth.

    ``tsdf, weight (B, G, G, G)``; ``points (B, P, 3)`` current world
    points, ``mask (B, P)`` the block's pixels; ``origin_cam (3,)`` shared,
    ``grid_origins (B, 3)``, ``voxel_sizes (B,)``. Samples ``n_samples``
    positions in ``±band`` around the original depth along the pixel ray,
    finds the first +→− zero crossing with both samples valid (weight >
    min_weight), interpolates it, and moves the point there if the
    displacement is within ``max_displacement``. Returns ``(new_points (B,
    P, 3), refined_mask (B, P))``.
    """
    B, G = tsdf.shape[0], tsdf.shape[1]
    dirs = points - origin_cam
    ray_len = _norm(dirs, keepdim=True)                              # (B, P, 1)
    dirs = dirs / ray_len.clamp_min(1e-9)

    ts = _linspace(-band, band, n_samples, points.device)
    depth = ray_len + ts                                             # (B, P, S)
    samples = origin_cam + dirs[..., None, :] * depth[..., None]
    vox = ((samples - grid_origins[:, None, None, :])
           / voxel_sizes[:, None, None, None])

    # both fields' 2x2x2 footprints as ONE 16-wide row per cell
    packed = torch.cat([_corner_stack(tsdf), _corner_stack(weight)],
                       dim=-1).reshape(B, G * G * G, 16)
    # G - 1.000001 is G - 1 in float32 (G = 64): p0 reaches G - 1 and the
    # +1 corners wrap, as in the JAX package
    p = vox.clamp(0.0, G - 1.000001)
    p0 = torch.floor(p)
    f = p - p0
    p0 = p0.nan_to_num(0.0).long()       # a NaN sample's row is never used
    lin = (p0[..., 0] * G + p0[..., 1]) * G + p0[..., 2]             # (B, P, S)
    rows = packed[torch.arange(B, device=lin.device)[:, None, None], lin]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    wts = [((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
            * (fz if dz else 1 - fz))
           for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
    phi = sum(wts[c] * rows[..., c] for c in range(8))               # (B, P, S)
    wgt = sum(wts[c] * rows[..., 8 + c] for c in range(8))
    valid_s = wgt > min_weight

    # first sign change + → − along the ray with both endpoints valid
    a = phi[..., :-1]
    b = phi[..., 1:]
    cross = (a > 0) & (b <= 0) & valid_s[..., :-1] & valid_s[..., 1:]
    any_cross = cross.any(-1)
    first = cross.to(torch.int32).argmax(-1, keepdim=True)  # first maximum
    a_v = a.gather(-1, first)[..., 0]
    b_v = b.gather(-1, first)[..., 0]
    frac = a_v / (a_v - b_v).clamp_min(1e-12)
    d0 = depth.gather(-1, first)[..., 0]
    d1 = depth.gather(-1, first + 1)[..., 0]
    d_new = d0 + frac * (d1 - d0)

    disp = (d_new - ray_len[..., 0]).abs()
    ok = mask & any_cross & (disp <= max_displacement)
    new_points = torch.where(ok[..., None],
                             origin_cam + dirs * d_new[..., None], points)
    return new_points, ok


def raycast_block(tsdf, weight, points, mask, origin_cam, grid_origin,
                  voxel_size, band, min_weight, max_displacement, n_samples):
    """One block of :func:`raycast_blocks`: ``tsdf, weight (G, G, G)``,
    ``points (P, 3)``, ``mask (P,)``, ``grid_origin (3,)``, ``voxel_size``
    a scalar. Returns ``(new_points (P, 3), refined_mask (P,))``."""
    vs = torch.as_tensor(voxel_size, dtype=torch.float32,
                         device=points.device).reshape(1)
    new, ok = raycast_blocks(tsdf[None], weight[None], points[None],
                             mask[None], origin_cam, grid_origin.reshape(1, 3),
                             vs, band, min_weight, max_displacement,
                             n_samples)
    return new[0], ok[0]


def refine_blocks_core(Xw, X_cam, conf, T_WC, sel_j, mask, grid_origins,
                       voxel_sizes, trunc, band, min_weight,
                       max_displacement, grid_dim, img_size, n_samples):
    """One keyframe event's device work between the pose snapshot and the
    fusion write-back: the batched projective builds, the block-pixel
    gather and the batched raycasts. ``Xw (N, 3)`` is the world pointmap
    (the scheduler fits the blocks' ROIs on it first), ``sel_j (B, P)`` the
    blocks' pixel indices. Returns ``(new_points (B, P, 3), refined (B,
    P))``."""
    tsdf, weight = build_blocks_tsdf_projective(
        X_cam, conf, T_WC, grid_origins, voxel_sizes, trunc, grid_dim,
        img_size)
    return raycast_blocks(tsdf, weight, Xw[sel_j], mask,
                          lie.translation(T_WC), grid_origins, voxel_sizes,
                          band, min_weight, max_displacement, n_samples)


def boost_conf(refined, C, conf_boost_scaled, conf_max_scaled):
    """The write-back's confidence boost: ``min(C + boost, max)`` on the
    refined pixels."""
    return torch.where(refined[:, None],
                       (C + conf_boost_scaled).clamp_max(conf_max_scaled), C)


# ---------------------------------------------------------------------------
# Host-side scheduling structures
# ---------------------------------------------------------------------------

class BlockState(Enum):
    IDLE = 0
    QUEUED = 1
    RUNNING = 2
    COOLDOWN = 3


@dataclasses.dataclass
class PatchBlock:
    kf_id: int
    patch_ids: list            # (gy, gx) patches in the block
    pixel_mask: np.ndarray     # (H*W,) bool
    priority: float
    depth_range: tuple


@dataclasses.dataclass
class _BlockInfo:
    state: BlockState = BlockState.IDLE
    last_finish: float = 0.0
    attempts: int = 0
    successes: int = 0


class RefineRegistry:
    """Block state machine preventing duplicate in-flight refinement."""

    def __init__(self, cooldown_s=5.0):
        self.blocks: dict = {}
        self.cooldown_s = cooldown_s
        self.lock = threading.Lock()

    def try_queue(self, key) -> bool:
        with self.lock:
            info = self.blocks.setdefault(key, _BlockInfo())
            now = time.monotonic()
            if info.state == BlockState.COOLDOWN and (
                now - info.last_finish
            ) >= self.cooldown_s:
                info.state = BlockState.IDLE
            if info.state != BlockState.IDLE:
                return False
            info.state = BlockState.QUEUED
            return True

    def mark_running(self, key):
        with self.lock:
            self.blocks[key].state = BlockState.RUNNING

    def mark_done(self, key, success: bool):
        with self.lock:
            info = self.blocks[key]
            info.state = BlockState.COOLDOWN
            info.last_finish = time.monotonic()
            info.attempts += 1
            info.successes += int(success)

    def get_stats(self):
        with self.lock:
            return {
                "n_blocks": len(self.blocks),
                "attempts": sum(b.attempts for b in self.blocks.values()),
                "successes": sum(b.successes for b in self.blocks.values()),
            }


class TSDFRefiner:
    """Worker thread + scheduler: ``start``, ``maybe_schedule_sliding_window``,
    ``schedule_final_pass``, ``stop_flag``/``is_alive``, ``drain``,
    ``stats``. The device work runs on ``device`` (the card unless the
    caller asks for the CPU); the write-back on the keyframe buffers'
    own."""

    def __init__(self, keyframes, cfg, quality_service=None, device="cuda"):
        c = cfg.get("tsdf_refine", {})
        self.keyframes = keyframes
        self.quality = quality_service
        self.device = torch.device(device)
        self.enabled = bool(c.get("enabled", True))
        self.window_size = int(c.get("window_size", 5))
        self.voxel_size = float(c.get("voxel_size", 0.02))
        self.trunc = float(c.get("trunc_dist", 0.08))
        self.max_grid_dim = int(c.get("max_grid_dim", 64))
        self.roi_size = float(c.get("roi_size", 0.4))
        self.ray_samples = int(c.get("ray_samples", 64))
        self.max_disp = float(c.get("max_displacement", 0.015))
        self.min_weight = float(c.get("min_weight_threshold", 0.01))
        self.conf_boost = float(c.get("confidence_boost", 0.08))
        self.conf_max = float(c.get("confidence_max", 1.3))
        self.min_hit_rate = float(c.get("min_hit_rate", 0.05))
        self.max_rois = int(c.get("max_rois_per_kf", 3))
        self.min_conf = float(c.get("min_confidence", 0.2))
        self.geo_weight = float(c.get("geo_weight", 0.0))
        self.max_retries = int(c.get("max_retries", 3))
        self.retry_backoff_s = float(c.get("retry_backoff_s", 2.0))
        self.max_pending = int(c.get("max_pending_tasks", 50))
        self.quality_wait_s = float(c.get("quality_wait_ms", 500)) / 1e3

        self.registry = RefineRegistry(float(c.get("cooldown_s", 5.0)))
        self.task_q: queue.Queue = queue.Queue(maxsize=self.max_pending)
        self.stop_flag = threading.Event()
        self.stats = {
            "scheduled": 0, "refined_blocks": 0, "rejected_blocks": 0,
            "dropped_tasks": 0, "points_refined": 0, "conf_boosted_kfs": 0,
            "version_conflicts": 0, "total_processing_time": 0.0,
        }
        self._retry: dict[int, tuple] = {}       # kf_id → (due_time, attempts)
        self._retry_counts: dict[int, int] = {}  # kf_id → failures so far
        self._quality_waits: dict[int, float] = {}  # kf_id → seconds deferred
        self._worker = threading.Thread(target=self.run, daemon=True,
                                        name="tsdf-refine")
        self._started = False

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self.enabled and not self._started:
            self._worker.start()
            self._started = True
        return self

    def is_alive(self):
        return self._started and self._worker.is_alive()

    def stop(self, timeout=10.0):
        self.stop_flag.set()
        if self._started:
            self._worker.join(timeout=timeout)

    def queue_size(self):
        return self.task_q.qsize()

    # -- scheduling ------------------------------------------------------------

    def maybe_schedule_sliding_window(self, current_kf: int,
                                      is_final_pass: bool = False):
        """Refine keyframe ``current_kf - window_size``; the final pass
        walks the whole window."""
        if not self.enabled:
            return
        if is_final_pass:
            targets = range(max(0, current_kf - self.window_size), current_kf + 1)
        else:
            t = current_kf - self.window_size
            if t < 0:
                return
            targets = [t]
        for kf_id in targets:
            self._schedule_refinement(kf_id)

    def schedule_final_pass(self, last_kf: int):
        self.maybe_schedule_sliding_window(last_kf, is_final_pass=True)

    def _patch_priority(self, kf_id: int, gh: int, gw: int,
                        allow_pending=True):
        """Quality priorities, or the confidence fallback ``0.3 - C`` on
        low-confidence patches. Returns ``None`` when the quality result is
        not in yet and deferring is allowed: the scheduler then retries
        within ``quality_wait_ms`` (without the wait, short runs schedule
        from the fallback heuristic only, which never fires on model
        confidences ≥ 1)."""
        if self.quality is not None:
            res = self.quality.get_by_kf_id(kf_id)
            if res is not None and res["priority"].shape == (gh, gw):
                return np.asarray(res["priority"], np.float32)
            if (res is None and allow_pending and self.quality.is_alive()
                    and self._quality_waits.get(kf_id, 0.0)
                    < self.quality_wait_s):
                return None
        with self.keyframes.lock:
            C = self.keyframes.C[kf_id][:, 0].cpu().numpy()
            n = max(int(self.keyframes.N[kf_id]), 1)
        h, w = self.keyframes.h, self.keyframes.w
        Cavg = (C / n).reshape(h, w)
        ps_h, ps_w = h // gh, w // gw
        Cp = Cavg[: gh * ps_h, : gw * ps_w].reshape(gh, ps_h, gw, ps_w).mean((1, 3))
        return np.maximum(0.3 - Cp, 0.0).astype(np.float32)

    def _schedule_refinement(self, kf_id: int):
        if kf_id < 0 or kf_id >= len(self.keyframes):
            return
        h, w = self.keyframes.h, self.keyframes.w
        # the patch grid must match the quality service's, or the shape
        # guard in _patch_priority discards every quality result
        ps = int(getattr(self.quality, "ps", 16)) if self.quality else 16
        gh, gw = h // ps, w // ps
        pri = self._patch_priority(kf_id, gh, gw)
        if pri is None:
            # quality result pending: defer via the retry pump, bounded by
            # quality_wait_ms in total per keyframe
            step = max(0.05, self.quality_wait_s / 4.0)
            self._quality_waits[kf_id] = (
                self._quality_waits.get(kf_id, 0.0) + step)
            if kf_id not in self._retry:
                self._retry[kf_id] = (time.monotonic() + step,
                                      self._retry_counts.get(kf_id, 0))
            return
        blocks = self._select_blocks(kf_id, pri, gh, gw, ps, h, w)
        for blk in blocks[: self.max_rois]:
            key = (kf_id, tuple(sorted(blk.patch_ids))[:4])
            if not self.registry.try_queue(key):
                continue
            try:
                self.task_q.put_nowait((key, blk))
                self.stats["scheduled"] += 1
            except queue.Full:
                self.registry.mark_done(key, False)
                self.stats["dropped_tasks"] += 1

    def _select_blocks(self, kf_id, pri, gh, gw, ps, h, w):
        """Top-5% priority patches → greedy BFS clusters by patch adjacency +
        depth continuity (the JAX package's code, so the blocks and their
        tie-breaks are the same)."""
        flat = pri.ravel()
        n_top = max(int(0.05 * flat.size), 4)
        thresh = np.partition(flat, -n_top)[-n_top]
        cand = set(map(tuple, np.argwhere((pri >= thresh) & (pri > 0))))
        if not cand:
            return []

        with self.keyframes.lock:
            X = self.keyframes.X[kf_id].cpu().numpy()
        depth = np.linalg.norm(X.reshape(h, w, 3), axis=-1)
        pdep = depth[: gh * ps, : gw * ps].reshape(gh, ps, gw, ps).mean((1, 3))

        blocks = []
        while cand:
            seed = max(cand, key=lambda p: pri[p])
            cluster = [seed]
            cand.remove(seed)
            frontier = [seed]
            while frontier and len(cluster) < 16:
                cur = frontier.pop()
                for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                    nb = (cur[0] + dy, cur[1] + dx)
                    if nb in cand and abs(
                        pdep[nb] - pdep[cur]
                    ) < 0.25 * max(pdep[cur], 0.2):
                        cand.remove(nb)
                        cluster.append(nb)
                        frontier.append(nb)
            mask = np.zeros((h, w), bool)
            for gy, gx in cluster:
                mask[gy * ps: (gy + 1) * ps, gx * ps: (gx + 1) * ps] = True
            deps = [pdep[p] for p in cluster]
            blocks.append(PatchBlock(
                kf_id=kf_id,
                patch_ids=cluster,
                pixel_mask=mask.ravel(),
                priority=float(np.mean([pri[p] for p in cluster])),
                depth_range=(float(min(deps)), float(max(deps))),
            ))
        blocks.sort(key=lambda b: -b.priority)
        return blocks

    # -- worker ------------------------------------------------------------

    def _pump_retries(self):
        """Re-schedule failed keyframes whose backoff has elapsed
        (exponential backoff with a give-up cap)."""
        now = time.monotonic()
        due = [kf for kf, (t, _) in self._retry.items() if t <= now]
        for kf in due:
            _, attempts = self._retry.pop(kf)
            self._schedule_refinement(kf)
            self.stats["retries"] = self.stats.get("retries", 0) + 1
            self._retry_counts[kf] = attempts

    def run(self):
        S.bind_thread(self.device)
        pending = None  # different-keyframe task popped while grouping
        while not self.stop_flag.is_set():
            self._pump_retries()
            if pending is not None:
                first, pending = pending, None
            else:
                try:
                    first = self.task_q.get(timeout=0.25)
                except queue.Empty:
                    continue
            # group the queued same-keyframe siblings (the scheduler
            # enqueues a keyframe's blocks back to back): they run as one
            # batched computation in _refine_blocks
            group = [first]
            while len(group) < self.max_rois:
                try:
                    nxt = self.task_q.get_nowait()
                except queue.Empty:
                    break
                if nxt[1].kf_id != first[1].kf_id:
                    pending = nxt
                    break
                group.append(nxt)
            for key, _ in group:
                self.registry.mark_running(key)
            t0 = time.monotonic()
            try:
                oks = self._refine_blocks([blk for _, blk in group])
            except Exception as e:
                print(f"[tsdf-refine] block batch failed: {e}")
                traceback.print_exc()
                oks = [False] * len(group)
            self.stats["total_processing_time"] += time.monotonic() - t0
            for (key, blk), ok in zip(group, oks):
                self.registry.mark_done(key, ok)
                if ok:
                    self.stats["refined_blocks"] += 1
                    self._retry_counts.pop(blk.kf_id, None)
                else:
                    self.stats["rejected_blocks"] += 1
                    attempts = self._retry_counts.get(blk.kf_id, 0) + 1
                    if (attempts <= self.max_retries
                            and blk.kf_id not in self._retry):
                        backoff = self.retry_backoff_s * (2 ** (attempts - 1))
                        self._retry[blk.kf_id] = (time.monotonic() + backoff,
                                                  attempts)
        if pending is not None:
            # a different-keyframe task popped while grouping, orphaned by
            # stop_flag: put it back so the registry entry (still QUEUED)
            # and the drain/queue accounting stay consistent. Non-blocking:
            # a full queue here would deadlock the worker against its own
            # (stopped) consumer, so close the registry entry instead.
            try:
                self.task_q.put_nowait(pending)
            except queue.Full:
                self.registry.mark_done(pending[0], False)
                self.stats["dropped_tasks"] = (
                    self.stats.get("dropped_tasks", 0) + 1)

    def _refine_blocks(self, blks) -> list:
        """Snapshot → local TSDF builds → raycasts → guarded fusion
        write-back for ALL of one keyframe's blocks.

        The blocks share the keyframe snapshot, so their builds and
        raycasts run batched (:func:`refine_blocks_core`). Write-backs stay
        sequential per block (``_select_blocks`` partitions the candidate
        patches, so the pixel masks are disjoint), tracking the version our
        own writes bump; an external write between write-backs rejects the
        remaining blocks.
        """
        kf = self.keyframes
        kf_id = blks[0].kf_id
        ok_out = [False] * len(blks)
        dev = self.device
        # the keyframe buffers are written in place: the snapshot is a copy
        with kf.lock:
            if kf_id >= len(kf):
                return ok_out
            version = int(kf.version[kf_id])
            X = kf.X[kf_id].to(dev, copy=True)          # (N, 3) cam frame
            C = kf.C[kf_id][:, 0].cpu().numpy()
            n_fuse = max(int(kf.N[kf_id]), 1)
            T_WC = kf.T_WC[kf_id].to(dev, copy=True)

        Xw = lie.act(T_WC[None], X)                      # world frame
        conf = torch.as_tensor(np.clip(C / n_fuse, 0.0, None), device=dev)
        Xw_np = Xw.cpu().numpy()  # host copy for the ROI percentile fit

        # host-side per-block ROI fit; blocks failing the sanity gates drop
        prep = []  # (slot, sel, grid_origin_lo, voxel)
        for s, blk in enumerate(blks):
            sel = np.where(blk.pixel_mask)[0]
            if sel.size == 0:
                continue
            roi_pts = Xw_np[sel]
            finite = np.isfinite(roi_pts).all(axis=1)
            if finite.mean() < 0.5:
                continue
            lo = np.percentile(roi_pts[finite], 5, axis=0) - self.trunc
            hi = np.percentile(roi_pts[finite], 95, axis=0) + self.trunc
            extent = float(np.max(hi - lo))
            voxel = max(self.voxel_size, extent / self.max_grid_dim)
            prep.append((s, sel, lo.astype(np.float32), voxel))
        if not prep:
            return ok_out

        G = self.max_grid_dim
        B = len(prep)
        # raycast only each block's pixels, compacted to one power-of-two
        # bucket shared across the batch
        P = 256
        while P < max(p[1].size for p in prep):
            P *= 2
        sel_pad = np.zeros((B, P), np.int64)
        mask_pad = np.zeros((B, P), bool)
        origins = np.zeros((B, 3), np.float32)
        voxels = np.zeros((B,), np.float32)
        for b, (_, sel, lo, voxel) in enumerate(prep):
            sel_pad[b, :sel.size] = sel
            mask_pad[b, :sel.size] = True
            origins[b] = lo
            voxels[b] = voxel
        sel_j = torch.as_tensor(sel_pad, device=dev)
        mask_j = torch.as_tensor(mask_pad, device=dev)
        band = 0.1
        new_sel, refined_sel = refine_blocks_core(
            Xw, X, conf, T_WC, sel_j, mask_j, torch.as_tensor(origins,
                                                              device=dev),
            torch.as_tensor(voxels, device=dev), self.trunc, band,
            self.min_weight, self.max_disp, G, (kf.h, kf.w),
            self.ray_samples)
        refined_all = refined_sel.cpu().numpy()          # (B, P)

        # conservative fusion per block: confidence boost (+ optional
        # geometric blend), iff the keyframe version is unchanged since the
        # snapshot (modulo our own committed sibling-block writes)
        for b, (s, sel, _, _) in enumerate(prep):
            refined_sel_np = refined_all[b, :sel.size]
            hits = int(refined_sel_np.sum())
            if hits < self.min_hit_rate * sel.size:
                continue
            refined_np = np.zeros(Xw_np.shape[0], bool)
            refined_np[sel] = refined_sel_np
            X_ref_cam = None
            if self.geo_weight > 0:
                idx = sel_j[b][mask_j[b]]
                new_w = Xw.clone()
                new_w[idx] = torch.where(refined_sel[b][mask_j[b]][:, None],
                                         new_sel[b][mask_j[b]], Xw[idx])
                X_ref_cam = lie.act(lie.inv(T_WC)[None], new_w).to(kf.device)

            with kf.lock:
                if int(kf.version[kf_id]) != version:
                    self.stats["version_conflicts"] += 1
                    continue
                refined_t = torch.as_tensor(refined_np, device=kf.device)
                boost = boost_conf(refined_t, kf.C[kf_id],
                                   self.conf_boost * n_fuse,
                                   self.conf_max * n_fuse)
                X_new = kf.X[kf_id]
                if X_ref_cam is not None:
                    X_new = torch.where(
                        refined_t[:, None],
                        (1.0 - self.geo_weight) * X_new
                        + self.geo_weight * X_ref_cam, X_new)
                ok = kf.update_pointmap_inplace(kf_id, X_new, boost,
                                                expected_version=version)
                if ok:
                    # our write bumped the version; siblings remain valid
                    version = int(kf.version[kf_id])
            if ok:
                self.stats["points_refined"] += hits
                self.stats["conf_boosted_kfs"] += 1
                ok_out[s] = True
        return ok_out

    # -- shutdown ------------------------------------------------------------

    def drain(self, max_wait_s=60.0, min_wait_s=2.0, stall_s=10.0):
        """Graceful queue drain with progress-stall detection."""
        t0 = time.monotonic()
        last_progress = t0
        last_done = self.stats["refined_blocks"] + self.stats["rejected_blocks"]
        while time.monotonic() - t0 < max_wait_s:
            # _retry holds quality-deferred keyframes too (scheduled before
            # their quality result landed): an empty task queue with
            # pending deferrals is NOT drained yet
            if (self.task_q.empty() and not self._retry
                    and time.monotonic() - t0 > min_wait_s):
                break
            done = self.stats["refined_blocks"] + self.stats["rejected_blocks"]
            if done > last_done:
                last_done = done
                last_progress = time.monotonic()
            elif time.monotonic() - last_progress > stall_s:
                print("[tsdf-refine] drain stalled; aborting remaining tasks")
                break
            time.sleep(0.1)
        self.stop()

    def print_stats(self):
        s = dict(self.stats)
        s.update(self.registry.get_stats())
        print(f"[tsdf-refine] {s}")
