"""Headless SLAM-state renderer (software z-buffer point splatting) in torch.

Counterpart of ``mast3r_slam_tpu/viz/render.py``: confidence-thresholded
keyframe pointmaps, the current frame's depth-coloured points, the camera
trajectory, frustum wireframes and factor-graph edges, drawn into an image
on the device of the keyframe tensors (the card in the CLI), so it works
without a display (snapshot PNGs) and is testable. The OpenGL viewer
(``viz/viewer.py``) reuses the camera helpers.

Under the keyframe buffer's lock the renderer only clones the keyframe
tensors on their device: the clone is queued behind the tracker's and the
backend's work, where a host copy would wait for all of it while holding
the lock. Everything else runs after the lock is released.

Where the JAX package's numpy arithmetic is float32, the port's is too,
with the same operations in the same order: projections are elementwise
sums (no matmul, whose summation order and TF32 use follow the device),
and ``draw_line`` samples a segment as NumPy 2's ``np.linspace`` does for
the float32 endpoints it is given (float32 ``arange * step + start``, the
last sample set to the end point).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mast3r_slam_tpu_torch.data import png
from mast3r_slam_tpu_torch.ops import lie

TRAJ_COLOR = (1.0, 0.3, 0.2)
FRUSTUM_COLOR = (0.3, 0.8, 1.0)
EDGE_COLOR = (0.2, 1.0, 0.3)
# apex-to-corner and corner-to-corner lines of frustum_corners' 5 points
FRUSTUM_LINES = ((0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4),
                 (4, 1))


def look_at(eye, target, up=(0.0, 1.0, 0.0), device=None):
    """World→camera rotation and translation (float32, on ``device``) for
    a camera at ``eye`` looking at ``target`` (OpenCV convention: +z
    forward, +y down), computed in float64 on the host."""
    def vec(a):
        return torch.as_tensor(a, dtype=torch.float64, device="cpu")

    eye = vec(eye)
    f = vec(target) - eye
    f = f / (torch.linalg.norm(f) + 1e-12)
    r = torch.linalg.cross(f, -vec(up))
    r = r / (torch.linalg.norm(r) + 1e-12)
    d = torch.linalg.cross(f, r)
    R = torch.stack([r, d, f])
    t = -R @ eye
    return R.float().to(device), t.float().to(device)


def _project(P_w, R, t, K, hw):
    """Pinhole projection of ``P_w (N, 3)``: (u, v, z, ok), ``ok`` where the
    point lies in front of the camera and inside [0, W-1) x [0, H-1)."""
    H, W = hw
    P_c = (P_w[:, 0:1] * R[:, 0] + P_w[:, 1:2] * R[:, 1]
           + P_w[:, 2:3] * R[:, 2] + t)
    z = P_c[:, 2]
    ok = z > 1e-6
    zs = torch.where(ok, z, torch.ones_like(z))
    u = K[0, 0] * P_c[:, 0] / zs + K[0, 2]
    v = K[1, 1] * P_c[:, 1] / zs + K[1, 2]
    ok &= (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
    return u, v, z, ok


def splat_points(img, zbuf, P_w, colors, R, t, K):
    """Z-buffered 1-px point splats into ``img (H, W, 3)`` / ``zbuf (H,
    W)``, in place. A pixel takes its nearest point if that is nearer than
    ``zbuf``; among points of exactly equal depth the lowest point index
    wins (two stable sorts: by depth, then by pixel), where the JAX
    package's unstable ``argsort`` leaves the winner undefined."""
    H, W = zbuf.shape
    u, v, z, ok = _project(P_w, R, t, K, (H, W))
    pts = ok.nonzero()[:, 0]
    lin = v[pts].long() * W + u[pts].long()
    by_depth = torch.sort(z[pts], stable=True).indices
    order = by_depth[torch.sort(lin[by_depth], stable=True).indices]
    lin_o = lin[order]
    first = torch.ones_like(lin_o, dtype=torch.bool)
    first[1:] = lin_o[1:] != lin_o[:-1]
    win = pts[order[first]]
    sel = lin_o[first]
    zb = zbuf.view(-1)
    im = img.view(-1, 3)
    closer = z[win] < zb[sel]
    zb[sel] = torch.where(closer, z[win], zb[sel])
    im[sel] = torch.where(closer[:, None], colors[win], im[sel])


def draw_lines(img, p0, p1, color):
    """Naive DDA lines in pixel space between ``p0 (L, 2)`` and ``p1 (L,
    2)`` (u, v; float32, pre-projected), in one ``color``: each segment is
    sampled at max(|du|, |dv|, 1) + 1 points as the JAX package's
    ``draw_line`` samples it, and each sample inside the image sets the
    pixel it truncates to."""
    if not len(p0):
        return
    H, W = img.shape[:2]
    dev = img.device
    delta = p1 - p0
    n = delta.abs().amax(-1).clamp_min(1.0).long()
    seg = torch.repeat_interleave(torch.arange(len(n), device=dev), n + 1)
    k = torch.arange(len(seg), device=dev) - (torch.cumsum(n + 1, 0)
                                               - (n + 1))[seg]
    step = delta / n[:, None].to(delta.dtype)
    y = k[:, None].to(delta.dtype) * step[seg] + p0[seg]
    y = torch.where((k == n[seg])[:, None], p1[seg], y)
    us, vs = y[:, 0], y[:, 1]
    ok = (us >= 0) & (us < W) & (vs >= 0) & (vs < H)
    img[vs[ok].long(), us[ok].long()] = torch.tensor(color, dtype=img.dtype,
                                                     device=dev)


def draw_line(img, p0, p1, color):
    """One line of :func:`draw_lines` from ``p0 = (u0, v0)`` to ``p1``."""
    def pt(p):
        return torch.as_tensor(p, dtype=torch.float32,
                               device=img.device).reshape(1, 2)

    draw_lines(img, pt(p0), pt(p1), color)


def _pair_lines(img, ends, R, t, K, color):
    """Project ``ends (L, 2, 3)`` and draw the segments whose both ends
    project into the image."""
    H, W = img.shape[:2]
    u, v, _, ok = _project(ends.reshape(-1, 3), R, t, K, (H, W))
    both = ok.reshape(-1, 2).all(1)
    uv = torch.stack([u, v], -1).reshape(-1, 2, 2)[both]
    draw_lines(img, uv[:, 0], uv[:, 1], color)


def draw_polyline_3d(img, pts_w, R, t, K, color):
    pts_w = torch.as_tensor(pts_w, dtype=torch.float32, device=img.device)
    _pair_lines(img, torch.stack([pts_w[:-1], pts_w[1:]], 1), R, t, K,
                color)


def frustum_corners(T_WC, scale=0.08, aspect=4.0 / 3.0):
    """World-space points of camera frustum wireframes (apex + 4 corners):
    ``(5, 3)`` for one pose ``(8,)``, ``(..., 5, 3)`` for ``(..., 8)``."""
    T = torch.as_tensor(T_WC)
    zs = scale
    xs = zs * aspect * 0.8
    ys = zs * 0.8
    local = torch.tensor([
        [0, 0, 0],
        [-xs, -ys, zs], [xs, -ys, zs], [xs, ys, zs], [-xs, ys, zs],
    ], dtype=torch.float32, device=T.device)
    return lie.act(T[..., None, :], local)


def turbo_colormap(t):
    """Cheap turbo-like colormap for normalized depth ``t (N,) in [0, 1]``
    (the reference colours the current frame by depth)."""
    t = torch.as_tensor(t).to(torch.float32).clamp(0.0, 1.0)
    r = (1.6 - (4.0 * t - 3.2).abs()).clamp(0, 1)
    g = (1.6 - (4.0 * t - 1.9).abs()).clamp(0, 1)
    b = (1.6 - (4.0 * t - 0.8).abs()).clamp(0, 1)
    return torch.stack([r, g, b], dim=-1)


def _finite(Xw):
    return torch.isfinite(Xw).all(-1) & (Xw.abs() < 1e4).all(-1)


def _norm3(X):
    """Row norms summed in NumPy's order for three columns."""
    return (X[:, 0] * X[:, 0] + X[:, 1] * X[:, 1] + X[:, 2] * X[:, 2]).sqrt()


def _to_uint8(img):
    return (img * 255).clamp(0, 255).to(torch.uint8)


def render_state(keyframes, states=None, img_hw=(480, 640),
                 conf_threshold=0.0, eye=None, target=None,
                 max_points_per_kf=20000):
    """Render the current SLAM state to an RGB uint8 ``(H, W, 3)`` tensor on
    the keyframe buffer's device."""
    H, W = img_hw
    dev = keyframes.device
    img = torch.zeros(H, W, 3, device=dev)
    zbuf = torch.full((H, W), float("inf"), device=dev)
    K = torch.tensor([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]],
                     dtype=torch.float32, device=dev)

    with keyframes.lock:
        n = len(keyframes)
        if n == 0:
            return _to_uint8(img)
        traj = keyframes.T_WC[:n].clone()
        X = keyframes.X[:n].clone()
        C = keyframes.C[:n, :, 0].clone()
        N = keyframes.N[:n].copy()
        uimg = list(keyframes.uimg[:n])
        edges = (list(zip(states.edges_ii, states.edges_jj))
                 if states is not None else [])

    # every keyframe's kept points in keyframe then pixel order: the
    # confidence gate, the per-keyframe stride of the kept points (the JAX
    # package's max_points_per_kf subsampling), then the finite gate
    Nw = torch.from_numpy(np.maximum(N, 1).astype(np.float32)).to(dev)
    keep = (C / Nw[:, None]) > conf_threshold
    count = keep.sum(1, keepdim=True)
    stride = torch.where(count > max_points_per_kf,
                         count // max_points_per_kf + 1,
                         torch.ones_like(count))
    Xw = lie.act(traj[:, None, :], X)
    sel = keep & ((keep.cumsum(1) - 1) % stride == 0) & _finite(Xw)
    cols = torch.from_numpy(np.stack([
        np.asarray(u, np.float32).reshape(-1, 3) if u is not None
        else np.full((X.shape[1], 3), 0.7, np.float32) for u in uimg]))
    pts_all = [Xw[sel]]
    col_all = [cols.to(dev)[sel]]

    # the current frame: depth-coloured splats
    cur = states.get_frame() if states is not None else None
    if cur is not None and cur.X_canon is not None:
        Xc = cur.X_canon.to(dev, torch.float32)
        Xwc = lie.act(cur.T_WC.to(dev).reshape(1, 8), Xc)
        fin = _finite(Xwc)
        Xwc = Xwc[fin]
        depth = _norm3(Xc[fin]).double()
        if depth.numel():
            lo, hi = torch.quantile(
                depth, torch.tensor([0.05, 0.95], dtype=torch.float64,
                                    device=dev)).tolist()
        else:
            lo, hi = 0.0, 1.0
        tcol = turbo_colormap((depth - lo) / max(hi - lo, 1e-6))
        if Xwc.shape[0] > max_points_per_kf:
            step = Xwc.shape[0] // max_points_per_kf + 1
            Xwc, tcol = Xwc[::step], tcol[::step]
        pts_all.append(Xwc)
        col_all.append(tcol)

    P = torch.cat(pts_all)
    Cp = torch.cat(col_all)
    centers = traj[:, :3]
    s = centers.sort(0).values
    scene_c = (0.5 * (s[(n - 1) // 2] + s[n // 2])).cpu().double()
    if eye is None:
        spread = (float(P.double().std(0, correction=0).max()) if len(P)
                  else 1.0)
        eye = scene_c + torch.tensor([0.0, -1.5, -3.0],
                                     dtype=torch.float64) * max(spread, 0.5)
    if target is None:
        target = scene_c
    R, t = look_at(eye, target, device=dev)

    if len(P):
        splat_points(img, zbuf, P, Cp, R, t, K)
    draw_polyline_3d(img, centers, R, t, K, TRAJ_COLOR)
    corners = frustum_corners(traj)                          # (n, 5, 3)
    a, b = zip(*FRUSTUM_LINES)
    _pair_lines(img, torch.stack([corners[:, list(a)], corners[:, list(b)]],
                                 2).reshape(-1, 2, 3), R, t, K,
                FRUSTUM_COLOR)
    ij = [(i, j) for i, j in edges if i < n and j < n]
    if ij:
        _pair_lines(img, centers[torch.tensor(ij, device=dev)], R, t, K,
                    EDGE_COLOR)
    return _to_uint8(img)


def save_snapshot(path, keyframes, states=None, **kw):
    """Render the state and write it as a PNG (``data/png.py``'s encoder).
    Returns the image; a path not ending in ``.png`` raises ValueError."""
    if Path(path).suffix.lower() != ".png":
        raise ValueError(f"save_snapshot writes PNG only, not "
                         f"{Path(path).suffix or 'a file without extension'}"
                         f": {path}")
    img = render_state(keyframes, states, **kw)
    png.write_png(path, img.cpu().numpy())
    return img
