"""Per-edge Gram of the BA normal equations (kernels K4 and K5) and their
plain versions.

Counterpart of ``mast3r_slam_tpu/ops/ba_kernels.py``: :func:`gram_rays`
(the ray residual) and :func:`gram_calib` (the calibrated pixel + log-depth
residual) return ``G (E, 32, 32)`` float32 whose diagonal 8x8 blocks hold
``[J_d ; rho_d]`` Gram products per residual channel d (H is the top-left
7x7 of their sum, g its last column, the cost the (rho, rho) corner); the
calibrated Gram's rows 24+ are zero. The measured channels come flat
``(E, N)`` from ``slam/factor_graph.py``'s premeas, float32 or bfloat16,
and are widened to float32 at load; the weighted rows are rounded to
``compute_dtype`` and their products summed in float32 by the kernel (in
float64 by the plain version, see :func:`_gram`).

On CUDA tensors both launch a hand-written kernel in ``csrc/ba_gram.cu``,
on one of three paths (:func:`gram_path`):

- ``"mma"``: bfloat16 rows, the Gram on the tensor cores (``mma.sync``)
  after a row stage on cheaper operations (MUFU reciprocal square roots,
  reciprocal sigmas from the host); :func:`rays_rows_kernel_order` and
  :func:`calib_rows_kernel_order` are its row arithmetic in plain form;
- ``"tf32"``: float32 rows, the IEEE float32 rows and the Gram on the
  tensor cores in 3xTF32 (``wgmma`` .tf32; each row value split into TF32
  hi and lo parts, three products), float32-accurate; :func:`gram_tf32x3`
  is its product in plain form;
- ``"fma"``: the first design, kept for timing (float32 or bfloat16 rows),
  the Gram as f32 FMAs.

On CPU tensors they return the plain versions :func:`gram_rays_ref` /
:func:`gram_calib_ref`; any other device raises. The TPU kernel's
sublane-split layout has no counterpart here.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from mast3r_slam_tpu_torch import _build
from mast3r_slam_tpu_torch.ops.tf32 import tf32_split

KERNEL = "ba_gram"
HUBER_K = 1.345
SQRT_HUBER_K = 1.15974135    # the "mma" path's constant, rounded to f32
THREADS = 256            # pixels per tile of the kernel
BLOCKS_PER_SM = 4        # blocks the "fma" grid aims for per SM
PATHS = ("mma", "tf32", "fma")
rays_counter = _build.LaunchCounter()
calib_counter = _build.LaunchCounter()
path_counters = {p: _build.LaunchCounter() for p in PATHS}


def as_dtype(dtype) -> torch.dtype:
    """``torch.float32`` / ``torch.bfloat16`` from a dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(dtype)]


def _huber_w(w_abs, k=HUBER_K):
    return torch.where(w_abs < k, torch.ones_like(w_abs),
                       k / w_abs.clamp_min(1e-30))


def _jrow_entries(m1, m2, m3, px, py, pz):
    """Closed-form local Sim3 J-row ``[m | X'xm | m.X']`` (7 channels)."""
    return [m1, m2, m3,
            py * m3 - pz * m2,
            pz * m1 - px * m3,
            px * m2 - py * m1,
            px * m1 + py * m2 + pz * m3]


def _transform(rts, xj, yj, zj):
    """``sR X + t`` of the observer points; ``rts`` columns are per-edge
    scalars broadcast over the pixels."""
    c = [rts[:, i:i + 1] for i in range(12)]
    px = c[0] * xj + c[1] * yj + c[2] * zj + c[9]
    py = c[3] * xj + c[4] * yj + c[5] * zj + c[10]
    pz = c[6] * xj + c[7] * yj + c[8] * zj + c[11]
    return px, py, pz


def _weighted_rows(rho, d_res, sqc, sigmas, px, py, pz):
    rows = []
    for dd in range(len(rho)):
        hub = _huber_w(sqc * rho[dd].abs() / sigmas[dd])
        sq = sqc / sigmas[dd] * torch.sqrt(hub)
        for ch in _jrow_entries(*d_res[dd], px, py, pz) + [rho[dd]]:
            rows.append(sq * ch)
    return rows


def _gram(rows, compute_dtype):
    """``S Sᵀ`` of the rows rounded to ``compute_dtype``, summed in float64
    and rounded to float32 once: the exact Gram of the rounded rows, which
    every float32 summation order approaches. (cuBLAS's float32 ``bmm`` of
    the same rows at E = 128, N = 196,608 was off by 1e-4 of the largest
    entry on an H100.)"""
    S = torch.stack([r.to(compute_dtype) for r in rows], dim=1).double()
    return (S @ S.transpose(1, 2)).float()


def gram_tf32x3(rows):
    """Plain version of the ``"tf32"`` path's product: the float32 rows
    ``S`` split into TF32 parts (:func:`~.tf32.tf32_split`), ``lo hiᵀ + hi
    loᵀ + hi hiᵀ`` summed in float64 (each product of TF32 values is exact
    there) and rounded to float32 once."""
    S = torch.stack([r.float() for r in rows], dim=1)
    hi, lo = (t.double() for t in tf32_split(S))
    hiT = hi.transpose(1, 2)
    return (lo @ hiT + hi @ lo.transpose(1, 2) + hi @ hiT).float()


def _ray_terms(rts, meas, p, dinv, d):
    """Residuals, J factors and ``sqrt(conf)`` of the ray residual at the
    transformed points ``p`` with ``1/d`` and ``d`` given."""
    mx, my, mz, di, cf = (ch.float() for ch in meas[:5])
    rx, ry, rz = (c * dinv for c in p)
    rho = [rx - mx, ry - my, rz - mz, d - di]
    d_res = [
        [dinv * (1.0 - rx * rx), -dinv * rx * ry, -dinv * rx * rz],
        [-dinv * ry * rx, dinv * (1.0 - ry * ry), -dinv * ry * rz],
        [-dinv * rz * rx, -dinv * rz * ry, dinv * (1.0 - rz * rz)],
        [rx, ry, rz],
    ]
    return rho, d_res, torch.sqrt(cf * rts[:, 12:13])


def rays_rows(rts, meas, sigma_ray, sigma_dist):
    """The 32 weighted float32 rows ``[J_d ; rho_d]`` of the ray residual,
    each ``(E, N)``, unrounded (K4's per-pixel arithmetic)."""
    p = _transform(rts, *(ch.float() for ch in meas[5:]))
    d = torch.sqrt(sum(c * c for c in p)).clamp_min(1e-12)
    dinv = 1.0 / d
    rho, d_res, sqc = _ray_terms(rts, meas, p, dinv, d)
    sigmas = (sigma_ray, sigma_ray, sigma_ray, sigma_dist)
    return _weighted_rows(rho, d_res, sqc, sigmas, *p)


def _weighted_rows_kernel_order(rho, d_res, sqc, sigmas, px, py, pz):
    """:func:`_weighted_rows` as the "mma" path orders it: ``ws =
    sqrt(conf) * (1 / sigma)``, ``w = ws |rho|`` and the Huber weight's
    square root ``1`` below k, ``sqrt(k) * rsqrt(w)`` above."""
    rows = []
    for dd in range(len(rho)):
        ws = sqc * (1.0 / sigmas[dd])
        w = ws * rho[dd].abs()
        sq = torch.where(w < HUBER_K, ws,
                         ws * (SQRT_HUBER_K * torch.rsqrt(w)))
        for ch in _jrow_entries(*d_res[dd], px, py, pz) + [rho[dd]]:
            rows.append(sq * ch)
    return rows


def rays_rows_kernel_order(rts, meas, sigma_ray, sigma_dist):
    """:func:`rays_rows` in the "mma" path's order: ``1/d =
    rsqrt(max(|X'|², 1e-24))`` and ``d = max(|X'|² / d, 1e-12)`` (the
    clamp of ``max(|X'|, 1e-12)`` kept), the weights as
    :func:`_weighted_rows_kernel_order`."""
    p = _transform(rts, *(ch.float() for ch in meas[5:]))
    n2 = sum(c * c for c in p)
    dinv = torch.rsqrt(n2.clamp_min(1e-24))
    d = (n2 * dinv).clamp_min(1e-12)
    rho, d_res, sqc = _ray_terms(rts, meas, p, dinv, d)
    sigmas = (sigma_ray, sigma_ray, sigma_ray, sigma_dist)
    return _weighted_rows_kernel_order(rho, d_res, sqc, sigmas, *p)


def gram_rays_ref(rts, meas, sigma_ray, sigma_dist,
                  compute_dtype=torch.bfloat16):
    """Plain version of :func:`gram_rays`."""
    return _gram(rays_rows(rts, meas, sigma_ray, sigma_dist),
                 as_dtype(compute_dtype))


def _calib_terms(rts, meas, img_size, pixel_border, z_eps):
    ui, vi, lz, cf, xj, yj, zj = (ch.float() for ch in meas)
    fx, fy, cx, cy = (rts[:, i:i + 1] for i in range(13, 17))
    H_img, W_img = img_size
    px, py, pz = _transform(rts, xj, yj, zj)
    valid_z = pz > z_eps
    z_safe = torch.where(valid_z, pz, torch.ones_like(pz))
    z_inv = 1.0 / z_safe
    u = fx * px * z_inv + cx
    v = fy * py * z_inv + cy
    valid = (valid_z
             & (u > pixel_border) & (u < W_img - 1 - pixel_border)
             & (v > pixel_border) & (v < H_img - 1 - pixel_border))
    zero = torch.zeros_like(z_inv)
    rho = [u - ui, v - vi,
           torch.where(valid_z, torch.log(z_safe), zero) - lz]
    sqc = torch.sqrt(torch.where(valid, cf, zero) * rts[:, 12:13])
    d_res = [
        [fx * z_inv, zero, -fx * px * z_inv * z_inv],
        [zero, fy * z_inv, -fy * py * z_inv * z_inv],
        [zero, zero, z_inv],
    ]
    return rho, d_res, sqc, (px, py, pz), zero


def calib_rows(rts, meas, img_size, pixel_border, z_eps, sigma_pixel,
               sigma_depth):
    """The 32 weighted float32 rows of the calibrated residual, each
    ``(E, N)``, unrounded; rows 24+ are zero (K5's per-pixel
    arithmetic)."""
    rho, d_res, sqc, p, zero = _calib_terms(rts, meas, img_size,
                                            pixel_border, z_eps)
    sigmas = (sigma_pixel, sigma_pixel, sigma_depth)
    return _weighted_rows(rho, d_res, sqc, sigmas, *p) + [zero] * 8


def calib_rows_kernel_order(rts, meas, img_size, pixel_border, z_eps,
                            sigma_pixel, sigma_depth):
    """:func:`calib_rows` with the weights in the "mma" path's order
    (:func:`_weighted_rows_kernel_order`)."""
    rho, d_res, sqc, p, zero = _calib_terms(rts, meas, img_size,
                                            pixel_border, z_eps)
    sigmas = (sigma_pixel, sigma_pixel, sigma_depth)
    return (_weighted_rows_kernel_order(rho, d_res, sqc, sigmas, *p)
            + [zero] * 8)


def gram_calib_ref(rts, meas, img_size, pixel_border, z_eps, sigma_pixel,
                   sigma_depth, compute_dtype=torch.bfloat16):
    """Plain version of :func:`gram_calib`."""
    return _gram(calib_rows(rts, meas, img_size, pixel_border, z_eps,
                            sigma_pixel, sigma_depth),
                 as_dtype(compute_dtype))


def gram_path(compute_dtype) -> str:
    """The kernel path a CUDA call takes by default: ``"mma"`` for bfloat16
    rows, ``"tf32"`` for float32."""
    return "mma" if as_dtype(compute_dtype) == torch.bfloat16 else "tf32"


def host_reciprocal(sigma) -> float:
    """``RN(1 / sigma)`` in float32 from the float32 ``sigma``: what the
    correctly rounded row sequences take as their reciprocal sigmas (the
    ``"tf32"`` path, K4′b); a float64 quotient rounded to float32 can be an
    ulp off."""
    return float(np.float32(1) / np.float32(sigma))


def gram_rays(rts, meas, sigma_ray, sigma_dist,
              compute_dtype=torch.bfloat16, grid=None, path=None):
    """Per-edge Gram of the weighted ray-residual system.

    ``rts (E, 13)``: ``[s*R (row-major 9) | t (3) | edge_mask]`` of the
    relative pose ``T_i^{-1} T_j``; ``meas``: the 8 ray channels
    ``(mx, my, mz, di, conf, xj, yj, zj)``, each ``(E, N)``. ``grid``
    overrides the kernel's ``(blocks_per_edge, tiles_per_block)`` and
    ``path`` the kernel path (the Gram microbenchmark's sweeps and kernel
    timing; the solver passes neither)."""
    if rts.device.type == "cpu":
        return gram_rays_ref(rts, meas, sigma_ray, sigma_dist, compute_dtype)
    G = _launch(0, rts, meas, compute_dtype, path,
                (sigma_ray, sigma_dist, 0.0, 0.0, 0.0, 0.0, 0.0), grid)
    rays_counter.add()
    return G


def gram_calib(rts, meas, img_size, pixel_border, z_eps, sigma_pixel,
               sigma_depth, compute_dtype=torch.bfloat16, path=None):
    """Per-edge Gram of the weighted calibrated-residual system.

    ``rts (E, 17)``: ``[s*R | t | edge_mask | fx fy cx cy]``; ``meas``: the
    7 calib channels ``(ui, vi, logzi, conf, xj, yj, zj)``; ``img_size``
    ``(H, W)``. Rows 24+ of the result are zero. ``path`` as
    :func:`gram_rays`'."""
    if rts.device.type == "cpu":
        return gram_calib_ref(rts, meas, img_size, pixel_border, z_eps,
                              sigma_pixel, sigma_depth, compute_dtype)
    H_img, W_img = img_size
    G = _launch(1, rts, meas, compute_dtype, path,
                (sigma_pixel, sigma_depth, z_eps, pixel_border,
                 W_img - 1 - pixel_border, pixel_border,
                 H_img - 1 - pixel_border))
    calib_counter.add()
    return G


def gram_error(G, G_ref):
    """Largest entry-wise error of a Gram against a reference, each entry
    relative to the scale of its own two rows, ``|G - G_ref|_ab / (s_a
    s_b)``. A residual channel's rho row has the scale ``sqrt(G_ref_rr)``;
    its seven J rows share ``sqrt(max_k G_ref_kk)`` over those rows (the
    largest entry of the channel's J block), since some J rows are zero up
    to rounding (the distance residual's ``X' x r``). By Cauchy-Schwarz
    ``|G_ref_ab| <= s_a s_b``, so every channel's J block, its rho column
    and its (rho, rho) corner are held to their own size: a small channel
    (the distance or log-depth residual, orders of magnitude below the ray
    or pixel rows once whitened) cannot hide under the largest entry. An
    entry whose reference rows are zero must be exactly zero: else the
    error is infinite. Used to check the kernels, never on the solve's
    path."""
    G, R = G.double(), G_ref.double()
    diag = torch.diagonal(R, dim1=-2, dim2=-1).clamp_min(0.0)
    blocks = diag.unflatten(-1, (-1, 8))
    j_scale = blocks[..., :7].amax(-1, keepdim=True).expand_as(blocks[..., :7])
    d = torch.cat([j_scale, blocks[..., 7:]], -1).flatten(-2).sqrt()
    den = d[..., :, None] * d[..., None, :]
    diff = (G - R).abs()
    rel = torch.where(den > 0, diff / den.clamp_min(1e-300),
                      torch.where(diff > 0, math.inf, 0.0))
    return rel.max().item()


def grid_shape(E, N, sm_count, tile=THREADS):
    """``(blocks_per_edge, tiles_per_block)`` of the "fma" path and K4′:
    enough blocks to give every SM ``BLOCKS_PER_SM`` at small E, each
    walking a contiguous run of ``tile``-pixel tiles."""
    n_tiles = math.ceil(N / tile)
    want = max(1, min(n_tiles, math.ceil(BLOCKS_PER_SM * sm_count / E)))
    tiles = math.ceil(n_tiles / want)
    return math.ceil(n_tiles / tiles), tiles


def grid_wave(E, N, sm_count, blocks_per_sm, tile=THREADS):
    """``(blocks_per_edge, tiles_per_block)`` of a one-wave kernel: as many
    blocks per edge as one wave of ``blocks_per_sm * sm_count`` resident
    blocks holds (a second, part-filled wave would leave SMs idle while it
    runs), at least one; each walks a contiguous run of ``tile``-pixel
    tiles. The "mma" path's (:func:`grid_mma`) and K4′b's rows kernels'
    (``gram_variants``)."""
    n_tiles = math.ceil(N / tile)
    want = max(1, min(n_tiles, blocks_per_sm * sm_count // E))
    tiles = math.ceil(n_tiles / want)
    return math.ceil(n_tiles / tiles), tiles


def grid_mma(E, N, sm_count, blocks_per_sm):
    """``(blocks_per_edge, tiles_per_block)`` of the "mma" path:
    :func:`grid_wave` on 256-pixel tiles."""
    return grid_wave(E, N, sm_count, blocks_per_sm)


def check_inputs(rts, meas, n_ch, cols):
    """``(E, N, channel dtype, rts, meas)`` of a Gram kernel's inputs, made
    contiguous (float32 ``rts``); raises on a device other than CUDA, a
    wrong count, shape or type."""
    if rts.device.type != "cuda":
        raise ValueError(f"unsupported device {rts.device}")
    if len(meas) != n_ch:
        raise ValueError(f"expected {n_ch} measured channels, got "
                         f"{len(meas)}")
    if rts.ndim != 2 or rts.shape[1] != cols:
        raise ValueError(f"rts must be (E, {cols}), got {tuple(rts.shape)}")
    E = rts.shape[0]
    dt = meas[0].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"channels must be float32 or bfloat16, got {dt}")
    N = meas[0].shape[1] if meas[0].ndim == 2 else -1
    for ch in meas:
        if (ch.device != rts.device or ch.dtype != dt
                or tuple(ch.shape) != (E, N)):
            raise ValueError(
                f"every channel must be ({E}, N) {dt} on {rts.device}")
    if N <= 0:
        raise ValueError("no pixels")
    return (E, N, dt, rts.float().contiguous(),
            [ch.contiguous() for ch in meas])


_mma_blocks: dict[tuple, int] = {}


def mma_blocks_per_sm(device, kind, meas_bf16, path="mma") -> int:
    """Blocks of a tensor-core kernel for (kind, channel type) that one SM
    of ``device`` holds at once, as the CUDA occupancy calculator reports it
    for the built instance (cached). ``path`` "mma": kind 0 = K4, 1 = K5,
    2 = K4′c, 3 = K4′d (``gram_variants`` with bfloat16 rows); "tf32":
    kind 0 = K4, 1 = K5 with float32 rows."""
    key = (torch.device(device).index, path, kind, meas_bf16)
    if key not in _mma_blocks:
        lib = _lib()
        query = (lib.ba_gram_tf32_blocks_per_sm if path == "tf32"
                 else lib.ba_gram_mma_blocks_per_sm)
        with torch.cuda.device(device):
            n = query(kind, int(meas_bf16))
        if n <= 0:
            _build.check(lib, KERNEL, -n or 1)
        _mma_blocks[key] = n
    return _mma_blocks[key]


def _launch(kind, rts, meas, compute_dtype, path, scalars, grid=None):
    n_ch = 8 if kind == 0 else 7
    E, N, dt, rts, meas = check_inputs(rts, meas, n_ch,
                                       13 if kind == 0 else 17)
    cdt = as_dtype(compute_dtype)
    path = path or gram_path(cdt)
    if path not in PATHS or (path != "fma" and gram_path(cdt) != path):
        raise ValueError(f"path {path!r} does not take {cdt} rows")
    dev = rts.device
    mb = dt == torch.bfloat16
    sm = _build.sm_count(dev)
    ptrs = [ch.data_ptr() for ch in meas] + [None] * (8 - n_ch)
    sig0, sig1, *geom = (float(s) for s in scalars)
    # the C launchers run on the current device: make it the tensors'
    with torch.cuda.device(dev):
        if grid is None:
            grid = (grid_shape(E, N, sm) if path == "fma" else
                    grid_mma(E, N, sm, mma_blocks_per_sm(dev, kind, mb,
                                                         path)))
        bpe, tiles = grid
        partial = torch.empty(E, bpe, 32 * 32, dtype=torch.float32,
                              device=dev)
        G = torch.empty(E, 32, 32, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib = _lib()
        if path == "mma":
            err = lib.ba_gram_mma(
                kind, *ptrs, rts.data_ptr(), E, N, int(mb), bpe, tiles,
                1.0 / sig0, 1.0 / sig1, *geom,
                partial.data_ptr(), G.data_ptr(), stream)
        elif path == "tf32":
            err = lib.ba_gram_tf32(
                kind, *ptrs, rts.data_ptr(), E, N, int(mb), bpe, tiles,
                sig0, sig1, host_reciprocal(sig0), host_reciprocal(sig1),
                *geom, partial.data_ptr(), G.data_ptr(), stream)
        else:
            err = lib.ba_gram(
                kind, *ptrs, rts.data_ptr(), E, N, int(mb),
                int(cdt == torch.bfloat16), bpe, tiles, sig0, sig1, *geom,
                partial.data_ptr(), G.data_ptr(), stream)
    _build.check(lib, KERNEL, err)
    path_counters[path].add()
    return G


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ctypes signatures of csrc/ba_gram.cu's K4 / K5 entries
ENTRIES = {
    "ba_gram": [_I] + [_P] * 9 + [_I] * 6 + [_F] * 7 + [_P] * 3,
    "ba_gram_mma": [_I] + [_P] * 9 + [_I] * 5 + [_F] * 7 + [_P] * 3,
    "ba_gram_mma_blocks_per_sm": [_I, _I],
    "ba_gram_tf32": [_I] + [_P] * 9 + [_I] * 5 + [_F] * 9 + [_P] * 3,
    "ba_gram_tf32_blocks_per_sm": [_I, _I],
}


def _lib():
    return _build.load(KERNEL, ENTRIES)
