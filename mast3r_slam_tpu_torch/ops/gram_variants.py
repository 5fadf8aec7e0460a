"""The four bodies of the BA Gram microbenchmark (kernel K4′) and their
plain versions.

Counterpart of ``scripts/gram_kernel_bench.py``'s Pallas bodies, run by its
``run_variant``. Each is the floor of one stage of K4's work
(:func:`ba_kernels.gram_rays`) on the ray residual, from the same inputs:
``rts (E, 13)`` and the 8 ray channels ``(mx, my, mz, di, conf, xj, yj,
zj)``, each ``(E, N)`` float32 or bfloat16 (flat, as K4 takes them; the
TPU's sublane-split layout has no counterpart here).

- :func:`gram_load` (``_load_kernel``): the sum over pixels of the sum of
  the 8 channels, widened to float32, ``(E, 1, 1)``. The memory-read floor.
- :func:`gram_rows` (``_rows_kernel``): the sum of K4's 32 weighted rows,
  float32 and unrounded, ``(E, 1, 1)``. The row-arithmetic floor.
- :func:`gram_diag` (``_diag_kernel``): the rows rounded to
  ``compute_dtype`` and ``sum_d S_d S_dᵀ`` over the 4 residual channels,
  ``(E, 8, 8)``: only the blocks ``factor_graph._edge_blocks_from_gram``
  reads.
- :func:`gram_one_product` (``_gram32_kernel_2c``): the full 32x32 Gram of
  the rounded rows as one product, ``(E, 32, 32)``: K4's function.

Beside them, :func:`gram_rows_fast` (no TPU counterpart) is
:func:`gram_rows` on the row arithmetic of K4's tensor-core path: the two
rows floors side by side show what correct rounding costs.
:func:`gram_rows_first` runs :func:`gram_rows`' first kernel (timing and
tests only; no counter).

On CUDA tensors each launches its kernel in ``csrc/ba_gram.cu`` (entry
``ba_gram_variant``, the library K4 and K5 live in); on CPU tensors it
returns its plain version; any other device raises. With bfloat16 rows,
:func:`gram_diag` and :func:`gram_one_product` run K4's tensor-core kernel
with their own tile sets: K4's rows (``ba_kernels.rays_rows_kernel_order``
is their plain form), staging, sums and one-wave grid, so that they differ
from K4 in the tiles they compute alone. With float32 rows they run K4's
FMA kernel. :func:`gram_rows` computes the IEEE rows bit for bit with
nvcc's fast sequences and one range guard a pixel, on a one-wave grid
(:func:`grid_rows`), taking its sigmas' float32 reciprocals
(:func:`host_reciprocal`); :func:`gram_rows_fast` runs the same kernel on
K4's arithmetic. The plain versions take ``ba_kernels``' IEEE row
arithmetic, as the JAX bodies do, and sum in float64;
:func:`diag_of_rows` is the diagonal-block Gram of any 32 rows.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mast3r_slam_tpu_torch import _build
from mast3r_slam_tpu_torch.ops import ba_kernels as BA
from mast3r_slam_tpu_torch.ops.ba_kernels import host_reciprocal

KERNEL = BA.KERNEL
load_counter = _build.LaunchCounter()
rows_counter = _build.LaunchCounter()
diag_counter = _build.LaunchCounter()
one_product_counter = _build.LaunchCounter()
rows_fast_counter = _build.LaunchCounter()
_KINDS = {"load": (0, load_counter), "rows": (1, rows_counter),
          "diag": (2, diag_counter), "one_product": (3, one_product_counter),
          "rows_fast": (4, rows_fast_counter), "rows_first": (5, None)}
ROW_SUMS = ("rows", "rows_fast", "rows_first")   # kinds 1, 4 and 5


def gram_load_ref(rts, meas):
    """Plain version of :func:`gram_load`."""
    total = sum(ch.double() for ch in meas)
    return total.sum(-1).float().reshape(-1, 1, 1)


def gram_rows_ref(rts, meas, sigma_ray, sigma_dist):
    """Plain version of :func:`gram_rows`."""
    rows = BA.rays_rows(rts, meas, sigma_ray, sigma_dist)
    total = sum(r.double() for r in rows)
    return total.sum(-1).float().reshape(-1, 1, 1)


def gram_rows_fast_ref(rts, meas, sigma_ray, sigma_dist):
    """Plain version of :func:`gram_rows_fast`."""
    rows = BA.rays_rows_kernel_order(rts, meas, sigma_ray, sigma_dist)
    total = sum(r.double() for r in rows)
    return total.sum(-1).float().reshape(-1, 1, 1)


def abs_sum(rts, meas, *sigmas):
    """Σ|terms| in float64, ``(E, 1, 1)``, of :func:`gram_load` (no sigmas:
    the channels) or :func:`gram_rows` / :func:`gram_rows_fast`
    (``sigma_ray, sigma_dist``: the 32 rows): the scale their float32 sums
    are held to, since the order of a float32 sum is the kernel's own."""
    terms = BA.rays_rows(rts, meas, *sigmas) if sigmas else meas
    return sum(t.double().abs() for t in terms).sum(-1).reshape(-1, 1, 1)


def one_live_pixel(meas, seed=0):
    """The 8 ray channels with every confidence (``meas[4]``) 0 but one
    pixel an edge, which keeps its own: a pixel of nonzero confidence drawn
    by ``numpy.random.default_rng(seed)`` (any pixel where an edge has
    none). Each edge's row sum is then that pixel's 32-row sum (every other
    pixel's rows are exactly 0), whatever a kernel's grid or summation
    order: two kernels of one row arithmetic must agree bit for bit.
    Returns ``(channels, live pixel of each edge)``."""
    conf = meas[4]
    keys = torch.from_numpy(np.random.default_rng(seed).random(
        tuple(conf.shape))).to(conf.device)
    live = torch.where(conf != 0, keys, -1.0).argmax(-1)
    rows = torch.arange(conf.shape[0], device=conf.device)
    one = torch.zeros_like(conf)
    one[rows, live] = conf[rows, live]
    return list(meas[:4]) + [one] + list(meas[5:]), live


def diag_of_rows(rows, compute_dtype):
    """``sum_d S_d S_dᵀ`` of the 32 rows rounded to ``compute_dtype``, in
    float64 and rounded to float32 once, ``(E, 8, 8)``."""
    cdt = BA.as_dtype(compute_dtype)
    S = torch.stack([r.to(cdt) for r in rows], dim=1).double()
    S = S.unflatten(1, (4, 8))
    return (S @ S.transpose(-1, -2)).sum(1).float()


def gram_diag_ref(rts, meas, sigma_ray, sigma_dist,
                  compute_dtype=torch.bfloat16):
    """Plain version of :func:`gram_diag`."""
    return diag_of_rows(BA.rays_rows(rts, meas, sigma_ray, sigma_dist),
                        compute_dtype)


def gram_one_product_ref(rts, meas, sigma_ray, sigma_dist,
                         compute_dtype=torch.bfloat16):
    """Plain version of :func:`gram_one_product` (``gram_rays_ref``)."""
    return BA.gram_rays_ref(rts, meas, sigma_ray, sigma_dist, compute_dtype)


def gram_load(rts, meas):
    """Sum of the 8 channels over each edge's pixels, ``(E, 1, 1)``."""
    if rts.device.type == "cpu":
        return gram_load_ref(rts, meas)
    return _launch("load", rts, meas, 1.0, 1.0, torch.float32)  # no sigmas


def gram_rows(rts, meas, sigma_ray, sigma_dist, grid=None):
    """Sum of K4's 32 float32 weighted rows over each edge's pixels,
    ``(E, 1, 1)``. ``grid`` overrides the kernel's ``(blocks_per_edge,
    tiles_per_block)``, as :func:`gram_diag`'s does."""
    if rts.device.type == "cpu":
        return gram_rows_ref(rts, meas, sigma_ray, sigma_dist)
    return _launch("rows", rts, meas, sigma_ray, sigma_dist, torch.float32,
                   grid)


def gram_rows_fast(rts, meas, sigma_ray, sigma_dist, grid=None):
    """:func:`gram_rows` on the "mma" path's row arithmetic
    (``ba_kernels.rays_rows_kernel_order``): the floor of that path's row
    stage, ``(E, 1, 1)``. Not a TPU kernel: the benchmark's probe of where
    the row stage's time goes. ``grid`` as :func:`gram_rows`'."""
    if rts.device.type == "cpu":
        return gram_rows_fast_ref(rts, meas, sigma_ray, sigma_dist)
    return _launch("rows_fast", rts, meas, sigma_ray, sigma_dist,
                   torch.float32, grid)


def gram_rows_first(rts, meas, sigma_ray, sigma_dist, grid=None):
    """:func:`gram_rows`' first kernel (IEEE operations with their
    per-operation checks, ``ba_kernels.grid_shape``'s grid) on CUDA
    tensors; timing and tests only, no launch counter."""
    return _launch("rows_first", rts, meas, sigma_ray, sigma_dist,
                   torch.float32, grid)


def gram_diag(rts, meas, sigma_ray, sigma_dist, compute_dtype=torch.bfloat16,
              grid=None):
    """``sum_d S_d S_dᵀ`` of the rows rounded to ``compute_dtype``,
    ``(E, 8, 8)``: the sum of K4's four diagonal 8x8 blocks. ``grid``
    overrides the kernel's ``(blocks_per_edge, tiles_per_block)``, as
    ``ba_kernels.gram_rays``' does."""
    if rts.device.type == "cpu":
        return gram_diag_ref(rts, meas, sigma_ray, sigma_dist, compute_dtype)
    return _launch("diag", rts, meas, sigma_ray, sigma_dist, compute_dtype,
                   grid)


def gram_one_product(rts, meas, sigma_ray, sigma_dist,
                     compute_dtype=torch.bfloat16, grid=None):
    """The full Gram ``S Sᵀ`` of the rounded rows, ``(E, 32, 32)``, every
    entry its own product. ``grid`` as :func:`gram_diag`'s."""
    if rts.device.type == "cpu":
        return gram_one_product_ref(rts, meas, sigma_ray, sigma_dist,
                                    compute_dtype)
    return _launch("one_product", rts, meas, sigma_ray, sigma_dist,
                   compute_dtype, grid)


def tile_pixels(name, N, vp):
    """Pixels of one tile of kernel ``name``: the reductions read ``vp``
    pixels of each channel a thread (:func:`vec_pixels`) when N is a
    multiple of that, else one; the Gram kernels one pixel."""
    if name in ("load",) + ROW_SUMS and N % vp == 0:
        return BA.THREADS * vp
    return BA.THREADS


def grid_rows(E, N, sm_count, blocks_per_sm, vp):
    """``(blocks_per_edge, tiles_per_block)`` of :func:`gram_rows` and
    :func:`gram_rows_fast`: one wave of the built instance's
    ``blocks_per_sm`` (``ba_kernels.grid_wave``) over their tiles of
    ``tile_pixels("rows", N, vp)`` pixels."""
    return BA.grid_wave(E, N, sm_count, blocks_per_sm,
                        tile_pixels("rows", N, vp))


_vec_pixels: dict[tuple, int] = {}
_rows_blocks: dict[tuple, int] = {}


def _query(cache, key, fn, *args):
    """``fn(*args)`` of the library, cached under ``key``; a negative
    answer is minus a ``cudaError_t`` and raises."""
    if key not in cache:
        n = fn(*args)
        if n <= 0:
            _build.check(_lib(), KERNEL, -n or 1)
        cache[key] = n
    return cache[key]


def vec_pixels(kind, meas_bf16) -> int:
    """Pixels a thread reads of each channel a tile on the vector path of
    reduction kind ``kind`` (cached)."""
    return _query(_vec_pixels, (kind, meas_bf16),
                  _lib().ba_gram_variant_vec_pixels, kind, int(meas_bf16))


def rows_blocks_per_sm(device, kind, meas_bf16, vec) -> int:
    """Blocks of the rows kernel (kind 1 or 4) for the channel type and
    path that one SM of ``device`` holds at once, as the CUDA occupancy
    calculator reports it for the built instance (cached)."""
    key = (torch.device(device).index, kind, meas_bf16, vec)
    with torch.cuda.device(device):
        return _query(_rows_blocks, key, _lib().ba_gram_rows_blocks_per_sm,
                      kind, int(meas_bf16), int(vec))


def _launch(name, rts, meas, sigma_ray, sigma_dist, compute_dtype,
            grid=None):
    kind, counter = _KINDS[name]
    E, N, dt, rts, meas = BA.check_inputs(rts, meas, 8, 13)
    meas = [_build.aligned(ch) for ch in meas]
    cdt = BA.as_dtype(compute_dtype)
    dev = rts.device
    mb = dt == torch.bfloat16
    sm = _build.sm_count(dev)
    reduce = name in ("load",) + ROW_SUMS
    vp = vec_pixels(kind, mb) if reduce else 1
    if grid is None:
        if name in ("rows", "rows_fast"):
            bps = rows_blocks_per_sm(dev, kind, mb, N % vp == 0)
            grid = grid_rows(E, N, sm, bps, vp)
        elif name in ("diag", "one_product") and cdt == torch.bfloat16:
            # K4's tensor-core kernel: one wave of its resident blocks
            grid = BA.grid_mma(E, N, sm, BA.mma_blocks_per_sm(dev, kind, mb))
        else:
            grid = BA.grid_shape(E, N, sm, tile_pixels(name, N, vp))
    bpe, tiles = grid
    partial = torch.empty(E, bpe, 32 * 32, dtype=torch.float32, device=dev)
    shape = {"diag": (E, 8, 8), "one_product": (E, 32, 32)}.get(name,
                                                               (E, 1, 1))
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    scratch = (torch.empty(E, 32, 32, dtype=torch.float32, device=dev)
               if name == "diag" and cdt == torch.float32 else None)
    # the rows kernels take float32 reciprocals; K4'c / K4'd K4's own
    if name in ROW_SUMS:
        sinv = (host_reciprocal(sigma_ray), host_reciprocal(sigma_dist))
    else:
        sinv = (1.0 / float(sigma_ray), 1.0 / float(sigma_dist))
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.ba_gram_variant(
            kind, *(ch.data_ptr() for ch in meas), rts.data_ptr(), E, N,
            int(mb), int(cdt == torch.bfloat16), bpe, tiles,
            float(sigma_ray), float(sigma_dist), *sinv, partial.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, KERNEL, err)
    if counter is not None:
        counter.add()
    return out


def rn_mismatches(op, lo, hi, sigma=1.0, device="cuda"):
    """Floats with bits in ``[lo, hi]`` (unsigned 32-bit patterns) at which
    the rows kernel's sequence ``op`` (0 sqrt, 1 reciprocal, 2 ``x /
    sigma`` from :func:`host_reciprocal`, 3 ``HUBER_K / x``) differs in any
    bit from the IEEE operation, counted on the card (a check of the
    sequences; no path calls it)."""
    count = torch.zeros(1, dtype=torch.int64, device=device)
    lo, hi = (int(np.uint32(b).view(np.int32)) for b in (lo, hi))
    lib = _lib()
    with torch.cuda.device(count.device):
        err = lib.ba_gram_rn_mismatches(
            op, lo, hi, float(sigma), host_reciprocal(sigma),
            count.data_ptr(),
            torch.cuda.current_stream(count.device).cuda_stream)
    _build.check(lib, KERNEL, err)
    return int(count.item())


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ctypes signature of csrc/ba_gram.cu's K4′ entry
ENTRIES = {"ba_gram_variant": [_I] + [_P] * 9 + [_I] * 6 + [_F] * 4
           + [_P] * 4,
           "ba_gram_rows_blocks_per_sm": [_I] * 3,
           "ba_gram_variant_vec_pixels": [_I] * 2,
           "ba_gram_rn_mismatches": [_I] * 3 + [_F] * 2 + [_P] * 2}


def _lib():
    return _build.load(KERNEL, ENTRIES)
