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
rows floors side by side show what the IEEE divisions and square roots
cost.

On CUDA tensors each launches its kernel in ``csrc/ba_gram.cu`` (entry
``ba_gram_variant``, the library K4 and K5 live in); on CPU tensors it
returns its plain version; any other device raises. With bfloat16 rows,
:func:`gram_diag` and :func:`gram_one_product` run K4's tensor-core kernel
with their own tile sets: K4's rows (``ba_kernels.rays_rows_kernel_order``
is their plain form), staging, sums and one-wave grid, so that they differ
from K4 in the tiles they compute alone. With float32 rows they run K4's
FMA kernel. The plain versions take ``ba_kernels``' IEEE row arithmetic, as
the JAX bodies do, and sum in float64; :func:`diag_of_rows` is the
diagonal-block Gram of any 32 rows.
"""

from __future__ import annotations

import ctypes

import torch

from mast3r_slam_tpu_torch import _build
from mast3r_slam_tpu_torch.ops import ba_kernels as BA

KERNEL = BA.KERNEL
load_counter = _build.LaunchCounter()
rows_counter = _build.LaunchCounter()
diag_counter = _build.LaunchCounter()
one_product_counter = _build.LaunchCounter()
rows_fast_counter = _build.LaunchCounter()
_KINDS = {"load": (0, load_counter), "rows": (1, rows_counter),
          "diag": (2, diag_counter), "one_product": (3, one_product_counter),
          "rows_fast": (4, rows_fast_counter)}


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


def gram_rows(rts, meas, sigma_ray, sigma_dist):
    """Sum of K4's 32 float32 weighted rows over each edge's pixels,
    ``(E, 1, 1)``."""
    if rts.device.type == "cpu":
        return gram_rows_ref(rts, meas, sigma_ray, sigma_dist)
    return _launch("rows", rts, meas, sigma_ray, sigma_dist, torch.float32)


def gram_rows_fast(rts, meas, sigma_ray, sigma_dist):
    """:func:`gram_rows` on the "mma" path's row arithmetic
    (``ba_kernels.rays_rows_kernel_order``): the floor of that path's row
    stage, ``(E, 1, 1)``. Not a TPU kernel: the benchmark's probe of where
    the row stage's time goes."""
    if rts.device.type == "cpu":
        return gram_rows_fast_ref(rts, meas, sigma_ray, sigma_dist)
    return _launch("rows_fast", rts, meas, sigma_ray, sigma_dist,
                   torch.float32)


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


def _tile_pixels(kind, N, meas_dtype):
    """Pixels of one tile of kind ``kind``'s kernel: the reductions read 16
    bytes of each channel a thread (8 bf16 or 4 f32 pixels) when N is a
    multiple of that, else one pixel; the Gram kernels one pixel."""
    if kind in ("load", "rows", "rows_fast"):
        vw = 8 if meas_dtype == torch.bfloat16 else 4
        if N % vw == 0:
            return BA.THREADS * vw
    return BA.THREADS


def _launch(name, rts, meas, sigma_ray, sigma_dist, compute_dtype,
            grid=None):
    kind, counter = _KINDS[name]
    E, N, dt, rts, meas = BA.check_inputs(rts, meas, 8, 13)
    meas = [_build.aligned(ch) for ch in meas]
    cdt = BA.as_dtype(compute_dtype)
    dev = rts.device
    mb = dt == torch.bfloat16
    sm = _build.sm_count(dev)
    if grid is None:
        if name in ("diag", "one_product") and cdt == torch.bfloat16:
            # K4's tensor-core kernel: one wave of its resident blocks
            grid = BA.grid_mma(E, N, sm, BA.mma_blocks_per_sm(dev, kind, mb))
        else:
            grid = BA.grid_shape(E, N, sm, _tile_pixels(name, N, dt))
    bpe, tiles = grid
    partial = torch.empty(E, bpe, 32 * 32, dtype=torch.float32, device=dev)
    shape = {"load": (E, 1, 1), "rows": (E, 1, 1), "rows_fast": (E, 1, 1),
             "diag": (E, 8, 8), "one_product": (E, 32, 32)}[name]
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    scratch = (torch.empty(E, 32, 32, dtype=torch.float32, device=dev)
               if name == "diag" and cdt == torch.float32 else None)
    lib = _lib()
    err = lib.ba_gram_variant(
        kind, *(ch.data_ptr() for ch in meas), rts.data_ptr(), E, N,
        int(mb), int(cdt == torch.bfloat16), bpe, tiles,
        float(sigma_ray), float(sigma_dist), 1.0 / float(sigma_ray),
        1.0 / float(sigma_dist), partial.data_ptr(),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, KERNEL, err)
    counter.add()
    return out


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ctypes signature of csrc/ba_gram.cu's K4′ entry
ENTRIES = {"ba_gram_variant": [_I] + [_P] * 9 + [_I] * 6 + [_F] * 4
           + [_P] * 4}


def _lib():
    return _build.load(KERNEL, ENTRIES)
