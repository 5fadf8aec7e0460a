"""Port parity: the plain versions of K4 ``gram_rays`` and K5 ``gram_calib``
(mast3r_slam_tpu_torch/ops/ba_kernels.py) vs the JAX package's Pallas
kernels run in interpret mode, and vs its XLA edge system
(``_edge_system_fused``) through ``_edge_blocks_from_gram``.

The Grams are compared entry by entry, each entry against the scale of its
own two rows (``ba_kernels.gram_error``), so the distance and log-depth
blocks, orders of magnitude below the ray and pixel blocks, are held to
their own size. Tolerances: 1e-5 with float32 rows (f32 summation order;
1.1e-6 measured), 1e-4 with bfloat16 rows, where a weight one f32 ulp apart
can round its row to the neighbouring bf16 value (1.5e-5 measured)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import ba_kernels as JK
from mast3r_slam_tpu.ops import geometry as JG
from mast3r_slam_tpu.ops.robust import huber as j_huber
from mast3r_slam_tpu.slam import factor_graph as JFG
from mast3r_slam_tpu_torch.ops import ba_kernels as TK
from mast3r_slam_tpu_torch.slam import factor_graph as TFG
from torch_parity import torch_one_thread  # noqa: F401
from torch_parity import ba_edges

SIGMAS_RAYS = (0.003, 10.0)
K = np.asarray([[40.0, 0.0, 16.0], [0.0, 40.0, 12.0], [0.0, 0.0, 1.0]],
               np.float32)
CALIB_ARGS = ((24, 32), 2.0, 1e-6, 1.0, 0.1)
TOL = {"float32": 1e-5, "bfloat16": 1e-4}


def _problem(kind, seed, meas_dtype):
    """JAX premeas channels and kernel rows, in ``meas_dtype``."""
    T, X, Cavg, ii, jj, idx, valid, Q, mask = (jnp.asarray(a) for a in
                                                ba_edges(seed))
    if kind == "rays":
        meas = JFG._premeas_rays(X, Cavg, ii, jj, idx, valid, Q, 0.5, 0.5)
        Ti, rts = JFG._rel_pose_rows(T, ii, jj, mask)
    else:
        meas = JFG._premeas_calib(X, Cavg, ii, jj, idx, valid, Q, 32, 1e-6,
                                  0.5, 0.5)
        Ti, rts = JFG._rel_pose_rows(T, ii, jj, mask,
                                     extra=JG.decompose_K(jnp.asarray(K)))
    meas = tuple(ch.astype(meas_dtype) for ch in meas)
    return T, ii, jj, mask, meas, Ti, rts


def _to_torch(meas, rts):
    tm = tuple(torch.from_numpy(np.array(ch, np.float32)).to(
        TK.as_dtype(str(ch.dtype))) for ch in meas)
    return tm, torch.from_numpy(np.array(rts))


def _jax_gram(kind, rts, meas, cdt, monkeypatch):
    monkeypatch.setattr(JK, "_TNL", 128)
    if kind == "rays":
        return JK.gram_rays(rts, meas, *SIGMAS_RAYS, compute_dtype=cdt,
                            interpret=True)
    return JK.gram_calib(rts, meas, *CALIB_ARGS, compute_dtype=cdt,
                         interpret=True)


def _port_gram(kind, rts, meas, cdt):
    if kind == "rays":
        return TK.gram_rays(rts, meas, *SIGMAS_RAYS, compute_dtype=cdt)
    return TK.gram_calib(rts, meas, *CALIB_ARGS, compute_dtype=cdt)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("meas_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_gram_plain_version_matches_pallas_kernel(kind, meas_dtype, compute,
                                                   monkeypatch):
    *_, meas, _, rts = _problem(kind, 3, jnp.dtype(meas_dtype))
    G_j = np.asarray(_jax_gram(kind, rts, meas, jnp.dtype(compute),
                               monkeypatch))
    before = (TK.rays_counter.launches, TK.calib_counter.launches)
    tm, trts = _to_torch(meas, rts)
    G_t = _port_gram(kind, trts, tm, compute).numpy()
    assert (TK.rays_counter.launches, TK.calib_counter.launches) == before
    assert G_t.shape == G_j.shape == (meas[0].shape[0], 32, 32)
    assert np.abs(G_j).max() > 0
    err = TK.gram_error(torch.from_numpy(G_t), torch.from_numpy(G_j))
    assert err <= TOL[compute], err
    if kind == "calib":
        assert not G_t[:, 24:].any() and not G_t[:, :, 24:].any()


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("meas_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_kernel_order_rows_match_pallas_kernel(kind, meas_dtype, compute,
                                               monkeypatch):
    """The "mma" path's row arithmetic in plain form (rsqrt norm, reciprocal
    sigmas, the Huber weight's square root as ``sqrt(k) rsqrt(w)``): its
    Gram holds to the JAX kernel at the plain version's tolerances, so a
    slip in the rewrite fails here."""
    *_, meas, _, rts = _problem(kind, 3, jnp.dtype(meas_dtype))
    G_j = torch.from_numpy(np.asarray(_jax_gram(
        kind, rts, meas, jnp.dtype(compute), monkeypatch)))
    tm, trts = _to_torch(meas, rts)
    if kind == "rays":
        rows = TK.rays_rows_kernel_order(trts, tm, *SIGMAS_RAYS)
    else:
        rows = TK.calib_rows_kernel_order(trts, tm, *CALIB_ARGS)
    G_t = TK._gram(rows, TK.as_dtype(compute))
    assert TK.gram_error(G_t, G_j) <= TOL[compute]
    if kind == "calib":
        assert not G_t[:, 24:].any() and not G_t[:, :, 24:].any()


def _xla_system(kind, T, ii, jj, mask, meas, compute):
    if kind == "rays":
        rho, d_res, Xp, sw, adj_inv = JFG._edge_terms_rays(
            T, ii, jj, meas, *SIGMAS_RAYS)
    else:
        rho, d_res, Xp, sw, adj_inv = JFG._edge_terms_calib(
            T, ii, jj, meas, jnp.asarray(K), *CALIB_ARGS)
    c = [sw[i] * sw[i] * j_huber(sw[i] * rho[i]) * mask[:, None]
         for i in range(len(rho))]
    return JFG._edge_system_fused(rho, d_res, Xp, c, adj_inv,
                                  compute_dtype=jnp.dtype(compute))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_edge_blocks_match_xla_edge_system(kind, compute):
    """Port Gram → ``_edge_blocks_from_gram`` gives the XLA edge system's
    world-frame H, g and cost."""
    T, ii, jj, mask, meas, Ti, rts = _problem(kind, 4, jnp.float32)
    H_x, g_x, c_x = (np.asarray(a) for a in
                     _xla_system(kind, T, ii, jj, mask, meas, compute))
    tm, trts = _to_torch(meas, rts)
    G = _port_gram(kind, trts, tm, compute)
    H_t, g_t, c_t = TFG._edge_blocks_from_gram(
        G, 4 if kind == "rays" else 3, torch.from_numpy(np.array(Ti)))
    tol = 2e-2 if compute == "bfloat16" else 1e-4
    for got, want in ((H_t, H_x), (g_t, g_x), (c_t, c_x)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())


def test_edge_blocks_from_gram_matches_jax(monkeypatch):
    """The same Gram through both packages' extraction: float32 rounding."""
    _, _, _, _, meas, Ti, rts = _problem("rays", 5, jnp.float32)
    G = _jax_gram("rays", rts, meas, jnp.float32, monkeypatch)
    want = JFG._edge_blocks_from_gram(G, 4, Ti)
    got = TFG._edge_blocks_from_gram(torch.from_numpy(np.array(G)), 4,
                                     torch.from_numpy(np.array(Ti)))
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("fault", ["distance rows zeroed",
                                   "distance rho negated",
                                   "log-depth rows zeroed",
                                   "log-depth rho negated"])
def test_gram_error_catches_a_fault_in_a_small_block(fault):
    """A Gram that drops or flips the distance (K4 rows 24-31) or log-depth
    (K5 rows 16-23) residual fails ``gram_error`` at the bf16 tolerance,
    though with config/base.yaml's sigmas those blocks sit far below
    max|G|."""
    kind = "rays" if fault.startswith("distance") else "calib"
    lo = 24 if kind == "rays" else 16
    *_, meas, _, rts = _problem(kind, 3, jnp.float32)
    tm, trts = _to_torch(meas, rts)
    if kind == "rays":
        G = TK.gram_rays(trts, tm, 0.003, 10.0, compute_dtype="float32")
    else:
        G = TK.gram_calib(trts, tm, *CALIB_ARGS[:3], 1.0, 10.0,
                          compute_dtype="float32")
    bad = G.clone()
    if fault.endswith("zeroed"):
        bad[:, lo:lo + 8] = 0.0
        bad[:, :, lo:lo + 8] = 0.0
    else:
        bad[:, lo + 7] *= -1.0
        bad[:, :, lo + 7] *= -1.0
    assert (bad - G).abs().max() <= 2e-2 * G.abs().max()   # hidden globally
    assert TK.gram_error(bad, G) > 100 * TOL["bfloat16"]


def test_grid_covers_every_tile():
    """The kernel's grid: every 256-pixel tile of an edge is walked by
    exactly one block, at the small and the large edge counts."""
    for E in (1, 2, 16, 128, 300):
        for N in (1, 255, 256, 257, 98_304, 196_608):
            bpe, tiles = TK.grid_shape(E, N, 132)
            n_tiles = -(-N // 256)
            assert bpe * tiles >= n_tiles > (bpe - 1) * tiles
            assert bpe >= 1 and tiles >= 1


def _mma_pixels(bpe, tiles, N):
    """Pixels each block of the "mma" kernel visits, by its loop bounds
    (csrc/ba_gram.cu, gram_tc_kernel): tile t gives warp w the 32 pixels
    from 256 t + 32 w, for t below the block's end and below the first
    tile whose chunk for w starts at or past N."""
    seen = np.zeros(N, np.int64)
    for b in range(bpe):
        for w in range(8):
            t_lim = int((N - 32 * w + 255) / 256)   # C division truncates
            for t in range(b * tiles, min(t_lim, b * tiles + tiles)):
                p = np.arange(t * 256 + 32 * w, t * 256 + 32 * w + 32)
                np.add.at(seen, p[p < N], 1)
    return seen


@pytest.mark.parametrize("blocks_per_sm", [1, 2, 3, 4])
def test_mma_grid_covers_every_pixel_once(blocks_per_sm):
    """The "mma" path's planner: no block is empty, the blocks cover every
    256-pixel tile, and the kernel's per-warp bounds visit every pixel
    exactly once; at most one wave of resident blocks where the edges
    allow it; E up to 65,535 (CUDA's grid y limit) fits."""
    for E in (1, 2, 5, 16, 128, 300, 1000, 65_535):
        for N in (1, 7, 255, 256, 257, 1000, 98_304, 196_608):
            bpe, tiles = TK.grid_mma(E, N, 132, blocks_per_sm)
            n_tiles = -(-N // 256)
            assert bpe >= 1 and tiles >= 1
            assert bpe * tiles >= n_tiles > (bpe - 1) * tiles
            assert E * bpe <= max(E, blocks_per_sm * 132)
            assert bpe < 2**31 and E <= 65_535
            if N <= 1000 and E <= 16:
                assert (_mma_pixels(bpe, tiles, N) == 1).all()
    assert TK.grid_mma(128, 98_304, 132, 2) == (2, 192)


def test_gram_path_by_row_type():
    """bf16 rows take the tensor-core path, f32 rows the 3xTF32 one."""
    assert TK.gram_path(torch.bfloat16) == TK.gram_path("bfloat16") == "mma"
    assert TK.gram_path(torch.float32) == "tf32"
    assert set(TK.path_counters) == set(TK.PATHS) == {"mma", "tf32", "fma"}


def _rows(kind, trts, tm):
    if kind == "rays":
        return TK.rays_rows(trts, tm, *SIGMAS_RAYS)
    return TK.calib_rows(trts, tm, *CALIB_ARGS)


@pytest.mark.parametrize("meas_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_tf32x3_gram_matches_pallas_kernel(kind, meas_dtype, monkeypatch):
    """The "tf32" path's product in plain form (``gram_tf32x3``: the f32
    rows split into TF32 parts, three products) against the JAX kernel with
    float32 rows, at the f32 rows' tolerance."""
    *_, meas, _, rts = _problem(kind, 3, jnp.dtype(meas_dtype))
    G_j = torch.from_numpy(np.asarray(_jax_gram(
        kind, rts, meas, jnp.float32, monkeypatch)))
    tm, trts = _to_torch(meas, rts)
    G_t = TK.gram_tf32x3(_rows(kind, trts, tm))
    assert G_t.dtype == torch.float32 and G_t.shape == G_j.shape
    assert TK.gram_error(G_t, G_j) <= TOL["float32"]
    if kind == "calib":
        assert not G_t[:, 24:].any() and not G_t[:, :, 24:].any()


@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_tf32x3_gram_against_float64(kind):
    """Against the float64 Gram of the same f32 rows: each product off by
    about 3 2^-22 of its size, so every entry within 2^-20 of its rows'
    scale (``gram_error``). Measured (seed 3, CPU): 9.2e-8 for both kinds,
    against 4.8e-8 / 5.2e-8 for the f32 rows' exact Gram rounded once
    (``_gram``)."""
    *_, meas, _, rts = _problem(kind, 3, jnp.float32)
    tm, trts = _to_torch(meas, rts)
    rows = _rows(kind, trts, tm)
    S = torch.stack(rows, dim=1).double()
    G64 = S @ S.transpose(1, 2)
    err = TK.gram_error(TK.gram_tf32x3(rows), G64)
    assert err <= 2.0 ** -20
