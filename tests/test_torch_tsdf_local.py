"""The port's local TSDF refiner (``mast3r_slam_tpu_torch/services/
tsdf_local.py``) against the JAX package's on the CPU.

The device functions take the same numpy-seeded inputs in both packages:
tsdf and weight within 1e-5, refined masks equal, new points within 1e-5,
at G = 16 and at the shipped G = 64 (with samples past the far face, where
the clamp to ``G - 1.000001`` rounds to ``G - 1`` and the corner rows wrap,
and with non-finite points and cells), against the JAX raycast with
``cell_walk_k`` 0 and 16 (the port's dense gather for both). Where a
projected pixel or a first crossing could part through float32 rounding,
the parting voxels or points are counted and bounded at 0.1%
(``MAX_PARTING``). Then the scheduler's
block selection and one synchronous ``_refine_blocks`` in both packages,
and counterparts of the local tests of tests/test_tsdf.py.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import lie as JL
from mast3r_slam_tpu.services import tsdf_local as J
from mast3r_slam_tpu_torch.ops import lie as TL
from mast3r_slam_tpu_torch.services import tsdf_local as T
from torch_parity import keyframe_pair, torch_one_thread  # noqa: F401

ATOL = 1e-5
MAX_PARTING = 1e-3
WAIT_S = 30.0
RNG = np.random.default_rng(5)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _nan_close(got, want, atol=ATOL):
    """Fraction of entries that part: NaN in one and not the other, or
    unequal and further apart than ``atol``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    with np.errstate(invalid="ignore"):
        same = ((got == want) | (np.isnan(got) & np.isnan(want))
                | (np.abs(got - want) <= atol))
    return (~same).mean()


def _pose(seed=0):
    rng = np.random.default_rng(seed)
    T_ = np.concatenate([rng.normal(size=3) * 0.03,
                         [0, 0, 0, 1] + rng.normal(size=4) * 0.01, [1.04]])
    T_[3:7] /= np.linalg.norm(T_[3:7])
    return T_.astype(np.float32)


def _pointmap(H=48, W=64, f=40.0, nonfinite=0, seed=0):
    """Pixel-ordered camera-frame pointmap of a rippled plane at depth ~1,
    with ``nonfinite`` NaN / inf points."""
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    z = 1.0 + 0.05 * np.sin(u / 7.0) * np.cos(v / 5.0)
    X = np.stack([(u - (W - 1) / 2) / f * z, (v - (H - 1) / 2) / f * z, z],
                 -1).reshape(-1, 3).astype(np.float32)
    idx = rng.choice(H * W, nonfinite, replace=False)
    X[idx[: nonfinite // 2]] = np.nan
    X[idx[nonfinite // 2:], 2] = np.inf
    return X, (H, W)


@pytest.mark.parametrize("start,stop,num", [(-1.0, 1.0, 16), (-1.0, 1.0, 8),
                                            (-0.1, 0.1, 64), (-0.1, 0.1, 16),
                                            (-0.08, 0.08, 32)])
def test_linspace_is_the_jax_packages(start, stop, num):
    np.testing.assert_array_equal(T._linspace(start, stop, num, "cpu").numpy(),
                                  np.asarray(jnp.linspace(start, stop, num)))


# ---------------------------------------------------------------------------
# Device functions against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [16, 64])
def test_scatter_build_matches_jax(G):
    pts = _pointmap()[0][::3]
    conf = RNG.uniform(0.3, 1.0, pts.shape[0]).astype(np.float32)
    origin = np.array([0.01, -0.02, 0.0], np.float32)
    go = np.array([-0.3, -0.3, 0.8], np.float32)
    voxel, trunc, S = 0.6 / G, 0.08, 16
    tj, wj = J.build_block_tsdf(jnp.asarray(pts), jnp.asarray(conf),
                                jnp.asarray(origin), jnp.asarray(go), voxel,
                                trunc, G, S)
    tt, wt = T.build_block_tsdf(_t(pts), _t(conf), _t(origin), _t(go), voxel,
                                trunc, G, S)
    assert (np.asarray(wj) > 0).sum() > 100
    assert _nan_close(tt.numpy(), tj) == 0
    assert _nan_close(wt.numpy(), wj) == 0


@pytest.mark.parametrize("G", [16, 64])
def test_projective_build_matches_jax(G):
    """Batched projective builds under a rotated, scaled pose, with NaN and
    inf points in the pointmap. Voxels whose projected pixel parts through
    float32 rounding would show as partings; none do here."""
    X, hw = _pointmap(nonfinite=40)
    conf = RNG.uniform(0.5, 1.0, X.shape[0]).astype(np.float32)
    Tw = _pose(1)
    origins = np.array([[-0.5, -0.5, 0.6], [-0.3, -0.4, 0.7]], np.float32)
    voxels = np.array([1.0, 0.8], np.float32) / G
    args = (0.1, G, hw)
    tj, wj = J.build_blocks_tsdf_projective(
        jnp.asarray(X), jnp.asarray(conf), jnp.asarray(Tw),
        jnp.asarray(origins), jnp.asarray(voxels), *args)
    tt, wt = T.build_blocks_tsdf_projective(_t(X), _t(conf), _t(Tw),
                                            _t(origins), _t(voxels), *args)
    assert (np.asarray(wj) > 0).mean() > 0.01
    assert _nan_close(tt.numpy(), tj) <= MAX_PARTING
    assert _nan_close(wt.numpy(), wj) <= MAX_PARTING
    # one block equals its batch entry
    t1, w1 = T.build_block_tsdf_projective(_t(X), _t(conf), _t(Tw),
                                           _t(origins[1]), float(voxels[1]),
                                           *args)
    assert torch.equal(t1, tt[1]) and torch.equal(w1.nan_to_num(-1),
                                                  wt[1].nan_to_num(-1))


def _raycast_case(G, seed):
    """Random fields with a NaN slab and NaN / inf cells on both far faces,
    block pixels sampled from a pointmap seen under a pose, and a grid
    placed so that some rays run past the far faces (the wrap case)."""
    rng = np.random.default_rng(seed)
    tsdf = rng.normal(size=(2, G, G, G)).astype(np.float32)
    weight = rng.uniform(0.0, 1.0, (2, G, G, G)).astype(np.float32)
    tsdf[:, G // 3: G // 3 + 2] = np.nan
    weight[:, :, 2 * G // 3, : G // 2] = np.nan
    tsdf[:, 0, :, : G // 4] = np.nan             # wrapped to from x = G-1
    weight[:, :, 0, G // 2:] = np.inf            # ... from y = G-1
    X, hw = _pointmap()
    Tw = _pose(2)
    pts = np.array(JL.act(jnp.asarray(Tw)[None],
                          jnp.asarray(X[rng.integers(0, X.shape[0],
                                                     (2, 256))])))
    pts[:, :3] = np.nan
    mask = rng.random((2, 256)) > 0.1
    # 1.92 and 2.05 m grids: at G = 64 a 0.03 m voxel keeps every ray
    # within 16 cells of the ±0.1 band (JAX's cell-walk bound); the far x
    # and y faces cut through the points (x up to 0.8, y up to 0.6)
    voxels = np.array([0.03, 0.032], np.float32) * 64 / G
    origins = np.array([[-1.62, -1.72, 0.45], [-1.5, -1.6, 0.6]], np.float32)
    return tsdf, weight, pts, mask, Tw[:3].copy(), origins, voxels


@pytest.mark.parametrize("cw", [0, 16])
@pytest.mark.parametrize("G", [16, 64])
def test_raycast_matches_jax_dense_and_cell_walk(G, cw):
    tsdf, weight, pts, mask, oc, origins, voxels = _raycast_case(G, G + cw)
    rest = (0.1, 0.01, 0.05, 64)
    vox = (pts - origins[:, None]) / voxels[:, None, None]
    assert (vox > G - 1).any(), "no ray reaches past the far faces"
    nj, oj = J.raycast_blocks(*(jnp.asarray(a) for a in (
        tsdf, weight, pts, mask, oc, origins, voxels)), *rest,
        cell_walk_k=cw)
    nt, ot = T.raycast_blocks(*(_t(a) for a in (
        tsdf, weight, pts, mask, oc, origins, voxels)), *rest)
    oj = np.asarray(oj)
    assert oj.sum() > 20
    assert (ot.numpy() != oj).mean() <= MAX_PARTING
    assert _nan_close(nt.numpy(), nj) <= MAX_PARTING
    # one block equals its batch entry
    n1, o1 = T.raycast_block(*(_t(a[1]) for a in (tsdf, weight, pts, mask)),
                             _t(oc), _t(origins[1]), float(voxels[1]), *rest)
    assert torch.equal(o1, ot[1])
    assert torch.equal(n1.nan_to_num(7.0), nt[1].nan_to_num(7.0))


def test_far_face_samples_take_cell_g_minus_1_and_wrap():
    """At G = 64 a sample past the far face clamps to 63.0 (the float32
    rounding of 64 - 1.000001), so its cell is 63 and its +1 corners come
    from the opposite face with weight 0: a NaN there makes the sample's
    field NaN, as in the JAX package."""
    G = 64
    assert torch.clamp(torch.tensor([70.0]), 0.0, G - 1.000001).item() == 63.0
    tsdf = torch.ones(1, G, G, G)
    weight = torch.ones(1, G, G, G)
    tsdf[0, 0] = float("nan")                    # the x = 0 face
    pts = torch.tensor([[[2.5, 0.5, 0.5]]])      # x beyond the grid's 1.0 m
    args = (torch.tensor([0.0, 0.5, 0.5]), torch.zeros(1, 3),
            torch.tensor([1.0 / G]), 0.1, 0.01, 10.0, 8)
    new, ok = T.raycast_blocks(tsdf, weight, pts, torch.ones(1, 1, dtype=bool),
                               *args)
    nj, oj = J.raycast_blocks(*(jnp.asarray(a.numpy()) for a in (
        tsdf, weight, pts, torch.ones(1, 1, dtype=bool), args[0], args[1],
        args[2])), *args[3:])
    assert not ok.item() and not bool(np.asarray(oj).item())
    np.testing.assert_array_equal(new.numpy(), np.asarray(nj))


@pytest.mark.parametrize("G", [16, 64])
def test_refine_blocks_core_matches_jax(G):
    X, hw = _pointmap(nonfinite=20)
    X[:, 2] += RNG.normal(size=X.shape[0]).astype(np.float32) * 0.01
    conf = RNG.uniform(0.5, 1.0, X.shape[0]).astype(np.float32)
    Tw = _pose(3)
    Xw = np.array(JL.act(jnp.asarray(Tw)[None], jnp.asarray(X)))
    sel = RNG.integers(0, X.shape[0], (3, 512))
    mask = RNG.random((3, 512)) > 0.1
    origins = np.array([[-0.6, -0.6, 0.55], [-0.4, -0.45, 0.6],
                        [-0.2, -0.1, 0.65]], np.float32)
    voxels = np.array([1.2, 1.0, 0.6], np.float32) / G
    rest = (0.08, 0.1, 0.01, 0.015, G, hw, 64)
    # the JAX refiner takes the cell walk only where every ray stays within
    # its 16 cells (tsdf_local.py:760-763); past that bound its rows differ
    walk = 2.0 * 0.1 * np.sqrt(3.0) / voxels.min() + 4 <= 16
    for cw in (0, 16) if walk else (0,):
        nj, oj = J.refine_blocks_core(
            *(jnp.asarray(a) for a in (Xw, X, conf, Tw, sel, mask, origins,
                                       voxels)), *rest, cell_walk_k=cw)
        nt, ot = T.refine_blocks_core(
            *(_t(a) for a in (Xw, X, conf, Tw, sel, mask, origins, voxels)),
            *rest)
        oj = np.asarray(oj)
        assert oj.sum() > 50
        assert (ot.numpy() != oj).mean() <= MAX_PARTING
        assert _nan_close(nt.numpy(), nj) <= MAX_PARTING


# ---------------------------------------------------------------------------
# The refiner's host code against JAX
# ---------------------------------------------------------------------------

def _noisy_plane(h=64, w=64, seed=0):
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    X = np.stack([(u - w / 2) / 100.0, (v - h / 2) / 100.0,
                  np.ones_like(u, np.float32)], -1).astype(np.float32)
    X[..., 2] += rng.normal(size=(h, w)).astype(np.float32) * 0.01
    C = np.full((h, w), 1.0, np.float32)
    C[16:48, 16:48] = 0.05      # low confidence → fallback priority > 0
    return X.reshape(-1, 3), C


REFINE_CFG = {"tsdf_refine": {
    "enabled": True, "window_size": 0, "max_grid_dim": 32,
    "ray_samples": 32, "voxel_size": 0.01, "trunc_dist": 0.05,
    "max_displacement": 0.05, "min_hit_rate": 0.01,
    "min_confidence": 0.2, "max_rois_per_kf": 2, "cooldown_s": 0.1}}


def test_select_blocks_matches_jax():
    """The same priorities (ties included) and pointmap give the same
    blocks, in the same order, with the same pixels."""
    h = w = 96
    rng = np.random.default_rng(7)
    X = _pointmap(h, w)[0]
    pri = np.round(rng.random((6, 6)), 1).astype(np.float32)   # many ties
    jk, tk = keyframe_pair(X, np.ones(h * w, np.float32), _pose(4), h, w)
    jr = J.TSDFRefiner(jk, REFINE_CFG)
    tr = T.TSDFRefiner(tk, REFINE_CFG, device="cpu")
    bj = jr._select_blocks(0, pri, 6, 6, 16, h, w)
    bt = tr._select_blocks(0, pri, 6, 6, 16, h, w)
    assert len(bt) == len(bj) >= 2
    for a, b in zip(bt, bj):
        assert a.patch_ids == [tuple(p) for p in b.patch_ids]
        np.testing.assert_array_equal(a.pixel_mask, b.pixel_mask)
        assert a.priority == b.priority and a.depth_range == b.depth_range


@pytest.mark.parametrize("G,pose_seed", [(32, None), (64, 6)])
def test_refine_blocks_matches_jax(G, pose_seed):
    """``_refine_blocks`` called synchronously in both packages on the same
    keyframe: the written pointmap and confidence, the version and the
    stats agree."""
    h = w = 64
    X, C = _noisy_plane(h, w)
    T_WC = (np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32)
            if pose_seed is None else _pose(pose_seed))
    jk, tk = keyframe_pair(X, C, T_WC, h, w)
    cfg = {"tsdf_refine": dict(REFINE_CFG["tsdf_refine"], max_grid_dim=G)}
    jr = J.TSDFRefiner(jk, cfg)
    tr = T.TSDFRefiner(tk, cfg, device="cpu")
    pri = jr._patch_priority(0, 4, 4)
    np.testing.assert_array_equal(tr._patch_priority(0, 4, 4), pri)
    bj = jr._select_blocks(0, pri, 4, 4, 16, h, w)
    bt = tr._select_blocks(0, pri, 4, 4, 16, h, w)
    oj = jr._refine_blocks(bj[:2])
    ot = tr._refine_blocks(bt[:2])
    assert ot == oj and any(ot)
    assert tr.stats == jr.stats
    assert tk.version[0] == jk.version[0] > 0
    assert tk.xc_version[0] == jk.xc_version[0]
    np.testing.assert_allclose(tk.X[0].numpy(), np.asarray(jk.X[0]), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(tk.C[0].numpy(), np.asarray(jk.C[0]), rtol=0,
                               atol=ATOL)


def test_refine_blocks_snapshot_survives_a_concurrent_write():
    """A write that lands after the snapshot (here: the pose, in place)
    makes the write-back reject, and the snapshot taken before it is what
    the builds used."""
    h = w = 64
    X, C = _noisy_plane(h, w)
    _, tk = keyframe_pair(X, C, np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32),
                     h, w)
    tr = T.TSDFRefiner(tk, REFINE_CFG, device="cpu")
    blocks = tr._select_blocks(0, tr._patch_priority(0, 4, 4), 4, 4, 16, h, w)
    orig = T.refine_blocks_core

    def write_between(*a, **kw):
        out = orig(*a, **kw)
        tk.update_T_WCs(TL.identity()[None] * 1.0, [0])   # bumps version
        tk.X[0] += 1.0                                  # in-place write
        return out

    T.refine_blocks_core = write_between
    try:
        assert tr._refine_blocks(blocks[:1]) == [False]
    finally:
        T.refine_blocks_core = orig
    assert tr.stats["version_conflicts"] == 1


def test_update_pointmap_inplace_checks_the_version():
    from mast3r_slam_tpu_torch.slam.frame import KeyframeBuffer

    kf = KeyframeBuffer(4, 4, capacity=2, feat_dim=8, device="cpu")
    kf.n_size = 1
    X, C = torch.ones(16, 3), torch.full((16, 1), 2.0)
    assert not kf.update_pointmap_inplace(0, X, C, expected_version=3)
    assert kf.X[0].abs().sum() == 0 and kf.version[0] == 0
    assert kf.update_pointmap_inplace(0, X, C, expected_version=0)
    assert torch.equal(kf.X[0], X) and torch.equal(kf.C[0], C)
    assert kf.version[0] == 1 and kf.xc_version[0] == 1 and kf.is_dirty[0]


# ---------------------------------------------------------------------------
# Counterparts of tests/test_tsdf.py's local tests
# ---------------------------------------------------------------------------

def _plane_points(n=4000, z=1.0, extent=0.4, noise=0.0):
    xy = (RNG.random((n, 2)) - 0.5) * extent
    zs = np.full((n, 1), z) + noise * RNG.normal(size=(n, 1))
    return np.concatenate([xy, zs], 1).astype(np.float32)


def _plane_pointmap(H=48, W=64, f=40.0, z=1.0):
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    return (np.stack([(u - (W - 1) / 2) / f * z, (v - (H - 1) / 2) / f * z,
                      np.full(u.shape, z)], -1).reshape(-1, 3)
            .astype(np.float32), (H, W))


def _bucket(sel):
    B = 1 << int(np.ceil(np.log2(sel.size)))
    sel_pad = np.zeros(B, np.int64)
    sel_pad[:sel.size] = sel
    mask = np.zeros(B, bool)
    mask[:sel.size] = True
    return sel_pad, mask


def test_build_block_tsdf_plane_sign():
    """TSDF is positive in front of the surface, negative behind."""
    pts = _plane_points()
    G, voxel = 32, 0.02
    go = np.array([-0.3, -0.3, 0.8], np.float32)
    tsdf, weight = T.build_block_tsdf(_t(pts), torch.ones(pts.shape[0]),
                                      torch.zeros(3), _t(go), voxel, 0.08, G,
                                      16)

    def at(x, y, z):
        i, j, k = ((np.array([x, y, z]) - go) / voxel).astype(int)
        return tsdf[i, j, k].item(), weight[i, j, k].item()

    (t_front, w_front), (t_behind, w_behind) = at(0, 0, 0.95), at(0, 0, 1.05)
    assert w_front > 0 and w_behind > 0
    assert t_front > 0 > t_behind


def test_raycast_block_recovers_plane():
    """Noisy plane points snap back to the TSDF zero crossing at z=1."""
    pts_clean = _plane_points(2000)
    go = np.array([-0.3, -0.3, 0.8], np.float32)
    voxel = 0.01
    tsdf, weight = T.build_block_tsdf(_t(pts_clean), torch.ones(2000),
                                      torch.zeros(3), _t(go), voxel, 0.06, 48,
                                      24)
    noisy = pts_clean.copy()
    noisy[:, 2] += RNG.normal(size=2000).astype(np.float32) * 0.03
    new, ok = T.raycast_block(tsdf, weight, _t(noisy),
                              torch.ones(2000, dtype=bool), torch.zeros(3),
                              _t(go), voxel, 0.08, 0.01, 0.1, 64)
    new, ok = new.numpy(), ok.numpy()
    assert ok.mean() > 0.5
    assert (np.abs(new[ok][:, 2] - 1.0).mean()
            < np.abs(noisy[ok][:, 2] - 1.0).mean() * 0.7)


def test_projective_build_plane_sign_and_matches_scatter():
    X, hw = _plane_pointmap()
    n = X.shape[0]
    G, voxel = 32, 0.02
    go = np.array([-0.3, -0.3, 0.8], np.float32)
    tp, wp = T.build_block_tsdf_projective(_t(X), torch.ones(n),
                                           TL.identity(), _t(go), voxel,
                                           0.08, G, hw)
    ts, ws = T.build_block_tsdf(_t(X), torch.ones(n), torch.zeros(3), _t(go),
                                voxel, 0.08, G, 16)
    tp, wp, ts, ws = (a.numpy() for a in (tp, wp, ts, ws))

    def at(grid, x, y, z):
        i, j, k = ((np.array([x, y, z]) - go) / voxel).astype(int)
        return grid[i, j, k]

    assert at(wp, 0, 0, 0.95) > 0 and at(wp, 0, 0, 1.05) > 0
    assert at(tp, 0, 0, 0.95) > 0 > at(tp, 0, 0, 1.05)
    both = (wp > 0.1) & (ws > 0.1)
    assert both.sum() > 100
    assert np.percentile(np.abs(tp[both] - ts[both]), 90) < 0.35


def test_projective_build_raycast_recovers_plane():
    X, hw = _plane_pointmap()
    n = X.shape[0]
    go = np.array([-0.3, -0.3, 0.8], np.float32)
    voxel = 0.01
    tsdf, weight = T.build_block_tsdf_projective(
        _t(X), torch.ones(n), TL.identity(), _t(go), voxel, 0.06, 48, hw)
    noisy = X.copy()
    noisy[:, 2] += RNG.normal(size=n).astype(np.float32) * 0.03
    sel = np.arange(0, n, 3)
    sel_pad, mask = _bucket(sel)
    new, ok = T.raycast_block(tsdf, weight, _t(noisy[sel_pad]), _t(mask),
                              torch.zeros(3), _t(go), voxel, 0.08, 0.01, 0.1,
                              64)
    new, ok = new.numpy()[:sel.size], ok.numpy()[:sel.size]
    assert ok.mean() > 0.5
    assert (np.abs(new[ok][:, 2] - 1.0).mean()
            < np.abs(noisy[sel][ok][:, 2] - 1.0).mean() * 0.7)


def test_refine_blocks_core_matches_two_call_path():
    """The fused keyframe event equals the build + gather + raycast chain
    bit for bit."""
    X, hw = _plane_pointmap()
    conf = RNG.uniform(0.5, 1.0, X.shape[0]).astype(np.float32)
    T_WC = TL.identity()
    Xw = TL.act(T_WC[None], _t(X))
    G, S, P = 16, 16, 64
    origins = _t(np.array([[-0.5, -0.5, 0.6], [-0.3, -0.4, 0.7]], np.float32))
    voxels = _t(np.array([0.06, 0.05], np.float32))
    sel = _t(RNG.integers(0, X.shape[0], (2, P)))
    mask = _t(RNG.random((2, P)) > 0.1)
    new_f, ok_f = T.refine_blocks_core(Xw, _t(X), _t(conf), T_WC, sel, mask,
                                       origins, voxels, 0.1, 0.1, 0.01, 0.05,
                                       G, hw, S)
    tb, wb = T.build_blocks_tsdf_projective(_t(X), _t(conf), T_WC, origins,
                                            voxels, 0.1, G, hw)
    new_2, ok_2 = T.raycast_blocks(tb, wb, Xw[sel], mask,
                                   TL.translation(T_WC), origins, voxels,
                                   0.1, 0.01, 0.05, S)
    assert torch.equal(ok_f, ok_2) and torch.equal(new_f, new_2)


def test_projective_build_raycast_recovers_oracle_surface():
    """Curved geometry against the analytic oracle: refined hits lie on the
    closed-form surface within a voxel and much closer than the noisy
    inputs."""
    from mast3r_slam_tpu_torch.utils.oracle_scene import OracleScene

    scene = OracleScene(seed=3)
    hw = (96, 128)
    K = scene.intrinsics(hw, fov_scale=2.0)
    T_id = np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32)
    X_cam, _ = scene.raycast(T_id, K, hw)      # identity pose: cam == world
    n = X_cam.shape[0]
    G, voxel = 48, 0.02
    zc = float(np.median(X_cam[:, 2]))
    go = np.array([-0.45, -0.45, zc - 0.48], np.float32)
    tsdf, weight = T.build_block_tsdf_projective(
        _t(X_cam), torch.ones(n), TL.identity(), _t(go), voxel, 0.08, G, hw)
    noisy = X_cam.copy()
    noisy[:, 2] += RNG.normal(size=n).astype(np.float32) * 0.03
    sel = np.arange(0, n, 3)
    sel_pad, mask = _bucket(sel)
    new, ok = T.raycast_block(tsdf, weight, _t(noisy[sel_pad]), _t(mask),
                              torch.zeros(3), _t(go), voxel, 0.1, 0.01, 0.12,
                              64)
    new, ok = new.numpy()[:sel.size], ok.numpy()[:sel.size]
    assert ok.mean() > 0.4, ok.mean()
    after = np.abs(new[ok][:, 2] - scene.height(new[ok][:, 0], new[ok][:, 1]))
    before = np.abs(noisy[sel][ok][:, 2]
                    - scene.height(noisy[sel][ok][:, 0], noisy[sel][ok][:, 1]))
    assert after.mean() < before.mean() * 0.75
    assert after.mean() < 1.2 * voxel, after.mean()


def test_refiner_end_to_end_schedule_and_refine():
    """The whole TSDFRefiner loop on its thread: low-confidence fallback
    priority → block selection → worker refinement → version-checked
    fusion write-back."""
    h = w = 64
    X, C = _noisy_plane(h, w)
    _, kfs = keyframe_pair(X, C, np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32),
                      h, w)
    ref = T.TSDFRefiner(kfs, REFINE_CFG, device="cpu").start()
    try:
        ref.maybe_schedule_sliding_window(0, is_final_pass=True)
        assert ref.stats["scheduled"] > 0, "nothing scheduled"
        deadline = time.monotonic() + WAIT_S
        while (ref.stats["refined_blocks"] + ref.stats["rejected_blocks"]
               < ref.stats["scheduled"] and time.monotonic() < deadline):
            time.sleep(0.05)
    finally:
        ref.stop()
    assert not ref.is_alive()
    assert ref.stats["refined_blocks"] >= 1, ref.stats
    assert (ref.stats["refined_blocks"] + ref.stats["rejected_blocks"]
            == ref.stats["scheduled"])
    assert kfs.version[0] > 0
    C_after = kfs.C[0].numpy().reshape(h, w)
    assert (C_after >= C.reshape(h, w) - 1e-5).all()
    assert (C_after > C.reshape(h, w) + 1e-5).any(), "no confidence boost"


def test_refiner_defers_to_a_pending_quality_result():
    """With a live quality service and no result yet, scheduling defers
    through the retry pump instead of falling back."""

    class Pending:
        ps = 16

        def get_by_kf_id(self, kf_id):
            return None

        def is_alive(self):
            return True

    h = w = 64
    X, C = _noisy_plane(h, w)
    _, kfs = keyframe_pair(X, C, np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32),
                      h, w)
    ref = T.TSDFRefiner(kfs, REFINE_CFG, quality_service=Pending(),
                        device="cpu")
    ref.maybe_schedule_sliding_window(0, is_final_pass=True)
    assert ref.stats["scheduled"] == 0 and 0 in ref._retry
    ref._quality_waits[0] = ref.quality_wait_s     # the wait is used up
    ref._schedule_refinement(0)
    assert ref.stats["scheduled"] > 0              # the fallback schedules
