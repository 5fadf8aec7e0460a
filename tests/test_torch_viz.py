"""Port parity: the viewer's host side (``mast3r_slam_tpu_torch/viz``) and
the keyframe buffer's viewer helpers against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:
- ``render_state``: at least 99.5% of pixels equal (``RENDER_AGREE``). The
  JAX renderer projects with a numpy float32 matmul, the port with
  elementwise float32 sums; a point whose projection lies within a rounding
  of a pixel boundary may land one pixel over. The scenes hold no exact
  depth ties (checked), where the JAX package's unstable sort leaves the
  winner undefined.
- ``look_at``, ``frustum_corners``: 1e-6. ``turbo_colormap``,
  ``draw_line``, ``draw_polyline_3d``, the overlay's triangles and its
  input handling: exact.
- ``_grid_normals``, ``_perspective``, ``_camera_mvp``, ``_gather_map``:
  1e-5 (``VIEW_TOL``); colours exact.
- ``get_dirty_idx``, ``last_index``: the same indices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import lie as JLie
from mast3r_slam_tpu.slam import frame as JF
from mast3r_slam_tpu.viz import render as JR
from mast3r_slam_tpu.viz import viewer as JV
from mast3r_slam_tpu_torch.data import png
from mast3r_slam_tpu_torch.slam import frame as TF
from mast3r_slam_tpu_torch.viz import render as TR
from mast3r_slam_tpu_torch.viz import viewer as TV
from torch_parity import torch_one_thread  # noqa: F401

RENDER_AGREE = 0.995
VIEW_TOL = 1e-5


def _jax_frame(i, h, w, uimg, X=None, C=None, N=1, T=None, feat_dim=8,
               n_patches=1):
    fr = JF.Frame(frame_id=i, img=jnp.zeros((h, w, 3)), img_shape=(h, w),
                  img_true_shape=(h, w), uimg=uimg)
    if T is not None:
        fr.T_WC = jnp.asarray(T)
    if X is not None:
        fr.X_canon = jnp.asarray(X)
        fr.C = jnp.asarray(C)
        fr.feat = jnp.zeros((1, n_patches, feat_dim))
        fr.pos = jnp.zeros((1, n_patches, 2), jnp.int32)
        fr.N = fr.N_updates = N
    return fr


def _port_frame(i, h, w, uimg, X=None, C=None, N=1, T=None, feat_dim=8,
                n_patches=1):
    fr = TF.Frame(frame_id=i, img=torch.zeros(h, w, 3), img_shape=(h, w),
                  img_true_shape=(h, w), uimg=uimg)
    if T is not None:
        fr.T_WC = torch.tensor(np.asarray(T))
    if X is not None:
        fr.X_canon = torch.from_numpy(X)
        fr.C = torch.from_numpy(C)
        fr.feat = torch.zeros(1, n_patches, feat_dim)
        fr.pos = torch.zeros(1, n_patches, 2, dtype=torch.int32)
        fr.N = fr.N_updates = N
    return fr


def _buffers(keyframes, h, w, capacity=8):
    """The same keyframes ``[(uimg, X, C, N, T)]`` in a JAX and a port
    (CPU) buffer."""
    jk = JF.KeyframeBuffer(h, w, capacity=capacity, feat_dim=8)
    tk = TF.KeyframeBuffer(h, w, capacity=capacity, feat_dim=8,
                           device="cpu")
    for i, (uimg, X, C, N, T) in enumerate(keyframes):
        kw = dict(X=X, C=C, N=N, T=T, n_patches=jk.num_patches)
        jk.append(_jax_frame(i, h, w, uimg, **kw))
        tk.append(_port_frame(i, h, w, uimg, **kw))
    return jk, tk


def _viz_eval_scene(n_kf=3, h=16, w=24, seed=7, conf_spread=False):
    """``tests/test_viz_eval.py``'s buffer: random points 2 m ahead,
    keyframes 0.3 apart along x; ``conf_spread`` gives each point its own
    confidence and the keyframes N of 1 and 2."""
    rng = np.random.default_rng(seed)
    n = h * w
    kfs = []
    for i in range(n_kf):
        uimg = rng.random((h, w, 3)).astype(np.float32)
        X = (rng.random((n, 3)) + [0, 0, 2.0]).astype(np.float32)
        C = (rng.uniform(0.5, 3.0, (n, 1)) if conf_spread
             else np.ones((n, 1))).astype(np.float32)
        T = np.asarray(JLie.exp(jnp.asarray([0.3 * i, 0, 0, 0, 0, 0, 0.0])))
        kfs.append((uimg, X, C, 1 + i % 2 if conf_spread else 1, T))
    return _buffers(kfs, h, w), rng


def _states(rng, h, w, current):
    js, ts = JF.States(), TF.States()
    js.set_edges([0, 1], [1, 2])
    ts.set_edges([0, 1], [1, 2])
    if current:
        uimg = rng.random((h, w, 3)).astype(np.float32)
        X = (rng.random((h * w, 3)) + [0, 0, 2.0]).astype(np.float32)
        jf = _jax_frame(9, h, w, uimg)
        jf.X_canon = jnp.asarray(X)
        tf = _port_frame(9, h, w, uimg)
        tf.X_canon = torch.from_numpy(X)
        js.set_frame(jf)
        ts.set_frame(tf)
    return js, ts


def _agree(got, want):
    return float((np.asarray(got) == np.asarray(want)).all(-1).mean())


@pytest.mark.parametrize("current", [False, True], ids=["keyframes",
                                                         "current_frame"])
@pytest.mark.parametrize("gate", [(0.0, 20000), (1.0, 100)],
                         ids=["all", "gated_strided"])
def test_render_state_matches_jax(current, gate, monkeypatch):
    conf, max_pts = gate
    (jk, tk), rng = _viz_eval_scene(conf_spread=conf > 0)
    js, ts = _states(rng, 16, 24, current)
    hw = (100, 140) if current else (120, 160)
    splats = []

    def recording(img, zbuf, P, C, R, t, K):
        splats.append(TR._project(P, R, t, K, zbuf.shape))
        return splat(img, zbuf, P, C, R, t, K)

    splat = TR.splat_points
    monkeypatch.setattr(TR, "splat_points", recording)
    want = JR.render_state(jk, js, img_hw=hw, conf_threshold=conf,
                           max_points_per_kf=max_pts)
    got = TR.render_state(tk, ts, img_hw=hw, conf_threshold=conf,
                          max_points_per_kf=max_pts)
    assert got.dtype == torch.uint8 and got.shape == (*hw, 3)
    _, _, z, ok = splats[0]
    assert ok.sum() > 50
    assert torch.unique(z[ok]).numel() == int(ok.sum()), "depth ties"
    assert (want > 0).any()
    assert _agree(got.numpy(), want) >= RENDER_AGREE


def test_render_empty_buffer_matches_jax():
    jk = JF.KeyframeBuffer(8, 8, capacity=2, feat_dim=4)
    tk = TF.KeyframeBuffer(8, 8, capacity=2, feat_dim=4, device="cpu")
    want = JR.render_state(jk, None, img_hw=(32, 32))
    got = TR.render_state(tk, None, img_hw=(32, 32))
    np.testing.assert_array_equal(got.numpy(), want)


def test_splat_ties_go_to_the_lowest_index():
    """Three points at exactly the same depth in one pixel, and a nearer
    one in another: the nearest wins its pixel, and of the tied three the
    first one."""
    R, t = torch.eye(3), torch.zeros(3)
    K = torch.tensor([[10.0, 0, 5.0], [0, 10.0, 5.0], [0, 0, 1.0]])
    P = torch.tensor([[0.0, 0, 2], [0.01, 0, 2], [0.02, 0, 2],
                      [0.6, 0, 3], [0.3, 0, 1.5]])
    colors = torch.arange(15, dtype=torch.float32).reshape(5, 3)
    img = torch.zeros(10, 10, 3)
    zbuf = torch.full((10, 10), float("inf"))
    TR.splat_points(img, zbuf, P, colors, R, t, K)
    assert torch.equal(img[5, 5], colors[0]) and zbuf[5, 5] == 2.0
    assert torch.equal(img[5, 7], colors[4]) and zbuf[5, 7] == 1.5
    assert int((zbuf < float("inf")).sum()) == 2


def test_look_at_matches_jax():
    rng = np.random.default_rng(3)
    for _ in range(20):
        eye, target = rng.normal(size=(2, 3)) * 3
        Rj, tj = JR.look_at(eye, target)
        Rt, tt = TR.look_at(eye, target)
        np.testing.assert_allclose(Rt.numpy(), Rj, atol=1e-6, rtol=0)
        np.testing.assert_allclose(tt.numpy(), tj, atol=1e-6, rtol=1e-6)


def test_frustum_corners_match_jax():
    rng = np.random.default_rng(4)
    xi = rng.normal(size=(6, 7)).astype(np.float32) * 0.5
    T = np.asarray(JLie.exp(jnp.asarray(xi)))
    got = TR.frustum_corners(torch.tensor(T))
    assert got.shape == (6, 5, 3)
    for k in range(6):
        want = JR.frustum_corners(T[k])
        np.testing.assert_allclose(got[k].numpy(), want, atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(
            TR.frustum_corners(torch.tensor(T[k]), scale=0.2,
                               aspect=1.5).numpy(),
            JR.frustum_corners(T[k], scale=0.2, aspect=1.5), atol=1e-6,
            rtol=1e-6)


def test_turbo_colormap_matches_jax():
    t = np.random.default_rng(5).uniform(-0.2, 1.2, 1000).astype(np.float32)
    np.testing.assert_array_equal(TR.turbo_colormap(torch.from_numpy(t))
                                  .numpy(), JR.turbo_colormap(t))


def test_draw_line_matches_jax():
    """Random float32 segments, some leaving the image, some shorter than
    a pixel or axis-parallel; each drawn in its own colour on one image."""
    rng = np.random.default_rng(6)
    want = np.zeros((48, 64, 3), np.float32)
    got = torch.zeros(48, 64, 3)
    ends = rng.uniform(-20, 80, (200, 4)).astype(np.float32)
    ends[:20, 2:] = ends[:20, :2] + rng.uniform(-0.9, 0.9, (20, 2))
    ends[20:40, 3] = ends[20:40, 1]
    ends[40:60] = np.round(ends[40:60])
    for u0, v0, u1, v1 in ends:
        color = rng.random(3)
        JR.draw_line(want, (u0, v0), (u1, v1), color)
        TR.draw_line(got, (u0, v0), (u1, v1), color)
    assert (want > 0).any()
    np.testing.assert_array_equal(got.numpy(), want)


def test_draw_polyline_3d_matches_jax():
    rng = np.random.default_rng(8)
    pts = (rng.normal(size=(40, 3)) * [1.0, 0.6, 0.5]
           + [0, 0, 3.0]).astype(np.float32)
    R, t = JR.look_at(np.array([0.2, -0.5, -1.0]), np.array([0, 0, 3.0]))
    K = np.array([[80, 0, 64], [0, 80, 48], [0, 0, 1]], np.float32)
    want = np.zeros((96, 128, 3), np.float32)
    JR.draw_polyline_3d(want, pts, R, t, K, np.array([1.0, 0.3, 0.2]))
    got = torch.zeros(96, 128, 3)
    TR.draw_polyline_3d(got, torch.from_numpy(pts), torch.from_numpy(R),
                        torch.from_numpy(t), torch.from_numpy(K),
                        (1.0, 0.3, 0.2))
    assert (want > 0).sum() > 100
    np.testing.assert_array_equal(got.numpy(), want)


def test_save_snapshot_roundtrips_through_png(tmp_path):
    (_, tk), rng = _viz_eval_scene()
    _, ts = _states(rng, 16, 24, current=True)
    path = tmp_path / "snap.png"
    img = TR.save_snapshot(path, tk, ts, img_hw=(60, 80))
    assert (img > 0).any()
    np.testing.assert_array_equal(png.read_png(path), img.numpy())
    with pytest.raises(ValueError, match=r"\.jpg"):
        TR.save_snapshot(tmp_path / "snap.jpg", tk, ts)
    assert not (tmp_path / "snap.jpg").exists()


# ---------------------------------------------------------------------------
# the GL viewer's host data path (no GL context)
# ---------------------------------------------------------------------------

def _viewer_scene(seed=0):
    """``tests/test_viewer_gl.py``'s scene (two keyframes over a wavy
    grid, edge 0-1), each point with its own confidence and a few
    non-finite points."""
    h, w = 24, 32
    rng = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    z = 2.0 + 0.1 * np.sin(u / 3.0)
    X = np.stack([(u - w / 2) / 20 * z, (v - h / 2) / 20 * z, z],
                 -1).reshape(-1, 3).astype(np.float32)
    kfs = []
    for i in range(2):
        Xi = X + np.float32(0.01 * i)
        Xi[rng.integers(0, h * w, 5)] = np.nan
        C = rng.uniform(0.5, 4.0, (h * w, 1)).astype(np.float32)
        T = np.asarray(JLie.exp(jnp.asarray(
            rng.normal(size=7).astype(np.float32) * [0.1] * 6 + [0.0])))
        kfs.append((rng.uniform(0.2, 1.0, (h, w, 3)).astype(np.float32),
                    Xi, C, 1 + i, T))
    jk, tk = _buffers(kfs, h, w, capacity=4)
    js, ts = JF.States(), TF.States()
    for s in (js, ts):
        s.set_edges([0], [1])
    return (JV.Viewer(jk, js, {}, width=160, height=120),
            TV.Viewer(tk, ts, {}, width=160, height=120))


def test_grid_normals_match_jax():
    rng = np.random.default_rng(9)
    X = rng.normal(size=(12 * 16, 3)).astype(np.float32)
    X[7] = np.nan
    got = TV._grid_normals(torch.from_numpy(X), 12, 16)
    np.testing.assert_allclose(got.numpy(), JV._grid_normals(X, 12, 16),
                               atol=VIEW_TOL, rtol=VIEW_TOL)


def test_perspective_and_camera_mvp_match_jax():
    np.testing.assert_allclose(TV._perspective(60, 4 / 3, 0.01, 1000.0),
                               JV._perspective(60, 4 / 3, 0.01, 1000.0),
                               atol=VIEW_TOL, rtol=VIEW_TOL)
    jv, tv = _viewer_scene()
    for yaw, pitch, dist, center in ((0.0, -0.4, 4.0, (0, 0, 0)),
                                     (1.3, 0.7, 2.5, (0.1, -0.2, 2.0))):
        for v in (jv, tv):
            v.yaw, v.pitch, v.dist = yaw, pitch, dist
            v.center = np.asarray(center, np.float32)
        np.testing.assert_allclose(tv._camera_mvp(), jv._camera_mvp(),
                                   atol=VIEW_TOL, rtol=VIEW_TOL)


@pytest.mark.parametrize("conf", [0.0, 1.2])
def test_refresh_and_gather_map_match_jax(conf):
    jv, tv = _viewer_scene()
    jv._refresh_dirty()
    tv._refresh_dirty()
    assert sorted(jv._kf_points) == sorted(tv._kf_points) == [0, 1]
    for i in (0, 1):
        for g, w in zip(tv._kf_points[i], jv._kf_points[i]):
            assert g.device.type == "cpu"
            np.testing.assert_allclose(g.numpy(), w, atol=VIEW_TOL,
                                       rtol=VIEW_TOL)
    jv.conf_threshold = tv.conf_threshold = conf
    (Pg, Cg, Ng), (Pw, Cw, Nw) = tv._gather_map(), jv._gather_map()
    assert Pg.shape == Pw.shape and len(Pg) > 100
    np.testing.assert_allclose(Pg, Pw, atol=VIEW_TOL, rtol=VIEW_TOL)
    np.testing.assert_array_equal(Cg, Cw)
    np.testing.assert_allclose(Ng, Nw, atol=VIEW_TOL, rtol=VIEW_TOL)
    # nothing dirty: the second refresh uploads nothing
    assert len(tv.keyframes.get_dirty_idx()) == 0


def test_overlay_triangles_and_input_match_jax():
    """The same presses, drags and releases on both overlays: the same
    consumed flags, viewer and shared state, and triangles."""
    jv, tv = _viewer_scene()

    def state(v):
        return (v.states.paused, v.follow, v.surfel_mode,
                v.conf_threshold, v.surfel_radius)

    def same():
        assert state(tv) == state(jv)
        for W, H in ((160, 120), (1280, 720)):
            for g, w in zip(tv.overlay.triangles(W, H),
                            jv.overlay.triangles(W, H)):
                np.testing.assert_array_equal(g, w)

    same()
    rects = [wdg.rect for wdg in tv.overlay.widgets]
    events = [("press", rects[0][0] + 5, rects[0][1] + 5), ("release",),
              ("press", rects[1][0] + 9, rects[1][1] + 3), ("release",),
              ("press", rects[2][0] + 2, rects[2][1] + 20), ("release",),
              ("press", rects[3][0] + 90, rects[3][1] + 5),
              ("drag", rects[3][0] + 170, rects[3][1] + 5),
              ("drag", rects[3][0] - 30, rects[3][1] + 5), ("release",),
              ("drag", 50, 50),
              ("press", rects[4][0] + 45, rects[4][1] + 10),
              ("drag", rects[4][0] + 120, 0), ("release",),
              ("press", 5, 170), ("press", 400, 400), ("release",)]
    for ev in events:
        kind, *xy = ev
        got = getattr(tv.overlay, f"handle_{kind}")(*xy)
        want = getattr(jv.overlay, f"handle_{kind}")(*xy)
        assert got == want, ev
        same()
    assert state(tv) != (False, False, True, 0.0, 0.01)


# ---------------------------------------------------------------------------
# the keyframe buffer's and the frame's viewer helpers
# ---------------------------------------------------------------------------

def test_dirty_indices_match_jax():
    h, w = 4, 6
    rng = np.random.default_rng(10)
    jk = JF.KeyframeBuffer(h, w, capacity=6, feat_dim=8)
    tk = TF.KeyframeBuffer(h, w, capacity=6, feat_dim=8, device="cpu")

    def frame(i):
        X = rng.normal(size=(h * w, 3)).astype(np.float32)
        C = rng.uniform(1, 2, (h * w, 1)).astype(np.float32)
        kw = dict(X=X, C=C, N=2, n_patches=jk.num_patches)
        uimg = rng.random((h, w, 3)).astype(np.float32)
        return (_jax_frame(i, h, w, uimg, **kw),
                _port_frame(i, h, w, uimg, **kw))

    def dirty():
        got, want = tk.get_dirty_idx(), jk.get_dirty_idx()
        np.testing.assert_array_equal(got, want)
        return list(got)

    X = rng.normal(size=(h * w, 3)).astype(np.float32)
    C = np.ones((h * w, 1), np.float32)
    T = np.asarray(JLie.exp(jnp.asarray(rng.normal(size=(2, 7)) * 0.1,
                                        jnp.float32)))
    steps = [
        lambda b, f: [b.append(f[k]) for k in range(3)],
        lambda b, f: None,
        lambda b, f: b.update_T_WCs(
            T if b is jk else torch.from_numpy(T), [0, 2]),
        lambda b, f: b.update_pointmap_inplace(
            1, *((jnp.asarray(X), jnp.asarray(C)) if b is jk
                 else (torch.from_numpy(X), torch.from_numpy(C)))),
        lambda b, f: b.update_pointmap_inplace(
            2, *((jnp.asarray(X), jnp.asarray(C)) if b is jk
                 else (torch.from_numpy(X), torch.from_numpy(C))),
            expected_version=0),
        lambda b, f: (b.append(f[3]), b.update_pointmap_inplace(
            0, *((jnp.asarray(X), jnp.asarray(C)) if b is jk
                 else (torch.from_numpy(X), torch.from_numpy(C))),
            expected_version=int(b.version[0]))),
    ]
    frames = [frame(i) for i in range(4)]
    seen = []
    for step in steps:
        step(jk, [f[0] for f in frames])
        step(tk, [f[1] for f in frames])
        seen.append(dirty())
    assert seen == [[0, 1, 2], [], [], [1], [], [0, 3]]
    assert tk.last_index() == jk.last_index() == 3
    np.testing.assert_array_equal(tk.last_keyframe().X_canon.numpy(),
                                  np.asarray(jk.last_keyframe().X_canon))
    assert tk.get_intrinsics() is None and jk.get_intrinsics() is None
    K = np.array([[50, 0, 3], [0, 50, 2], [0, 0, 1]], np.float32)
    jk.set_intrinsics(K)
    tk.set_intrinsics(K)
    np.testing.assert_array_equal(tk.get_intrinsics().numpy(),
                                  np.asarray(jk.get_intrinsics()))
    empty = TF.KeyframeBuffer(h, w, capacity=2, feat_dim=8, device="cpu")
    assert empty.last_keyframe() is None and empty.last_index() == -1


@pytest.mark.parametrize("score", ["median", "mean"])
def test_frame_confidence_helpers_match_jax(score):
    rng = np.random.default_rng(12)
    h, w = 5, 7
    C = rng.uniform(0.5, 3.0, (h * w, 1)).astype(np.float32)
    X = rng.normal(size=(h * w, 3)).astype(np.float32)
    uimg = rng.random((h, w, 3)).astype(np.float32)
    jf = _jax_frame(0, h, w, uimg, X=X, C=C, N=3)
    tf = _port_frame(0, h, w, uimg, X=X, C=C, N=3)
    np.testing.assert_allclose(tf.get_average_conf().numpy(),
                               np.asarray(jf.get_average_conf()),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(tf.get_score(tf.C, score)),
                               float(jf.get_score(jf.C, score)), rtol=1e-6)
    bare = _port_frame(1, h, w, uimg)
    assert bare.get_average_conf() is None
