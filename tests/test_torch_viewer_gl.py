"""Headless-EGL execution of the port's GL viewer (``mast3r_slam_tpu_torch/
viz/viewer.py``): both pipelines draw, the confidence threshold culls, the
control overlay draws and takes input (the four tests of
``tests/test_viewer_gl.py`` on the port's viewer), and its pixels agree
with the JAX viewer's on the same scene: at least ``PIXEL_AGREE`` of them
(the two packages' host arithmetic rounds the vertices' last bits apart,
and a rasterized edge can move by a pixel).

The contexts are made one at a time, each destroyed before the next (the
EGL display is shared, and destroying a context terminates it). PyOpenGL
picks its platform at its first import: ``glctx.EglContext`` chooses EGL
when nothing has imported OpenGL yet. Skips only if no GL stack imports.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu_torch.slam.frame import Frame, KeyframeBuffer, States
from mast3r_slam_tpu_torch.viz.viewer import Viewer
from torch_parity import torch_one_thread  # noqa: F401

PIXEL_AGREE = 0.99


def _scene_arrays():
    """``tests/test_viewer_gl.py``'s scene: two keyframes over a wavy grid
    0.1 apart in x, confidence 2, edge 0-1."""
    h, w = 24, 32
    rng = np.random.default_rng(0)
    u, v = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32), indexing="xy")
    z = 2.0 + 0.1 * np.sin(u / 3.0)
    X = np.stack([(u - w / 2) / 20 * z, (v - h / 2) / 20 * z, z],
                 -1).reshape(-1, 3).astype(np.float32)
    kfs = [(rng.uniform(0.2, 1.0, (h, w, 3)).astype(np.float32),
            np.array([0.1 * i, 0, 0, 0, 0, 0, 1, 1], np.float32),
            X + np.float32(0.01 * i)) for i in range(2)]
    return h, w, kfs


def _make_scene():
    h, w, kfs = _scene_arrays()
    buf = KeyframeBuffer(h, w, capacity=4, feat_dim=8, patch_size=8,
                         device="cpu")
    states = States()
    for i, (uimg, T, X) in enumerate(kfs):
        fr = Frame(frame_id=i, img=None, img_shape=(h, w),
                   img_true_shape=(h, w), uimg=uimg)
        fr.T_WC = torch.from_numpy(T)
        fr.X_canon = torch.from_numpy(X)
        fr.C = torch.full((h * w, 1), 2.0)
        fr.feat = torch.zeros(1, 12, 8)
        fr.pos = torch.zeros(1, 12, 2, dtype=torch.int32)
        fr.N = fr.N_updates = 1
        buf.append(fr)
    states.set_edges([0], [1])
    return buf, states


def _make_jax_scene():
    from mast3r_slam_tpu.slam.frame import Frame as JFrame
    from mast3r_slam_tpu.slam.frame import KeyframeBuffer as JBuffer
    from mast3r_slam_tpu.slam.frame import States as JStates

    h, w, kfs = _scene_arrays()
    buf = JBuffer(h, w, capacity=4, feat_dim=8, patch_size=8)
    states = JStates()
    for i, (uimg, T, X) in enumerate(kfs):
        fr = JFrame(frame_id=i, img=None, img_shape=(h, w),
                    img_true_shape=(h, w), uimg=uimg)
        fr.T_WC = jnp.asarray(T)
        fr.X_canon = jnp.asarray(X)
        fr.C = jnp.ones((h * w, 1), jnp.float32) * 2.0
        fr.feat = jnp.zeros((1, 12, 8))
        fr.pos = jnp.zeros((1, 12, 2), jnp.int32)
        fr.N = fr.N_updates = 1
        buf.append(fr)
    states.set_edges([0], [1])
    return buf, states


def _init(viewer):
    try:
        viewer.init_gl()
    except Exception as e:  # no GL stack at all
        pytest.skip(f"no headless GL available: {e}")
    return viewer


@pytest.fixture
def gl_viewer():
    kfs, states = _make_scene()
    v = _init(Viewer(kfs, states, {}, width=160, height=120, headless=True))
    v.show_ui = False  # map-pipeline tests; the overlay has its own test
    yield v
    v.ctx.destroy()


def _nonbg_fraction(img):
    bg = np.array([int(0.05 * 255), int(0.05 * 255), int(0.08 * 255)])
    return (np.abs(img.astype(int) - bg).sum(-1) > 10).mean()


def _render(viewer, surfels, show_ui):
    viewer.surfel_mode = surfels
    viewer.surfel_radius = 0.05
    viewer.show_ui = show_ui
    viewer.yaw, viewer.pitch, viewer.dist = 0.3, -0.4, 3.0
    viewer.center = np.array([0.0, 0.0, 2.0], np.float32)
    viewer.render_frame()
    return viewer.ctx.read_pixels().copy()


def test_viewer_pixels_match_the_jax_viewer():
    """The same scene and camera through both viewers, one context after
    the other: surfels and points, with the overlay, at 320x240."""
    from mast3r_slam_tpu.viz.viewer import Viewer as JViewer

    modes = [(True, True), (False, True), (True, False)]
    imgs = {}
    for name, viewer in (("jax", JViewer(*_make_jax_scene(), {}, width=320,
                                         height=240, headless=True)),
                         ("port", Viewer(*_make_scene(), {}, width=320,
                                         height=240, headless=True))):
        _init(viewer)
        try:
            imgs[name] = [_render(viewer, *m) for m in modes]
        finally:
            viewer.ctx.destroy()
    for (surfels, _), got, want in zip(modes, imgs["port"], imgs["jax"]):
        assert _nonbg_fraction(want) > 0.05
        agree = (got == want).all(-1).mean()
        assert agree >= PIXEL_AGREE, (surfels, agree)


def test_surfel_pipeline_draws(gl_viewer):
    gl_viewer.surfel_mode = True
    gl_viewer.surfel_radius = 0.05
    gl_viewer.render_frame()
    img = gl_viewer.ctx.read_pixels()
    assert img.shape == (120, 160, 3)
    assert _nonbg_fraction(img) > 0.05, "surfel pass drew nothing"


def test_point_pipeline_and_overlays_draw(gl_viewer):
    gl_viewer.surfel_mode = False
    gl_viewer.render_frame()
    img = gl_viewer.ctx.read_pixels()
    assert _nonbg_fraction(img) > 0.01, "point pass drew nothing"


def test_conf_threshold_culls(gl_viewer):
    gl_viewer.surfel_mode = True
    gl_viewer.conf_threshold = 100.0   # above every confidence
    gl_viewer._kf_points.clear()
    gl_viewer.keyframes.is_dirty[:2] = True
    gl_viewer.render_frame()
    lo = _nonbg_fraction(gl_viewer.ctx.read_pixels())
    gl_viewer.conf_threshold = 0.0
    gl_viewer._kf_points.clear()
    gl_viewer.keyframes.is_dirty[:2] = True
    gl_viewer.render_frame()
    hi = _nonbg_fraction(gl_viewer.ctx.read_pixels())
    assert hi > lo, (hi, lo)


def test_control_overlay_draws_and_handles_input(gl_viewer):
    """The control panel renders, and its buttons and sliders change the
    viewer's and the shared state."""
    gl_viewer.show_ui = True
    gl_viewer.render_frame()
    img = gl_viewer.ctx.read_pixels()
    panel_px = img[6:100, 6:100].reshape(-1, 3)
    bg = np.array([int(0.12 * 255), int(0.13 * 255), int(0.18 * 255)])
    assert (np.abs(panel_px.astype(int) - bg).sum(-1) < 12).mean() > 0.2

    ov = gl_viewer.overlay
    btn = ov.widgets[0]                   # pause
    with gl_viewer.states.lock:
        paused0 = gl_viewer.states.paused
    assert ov.handle_press(btn.rect[0] + 5, btn.rect[1] + 5)
    with gl_viewer.states.lock:
        assert gl_viewer.states.paused != paused0
    assert btn.text() in ("PAUSE", "RESUME")
    ov.handle_release()

    # conf slider: press at 50% then drag to 100%
    sld = [w for w in ov.widgets if hasattr(w, "lo")][0]
    sx, sy, sw, sh = sld.rect
    assert ov.handle_press(sx + sw * 0.5, sy + sh / 2)
    v_mid = sld.get()
    assert abs(v_mid - (sld.lo + 0.5 * (sld.hi - sld.lo))) < 0.2 * (
        sld.hi - sld.lo)
    assert ov.handle_drag(sx + sw, sy + sh / 2)
    assert sld.get() > v_mid
    ov.handle_release()
    assert not ov.handle_drag(sx, sy)     # the drag ends on release
    # a click beyond the panel is not consumed (a camera drag instead)
    assert not ov.handle_press(ov.panel_rect[0] + ov.panel_rect[2] + 50,
                               ov.panel_rect[1] + ov.panel_rect[3] + 50)
