"""The port's global TSDF (``mast3r_slam_tpu_torch/services/native_tsdf.py``,
``tsdf_global.py``) on the CPU.

The native hash (the port's own copy of the C++ source, built with g++
here) against its plain version ``PyVoxelHash`` and against the JAX
package's native hash: the same integrations give the same voxel count and
update count, and queries the same validity and TSDF values within 1e-6
(gradients within 1e-6 / (2·voxel), what a 1e-6 TSDF difference makes of
the central difference). ``TSDFPoseOptimizer.optimize_single`` against the
JAX package's from the same keyframe: the pose within 1e-5, on a plane and
on the curved oracle surface. Then the manager's hook and threads, and
counterparts of tests/test_tsdf.py's global tests.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.ops import lie as JL
from mast3r_slam_tpu.services import native_tsdf as JN
from mast3r_slam_tpu.services import tsdf_global as JG
from mast3r_slam_tpu_torch.ops import lie as TL
from mast3r_slam_tpu_torch.services import native_tsdf as TN
from mast3r_slam_tpu_torch.services import tsdf_global as TG
from mast3r_slam_tpu_torch.utils.oracle_scene import OracleScene
from torch_parity import keyframe_pair, torch_one_thread  # noqa: F401

TSDF_TOL = 1e-6
POSE_TOL = 1e-5
WAIT_S = 30.0
T_ID = np.array([0, 0, 0, 0, 0, 0, 1, 1], np.float32)


def _plane_points(rng, n=3000, z=1.0, extent=0.6):
    xy = (rng.random((n, 2)) - 0.5) * extent
    zs = z + 0.05 * np.sin(9 * xy[:, :1]) + 0.01 * rng.normal(size=(n, 1))
    return np.concatenate([xy, zs], 1).astype(np.float32)


def _hash_case(kind):
    rng = np.random.default_rng(1)
    if kind == "plane":
        pts = _plane_points(rng)
        pts[:5] = np.nan
        pts[5:8, 2] = 5e3                   # past the 1 km range gate
    else:
        scene = OracleScene(seed=4)
        K = scene.intrinsics((48, 64), fov_scale=1.5)
        _, hits = scene.raycast(T_ID, K, (48, 64))
        pts = hits.astype(np.float32)
    conf = rng.uniform(0.0, 1.0, pts.shape[0]).astype(np.float32)
    origin = np.array([0.01, -0.02, 0.0], np.float32)
    q = pts[100:700] + rng.normal(size=(600, 3)).astype(np.float32) * 0.02
    return pts, conf, origin, q


def _integrate_twice(h, pts, conf, origin):
    """Two integrations (the second with a lower confidence gate and
    another order), the shapes of a keyframe integrated then re-integrated
    after a pose update."""
    a = h.integrate(pts, conf, origin, 0.2)
    b = h.integrate(pts[::-1] * 1.01, conf[::-1], origin, 0.0)
    return a, b


@pytest.mark.parametrize("kind", ["plane", "oracle"])
def test_native_hash_matches_plain_version_and_jax(kind):
    pts, conf, origin, q = _hash_case(kind)
    args = (1 << 16, 0.02, 0.08, 100.0)
    native, plain, jax_hash = (TN.NativeVoxelHash(*args),
                               TN.PyVoxelHash(*args),
                               JN.NativeVoxelHash(*args))
    counts = [_integrate_twice(h, pts, conf, origin)
              for h in (native, plain, jax_hash)]
    assert counts[0] == counts[1] == counts[2] and counts[0][0] > 1000
    stats = [h.stats() for h in (native, plain, jax_hash)]
    assert stats[0] == stats[1] == stats[2], stats
    t0, g0, v0 = native.query(q)
    assert 100 < v0.sum() < v0.size
    for other in (plain, jax_hash):
        t1, g1, v1 = other.query(q)
        np.testing.assert_array_equal(v1, v0)
        np.testing.assert_allclose(t1, t0, rtol=0, atol=TSDF_TOL)
        np.testing.assert_allclose(g1, g0, rtol=0,
                                   atol=TSDF_TOL / (2 * 0.02))


def test_native_hash_load_cap_matches_plain_version():
    """A table too small for the scene refuses inserts past 90% load, in
    both versions alike."""
    pts, conf, origin, _ = _hash_case("plane")
    args = (512, 0.02, 0.08, 100.0)
    native, plain = TN.NativeVoxelHash(*args), TN.PyVoxelHash(*args)
    assert (native.integrate(pts, conf, origin)
            == plain.integrate(pts, conf, origin))
    assert native.stats() == plain.stats()
    assert native.stats()["failed_inserts"] > 0
    # an insert is refused once size * 10 >= capacity * 9
    assert native.num_voxels() == plain.num_voxels() == 461


def test_make_voxel_hash_raises_when_the_build_fails(monkeypatch, tmp_path):
    """No silent numpy fallback: without a compiler the hash raises."""
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_BUILD", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="native TSDF hash"):
        TN.make_voxel_hash(1 << 10)


def test_voxel_hash_roundtrip():
    v = TN.make_voxel_hash(1 << 16, voxel_size=0.02, trunc=0.08)
    assert isinstance(v, TN.NativeVoxelHash)
    rng = np.random.default_rng(5)
    xy = (rng.random((5000, 2)) - 0.5) * 0.4
    pts = np.concatenate([xy, np.ones((5000, 1))], 1).astype(np.float32)
    v.integrate(pts, np.ones(5000), np.zeros(3))
    assert v.num_voxels() > 100
    tsdf, grad, valid = v.query(np.array([[0, 0, 0.97], [0, 0, 1.03]],
                                         np.float32))
    assert valid.all()
    assert tsdf[0] > 0 > tsdf[1]
    assert grad[0, 2] < 0  # TSDF decreases along +z through the surface


# ---------------------------------------------------------------------------
# The pose optimizer against JAX
# ---------------------------------------------------------------------------

def _flat(rng, n, extent):
    xy = (rng.random((n, 2)) - 0.5) * extent
    return np.concatenate([xy, np.ones((n, 1))], 1).astype(np.float32)


def _plane_scene():
    """tests/test_tsdf.py's plane: the world at z = 1 seen from the origin,
    the keyframe's points on it, its pose 3 cm off along z."""
    rng = np.random.default_rng(0)
    cfg = {"tsdf_global": {"voxel_size": 0.02, "trunc_dist": 0.1,
                           "samples_per_kf": 1500, "lambda": 1.0,
                           "max_iterations": 10, "min_confidence": 0.0,
                           "table_capacity": 1 << 16}}
    world = _flat(rng, 8000, 0.8)
    X_cam = _flat(rng, 32 * 32, 0.6)
    T_off = np.asarray(JL.exp(jnp.asarray([0, 0, 0.03, 0, 0, 0, 0.0])))
    return cfg, world, X_cam, T_off, (32, 32)


def _oracle_scene():
    scene = OracleScene(seed=4)
    h = w = 32
    K = scene.intrinsics((h, w), fov_scale=1.5)
    X_cam, _ = scene.raycast(T_ID, K, (h, w))
    cfg = {"tsdf_global": {"voxel_size": 0.02, "trunc_dist": 0.1,
                           "samples_per_kf": 1024, "lambda": 1.0,
                           "max_iterations": 12, "min_confidence": 0.0,
                           "table_capacity": 1 << 18}}
    # a denser raycast of the same view keeps the narrow band contiguous
    Kd = scene.intrinsics((128, 128), fov_scale=1.5)
    _, hits_dense = scene.raycast(T_ID, Kd, (128, 128))
    xi = np.asarray([0.015, -0.01, 0.025, 0.01, -0.008, 0.006, 0.0],
                    np.float32)
    T_off = np.asarray(JL.compose(JL.exp(jnp.asarray(xi)),
                                  jnp.asarray(T_ID)))
    return (cfg, hits_dense.astype(np.float32), X_cam, T_off, (h, w),
            scene, xi)


def _both_optimizers(cfg, world, X_cam, T_off, hw):
    h, w = hw
    jk, tk = keyframe_pair(X_cam, np.ones(h * w, np.float32), T_off, h, w)
    jv, tv = JG.TSDFVolume(cfg), TG.TSDFVolume(cfg)
    for v in (jv, tv):
        v.integrate(world, np.ones(world.shape[0]), np.zeros(3))
    return (JG.TSDFPoseOptimizer(jv, jk, cfg), jk,
            TG.TSDFPoseOptimizer(tv, tk, cfg), tk)


@pytest.mark.parametrize("scene", ["plane", "oracle"])
def test_optimize_single_matches_jax(scene):
    case = _plane_scene() if scene == "plane" else _oracle_scene()[:5]
    jo, jk, to, tk = _both_optimizers(*case)
    assert jo.optimize_single(0) and to.optimize_single(0)
    np.testing.assert_allclose(tk.T_WC[0].numpy(), np.asarray(jk.T_WC[0]),
                               rtol=0, atol=POSE_TOL)
    assert tk.version[0] == jk.version[0] == 1
    assert not np.allclose(tk.T_WC[0].numpy(), case[3], atol=1e-4)


def test_optimize_single_discards_when_the_pose_moved():
    cfg, world, X_cam, T_off, hw = _plane_scene()
    _, _, to, tk = _both_optimizers(cfg, world, X_cam, T_off, hw)
    orig = to.volume.query

    def query_then_ba_writes(points):
        if tk.version[0] == 0:
            tk.update_T_WCs(torch.from_numpy(T_off)[None], [0])
        return orig(points)

    to.volume.query = query_then_ba_writes
    assert not to.optimize_single(0)
    np.testing.assert_array_equal(tk.T_WC[0].numpy(), T_off)
    assert tk.version[0] == 1 and to.refined == 0


def test_tsdf_pose_optimizer_reduces_offset():
    """A keyframe pose offset along z is pulled back toward the surface."""
    cfg, world, X_cam, T_off, hw = _plane_scene()
    _, _, to, tk = _both_optimizers(cfg, world, X_cam, T_off, hw)
    assert to.optimize_single(0)
    assert abs(tk.T_WC[0, 2].item()) < 0.03 * 0.7, tk.T_WC[0, :3]


def test_tsdf_pose_optimizer_curved_oracle_surface():
    """On curved oracle geometry the keyframe's points come back onto the
    true surface (the observable part; sliding directions stay bounded)."""
    cfg, world, X_cam, T_off, hw, scene, xi = _oracle_scene()
    _, _, to, tk = _both_optimizers(cfg, world, X_cam, T_off, hw)
    err0 = float(torch.linalg.norm(TL.log(tk.T_WC[0])))
    assert to.optimize_single(0)
    err1 = float(torch.linalg.norm(TL.log(tk.T_WC[0])))

    def surf_res(T):
        Xw = TL.act(torch.as_tensor(T)[None], torch.from_numpy(X_cam)).numpy()
        return float(np.mean(np.abs(Xw[:, 2]
                                    - scene.height(Xw[:, 0], Xw[:, 1]))))

    r0, r1 = surf_res(T_off), surf_res(tk.T_WC[0])
    assert r1 < r0 * 0.5, (r0, r1)
    assert err1 < err0 * 2.0, (err0, err1)


# ---------------------------------------------------------------------------
# The manager
# ---------------------------------------------------------------------------

class _Graph:
    def __init__(self, unique):
        self.last_unique_kf_idx = unique


def test_on_after_backend_solve_marks_the_keyframes_past_pin():
    cfg = {"tsdf_global": {"enabled": True, "table_capacity": 1 << 12},
           "local_opt": {"pin": 2}}
    _, tk = keyframe_pair(np.ones((16, 3), np.float32),
                          np.ones(16, np.float32), T_ID, 4, 4)
    m = TG.TSDFGlobalManager(tk, cfg)
    m.on_after_backend_solve(_Graph(np.arange(5)))      # not started: no-op
    assert not m.opt_thread.queue
    m._started = True           # the hook alone, without the threads
    m.on_after_backend_solve(_Graph(None))
    m.on_after_backend_solve(_Graph(np.array([0, 1, 3, 4])))
    m.on_after_backend_solve(_Graph(np.array([0, 1, 4, 6])))
    assert list(m.integrator.reintegration_queue) == [3, 4, 6]
    assert list(m.opt_thread.queue) == [3, 4, 6]


def test_manager_threads_integrate_refine_and_stop():
    """Started, the integrator fills the volume from the keyframes and the
    optimizer refines a marked keyframe; shutdown joins both threads."""
    cfg, world, X_cam, T_off, hw = _plane_scene()
    cfg = {"tsdf_global": dict(cfg["tsdf_global"], enabled=True,
                               queue_check_interval=0.01),
           "local_opt": {"pin": 0}}
    h, w = hw
    _, tk = keyframe_pair(world[: h * w], np.ones(h * w, np.float32), T_ID,
                          h, w)
    m = TG.TSDFGlobalManager(tk, cfg).start()
    try:
        deadline = time.monotonic() + WAIT_S
        while (m.integrator.integrated_until < 1
               and time.monotonic() < deadline):
            time.sleep(0.02)
        assert m.volume.stats()["voxels"] > 100
        m.on_after_backend_solve(_Graph(np.array([0])))
        while m.optimizer.refined < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert m.optimizer.refined == 1
    finally:
        m.shutdown()
    assert not m.integrator.is_alive() and not m.opt_thread.is_alive()
