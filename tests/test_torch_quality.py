"""The port's quality service (``mast3r_slam_tpu_torch/services/
quality_core.py``, ``quality_async.py``) against the JAX package's on the
CPU: the same numpy-seeded inputs through both. Float fields within 1e-6
absolute, ``class_id`` equal. Counterparts of tests/test_quality.py follow;
every thread wait is bounded at 30 s and every started service is shut
down in a ``finally``."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.services import quality_core as JQ
from mast3r_slam_tpu_torch.services import quality_core as TQ
from mast3r_slam_tpu_torch.services.quality_async import (
    AsynchronousQualityService)
from torch_parity import torch_one_thread  # noqa: F401

ATOL = 1e-6
FIELDS = ("delta_cov", "r", "u", "class_id", "priority", "cov_ewma")
ARGS = dict(alpha=0.8, b0=0.15, theta0=float(np.deg2rad(10.0)), C_thr=1.0,
            Q_thr=1.5, thr_zr=1.0, thr_zu=1.0, thr_dc=0.02)
WAIT_S = 30.0
# 64x96 is a 4x6 grid (24 patches, an even count for robust_z), 48x80 a
# 3x5 grid (15, odd)
GRIDS = [(64, 96), (48, 80)]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _check_fields(got, want, where=""):
    for k in FIELDS:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (k, g.shape, w.shape)
        if k == "class_id":
            np.testing.assert_array_equal(g, w, err_msg=f"{k} {where}")
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL,
                                       err_msg=f"{k} {where}")


def _job_arrays(rng, n, B=None):
    shape = (n,) if B is None else (B, n)
    return dict(valid_kf=rng.random(shape) > 0.2,
                r_pix=rng.random(shape).astype(np.float32),
                Ck=rng.uniform(0.1, 2.0, shape).astype(np.float32),
                Qk=rng.uniform(0.1, 3.0, shape).astype(np.float32))


@pytest.mark.parametrize("hw", GRIDS)
def test_masked_median_and_reduce_grid_match_jax(hw):
    """The lower-middle median of an even count and the mean, masked and
    unmasked, on a 64x96 (even patch size counts) and a 48x80 grid."""
    rng = np.random.default_rng(1)
    x = rng.random(hw).astype(np.float32)
    valid = rng.random(hw) > 0.4
    valid[:16, :16] = False                        # one empty patch
    for kw in (dict(), dict(method="mean"), dict(valid=valid),
               dict(valid=valid, method="mean")):
        jkw = dict(kw, valid=jnp.asarray(kw["valid"])) if "valid" in kw \
            else kw
        tkw = dict(kw, valid=_t(kw["valid"])) if "valid" in kw else kw
        got = TQ.reduce_grid(_t(x), 16, **tkw).numpy()
        want = np.asarray(JQ.reduce_grid(jnp.asarray(x), 16, **jkw))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                   err_msg=str(kw.keys()))
    X = rng.random((6, 32)).astype(np.float32)
    m = rng.random((6, 32)) > 0.5
    m[0] = False
    np.testing.assert_array_equal(
        TQ.masked_median(_t(X), _t(m)).numpy(),
        np.asarray(JQ.masked_median(jnp.asarray(X), jnp.asarray(m))))


@pytest.mark.parametrize("n", [24, 15, 768])
def test_robust_z_takes_the_mean_of_the_middle_pair_like_jax(n):
    """``jnp.median`` averages the two middle values of an even count
    (24 and 768 patches: the 384x512 grid); ``torch.median`` would not."""
    x = np.random.default_rng(n).random(n).astype(np.float32)
    got = TQ.robust_z(_t(x)).numpy()
    want = np.asarray(JQ.robust_z(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the convention is visible: [1, 2, 3, 10] has median 2.5 and MAD 1.0
    # (the lower-middle convention would give 2 and 1, so z[1] = 0)
    z = TQ.robust_z(torch.tensor([1.0, 2.0, 3.0, 10.0]))
    assert z[1].item() == pytest.approx(-0.5 / (1.0 + 1e-6))


@pytest.mark.parametrize("hw", GRIDS)
def test_compute_quality_matches_jax(hw):
    H, W = hw
    rng = np.random.default_rng(2)
    a = _job_arrays(rng, H * W)
    prev = rng.random((H // 16, W // 16)).astype(np.float32)
    tn, th = np.float32(0.07), np.float32(0.12)
    got = TQ.compute_quality(*(_t(a[k]) for k in a), torch.tensor(tn),
                             torch.tensor(th),
                             _t(prev), H, W, 16, *ARGS.values())
    want = JQ.compute_quality(*(jnp.asarray(a[k]) for k in a),
                              jnp.asarray(tn), jnp.asarray(th),
                              jnp.asarray(prev), H, W, 16, *ARGS.values())
    _check_fields({k: v.numpy() for k, v in got.items()}, want)


@pytest.mark.parametrize("hw", GRIDS)
def test_compute_quality_batch_interleaved_matches_jax(hw):
    """A batch ``[A, B, A]`` with the chain set where the keyframe repeats
    the previous job's (here none), then ``[A, A, B]`` with it set."""
    H, W = hw
    rng = np.random.default_rng(3)
    B = 3
    a = _job_arrays(rng, H * W, B)
    tn = rng.random(B).astype(np.float32)
    th = (rng.random(B) * 0.2).astype(np.float32)
    prev = rng.random((B, H // 16, W // 16)).astype(np.float32)
    for chain in ([False, False, False], [False, True, False]):
        chain = np.asarray(chain)
        got = TQ.compute_quality_batch(
            *(_t(a[k]) for k in a), _t(tn), _t(th), _t(prev), chain,
            H, W, 16, *ARGS.values())
        want = JQ.compute_quality_batch(
            *(jnp.asarray(a[k]) for k in a), jnp.asarray(tn),
            jnp.asarray(th), jnp.asarray(prev), jnp.asarray(chain),
            H, W, 16, *ARGS.values())
        _check_fields({k: v.numpy() for k, v in got.items()}, want,
                      f"chain {chain}")


def test_upsample_to_hw_matches_jax():
    g = np.arange(12, dtype=np.float32).reshape(3, 4)
    for h, w in ((48, 64), (50, 61)):
        np.testing.assert_array_equal(
            TQ.upsample_to_hw(_t(g), h, w).numpy(),
            np.asarray(JQ.upsample_to_hw(jnp.asarray(g), h, w)))


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------

def _svc(**q):
    return AsynchronousQualityService({"quality": q}, device="cpu")


def _mk(rng, kf_id, frame_id, H=32, W=48, tensors=False):
    n = H * W
    job = {"kf_id": kf_id, "frame_id": frame_id, "H": H, "W": W,
           **_job_arrays(rng, n), "t_norm": float(rng.random()),
           "theta": float(rng.random() * 0.2)}
    if tensors:     # the tracker's form: tensors, 0-d t_norm / theta
        job = {k: (torch.as_tensor(v) if isinstance(v, (np.ndarray, float))
                   else v) for k, v in job.items()}
    return job


def _wait(cond):
    deadline = time.monotonic() + WAIT_S
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("tensors", [False, True])
def test_process_group_equals_sequential_bit_for_bit(tensors):
    """An interleaved batch [A, B, A] through ``_process_group`` publishes
    the same bits and EWMA state as ``_process`` job by job, from numpy
    jobs and from the tracker's tensor jobs."""
    rng = np.random.default_rng(4)
    jobs = [_mk(rng, 3, 0, tensors=tensors), _mk(rng, 8, 1, tensors=tensors),
            _mk(rng, 3, 2, tensors=tensors)]
    seq, grp = _svc(batch_size=4), _svc(batch_size=4)   # never started
    for j in jobs:
        seq._process(dict(j))
    grp._process_group([dict(j) for j in jobs])
    for fid in (0, 1, 2):
        a, b = seq.get_by_frame_id(fid), grp.get_by_frame_id(fid)
        for k in FIELDS:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{k} {fid}")
    for kf in (3, 8):
        np.testing.assert_array_equal(grp._ewma_state[kf],
                                      seq._ewma_state[kf])


def test_service_results_match_jax_service():
    """The same jobs through both packages' services (direct calls)."""
    from mast3r_slam_tpu.services.quality_async import (
        AsynchronousQualityService as JService)

    rng = np.random.default_rng(5)
    jobs = [_mk(rng, k, f) for f, k in enumerate((2, 2, 5, 2))]
    cfg = {"quality": {"batch_size": 4}}
    port, jx = _svc(batch_size=4), JService(cfg)
    port._process_group([dict(j) for j in jobs[:3]])
    jx._process_group([dict(j) for j in jobs[:3]])
    port._process(dict(jobs[3]))
    jx._process(dict(jobs[3]))
    for fid in range(4):
        _check_fields(port.get_by_frame_id(fid), jx.get_by_frame_id(fid),
                      f"frame {fid}")
    assert port.global_stats() == pytest.approx(jx.global_stats(), abs=ATOL)


def test_masked_median_matches_torch_nanmedian():
    """The lower middle element for even counts, as torch.nanmedian."""
    rng = np.random.default_rng(11)
    x = rng.random((6, 32)).astype(np.float32)
    mask = rng.random((6, 32)) > 0.4
    got = TQ.masked_median(_t(x), _t(mask)).numpy()
    want = torch.nanmedian(torch.where(_t(mask), _t(x), float("nan")),
                           dim=-1).values.numpy()
    np.testing.assert_array_equal(got, want)


def test_reduce_grid_shapes():
    x = np.random.default_rng(12).random((64, 96)).astype(np.float32)
    assert TQ.reduce_grid(_t(x), 16).shape == (4, 6)
    g2 = TQ.reduce_grid(_t(x), 16, valid=torch.ones(64, 96, dtype=bool),
                        method="mean")
    np.testing.assert_allclose(
        g2.numpy(), x.reshape(4, 16, 6, 16).transpose(0, 2, 1, 3)
        .reshape(4, 6, -1).mean(-1), atol=1e-5)


def test_compute_quality_flags_bad_region():
    """A patch with high residual + low confidence gets the top priority."""
    H, W, ps = 64, 96, 16
    n = H * W
    r_pix = np.full(n, 0.01, np.float32)
    Ck = np.full(n, 2.0, np.float32)
    Qk = np.full(n, 3.0, np.float32)
    bad = np.zeros((H, W), bool)
    bad[16:32, 32:48] = True  # patch (1, 2)
    r_pix[bad.ravel()] = 0.5
    Ck[bad.ravel()] = 0.05
    Qk[bad.ravel()] = 0.1
    res = TQ.compute_quality(
        torch.ones(n, dtype=bool), _t(r_pix), _t(Ck), _t(Qk),
        torch.tensor(0.2), torch.tensor(0.1), torch.zeros(H // ps, W // ps),
        H, W, ps, 0.8, 0.15, np.deg2rad(10.0), 1.0, 1.5, 1.0, 1.0, 0.02)
    pri = res["priority"].numpy()
    assert pri[1, 2] == pri.max() > 0.5
    assert res["class_id"][1, 2].item() in (1, 2, 3)


def test_async_service_end_to_end():
    svc = _svc(batch_size=2, max_wait_ms=5)
    try:
        svc.start()
        rng = np.random.default_rng(13)
        job = _mk(rng, 7, 3)
        job.update(Ck=np.ones(32 * 48, np.float32),
                   Qk=np.ones(32 * 48, np.float32))
        hits = []
        svc.register_callback(lambda res: hits.append(res["kf_id"]))
        assert svc.submit(dict(job))
        assert _wait(lambda: svc.get_by_kf_id(7) is not None)
        res = svc.get_by_kf_id(7)
        assert res["priority"].shape == (2, 3)
        assert svc.get_by_frame_id(3) is not None
        assert hits == [7]
        # EWMA state persists: a second job for the same kf grows coverage
        ew1 = res["cov_ewma"].copy()
        svc.submit(dict(job))
        assert _wait(lambda: svc.processed_jobs >= 2)
        assert (svc.get_by_kf_id(7)["cov_ewma"] >= ew1 - 1e-6).all()
        assert svc.global_stats()["n"] == 2
    finally:
        svc.shutdown()
    assert not svc.is_alive()


def test_async_service_batches_into_one_call(monkeypatch):
    """4 queued same-kf jobs drain through one ``_process_group`` and the
    EWMA chain equals sequential submission."""
    from mast3r_slam_tpu_torch.services import quality_async as QA

    calls = {"group": 0, "single": 0}
    orig_group = QA.AsynchronousQualityService._process_group
    orig_single = QA.AsynchronousQualityService._process

    def spy_group(self, jobs):
        calls["group"] += 1
        return orig_group(self, jobs)

    def spy_single(self, job):
        calls["single"] += 1
        return orig_single(self, job)

    monkeypatch.setattr(QA.AsynchronousQualityService, "_process_group",
                        spy_group)
    monkeypatch.setattr(QA.AsynchronousQualityService, "_process", spy_single)
    rng = np.random.default_rng(14)
    jobs = [_mk(rng, 3, f) for f in range(4)]

    seq = _svc(batch_size=1, max_wait_ms=1)
    try:
        seq.start()
        for j in jobs:
            seq.submit(dict(j))
            assert _wait(lambda: seq.processed_jobs >= j["frame_id"] + 1)
        ref = seq.get_by_kf_id(3)
    finally:
        seq.shutdown()

    svc = _svc(batch_size=4, max_wait_ms=200)
    try:
        calls["group"] = calls["single"] = 0
        # the first submit starts the worker, which waits up to 200 ms for
        # the batch to fill
        for j in jobs:
            assert svc.submit(dict(j))
        assert _wait(lambda: svc.processed_jobs >= 4)
        got = svc.get_by_kf_id(3)
    finally:
        svc.shutdown()
    assert calls == {"group": 1, "single": 0}, calls
    for key in ("cov_ewma", "priority", "class_id", "r"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_service_drops_on_full_queue_and_counts(monkeypatch):
    """A full job queue drops and counts; processed + dropped covers every
    submission once the worker has drained."""
    svc = _svc(batch_size=4, max_wait_ms=1)
    rng = np.random.default_rng(15)
    job = _mk(rng, 1, 0)
    monkeypatch.setattr(svc, "start", lambda: svc)   # hold the worker
    for _ in range(64):
        assert svc.submit(dict(job))
    try:
        assert not svc.submit(dict(job))
        assert svc.dropped_jobs == 1
        AsynchronousQualityService.start(svc)
        assert _wait(lambda: svc.processed_jobs == 64)
        assert svc.processed_jobs + svc.dropped_jobs == 65
    finally:
        svc.shutdown()
