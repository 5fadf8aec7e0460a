"""Port parity: the disjoint device topology and the device slots
(mast3r_slam_tpu_torch/parallel/) against the JAX package's
``parallel/topology.py`` and ``parallel/sharding.py``, on the CPU.

The JAX side plans on conftest's 8 virtual CPU devices, the port on a list
of CPU slots (``[cpu] * n``, a device repeated as JAX's virtual devices
repeat the host): the roles must take the same slot numbers for every n.
Also here: the kernel wrappers' device guard (each C launch runs inside
the device context of the tensors it is given), checked with the C library
replaced by a recorder, since a CPU tensor never reaches a launch."""

import types

import jax
import numpy as np
import pytest
import torch

from mast3r_slam_tpu.parallel import sharding as JS
from mast3r_slam_tpu.parallel import topology as JT
from mast3r_slam_tpu_torch import _build
from mast3r_slam_tpu_torch.ops import ba_kernels as BA
from mast3r_slam_tpu_torch.ops import conv3x3 as C3
from mast3r_slam_tpu_torch.ops import flash_attention as FA
from mast3r_slam_tpu_torch.ops import gram_variants as GV
from mast3r_slam_tpu_torch.parallel import sharding as S
from mast3r_slam_tpu_torch.parallel import topology as T

CPU = torch.device("cpu")


def _jax_roles(t):
    """Role -> device id(s) of a JAX topology (ids of the virtual CPU
    devices are their slot numbers)."""
    def one(d):
        return None if d is None else d.id

    back = (() if t.backend_mesh is None
            else tuple(d.id for d in t.backend_mesh.devices.flat))
    return dict(frontend=one(t.frontend_device), backend=back,
                quality=one(t.quality_device),
                tsdf_local=one(t.tsdf_local_device),
                tsdf_global=one(t.tsdf_global_device))


def _port_roles(t):
    return dict(frontend=t.frontend, backend=t.backend, quality=t.quality,
                tsdf_local=t.tsdf_local, tsdf_global=t.tsdf_global)


@pytest.mark.parametrize("n", range(1, 9))
def test_plan_topology_assigns_jax_slots(n):
    """Slot for slot the JAX rule, for every slice size: one slot keeps
    everything local, n = 5 trades a backend slot for a service pool, n = 8
    gives every service a slot of its own; the frontend slot is never
    another role's."""
    assert len(jax.devices()) >= n
    want = JT.plan_topology(jax.devices()[:n])
    got = T.plan_topology([CPU] * n)
    assert _port_roles(got) == _jax_roles(want)
    assert got.n_backend == want.n_backend
    assert got.describe().startswith("frontend=")
    if n == 1:
        assert got.backend_mesh is None and got.quality_device is None
        assert got.frontend_device == CPU
        return
    mesh = got.backend_mesh
    assert mesh.size == got.n_backend and mesh.slots == got.backend
    assert mesh.devices == (CPU,) * mesh.size
    assert got.frontend not in got.backend
    for role in (got.quality, got.tsdf_local, got.tsdf_global):
        assert role != got.frontend
    for dev in (got.quality_device, got.tsdf_local_device,
                got.tsdf_global_device):
        assert dev == CPU


def test_plan_topology_without_devices():
    assert T.plan_topology([]).frontend_device is None
    if not torch.cuda.is_available():
        t = T.plan_topology()
        assert t.devices == () and t.backend_mesh is None


def test_pow2_floor_matches_jax():
    for n in range(1, 70):
        assert T._pow2_floor(n) == JT._pow2_floor(n)


def test_pad_to_multiple_matches_jax():
    for n in range(0, 20):
        for k in (1, 2, 3, 4, 8):
            assert S.pad_to_multiple(n, k) == JS.pad_to_multiple(n, k)


def test_mesh_needs_explicit_indices():
    with pytest.raises(ValueError, match="explicit"):
        S.DeviceMesh((torch.device("cuda"),), (0,))
    with pytest.raises(ValueError, match="one device per slot"):
        S.DeviceMesh((CPU, CPU), (0,))
    m = S.make_mesh(devices=["cpu"] * 3)
    assert m.slots == (0, 1, 2) and m.first == CPU and m.distinct() == (CPU,)
    assert S.make_mesh(2, devices=["cpu"] * 3).size == 2


def test_replicate_shares_one_copy_per_device():
    """Slots on one device share the caller's tensors (no copy of the
    parameters for a virtual layout)."""
    tree = {"a": torch.arange(6.0), "b": [torch.ones(2), (torch.zeros(1),)],
            "n": 3}
    reps = S.replicate(tree, S.make_mesh(devices=["cpu"] * 4))
    assert len(reps) == 4
    for r in reps:
        assert r["a"] is tree["a"] and r["b"][0] is tree["b"][0]
        assert r["b"][1][0] is tree["b"][1][0] and r["n"] == 3
        assert isinstance(r["b"][1], tuple)


@pytest.mark.parametrize("n_rows,n_slots", [(8, 4), (3, 4), (5, 2), (7, 3)])
def test_shard_leading_splits_in_slot_order(n_rows, n_slots):
    x = torch.arange(n_rows * 2).reshape(n_rows, 2)
    parts = S.shard_leading(x, S.make_mesh(devices=["cpu"] * n_slots))
    assert len(parts) == n_slots
    assert torch.equal(torch.cat(parts), x)
    sizes = [p.shape[0] for p in parts]
    assert max(sizes) - min(sizes) <= 1 and sizes == sorted(sizes,
                                                           reverse=True)


@pytest.mark.parametrize("device,bound", [
    ("cpu", None), ("cuda", None), ("cuda:1", torch.device("cuda", 1))])
def test_bind_thread_sets_only_a_named_card(monkeypatch, device, bound):
    """A worker binds its role's card; a CPU device or a bare "cuda" (the
    services' default, which names no card) leaves the thread as it is."""
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    S.bind_thread(device)
    assert calls == ([] if bound is None else [bound])


# ---------------------------------------------------------------------------
# The kernel wrappers' device guard
# ---------------------------------------------------------------------------

CARD = torch.device("cuda", 1)


class OnCard(torch.Tensor):
    """A CPU tensor that reports a second card as its device, so that a
    wrapper takes its launch path; the C library is a recorder."""

    @property
    def device(self):
        return CARD


def _on_card(x):
    return torch.Tensor._make_subclass(OnCard, x)


@pytest.fixture
def recorder(monkeypatch):
    """Replaces the C library, the current-device context, the stream,
    the SM count and device allocations: records for each C call the
    device whose context it ran in."""
    active, calls = [], []

    class DeviceCtx:
        def __init__(self, dev):
            self.dev = torch.device(dev)

        def __enter__(self):
            active.append(self.dev)

        def __exit__(self, *exc):
            active.pop()

    class Lib:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, active[-1] if active else None))
                return 2 if name.endswith("blocks_per_sm") else (
                    8 if name.endswith("vec_pixels") else 0)
            return call

    real = {n: getattr(torch, n) for n in ("empty", "zeros")}

    def host(fn):
        def alloc(*a, device=None, **kw):
            return fn(*a, **kw)
        return alloc

    for n, fn in real.items():
        monkeypatch.setattr(torch, n, host(fn))
    monkeypatch.setattr(torch.cuda, "device", DeviceCtx)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_build, "load", lambda name, entries=None: Lib())
    monkeypatch.setattr(_build, "sm_count", lambda dev: 132)
    BA._mma_blocks.clear()
    GV._rows_blocks.clear()
    GV._vec_pixels.clear()
    yield calls
    BA._mma_blocks.clear()
    GV._rows_blocks.clear()
    GV._vec_pixels.clear()


def _rand(*shape, dtype=torch.float32):
    rng = np.random.default_rng(sum(shape))
    return _on_card(torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dtype))


def _call_k1():
    q = _rand(1, 2, 16, 64, dtype=torch.bfloat16)
    tab = _rand(1, 16, 64)
    FA.flash_attention_rope(q, q, q, tab, tab, tab, tab)


def _call_k1_f32():
    q = _rand(1, 2, 16, 64)
    tab = _rand(1, 16, 64)
    FA.flash_attention_rope(q, q, q, tab, tab, tab, tab)


def _call_k3():
    q = _rand(1, 2, 16, 64, dtype=torch.bfloat16)
    FA.flash_attention(q, q, q)


def _call_k2(path):
    dt = torch.float32 if path in ("fma", "tf32x3") else torch.bfloat16
    x = _rand(1, 8, 8, 16, dtype=dt)
    w = _rand(3, 3, 16, 16, dtype=dt)
    C3.conv3x3(x, w, _rand(16, dtype=dt), path=path)


def _call_gram(kind, path):
    n_ch, cols = (8, 13) if kind == "rays" else (7, 17)
    rts = _rand(2, cols)
    meas = [_rand(2, 512) for _ in range(n_ch)]
    cdt = torch.float32 if path == "tf32" else torch.bfloat16
    if kind == "rays":
        BA.gram_rays(rts, meas, 0.003, 10.0, compute_dtype=cdt, path=path)
    else:
        BA.gram_calib(rts, meas, (16, 32), -10.0, 1e-6, 1.0, 10.0,
                      compute_dtype=cdt, path=path)


def _call_k4p(name):
    rts = _rand(2, 13)
    meas = [_rand(2, 512, dtype=torch.bfloat16) for _ in range(8)]
    if name == "load":
        GV.gram_load(rts, meas)
    else:
        getattr(GV, f"gram_{name}")(rts, meas, 0.003, 10.0)


CALLS = {
    "K1 bf16": (_call_k1, {"flash_attention_bf16"}),
    "K1 f32": (_call_k1_f32, {"flash_attention_rope"}),
    "K3": (_call_k3, {"flash_attention_bf16"}),
    "K2 igemm": (lambda: _call_k2("igemm"), {"conv3x3_igemm"}),
    "K2 tf32x3": (lambda: _call_k2("tf32x3"), {"conv3x3_tf32x3"}),
    "K2 fma": (lambda: _call_k2("fma"), {"conv3x3_nhwc"}),
    "K2 split": (lambda: C3.tf32_split_weights(_rand(3, 3, 16, 16)),
                 {"conv3x3_tf32_split"}),
    "K2 round": (lambda: C3.tf32_round_on_card(_rand(64)),
                 {"conv3x3_tf32_round"}),
    "K4 mma": (lambda: _call_gram("rays", "mma"),
               {"ba_gram_mma", "ba_gram_mma_blocks_per_sm"}),
    "K4 tf32": (lambda: _call_gram("rays", "tf32"),
                {"ba_gram_tf32", "ba_gram_tf32_blocks_per_sm"}),
    "K5 mma": (lambda: _call_gram("calib", "mma"),
               {"ba_gram_mma", "ba_gram_mma_blocks_per_sm"}),
    "K5 fma": (lambda: _call_gram("calib", "fma"), {"ba_gram"}),
    "K4' load": (lambda: _call_k4p("load"),
                 {"ba_gram_variant", "ba_gram_variant_vec_pixels"}),
    "K4' rows": (lambda: _call_k4p("rows"),
                 {"ba_gram_variant", "ba_gram_variant_vec_pixels",
                  "ba_gram_rows_blocks_per_sm"}),
    "K4' one_product": (lambda: _call_k4p("one_product"),
                        {"ba_gram_variant", "ba_gram_mma_blocks_per_sm"}),
    "K4' rn": (lambda: GV.rn_mismatches(0, 0x3F800000, 0x3F800010,
                                        device=CARD),
               {"ba_gram_rn_mismatches"}),
}


@pytest.mark.parametrize("case", sorted(CALLS))
def test_wrapper_launches_in_the_tensors_device_context(recorder, case,
                                                        monkeypatch):
    """Each C call that launches, or asks the occupancy calculator about
    the current device, runs inside ``torch.cuda.device`` of its tensors'
    card (here cuda:1, not the thread's current device)."""
    fn, entries = CALLS[case]
    if case == "K4' rn":
        # rn_mismatches allocates its counter itself and reads it back
        zeros = torch.zeros
        monkeypatch.setattr(torch, "zeros",
                            lambda *a, **kw: _on_card(zeros(*a, **kw)))
        monkeypatch.setattr(OnCard, "item", lambda self: 0, raising=False)
    fn()
    called = {name for name, _ in recorder}
    assert entries <= called, (entries, called)
    for name, dev in recorder:
        # two queries of constants touch no device
        if name.endswith(("_error_string", "_vec_pixels")):
            continue
        assert dev == CARD, (name, dev)

