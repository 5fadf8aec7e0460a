"""Rules the PyTorch port keeps: no JAX, on the card by default, no hidden
fallback from a kernel to its plain version."""

import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mast3r_slam_tpu_torch import _build
from mast3r_slam_tpu_torch import main as cli
from mast3r_slam_tpu_torch.bench import (ate_study, ba_solve_microbench,
                                         bench_ba, debug_oracle_fail,
                                         eval_datasets, gram_kernel_bench,
                                         profile_backend_decode,
                                         profile_refine, retrieval_recall,
                                         trace_breakdown, validate_real)
from mast3r_slam_tpu_torch.models import convert, mast3r
from mast3r_slam_tpu_torch.ops import ba_kernels as BA
from mast3r_slam_tpu_torch.ops import gram_variants as GV
from mast3r_slam_tpu_torch.ops import conv3x3 as C3
from mast3r_slam_tpu_torch.ops import flash_attention as FA
from mast3r_slam_tpu_torch.services import quality_async, tsdf_local
from mast3r_slam_tpu_torch.slam import frame, pipeline
from mast3r_slam_tpu_torch.utils import oracle_scene

ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|cv2|PIL)\b|^\s*import\s+mast3r_slam_tpu\b"
    r"|^\s*from\s+mast3r_slam_tpu\s+import|mast3r_slam_tpu\.", re.M)


def _port_sources():
    """The package, chip_smoke.py, the test encoders chip_smoke.py writes
    its JPEG and PNG clips with and the resize fixtures' input maker."""
    files = sorted((ROOT / "mast3r_slam_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "tests" /
                    "torch_jpeg_writer.py", ROOT / "tests" /
                    "torch_png_writer.py", ROOT / "tests" /
                    "torch_resize_inputs.py"]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """Nor OpenCV or PIL, which the card machine lacks."""
    files = _port_sources()
    assert len(files) > 25
    names = {str(f.relative_to(ROOT)) for f in files}
    for mod in ("main.py", "evaluation.py", "data/png.py",
                "data/image_ops.py", "data/datasets.py", "data/imread.py",
                "data/jpeg.py", "data/undistort.py", "data/exif.py",
                "data/image_host.py", "bench/frame_profile.py",
                "slam/retrieval.py", "slam/pipeline.py",
                "utils/checkpoint.py", "utils/tictoc.py",
                "ops/gram_variants.py", "ops/device_loop.py", "ops/graphs.py",
                "bench/gram_kernel_bench.py", "bench/ate_study.py",
                "bench/eval_datasets.py", "bench/validate_real.py",
                "bench/retrieval_recall.py", "data/seven_scenes_gt.py",
                "bench/bench_ba.py", "bench/ba_solve_microbench.py",
                "bench/profile_backend_decode.py",
                "bench/trace_breakdown.py", "bench/profile_refine.py",
                "bench/debug_oracle_fail.py",
                "services/quality_core.py", "services/quality_async.py",
                "services/tsdf_local.py", "services/tsdf_global.py",
                "services/native_tsdf.py", "parallel/__init__.py",
                "parallel/sharding.py", "parallel/topology.py",
                "viz/render.py", "viz/viewer.py", "viz/ui.py",
                "viz/glctx.py"):
        assert f"mast3r_slam_tpu_torch/{mod}" in names, mod
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert not hits, hits


@pytest.mark.parametrize("fn,arg", [
    (mast3r.init_params, "device"), (convert.params_from_jax, "device"),
    (pipeline.create_frame, "device"), (frame.KeyframeBuffer, "device"),
    (oracle_scene.run_oracle_slam, "device"), (cli.main, "device"),
    (cli.build_model, "device"), (oracle_scene.OracleWorld, "device"),
    (gram_kernel_bench.main, "device"), (ate_study.main, "device"),
    (eval_datasets.main, "device"), (validate_real.main, "device"),
    (retrieval_recall.main, "device"), (bench_ba.main, "device"),
    (ba_solve_microbench.main, "device"),
    (profile_backend_decode.main, "device"), (trace_breakdown.main, "device"),
    (profile_refine.main, "device"), (debug_oracle_fail.main, "device"),
    (debug_oracle_fail.run, "device"), (profile_refine.run, "device"),
    (quality_async.AsynchronousQualityService, "device"),
    (tsdf_local.TSDFRefiner, "device")])
def test_entry_points_default_to_cuda(fn, arg):
    assert inspect.signature(fn).parameters[arg].default == "cuda"


@pytest.mark.parametrize("mod", [bench_ba, ba_solve_microbench,
                                 profile_backend_decode, profile_refine,
                                 debug_oracle_fail])
def test_backend_tools_raise_without_a_card(mod, monkeypatch):
    """The backend speed tools run on the card by default and raise where
    there is none; they never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        mod.main([])


def test_builder_without_nvcc_raises(monkeypatch, tmp_path):
    """With no CUDA compiler the builder raises an error that names it; it
    never hands back the plain version."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has nvcc")
    for name in (FA.KERNEL, C3.KERNEL, BA.KERNEL):
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load(name)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all([FA.KERNEL, C3.KERNEL, BA.KERNEL])


def test_kernel_sources_exist_and_build_names_are_content_keyed():
    for name in (FA.KERNEL, C3.KERNEL, BA.KERNEL):
        src = _build.CSRC / f"{name}.cu"
        assert src.is_file()
        text = src.read_text()
        assert 'extern "C"' in text and f"{name}_error_string" in text
        p = _build.library_path(name)
        assert p.parent == _build.BUILD and p.name.startswith(f"lib{name}-")
        assert p == _build.library_path(name)
    assert GV.KERNEL == BA.KERNEL
    assert 'extern "C" int ba_gram_variant' in (
        _build.CSRC / f"{BA.KERNEL}.cu").read_text()


def test_kernel_setup_is_per_device():
    """Each launcher raises its kernel's dynamic shared-memory limit once
    per device (``csrc/device_once.cuh``), never once per process: the
    attribute belongs to the current device, so a process-wide flag would
    leave a second card at the default 48 KB. The shared header is part of
    every library's build key."""
    header = (_build.CSRC / "device_once.cuh").read_text()
    assert "cudaGetDevice" in header and "std::atomic" in header
    for name in (FA.KERNEL, C3.KERNEL, BA.KERNEL):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "device_once.cuh"' in text
        assert "static bool" not in text
        sites = text.count("cudaFuncSetAttribute(")
        assert sites >= 1 and text.count("PerDeviceOnce") >= sites, name


def test_library_key_covers_the_shared_header(monkeypatch, tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in _build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.library_path(C3.KERNEL)
    (csrc / "device_once.cuh").write_text(
        (csrc / "device_once.cuh").read_text() + "\n// edited\n")
    assert _build.library_path(C3.KERNEL) != before


def test_k1_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(61)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 20, 64))
                                .astype(np.float32)) for _ in range(3))
    pos = mast3r.patch_positions(4, 5, 1, "cpu")
    cos, sin = FA.rope_tables(pos, 64)
    before = FA.counter.launches
    got = FA.flash_attention_rope(q, k, v, cos, sin, cos, sin)
    want = FA.flash_attention_rope_ref(q, k, v, cos, sin, cos, sin)
    assert torch.equal(got, want)
    assert FA.counter.launches == before


def test_k2_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(62)
    x = torch.from_numpy(rng.normal(size=(1, 6, 7, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 5, 4)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))
    before = C3.counter.launches
    assert torch.equal(C3.conv3x3(x, w, b), C3.conv3x3_ref(x, w, b))
    assert C3.counter.launches == before


def test_k3_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(64)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, n, 64))
                                .astype(np.float32)) for n in (20, 33, 33))
    before = (FA.attn_counter.launches, FA.counter.launches)
    assert torch.equal(FA.flash_attention(q, k, v),
                       FA.flash_attention_ref(q, k, v))
    assert torch.equal(mast3r.attention(q, k, v),
                       FA.flash_attention_ref(q, k, v))
    assert (FA.attn_counter.launches, FA.counter.launches) == before


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; anything else launches the
    kernel or raises (here: tensors on the meta device)."""
    q = torch.empty(1, 2, 8, 64, device="meta")
    tab = torch.empty(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        FA.flash_attention_rope(q, q, q, tab, tab, tab, tab)
    with pytest.raises(ValueError, match="device"):
        FA.flash_attention(q, q, q)
    x = torch.empty(1, 4, 4, 8, device="meta")
    w = torch.empty(3, 3, 8, 8, device="meta")
    with pytest.raises(ValueError, match="device"):
        C3.conv3x3(x, w)


def _ba_inputs(device, kind):
    n_ch, cols = (8, 13) if kind == "rays" else (7, 17)
    rng = np.random.default_rng(63)
    rts = rng.normal(size=(2, cols)).astype(np.float32)
    rts[:, 12] = 1.0                          # the edge mask
    rts = torch.from_numpy(rts)
    meas = [torch.from_numpy(rng.uniform(0.5, 2, (2, 300)).astype(
        np.float32)) for _ in range(n_ch)]
    return rts.to(device), [m.to(device) for m in meas]


@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_k4_k5_wrappers_on_cpu_are_the_plain_versions(kind):
    rts, meas = _ba_inputs("cpu", kind)
    before = (BA.rays_counter.launches, BA.calib_counter.launches)
    if kind == "rays":
        got = BA.gram_rays(rts, meas, 0.003, 10.0)
        want = BA.gram_rays_ref(rts, meas, 0.003, 10.0)
    else:
        args = ((24, 32), -10.0, 1e-6, 1.0, 10.0)
        got = BA.gram_calib(rts, meas, *args)
        want = BA.gram_calib_ref(rts, meas, *args)
    assert torch.equal(got, want)
    assert (BA.rays_counter.launches, BA.calib_counter.launches) == before


@pytest.mark.parametrize("kind", ["rays", "calib"])
def test_k4_k5_wrappers_refuse_other_devices(kind):
    rts, meas = _ba_inputs("meta", kind)
    with pytest.raises(ValueError, match="device"):
        if kind == "rays":
            BA.gram_rays(rts, meas, 0.003, 10.0)
        else:
            BA.gram_calib(rts, meas, (24, 32), -10.0, 1e-6, 1.0, 10.0)


_K4P = ("load", "rows", "diag", "one_product")


def _k4p_call(name, rts, meas, plain=False):
    fn = getattr(GV, f"gram_{name}" + ("_ref" if plain else ""))
    return fn(rts, meas) if name == "load" else fn(rts, meas, 0.003, 10.0)


def _k4p_counts():
    return tuple(getattr(GV, f"{n}_counter").launches for n in _K4P)


@pytest.mark.parametrize("name", _K4P)
def test_k4_prime_wrappers_on_cpu_are_the_plain_versions(name):
    rts, meas = _ba_inputs("cpu", "rays")
    before = _k4p_counts()
    assert torch.equal(_k4p_call(name, rts, meas),
                       _k4p_call(name, rts, meas, plain=True))
    assert _k4p_counts() == before


@pytest.mark.parametrize("name", _K4P)
def test_k4_prime_wrappers_refuse_other_devices(name):
    rts, meas = _ba_inputs("meta", "rays")
    with pytest.raises(ValueError, match="device"):
        _k4p_call(name, rts, meas)


def test_gram_bench_without_a_card_raises(monkeypatch):
    """The benchmark's default device is the card; without one it raises
    and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gram_kernel_bench.main(["--edges", "1", "--pixels", "8"])


@pytest.mark.parametrize("main,argv", [
    (ate_study.main, []),
    (eval_datasets.main, ["tum", "no_such_root"]),
    (validate_real.main, ["no_such.pth", "no_such_seq"]),
    (retrieval_recall.main, [])])
def test_accuracy_tools_without_a_card_raise(monkeypatch, main, argv):
    """The accuracy tools' default device is the card; without one each
    raises before it reads or runs anything, and never falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
