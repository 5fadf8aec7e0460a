"""The port's trace breakdown (``bench/trace_breakdown.py``) against the JAX
repo's ``scripts/trace_breakdown.py``: one set of nested intervals written
as a JAX trace (TPU op and module lanes, run through the script in a
subprocess) and as a torch Chrome trace (``kernel`` events) give the same
self time per op, the same totals and, where the two sets of kind patterns
name the same group, the same kinds. Then a real ``torch.profiler`` CPU
trace (no device lane: the tool exits non-zero and names the lanes it
saw) and a synthetic trace with correlation ids and Python frames (the
grouping by source, graph replays included)."""

import gzip
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mast3r_slam_tpu_torch.bench import trace_breakdown as TB

ROOT = Path(__file__).resolve().parents[1]

# (name, start us, end us): nested on one lane; every self time a whole
# number of microseconds, so the script's rounded ms are exact
INTERVALS = [
    ("elementwise_add_kernel", 0, 1000),
    ("gather_rows", 100, 400),
    ("dot_gemm_1", 500, 800),
    ("reduce_sum", 600, 700),
    ("scatter_add_2", 1200, 1500),
    ("sort_keys", 1500, 1600),
    ("copy_transpose", 2000, 2250),
    ("mystery_op", 2300, 2400),
    ("gather_rows", 2500, 2600),
]
SELF_US = {"elementwise_add_kernel": 400, "gather_rows": 400,
           "dot_gemm_1": 200, "reduce_sum": 100, "scatter_add_2": 300,
           "sort_keys": 100, "copy_transpose": 250, "mystery_op": 100}
BUSY_US = 1850
# the JAX script's kind names -> the port's
KIND_MAP = {"gather/slice": "gather / index",
            "matmul/conv (MXU)": "gemm (cuBLAS / CUTLASS)",
            "scatter": "scatter / index_put", "sort/topk": "sort / top-k",
            "reduce": "reduce", "copy/transpose": "copy / memcpy / memset",
            "fusion (elementwise)": "elementwise", "other": "other"}


def _jax_trace(path):
    """The intervals on a TPU "XLA Ops" lane, their union on "XLA
    Modules"."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
         "args": {"name": "XLA Ops"}},
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 2,
         "args": {"name": "XLA Modules"}},
    ]
    events += [{"ph": "X", "pid": 1, "tid": 1, "name": n, "ts": a,
                "dur": b - a} for n, a, b in INTERVALS]
    events += [{"ph": "X", "pid": 1, "tid": 2, "name": "jit_step", "ts": a,
                "dur": b - a} for a, b in ((0, 1000), (1200, 1600),
                                           (2000, 2250), (2300, 2400),
                                           (2500, 2600))]
    path.parent.mkdir(parents=True, exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _torch_trace(path):
    events = [{"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": n,
               "ts": float(a), "dur": float(b - a),
               "args": {"correlation": k + 1, "stream": 7}}
              for k, (n, a, b) in enumerate(INTERVALS)]
    path.write_text(json.dumps({"traceEvents": events}))


def _parse_jax(out):
    """The script's busy line, top-op table and kind table."""
    busy = re.search(r"device busy: ([\d.]+) ms/rep .*?op-exclusive sum "
                     r"([\d.]+) ms/rep", out)
    ops, kinds, section = {}, {}, None
    for line in out.splitlines():
        if line.startswith("top 30 ops"):
            section = ops
        elif line.startswith("by source"):
            section = None
        elif line.startswith("by kind"):
            section = kinds
        elif section is not None and line.startswith("  "):
            t, name = line.split(None, 1)
            section[name.strip()] = float(t)
    return float(busy.group(1)), float(busy.group(2)), ops, kinds


def test_self_times_and_kinds_match_the_jax_script(tmp_path):
    jdir = tmp_path / "jax" / "plugins" / "profile" / "run"
    _jax_trace(jdir / "host.trace.json.gz")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "trace_breakdown.py"),
         str(tmp_path / "jax"), "1"], capture_output=True, text=True,
        timeout=120, check=True)
    busy_j, self_j, ops_j, kinds_j = _parse_jax(proc.stdout)
    _torch_trace(tmp_path / "torch.json")
    b = TB.breakdown(str(tmp_path / "torch.json"), n_reps=1)
    ops_t = {name: ms for name, ms, _, _, _ in b["kernels"]}
    assert ops_j == {n: round(us / 1e3, 3) for n, us in SELF_US.items()}
    assert ops_t == pytest.approx({n: us / 1e3 for n, us in
                                   SELF_US.items()}, abs=1e-9)
    assert {n: round(ms, 3) for n, ms in ops_t.items()} == ops_j
    assert busy_j == round(BUSY_US / 1e3, 2) == round(b["busy_ms"], 2)
    assert self_j == round(b["self_ms"], 2)
    assert b["busy_ms"] == pytest.approx(b["self_ms"]) == pytest.approx(
        BUSY_US / 1e3)
    want = {KIND_MAP[k]: t for k, t in kinds_j.items()}
    assert {k: round(t, 2) for k, t in b["by_kind"].items()} == want
    assert len(want) == len(KIND_MAP)          # every group exercised
    counts = {name: c for name, _, c, _, _ in b["kernels"]}
    assert counts["gather_rows"] == 2 and b["events"] == len(INTERVALS)


def test_directory_and_gzip_inputs(tmp_path):
    _torch_trace(tmp_path / "a.json")
    (tmp_path / "sub").mkdir()
    with gzip.open(tmp_path / "sub" / "b.json.gz", "wt") as f:
        f.write((tmp_path / "a.json").read_text())
    assert TB.find_trace(str(tmp_path)).endswith("b.json.gz")
    one = TB.breakdown(str(tmp_path), n_reps=2)
    two = TB.breakdown(str(tmp_path / "a.json"), n_reps=1)
    assert one["busy_ms"] * 2 == pytest.approx(two["busy_ms"])


def test_cpu_trace_has_no_device_lane(tmp_path, capsys):
    """A real ``torch.profiler`` trace of CPU work: no kernel lane, so the
    tool prints the lanes it saw and exits non-zero; ``--device cpu``
    reads its ``cpu_op`` lanes."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(32, 32)
    with profile(activities=[ProfilerActivity.CPU], with_stack=True) as p:
        (x @ x).sum()
    path = tmp_path / "cpu.json"
    p.export_chrome_trace(str(path))
    with pytest.raises(SystemExit) as exc:
        TB.main([str(path)])
    assert exc.value.code not in (0, None)
    out = capsys.readouterr().out
    assert "lanes found" in out and "cpu_op" in out
    assert "python_function" in out
    b = TB.main([str(path), "--device", "cpu"])
    assert b["events"] > 0
    assert any("mm" in name for name, *_ in b["kernels"])


def _frames_trace(with_ids):
    """Python frames of one thread, the runtime calls made in them and the
    kernels each launched (see the test below)."""
    frames = [
        ("mast3r_slam_tpu_torch/slam/factor_graph.py(542): add_factors",
         0, 1000, 1, None),
        ("mast3r_slam_tpu_torch/models/inference.py(251): match_symmetric",
         100, 500, 2, 1),
        ("mast3r_slam_tpu_torch/models/inference.py(285): _graphed",
         150, 480, 3, 2),
        ("mast3r_slam_tpu_torch/ops/graphs.py(568): run", 160, 470, 4, 3),
        ("mast3r_slam_tpu_torch/ops/device_loop.py(200): launch", 170, 200,
         5, 4),
        ("torch/functional.py(10): einsum", 600, 700, 6, 1),
        ("mast3r_slam_tpu_torch/ops/ba_kernels.py(391): _launch", 800, 900,
         7, 1),
    ]
    ev = []
    for name, a, b, i, parent in frames:
        args = {"Python id": i, "Python parent id": parent} if with_ids \
            else {}
        ev.append({"ph": "X", "cat": "python_function", "pid": 1, "tid": 1,
                   "name": name, "ts": float(a), "dur": float(b - a),
                   "args": args})
    for name, ts, corr in (("cudaGraphLaunch", 180, 10),
                           ("cudaLaunchKernel", 650, 11),
                           ("cudaLaunchKernel", 850, 12),
                           ("cudaMemsetAsync", 950, 13)):
        ev.append({"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1,
                   "name": name, "ts": float(ts), "dur": 5.0,
                   "args": {"correlation": corr, "External id": 0}})
    ev.append({"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1,
               "name": "aten::copy_", "ts": 960.0, "dur": 10.0,
               "args": {"External id": 5}})
    for cat, name, corr, ext, a, b in (
            ("kernel", "void at::native::vectorized_elementwise_kernel<4>()",
             10, 0, 1000, 1100),
            ("kernel", "void at::native::gather_kernel<>()", 10, 0, 1100,
             1200),
            ("kernel", "void loop_step_kernel()", 97, 0, 1210, 1250),
            ("kernel", "void gram_tc_kernel<(Tiles)0, false>(Params)", 12,
             0, 1300, 1400),
            ("kernel", "void at::native::reduce_kernel<512, 1>()", 11, 0,
             1400, 1450),
            ("gpu_memset", "Memset (Device)", 13, 0, 1500, 1510),
            ("kernel", "void copy_kernel()", 99, 5, 1600, 1620),
            ("kernel", "void orphan_kernel()", 98, 4, 1700, 1710)):
        ev.append({"ph": "X", "cat": cat, "pid": 0, "tid": 7, "name": name,
                   "ts": float(a), "dur": float(b - a),
                   "args": {"correlation": corr, "External id": ext}})
    for e in ev:              # a graph's kernels may come on another stream
        if e["name"] == "void loop_step_kernel()":
            e["tid"] = 150
    return {"traceEvents": ev}


@pytest.mark.parametrize("with_ids", [True, False])
def test_by_source_follows_correlation_to_the_port_frame(tmp_path,
                                                         with_ids):
    """A replay's kernels go under its ``cudaGraphLaunch`` and the deepest
    port frame outside the graph machinery (``match_symmetric``); an eager
    kernel under the deepest port frame around its launch (a torch frame
    is passed over); a kernel without a runtime call by its op's
    ``External id``; one with neither is a conditional loop's step of the
    replay before it (if no eager kernel came between), or else ``?``."""
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_frames_trace(with_ids)))
    b = TB.breakdown(str(path))
    graph = ("cudaGraphLaunch <- mast3r_slam_tpu_torch/models/inference.py"
             "(251): match_symmetric")
    add = "mast3r_slam_tpu_torch/slam/factor_graph.py(542): add_factors"
    want = {graph: 0.2 + 0.04, add: 0.05 + 0.01 + 0.02,
            "mast3r_slam_tpu_torch/ops/ba_kernels.py(391): _launch": 0.1,
            "?": 0.01}
    assert b["by_source"] == pytest.approx(want)
    assert b["replay_events"] == 3
    assert b["by_kind"]["K4 mma"] == pytest.approx(0.1)
    assert b["by_kind"]["reduce"] == pytest.approx(0.05)
    assert b["by_kind"]["copy / memcpy / memset"] == pytest.approx(0.03)


@pytest.mark.parametrize("name,kind", [
    ("void flash_pipelined_kernel<true>(__nv_bfloat16 const*, Strides)",
     "K1 flash attention + RoPE"),
    ("void rope_rotate_rows(__nv_bfloat16 const*)",
     "K1 flash attention + RoPE"),
    ("void flash_pipelined_kernel<false>(__nv_bfloat16 const*)",
     "K3 flash attention"),
    ("void conv3x3_igemm_kernel(__nv_bfloat16 const*)", "K2 igemm"),
    ("void conv3x3_tf32x3_kernel(float const*)", "K2 tf32x3"),
    ("void conv3x3_split_sum_kernel<float>(float const*)", "K2 split-K sum"),
    ("void gram_tc_kernel<(Tiles)0, true>(Params)", "K4 mma"),
    ("void (anonymous namespace)::gram_tc_kernel<((anonymous namespace)::"
     "Tiles)0, false>((anonymous namespace)::Params)", "K4 mma"),
    ("void (anonymous namespace)::gram_tc_kernel<((anonymous namespace)::"
     "Tiles)1, true>((anonymous namespace)::Params)", "K5 mma"),
    ("void (anonymous namespace)::reduce_kernel<true, false, 8>("
     "(anonymous namespace)::Params)", "K4' (Gram microbenchmark)"),
    ("void kernel<getrf_wo_pivot_params_<float, 0, 256, 1, 64, 64, 2>>()",
     "solve (cuSOLVER / trsm)"),
    ("void trsv_lt_exec<float, 32u, 32u, 4u, false, false>(int)",
     "solve (cuSOLVER / trsm)"),
    ("void gram_tc_kernel<(Tiles)1, false>(Params)", "K5 mma"),
    ("void gram_tc_kernel<(Tiles)3, true>(Params)",
     "K4' (Gram microbenchmark)"),
    ("void gram_tf32_kernel<false, false>(Params)", "K4 tf32"),
    ("void gram_tf32_kernel<true, true>(Params)", "K5 tf32"),
    ("void gram_sum_kernel(float const*, float*, int, int)",
     "K4/K5 sum pass"),
    ("void reduce_kernel<false, true, 8>(Params)",
     "K4' (Gram microbenchmark)"),
    ("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<float>)",
     "reduce"),
    ("loop_condition_kernel(unsigned long long, bool const*)",
     "loop condition"),
    ("void potrf_alg2_cta_upper<float>()", "solve (cuSOLVER / trsm)"),
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize", "gemm (cuBLAS / "
     "CUTLASS)"),
    ("nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT", "gemm (cuBLAS / CUTLASS)"),
    ("void at::native::index_elementwise_kernel<128, 4>()",
     "gather / index"),
    ("void at::native::indexing_backward_kernel<float>()",
     "scatter / index_put"),
    ("void cub::DeviceRadixSortOnesweepKernel<>()", "sort / top-k"),
    ("Memcpy DtoD (Device -> Device)", "copy / memcpy / memset"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::direct_copy_kernel_cuda>()", "copy / memcpy / memset"),
    ("void at::native::vectorized_elementwise_kernel<4, MulFunctor>()",
     "elementwise"),
    ("void some_kernel()", "other"),
])
def test_kind_of_names_the_ports_kernels_first(name, kind):
    assert TB.kind_of(name) == kind
