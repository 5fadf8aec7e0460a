"""A ``torch.profiler`` Chrome trace of the card, summed by exclusive self
time per kernel, per source line and per kind.

    python -m mast3r_slam_tpu_torch.bench.trace_breakdown <trace> [n_reps]
        [--device cuda]

Counterpart of ``scripts/trace_breakdown.py`` (which reads a JAX trace's
TPU op lanes). ``<trace>`` is a ``.json`` or ``.json.gz`` Chrome trace
(``prof.export_chrome_trace``) or a directory holding one (the last by
name, searched recursively). The device lanes are the events of the
categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; where the trace
holds none, it prints the lanes it saw and exits non-zero (``--device
cpu`` reads the ``cpu_op`` lanes instead, for traces of the plain versions
in the tests; nothing falls back from one to the other).

Exclusive self time is the script's line sweep: each instant goes to the
deepest event covering it (the one that started last), so an event's
children are not counted twice; summed over every event it is the union of
the device events, which is the device's busy time (as
``bench/frame_profile.py::_busy_ns`` takes it). It prints the device busy
time and the self-time sum per rep, the top 30 kernels, the total by
source and the total by kind.

By source: a kernel's correlation id names the runtime call that launched
it (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaGraphLaunch``, ...;
else its ``External id`` names the launching op), and that call's thread
and time name the Python frames around it (the ``python_function`` events
of a trace taken ``with_stack=True``). Its source is the deepest frame of
``mast3r_slam_tpu_torch/`` among them, skipping the graph machinery
(``ops/graphs.py``, ``ops/device_loop.py``, ``_build.py`` and the
dispatchers ``_graphed`` / ``_run_solve``); a kernel that a graph replay
ran is grouped under that replay's ``cudaGraphLaunch`` and the frame that
launched it. CUPTI gives the kernels of a conditional loop's steps inside
a graph (``ops/device_loop.py``) no launching call: an event with neither
call nor op that follows a replay's events (before the next eager one) is
counted in that replay. Other kernels without a frame take the launching
op's or call's name as their source, else ``?``.

By kind: the port's own kernels by their symbols first (K1 / K3, K2 by
path, K4 / K5 by path and their sum pass, K4′, the loop condition), then
the library's by name: solve (cuSOLVER / trsm), gemm (cuBLAS / CUTLASS),
gather / index, scatter / index_put, sort / top-k, reduce, copy / memcpy /
memset, elementwise and other.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import gzip
import json
import os
import re
import sys
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PORT = "mast3r_slam_tpu_torch/"
MACHINERY = (PORT + "ops/graphs.py", PORT + "ops/device_loop.py",
             PORT + "_build.py")
DISPATCH = (": _graphed", ": _run_solve")
# the port's kernels (csrc/*.cu) by their symbols, then the library's by
# name; the first pattern that matches gives the kind
KIND_PATTERNS = [
    ("K1 flash attention + RoPE",
     re.compile(r"flash_\w*kernel<true>|rope_rotate_rows")),
    ("K3 flash attention", re.compile(r"flash_\w*kernel<false>")),
    ("K2 igemm", re.compile(r"conv3x3_igemm_kernel")),
    ("K2 tf32x3", re.compile(r"conv3x3_tf32x3_kernel|conv3x3_tf32_split")),
    ("K2 mma", re.compile(r"conv3x3_mma_kernel")),
    ("K2 fma", re.compile(r"\bconv3x3_kernel\b")),
    ("K2 split-K sum", re.compile(r"conv3x3_split_sum_kernel")),
    ("K4 mma", re.compile(r"gram_tc_kernel<[^,]*(Tiles\)0|Tiles::RAYS)\b")),
    ("K5 mma", re.compile(r"gram_tc_kernel<[^,]*(Tiles\)1|Tiles::CALIB)\b")),
    ("K4 tf32", re.compile(r"gram_tf32_kernel<false\b")),
    ("K5 tf32", re.compile(r"gram_tf32_kernel<true\b")),
    ("K4/K5 fma", re.compile(r"\bgram_kernel<")),
    ("K4/K5 sum pass", re.compile(r"gram_sum_kernel")),
    ("K4' (Gram microbenchmark)",
     re.compile(r"gram_tc_kernel<[^,]*(Tiles\)[23]|Tiles::(DIAG|FULL))\b"
                r"|\brows_kernel<|\breduce_kernel<(true|false)\b"
                r"|diag_blocks_kernel|rn_check_kernel")),
    ("loop condition", re.compile(r"loop_condition_kernel")),
    ("solve (cuSOLVER / trsm)",
     re.compile(r"potrf|potrs|trsm|trsv|syrk|getrf|cusolver", re.I)),
    ("gemm (cuBLAS / CUTLASS)",
     re.compile(r"gemm|gemv|nvjet|cutlass|xmma|cublas|dot_kernel|^dot|%dot"
                r"|addmm|matmul|\bmm\b|bmm", re.I)),
    ("gather / index", re.compile(r"gather|index_elementwise|index_select"
                                  r"|indexSelect|aten::index\b", re.I)),
    ("scatter / index_put", re.compile(r"scatter|index_put|indexing_backward"
                                       r"|index_add", re.I)),
    ("sort / top-k", re.compile(r"sort|top-k|topk", re.I)),
    ("reduce", re.compile(r"reduce|norm_kernel|aten::(sum|mean|max|min)\b",
                          re.I)),
    ("copy / memcpy / memset", re.compile(
        r"copy|memcpy|memset|transpose|CatArray|aten::cat\b", re.I)),
    ("elementwise", re.compile(r"elementwise|fusion|add|mul|tanh|exp"
                               r"|select|where|fill", re.I)),
]


def kind_of(name):
    for kind, pat in KIND_PATTERNS:
        if pat.search(name):
            return kind
    return "other"


def find_trace(path):
    """The trace file: ``path`` itself, or the last ``*.json`` /
    ``*.json.gz`` under the directory ``path``."""
    if os.path.isdir(path):
        found = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                                 recursive=True)
                       + glob.glob(os.path.join(path, "**", "*.json.gz"),
                                   recursive=True))
        if not found:
            raise SystemExit(f"no .json or .json.gz trace under {path}")
        return found[-1]
    return path


def load_events(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def self_times(intervals):
    """Exclusive self time of each ``(start, end)`` interval: the script's
    line sweep, each instant to the deepest (last started) covering one."""
    pts = []
    for i, (ts, te) in enumerate(intervals):
        pts.append((ts, 0, i))
        pts.append((te, 1, i))
    pts.sort(key=lambda p: (p[0], p[1]))
    own = [0.0] * len(intervals)
    active = []
    last_t = None
    for t, kind, i in pts:
        if active and last_t is not None and t > last_t:
            own[active[-1]] += t - last_t
        if kind == 0:
            active.append(i)
        elif i in active:
            active.remove(i)
        last_t = t
    return own


def union(intervals):
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _lanes(events):
    names, pids = {}, {}
    for ev in events:
        if ev.get("ph") == "M":
            if ev.get("name") == "thread_name":
                names[(ev.get("pid"), ev.get("tid"))] = ev["args"]["name"]
            elif ev.get("name") == "process_name":
                pids[ev.get("pid")] = ev["args"]["name"]
    return names, pids


class _Frames:
    """The ``python_function`` events of each thread, for the question
    "which frames were open on this thread at this instant"."""

    def __init__(self, events):
        by_thread = defaultdict(list)
        self.parent = {}          # Python id -> (parent's id, its frame)
        for ev in events:
            if ev.get("cat") == "python_function" and ev.get("ph") == "X":
                args = ev.get("args", {})
                frame = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                         ev["name"], args.get("Python id"))
                by_thread[(ev.get("pid"), ev.get("tid"))].append(frame)
                if args.get("Python id") is not None:
                    self.parent[args["Python id"]] = (
                        args.get("Python parent id"), frame)
        self.threads = {}
        for key, frames in by_thread.items():
            frames.sort(key=lambda f: (f[0], -f[1]))
            self.threads[key] = (frames, [f[0] for f in frames])
        self._cache = {}

    @staticmethod
    def _wanted(name):
        return (PORT in name and not any(m in name for m in MACHINERY)
                and not any(name.endswith(d) for d in DISPATCH))

    def _open(self, frames, starts, t):
        """The frames open at ``t``, deepest first: the last one started
        that covers ``t``, then its callers (by the Python parent ids where
        the trace has them, else by the same scan)."""
        k = bisect.bisect_right(starts, t) - 1
        while k >= 0:
            ts, te, name, pid = frames[k]
            k -= 1
            if te < t:
                continue
            yield name
            if pid is not None and pid in self.parent:
                up = self.parent[pid][0]
                while up is not None and up in self.parent:
                    up, frame = self.parent[up]
                    yield frame[2]
                return

    def port_frame(self, thread, t):
        """The deepest frame of the port open at ``t`` on ``thread`` (not
        the graph machinery), as ``path(line): function``; else None."""
        key = (thread, t)
        if key not in self._cache:
            frames, starts = self.threads.get(thread, ((), ()))
            name = next((n for n in self._open(frames, starts, t)
                         if self._wanted(n)), None)
            self._cache[key] = (None if name is None
                                else name[name.index(PORT):])
        return self._cache[key]


def _sources(events, dev, frames):
    """The source of each device event (see the module docstring) and
    whether a graph replay ran it."""
    launches, ops = {}, {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = ev.get("args", {})
        if ev.get("cat") in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = ev
        elif ev.get("cat") in ("cpu_op", "user_annotation"):
            if "External id" in args:
                ops.setdefault(args["External id"], ev)
    out = [None] * len(dev)
    # in time order: an event with neither a launching call nor an op,
    # after a replay's events and before the next eager one, is a step of
    # one of its conditional loops (CUPTI does not give those the launch's
    # id, and may report a graph's kernels on streams of its own)
    replaying = None
    for i in sorted(range(len(dev)), key=lambda i: float(dev[i]["ts"])):
        ev = dev[i]
        args = ev.get("args", {})
        call = launches.get(args.get("correlation"))
        op = ops.get(args.get("External id"))
        if call is None and op is None:
            out[i] = (replaying, True) if replaying else ("?", False)
            continue
        replay = call is not None and "GraphLaunch" in call["name"]
        src = None
        for host in (call, op):
            if host is None:
                continue
            src = frames.port_frame((host.get("pid"), host.get("tid")),
                                    float(host["ts"]))
            if src is not None:
                break
        if src is None:
            src = (op or call).get("name", "?")
        if replay:
            src = f"{call['name']} <- {src}"
        replaying = src if replay else None
        out[i] = (src, replay)
    return out


def breakdown(path, n_reps=1, device="cuda"):
    """The trace's device events summed per kernel, source and kind.
    Returns a dict: ``busy_ms`` and ``self_ms`` (per rep), ``events``,
    ``replay_events`` (run by a graph replay), ``kernels`` ([name, ms,
    count, kind, source] by ms), ``by_source``, ``by_kind`` (ms per rep),
    ``unattributed`` (the kernels of source ``?``, ms per rep),
    ``lanes`` (every lane's total duration, ms). Raises ``SystemExit``
    (after printing the lanes) where it finds no device lane."""
    events = load_events(find_trace(path))
    names, pids = _lanes(events)
    cats = DEVICE_CATS if device == "cuda" else ("cpu_op",)
    dev, lanes = [], defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        pid, tid = ev.get("pid"), ev.get("tid")
        lane = (f"{ev.get('cat', '?')}: {pids.get(pid, pid)}"
                f"/{names.get((pid, tid), tid)}")
        lanes[lane] += float(ev["dur"])
        if ev.get("cat") in cats:
            dev.append(ev)
    if not dev:
        print("lanes found:")
        for lane, d in sorted(lanes.items(), key=lambda kv: -kv[1])[:15]:
            print(f"  {d / 1e3:9.2f} ms  {lane}")
        raise SystemExit(f"no {' / '.join(cats)} lane in {path}; see the "
                         "lanes above")
    spans = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
             for ev in dev]
    own = self_times(spans)
    srcs = _sources(events, dev, _Frames(events))
    per = {}
    by_src, by_kind = defaultdict(float), defaultdict(float)
    lost = defaultdict(float)
    for ev, t, (src, _) in zip(dev, own, srcs):
        rec = per.setdefault(ev["name"], [0.0, 0, src])
        rec[0] += t
        rec[1] += 1
        by_src[src] += t
        by_kind[kind_of(ev["name"])] += t
        if src == "?":
            lost[ev["name"]] += t
    scale = 1e3 * n_reps                 # trace microseconds -> ms per rep
    return dict(
        trace=find_trace(path), n_reps=n_reps, events=len(dev),
        replay_events=sum(r for _, r in srcs),
        busy_ms=union(spans) / scale, self_ms=sum(own) / scale,
        kernels=sorted(([n, t / scale, c, kind_of(n), s]
                        for n, (t, c, s) in per.items()),
                       key=lambda k: -k[1]),
        by_source=dict(sorted(((k, v / scale) for k, v in by_src.items()),
                              key=lambda kv: -kv[1])),
        by_kind=dict(sorted(((k, v / scale) for k, v in by_kind.items()),
                            key=lambda kv: -kv[1])),
        unattributed=dict(sorted(((k, v / scale) for k, v in lost.items()),
                                 key=lambda kv: -kv[1])[:10]),
        lanes={k: v / 1e3 for k, v in lanes.items()})


def report(b, top=30, emit=print):
    """The script's tables for a :func:`breakdown`."""
    n = b["n_reps"]
    emit(f"device busy: {b['busy_ms']:.3f} ms/rep (union of the device "
         f"events); self-time sum {b['self_ms']:.3f} ms/rep ({n} reps; "
         f"{b['events']} device events, {b['replay_events']} in graph "
         "replays)")
    emit(f"\ntop {top} kernels by self time (ms/rep):")
    for name, t, count, _, src in b["kernels"][:top]:
        emit(f"  {t:8.3f}  {count:5d}x  {name[:60]:60s} {src[-55:]}")
    emit("\nby kind (ms/rep):")
    for kind, t in b["by_kind"].items():
        emit(f"  {t:8.3f}  {kind}")
    emit("\nby source (ms/rep, top 25):")
    for src, t in list(b["by_source"].items())[:25]:
        emit(f"  {t:8.3f}  {src[-100:]}")
    if b["unattributed"]:
        emit("  (?: " + "; ".join(f"{n[:60]} {t:.3f}" for n, t in
                                   b["unattributed"].items()) + ")")


def main(argv=None, device="cuda"):
    """Break a trace down; returns the :func:`breakdown`."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace", help="a .json / .json.gz Chrome trace or a "
                    "directory holding one")
    ap.add_argument("n_reps", nargs="?", type=int, default=1)
    ap.add_argument("--device", default=device, choices=("cuda", "cpu"),
                    help="cuda: the card's kernel / memcpy / memset lanes; "
                    "cpu: the cpu_op lanes of a CPU run")
    args = ap.parse_args(argv)
    b = breakdown(args.trace, args.n_reps, args.device)
    report(b, emit=lambda *a: print(*a, flush=True))
    print(json.dumps({k: v for k, v in b.items() if k != "kernels"}),
          flush=True)
    return b


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
