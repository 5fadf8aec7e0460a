"""Loops whose exit is decided on the device: the counterparts of the JAX
package's ``lax.while_loop`` in ``track_core`` (the matcher's and the pose
solve's LM loops).

:func:`run` runs ``step`` at most ``cap`` times while the 0-dim bool
``live`` holds. ``step`` updates the loop's state in place (``copy_`` into
the same tensors each time) and ``live`` with it, and a step after ``live``
turned False leaves the state as it is, so a loop that runs on past its
exit gives the exit's result. On the CPU, where the flag is host memory,
a Python loop stops at the exit. Eagerly on the card (outside a capture)
nothing waits for the device: each step's flag is copied to pinned host
memory behind it, and the Python loop stops once a landed copy shows the
exit (the steps launched meanwhile run masked). While a thread captures a
CUDA graph inside :func:`capturing` (``ops/graphs.py``), the loop becomes
one conditional WHILE node of the graph (``csrc/graph_loop.cu``): ``step``
is captured once as its body, and on replay the body runs while ``live``
holds and fewer than ``cap`` steps ran, so the steps after the exit cost
nothing. The body's memory comes from a pool of its own, which lives as
long as the graph.

The kernels a step launches count once for each step that ran while
``live`` held. In a graph, which cannot count a step, the replay counts
the body's launches times the node's step count (``_build.loop_step``).
On the card's eager path each step's launches are recorded and must be
the first step's; the steps that started while ``live`` held are summed
on the device and counted on the kernels' counters, the steps launched
after the exit (which ran masked) on :data:`masked`. Both counts are
read from the device when the launch counters are read.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from mast3r_slam_tpu_torch import _build

KERNEL = "graph_loop"
_P, _I = ctypes.c_void_p, ctypes.c_int
# ctypes signatures of csrc/graph_loop.cu's C entries
ENTRIES = {
    "graph_loop_begin": [_P, _P, _P, _P, _I, _P],
    "graph_loop_end": [_P, _P, _P, _I, _P],
    "graph_loop_instantiate": [_P, _P, _P],
    "graph_loop_launch": [_P, _P],
    "graph_loop_destroy": [_P],
}

# loop nodes captured: one a loop; each replay of a graph adds its loops
counter = _build.LaunchCounter()
# the counted kernels' launches in the steps that the card's eager loop
# launched after its exit (they ran masked): not on the kernels' counters
masked = _build.LaunchCounter()

_local = threading.local()

# Held by a thread while it captures a CUDA graph (``_build.capture_lock``;
# a device-wide sync in another thread waits for it).
capture_lock = _build.capture_lock


class BodyPool:
    """The memory pool of the loop bodies of one graph, on ``device`` (a
    ``torch.device`` with its index).
    Each body's capture routes the thread's allocations to it; release it
    (:meth:`release`) only after the graph is gone."""

    def __init__(self, device):
        self.device = device
        self.handle = torch.cuda.graph_pool_handle()
        self.uses = 0

    def release(self):
        for _ in range(self.uses):
            torch._C._cuda_releasePool(self.device.index, self.handle)
        self.uses = 0


@contextlib.contextmanager
def capturing(pool, body_stream):
    """Within the block, the calling thread is capturing a CUDA graph (the
    caller's ``torch.cuda.graph`` block) on ``pool.device``: :func:`run`
    captures its loops as conditional WHILE nodes, their bodies on
    ``body_stream`` (an idle stream) and their memory from ``pool``."""
    _local.capture = (pool, body_stream)
    try:
        yield
    finally:
        _local.capture = None


def capturing_here():
    """Whether the calling thread is inside :func:`capturing`, i.e. is
    capturing a CUDA graph (in thread-local mode: it may not destroy
    graphs or their executables until the capture ends)."""
    return getattr(_local, "capture", None) is not None


def run(cap, live, step):
    """``step()`` at most ``cap`` times while ``live`` holds (see module
    docstring)."""
    capture = getattr(_local, "capture", None)
    if capture is None and live.device.type == "cpu":
        for _ in range(cap):
            if not live:                 # host memory: stop at the exit
                break
            step()
        return
    if capture is None:
        _run_polled(cap, live, step)
        return
    pool, body = capture
    if live.device != pool.device:
        raise ValueError(f"a loop on {live.device} inside a capture on "
                         f"{pool.device}")
    lib = _build.load(KERNEL, ENTRIES)
    count = torch.empty((), dtype=torch.int32, device=live.device)
    handle = ctypes.c_ulonglong(0)
    outer = torch.cuda.current_stream(live.device)
    with torch.cuda.device(live.device):
        err = lib.graph_loop_begin(outer.cuda_stream, body.cuda_stream,
                                   live.data_ptr(), count.data_ptr(), cap,
                                   ctypes.addressof(handle))
    _build.check(lib, KERNEL, err)
    torch._C._cuda_beginAllocateCurrentThreadToPool(pool.device.index,
                                                    pool.handle)
    pool.uses += 1
    try:
        with _build.loop_step(count), torch.cuda.stream(body):
            step()
    finally:
        torch._C._cuda_endAllocateToPool(pool.device.index, pool.handle)
        with torch.cuda.device(live.device):
            err = lib.graph_loop_end(body.cuda_stream, live.data_ptr(),
                                     count.data_ptr(), cap,
                                     ctypes.addressof(handle))
    _build.check(lib, KERNEL, err)
    counter.add()


def _run_polled(cap, live, step):
    """The eager loop on the card: after each step its flag is copied to
    pinned host memory without a wait, and the loop stops once a copy that
    has landed shows the exit. The steps launched before then run masked,
    so the result is the exit's, however far the host ran ahead. Every
    step must launch the counted kernels the first did (a graph's body
    does); the steps that started while ``live`` held are summed on the
    device and counted on the kernels' counters, the others on
    :data:`masked`."""
    flags = torch.empty(cap, dtype=torch.bool, pin_memory=True)
    seen = flags.numpy()
    copied = []                          # one event a step, in stream order
    landed = 0
    steps = torch.zeros((), dtype=torch.int32, device=live.device)
    first = None
    try:
        for k in range(cap):
            while landed < len(copied) and copied[landed].query():
                landed += 1
            if landed and not seen[landed - 1]:
                return
            steps.add_(live)
            with _build.LaunchRecording() as launched:
                step()
            if first is None:
                first = launched.counts
            elif launched.counts != first:
                raise RuntimeError("a loop step launched other counted "
                                   "kernels than its first step")
            flags[k].copy_(live, non_blocking=True)
            copied.append(torch.cuda.Event())
            copied[-1].record()
    finally:
        if first:
            for counter, n in first.items():
                counter.add_steps(steps, n)
            masked.add_steps(len(copied) - steps, sum(first.values()))


class Executable:
    """A captured graph (``torch.cuda.CUDAGraph(keep_graph=True)``, after
    its capture) instantiated here: PyTorch instantiates with
    ``cudaGraphInstantiateFlagAutoFreeOnLaunch``, which a graph with
    conditional nodes does not take. :meth:`launch` replays it on the
    current stream; :meth:`destroy` frees it (before the graph)."""

    def __init__(self, graph):
        self._lib = _build.load(KERNEL, ENTRIES)
        self._exec = ctypes.c_void_p()
        node_type = ctypes.c_int(-1)
        err = self._lib.graph_loop_instantiate(
            graph.raw_cuda_graph(), ctypes.addressof(self._exec),
            ctypes.addressof(node_type))
        if err:
            raise RuntimeError(
                f"instantiating the captured graph failed: CUDA error {err} "
                f"at a node of type {node_type.value} (cudaGraphNodeType)")

    def launch(self):
        _build.check(self._lib, KERNEL, self._lib.graph_loop_launch(
            self._exec, torch.cuda.current_stream().cuda_stream))

    def destroy(self):
        if self._exec:
            _build.check(self._lib, KERNEL,
                         self._lib.graph_loop_destroy(self._exec))
            self._exec = ctypes.c_void_p()
