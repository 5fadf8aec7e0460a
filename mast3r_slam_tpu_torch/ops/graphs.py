"""A computation as one CUDA graph per static key, replayed on later calls:
the counterpart of the JAX package's ``jax.jit`` for the port's device
programs (the tracked frame, ``slam/tracker.py::TrackGraphs``; the
backend's bundle-adjustment solve, ``slam/factor_graph.py``; its decode +
match, ``models/inference.py``).

:meth:`GraphCache.run` keys a graph on what the caller names static (what
the jit is static on), the device, the inputs' shapes and dtypes, and an
owner (e.g. the model's ``params``: new weights drop every graph, since a
graph reads the tensors it was captured with). A key's first call runs the
computation eagerly on a side stream (its output is the call's; it builds
the kernels, their one-time setup, the cached tables and the cuBLAS /
cuSOLVER workspaces), then captures it into a private memory pool in
``thread_local`` mode (other threads go on launching and syncing their
streams meanwhile; a device-wide sync waits for
``device_loop.capture_lock``). Loops whose exit the device decides become
conditional WHILE nodes (``ops/device_loop.py``), so a replay stops each
where the eager loop exits. Later calls copy the inputs into the graph's
static buffers (or, for inputs the caller keeps as the graph's own,
check that they are the same tensors), replay it and return clones of its
outputs, which the next replay overwrites. The kernels' launch counters
count launches that ran: a capture adds nothing
(``_build.LaunchRecording``), each replay adds the captured counts and
each loop's launches a step times the steps its node ran (summed on the
device). A caller that lets go of a buffer its graphs read in place
drops them (:meth:`GraphCache.drop`). A graph let go of inside a
capture in its thread (the cyclic garbage collector runs where Python
allocates) is freed after that capture. A failed capture or replay raises;
nothing falls back to the eager path.
"""

from __future__ import annotations

import threading

import torch

from mast3r_slam_tpu_torch import _build
from mast3r_slam_tpu_torch.ops import device_loop
from mast3r_slam_tpu_torch.utils.tictoc import STEPS


# what _Captured.__del__ could not free because its thread was capturing
# (the cyclic garbage collector runs wherever Python allocates, a capture
# included): freed by the next GraphCache call outside a capture
_deferred = []
_deferred_lock = threading.RLock()


def _free_deferred():
    with _deferred_lock:
        parts = _deferred[:]
        _deferred.clear()
    for free in parts:
        free()


def _map(fn, out):
    """``fn`` applied to every tensor of a dict / tuple / list / tensor."""
    if isinstance(out, dict):
        return {k: _map(fn, v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_map(fn, v) for v in out)
    return fn(out)


def _tensors(out):
    found = []
    _map(found.append, out)
    return found


class GraphCache:
    """CUDA graphs of computations, one per key (see the module
    docstring). ``captures`` and ``replays`` count what :meth:`run` did;
    ``name`` says whose graphs they are."""

    def __init__(self, name):
        self.name = name
        # the replay's host steps, as :data:`STEPS` names them
        self._laps = tuple(f"{name}: {step}" for step in (
            "graph key", "input copies", "launch", "counters",
            "output clones"))
        self._graphs = {}
        self._owner = None
        self.captures = 0
        self.replays = 0

    def run(self, key, fn, inputs, owner=None, static=()):
        """``fn(*inputs)`` as the graph of ``key``: ``inputs`` are tensors
        on one CUDA device; ``fn`` returns a tensor or a dict / tuple of
        them. ``static``: the indices of inputs the caller keeps as the
        graph's own buffers, passing the same tensor (written in place)
        on every call of this key; the graph reads them where they are."""
        dev = inputs[0].device
        if dev.type != "cuda" or any(t.device != dev for t in inputs):
            raise ValueError(f"{self.name}: a graph's inputs must be on one "
                             "CUDA device")
        full = (key, dev, tuple((tuple(t.shape), t.dtype) for t in inputs))
        if owner is not self._owner:
            self._graphs.clear()
            self._owner = owner
        if _deferred and not device_loop.capturing_here():
            _free_deferred()
        with torch.cuda.device(dev):
            graph = self._graphs.get(full)
            if graph is None:
                out, self._graphs[full] = self._capture(fn, inputs, static)
                return out
            key_lap, copy_lap, launch_lap, count_lap, clone_lap = self._laps
            STEPS.lap(key_lap)
            for i, (buf, t) in enumerate(zip(graph.inputs, inputs)):
                if i not in static:
                    buf.copy_(t)
                elif buf is not t:
                    raise ValueError(f"{self.name}: input {i} is kept as the "
                                     "graph's buffer; pass the same tensor")
            STEPS.lap(copy_lap)
            graph.exec.launch()
            STEPS.lap(launch_lap)
            graph.launches.replayed()
            self.replays += 1
            STEPS.lap(count_lap)
            out = _map(torch.clone, graph.outputs)
            STEPS.lap(clone_lap)
            return out

    def _capture(self, fn, inputs, static):
        bufs = tuple(t if i in static else t.clone()
                     for i, t in enumerate(inputs))
        main = torch.cuda.current_stream()
        side, body = torch.cuda.Stream(), torch.cuda.Stream()
        for stream in (side, body):
            stream.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn(*inputs)
        with torch.cuda.stream(body):
            # the loop bodies' stream gets its cuBLAS workspace here, from
            # the ordinary pool, not inside a capture
            eye = torch.eye(7, device=main.device)
            torch.mv(torch.mm(eye, eye), eye[0])
        graph = _Captured(bufs, device_loop.BodyPool(main.device))
        with (device_loop.capture_lock, graph.launches,
              device_loop.capturing(graph.pool, body)):
            with torch.cuda.graph(graph.graph, stream=side,
                                  capture_error_mode="thread_local"):
                graph.outputs = fn(*bufs)
        graph.exec = device_loop.Executable(graph.graph)
        main.wait_stream(side)
        for t in _tensors(out):
            t.record_stream(main)
        self.captures += 1
        if _deferred and not device_loop.capturing_here():
            _free_deferred()
        return out, graph

    def drop(self, buf):
        """Forget the graphs that read the caller's buffer ``buf`` (one of
        their ``static`` inputs), which the caller is about to let go:
        their memory is released with them."""
        for full in [full for full, g in self._graphs.items()
                     if any(t is buf for t in g.inputs)]:
            del self._graphs[full]

    def drop_if(self, pred):
        """Forget the graphs whose key (the caller's ``key``) satisfies
        ``pred``."""
        for full in [full for full in self._graphs if pred(full[0])]:
            del self._graphs[full]

    def pool_bytes(self):
        """Device memory held by each graph's pools (its own and its loop
        bodies'), by key: the segments ``torch.cuda.memory_snapshot()``
        lists in them."""
        pools = {full: {tuple(g.graph.pool()), tuple(g.pool.handle)}
                 for full, g in self._graphs.items()}
        held = dict.fromkeys(pools, 0)
        for seg in torch.cuda.memory_snapshot():
            pool = tuple(seg.get("segment_pool_id", ()))
            for full, ids in pools.items():
                if pool in ids:
                    held[full] += seg["total_size"]
        return held


class _Captured:
    """One captured computation: the static input buffers, the graph (kept
    after its capture) and its executable, its outputs, the launches its
    capture recorded, and the memory pool of its loop bodies, released
    after the graph itself."""

    def __init__(self, inputs, pool):
        self.inputs = inputs
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.exec = None
        self.outputs = None
        self.launches = _build.LaunchRecording()
        self.pool = pool

    def __del__(self):
        self.outputs = None
        exec_, graph, pool = self.exec, self.graph, self.pool

        def free():
            if exec_ is not None:
                exec_.destroy()
            graph.reset()
            pool.release()

        if device_loop.capturing_here():
            # a capture in this thread refuses the destroys: later
            with _deferred_lock:
                _deferred.append(free)
        else:
            free()
