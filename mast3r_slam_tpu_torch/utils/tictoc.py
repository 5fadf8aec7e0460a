"""Device-aware tic/toc timers (counterpart of
``mast3r_slam_tpu/utils/tictoc.py``): :func:`sync` waits for the card,
:func:`section` accumulates named timings (with ``sync_device=True`` it
times the enclosed device work with CUDA events), :func:`trace` wraps
``torch.profiler``, and :data:`STEPS` times the steps of a tracked frame's
host work by host clock (:class:`HostSteps`).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch

from mast3r_slam_tpu_torch.ops import device_loop

_stack: list[float] = []
# name → [total seconds, calls, pending (start, end) CUDA event pairs]
_sections: dict[str, list] = collections.defaultdict(lambda: [0.0, 0, []])


def sync(device=None):
    """Block until all outstanding work on the card is complete (no-op
    without one); not while another thread captures a CUDA graph."""
    if torch.cuda.is_available():
        with device_loop.capture_lock:
            torch.cuda.synchronize(device)


def tic():
    sync()
    _stack.append(time.perf_counter())


def toc(tag: str = "") -> float:
    sync()
    dt = time.perf_counter() - _stack.pop()
    print(f"[tictoc] {tag}: {dt:.6f}s")
    return dt


@contextlib.contextmanager
def section(name: str, sync_device: bool = False):
    """Accumulating timer: ``with section("track"): ...``; see report().
    With ``sync_device`` and a card, the section is timed by CUDA events
    recorded around it (read at :func:`report`); otherwise by the host
    clock."""
    s = _sections[name]
    if sync_device and torch.cuda.is_available():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            s[2].append((start, end))
            s[1] += 1
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        s[0] += time.perf_counter() - t0
        s[1] += 1


def _settle():
    for s in _sections.values():
        if s[2]:
            sync()
            s[0] += sum(a.elapsed_time(b) for a, b in s[2]) * 1e-3
            s[2].clear()


def report() -> dict:
    _settle()
    out = {}
    for name, (total, n, _) in sorted(_sections.items()):
        out[name] = {"total_s": total, "calls": n,
                     "mean_ms": 1e3 * total / max(n, 1)}
        print(f"[tictoc] {name:24s} {total:8.3f}s / {n:6d} calls "
              f"= {1e3 * total / max(n, 1):8.2f} ms")
    return out


def reset():
    _sections.clear()


@contextlib.contextmanager
def trace(logdir: str = "torch-trace"):
    """Profile the enclosed block with ``torch.profiler`` (CPU and, with a
    card, CUDA activity) and write a Chrome trace under ``logdir``."""
    import os

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[tictoc] trace written to {path}")


class HostSteps:
    """Host-clock laps of a frame's named steps (``create_frame``, the
    tracker's snapshot and small inputs, the graph's input copies, launch,
    counters and output clones, the decision read, the rest of ``track``):
    the breakdown ``scripts/profile_torch_track.py`` and ``chip_smoke.py``
    print. The instrumented code calls :meth:`mark` where a run of steps
    starts and :meth:`lap` at the end of each step; both are a flag test
    unless :meth:`start` turned the recorder on, and then record only in
    the thread that did. Nothing here syncs the device: a step's time is
    the host's, and work it queues on the card is not in it."""

    def __init__(self):
        self.on = False
        self._thread = None
        self._t = 0.0
        self._frame = {}
        self.frames = []          # one dict a frame: step -> ms

    def start(self):
        """Record from now on, in this thread; forget earlier frames."""
        self._thread = threading.get_ident()
        self._frame, self.frames = {}, []
        self._t = time.perf_counter()
        self.on = True

    def stop(self):
        self.on = False

    def _mine(self):
        return self.on and threading.get_ident() == self._thread

    def mark(self):
        """A run of steps starts here."""
        if self._mine():
            self._t = time.perf_counter()

    def lap(self, name):
        """Step ``name`` ends here (it began at the last mark or lap)."""
        if self._mine():
            t = time.perf_counter()
            self._frame[name] = self._frame.get(name, 0.0) + (t - self._t)
            self._t = t

    def end_frame(self):
        """Close the frame: its steps in ms, appended to :attr:`frames`."""
        ms = {k: v * 1e3 for k, v in self._frame.items()}
        self._frame = {}
        self.frames.append(ms)
        return ms


STEPS = HostSteps()
