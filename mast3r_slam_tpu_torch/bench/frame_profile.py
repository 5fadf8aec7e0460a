"""Where a tracked frame's time goes, on one card: its host steps by host
clock (``utils/tictoc.py::STEPS``) and its device events under
``torch.profiler``. ``scripts/profile_torch_track.py`` and
``chip_smoke.py``'s main phase print both with these helpers.

The device side reads the profiler's own events (kineto's): every kernel,
copy and set the card ran, with its start and end. An event belongs to a
graph replay when its correlation id is that of a ``cudaGraphLaunch``
call (CUPTI gives a graph's kernels the id of the launch that ran them).
From these: the device's busy time a frame, the kernels a frame (in and
outside the replay), and the device's idle time split into the gaps
inside the replay (its first event to its last, less its busy time) and
the rest, the time the device waits on the host.
"""

from __future__ import annotations

import os
import platform
import statistics
import subprocess


def smi() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (first card)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out[0] if out else "nvidia-smi printed nothing"


def device_label(device) -> str:
    """What a result ran on: the card's :func:`smi` line, or the CPU's
    architecture and core count."""
    if getattr(device, "type", str(device).split(":")[0]) == "cuda":
        return smi()
    return f"cpu ({platform.machine()}, {os.cpu_count()} cores)"


def call_ms(fn, device):
    """``(fn(), ms)``: the call timed from a synced device to its end, by
    CUDA events on the card and the host clock on the CPU."""
    import time

    import torch

    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end)


def _is_device(e):
    return str(e.device_type()).endswith("CUDA")


def device_events(prof):
    """``[(name, start_ns, end_ns, launch)]`` of every device event of a
    finished ``torch.profiler.profile``, by start (``launch``: the
    correlation id of the graph launch it ran in, else None), and the
    number of graph launches the host made."""
    events = prof.profiler.kineto_results.events()
    launches = {e.correlation_id() for e in events
                if not _is_device(e) and "GraphLaunch" in e.name()}
    out = sorted((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                  e.correlation_id() if e.correlation_id() in launches
                  else None)
                 for e in events if _is_device(e))
    return out, len(launches)


def _busy_ns(spans):
    """The length of the union of ``(start, end)`` spans."""
    total, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def device_split(prof, n_frames, frame_ms):
    """The device side of ``n_frames`` profiled frames, per frame:
    ``busy_ms`` (the union of its events; ``busy_sum_ms``, the sum of
    their durations, as the profiler's self device time sums them, which
    counts twice what overlaps),
    ``kernels`` and
    ``replay_kernels`` (kernel events; copies and sets are not kernels),
    ``replays``, ``replay_span_ms`` (first to last event of each replay),
    ``idle_ms`` = ``frame_ms`` (the unprofiled frame) less busy, split into
    ``gap_in_replay_ms`` and ``gap_outside_ms``, and ``idle_share``.
    Without graph launches the replay's entries are 0; where the profiler
    saw no device event, ``busy_ms`` is None (not measured)."""
    events, n_launch = device_events(prof)
    n = max(n_frames, 1)
    if not events:
        return dict(busy_ms=None, kernels=None, replay_kernels=None,
                    replays=n_launch / n, note="no device event seen")
    kernel = [not (name.startswith("Memcpy") or name.startswith("Memset"))
              for name, *_ in events]
    busy = _busy_ns([(a, b) for _, a, b, _ in events])
    replays = {}
    for _, a, b, launch in events:
        if launch is not None:
            replays.setdefault(launch, []).append((a, b))
    span = gap_in = 0
    for g in replays.values():
        s = max(b for _, b in g) - min(a for a, _ in g)
        span += s
        gap_in += s - _busy_ns(g)
    busy_ms = busy / 1e6 / n
    idle = max(0.0, frame_ms - busy_ms)
    out = dict(
        busy_ms=busy_ms,
        busy_sum_ms=sum(b - a for _, a, b, _ in events) / 1e6 / n,
        kernels=sum(kernel) / n,
        replay_kernels=sum(k for k, (*_, r) in zip(kernel, events)
                           if r is not None) / n,
        replays=n_launch / n, replay_span_ms=span / 1e6 / n,
        idle_ms=idle, gap_in_replay_ms=gap_in / 1e6 / n,
        gap_outside_ms=max(0.0, idle - gap_in / 1e6 / n),
        idle_share=idle / frame_ms if frame_ms else None)
    if n_launch and not replays:
        out.update(gap_in_replay_ms=None, gap_outside_ms=None,
                   note="no device event matched a graph launch: the "
                        "split of the idle time is not measured")
    return out


def host_breakdown(frames, frame_ms):
    """The median ms of each host step over ``frames`` (dicts of
    ``STEPS.frames``) and their sum beside the median frame of
    ``frame_ms``: how much of the frame the steps account for."""
    names = []
    for f in frames:
        names += [k for k in f if k not in names]
    steps = {k: statistics.median(f.get(k, 0.0) for f in frames)
             for k in names}
    total = sum(steps.values())
    frame = statistics.median(frame_ms)
    return dict(frame_ms=frame, steps=steps, steps_sum_ms=total,
                steps_share=total / frame if frame else None)
