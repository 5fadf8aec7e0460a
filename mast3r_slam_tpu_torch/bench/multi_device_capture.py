"""What one CUDA graph can hold across two cards: the two questions that
decide how a backend mesh over distinct cards runs its solve.

    python -m mast3r_slam_tpu_torch.bench.multi_device_capture

1. ``fork``: can a stream capture on cuda:0 fork to a stream of cuda:1
   through an event (a kernel on each card, joined back), and does the
   graph replay with both kernels run?
2. ``conditional``: can a conditional WHILE node's body (``ops/
   device_loop.py``, ``csrc/graph_loop.cu``) hold a kernel of cuda:1
   beside one of cuda:0, captured, instantiated and launched?

Each case counts its kernels' effects (in-place adds, no allocation inside
the capture) against the replays, and records ``"ok"`` or the error that
the capture, the instantiation or the launch raised. ``slam/
factor_graph.py`` runs a mesh over distinct cards as one graph per card
and the loop on the host when the answer to 2 is no. Prints one JSON line
with both answers and the cards' ``nvidia-smi`` name and power limit;
needs two cards.
"""

from __future__ import annotations

import json

import torch

STEPS = 3


def _fork(dev0, dev1):
    x0 = torch.zeros((), device=dev0)
    x1 = torch.zeros((), device=dev1)
    s1 = torch.cuda.Stream(dev1)
    side = torch.cuda.Stream(dev0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev0), torch.cuda.graph(graph, stream=side):
        x0.add_(1)
        there = torch.cuda.Event()
        there.record(side)
        s1.wait_event(there)
        with torch.cuda.device(dev1), torch.cuda.stream(s1):
            x1.add_(1)
            back = torch.cuda.Event()
            back.record(s1)
        side.wait_event(back)
    for _ in range(STEPS):
        graph.replay()
    torch.cuda.synchronize(dev0)
    torch.cuda.synchronize(dev1)
    got = (float(x0), float(x1))
    if got != (STEPS, STEPS):
        return f"replayed {STEPS} times, counted {got}"
    return "ok"


def _conditional(dev0, dev1):
    from mast3r_slam_tpu_torch import _build
    from mast3r_slam_tpu_torch.ops import device_loop

    x0 = torch.zeros((), device=dev0)
    x1 = torch.zeros((), device=dev1)
    live = torch.ones((), dtype=torch.bool, device=dev0)
    s1 = torch.cuda.Stream(dev1)
    side, body = torch.cuda.Stream(dev0), torch.cuda.Stream(dev0)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    pool = device_loop.BodyPool(dev0)

    def step():
        x0.add_(1)
        there = torch.cuda.Event()
        there.record(body)
        s1.wait_event(there)
        with torch.cuda.device(dev1), torch.cuda.stream(s1):
            x1.add_(1)
            back = torch.cuda.Event()
            back.record(s1)
        body.wait_event(back)
        live.copy_(x0 < STEPS)

    exe = None
    try:
        with torch.cuda.device(dev0):
            with (device_loop.capture_lock, _build.LaunchRecording(),
                  device_loop.capturing(pool, body)):
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    device_loop.run(2 * STEPS, live, step)
            exe = device_loop.Executable(graph)
            exe.launch()
        torch.cuda.synchronize(dev0)
        torch.cuda.synchronize(dev1)
        got = (float(x0), float(x1))
        if got != (STEPS, STEPS):
            return f"one launch, {STEPS} steps expected, counted {got}"
        return "ok"
    finally:
        if exe is not None:
            exe.destroy()
        graph.reset()
        pool.release()


def main(argv=None):
    from mast3r_slam_tpu_torch.bench.frame_profile import smi

    if torch.cuda.device_count() < 2:
        raise RuntimeError("the probe needs two CUDA cards")
    dev0, dev1 = torch.device("cuda", 0), torch.device("cuda", 1)
    out = {}
    for name, case in (("fork", _fork), ("conditional", _conditional)):
        try:
            out[name] = case(dev0, dev1)
        except Exception as e:         # the answer is the error itself
            out[name] = f"{type(e).__name__}: {e}"
        print(f"{name}: {out[name]}", flush=True)
    out["device"] = smi()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
