"""Device slots for the multi-device path (counterpart of
``mast3r_slam_tpu/parallel/sharding.py``).

The JAX package shards its two batch-heavy backend computations over a 1-D
device mesh and lets XLA insert the collectives: the symmetric keyframe-pair
decode (each device decodes a slice of the pair batch) and the bundle
adjustment's per-edge system (each device builds the dense normal equations
from its own edges, and a ``psum`` adds them). PyTorch has no mesh, so the
port's :class:`DeviceMesh` is an ordered list of slots, each naming a
``torch.device``, and the callers loop over it: a slot's work runs on its
device (kernel launches are asynchronous, so the devices overlap), and the
results are gathered onto the first slot in slot order.

Slots may repeat a device, as JAX's virtual CPU devices do: the CPU tests
and one card run the sharded code unchanged. :func:`replicate` then keeps
one copy per distinct device, so a virtual layout on one card copies
nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

EDGE_AXIS = "edge"


@dataclass(frozen=True)
class DeviceMesh:
    """``devices[k]`` is the device of slot ``slots[k]``, in slot order
    (``slots`` numbers the slots in the device list they were planned
    from)."""

    devices: tuple
    slots: tuple
    axis_name: str = EDGE_AXIS

    def __post_init__(self):
        if not self.devices or len(self.devices) != len(self.slots):
            raise ValueError(f"a mesh needs one device per slot, got "
                             f"{self.devices} for slots {self.slots}")
        for d in self.devices:
            if d.type == "cuda" and d.index is None:
                raise ValueError("mesh devices need explicit indices: a bare "
                                 "'cuda' is the calling thread's device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """The device of the first slot, where sharded results gather."""
        return self.devices[0]

    def distinct(self) -> tuple:
        """The distinct devices, in order of their first slot."""
        return tuple(dict.fromkeys(self.devices))


def visible_devices() -> list:
    """``cuda:i`` for every visible card (explicit indices)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, devices=None) -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (default: the
    visible cards), slots numbered from 0."""
    devs = [torch.device(d) for d in (visible_devices() if devices is None
                                      else devices)]
    if n_devices is not None:
        devs = devs[:n_devices]
    return DeviceMesh(tuple(devs), tuple(range(len(devs))))


def _tree_to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)        # no copy when it is there already
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree


def replicate(tree, mesh: DeviceMesh) -> list:
    """One entry per slot: ``tree`` (tensors in dicts, lists and tuples) on
    the slot's device. Slots that share a device share one copy, and a
    device that already holds ``tree`` gets ``tree`` itself."""
    copies = {d: _tree_to(tree, d) for d in mesh.distinct()}
    return [copies[d] for d in mesh.devices]


def shard_leading(x, mesh: DeviceMesh) -> list:
    """``x`` split along its leading dim over the slots
    (``torch.tensor_split``: sizes differ by at most one, the first slots
    take the larger), each piece on its slot's device. The decode pads to a
    multiple of the mesh size first (:func:`pad_to_multiple`); the BA system
    takes uneven pieces."""
    return [p.to(d) for p, d in zip(torch.tensor_split(x, mesh.size),
                                    mesh.devices)]


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def bind_thread(device) -> None:
    """Make ``device`` the calling thread's current CUDA device (a worker
    thread's first act, so that anything it creates without an explicit
    device lands on its role's card). Nothing for a CPU device, nor for a
    bare "cuda", which names no card but whichever is current."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
