"""Disjoint device topology: tracking, backend and services on separate
devices (counterpart of ``mast3r_slam_tpu/parallel/topology.py``).

On one device every role's work serializes, so the backend's keyframe
event, the quality batches and the TSDF refiner stall tracking. With more
devices, the frame-rate-critical tracker gets one of its own and the
asynchronous work fans out over the rest. Layout for ``n`` device slots,
slot for slot the JAX package's rule:

- slot 0            → frontend tracking (every per-frame computation)
- slots 1..k        → the backend mesh (symmetric pair decode and the BA's
                      edge systems), ``k`` the largest power of two that
                      leaves the frontend its slot; with no spare slot and
                      ``k >= 4`` (n = 5) one backend slot goes to the
                      services instead
- remaining slots   → quality service, local TSDF refiner, global TSDF
                      (round-robin; the last backend slot when none is
                      spare)

One process drives every device. Frontend tensors live on the frontend
device; the model and the factor graph place the backend's inputs on the
mesh and commit solved poses back to the frontend device; each service
copies what it reads to its own device. Slots may repeat a device
(``plan_topology([cpu] * 8)``, or five slots of one card), which runs the
multi-device code on one physical device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mast3r_slam_tpu_torch.parallel.sharding import DeviceMesh, visible_devices


@dataclass(frozen=True)
class Topology:
    """Device assignment for one SLAM run: ``devices`` is the planned
    slot list, each role holds slot numbers into it (None / empty where the
    role has no device of its own)."""

    devices: tuple
    frontend: int | None
    backend: tuple
    quality: int | None
    tsdf_local: int | None
    tsdf_global: int | None

    def _dev(self, slot):
        return None if slot is None else self.devices[slot]

    @property
    def frontend_device(self):
        return self._dev(self.frontend)

    @property
    def backend_mesh(self) -> DeviceMesh | None:
        if not self.backend:
            return None
        return DeviceMesh(tuple(self.devices[s] for s in self.backend),
                          self.backend)

    @property
    def quality_device(self):
        return self._dev(self.quality)

    @property
    def tsdf_local_device(self):
        return self._dev(self.tsdf_local)

    @property
    def tsdf_global_device(self):
        return self._dev(self.tsdf_global)

    @property
    def n_backend(self) -> int:
        return len(self.backend)

    def describe(self) -> str:
        def _n(slot):
            return "-" if slot is None else f"{self.devices[slot]}#{slot}"

        back = ",".join(_n(s) for s in self.backend) or "none"
        return (f"frontend={_n(self.frontend)} backend=[{back}] "
                f"quality={_n(self.quality)} "
                f"tsdf_local={_n(self.tsdf_local)} "
                f"tsdf_global={_n(self.tsdf_global)}")


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def plan_topology(devices=None) -> Topology:
    """Assign the device slots to the SLAM roles (see module docstring).
    ``devices`` defaults to every visible card, ``cuda:i`` with explicit
    indices."""
    devs = tuple(torch.device(d) for d in (visible_devices() if devices is None
                                           else devices))
    n = len(devs)
    if n <= 1:
        return Topology(devs, 0 if devs else None, (), None, None, None)
    rest = list(range(1, n))
    n_back = _pow2_floor(len(rest))
    spare = rest[n_back:]
    backend = rest[:n_back]
    if not spare and n_back >= 4:
        n_back //= 2
        backend = rest[:n_back]
        spare = rest[n_back:]
    pool = spare if spare else backend[-1:]
    return Topology(devs, 0, tuple(backend), pool[0 % len(pool)],
                    pool[1 % len(pool)], pool[2 % len(pool)])
