"""Device meshes for the port's multi-device paths (port of
``ame_tpu/parallel/mesh.py``: ``make_mesh``).

A ``Mesh`` is an ndarray of ``torch.device`` with named axes. The port's
multi-device paths run in the caller's one process: shard *i* of an axis
lives on the axis's device *i*, each stage's per-shard work runs in a loop
over the shards (launches on different cards are asynchronous, so the loop
overlaps them), and the small cross-shard tensors move with ``.to(device)``.
A mesh may name one device several times: D shards then run on one card (or
on the CPU, as the tests run D = 8), which is the counterpart of the JAX
tests' virtual host devices.

``init_distributed`` (the multi-process runtime) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ame_tpu_torch.device import resolve_device


class Mesh:
    """Devices on named axes: ``devices`` an object ndarray of
    ``torch.device`` whose dimensions are ``axis_names``; ``shape`` maps an
    axis name to its size, as a ``jax.sharding.Mesh``'s does."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices along ``axis`` (index 0 on every other axis): shard
        i of an array split over ``axis`` lives on the i-th."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes "
                             f"{self.axis_names})")
        i = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        idx[i] = slice(None)
        return list(self.devices[tuple(idx)])


def make_mesh(axis_specs: dict[str, int] | None = None,
              devices=None) -> Mesh:
    """Build a Mesh. Default devices: every card (``cuda:0`` ..), which
    raises where there is none; ``devices`` names them explicitly (e.g.
    ``["cpu"] * 8``, or one card several times). Default axes: every device
    on one 'data' axis."""
    if devices is None:
        resolve_device("cuda", "the default mesh")
        devices = [torch.device(f"cuda:{i}")
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d, "the mesh") for d in devices]
    if axis_specs is None:
        axis_specs = {"data": len(devices)}
    names = tuple(axis_specs)
    shape = tuple(int(v) for v in axis_specs.values())
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh wants {n} devices, have {len(devices)}")
    dev = np.empty(n, dtype=object)
    dev[:] = devices[:n]
    return Mesh(dev.reshape(shape), names)


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str) -> list:
    """Split [N, ...] ``x`` into the axis's equal row blocks, block i on the
    axis's device i (a view where it already lies there). N must divide by
    the axis size."""
    devs = mesh.axis_devices(axis)
    n = x.shape[0]
    if n % len(devs):
        raise ValueError(f"N={n} not divisible by {len(devs)} shards")
    ln = n // len(devs)
    return [x[i * ln:(i + 1) * ln].to(d) for i, d in enumerate(devs)]


def gather_rows(parts: list) -> torch.Tensor:
    """The shards back in order as one tensor on the first shard's
    device."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts])
