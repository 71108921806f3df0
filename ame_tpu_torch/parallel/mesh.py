"""Device meshes and the multi-process runtime (port of
``ame_tpu/parallel/mesh.py``: ``init_distributed``, ``make_mesh``).

A ``Mesh`` is an ndarray of ``torch.device`` with named axes. The port's
multi-device paths run in the caller's one process: shard *i* of an axis
lives on the axis's device *i*, each stage's per-shard work runs in a loop
over the shards (launches on different cards are asynchronous, so the loop
overlaps them), and the small cross-shard tensors move with ``.to(device)``.
A mesh may name one device several times: D shards then run on one card (or
on the CPU, as the tests run D = 8), which is the counterpart of the JAX
tests' virtual host devices.

The multi-process path, the sharded training step (``parallel/train.py``),
runs one process a rank over ``torch.distributed``: ``init_distributed``
starts the process group, and a mesh then describes the ranks, rank r on
its flat row-major entry r.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ame_tpu_torch.device import resolve_device


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device="cuda",
                     timeout: float = 600.0) -> int:
    """Start ``torch.distributed``'s process group for a multi-process run;
    returns the world size.

    Call once per process before the sharded training step. The arguments
    map to ``init_process_group``: ``coordinator_address`` is the
    ``init_method`` (``tcp://host:port``, ``file:///path``; a bare
    ``host:port`` means TCP), ``num_processes`` the world size,
    ``process_id`` the rank. They default to torchrun's environment:
    ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``), ``WORLD_SIZE``,
    ``RANK``; ``AME_TPU_COORDINATOR_ADDRESS`` names an ``init_method`` for
    launchers that export no TCP address, and ``AME_TPU_DISTRIBUTED=1``
    forces ``env://``. With none of these signals it is a no-op returning
    1: a single-card box must not wait for a coordinator. Called again once
    the group exists, it returns its size.

    ``device`` "cuda" (default; raises without a card) selects the card
    ``LOCAL_RANK`` (else the rank modulo the card count) and the ``nccl``
    backend; "cpu" the ``gloo`` backend. ``timeout`` (seconds) bounds every
    collective, so a lost rank fails the others instead of hanging them."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    coordinator_address = (coordinator_address
                           or env.get("AME_TPU_COORDINATOR_ADDRESS"))
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    forced = (env.get("AME_TPU_DISTRIBUTED") == "1"
              or ("MASTER_ADDR" in env and "MASTER_PORT" in env))
    if (coordinator_address is None and num_processes is None
            and process_id is None and not forced):
        return 1
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dev = resolve_device(device, "distributed training")
    if dev.type == "cuda":
        local = env.get("LOCAL_RANK")
        torch.cuda.set_device(
            int(local) if local is not None
            else (process_id or 0) % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=datetime.timedelta(seconds=timeout))
    return dist.get_world_size()


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
