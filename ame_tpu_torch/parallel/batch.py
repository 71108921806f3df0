"""Fleet mastering of a same-length batch: ``master_batch`` (port of
``ame_tpu/parallel/batch.py``).

Tracks are independent (SURVEY.md §5.8 — "pure data parallelism"). The
reference runs the unmodified single-track quality program B times inside
one dispatch (``lax.map`` under a ``shard_map`` over a mesh's data axis),
which amortizes the per-dispatch host round trip of a TPU. One card has
no such dispatch to amortize: this port runs the same single-track chain
(``graph.chain.master_graph`` in quality mode, the K5 cascades and all)
B times in a row on ``device`` (the card unless the caller asks for the
CPU), so a batch costs B single-track chains. Capturing the chain in a
CUDA graph is the later lever.

With ``mesh`` (``parallel/mesh.make_mesh``, a 'data' axis of D devices)
the batch is split into D contiguous groups, group d mastered on the axis's
device d; the tracks are launched device by device in turn, so D cards
overlap, and the results come back in order on the axis's first device.
"""

from __future__ import annotations

import dataclasses

import torch

from ame_tpu_torch.config import MasterSettings
from ame_tpu_torch.device import resolve_device
from ame_tpu_torch.graph.chain import master_graph


def master_batch(xs, sample_rate: float, settings, mesh=None,
                 device="cuda") -> torch.Tensor:
    """Master a batch of tracks in quality mode.

    Args:
      xs: [B, N, 2] float32 (tensor or numpy).
      settings: MasterSettings or reference settings dict; the quality
        chain runs whatever its ``mode``, as ``ame_tpu``'s does.
      mesh: None, or a Mesh with a 'data' axis whose size divides B: the
        batch is split over that axis's devices (``device`` is then not
        used).
      device: without a mesh, "cuda" (default; raises without a card) or
        "cpu", which runs the plain PyTorch versions of the kernels.

    Returns mastered [B, N, 2] on ``device`` (with a mesh: on the data
    axis's first device)."""
    if isinstance(settings, dict):
        settings = MasterSettings.from_dict(settings)
    settings = dataclasses.replace(settings, mode="quality")
    xs = torch.as_tensor(xs, dtype=torch.float32)
    if xs.ndim != 3 or xs.shape[-1] != 2:
        raise ValueError(f"master_batch takes [B, N, 2], got "
                         f"{tuple(xs.shape)}")
    if mesh is None:
        xs = xs.to(resolve_device(device, "master_batch"))
        return torch.stack([master_graph(x, sample_rate, settings)[0]
                            for x in xs])
    devs = mesh.axis_devices("data")
    B, D = xs.shape[0], len(devs)
    if B % D:
        raise ValueError(f"a batch of {B} does not split over the {D} "
                         f"devices of the mesh's 'data' axis")
    per = B // D
    groups = [xs[d * per:(d + 1) * per].to(dev) for d, dev in enumerate(devs)]
    ys = [[None] * per for _ in devs]
    for i in range(per):
        for d in range(D):
            ys[d][i] = master_graph(groups[d][i], sample_rate, settings)[0]
    dev0 = devs[0]
    return torch.stack([y.to(dev0) for group in ys for y in group])
