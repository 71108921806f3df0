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

The multi-device mesh (ROADMAP A.9) is not ported: ``mesh=`` raises.
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
      xs: [B, N, 2] float32 (tensor or numpy); moved to ``device``.
      settings: MasterSettings or reference settings dict; the quality
        chain runs whatever its ``mode``, as ``ame_tpu``'s does.
      mesh: not ported; anything but None raises NotImplementedError.
      device: "cuda" (default; raises without a card) or "cpu", which runs
        the plain PyTorch versions of the kernels.

    Returns mastered [B, N, 2] on ``device``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "master_batch(mesh=...): the multi-device paths (ROADMAP A.9) "
            "are not ported to ame_tpu_torch; pass mesh=None to master the "
            "batch on one device")
    dev = resolve_device(device, "master_batch")
    if isinstance(settings, dict):
        settings = MasterSettings.from_dict(settings)
    settings = dataclasses.replace(settings, mode="quality")
    xs = torch.as_tensor(xs, dtype=torch.float32, device=dev)
    if xs.ndim != 3 or xs.shape[-1] != 2:
        raise ValueError(f"master_batch takes [B, N, 2], got "
                         f"{tuple(xs.shape)}")
    return torch.stack([master_graph(x, sample_rate, settings)[0]
                        for x in xs])
