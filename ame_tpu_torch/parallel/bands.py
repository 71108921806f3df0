"""Band-parallel ("expert"-style) multiband compression over a device mesh
(port of ``ame_tpu/parallel/bands.py``).

Each device on the mesh's ``band`` axis owns ONE crossover band: its own
LR4 cascade off the whole input (K5, in pieces of at most 8 sections on the
card) and its own compressor threshold and ratio
(``compressor.compress_quality_multi`` on that band alone); the compressed
bands are summed on the axis's first device. This is model parallelism over
the frequency axis, beside the data parallelism of ``parallel/batch.py``
and the time sharding of ``parallel/sp_master.py``: a G-band master
(``graph/multiband.multiband_quality_n``) at one band's working set a
device.

Reference: the 3-band multiband stage (audio_mastering_engine.py:299-309),
generalized to G bands and distributed.
"""

from __future__ import annotations

import torch

from ame_tpu_torch import config as C
from ame_tpu_torch.graph import multiband as mb
from ame_tpu_torch.ops import compressor
from ame_tpu_torch.ops.scan_iir import sosfilt
from ame_tpu_torch.parallel.mesh import Mesh


def multiband_band_parallel(x: torch.Tensor, sample_rate: float, edges,
                            threshs, ratios, mesh: Mesh, axis: str = "band",
                            attack_ms: float = C.MB_ATTACK_MS,
                            release_ms: float = C.MB_RELEASE_MS
                            ) -> torch.Tensor:
    """G-band multiband compression with one band a device.

    Args:
      x: [N, C] float32; copied to every device on the ``axis``.
      edges: G-1 crossover frequencies (Hz, ascending); G must equal the
        mesh's ``axis`` size.
      threshs / ratios: per-band compressor parameters, length G.
      mesh: a Mesh with a ``band`` (or ``axis``-named) axis of size G.

    Returns the recombined [N, C] master on the axis's first device."""
    edges = tuple(float(e) for e in edges)
    G = len(edges) + 1
    if mesh.shape.get(axis) != G:
        raise ValueError(
            f"mesh axis '{axis}' has {mesh.shape.get(axis)} slices; "
            f"{G} bands need exactly G slices (edges={edges})")
    cascades = mb._band_cascades_n(float(sample_rate), edges)
    devs = mesh.axis_devices(axis)
    comps = []
    for g, (sos, dev) in enumerate(zip(cascades, devs)):
        band = sosfilt(sos, x.to(dev))[0]
        comps.append(compressor.compress_quality_multi(
            [band], float(sample_rate), [float(threshs[g])],
            [float(ratios[g])], attack_ms, release_ms)[0])
    out = comps[0]
    for c in comps[1:]:
        out = out + c.to(out.device)
    return out
