"""Sequence-parallel IIR filtering (port of ``ame_tpu/parallel/sequence.py``).

The time axis of [N, C] is split into D equal shards over a mesh axis
(``parallel/mesh.py``: shard i on the axis's device i). The decomposition
that makes one cascade blocked works across shards: each shard filters its
rows from zero state (one K5 launch a shard on the card), the shards'
[k, C, 2] end states go to the first shard's device, the state entering
each shard is composed there from the states of the shards before it
(c_{s+1} = A^{local_n} c_s + e_s, with A^{local_n} built on the host in
float64 by binary powers, so a shard need not be a power of two long), and
each shard's output gets the zero-input response from its inbound state
(``scan_iir.zero_input_response``: the cascade over zeros from that
state). Linearity makes the sum exact. The first shard's inbound state is
zero, so it gets no correction; with one shard the carry work is skipped.
"""

from __future__ import annotations

import numpy as np
import torch

from ame_tpu_torch.parallel.mesh import Mesh, gather_rows, shard_rows
from ame_tpu_torch.ops.scan_iir import (_state_space_np, sosfilt,
                                        zero_input_response)


def _matrix_power(A: np.ndarray, m: int) -> np.ndarray:
    """A^m in float64 by binary powers (any m)."""
    out = np.eye(A.shape[0])
    p = A.copy()
    while m:
        if m & 1:
            out = p @ out
        p = p @ p
        m >>= 1
    return out


def sosfilt_shards(sos, parts: list) -> list:
    """The cascade over the concatenation of ``parts`` (equal-length
    [local_n, C] shards, each on its own device), as per-shard outputs.
    ``sos``: host coefficients [k, 6]."""
    sos64 = np.ascontiguousarray(np.asarray(sos, np.float64))
    if len(parts) == 1:
        # one shard: the inbound state is zero, so the gather / compose /
        # correction would add 0
        return [sosfilt(sos64, parts[0])[0]]
    D = len(parts)
    local_n = parts[0].shape[0]
    k = sos64.shape[0]
    A, _, _, _, Vf, Vi = _state_space_np(sos64)
    outs = [sosfilt(sos64, p) for p in parts]            # zero state each
    dev0 = parts[0].device
    zf = torch.stack([z.to(dev0, torch.float64) for _, z in outs])
    C = zf.shape[2]
    f64 = dict(device=dev0, dtype=torch.float64)
    Vi_t, Vf_t = torch.tensor(Vi, **f64), torch.tensor(Vf, **f64)
    AL = torch.tensor(_matrix_power(A, local_n), **f64)
    # the shards' zero-state end states in the internal basis: [D, 2k, C]
    e_int = torch.einsum("kab,dkcb->dkac", Vi_t, zf).reshape(D, 2 * k, C)
    ys = [outs[0][0]]
    c = e_int[0]
    for s in range(1, D):
        zi = torch.einsum("kab,kbc->kca", Vf_t, c.reshape(k, 2, C))
        zi = zi.to(parts[s].device, torch.float32).contiguous()
        ys.append(outs[s][0] + zero_input_response(sos64, zi, local_n))
        c = AL @ c + e_int[s]
    return ys


def sosfilt_sequence_parallel(sos, x: torch.Tensor, mesh: Mesh,
                              axis: str = "sp") -> torch.Tensor:
    """Filter [N, C] x with the time axis sharded over mesh axis ``axis``;
    returns the filtered [N, C] on x's device.

    ``sos`` must be host coefficients (numpy): every filter the sharded
    chains run is designed on the host. N must divide evenly by the axis
    size. Exact up to f32 rounding: matches the one-device ``sosfilt``."""
    if isinstance(sos, torch.Tensor):
        raise NotImplementedError(
            "sequence-parallel filtering requires host-known coefficients")
    ys = sosfilt_shards(sos, shard_rows(x, mesh, axis))
    return gather_rows(ys).to(x.device)
