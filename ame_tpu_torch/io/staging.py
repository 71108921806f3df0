"""Page-locked host staging for the card's two copies of a track.

On a CUDA device ``api.master_file`` decodes a PCM16 WAV straight into a
page-locked host block and uploads from it without blocking, and
``api`` fetches an int16 master into a second block, which
``write_audio`` writes from. The card copies page-locked memory by DMA;
from pageable memory CUDA copies through a staging buffer of its
own, and a fresh ``.cpu()`` buffer faults its pages in during the copy.

A ``Pool`` holds one block a direction, ``"in"`` (decode, then upload)
and ``"out"`` (fetch, then encode), and ``pool`` keeps one a thread and
device: served workers master on several threads at once. A block grows
to the next power of two at or above the need and is then reused. Each
block the pool makes is counted in the open span's ``host_bytes``
(``utils.telemetry.note_host_bytes``); a reused one counts nothing. The
``"in"`` block is not written again until the last upload from it has
completed, which an event marks, also after a call that raised before it
waited for its device work.

``decoding_into(pool)`` is the private scope in which this thread's PCM16
decode with ``prefer_int16`` (``io/wav.read_wav``) reads its samples into
the pool's ``"in"`` block (``decode_buffer``) instead of a new array.
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

from ame_tpu_torch.utils.telemetry import note_host_bytes

_local = threading.local()   # .pools: {device: Pool}; .decode: Pool or None


def _pinned(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


class Pool:
    """One thread's reusable host blocks for one device. ``alloc(nbytes)``
    makes a block: a 1-D uint8 CPU tensor (page-locked by default)."""

    def __init__(self, alloc=_pinned):
        self._alloc = alloc
        self._blocks: dict[str, torch.Tensor] = {}
        self._uploading = None   # event after the last upload from "in"

    def block(self, direction: str, nbytes: int) -> torch.Tensor:
        """The first ``nbytes`` of ``direction``'s block, free to write."""
        if direction == "in" and self._uploading is not None:
            self._uploading.synchronize()
            self._uploading = None
        b = self._blocks.get(direction)
        if b is None or b.numel() < nbytes:
            del b
            self._blocks.pop(direction, None)   # freed before the new one
            cap = 1 << max(nbytes - 1, 0).bit_length()
            b = self._blocks[direction] = self._alloc(cap)
            note_host_bytes(cap)
        return b[:nbytes]

    def upload(self, audio: np.ndarray,
               device: torch.device) -> torch.Tensor | None:
        """``audio`` on ``device``, copied without blocking from the
        ``"in"`` block where it is the block's int16 samples from its start
        (a decode inside ``decoding_into``); the block stays unwritten until
        the copy is done. None for any other array."""
        b = self._blocks.get("in")
        if (b is None or audio.dtype != np.int16
                or not audio.flags.c_contiguous
                or audio.ctypes.data != b.data_ptr()
                or audio.nbytes > b.numel()):
            return None
        src = b[:audio.nbytes].view(torch.int16).view(audio.shape)
        out = src.to(device, non_blocking=True)
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            self._uploading = done
        return out

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        """``t``'s values in the ``"out"`` block, as an array of its
        shape; the copy waits for the device work queued before it. The
        array is valid until this thread's next ``fetch`` from the pool."""
        host = self.block("out", t.numel() * t.element_size())
        host = host.view(t.dtype).view(t.shape)
        host.copy_(t)
        return host.numpy()


def pool(device: torch.device) -> Pool | None:
    """This thread's pool for the CUDA ``device``; None for any other
    device, whose copies stay as they are."""
    if device.type != "cuda":
        return None
    pools = getattr(_local, "pools", None)
    if pools is None:
        pools = _local.pools = {}
    p = pools.get(device)
    if p is None:
        p = pools[device] = Pool()
    return p


@contextlib.contextmanager
def decoding_into(p: Pool | None):
    """Inside the block, this thread's PCM16 decode with ``prefer_int16``
    reads into ``p``'s ``"in"`` block; with ``p`` None, nothing changes."""
    prev = getattr(_local, "decode", None)
    _local.decode = p
    try:
        yield
    finally:
        _local.decode = prev


def decode_buffer(nbytes: int) -> np.ndarray | None:
    """A writable uint8 array of ``nbytes`` over the open scope's ``"in"``
    block; None outside a ``decoding_into`` scope."""
    p = getattr(_local, "decode", None)
    return None if p is None else p.block("in", nbytes).numpy()
