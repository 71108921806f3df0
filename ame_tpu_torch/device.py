"""The port's device rule: every entry point runs on the card unless its
caller asks for the host, and never falls back to the CPU in silence."""

from __future__ import annotations

import torch


def resolve_device(device, what: str) -> torch.device:
    """``torch.device(device)``; raises where it names CUDA and there is no
    card. ``what`` names the caller in the message ("the fleet")."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device: {what} runs on the card "
                           "(device='cpu' / --device cpu runs it on the "
                           "host)")
    return dev
