"""The cascade work of one master: each cascade stage of the chain (the
configuration's ``cascades`` list) reads its [N, C] float32 input once and
writes its [N, C] output once. Launches, tiles and scratch are not counted,
so a fused or renamed kernel cannot push the share past 100 %."""

from __future__ import annotations

F32 = 4


def bytes_for(config: dict, n_samples: int) -> int:
    """Least bytes the chain's cascades move for one track of
    ``n_samples`` frames."""
    return sum(2 * n_samples * c["channels"] * F32
               for c in config["cascades"])


def kernel_names(config: dict) -> list[str]:
    """Names (substrings) of the device kernels that do the cascade work."""
    return list(config["cascade_kernels"])
