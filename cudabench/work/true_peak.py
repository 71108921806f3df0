"""The least work of the true peak of one track (BS.1770 4x oversampling,
a polyphase bank of 4 phases x 32 taps): each of the [N, C] float32 input
samples read once, and one multiply-add a tap, a phase, a sample and a
channel. The peak it returns is a scalar, so nothing is written. Least
time is the larger of the bytes at the card's HBM bandwidth and the
operations at its bf16 tensor-core peak, the fastest rate any
implementation could use, so that no kernel, dense or polyphase, can read
above 100 %."""

from __future__ import annotations

F32 = 4
PHASES = 4
TAPS = 32


def bytes_for(n_samples: int, channels: int) -> int:
    """Least bytes: the [N, C] float32 input read once."""
    return n_samples * channels * F32


def flops_for(n_samples: int, channels: int) -> int:
    """Least operations: a multiply and an add a tap, a phase, a sample
    and a channel."""
    return 2 * PHASES * TAPS * n_samples * channels


def least_seconds(n_samples: int, channels: int, peaks: dict) -> float:
    """The larger of the bytes over HBM bandwidth and the operations over
    the bf16 peak of ``peaks`` (``peaks.for_device``)."""
    return max(bytes_for(n_samples, channels) / peaks["hbm_bytes_per_s"],
               flops_for(n_samples, channels) / peaks["bf16_flops_per_s"])


def kernel_names(config: dict) -> list[str]:
    """Names (substrings) of the device kernels of the true peak's
    product."""
    return list(config["true_peak_kernels"])
