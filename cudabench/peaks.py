"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates, at the full 700 W power limit)."""

from __future__ import annotations

PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "f32_flops_per_s": 67e12,
             "bf16_flops_per_s": 989e12},
}


def for_device(kind: str) -> dict | None:
    """The peaks of the card named ``kind`` (``torch.cuda
    .get_device_name``), or None for a card not in the table."""
    for key, peaks in PEAKS.items():
        if key in kind:
            return peaks
    return None
