"""Precision policy of the port: float32 products are true fp32.

The tile-conv tables and the loudness sums rely on full fp32 products
(``ops/tile_conv.py``: ~1e-7 relative against float64 scipy); TF32 keeps about
three decimal digits. PyTorch leaves cuBLAS in fp32 by default but runs
cuDNN convolutions in TF32, and either can be switched on elsewhere in a
process, so the chain applies this policy before it runs. bf16 appears only
where the reference chose it (the true-peak operands, ``ops/loudness.py``).
"""

from __future__ import annotations

import torch


def apply() -> None:
    """Turn TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_enabled() -> bool:
    """Whether either backend may use TF32 for float32 work."""
    return bool(torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)
