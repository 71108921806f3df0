"""Carry the reference's graph parameters over to the port.

The quality path has no trained weights: what must match between
``ame_tpu`` and ``ame_tpu_torch`` is the parameters and the filter state
(``zi``/``zf`` keep scipy's [k, C, 2] layout on both sides, so either side's
state can be handed to the other as a numpy array).
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(d: dict, device) -> dict:
    """``ame_tpu.graph.chain.params_from_settings(s)`` converted to numpy
    (``{k: np.asarray(v)}``) -> the port's params, as
    ``ame_tpu_torch.graph.chain.params_from_settings`` builds them: 0-d
    arrays become host floats (the same float32 values), vectors become
    float32 tensors on ``device``."""
    out = {}
    for name, v in d.items():
        a = np.asarray(v)
        if a.ndim == 0:
            out[name] = float(a)
        else:
            out[name] = torch.as_tensor(a.astype(np.float32), device=device)
    return out
