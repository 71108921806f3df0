"""Carry the reference's parameters and weights over to the port.

The mastering chains have no trained weights: what must match between
``ame_tpu`` and ``ame_tpu_torch`` there is the parameters and the filter
state (``zi``/``zf`` keep scipy's [k, C, 2] layout on both sides, so either
side's state can be handed to the other as a numpy array). The mood CNN's
trained weights are a flax tree; ``mood_cnn_state_dict`` turns it into the
port's ``MoodCNN`` state dict.
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


def mood_cnn_state_dict(params: dict) -> dict:
    """The mood CNN's flax tree as numpy (``{"Conv_i": {"kernel", "bias"},
    "Dense_j": {...}}``, what ``models/_msgpack.load`` returns) -> the
    state dict of ``ame_tpu_torch.models.mood_cnn.MoodCNN`` (CPU float32
    tensors). Conv kernels go from HWIO [3, 3, Ci, Co] to OIHW [Co, Ci, 3,
    3], dense kernels from [in, out] to Linear's [out, in]."""
    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=torch.float32)

    out = {}
    for i in range(3):
        layer = params[f"Conv_{i}"]
        out[f"convs.{i}.weight"] = t(np.transpose(layer["kernel"],
                                                  (3, 2, 0, 1)))
        out[f"convs.{i}.bias"] = t(layer["bias"])
    for j in range(2):
        layer = params[f"Dense_{j}"]
        out[f"dense{j}.weight"] = t(np.transpose(layer["kernel"]))
        out[f"dense{j}.bias"] = t(layer["bias"])
    return out
