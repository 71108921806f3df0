"""Mood classification CNN, inference only (port of
``ame_tpu/models/mood_cnn.py``; the reference's Keras model is N8/C14).

Interface: a 128x128x3 normalized mel-spectrogram image in, logits over
the four label-encoder classes out (alphabetical, ``MOOD_CLASSES``). The
network: three 3x3 convolutions (32, 64, 128 channels, zero padding 1),
each followed by ReLU and a 2x2 max pool; global average pool; Dense
128 -> 128 with ReLU; Dense 128 -> 4.

Numerics are those of ``ame_tpu.models.mood_cnn.predict_logits``: each
convolution's input and weight are rounded to bf16 and convolved in
float32. A product of two bf16 values is exact in float32 and TF32 is off
(``ame_tpu_torch/precision.py``), so this is XLA's bf16 x bf16 -> f32
contraction up to the order of the float32 sums (the caller applies the
policy: ``analysis/musicologist.py``). The dense layers stay float32.
Training (``loss_fn``, ``make_train_step``) is not ported.

Weights come from flax checkpoints (``flax.serialization.to_bytes``, as
``ame_tpu/models/train_mood.py`` writes them), read by ``_msgpack`` and
converted by ``convert.mood_cnn_state_dict``. The package carries its own
copy of the shipped checkpoint.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from ame_tpu_torch import convert
from ame_tpu_torch.models import _msgpack

MOOD_CLASSES = ("Angry/Anxious", "Calm/Content", "Happy/Excited",
                "Sad/Depressed")
IMG_SIZE = 128

_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__),
                                "mood_cnn_weights.msgpack")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


class MoodCNN(nn.Module):
    """The mood CNN; ``forward`` takes images [B, 128, 128, 3] (the
    reference's channels-last layout) and returns logits [B, 4]."""

    def __init__(self, num_classes: int = len(MOOD_CLASSES), device=None):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(ci, co, 3, padding=1, device=device)
            for ci, co in ((3, 32), (32, 64), (64, 128)))
        self.dense0 = nn.Linear(128, 128, device=device)
        self.dense1 = nn.Linear(128, num_classes, device=device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = images.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.conv2d(_bf16(x), _bf16(conv.weight), conv.bias, padding=1)
            x = F.max_pool2d(F.relu(x), 2)
        x = x.mean(dim=(2, 3))                   # global average pool
        x = F.relu(self.dense0(x))
        return self.dense1(x)


def _seed_init(model: MoodCNN, seed: int = 0) -> None:
    """Uniform(+-1/sqrt(fan_in)) weights and biases from a seeded
    torch.Generator. Deterministic, but not flax's PRNG initialization: the
    untrained weights of the two packages differ."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in (*model.convs, model.dense0, model.dense1):
            bound = 1.0 / math.sqrt(layer.weight[0].numel())
            for p in (layer.weight, layer.bias):
                p.uniform_(-bound, bound, generator=g)


_cache: dict = {}


def load_params(path: str | None = None, device="cuda"):
    """(model on ``device`` in eval mode, trained). Reads ``path``, else
    ``AME_TPU_MOOD_WEIGHTS``, else the package's checkpoint; where the file
    does not exist, seeded untrained weights (``trained`` False). The model
    is built and uploaded once per (checkpoint, device) and kept: the
    reference measured per-call weight uploads as most of its analysis
    time on a TPU (``ame_tpu/models/mood_cnn.py:84-88``)."""
    path = path or os.environ.get("AME_TPU_MOOD_WEIGHTS", _DEFAULT_WEIGHTS)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (os.path.abspath(path), str(dev))
    if key not in _cache:
        model = MoodCNN(device="meta").to_empty(device="cpu")
        trained = os.path.exists(path)
        if trained:
            model.load_state_dict(
                convert.mood_cnn_state_dict(_msgpack.load(path)))
        else:
            _seed_init(model)
        _cache[key] = (model.to(dev).eval().requires_grad_(False), trained)
    return _cache[key]
