"""Mood classification CNN (port of ``ame_tpu/models/mood_cnn.py``; the
reference's Keras model is N8/C14): inference and training.

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

Training (``forward(..., train=True)``, ``loss_fn``, ``make_train_step``)
is flax's ``MoodCNN.__call__(train=True)``: float32 convolutions with no
bf16 rounding (TF32 off), and Dropout(0.3) after dense0's ReLU, its mask
drawn from an explicit ``torch.Generator``. ``init_params`` uses flax's
default initialisers (truncated-normal LeCun kernels, zero biases).

Weights come from flax checkpoints (``flax.serialization.to_bytes``, as
``ame_tpu/models/train_mood.py`` writes them), read by ``_msgpack`` and
converted by ``convert.mood_cnn_state_dict``; ``save_params`` writes the
same format (``_msgpack.dump`` of ``convert.mood_cnn_params``), so either
package loads what the other trained. The package carries its own copy of
the shipped checkpoint.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from ame_tpu_torch import convert, precision
from ame_tpu_torch.models import _msgpack

MOOD_CLASSES = ("Angry/Anxious", "Calm/Content", "Happy/Excited",
                "Sad/Depressed")
IMG_SIZE = 128

_DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__),
                                "mood_cnn_weights.msgpack")
DROPOUT = 0.3


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

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                dropout: float = DROPOUT) -> torch.Tensor:
        """Logits [B, 4]. ``train=False``: inference, bf16 convolution
        operands. ``train=True``: float32 convolutions, and dropout at rate
        ``dropout`` after dense0 with its mask drawn from ``generator`` (on
        the images' device; required when ``dropout`` > 0)."""
        x = images.permute(0, 3, 1, 2)
        for conv in self.convs:
            if train:
                x = F.conv2d(x, conv.weight, conv.bias, padding=1)
            else:
                x = F.conv2d(_bf16(x), _bf16(conv.weight), conv.bias,
                             padding=1)
            x = F.max_pool2d(F.relu(x), 2)
        x = x.mean(dim=(2, 3))                   # global average pool
        x = F.relu(self.dense0(x))
        if train and dropout > 0.0:
            x = _dropout(x, dropout, generator)
        return self.dense1(x)


def _dropout(x: torch.Tensor, rate: float,
             generator: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each unit with probability 1 - rate and
    scale the kept ones by 1 / (1 - rate)."""
    if generator is None:
        raise ValueError("training dropout draws from an explicit "
                         "torch.Generator; pass generator=")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def init_params(seed: int = 0, device="cpu") -> MoodCNN:
    """A fresh model with flax's default initialisers, from a seeded
    torch.Generator: kernels LeCun normal (variance 1/fan_in, truncated at
    two standard deviations and rescaled, as ``lecun_normal`` is), biases
    zero. Deterministic; the draws are not flax's PRNG's."""
    model = MoodCNN(device="meta").to_empty(device="cpu")
    g = torch.Generator().manual_seed(seed)
    # flax's truncated normal: std / 0.8796... so that the truncated
    # distribution has the requested variance
    scale = 0.87962566103423978
    with torch.no_grad():
        for layer in (*model.convs, model.dense0, model.dense1):
            std = math.sqrt(1.0 / layer.weight[0].numel()) / scale
            torch.nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std,
                                        2.0 * std, generator=g)
            layer.bias.zero_()
    return model.to(device)


def loss_fn(model: MoodCNN, images: torch.Tensor, labels: torch.Tensor,
            generator: torch.Generator | None = None,
            dropout: float = DROPOUT):
    """(mean cross-entropy, accuracy) of the training forward on a batch
    (``ame_tpu/models/mood_cnn.py::loss_fn``). Turns TF32 off first."""
    precision.apply()
    logits = model(images, train=True, generator=generator, dropout=dropout)
    loss = F.cross_entropy(logits, labels)
    acc = (logits.argmax(-1) == labels).to(torch.float32).mean()
    return loss, acc


def make_train_step(optimizer: torch.optim.Optimizer):
    """A step (model, images, labels, generator) -> (loss, acc) that takes
    one optimizer step on the batch."""
    def train_step(model, images, labels, generator):
        optimizer.zero_grad(set_to_none=True)
        loss, acc = loss_fn(model, images, labels, generator)
        loss.backward()
        optimizer.step()
        return loss.detach(), acc
    return train_step


def save_params(model: MoodCNN, path: str | None = None) -> str:
    """Write the model's weights as a flax checkpoint (the format
    ``load_params`` and ``ame_tpu.models.mood_cnn.load_params`` read) to
    ``path``, by default the package's checkpoint. Returns the path."""
    path = path or _DEFAULT_WEIGHTS
    tree = convert.mood_cnn_params(model.state_dict())
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(_msgpack.dump(tree))
    os.replace(tmp, path)
    return path


_cache: dict = {}


def load_params(path: str | None = None, device="cuda"):
    """(model on ``device`` in eval mode, trained). Reads ``path``, else
    ``AME_TPU_MOOD_WEIGHTS``, else the package's checkpoint; where the file
    does not exist, ``init_params(0)``'s untrained weights (``trained``
    False; not ``ame_tpu``'s, whose PRNG draws differ). The model
    is built and uploaded once per (checkpoint, device) and kept: the
    reference measured per-call weight uploads as most of its analysis
    time on a TPU (``ame_tpu/models/mood_cnn.py:84-88``)."""
    path = path or os.environ.get("AME_TPU_MOOD_WEIGHTS", _DEFAULT_WEIGHTS)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (os.path.abspath(path), str(dev))
    if key not in _cache:
        model = init_params(0)
        trained = os.path.exists(path)
        if trained:
            model.load_state_dict(
                convert.mood_cnn_state_dict(_msgpack.load(path)))
        _cache[key] = (model.to(dev).eval().requires_grad_(False), trained)
    return _cache[key]
