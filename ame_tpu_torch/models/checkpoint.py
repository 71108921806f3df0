"""Training checkpoint and resume (port of ``ame_tpu/models/checkpoint.py``,
which keeps them with orbax).

A checkpoint is one file, ``<dir>/ckpt_<epoch>.pt``, written by
``torch.save`` of {"model": state dict, "optimizer": state dict, "epoch"}
to a temporary name and renamed, so a crash never leaves a partial file
under a checkpoint's name. The newest 3 are kept, as orbax's
``max_to_keep=3`` keeps them.
"""

from __future__ import annotations

import os
import re

import torch

KEEP = 3
_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _epochs(ckpt_dir: str) -> list[int]:
    """The epochs with a checkpoint in ckpt_dir, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                              os.listdir(ckpt_dir)) if m)


def _path(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{epoch}.pt")


def save_train_state(ckpt_dir: str, epoch: int, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer,
                     keep: int = KEEP) -> str:
    """Write checkpoint ``epoch`` (blocking) and drop all but the newest
    ``keep``. Returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, epoch)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"model": model.state_dict(),
                "optimizer": optimizer.state_dict(), "epoch": int(epoch)},
               tmp)
    os.replace(tmp, path)
    for old in _epochs(ckpt_dir)[:-keep]:
        os.remove(_path(ckpt_dir, old))
    return path


def restore_train_state(ckpt_dir: str, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer):
    """(model, optimizer, next_epoch): the newest checkpoint loaded into
    ``model`` and ``optimizer`` (in place, onto the model's device), or
    both untouched and epoch 0 when there is none."""
    epochs = _epochs(ckpt_dir)
    if not epochs:
        return model, optimizer, 0
    device = next(model.parameters()).device
    state = torch.load(_path(ckpt_dir, epochs[-1]), map_location=device,
                       weights_only=True)
    model.load_state_dict(state["model"])
    optimizer.load_state_dict(state["optimizer"])
    return model, optimizer, int(state["epoch"]) + 1
