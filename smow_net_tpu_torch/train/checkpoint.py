"""Checkpoints (port of smow_net_tpu/train/checkpoint.py): save and restore
a resumable train state (model parameters and BN statistics, optimizer
state and update count, step, accumulated metrics) with `torch.save`. A
step taken after `restore_checkpoint` equals the one an uninterrupted run
takes.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from .trainer import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint"]


def save_checkpoint(path: str, state: TrainState, **extra: Any) -> None:
    """Write `state` and any extra plain values (numbers, strings, tensors:
    e.g. the epoch or the best metric) to the file `path`, atomically."""
    payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "step": state.step, "cm": state.cm, "loss_sum": state.loss_sum,
               "loss_count": state.loss_count, "extra": extra}
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, state: TrainState) -> Dict[str, Any]:
    """Load the file `path` into `state` in place (onto the model's device);
    returns the extra values it was saved with."""
    device = state.cm.device
    payload = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    for name in ("cm", "loss_sum", "loss_count"):
        getattr(state, name).copy_(payload[name])
    return payload["extra"]
