"""Checkpoints (port of smow_net_tpu/train/checkpoint.py): save and restore
a resumable train state (model parameters and BN statistics, optimizer
state and update count, step, accumulated metrics, the DropPath generator's
state) with `torch.save`. A step taken after `restore_checkpoint` equals the
one an uninterrupted run takes. `save_best_params` keeps the model's
`state_dict()` alone (parameters and BN buffers), for evaluation.
Every file is written atomically.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from .trainer import TrainState

__all__ = ["save_checkpoint", "restore_checkpoint", "save_best_params", "restore_best_params"]


def save_checkpoint(path: str, state: TrainState, **extra: Any) -> None:
    """Write `state` and any extra plain values (numbers, strings, tensors:
    e.g. the epoch or the best metric) to the file `path`, atomically."""
    payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
               "step": state.step, "cm": state.cm, "loss_sum": state.loss_sum,
               "loss_count": state.loss_count, "generator": state.generator.get_state(),
               "extra": extra}
    _save(payload, path)


def _save(payload, path: str) -> None:
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
    state.generator.set_state(payload["generator"].cpu())
    return payload["extra"]


def save_best_params(path: str, model: torch.nn.Module) -> None:
    """Write `model.state_dict()` to the file `path`, atomically."""
    _save(model.state_dict(), path)


def restore_best_params(path: str, model: torch.nn.Module) -> None:
    """Load the file `path` (from `save_best_params`) into `model`, strictly."""
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(path, map_location=device, weights_only=True))
