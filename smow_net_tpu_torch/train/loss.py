"""BCE + (1 - soft Dice) loss (port of smow_net_tpu/train/loss.py;
reference utils/loss_f.py:8-18).

Takes sigmoid probabilities. BCE matches torch nn.BCELoss including its log
clamp at -100 (predictions clipped to [1e-12, 1 - 1e-7] first); Dice runs
over the whole batch with eps 1e-7. `valid` is an optional (B,) per-sample
weight (padded-batch masking).
"""

from __future__ import annotations

import torch

__all__ = ["bce_dice_loss", "bce_loss", "dice_loss"]


def _weights(pred: torch.Tensor, valid) -> torch.Tensor:
    if valid is None:
        return torch.ones_like(pred)
    w = valid.reshape(valid.shape[0], *([1] * (pred.dim() - 1))).to(pred.dtype)
    return w.expand_as(pred)


def bce_loss(pred: torch.Tensor, gt: torch.Tensor, valid=None) -> torch.Tensor:
    pred = pred.clamp(1e-12, 1.0 - 1e-7)
    log_p = torch.log(pred).clamp_min(-100.0)
    log_1p = torch.log1p(-pred).clamp_min(-100.0)
    elem = -(gt * log_p + (1.0 - gt) * log_1p)
    w = _weights(pred, valid)
    return (elem * w).sum() / w.sum().clamp_min(1.0)


def dice_loss(pred: torch.Tensor, gt: torch.Tensor, valid=None,
              eps: float = 1e-7) -> torch.Tensor:
    w = _weights(pred, valid)
    inter = (gt * pred * w).sum()
    dice = (2.0 * inter + eps) / ((gt * w).sum() + (pred * w).sum() + eps)
    return 1.0 - dice


def bce_dice_loss(pred: torch.Tensor, gt: torch.Tensor, valid=None) -> torch.Tensor:
    return bce_loss(pred, gt, valid) + dice_loss(pred, gt, valid)
