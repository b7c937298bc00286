"""Evaluation step (port of smow_net_tpu/train/trainer.py:52-56, 155-164).

`make_eval_step(model)` returns step(batch) -> (cm, loss, pred) over the
JAX step's batch dict: A, B (B, H, W, 3) float images, mask (B, H, W) and an
optional valid (B,). The step runs on the model's device and dtype under
torch.inference_mode(); the loss and metrics take fp32 predictions.
"""

from __future__ import annotations

import torch

from .loss import bce_dice_loss
from .metrics import confusion_matrix

__all__ = ["select_pred", "make_eval_step"]


def select_pred(out: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) -> squeeze; (B, 2, H, W) -> sigmoid, channel 1
    (reference train.py:170-174)."""
    if out.shape[1] == 1:
        return out[:, 0]
    return torch.sigmoid(out)[:, 1]


def make_eval_step(model: torch.nn.Module):
    model.eval()
    param = next(model.parameters())
    device, dtype = param.device, param.dtype

    def image(x):
        return torch.as_tensor(x, device=device).permute(0, 3, 1, 2).to(dtype)

    @torch.inference_mode()
    def step(batch):
        out = model(image(batch["A"]), image(batch["B"]))
        pred = select_pred(out).float()
        gt = torch.as_tensor(batch["mask"], device=device, dtype=torch.float32)
        valid = batch.get("valid")
        if valid is not None:
            valid = torch.as_tensor(valid, device=device, dtype=torch.float32)
        loss = bce_dice_loss(pred, gt, valid)
        return confusion_matrix(pred, gt, valid=valid), loss, pred

    return step
