"""Train and eval steps (port of smow_net_tpu/train/trainer.py, without the
device mesh: one card).

The batch is the JAX step's dict: A, B (B, H, W, 3) float images, mask
(B, H, W) and an optional valid (B,). Prediction heads as the reference
(train.py:170-174): 1-channel -> squeeze, 2-channel -> sigmoid, channel 1.

`make_train_step(model, optimizer, compute_dtype)` returns step(state,
batch) -> loss. One step: forward in train mode, `select_pred`, the
BCE-Dice loss on fp32 predictions, backward, per-element gradient clip,
the optimizer update, and the confusion matrix accumulated on the device.
It updates the model, the optimizer and `state` in place. With
compute_dtype=torch.bfloat16 the forward and backward run on a bf16 cast of
the fp32 master parameters (`torch.func.functional_call`); the cast is
differentiable, so the gradients reach the masters in fp32, as JAX's
`tree_map(astype)` does. BatchNorm running statistics are buffers, never
cast, and stay fp32. The train state owns a torch.Generator on the model's
device, seeded by `create_train_state`; every DropPath of the model draws
its masks from it, so a run can be repeated (JAX folds the step into its
dropout key instead; the masks differ, their law does not).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch
from torch.func import functional_call

from ..nn.ssm import DropPath
from .loss import bce_dice_loss
from .metrics import confusion_matrix

__all__ = ["Optimizer", "make_optimizer", "TrainState", "create_train_state",
           "select_pred", "make_train_step", "make_eval_step"]


def select_pred(out: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) -> squeeze; (B, 2, H, W) -> sigmoid, channel 1
    (reference train.py:170-174)."""
    if out.shape[1] == 1:
        return out[:, 0]
    return torch.sigmoid(out)[:, 1]


class Optimizer:
    """optax.chain(clip(clip), adamw(schedule, 0.9, 0.999, 1e-8, wd)) or
    chain(clip, add_decayed_weights(wd), sgd(schedule, momentum)) over
    `params`: each gradient element is clamped to +-clip, then torch's AdamW
    (decoupled weight decay; the same update as optax's adamw) or SGD with
    weight decay added to the gradient before the momentum trace (optax's
    order). The learning rate is schedule(count) with `count` the number of
    updates made before this one, as optax counts."""

    def __init__(self, params, schedule: Callable, weight_decay: float = 1e-4,
                 clip: float = 0.5, optimizer: str = "adamw", momentum: float = 0.9):
        self.params = list(params)
        self.schedule, self.clip, self.count = schedule, clip, 0
        lr = float(schedule(0))
        if optimizer == "adamw":
            self.inner = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=weight_decay)
        elif optimizer == "sgd":
            self.inner = torch.optim.SGD(self.params, lr=lr, momentum=momentum,
                                         weight_decay=weight_decay)
        else:
            raise ValueError(optimizer)

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        # optax updates every leaf: a parameter that got no gradient (SMOW_Net_LW's
        # features.18, which feeds no tap) takes a zero one, so its weight decay
        # and moments move as in JAX
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.clip and self.clip > 0:
            torch._foreach_clamp_min_(grads, -self.clip)
            torch._foreach_clamp_max_(grads, self.clip)
        for group in self.inner.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self.inner.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "inner": self.inner.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        self.inner.load_state_dict(sd["inner"])


def make_optimizer(schedule: Callable, weight_decay: float = 1e-4, clip: float = 0.5,
                   optimizer: str = "adamw", momentum: float = 0.9) -> Callable:
    """The JAX package's `make_optimizer`; returns params -> Optimizer (the
    counterpart of optax's tx, and calling it of tx.init)."""
    if optimizer not in ("adamw", "sgd"):
        raise ValueError(optimizer)
    return functools.partial(Optimizer, schedule=schedule, weight_decay=weight_decay,
                             clip=clip, optimizer=optimizer, momentum=momentum)


@dataclasses.dataclass
class TrainState:
    """What a run carries between steps: the model (master parameters and
    BN statistics), its optimizer, the step count, the metrics summed on
    the device since the last reset, and the generator of the model's
    DropPath masks."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int
    cm: torch.Tensor
    loss_sum: torch.Tensor
    loss_count: torch.Tensor
    generator: torch.Generator


def create_train_state(model: torch.nn.Module, optimizer: Optimizer,
                       seed: int = 0) -> TrainState:
    """The state of a run from step 0; attaches its generator, seeded with
    `seed`, to every DropPath of `model`."""
    device = next(model.parameters()).device
    zero = functools.partial(torch.zeros, dtype=torch.float32, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    for m in model.modules():
        if isinstance(m, DropPath):
            m.generator = generator
    return TrainState(model=model, optimizer=optimizer, step=0, cm=zero(2, 2),
                      loss_sum=zero(()), loss_count=zero(()), generator=generator)


def _batch_tensors(batch, device, dtype):
    def image(x):
        return torch.as_tensor(x, device=device).permute(0, 3, 1, 2).to(dtype)

    gt = torch.as_tensor(batch["mask"], device=device, dtype=torch.float32)
    valid = batch.get("valid")
    if valid is not None:
        valid = torch.as_tensor(valid, device=device, dtype=torch.float32)
    return image(batch["A"]), image(batch["B"]), gt, valid


def make_train_step(model: torch.nn.Module, optimizer: Optimizer, compute_dtype=None):
    """step(state, batch) -> loss for `state = create_train_state(model,
    optimizer)`; see the module docstring."""
    param = next(model.parameters())
    device, dtype = param.device, compute_dtype or param.dtype

    def forward(x1, x2):
        if compute_dtype is None:
            return model(x1, x2)
        params = {n: p.to(compute_dtype) for n, p in model.named_parameters()}
        return functional_call(model, params, (x1, x2))

    def step(state: TrainState, batch) -> torch.Tensor:
        x1, x2, gt, valid = _batch_tensors(batch, device, dtype)
        model.train()
        pred = select_pred(forward(x1, x2)).float()
        loss = bce_dice_loss(pred, gt, valid)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        loss = loss.detach()
        with torch.no_grad():
            state.cm += confusion_matrix(pred.detach(), gt, valid=valid)
            state.loss_sum += loss
            state.loss_count += 1.0
        state.step += 1
        return loss

    return step


def make_eval_step(model: torch.nn.Module):
    """step(batch) -> (cm, loss, pred) on the model's device and dtype under
    torch.inference_mode(); the loss and metrics take fp32 predictions.
    Each call puts the model in eval mode (a train step in between puts it
    in train mode), as JAX's eval step applies train=False on every call:
    BN normalises with its running statistics and leaves them as they are,
    and DropPath draws no mask."""
    param = next(model.parameters())
    device, dtype = param.device, param.dtype

    @torch.inference_mode()
    def step(batch):
        model.eval()
        x1, x2, gt, valid = _batch_tensors(batch, device, dtype)
        pred = select_pred(model(x1, x2)).float()
        loss = bce_dice_loss(pred, gt, valid)
        return confusion_matrix(pred, gt, valid=valid), loss, pred

    return step
