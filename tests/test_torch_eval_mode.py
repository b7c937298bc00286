"""The port's eval step after a train step (train/trainer.py): every eval
call runs the model in eval mode, as the JAX package's eval step applies
train=False on every call. A small model with the port's BatchNorm2d and
DropPath, on the CPU; no JAX, seconds."""

import numpy as np
import torch
from torch import nn

from smow_net_tpu_torch.nn.layers import BatchNorm2d
from smow_net_tpu_torch.nn.ssm import DropPath
from smow_net_tpu_torch.train.trainer import (create_train_state, make_eval_step,
                                              make_optimizer, make_train_step)


class _Tiny(nn.Module):
    """(x1, x2) -> (B, 1, H, W) logits through a conv, BN and a DropPath
    branch; records the mode of each forward."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(6, 4, 3, padding=1)
        self.bn = BatchNorm2d(4)
        self.drop = DropPath(0.5)
        self.head = nn.Conv2d(4, 1, 1)
        self.modes = []

    def forward(self, x1, x2):
        self.modes.append(self.training)
        y = self.bn(self.conv(torch.cat([x1, x2], dim=1)))
        return self.head(y + self.drop(torch.relu(y)))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"A": rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
            "B": rng.normal(size=(4, 8, 8, 3)).astype(np.float32),
            "mask": (rng.random((4, 8, 8)) > 0.5).astype(np.float32)}


def test_eval_step_after_a_train_step_runs_in_eval_mode():
    torch.manual_seed(0)
    model = _Tiny()
    state = create_train_state(model, make_optimizer(lambda count: 1e-2)(model.parameters()))
    eval_step = make_eval_step(model)
    train_step = make_train_step(model, state.optimizer)
    batch = _batch(1)

    eval_step(batch)
    train_step(state, _batch(2))
    assert model.training
    stats = [b.clone() for b in (model.bn.running_mean, model.bn.running_var)]
    draws = state.generator.get_state()
    model.modes.clear()
    cm, loss, pred = eval_step(batch)

    # the eval call ran in eval mode, left the BN statistics and drew no mask
    assert model.modes == [False]
    assert torch.equal(model.bn.running_mean, stats[0])
    assert torch.equal(model.bn.running_var, stats[1])
    assert torch.equal(state.generator.get_state(), draws)
    # and equals a fresh eval step on the same weights
    cm_f, loss_f, pred_f = make_eval_step(model)(batch)
    assert torch.equal(pred, pred_f)
    assert torch.equal(loss, loss_f)
    assert torch.equal(cm, cm_f)
