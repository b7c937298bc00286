"""The port's SMOW_Net train step (smow_net_tpu_torch/train) against the
JAX package on CPU at 64x64, batch 2.

Every JAX leaf is numpy-seeded as in tests/test_torch_smow_net.py and goes
through `state_dict_from_jax` into the port; the same numpy-seeded batch
runs through both sides.

The whole-model comparisons (a, b, e) run in float64 on both sides (JAX with
x64 switched on for the call, the port's model `.double()`; the fixed fp32
islands of both, the warp coordinates and the decoder's LayerNorm, stay
fp32). In fp32 a deep ReLU / LeakyReLU network cannot be held per leaf to
1e-3 of the largest gradient: the forward activations of the two frameworks
differ by ~7e-6 relative after the encoder, so an activation within that of
0 takes the other branch of the kink on one side (one such element per
decoder BatchNorm at this size), and that single element moves whole
weight gradients by 2e-3 to 4e-3 of their largest element. Measured: the
port in fp32 against itself in fp64, 3.0e-3; JAX in fp32 against the port
in fp64, 1.1e-3. In float64 no activation comes that close to a kink.

On the CPU the port's token chain and decoder layer take their plain versions (their gradients are held to the Pallas
kernels in tests/test_torch_token_grad.py and tests/test_torch_xattn_grad.py);
JAX's train path runs its CPU lowering (XLA).

Bounds, each with its reason:
  (a) parameter gradients: per leaf, 1e-4 of the leaf's largest |g| (the
      fp32 islands and the frameworks' summation orders); leaves whose
      gradient is zero in exact arithmetic (a conv bias right before a
      train-mode BatchNorm, the token logits' bias under the softmax) are
      held to 1e-7 of the model's largest gradient instead;
  (b) BN running statistics after one train forward: 1e-5 relative
      (flax semantics: biased variance, momentum 0.9);
  (c) clip + AdamW and clip + SGD on fixed gradients for 3 steps: 1e-6
      relative against the optax chain of `make_optimizer`;
  (d) LR schedules: 1e-10 absolute (Python floats against JAX's fp32);
  (e) one whole train step: the loss to rtol 1e-5; the parameters to
      2 lr (Adam's first update is about lr sign(g), so an element whose
      gradient is near 0 may flip), and 99.9% of the elements to lr / 100;
  (f) a checkpoint restored into a fresh state takes the same next step:
      exactly equal on the CPU;
  (g) (tests/test_torch_smow_net.py) the port runs a CPU train step in a
      process that never imports JAX."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from smow_net_tpu.models import get_model as get_jax_model
from smow_net_tpu.train import schedule as jschedule
from smow_net_tpu.train import trainer as jtrainer
from smow_net_tpu.train.loss import bce_dice_loss as jax_loss
from smow_net_tpu_torch.models import get_model
from smow_net_tpu_torch.nn.layers import BatchNorm3d
from smow_net_tpu_torch.train import schedule as tschedule
from smow_net_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from smow_net_tpu_torch.train.convert import state_dict_from_jax
from smow_net_tpu_torch.train.loss import bce_dice_loss
from smow_net_tpu_torch.train.trainer import (Optimizer, create_train_state, make_optimizer,
                                              make_train_step, select_pred)
from test_torch_smow_net import _seeded

SIZE, BATCH = 64, 2
LR = 1e-4


def _schedule(jax_side: bool):
    mod = jschedule if jax_side else tschedule
    return mod.get_schedule("cosine", LR, epochs=2, iters_per_epoch=4)


@contextlib.contextmanager
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _f64(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64), tree)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    model = get_jax_model("smow_net")
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x, train=False))
    variables = {"params": _seeded(variables["params"], rng),
                 "batch_stats": _seeded(variables["batch_stats"], rng)}
    batch = {"A": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "B": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "mask": (rng.random((BATCH, SIZE, SIZE)) > 0.7).astype(np.float32),
             "valid": np.ones(BATCH, np.float32)}
    return model, variables, batch


def _port_model(variables, dtype=torch.float64):
    port = get_model("smow_net", device="cpu")
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    return port.to(dtype)


@pytest.fixture(scope="module")
def grads(setup):
    """(a) and (b): loss, gradients and updated BN statistics of one train
    forward/backward on each side."""
    model, variables, batch = setup
    with _x64():
        jb = {k: jnp.asarray(v) for k, v in _f64(batch).items()}
        stats = _f64(variables["batch_stats"])

        def loss_fn(params):
            out, mut = model.apply({"params": params, "batch_stats": stats},
                                   jb["A"], jb["B"], train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(0)})
            return jax_loss(jtrainer.select_pred(out), jb["mask"], jb["valid"]), mut

        (loss_j, mut), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            _f64(variables["params"]))
        g_j, stats_j, loss_j = _f64(g_j), _f64(mut["batch_stats"]), float(loss_j)
    want = state_dict_from_jax({"params": g_j, "batch_stats": stats_j})

    port = _port_model(variables)
    port.train()
    t = lambda k: torch.from_numpy(batch[k]).double()
    pred = select_pred(port(t("A").permute(0, 3, 1, 2), t("B").permute(0, 3, 1, 2)))
    loss = bce_dice_loss(pred, t("mask"), t("valid"))
    loss.backward()
    return dict(loss=(float(loss.detach()), loss_j), port=port, want=want)


def test_parameter_gradients_match_jax(grads):
    port, want = grads["port"], grads["want"]
    np.testing.assert_allclose(*grads["loss"], rtol=1e-5)
    exact_zero = 0
    largest = max(np.abs(want[name].numpy()).max() for name, _ in port.named_parameters())
    for name, p in port.named_parameters():
        assert p.grad is not None, name
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        if np.abs(w).max() < 1e-9 * largest:
            exact_zero += 1
            assert err <= 1e-7 * largest, f"{name}: {err:.2e}"
        else:
            err /= np.abs(w).max()
            assert err <= 1e-4, f"{name}: {err:.2e} of the leaf's largest gradient"
    assert exact_zero < 40


def test_bn_running_statistics_match_flax(grads):
    """flax moves running_var toward the BIASED batch variance."""
    port, want = grads["port"], grads["want"]
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 50
    sd = port.state_dict()
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_optimizer_matches_optax_chain(kind):
    rng = np.random.default_rng(1)
    shapes = [(5, 7), (7,), (3, 2, 4)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    steps = [[rng.normal(size=s).astype(np.float32) * 0.4 for s in shapes] for _ in range(3)]
    sched_j, sched_t = _schedule(True), _schedule(False)

    tx = jtrainer.make_optimizer(sched_j, optimizer=kind)
    pj = [jnp.asarray(p) for p in params]
    opt_state = tx.init(pj)
    pt = [torch.from_numpy(p.copy()).requires_grad_() for p in params]
    opt = make_optimizer(sched_t, optimizer=kind)(pt)
    assert isinstance(opt, Optimizer)
    for g in steps:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, pj)
        pj = optax.apply_updates(pj, updates)
        for p, x in zip(pt, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    assert opt.count == 3
    for got, want in zip(pt, pj):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("name,kw", [
    ("cosine", {}),
    ("step", {"lr_decay_epochs": [3, 6]}),
    ("step", {}),
    ("cosine", {"warmup_epochs": 2}),
    ("step", {"warmup_epochs": 1, "lr_decay_epochs": [4]}),
], ids=["cosine", "step_epochs", "step_default", "cosine_warmup", "step_warmup"])
def test_schedules_match_jax(name, kw):
    args = (name, 1e-4, 50, 7)
    fj, ft = jschedule.get_schedule(*args, **kw), tschedule.get_schedule(*args, **kw)
    for step in range(0, 50 * 7 + 10, 3):
        assert abs(ft(step) - float(fj(jnp.asarray(step)))) <= 1e-10, step


def test_train_step_matches_jax(setup):
    """(e): one whole step of each side's make_train_step."""
    model, variables, batch = setup
    with _x64():
        params = _f64(variables["params"])
        tx = jtrainer.make_optimizer(_schedule(True))
        state = jtrainer.TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=_f64(variables["batch_stats"]), opt_state=tx.init(params),
            cm=jnp.zeros((2, 2), jnp.float32), loss_sum=jnp.zeros((), jnp.float32),
            loss_count=jnp.zeros((), jnp.float32), rng=jax.random.PRNGKey(0), tx=tx)
        state, loss_j = jtrainer.make_train_step(model, donate=False)(
            state, {k: jnp.asarray(v) for k, v in _f64(batch).items()})
        want = state_dict_from_jax({"params": _f64(state.params),
                                    "batch_stats": _f64(state.batch_stats)})
        loss_j, cm_j = float(loss_j), np.asarray(state.cm)

    port = _port_model(variables)
    opt = make_optimizer(_schedule(False))(port.parameters())
    tstate = create_train_state(port, opt)
    loss = make_train_step(port, opt)(tstate, {k: v.astype(np.float64) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), loss_j, rtol=1e-5)
    assert tstate.step == 1 and opt.count == 1
    np.testing.assert_allclose(tstate.cm.numpy(), cm_j, atol=2)
    diffs = []
    for name, t in port.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        d = np.abs(t.numpy() - want[name].numpy())
        assert d.max() <= 2 * LR, f"{name}: {d.max():.2e}"
        diffs.append(d.ravel())
    diffs = np.concatenate(diffs)
    assert np.mean(diffs <= LR / 100) >= 0.999, np.mean(diffs <= LR / 100)


class _Tiny(torch.nn.Module):
    """A conv, a BatchNorm and a 1-channel head over the stacked pair: every
    kind of state a resume must restore (parameters, BN buffers, AdamW
    moments, the update count), at a fraction of SMOW_Net's cost."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv3d(3, 4, 3, padding=1)
        self.bn = BatchNorm3d(4)
        self.head = torch.nn.Conv3d(4, 1, 1)

    def forward(self, x1, x2):
        y = self.head(torch.relu(self.bn(self.conv(torch.stack([x1, x2], dim=2)))))
        return torch.sigmoid(y.mean(dim=2))


def test_checkpoint_resume_equals_uninterrupted(setup, tmp_path):
    """(f): step, save, step again; restore the save into a fresh state and
    step: the same parameters, BN statistics, optimizer state and metrics."""
    batch = setup[2]
    init = _Tiny().state_dict()

    def fresh():
        model = _Tiny()
        model.load_state_dict(init)
        opt = make_optimizer(_schedule(False))(model.parameters())
        return create_train_state(model, opt), make_train_step(model, opt)

    state, step = fresh()
    step(state, batch)
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(path, state, epoch=3)
    step(state, batch)

    resumed, step2 = fresh()
    assert restore_checkpoint(path, resumed) == {"epoch": 3}
    assert resumed.step == 1 and resumed.optimizer.count == 1
    step2(resumed, batch)
    assert resumed.step == state.step == 2
    for (name, a), b in zip(state.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    for name in ("cm", "loss_sum", "loss_count"):
        assert torch.equal(getattr(state, name), getattr(resumed, name)), name
    ia, ib = state.optimizer.inner.state_dict(), resumed.optimizer.inner.state_dict()
    assert len(ia["state"]) == len(list(state.model.parameters()))
    for k in ia["state"]:
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(ia["state"][k][key], ib["state"][k][key])
