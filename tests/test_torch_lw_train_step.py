"""The port's SMOW_Net_LW train step (smow_net_tpu_torch/train) against the
JAX package on CPU at 64x64, batch 2.

Leaves and batch are numpy-seeded as in tests/test_torch_smow_net_lw.py.
The comparisons run in float64 on both sides (JAX with x64 switched on for
the call, the port's model `.double()`), for the reason
tests/test_torch_train_step.py gives: in fp32 an activation next to a kink
(LeakyReLU here, and ReLU6's two kinks at 0 and 6 in the backbone) takes the
other branch on one side and moves whole weight gradients by ~1e-3. The
fixed fp32 islands of both sides (the warp coordinates and the decoder's
LayerNorm) stay fp32.

On the CPU the port's token chain takes the plain versions of the unfused
chain's ops (A, B, C, A-bwd) and the decoder layer its plain version under
autograd; JAX's train path on CPU runs the same unfused chain in XLA.

JAX's side is ONE jitted value_and_grad of its train-mode forward (loss,
gradients, mutated BN statistics, predictions). Compiling LW's x64 step
costs ~80 CPU-seconds, and the tier-1 suite runs close to its time limit
(1134-1461 s of 1470 measured with this file), so instead of compiling
`make_train_step` as well, (c) completes JAX's step from these gradients
with `make_train_step`'s own sequence: `make_optimizer`'s tx.update, then optax.apply_updates (equal to
`make_train_step` to 2.1e-6 on the parameters, inside (c)'s bound;
tests/test_torch_train_step.py calls `make_train_step` itself).

Bounds, each with its reason:
  (a) parameter gradients: per leaf, 1e-4 of the leaf's largest |g| (the
      fp32 islands and the frameworks' summation orders); leaves whose
      gradient is zero in exact arithmetic (a conv bias right before a
      train-mode BatchNorm, the token logits' bias under the softmax) are
      held to 1e-7 of the model's largest gradient instead. The backbone's
      `features.18` feeds no tap: its JAX gradient is exactly zero and the
      port's autograd leaves it unset;
  (b) BN running statistics after one train forward, `features.18`
      included: 1e-5 relative (flax semantics, two backbone passes);
  (c) one whole clip + AdamW train step: the loss to rtol 1e-5; the
      parameters to 2 lr (Adam's first update is about lr sign(g), so an
      element whose gradient is near 0 may flip) and 99.9% of the elements
      to lr / 100, as for SMOW_Net; the unused `features.18` decays by
      exactly lr * wd, as optax decays every leaf."""

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
from smow_net_tpu.train.metrics import confusion_matrix as jax_confusion_matrix
from smow_net_tpu_torch.models import get_model
from smow_net_tpu_torch.train import schedule as tschedule
from smow_net_tpu_torch.train.convert import j2t_conv, state_dict_from_jax
from smow_net_tpu_torch.train.loss import bce_dice_loss
from smow_net_tpu_torch.train.trainer import (create_train_state, make_optimizer,
                                              make_train_step, select_pred)
from test_torch_smow_net_lw import seeded_batch, seeded_variables
from test_torch_train_step import _f64, _x64
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

LR = 1e-4
UNUSED = "backbone.features.18."


def _schedule(jax_side: bool):
    mod = jschedule if jax_side else tschedule
    return mod.get_schedule("cosine", LR, epochs=2, iters_per_epoch=4)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(1)
    model = get_jax_model("smow_net_lw")
    return model, seeded_variables(model, rng), seeded_batch(rng, [1.0, 1.0])


@pytest.fixture(scope="module")
def jax_side(setup):
    """JAX's loss, gradients (float64 tree), mutated batch_stats and
    confusion matrix of one train forward/backward: the file's one compile."""
    model, variables, batch = setup
    with _x64():
        jb = {k: jnp.asarray(v) for k, v in _f64(batch).items()}
        stats = _f64(variables["batch_stats"])

        def loss_fn(params):
            out, mut = model.apply({"params": params, "batch_stats": stats},
                                   jb["A"], jb["B"], train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(0)})
            pred = jtrainer.select_pred(out)
            return jax_loss(pred, jb["mask"], jb["valid"]), (mut, pred)

        (loss, (mut, pred)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            _f64(variables["params"]))
        cm = jax_confusion_matrix(pred.astype(jnp.float32), jb["mask"], valid=jb["valid"])
        return dict(loss=float(loss), grads=_f64(grads), stats=_f64(mut["batch_stats"]),
                    cm=np.asarray(cm))


def _port_model(variables):
    port = get_model("smow_net_lw", device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, model="smow_net_lw"), strict=True)
    return port.double()


@pytest.fixture(scope="module")
def grads(setup, jax_side):
    """(a) and (b): the port's loss, gradients and updated BN statistics of
    one train forward/backward, beside JAX's."""
    _, variables, batch = setup
    want = state_dict_from_jax({"params": jax_side["grads"], "batch_stats": jax_side["stats"]},
                               model="smow_net_lw")
    port = _port_model(variables)
    port.train()
    t = lambda k: torch.from_numpy(batch[k]).double()
    pred = select_pred(port(t("A").permute(0, 3, 1, 2), t("B").permute(0, 3, 1, 2)))
    loss = bce_dice_loss(pred, t("mask"), t("valid"))
    loss.backward()
    return dict(loss=(float(loss.detach()), jax_side["loss"]), port=port, want=want)


def test_parameter_gradients_match_jax(grads):
    port, want = grads["port"], grads["want"]
    np.testing.assert_allclose(*grads["loss"], rtol=1e-5)
    exact_zero, unused = 0, 0
    largest = max(np.abs(want[name].numpy()).max() for name, _ in port.named_parameters())
    for name, p in port.named_parameters():
        w = want[name].numpy()
        if name.startswith(UNUSED):
            assert p.grad is None and not w.any(), name
            unused += 1
            continue
        assert p.grad is not None, name
        err = np.abs(p.grad.numpy() - w).max()
        if np.abs(w).max() < 1e-9 * largest:
            exact_zero += 1
            assert err <= 1e-7 * largest, f"{name}: {err:.2e}"
        else:
            err /= np.abs(w).max()
            assert err <= 1e-4, f"{name}: {err:.2e} of the leaf's largest gradient"
    assert unused == 3 and exact_zero < 20


def test_bn_running_statistics_match_flax(grads):
    """flax moves running_var toward the BIASED batch variance; the backbone
    runs once per image, so its statistics take two updates."""
    port, want = grads["port"], grads["want"]
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) > 100 and UNUSED + "1.running_var" in keys
    sd = port.state_dict()
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_train_step_matches_jax(setup, jax_side):
    """(c): one whole step of the port's make_train_step against JAX's
    make_train_step sequence on JAX's gradients (module docstring)."""
    _, variables, batch = setup
    with _x64():
        params = _f64(variables["params"])
        tx = jtrainer.make_optimizer(_schedule(True))

        @jax.jit      # one small elementwise program, not thousands of eager ops
        def update(g, p):
            return optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])

        stepped = _f64(update(jax_side["grads"], params))
    want = state_dict_from_jax({"params": stepped, "batch_stats": jax_side["stats"]},
                               model="smow_net_lw")

    port = _port_model(variables)
    opt = make_optimizer(_schedule(False))(port.parameters())
    tstate = create_train_state(port, opt)
    loss = make_train_step(port, opt)(tstate, {k: v.astype(np.float64) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), jax_side["loss"], rtol=1e-5)
    assert tstate.step == 1 and opt.count == 1
    np.testing.assert_allclose(tstate.cm.numpy(), jax_side["cm"], atol=2)
    diffs = []
    for name, t in port.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        d = np.abs(t.numpy() - want[name].numpy())
        assert d.max() <= 2 * LR, f"{name}: {d.max():.2e}"
        diffs.append(d.ravel())
    diffs = np.concatenate(diffs)
    assert np.mean(diffs <= LR / 100) >= 0.999, np.mean(diffs <= LR / 100)
    # the unused backbone head decays by lr * wd = 1e-8 (compared in float64:
    # fp32 would round the step away)
    kernel = lambda tree: j2t_conv(tree["backbone"]["features_18"]["conv"]["kernel"])
    head = port.state_dict()[UNUSED + "0.weight"].numpy()
    head0 = kernel(_f64(variables["params"]))
    np.testing.assert_allclose(head, kernel(stepped), rtol=1e-12)
    np.testing.assert_allclose(head0 - head, head0 * LR * 1e-4, rtol=1e-6)
