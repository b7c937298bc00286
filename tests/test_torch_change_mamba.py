"""The port's ChangeMamba (smow_net_tpu_torch/models/change_mamba.py) and its
VMamba layers (nn/ssm.py) against the JAX package on CPU.

The whole model is the tiny configuration of tests/test_train_smoke.py
(depths (1, 1, 1, 1), dims (16, 32, 48, 64)) at 32x32, the smallest input
its five stride-2 steps take, batch 2. Every JAX leaf is numpy-seeded (the
SS2D leaves A_logs, Ds and dt_projs_bias perturbed around the reference's
initialisation, BN statistics away from identity), carried into the port by
`state_dict_from_jax(..., model="change_mamba")`. Both sides run in float64
(JAX with x64 switched on for the call, the port `.double()`), the selective
scan in fp32 inside on both, as tests/test_torch_train_step.py does: in
fp32 a ReLU kink flips between frameworks and moves whole gradients.

JAX's side is ONE jitted computation: the eval-mode probabilities, and the
train-mode loss, gradients and mutated BN statistics (one compile, ~40 s
and ~140 CPU-seconds; eager dispatch of the same function took 393 s). DropPath's masks are injected on both sides from one numpy
table keyed by the module's torch name and call index: an interceptor
replaces JAX's DropPath draw, and each port DropPath's `draw`.

Bounds: probabilities 1e-4; each parameter gradient 1e-4 of the leaf's
largest element (leaves whose gradient is zero in exact arithmetic to
1e-9 of the model's largest gradient); BN
running statistics 1e-5 relative; SS2D and VSSBlock outputs in fp32 1e-5 of
the largest element; the state_dict round trip through convert_generic
exact."""

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.models.zoo.change_mamba import ChangeMamba as JaxChangeMamba
from smow_net_tpu.nn import ssm as jssm
from smow_net_tpu.train.convert_zoo import convert_generic
from smow_net_tpu.train.loss import bce_dice_loss as jax_loss
from smow_net_tpu.train.trainer import select_pred as jax_select_pred
from smow_net_tpu.train.zoo_specs import ZOO_CONVERT_SPECS
from smow_net_tpu_torch.models import get_model, list_models
from smow_net_tpu_torch.models.change_mamba import ChangeMamba
from smow_net_tpu_torch.nn.ssm import SS2D, DropPath, VSSBlock
from smow_net_tpu_torch.train.convert import _CHANGE_MAMBA_RENAMES, state_dict_from_jax
from smow_net_tpu_torch.train.loss import bce_dice_loss
from smow_net_tpu_torch.train.schedule import get_schedule
from smow_net_tpu_torch.train.trainer import (create_train_state, make_optimizer,
                                              make_train_step, select_pred)
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)
from test_torch_train_step import _f64, _x64

SIZE, BATCH = 32, 2
TINY = dict(depths=(1, 1, 1, 1), dims=(16, 32, 48, 64))


def _seeded(tree, rng, path=()):
    """Numpy-seeded values for every leaf, scaled by what the leaf is."""
    if hasattr(tree, "items"):
        return {k: _seeded(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tuple(tree.shape), path[-1]
    n = rng.normal(size=shape)
    if name == "kernel":
        v = n / np.sqrt(shape[-2] * np.prod(shape[:-2]))
    elif name == "x_proj_weight":
        v = n / np.sqrt(shape[-1])
    elif name == "dt_projs_weight":
        v = n / np.sqrt(shape[-1])
    elif name == "dt_projs_bias":       # softplus(-4) ~ 0.018, the reference's dt range
        v = -4.0 + 0.5 * n
    elif name == "A_logs":
        v = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * n
    elif name in ("scale", "Ds"):
        v = 1.0 + 0.1 * n
    elif name == "var":
        v = rng.uniform(0.5, 1.5, size=shape)
    else:                               # biases, BN means
        v = 0.1 * n
    return v.astype(np.float32)


def _torch_name(path, renames=_CHANGE_MAMBA_RENAMES) -> str:
    """A flax module path -> the port's module name (the converter's rule)."""
    name = ".".join(path)
    for pat, rep in renames:
        name = re.sub(pat, rep, name)
    return name


class _Masks:
    """DropPath keep masks by (torch module name, call index), drawn once
    from a numpy generator, so both frameworks apply the same ones."""

    def __init__(self, seed):
        self.rng, self.table = np.random.default_rng(seed), {}

    def get(self, name, call, batch):
        key = (name, call)
        if key not in self.table:      # at least one sample keeps the branch
            keep = self.rng.random(batch) < 0.5
            keep[self.rng.integers(batch)] = True
            self.table[key] = keep
        return self.table[key]


def _jax_interceptor(masks: _Masks, renames=_CHANGE_MAMBA_RENAMES):
    calls = {}

    def intercept(next_fun, args, kwargs, context):
        m = context.module
        if not isinstance(m, jssm.DropPath) or context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x, train = args
        if m.rate == 0.0 or not train:
            return x
        name = _torch_name(m.path, renames)
        calls[name] = calls.get(name, -1) + 1
        mask = masks.get(name, calls[name], x.shape[0]).reshape((-1,) + (1,) * (x.ndim - 1))
        return x * jnp.asarray(mask) / (1.0 - m.rate)

    return intercept


def _inject_masks(port, masks: _Masks):
    for name, m in port.named_modules():
        if isinstance(m, DropPath):
            calls = iter(range(10))
            m.draw = lambda x, name=name, calls=calls: torch.from_numpy(
                masks.get(name, next(calls), x.shape[0])).reshape((-1,) + (1,) * (x.dim() - 1))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    model = JaxChangeMamba(**TINY)
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    # only the tree's shapes are needed: every leaf is replaced below
    variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x, train=False))
    variables = {"params": _seeded(variables["params"], rng),
                 "batch_stats": _seeded(variables["batch_stats"], rng)}
    batch = {"A": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "B": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "mask": (rng.random((BATCH, SIZE, SIZE)) > 0.7).astype(np.float32)}
    return model, variables, batch


@pytest.fixture(scope="module")
def jax_side(setup):
    """The file's one JAX whole-model computation (jitted, float64): eval
    probabilities; train-mode loss, gradients and mutated batch_stats."""
    model, variables, batch = setup
    masks = _Masks(5)
    with _x64(), fnn.intercept_methods(_jax_interceptor(masks)):
        a, b, gt = (jnp.asarray(batch[k], jnp.float64) for k in ("A", "B", "mask"))
        stats = _f64(variables["batch_stats"])

        def run(params):
            probs = jax_select_pred(model.apply({"params": params, "batch_stats": stats}, a, b,
                                                train=False))

            def loss_fn(p):
                out, mut = model.apply({"params": p, "batch_stats": stats}, a, b, train=True,
                                       mutable=["batch_stats"])
                return jax_loss(jax_select_pred(out), gt), mut

            (loss, mut), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            return probs, loss, grads, mut["batch_stats"]

        probs, loss, grads, new_stats = jax.jit(run)(_f64(variables["params"]))
    assert masks.table, "no DropPath mask was drawn"
    return dict(probs=np.asarray(probs), loss=float(loss), masks=masks,
                grads=state_dict_from_jax({"params": _f64(grads), "batch_stats": _f64(new_stats)},
                                          model="change_mamba"))


@pytest.fixture(scope="module")
def port_side(setup, jax_side):
    _, variables, batch = setup
    port = ChangeMamba(**TINY)
    port.load_state_dict(state_dict_from_jax(variables, model="change_mamba"), strict=True)
    port = port.double()
    t = lambda k: torch.from_numpy(batch[k]).double()
    a, b = t("A").permute(0, 3, 1, 2), t("B").permute(0, 3, 1, 2)
    with torch.no_grad():
        probs = select_pred(port.eval()(a, b))
    _inject_masks(port, jax_side["masks"])
    loss = bce_dice_loss(select_pred(port.train()(a, b)), t("mask"))
    loss.backward()
    return dict(port=port, probs=probs.numpy(), loss=float(loss.detach()))


def test_eval_probabilities_match_jax(jax_side, port_side):
    want = jax_side["probs"]
    assert port_side["probs"].shape == want.shape == (BATCH, SIZE, SIZE)
    assert want.std() > 0.05, "probabilities saturated: the check would be vacuous"
    np.testing.assert_allclose(port_side["probs"], want, rtol=0, atol=1e-4)


def test_train_gradients_match_jax(jax_side, port_side):
    port, want = port_side["port"], jax_side["grads"]
    np.testing.assert_allclose(port_side["loss"], jax_side["loss"], rtol=1e-6)
    largest = max(np.abs(want[name].numpy()).max() for name, _ in port.named_parameters())
    exact_zero = 0
    for name, p in port.named_parameters():
        w = want[name].numpy()
        assert p.grad is not None, name
        err = np.abs(p.grad.numpy() - w).max()
        if np.abs(w).max() < 1e-9 * largest:
            exact_zero += 1
            assert err <= 1e-9 * largest, f"{name}: {err:.2e}"
        else:
            assert err <= 1e-4 * np.abs(w).max(), f"{name}: {err / np.abs(w).max():.2e}"
    # zero in exact arithmetic: the fuse layers' conv biases (a train-mode BN
    # follows); an MLP's fc2 bias where the BN follows and both samples kept
    # the branch; A_logs of a scan over L = 1 (the stride-32 maps)
    assert 4 <= exact_zero < 16


def test_bn_running_statistics_match_flax(jax_side, port_side):
    want, sd = jax_side["grads"], port_side["port"].state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 20      # 4 fuse BNs and 3 ResBlocks' two BNs, mean and var
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-8,
                                   err_msg=k)


def test_state_dict_round_trips_through_convert_generic(setup):
    """The port's keys are the reference's: JAX's generic torch-checkpoint
    converter consumes every one of them and rebuilds the JAX variables."""
    _, variables, _ = setup
    sd = state_dict_from_jax(variables, model="change_mamba")
    assert set(sd) == set(ChangeMamba(**TINY).state_dict())
    back, report = convert_generic({k: v.numpy() for k, v in sd.items()}, variables,
                                   **ZOO_CONVERT_SPECS["change_mamba"])
    report.check()
    for part in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[part])
        got = dict(jax.tree_util.tree_leaves_with_path(back[part]))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))


@pytest.mark.parametrize("which", ["SS2D", "VSSBlock"])
def test_layer_matches_jax(which):
    """One layer at width 8 on a 4x5 map, fp32, eval mode."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 4, 5, 8)).astype(np.float32)
    jmod = jssm.SS2D(8) if which == "SS2D" else jssm.VSSBlock(8, drop_path=0.2)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = _seeded(shapes["params"], rng)
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, jnp.asarray(x)))
    port = SS2D(8) if which == "SS2D" else VSSBlock(8, drop_path=0.2)
    port.load_state_dict(state_dict_from_jax({"params": params, "batch_stats": {}},
                                             model="change_mamba"), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_drop_path_injected_mask_and_eval_identity():
    dp = DropPath(0.25)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(4, 3, 2, 5)))
    assert dp.eval()(x) is x
    mask = torch.tensor([True, False, True, True]).reshape(4, 1, 1, 1)
    dp.train().draw = lambda t: mask
    torch.testing.assert_close(dp(x), x * mask / 0.75, rtol=0, atol=0)
    with pytest.raises(RuntimeError, match="generator"):
        DropPath(0.25).train()(x)
    # the masks come from the attached generator: its seed decides them
    draws = []
    for seed in (1, 1, 2):
        dp = DropPath(0.5).train()
        dp.generator = torch.Generator().manual_seed(seed)
        draws.append(torch.cat([dp.draw(torch.zeros(64, 1)) for _ in range(2)]))
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert 0.3 < draws[0].float().mean() < 0.7


def test_train_step_repeats_from_the_state_generator():
    """Two runs of a train step from one seed give the same loss and
    weights: DropPath draws its masks from the train state's generator."""
    def run(seed):
        torch.manual_seed(0)
        model = ChangeMamba(**TINY)
        opt = make_optimizer(get_schedule("cosine", 1e-3, 1, 2))(model.parameters())
        state = create_train_state(model, opt, seed=seed)
        step = make_train_step(model, opt)
        rng = np.random.default_rng(6)
        batch = {"A": rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32),
                 "B": rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32),
                 "mask": (rng.random((2, SIZE, SIZE)) > 0.7).astype(np.float32)}
        draws_before = state.generator.get_state()
        loss = float(step(state, batch))
        assert not torch.equal(state.generator.get_state(), draws_before)
        return loss, model.main_clf.weight.detach().clone()

    (l1, w1), (l2, w2) = run(1), run(1)
    assert l1 == l2 and torch.equal(w1, w2) and np.isfinite(l1)


def test_registry():
    """get_model("change_mamba") itself runs in tests/test_torch_smow_net.py's
    no-JAX subprocess; the full width is counted here on the meta device."""
    assert "change_mamba" in list_models()
    with torch.device("meta"):
        assert sum(p.numel() for p in ChangeMamba().parameters()) == 48_561_794
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model("seifnet", device="cpu")
