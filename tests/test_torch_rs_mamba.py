"""The port's RS-Mamba (smow_net_tpu_torch/models/rs_mamba.py) against the
JAX package on CPU.

The whole model is a tiny configuration (depths (1, 1, 1, 1), dims (16,
32, 48, 64), K = 8 as the recipe) at 32x32, the smallest input its five
stride-2 steps take, batch 2. Every JAX leaf is numpy-seeded (the SS2D
leaves A_logs, Ds and dt_projs_bias perturbed around the reference's
initialisation, BN statistics away from identity), carried into the port
by `state_dict_from_jax(..., model="rs_mamba")`. Both sides run in float64
(JAX with x64 switched on for the call, the port `.double()`).

Both models' selective scans compute in fp32 inside, and their last bits
differ (exp2 against exp, other sums); the decoder's ReLUs after its
train-mode BatchNorms then move whole gradients. So the whole-model
comparison swaps one float64 scan into both models (a sequential
recurrence over the direction-major contract, `_scan64_jax` and
`_scan64_torch`), and compares the model code around it: the 8-direction
cross-scan, the SS2D and VSS blocks, the 2B encoder pass, the fuse and
decoder blocks, the flax-semantics BatchNorm and the resizes. The real
scans at K = 8 are held in tests/test_torch_ss2d_family.py.

JAX's side is ONE jitted computation: the eval-mode probabilities, and the
train-mode loss, gradients and mutated BN statistics. DropPath's masks are
injected on both sides from one numpy table keyed by the module's torch
name and call index, one (2B,) mask per call (the encoder runs once over
the stacked pair).

Bounds: probabilities 1e-6; the loss 1e-7 relative (both SS2Ds take A =
-exp(A_logs) in fp32, and the two frameworks' fp32 exps differ by an ulp
here and there: 2.1e-9 here); each parameter
gradient 1e-6 of the leaf's largest element (leaves whose gradient is zero
in exact arithmetic to 1e-9 of the model's largest gradient); BN running
statistics 1e-6 relative; the state_dict round trip through
convert_generic exact."""

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.models.zoo.rs_mamba import RSMCD as JaxRSMCD
from smow_net_tpu.nn import ssm as jssm
from smow_net_tpu.train.convert_zoo import convert_generic
from smow_net_tpu.train.loss import bce_dice_loss as jax_loss
from smow_net_tpu.train.trainer import select_pred as jax_select_pred
from smow_net_tpu.train.zoo_specs import ZOO_CONVERT_SPECS
from smow_net_tpu_torch.models import get_model, list_models
from smow_net_tpu_torch.models.rs_mamba import RSMCD
from smow_net_tpu_torch.ops import scan
from smow_net_tpu_torch.train import ingest
from smow_net_tpu_torch.train.convert import _RS_MAMBA_RENAMES, state_dict_from_jax
from smow_net_tpu_torch.train.loss import bce_dice_loss
from smow_net_tpu_torch.train.trainer import select_pred
from test_torch_cd_mamba import _swapped
from test_torch_change_mamba import _inject_masks, _jax_interceptor, _Masks, _seeded
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)
from test_torch_ss2d_family import run_compiled
from test_torch_train_step import _f64, _x64

SIZE, BATCH = 32, 2
TINY = dict(depths=(1, 1, 1, 1), dims=(16, 32, 48, 64))


def _scan64_jax(xs, dts, A, Bs, Cs, Ds=None, dt_bias=None, delta_softplus=True):
    """The direction-major scan in the inputs' dtype (float64 here), a
    sequential recurrence (lax.scan)."""
    B, K, L, Dk = xs.shape
    N = Bs.shape[-1]
    dt = jax.nn.softplus(dts + dt_bias.reshape(K, 1, Dk))
    a = jnp.exp(dt[..., None] * A.reshape(K, 1, Dk, N))
    x = (dt * xs)[..., None] * Bs[:, :, :, None, :]

    def step(h, ax):
        h = ax[0] * h + ax[1]
        return h, h

    _, h = jax.lax.scan(step, jnp.zeros_like(x[:, :, 0]), (jnp.moveaxis(a, 2, 0),
                                                           jnp.moveaxis(x, 2, 0)))
    y = jnp.einsum("lbkdn,bkln->bkld", h, Cs)
    return y + xs * Ds.reshape(K, 1, Dk)


def _scan64_torch(xs, dts, A, Bs, Cs, Ds=None, dt_bias=None, delta_softplus=True):
    """`_scan64_jax` in torch."""
    B, K, L, Dk = xs.shape
    N = Bs.shape[-1]
    v = dts + dt_bias.reshape(K, 1, Dk)
    dt = torch.log1p(torch.exp(-v.abs())) + v.clamp_min(0)
    a = torch.exp(dt[..., None] * A.reshape(K, 1, Dk, N).to(dt.dtype)).unbind(2)
    x = ((dt * xs)[..., None] * Bs[:, :, :, None, :]).unbind(2)
    h, hs = torch.zeros_like(x[0]), []
    for l in range(L):
        h = torch.addcmul(x[l], a[l], h)
        hs.append(h)
    return torch.einsum("bkldn,bkln->bkld", torch.stack(hs, 2), Cs) + xs * Ds.reshape(K, 1, Dk)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    model = JaxRSMCD(**TINY)
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
    """The file's one JAX whole-model computation (jitted, float64, the
    float64 scan swapped in): eval probabilities; train-mode loss,
    gradients and mutated batch_stats."""
    model, variables, batch = setup
    masks = _Masks(5)
    with _x64(), fnn.intercept_methods(_jax_interceptor(masks, _RS_MAMBA_RENAMES)), \
            _swapped(jssm, "cross_selective_scan", _scan64_jax):
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

        probs, loss, grads, new_stats = run_compiled(run, _f64(variables["params"]))
    assert masks.table, "no DropPath mask was drawn"
    return dict(probs=np.asarray(probs), loss=float(loss), masks=masks,
                grads=state_dict_from_jax({"params": _f64(grads), "batch_stats": _f64(new_stats)},
                                          model="rs_mamba"))


@pytest.fixture(scope="module")
def port_side(setup, jax_side):
    _, variables, batch = setup
    port = RSMCD(**TINY)
    port.load_state_dict(state_dict_from_jax(variables, model="rs_mamba"), strict=True)
    port = port.double()
    t = lambda k: torch.from_numpy(batch[k]).double()
    a, b = t("A").permute(0, 3, 1, 2), t("B").permute(0, 3, 1, 2)
    with _swapped(scan, "cross_selective_scan", _scan64_torch):
        with torch.no_grad():
            probs = select_pred(port.eval()(a, b))
        _inject_masks(port, jax_side["masks"])
        loss = bce_dice_loss(select_pred(port.train()(a, b)), t("mask"))
        loss.backward()
    return dict(port=port, probs=probs.numpy(), loss=float(loss.detach()))


def test_eval_probabilities_match_jax(jax_side, port_side):
    want = jax_side["probs"]
    assert port_side["probs"].shape == want.shape == (BATCH, SIZE, SIZE)
    assert want.std() > 0.01, "probabilities nearly constant: the check would be vacuous"
    np.testing.assert_allclose(port_side["probs"], want, rtol=0, atol=1e-6)


def test_train_gradients_match_jax(jax_side, port_side):
    port, want = port_side["port"], jax_side["grads"]
    np.testing.assert_allclose(port_side["loss"], jax_side["loss"], rtol=1e-7)
    # one (2B,) mask per DropPath call on both sides (a port mask of another
    # size would not broadcast): the encoder runs once over the pair
    assert {len(m) for m in jax_side["masks"].table.values()} == {2 * BATCH}
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
            assert err <= 1e-6 * np.abs(w).max(), f"{name}: {err / np.abs(w).max():.2e}"
    # zero in exact arithmetic: the x4 head's conv biases (a train-mode BN
    # follows); A_logs of the scan over L = 1 (the stride-32 map)
    assert 2 <= exact_zero < 8


def test_bn_running_statistics_match_flax(jax_side, port_side):
    want, sd = jax_side["grads"], port_side["port"].state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 18      # 4 fuse, 3 decoder and 2 head BNs, mean and var
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def test_state_dict_round_trips_through_convert_generic(setup):
    """The port's keys are the reference's: JAX's generic torch-checkpoint
    converter consumes every one of them (`deocder_block` included) and
    rebuilds the JAX variables; `ingest` loads them into the port."""
    _, variables, _ = setup
    sd = state_dict_from_jax(variables, model="rs_mamba")
    assert set(sd) == set(RSMCD(**TINY).state_dict())
    assert any(k.startswith("deocder_block3.fuse.0.") for k in sd)
    back, report = convert_generic({k: v.numpy() for k, v in sd.items()}, variables,
                                   **ZOO_CONVERT_SPECS["rs_mamba"])
    report.check()
    for part in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[part])
        got = dict(jax.tree_util.tree_leaves_with_path(back[part]))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))
    model = ingest.ingest_torch_checkpoint("rs_mamba", {"module." + k: v for k, v in sd.items()},
                                           RSMCD(**TINY))
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())


def test_registry():
    """get_model("rs_mamba") itself runs on the CPU (51,949,050 parameters,
    jax.eval_shape's count of the JAX model) in tests/test_torch_smow_net.py's
    no-JAX subprocess; the recipe is read here on the meta device: K = 8 in
    every one of the 15 blocks, drop path rising to 0.2, remat with
    use_checkpoint."""
    assert "rs_mamba" in list_models() and "rs_mamba" in ingest.supported_models()
    with torch.device("meta"):
        model, remat = RSMCD(), RSMCD(**TINY, use_checkpoint=True)
    assert sum(p.numel() for p in model.parameters()) == 51_949_050
    blocks = [m for n, m in model.named_modules()
              if re.fullmatch(r"encoder_block\d\.blocks\.\d+", n)]
    assert len(blocks) == 15 and all(b.op.K == 8 for b in blocks)
    assert blocks[-1].drop_path.rate == pytest.approx(0.2)
    assert not any(b.remat for b in blocks)
    assert all(m.remat for m in remat.modules() if hasattr(m, "remat"))
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        get_model("seifnet", device="cpu")
