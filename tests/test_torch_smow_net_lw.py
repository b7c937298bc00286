"""The port's SMOWNetLW, its MobileNetV2 backbone and its eval step
(smow_net_tpu_torch) against the JAX package on CPU at 64x64, batch 2,
fp32, eval mode.

Every JAX leaf (params and batch_stats, `features_18` included) is replaced
by numpy-seeded values as in tests/test_torch_smow_net.py, the tree goes
through `state_dict_from_jax(..., model="smow_net_lw")` into the port, and
the same numpy-seeded batch runs through both eval steps. Bounds: the
probabilities to max abs 1e-4 and the loss to rtol 1e-5 (both sides in
fp32, other summation orders); the backbone's five taps alone to 1e-5 of
each tap's largest element; the state_dict round trip exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.models import get_model as get_jax_model
from smow_net_tpu.nn.mobilenetv2 import MobileNetV2 as JaxMobileNetV2
from smow_net_tpu.train.convert import load_smownet_lw_state_dict
from smow_net_tpu.train.trainer import make_eval_step as make_jax_eval_step
from smow_net_tpu_torch.models import get_model, list_models
from smow_net_tpu_torch.nn.mobilenetv2 import MobileNetV2
from smow_net_tpu_torch.train.convert import state_dict_from_jax
from smow_net_tpu_torch.train.trainer import make_eval_step
from test_torch_smow_net import _seeded

SIZE, BATCH = 64, 2


def seeded_variables(model, rng):
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    # only the tree's shapes are needed: every leaf is replaced below
    variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x, train=False))
    return {"params": _seeded(variables["params"], rng),
            "batch_stats": _seeded(variables["batch_stats"], rng)}


def seeded_batch(rng, valid):
    return {"A": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32),
            "B": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32),
            "mask": (rng.random((BATCH, SIZE, SIZE)) > 0.7).astype(np.float32),
            "valid": np.asarray(valid, np.float32)}


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    model = get_jax_model("smow_net_lw")
    variables = seeded_variables(model, rng)
    batch = seeded_batch(rng, [1.0, 0.0])
    jax_out = make_jax_eval_step(model)(variables["params"], variables["batch_stats"],
                                        {k: jnp.asarray(v) for k, v in batch.items()})
    jax_out = [np.asarray(v) for v in jax_out]

    sd = state_dict_from_jax(variables, model="smow_net_lw")
    port = get_model("smow_net_lw", device="cpu")
    port.load_state_dict(sd, strict=True)
    port_out = [v.numpy() for v in make_eval_step(port)(batch)]
    return dict(variables=variables, sd=sd, port=port, batch=batch, jax=jax_out,
                torch=port_out)


def test_registry_lists_smow_net_lw():
    assert "smow_net_lw" in list_models()


def test_state_dict_round_trips_through_the_jax_loader(runs):
    variables, sd = runs["variables"], runs["sd"]
    assert set(sd) == set(runs["port"].state_dict())
    assert "backbone.features.18.1.running_var" in sd
    back = load_smownet_lw_state_dict({k: v.numpy() for k, v in sd.items()}, variables)
    for part in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[part])
        got = dict(jax.tree_util.tree_leaves_with_path(back[part]))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))


def test_smownet_lw_matches_jax(runs):
    pred_j, pred_t = runs["jax"][2], runs["torch"][2]
    assert pred_t.shape == pred_j.shape == (BATCH, SIZE, SIZE)
    assert 0.05 < pred_j.std(), "probabilities saturated: the check would be vacuous"
    np.testing.assert_allclose(pred_t, pred_j, rtol=0, atol=1e-4)


def test_eval_step_matches_jax(runs):
    (cm_j, loss_j, pred_j), (cm_t, loss_t, _) = runs["jax"], runs["torch"]
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    # a probability within the parity bound of the 0.5 threshold may flip
    near = int(np.sum(np.abs(pred_j[0] - 0.5) < 1e-4))
    assert np.abs(cm_t - cm_j).sum() <= 2 * near
    assert cm_t.sum() == SIZE * SIZE            # valid = [1, 0]


def test_mobilenet_taps_match_jax(runs):
    """The backbone alone, eval mode: the five taps (16@/2 .. 320@/32)."""
    v = runs["variables"]
    bb = {"params": v["params"]["backbone"], "batch_stats": v["batch_stats"]["backbone"]}
    x = runs["batch"]["A"]
    taps_j = JaxMobileNetV2().apply(bb, jnp.asarray(x), False)
    port = MobileNetV2()
    port.load_state_dict({k[len("backbone."):]: t for k, t in runs["sd"].items()
                          if k.startswith("backbone.")}, strict=True)
    with torch.inference_mode():
        taps_t = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    widths = [(16, 2), (24, 4), (32, 8), (96, 16), (320, 32)]
    assert len(taps_t) == len(taps_j) == len(widths)
    for (c, s), tj, tt in zip(widths, taps_j, taps_t):
        tj = np.asarray(tj)
        assert tj.shape == (BATCH, SIZE // s, SIZE // s, c)
        np.testing.assert_allclose(tt.permute(0, 2, 3, 1).numpy(), tj, rtol=0,
                                   atol=1e-5 * np.abs(tj).max())
