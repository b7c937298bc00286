"""The port's SMOWNet and eval step (smow_net_tpu_torch) against the JAX
package on CPU at 64x64, batch 2, fp32, eval mode.

Every JAX leaf (params and batch_stats) is replaced by numpy-seeded values
(mixers and BN statistics included, so every branch carries signal), the
tree goes through `state_dict_from_jax` into the port, and the same
numpy-seeded batch runs through both eval steps. Bound: max abs 1e-4 on the
probabilities; the loss to rtol 1e-5."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.models import get_model as get_jax_model
from smow_net_tpu.train.convert import load_smownet_state_dict
from smow_net_tpu.train.trainer import make_eval_step as make_jax_eval_step
from smow_net_tpu_torch.models import get_model
from smow_net_tpu_torch.train.convert import state_dict_from_jax
from smow_net_tpu_torch.train.trainer import make_eval_step
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

SIZE, BATCH = 64, 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _seeded(tree, rng, path=()):
    """Numpy-seeded values for every leaf, scaled by what the leaf is."""
    if hasattr(tree, "items"):
        return {k: _seeded(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tuple(tree.shape), path[-1]
    n = rng.normal(size=shape)
    if name in ("kernel", "time_5_kernel", "time_mix_kernel"):
        fan_in = shape[-2] * (np.prod(shape[:-2]) if name == "kernel" else 1)
        v = n / np.sqrt(fan_in)
    elif name == "scale":
        v = 1.0 + 0.1 * n
    elif name == "var":
        v = rng.uniform(0.5, 1.5, size=shape)
    elif name == "pos_embedding":
        v = n
    else:                                       # biases, BN means
        v = 0.1 * n
    return v.astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(0)
    model = get_jax_model("smow_net")
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    # only the tree's shapes are needed: every leaf is replaced below
    variables = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x, train=False))
    variables = {"params": _seeded(variables["params"], rng),
                 "batch_stats": _seeded(variables["batch_stats"], rng)}
    batch = {"A": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "B": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "mask": (rng.random((BATCH, SIZE, SIZE)) > 0.7).astype(np.float32),
             "valid": np.array([1.0, 0.0], np.float32)}
    jax_out = make_jax_eval_step(model)(variables["params"], variables["batch_stats"],
                                        {k: jnp.asarray(v) for k, v in batch.items()})
    jax_out = [np.asarray(v) for v in jax_out]

    sd = state_dict_from_jax(variables)
    port = get_model("smow_net", device="cpu")
    port.load_state_dict(sd, strict=True)
    port_out = [v.numpy() for v in make_eval_step(port)(batch)]
    return dict(variables=variables, sd=sd, port=port, jax=jax_out, torch=port_out)


def test_state_dict_round_trips_through_the_jax_loader(runs):
    variables, sd = runs["variables"], runs["sd"]
    assert set(sd) == set(runs["port"].state_dict())
    back = load_smownet_state_dict({k: v.numpy() for k, v in sd.items()}, variables)
    for part in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[part])
        got = dict(jax.tree_util.tree_leaves_with_path(back[part]))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))


def test_smownet_matches_jax(runs):
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


def test_port_imports_no_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from smow_net_tpu_torch.models import get_model\n"
        "m = get_model('smow_net', device='cpu').eval()\n"
        "x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))\n"
        "with torch.inference_mode():\n"
        "    y = m(x, x.flip(-1))\n"
        "assert y.shape == (1, 1, 64, 64) and bool(torch.isfinite(y).all())\n"
        "from smow_net_tpu_torch.train.schedule import get_schedule\n"
        "from smow_net_tpu_torch.train.trainer import (create_train_state, make_optimizer,\n"
        "                                              make_train_step)\n"
        "opt = make_optimizer(get_schedule('cosine', 1e-4, 2, 1))(m.parameters())\n"
        "state = create_train_state(m, opt)\n"
        "g = torch.Generator().manual_seed(1)\n"
        "batch = {'A': torch.randn(1, 64, 64, 3, generator=g),\n"
        "         'B': torch.randn(1, 64, 64, 3, generator=g),\n"
        "         'mask': (torch.rand(1, 64, 64, generator=g) > 0.8).float()}\n"
        "loss = make_train_step(m, opt)(state, batch)\n"
        "assert bool(torch.isfinite(loss)) and state.step == 1 and opt.count == 1\n"
        "lw = get_model('smow_net_lw', device='cpu').eval()\n"
        "with torch.inference_mode():\n"
        "    y = lw(x, x.flip(-1))\n"
        "assert y.shape == (1, 1, 64, 64) and bool(torch.isfinite(y).all())\n"
        "cm = get_model('change_mamba', device='cpu').eval()\n"
        "with torch.inference_mode():\n"
        "    y = cm(x[..., :32, :32], x[..., :32, :32].flip(-1))\n"
        "assert y.shape == (1, 2, 32, 32) and bool(torch.isfinite(y).all())\n"
        "cd = get_model('cd_mamba', device='cpu').eval()\n"
        "with torch.inference_mode():\n"
        "    y = cd(x[..., :32, :32], x[..., :32, :32].flip(-1))\n"
        "assert y.shape == (1, 2, 32, 32) and bool(torch.isfinite(y).all())\n"
        "rs = get_model('rs_mamba', device='cpu').eval()\n"
        "assert sum(p.numel() for p in rs.parameters()) == 51_949_050\n"
        "with torch.inference_mode():\n"
        "    y = rs(x[..., :32, :32], x[..., :32, :32].flip(-1))\n"
        "assert y.shape == (1, 2, 32, 32) and bool(torch.isfinite(y).all())\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'flax', 'smow_net_tpu')]\n"
        "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
