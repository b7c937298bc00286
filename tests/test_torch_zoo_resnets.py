"""The port's ResNet zoo models, AFCF3D and BIT, and its 2D ResNet
(smow_net_tpu_torch/nn/resnet.py) against the JAX package on CPU.

AFCF3D runs at its recipe at 32x32, the smallest input its stride-32
encoder takes, batch 2, in float64, through the helpers of
tests/test_torch_pa_former.py: one jitted JAX computation (eval and
train-mode probabilities, loss, gradients, mutated BN statistics) against
the port with the same numpy-seeded weights carried over by
`state_dict_from_jax`. BIT's whole-model float64 comparison runs in
tests/test_torch_pa_former.py beside PA-Former's (its JAX trace and
compile, ~17 s, would take this file past its 75 s); its state_dict, its
pretrained recipe and its recipe's size are held here. Bounds as there:
probabilities 1e-6, the loss 1e-7 relative, each gradient 1e-6 of its leaf's
largest element (leaves zero in exact arithmetic to 1e-9 of the largest
gradient), BN statistics 1e-6 relative, the round trip through
convert_generic exact. The pretrained recipes (`load_resnet18_2d` into BIT,
resnet18 inflated into AFCF3D's ResNet3D) are held against the JAX
package's `load_pretrained_backbone` on a numpy-seeded state_dict in
torchvision's resnet18 layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.nn import resnet as jax_resnet
from smow_net_tpu.ops import resize as jax_resize
from smow_net_tpu.train import pretrained as jax_pretrained
from smow_net_tpu_torch.models import afcf3d as afcf3d_module
from smow_net_tpu_torch.models import get_model, list_models
from smow_net_tpu_torch.models.afcf3d import AFCF3D
from smow_net_tpu_torch.models.bit import BIT
from smow_net_tpu_torch.nn import resnet
from smow_net_tpu_torch.train import pretrained
from smow_net_tpu_torch.train.convert import state_dict_from_jax
from test_torch_cd_mamba import _swapped
from test_torch_io import _resnet18
from test_torch_pa_former import (assert_bn_stats, assert_grads, assert_outputs,
                                  assert_round_trip, jax_whole_model, port_whole_model,
                                  zoo_variables)
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)
from test_torch_smow_net import _seeded
from test_torch_train_step import _f64, _x64

SIZE = 32
# the reference's dead modules (zoo_specs' allow_unconsumed) in a checkpoint
DEAD = {"bit": ("resnet.layer4.0.conv1.weight", "resnet.fc.weight"),
        "afcf3d": ("decoder.output.superD1.weight", "decoder.AFCF_fuse.AFCF1.conv_down.x")}


@pytest.fixture(scope="module")
def setups():
    return {name: zoo_variables(name, SIZE) for name in ("bit", "afcf3d")}


def _resize_jax_weights(x, size, align_corners=False):
    """`ops.resize.resize_linear` as the JAX package computes it: products
    with its per-axis interpolation matrices, whose weights it rounds to
    fp32 (smow_net_tpu/ops/resize.py:44), in x's dtype."""
    mh, mw = (torch.from_numpy(jax_resize.interp_matrix(n, m, align_corners)).to(x.dtype)
              for n, m in zip(x.shape[-2:], size))
    return torch.einsum("oh,bchw,pw->bcop", mh, x, mw)


@pytest.fixture(scope="module")
def runs(setups):
    """AFCF3D's JAX side and port side. Its 15 bilinear resizes a forward
    feed BatchNorms (the shared up-sampling conv's among them): there the
    fp32 rounding of JAX's interpolation weights moves running means near
    zero by 1e-5 relative, so the port's side takes JAX's weights
    (`_resize_jax_weights`); `ops.resize` itself is held against JAX's in
    tests/test_torch_repairs.py."""
    model, variables, batch = setups["afcf3d"]
    jax_side = jax_whole_model("afcf3d", model, variables, batch)
    with _swapped(afcf3d_module, "resize_linear", _resize_jax_weights):
        return jax_side, port_whole_model("afcf3d", variables, batch)


def test_resnet34_features_match_jax():
    """Every tap of nn/resnet.py's ResNet-34 (its recipe: the last two stages
    lose their stride and, by the reference's clamp, do not dilate), eval
    mode, float64, against JAX's jitted forward. BIT's three-stage ResNet-18
    with the same clamp runs in BIT's whole-model cases
    (tests/test_torch_pa_former.py)."""
    model, rng = jax_resnet.resnet34_config(), np.random.default_rng(5)
    x = rng.normal(size=(2, SIZE, SIZE, 3))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                                               train=False))
    variables = {k: _seeded(shapes[k], rng) for k in ("params", "batch_stats")}
    with _x64():
        want = jax.jit(lambda v, a: model.apply(v, a, train=False))(_f64(variables),
                                                                     jnp.asarray(x))
    sd = state_dict_from_jax({k: {"resnet": v} for k, v in variables.items()}, model="bit")
    port = resnet.resnet34_config()
    port.load_state_dict({k[len("resnet."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = port.double().eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-9 * np.abs(w).max())


def test_afcf3d_eval_and_train_outputs_match_jax(runs):
    assert_outputs(*runs, SIZE)


def test_afcf3d_train_gradients_match_jax(runs):
    # zero in exact arithmetic: the biases of the 55 convs right before a
    # train-mode BatchNorm (the BasicConv3d units and the gates' first convs)
    assert assert_grads(*runs) == 55


def test_afcf3d_bn_running_statistics_match_flax(runs):
    # 76 BatchNorms, the shared ones moved once per call
    assert_bn_stats(*runs, 76)


@pytest.mark.parametrize("name", ["bit", "afcf3d"])
def test_state_dict_round_trips_through_convert_generic(setups, name):
    assert_round_trip(name, setups[name][1], DEAD[name])


@pytest.mark.parametrize("name", ["bit", "afcf3d"])
def test_pretrained_resnet18_matches_jax(tmp_path, setups, name):
    """A torchvision resnet18 state_dict into BIT's three-stage ResNet or
    AFCF3D's inflated ResNet3D, against the JAX package's recipe: every
    backbone weight, BN scale, bias and statistic it holds moves, nothing
    else (not AFCF3D's temporal mixers)."""
    sd = _resnet18(np.random.default_rng(6))
    path = str(tmp_path / "resnet18.pth")
    torch.save({k: torch.tensor(np.asarray(v, np.float32)) if np.ndim(v) else torch.tensor(v)
                for k, v in sd.items()}, path)
    variables = setups[name][1]
    model = get_model(name, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, model=name))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert pretrained.load_pretrained_backbone(name, path, model) is model
    got = model.state_dict()
    want = state_dict_from_jax(jax_pretrained.load_pretrained_backbone(name, path, variables),
                               model=name)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k].to(got[k].dtype)), k
    moved = {k for k in got if not torch.equal(got[k], before[k])}
    assert moved == {k for k in got if k.startswith("resnet.") and ".conv3d_time_" not in k
                     and not k.endswith("num_batches_tracked")}


def test_registry():
    """get_model's recipes, counted on the meta device against the JAX
    models' parameters (jax.eval_shape's counts): BIT 3,037,026 (token_len
    4, three ResNet stages, decoder depth 8, dim_head 8), AFCF3D 17,540,481
    (features 32)."""
    assert {"bit", "afcf3d"} <= set(list_models())
    with torch.device("meta"):
        bit, afcf3d = BIT(**{"output_nc": 2, "token_len": 4, "resnet_stages_num": 4,
                             "with_pos": "learned", "enc_depth": 1, "dec_depth": 8,
                             "decoder_dim_head": 8}), AFCF3D(features=32)
    assert sum(p.numel() for p in bit.parameters()) == 3_037_026
    assert sum(p.numel() for p in afcf3d.parameters()) == 17_540_481
    assert len(bit.transformer_decoder.layers) == 8 and not hasattr(bit.resnet, "layer4")
