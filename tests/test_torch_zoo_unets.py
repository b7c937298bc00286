"""The port's conv U-Net zoo models, FC-EF, SNUNet, DTCDSCN and IFN, its
VGG-16 features (smow_net_tpu_torch/nn/vgg.py) and its pools
(ops/pooling.py) against the JAX package on CPU.

Each model runs at its recipe at the smallest input it takes (16x16: FC-EF,
SNUNet and IFN's four stride-2 levels; 32x32: DTCDSCN's stride-32 encoder),
batch 2, in float64, through the helpers of tests/test_torch_pa_former.py:
one jitted JAX computation per model (eval and train-mode probabilities,
loss, gradients, mutated BN statistics) against the port with the same
numpy-seeded weights carried over by `state_dict_from_jax`. FC-EF's
channel Dropout2d(0.2) and IFN's Dropout(0.6) draw their train-mode masks
from one numpy table, in call order, on both sides (`Dropouts`). Bounds as
there: probabilities 1e-6, the loss 1e-7 relative, each gradient 1e-6 of
its leaf's largest element (leaves zero in exact arithmetic to 1e-9 of the
largest gradient), BN statistics 1e-6 relative, the round trip through the
JAX package's converter exact (FC-EF's bespoke `convert_fc_ef`). The
gradients are held for FC-EF and SNUNet: DTCDSCN's and IFN's float64
backward would add ~20 s of JAX trace and compile to a file that must run
in 75 s alone (their train-mode forwards, BN statistics and losses are
held). IFN's
pretrained recipe (torchvision vgg16 into both bases) is held against the
JAX package's `load_pretrained_backbone`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.nn.vgg import VGG16Features as JaxVGG16Features
from smow_net_tpu.ops import pooling as jax_pooling
from smow_net_tpu.train import pretrained as jax_pretrained
from smow_net_tpu_torch.models import get_model, list_models
from smow_net_tpu_torch.nn.vgg import VGG16Features
from smow_net_tpu_torch.ops import pooling
from smow_net_tpu_torch.train import pretrained
from smow_net_tpu_torch.train.convert import state_dict_from_jax
from test_torch_pa_former import (Dropouts, assert_bn_stats, assert_grads, assert_outputs,
                                  assert_round_trip, jax_whole_model, port_whole_model,
                                  zoo_variables)
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)
from test_torch_smow_net import _seeded
from test_torch_train_step import _f64, _x64

SIZES = {"fc_ef": 16, "snunet": 16, "dtcdscn": 32, "ifn": 16}
# the train-mode dropouts a forward draws: FC-EF's after each of its 19 conv
# units, IFN's after each of its 14 conv blocks
DROPOUT = {"fc_ef": 19, "ifn": 14}
# BatchNorms per model
BNS = {"fc_ef": 19, "snunet": 30, "dtcdscn": 48, "ifn": 19}
# the gradients held, and each model's leaves whose gradient is zero in
# exact arithmetic: conv biases right before a train-mode BatchNorm (FC-EF's
# 19 conv + BN + ReLU units, SNUNet's second conv of each of its 15 nested
# blocks)
ZERO_LEAVES = {"fc_ef": 19, "snunet": 15}
# the reference's dead modules (zoo_specs' allow_unconsumed) in a checkpoint
DEAD = {"fc_ef": (), "snunet": (), "dtcdscn": ("decoder1.conv1.weight", "dblock.dilate1.bias"),
        "ifn": ("ca1.fc1.weight", "o2_conv4.0.weight")}


@pytest.fixture(scope="module")
def setups():
    return {name: zoo_variables(name, size) for name, size in SIZES.items()}


@pytest.fixture(scope="module")
def runs(setups):
    out = {}
    for name, (model, variables, batch) in setups.items():
        dropouts = Dropouts(7) if name in DROPOUT else None
        jax_side = jax_whole_model(name, model, variables, batch, dropouts,
                                   grads=name in ZERO_LEAVES)
        assert len(dropouts.masks if dropouts else ()) == DROPOUT.get(name, 0)
        out[name] = (jax_side, port_whole_model(name, variables, batch, dropouts))
    return out


@pytest.mark.parametrize("name", list(SIZES))
def test_outputs_and_bn_statistics_match_jax(runs, name):
    """Eval and train-mode probabilities and the loss; the BN running
    statistics after the train-mode forward."""
    assert_outputs(*runs[name], SIZES[name])
    assert_bn_stats(*runs[name], BNS[name])


@pytest.mark.parametrize("name", list(ZERO_LEAVES))
def test_train_gradients_match_jax(runs, name):
    assert assert_grads(*runs[name]) == ZERO_LEAVES[name]


@pytest.mark.parametrize("name", list(SIZES))
def test_state_dict_round_trips_through_the_jax_converter(setups, name):
    assert_round_trip(name, setups[name][1], DEAD[name])


def test_vgg16_features_match_jax():
    """Every tap of nn/vgg.py's VGG16Features (torchvision's `features.N`
    keys), float64, against JAX's eager forward at 16x16."""
    model, rng = JaxVGG16Features(), np.random.default_rng(9)
    x = rng.normal(size=(2, 16, 16, 3))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3))))
    params = _seeded(shapes["params"], rng)
    with _x64():
        want = model.apply({"params": _f64(params)}, jnp.asarray(x))
    sd = state_dict_from_jax({"params": {"t1_base": params}, "batch_stats": {}}, model="ifn")
    port = VGG16Features()
    port.load_state_dict({k[len("t1_base."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = port.double()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape[1:]) for g in got] == [(64, 16, 16), (128, 8, 8), (256, 4, 4),
                                                 (512, 2, 2), (512, 1, 1)]
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-9 * np.abs(w).max())


def test_pools_match_jax():
    """`avg_pool` with and without `count_include_pad`, `adaptive_avg_pool`
    (global and a dividing size) and `max_pool` against the JAX package's
    (channels-last there), float64 to 1e-12; a size that does not divide
    the map raises, as JAX's asserts."""
    x = np.random.default_rng(10).normal(size=(2, 12, 8, 5))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    cases = [(lambda v: pooling.avg_pool(v, 3, 2, 1), lambda v: jax_pooling.avg_pool(v, 3, 2, 1)),
             (lambda v: pooling.avg_pool(v, 3, 2, 1, count_include_pad=False),
              lambda v: jax_pooling.avg_pool(v, 3, 2, 1, count_include_pad=False)),
             (lambda v: pooling.avg_pool(v, (2, 4)), lambda v: jax_pooling.avg_pool(v, (2, 4))),
             (lambda v: pooling.adaptive_avg_pool(v, 1),
              lambda v: jax_pooling.adaptive_avg_pool(v, 1)),
             (lambda v: pooling.adaptive_avg_pool(v, (3, 2)),
              lambda v: jax_pooling.adaptive_avg_pool(v, (3, 2))),
             (lambda v: pooling.max_pool(v, 3, 2, 1), lambda v: jax_pooling.max_pool(v, 3, 2, 1))]
    with _x64():
        for port_fn, jax_fn in cases:
            want = np.asarray(jax_fn(jnp.asarray(x))).transpose(0, 3, 1, 2)
            got = port_fn(xt).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        pooling.adaptive_avg_pool(xt, (5, 3))


def _vgg16(rng):
    """torchvision vgg16's state_dict layout: 13 convs in `features`, then
    the classifier (which no recipe reads)."""
    sd, c, idx = {}, 3, 0
    for s, (width, n) in enumerate(((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))):
        idx += s > 0
        for _ in range(n):
            sd[f"features.{idx}.weight"] = rng.normal(size=(width, c, 3, 3))
            sd[f"features.{idx}.bias"] = rng.normal(size=width)
            c, idx = width, idx + 2
    sd["classifier.0.weight"], sd["classifier.0.bias"] = rng.normal(size=(8, 4)), rng.normal(size=8)
    return sd


def test_pretrained_vgg16_matches_jax(tmp_path, setups):
    """torchvision vgg16 into both of IFN's bases against the JAX package's
    recipe: every base conv moves, nothing else."""
    path = str(tmp_path / "vgg16.npz")
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in _vgg16(np.random.default_rng(11)).items()})
    variables = setups["ifn"][1]
    model = get_model("ifn", device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, model="ifn"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert pretrained.load_pretrained_backbone("ifn", path, model) is model
    got = model.state_dict()
    want = state_dict_from_jax(jax_pretrained.load_pretrained_backbone("ifn", path, variables),
                               model="ifn")
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    moved = {k for k in got if not torch.equal(got[k], before[k])}
    assert moved == {k for k in got if k.startswith(("t1_base.", "t2_base."))}


def test_registry():
    """get_model's recipes, counted on the meta device against the JAX
    models' parameters (jax.eval_shape's counts)."""
    counts = {"fc_ef": 1_350_578, "snunet": 12_034_978, "dtcdscn": 31_256_273,
              "ifn": 50_441_273}
    assert set(counts) <= set(list_models())
    for name, want in counts.items():
        with torch.device("meta"):
            model = get_model(name, device="meta")
        assert sum(p.numel() for p in model.parameters()) == want, name
