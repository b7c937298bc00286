"""The zoo's first row's two token transformers, the port's PA-Former
(smow_net_tpu_torch/models/pa_former.py) and BIT (models/bit.py), and
PA-Former's warp at C = 64, against the JAX package on CPU.

The whole model runs at its recipe (f_c 64, the token decoder's (128, 8,
8, 256) layer) at 64x64, the smallest input its PriorInterpreter's three
unpadded stride-2 convs take, batch 2. Every JAX leaf is numpy-seeded,
carried into the port by `state_dict_from_jax(..., model="pa_former")`.
Both sides run in float64 (JAX with x64 switched on for the call, the port
`.double()`); JAX's side is ONE jitted computation (XLA's default
optimisation: at level 0 the float64 convolutions of the zoo's models run
slower than they compile): the eval-mode probabilities, and the train-mode probabilities,
loss, gradients and mutated BN statistics. On the CPU JAX takes its XLA
decoder layer (`cross_layer_head1`).

The warp (JAX's XLA `grid_sample`, the function kernel A-fwd computes)
takes its coordinates and weights in fp32 whatever the values' dtype, on
both sides, and JAX chains dgrid in fp32: the leaves upstream of the
PriorInterpreter's grid (flow_make, the depthwise convs) then differ by up
to 3e-6 of their largest element, fp32's rounding carried through the
pixel sums. So the whole-model comparison swaps one float64 bilinear warp
into both models (`_grid_sample64_jax`, `_grid_sample64_torch`, JAX's
arithmetic with the coordinates in float64) and compares the model code
around it; the port's warp itself is held below against JAX's. The
identity grid under the flow is an fp32 linspace on both sides, and
torch's and jnp's differ by an ulp here and there (up to 1.8e-7 at 16
points), which moves those leaves by up to 2e-6 of their largest element:
the port's side takes jnp's linspace values (`_offset_grid_jnp`), and
`warp.offset_grid` is held to JAX's grid within 2 fp32 ulps below.

Bounds: probabilities 1e-6; the loss 1e-7 relative (the decoder layer
normalises its memory tokens in fp32 whatever the dtype on both sides, JAX
nn/layers.py:366 and the port's `xattn.layer_norm32`: 1.5e-9 here); each parameter
gradient 1e-6 of the leaf's largest element (leaves whose gradient is zero
in exact arithmetic, the conv biases before train-mode BatchNorms and the
token logits' bias under the softmax, to 1e-9 of the model's largest
gradient); BN running statistics 1e-6 relative; the state_dict round trip
through convert_generic exact.

The warp cases hold the port's `bilinear_warp` (its autograd Function, on
the CPU the plain versions of A-fwd and A-bwd) at C = 64, zeros padding,
align_corners=False, against JAX's XLA `grid_sample` and `jax.vjp` of it:
the values, dx and dgrid, on a grid reaching past the image, in fp32 (1e-5
of the largest element; dgrid 1e-4) and on one with NaN coordinates (NaN at
the same elements).

BIT runs at its recipe (token_len 4, three ResNet stages, 8 decoder
layers of dim_head 8) at 32x32, the smallest input its stride-8 backbone
and x4 head take, batch 2, with no swap, under the same bounds; its
pretrained recipe (`load_resnet18_2d`) and its state_dict's round trip are
held in tests/test_torch_zoo_resnets.py beside AFCF3D's.

The helpers below (`zoo_variables`, `jax_whole_model`, `port_whole_model`,
`assert_*`) serve the zoo's other two files too."""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.models import get_model as get_jax_model
from smow_net_tpu.models.zoo import pa_former as jax_pa_former
from smow_net_tpu.ops import warp as jax_warp
from smow_net_tpu.train.convert_zoo import convert_generic
from smow_net_tpu.train.loss import bce_dice_loss as jax_loss
from smow_net_tpu.train.trainer import select_pred as jax_select_pred
from smow_net_tpu.train.zoo_specs import ZOO_CONVERT_SPECS
from smow_net_tpu_torch.models import get_model, list_models
from smow_net_tpu_torch.models.pa_former import PAFormer
from smow_net_tpu_torch.ops import warp
from smow_net_tpu_torch.train import ingest, pretrained
from smow_net_tpu_torch.train.convert import state_dict_from_jax
from smow_net_tpu_torch.train.loss import bce_dice_loss
from smow_net_tpu_torch.train.trainer import select_pred
from test_torch_cd_mamba import _swapped
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)
from test_torch_smow_net import _seeded
from test_torch_train_step import _f64, _x64

SIZE, BATCH = 64, 2
BIT_SIZE = 32


# ---------------------------------------------------------------- shared helpers

def _grid_sample64_jax(x, grid, padding_mode="border", align_corners=True):
    """smow_net_tpu/ops/warp.py `grid_sample` with the coordinates and
    weights in the grid's dtype (float64 here) instead of fp32."""
    B, H, W, C = x.shape
    _, Hg, Wg, _ = grid.shape

    def unnorm(g, size):
        return (g + 1.0) * 0.5 * (size - 1) if align_corners else ((g + 1.0) * size - 1.0) * 0.5

    ix, iy = unnorm(grid[..., 0], W), unnorm(grid[..., 1], H)
    if padding_mode == "border":
        ix, iy = jnp.clip(ix, 0.0, W - 1), jnp.clip(iy, 0.0, H - 1)
    ix0, iy0 = jnp.floor(ix), jnp.floor(iy)
    tx, ty = ix - ix0, iy - iy0
    x0, y0 = ix0.astype(jnp.int32), iy0.astype(jnp.int32)
    flat = x.reshape(B, H * W, C)
    out = 0.0
    for yi, xi, w in ((y0, x0, (1 - tx) * (1 - ty)), (y0, x0 + 1, tx * (1 - ty)),
                      (y0 + 1, x0, (1 - tx) * ty), (y0 + 1, x0 + 1, tx * ty)):
        if padding_mode == "zeros":
            w = w * ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))
        idx = (jnp.clip(yi, 0, H - 1) * W + jnp.clip(xi, 0, W - 1)).reshape(B, -1, 1)
        out = out + jnp.take_along_axis(flat, idx, axis=1).reshape(B, Hg, Wg, C) * w[..., None]
    return out


def _grid_sample64_torch(x, grid, padding_mode="border", align_corners=True):
    """`_grid_sample64_jax` in torch, under autograd."""
    B, H, W, C = x.shape
    _, Hg, Wg, _ = grid.shape

    def unnorm(g, size):
        return (g + 1.0) * 0.5 * (size - 1) if align_corners else ((g + 1.0) * size - 1.0) * 0.5

    ix, iy = unnorm(grid[..., 0], W), unnorm(grid[..., 1], H)
    if padding_mode == "border":
        ix, iy = ix.clamp(0.0, W - 1), iy.clamp(0.0, H - 1)
    ix0, iy0 = torch.floor(ix), torch.floor(iy)
    tx, ty = ix - ix0, iy - iy0
    x0, y0 = ix0.long(), iy0.long()
    flat = x.reshape(B, H * W, C)
    out = 0.0
    for yi, xi, w in ((y0, x0, (1 - tx) * (1 - ty)), (y0, x0 + 1, tx * (1 - ty)),
                      (y0 + 1, x0, (1 - tx) * ty), (y0 + 1, x0 + 1, tx * ty)):
        if padding_mode == "zeros":
            w = w * ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(B, -1, 1)
        out = out + torch.gather(flat, 1, idx.expand(-1, -1, C)).reshape(B, Hg, Wg, C) * w[..., None]
    return out


def _offset_grid_jnp(flow, H, W):
    """`warp.offset_grid` on the identity grid of jnp.linspace's fp32 values."""
    fy, fx = (torch.from_numpy(np.asarray(jnp.linspace(-1.0, 1.0, n, dtype=jnp.float32)))
              for n in (H, W))
    base = torch.stack(torch.meshgrid(fx, fy, indexing="xy"), dim=-1).to(flow.dtype)
    return base[None] + flow / torch.tensor([W, H], dtype=flow.dtype)


def zoo_variables(name, size, seed=0):
    """(JAX model of registry `name`, its numpy-seeded variables, a batch of
    BATCH pairs at size x size): the tree's shapes from `jax.eval_shape`
    (no init is compiled)."""
    rng = np.random.default_rng(seed)
    model = get_jax_model(name)
    x = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x, train=False))
    variables = {"params": _seeded(shapes["params"], rng),
                 "batch_stats": _seeded(shapes["batch_stats"], rng)}
    batch = {"A": rng.normal(size=(BATCH, size, size, 3)).astype(np.float32),
             "B": rng.normal(size=(BATCH, size, size, 3)).astype(np.float32),
             "mask": (rng.random((BATCH, size, size)) > 0.7).astype(np.float32)}
    return model, variables, batch


class Dropouts:
    """Dropout keep masks in call order, drawn once from numpy on the JAX
    side (flax's `nn.Dropout`, its `broadcast_dims` kept) and replayed on the
    port's `nn.Dropout` / `nn.Dropout2d` modules, which the models call in
    the same order."""

    def __init__(self, seed):
        self.rng, self.masks = np.random.default_rng(seed), []

    def interceptor(self):
        def intercept(next_fun, args, kwargs, context):
            m = context.module
            if not isinstance(m, fnn.Dropout) or context.method_name != "__call__":
                return next_fun(*args, **kwargs)
            x = args[0]
            if kwargs.get("deterministic", m.deterministic) or m.rate == 0.0:
                return x
            shape = list(x.shape)
            for d in m.broadcast_dims:
                shape[d] = 1
            keep = self.rng.random(shape) >= m.rate
            self.masks.append((keep, m.rate))
            return jnp.where(jnp.asarray(keep), x / (1.0 - m.rate), 0.0)

        return intercept

    def inject(self, port):
        masks = iter(self.masks)

        def forward(x):
            keep, rate = next(masks)
            mask = torch.from_numpy(keep.transpose(0, 3, 1, 2)).to(x.dtype)
            return x * mask / (1.0 - rate)

        for m in port.modules():
            if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
                m.forward = forward


def jax_whole_model(name, model, variables, batch, dropouts=None, grads=True):
    """The JAX side in float64, one compiled computation: eval and train-mode
    probabilities, the BCE-Dice loss, its gradients (unless `grads` is
    False) and the mutated BN statistics, the last two as the port's
    state_dict."""
    intercept = (fnn.intercept_methods(dropouts.interceptor()) if dropouts
                 else contextlib.nullcontext())
    with _x64(), intercept:
        a, b, gt = (jnp.asarray(batch[k], jnp.float64) for k in ("A", "B", "mask"))
        stats = _f64(variables["batch_stats"])

        def run(params):
            probs = jax_select_pred(model.apply({"params": params, "batch_stats": stats}, a, b,
                                                train=False))

            def loss_fn(p):
                out, mut = model.apply({"params": p, "batch_stats": stats}, a, b, train=True,
                                       mutable=["batch_stats"])
                pred = jax_select_pred(out)
                return jax_loss(pred, gt), (pred, mut)

            if not grads:
                loss, (pred, mut) = loss_fn(params)
                return probs, pred, loss, params, mut["batch_stats"]
            (loss, (pred, mut)), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
            return probs, pred, loss, g, mut["batch_stats"]

        probs, train_probs, loss, g, new_stats = jax.jit(run)(_f64(variables["params"]))
    return dict(probs=np.asarray(probs), train_probs=np.asarray(train_probs), loss=float(loss),
                grads=state_dict_from_jax({"params": _f64(g), "batch_stats": _f64(new_stats)},
                                          model=name))


def port_whole_model(name, variables, batch, dropouts=None):
    """The port's side in float64: eval probabilities, then one train-mode
    forward (the JAX side's dropout masks replayed) and its backward."""
    port = get_model(name, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, model=name), strict=True)
    port = port.double()
    t = lambda k: torch.from_numpy(batch[k]).double()          # noqa: E731
    a, b = t("A").permute(0, 3, 1, 2), t("B").permute(0, 3, 1, 2)
    with torch.no_grad():
        probs = select_pred(port.eval()(a, b))
    if dropouts:
        dropouts.inject(port)
    train_probs = select_pred(port.train()(a, b))
    loss = bce_dice_loss(train_probs, t("mask"))
    loss.backward()
    return dict(port=port, probs=probs.numpy(), train_probs=train_probs.detach().numpy(),
                loss=float(loss.detach()))


def assert_outputs(jax_side, port_side, size):
    """Eval and train-mode probabilities 1e-6, the loss 1e-7 relative."""
    want = jax_side["probs"]
    assert port_side["probs"].shape == want.shape == (BATCH, size, size)
    # 1000x the bound: AFCF3D's seeded sigmoid output spreads least (std 3.8e-3)
    assert want.std() > 1e-3, "probabilities nearly constant: the check would be vacuous"
    np.testing.assert_allclose(port_side["probs"], want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port_side["train_probs"], jax_side["train_probs"], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(port_side["loss"], jax_side["loss"], rtol=1e-7)


def assert_grads(jax_side, port_side):
    """Each gradient within 1e-6 of its leaf's largest element; leaves that
    are zero in exact arithmetic within 1e-9 of the model's largest
    gradient. Returns how many such leaves there were."""
    port, want = port_side["port"], jax_side["grads"]
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
    return exact_zero


def assert_bn_stats(jax_side, port_side, count):
    want, sd = jax_side["grads"], port_side["port"].state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * count
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=k)


def assert_round_trip(name, variables, dead=()):
    """The port's keys are the reference's: the JAX package's converter for
    `name` (zoo_specs) consumes every one of them and rebuilds the JAX
    variables bit for bit; `ingest` loads them into the port, the dead
    modules' keys `dead` dropped."""
    sd = state_dict_from_jax(variables, model=name)
    assert set(sd) == set(get_model(name, device="cpu").state_dict())
    npsd = {k: v.numpy() for k, v in sd.items()}
    spec = ZOO_CONVERT_SPECS[name]
    if callable(spec):
        back = spec(npsd, variables)
    else:
        kw = {k: v for k, v in spec.items() if k != "allow_unconsumed"}
        back, report = convert_generic(npsd, variables, **kw)
        report.check()
    for part in ("params", "batch_stats"):
        want = jax.tree_util.tree_leaves_with_path(variables[part])
        got = dict(jax.tree_util.tree_leaves_with_path(back[part]))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))
    ckpt = {"module." + k: v for k, v in sd.items()}
    ckpt.update({"module." + k: torch.zeros(1) for k in dead})
    model = ingest.ingest_torch_checkpoint(name, ckpt, get_model(name, device="cpu"))
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())


# ---------------------------------------------------------------- PA-Former

@pytest.fixture(scope="module")
def setup():
    return zoo_variables("pa_former", SIZE)


@pytest.fixture(scope="module")
def jax_side(setup):
    with _swapped(jax_pa_former, "grid_sample", _grid_sample64_jax):
        return jax_whole_model("pa_former", *setup)


@pytest.fixture(scope="module")
def port_side(setup, jax_side):
    _, variables, batch = setup
    with _swapped(warp, "bilinear_warp", _grid_sample64_torch), \
            _swapped(warp, "offset_grid", _offset_grid_jnp):
        return port_whole_model("pa_former", variables, batch)


@pytest.fixture(scope="module")
def bit_runs():
    model, variables, batch = zoo_variables("bit", BIT_SIZE)
    return (jax_whole_model("bit", model, variables, batch),
            port_whole_model("bit", variables, batch))


@pytest.fixture(scope="module")
def runs(jax_side, port_side, bit_runs):
    return {"pa_former": (jax_side, port_side, SIZE), "bit": (*bit_runs, BIT_SIZE)}


@pytest.mark.parametrize("name", ["pa_former", "bit"])
def test_eval_and_train_outputs_match_jax(runs, name):
    jax_out, port_out, size = runs[name]
    assert_outputs(jax_out, port_out, size)


# zero in exact arithmetic: PA-Former's three depthwise conv biases in the
# PriorInterpreter (a train-mode BatchNorm follows each) and its token
# encoder's logit bias (a softmax over the pixels follows); in BIT the last
# decoder layer's output bias (it adds to both images' maps alike, and the
# head takes |f1 - f2|)
@pytest.mark.parametrize("name,zero_leaves", [("pa_former", 4), ("bit", 1)])
def test_train_gradients_match_jax(runs, name, zero_leaves):
    assert assert_grads(*runs[name][:2]) == zero_leaves


# PA-Former's backbone's 22 BNs and its PriorInterpreter's 3, BIT's ResNet's
# 15 and its classifier's; each runs once per image
@pytest.mark.parametrize("name,count", [("pa_former", 25), ("bit", 16)])
def test_bn_running_statistics_match_flax(runs, name, count):
    assert_bn_stats(*runs[name][:2], count)


def test_state_dict_round_trips_through_convert_generic(setup):
    assert_round_trip("pa_former", setup[1])


def test_registry(tmp_path):
    """get_model("pa_former") with the JAX registry's recipe: the JAX
    model's 16,132,680 parameters (jax.eval_shape's count at 64^2), counted
    on the meta device; no pretrained-backbone recipe, as in the JAX
    package."""
    assert "pa_former" in list_models()
    with torch.device("meta"):
        model = PAFormer()
    assert sum(p.numel() for p in model.parameters()) == 16_132_680
    layer = model.token_decoder.transformer_decoder
    assert layer.dim == 128 and layer.layers[0][1].fn.fn.net[0].out_features == 256
    path = str(tmp_path / "x.npz")
    np.savez(path, w=np.zeros(1, np.float32))
    with pytest.raises(ValueError, match="no pretrained-backbone recipe"):
        pretrained.load_pretrained_backbone("pa_former", path, model)


# ---------------------------------------------------------------- the warp at C = 64

def _warp_case(nan: bool):
    rng = np.random.default_rng(64 + nan)
    x = rng.normal(size=(2, 12, 16, 64)).astype(np.float32)
    gy = rng.normal(size=(2, 10, 12, 64)).astype(np.float32)
    grid = rng.uniform(-1.25, 1.25, size=(2, 10, 12, 2)).astype(np.float32)
    if nan:
        grid[0, 1, 2, 0] = np.nan
        grid[1, 3, 4] = np.nan
    return x, gy, grid


def _nan_close(got, want, atol, rtol):
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    finite = ~nan
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=atol + rtol * np.abs(want[finite]).max())


@pytest.mark.parametrize("nan", [False, True], ids=["past_the_image", "nan_grid"])
def test_bilinear_warp_c64_matches_jax_grid_sample(nan):
    """Values, dx and dgrid of `bilinear_warp(x, grid, "zeros", False)` at C
    = 64 against jax.vjp of the XLA `grid_sample`: 1e-5 of the largest
    element (dgrid 1e-4), NaN at the same elements."""
    x, gy, grid = _warp_case(nan)

    @jax.jit
    def reference(a, g, ct):
        out, vjp = jax.vjp(lambda a, g: jax_warp.grid_sample(a, g, "zeros", False), a, g)
        return (out,) + vjp(ct)

    out, dx, dgrid = reference(jnp.asarray(x), jnp.asarray(grid), jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_()
    gt = torch.from_numpy(grid).requires_grad_()
    got = warp.bilinear_warp(xt, gt, "zeros", False)
    got.backward(torch.from_numpy(gy))
    assert bool(np.isnan(np.asarray(out)).any()) == nan
    _nan_close(got.detach().numpy(), np.asarray(out), 0.0, 1e-5)
    _nan_close(xt.grad.numpy(), np.asarray(dx), 0.0, 1e-5)
    _nan_close(gt.grad.numpy(), np.asarray(dgrid), 0.0, 1e-4)
    # the kernels' plain versions, which the wrapper routes a CPU tensor to
    np.testing.assert_array_equal(
        warp.grid_sample(xt.detach(), gt.detach(), "zeros", False).numpy(),
        got.detach().numpy())
    # PA-Former's grid (pa_former.py:64-71) from a float64 flow: within two
    # fp32 ulps of the identity grid's linspace
    flow = np.random.default_rng(3).normal(size=(2, 10, 12, 2)) * 3.0
    with _x64():
        base = jnp.stack(jnp.meshgrid(jnp.linspace(-1.0, 1.0, 12, dtype=jnp.float32),
                                      jnp.linspace(-1.0, 1.0, 10, dtype=jnp.float32),
                                      indexing="xy"), axis=-1)
        want = np.asarray(base[None] + jnp.asarray(flow) / jnp.asarray([12, 10], jnp.float32))
    got = warp.offset_grid(torch.from_numpy(flow), 10, 12)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * 2.0 ** -23)
