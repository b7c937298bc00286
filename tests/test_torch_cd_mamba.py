"""The port's CD-Mamba (smow_net_tpu_torch/models/cd_mamba.py) against the
JAX package on CPU.

The whole model is a small configuration (init_filters 8, blocks_down (1,
1, 1, 1), the recipe's blocks_up and stage) at 32x32, batch 2. Every JAX
leaf is numpy-seeded (A_log, D and dt_proj_bias perturbed around the
reference's initialisation), carried into the port by
`state_dict_from_jax(..., model="cd_mamba")`. Both sides run in float64
(JAX with x64 switched on for the call, the port `.double()`). JAX's side
is ONE jitted computation: the probabilities, the loss and the gradients of
a train-mode forward (CD-Mamba has no batch statistics and no dropout, so
its train-mode output is its eval-mode output).

Both models' selective scans compute in fp32 inside, and in fp32 their last
bits differ (exp2 against exp, other sums; and 9% of the fp32 exps that make
A = -exp(A_log) differ by an ulp between the frameworks): the gates' ReLUs
(ReLU(q) in GatedFusionMamba, after each GroupNorm) then sit on the other
side of their kinks here and there, and the worst gradient leaf differs by
2.6e-3 of its largest element. So the whole-model comparison swaps one
float64 scan into both models (a sequential recurrence, `_scan64_jax` and
`_scan64_torch` below: the same function as the plain scan, which
tests/test_torch_scan_flat.py holds against JAX's kernels), and compares
the model code around it. The eval probabilities are the port's own path,
its fp32 plain scan included, against JAX's.

Bounds: probabilities 1e-4; each parameter gradient 1e-4 of the leaf's
largest element (leaves whose gradient is zero in exact arithmetic, a
Linear's bias before a GroupNorm or before |a - b| of the siamese pair, to
1e-9 of the model's largest gradient); the loss 1e-6 relative; the blocks
(ConvMamba, GF in both modes, SRCMBlock in both conv modes; fp32, their
real scans, one more jitted computation) 1e-5 of the largest element; the
decode path token by token against JAX's and against the whole-sequence
core 1e-5; the state_dict round trip through convert_generic exact.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.models.zoo import cd_mamba as jcdm
from smow_net_tpu.train.convert_zoo import convert_generic
from smow_net_tpu.train.loss import bce_dice_loss as jax_loss
from smow_net_tpu.train.trainer import select_pred as jax_select_pred
from smow_net_tpu.train.zoo_specs import ZOO_CONVERT_SPECS
from smow_net_tpu_torch.models import cd_mamba, get_model, list_models
from smow_net_tpu_torch.ops import scan
from smow_net_tpu_torch.train.convert import state_dict_from_jax
from smow_net_tpu_torch.train.loss import bce_dice_loss
from smow_net_tpu_torch.train.trainer import select_pred
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)
from test_torch_train_step import _f64, _x64

SIZE, BATCH = 32, 2
TINY = dict(init_filters=8, blocks_down=(1, 1, 1, 1))


def _seeded(tree, rng, path=()):
    """Numpy-seeded values for every leaf, scaled by what the leaf is."""
    if hasattr(tree, "items"):
        return {k: _seeded(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name = tuple(tree.shape), path[-1]
    n = rng.normal(size=shape)
    if name == "kernel" or name.startswith("ag"):
        v = n / np.sqrt(np.prod(shape[:-1]))
        if path[-2:] == ("conv_final", "kernel"):     # logits with a spread
            v = 4.0 * v
    elif name in ("x_proj_kernel", "dt_proj_kernel"):
        v = n / np.sqrt(shape[0])
    elif name == "conv1d_kernel":
        v = n / np.sqrt(shape[0])
    elif name == "dt_proj_bias":        # softplus(-4) ~ 0.018, the reference's dt range
        v = -4.0 + 0.5 * n
    elif name == "A_log":
        v = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * n
    elif name in ("scale", "D", "skip_scale"):
        v = 1.0 + 0.1 * n
    else:                               # biases
        v = 0.1 * n
    return v.astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    model = jcdm.CDMamba(**TINY)
    x = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    # only the tree's shapes are needed: every leaf is replaced below
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, x, train=False))
    variables = {"params": _seeded(shapes["params"], rng)}
    batch = {"A": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "B": rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "mask": (rng.random((BATCH, SIZE, SIZE)) > 0.7).astype(np.float32)}
    return model, variables, batch


def _scan64_jax(u, delta, A, Bmat, Cmat, D=None, delta_bias=None, delta_softplus=True):
    """The flat contract's scan in the inputs' dtype (float64 here), a
    sequential recurrence (lax.scan)."""
    B, L, Dch = u.shape
    G, N = Bmat.shape[2:]
    dt = jax.nn.softplus(delta + delta_bias)
    a = jnp.exp(dt[..., None] * A)
    x = ((dt * u).reshape(B, L, G, -1)[..., None] * Bmat[:, :, :, None, :]).reshape(B, L, Dch, N)

    def step(h, ax):
        h = ax[0] * h + ax[1]
        return h, h

    _, h = jax.lax.scan(step, jnp.zeros_like(x[:, 0]), (jnp.moveaxis(a, 1, 0),
                                                        jnp.moveaxis(x, 1, 0)))
    y = jnp.einsum("lbgcn,blgn->blgc", h.reshape(L, B, G, -1, N), Cmat).reshape(B, L, Dch)
    return y + u * D


def _scan64_torch(u, delta, A, Bmat, Cmat, D=None, delta_bias=None, delta_softplus=True):
    """`_scan64_jax` in torch."""
    B, L, Dch = u.shape
    G, N = Bmat.shape[2:]
    dt = torch.log1p(torch.exp(-(delta + delta_bias).abs())) + (delta + delta_bias).clamp_min(0)
    a = torch.exp(dt[..., None] * A.to(dt.dtype)).unbind(1)
    x = ((dt * u).reshape(B, L, G, -1)[..., None] * Bmat[:, :, :, None, :]).reshape(
        B, L, Dch, N).unbind(1)
    h, hs = torch.zeros_like(x[0]), []
    for l in range(L):
        h = torch.addcmul(x[l], a[l], h)
        hs.append(h)
    h = torch.stack(hs, 1).reshape(B, L, G, -1, N)
    return torch.einsum("blgcn,blgn->blgc", h, Cmat).reshape(B, L, Dch) + u * D


@contextlib.contextmanager
def _swapped(module, name, fn):
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


@pytest.fixture(scope="module")
def jax_side(setup):
    """The file's one JAX whole-model computation (jitted, float64, the
    float64 scan swapped in): the probabilities, loss and gradients of a
    train-mode forward."""
    model, variables, batch = setup
    with _x64(), _swapped(jcdm, "selective_scan_auto", _scan64_jax):
        a, b, gt = (jnp.asarray(batch[k], jnp.float64) for k in ("A", "B", "mask"))

        def loss_fn(p):
            probs = jax_select_pred(model.apply({"params": p}, a, b, train=True))
            return jax_loss(probs, gt), probs

        (loss, probs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            _f64(variables["params"]))
    return dict(probs=np.asarray(probs), loss=float(loss),
                grads=state_dict_from_jax({"params": _f64(grads)}, model="cd_mamba"))


@pytest.fixture(scope="module")
def port_side(setup, jax_side):
    """The eval probabilities on the port's own path; the train-mode loss
    and gradients with the float64 scan swapped in."""
    _, variables, batch = setup
    port = cd_mamba.CDMamba(**TINY)
    port.load_state_dict(state_dict_from_jax(variables, model="cd_mamba"), strict=True)
    port = port.double()
    t = lambda k: torch.from_numpy(batch[k]).double()
    a, b = t("A").permute(0, 3, 1, 2), t("B").permute(0, 3, 1, 2)
    with torch.no_grad():
        probs = select_pred(port.eval()(a, b))
    with _swapped(scan, "selective_scan", _scan64_torch):
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
    assert {name for name, _ in port.named_parameters()} == set(want)
    largest = max(np.abs(w.numpy()).max() for w in want.values())
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
    # zero in exact arithmetic: the proj bias of an SRCM layer a GroupNorm
    # follows (enc0's first, each decoder block's two), and enc3's last,
    # which reaches the loss only through |a - b|
    assert exact_zero == 5


def test_state_dict_round_trips_through_convert_generic(setup):
    """The port's keys are the reference's: JAX's generic torch-checkpoint
    converter with the "cd_mamba" spec (its renames and `cdm_hook`) consumes
    every one of them and rebuilds the JAX variables."""
    _, variables, _ = setup
    sd = state_dict_from_jax(variables, model="cd_mamba")
    assert set(sd) == set(cd_mamba.CDMamba(**TINY).state_dict())
    assert {"l_gf1.fusionencoder.lcoal_relation.0.weight", "ag2.gate.weight",
            "g_gf2.fusionencoder.A_g_log", "srcm_encoder_layers.1.0.0.convmamba.conv1d_b.bias",
            "srcm_decoder_layers.0.0.conv1.convmamba.local_relation.2.pointwise_conv.weight",
            "up_samples.2.0.weight", "conv_final.2.bias"} <= set(sd)
    spec = dict(ZOO_CONVERT_SPECS["cd_mamba"])
    allow = spec.pop("allow_unconsumed")
    back, report = convert_generic({k: v.numpy() for k, v in sd.items()}, variables, **spec)
    report.check(allow)
    assert not report.unconsumed
    want = jax.tree_util.tree_leaves_with_path(variables["params"])
    got = dict(jax.tree_util.tree_leaves_with_path(back["params"]))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=str(path))


# the blocks, each embedded at a flax path whose renames give its torch prefix
_BLOCKS = {
    # name: (JAX module, flax path, torch prefix, channels)
    "ConvMamba": (jcdm.ConvMamba(8), ("enc0_block0", "conv1", "convmamba"),
                  "srcm_encoder_layers.0.1.conv1.convmamba.", 8),
    "GF-local": (jcdm.GF(8, "local"), ("l_gf1",), "l_gf1.", 8),
    "GF-global": (jcdm.GF(8, "global"), ("g_gf1",), "g_gf1.", 8),
    "SRCMBlock": (jcdm.SRCMBlock(16), ("enc0_block0",), "srcm_encoder_layers.0.1.", 16),
    "SRCMBlock-deepwise": (jcdm.SRCMBlock(16, conv_mode="deepwise"), ("dec0_block0",),
                           "srcm_decoder_layers.0.0.", 16),
}


def _port_block(name):
    return {"ConvMamba": lambda: cd_mamba.ConvMamba(8),
            "GF-local": lambda: cd_mamba.GF(8, "local"),
            "GF-global": lambda: cd_mamba.GF(8, "global"),
            "SRCMBlock": lambda: cd_mamba.SRCMBlock(16),
            "SRCMBlock-deepwise": lambda: cd_mamba.SRCMBlock(16, conv_mode="deepwise")}[name]()


@pytest.fixture(scope="module")
def jax_blocks():
    """Each block's numpy-seeded params, inputs (2, 4, 6, C) NHWC and JAX
    output, fp32, through one jitted computation."""
    rng = np.random.default_rng(3)
    cases = {}
    for name, (mod, _, _, C) in _BLOCKS.items():
        x = rng.normal(size=(2, 4, 6, C)).astype(np.float32)
        y = rng.normal(size=(2, 4, 6, C)).astype(np.float32)
        args = (x, y) if name.startswith("GF") else (x,)
        kw = {} if name == "ConvMamba" else {"train": False}
        shapes = jax.eval_shape(lambda m=mod, a=args, k=kw: m.init(jax.random.PRNGKey(0), *a,
                                                                   **k))
        cases[name] = (_seeded(shapes["params"], rng), args, kw)

    def run(params):
        return {n: _BLOCKS[n][0].apply({"params": params[n]}, *a, **kw)
                for n, (_, a, kw) in cases.items()}

    outs = jax.jit(run)({n: c[0] for n, c in cases.items()})
    return {n: (c[0], c[1], jax.tree_util.tree_map(np.asarray, outs[n]))
            for n, c in cases.items()}


@pytest.mark.parametrize("name", list(_BLOCKS))
def test_block_matches_jax(jax_blocks, name):
    params, args, want = jax_blocks[name]
    _, path, prefix, C = _BLOCKS[name]
    tree = params
    for key in reversed(path):
        tree = {key: tree}
    sd = {k[len(prefix):]: v for k, v in state_dict_from_jax({"params": tree}, "cd_mamba").items()}
    port = _port_block(name)
    port.load_state_dict(sd, strict=True)
    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2) for a in args]
    with torch.no_grad():
        if name == "ConvMamba":
            got = [port(nchw[0].flatten(2).transpose(1, 2), 4, 6).reshape(2, 4, 6, C)]
        else:
            got = port.eval()(*nchw)
            got = [t.permute(0, 2, 3, 1) for t in (got if isinstance(got, tuple) else [got])]
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_mamba_core_step_matches_jax_and_full_scan():
    """The decode path token by token (conv window + scan carry) against
    JAX's `mamba_core_step` and against the whole-sequence core."""
    B, L, Di, R = 2, 11, 8, 2
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, L, Di)).astype(np.float32)
    core = jcdm.Mamba1DCore(Di, 16, R)
    params = _seeded(jax.eval_shape(lambda: core.init(jax.random.PRNGKey(0), jnp.asarray(x)))[
        "params"], rng)
    pj = jcdm.Mamba1DParams(Di, 16, R).apply({"params": params})

    def decode(xs):
        def step(carry, t):
            cs, hs = carry
            y, cs, hs = jcdm.mamba_core_step(pj, xs[:, t], cs, hs)
            return (cs, hs), y

        _, ys = jax.lax.scan(step, jcdm.mamba_cache_init(B, Di), jnp.arange(L))
        return jnp.swapaxes(ys, 0, 1)

    want = np.asarray(jax.jit(decode)(jnp.asarray(x)))
    port = cd_mamba.Mamba1DCore(Di, 16, R)
    port.load_state_dict(state_dict_from_jax({"params": params}, "cd_mamba"), strict=True)
    p = cd_mamba.Mamba1DParams(port)
    conv_state, ssm_state = cd_mamba.mamba_cache_init(B, Di)
    xt = torch.from_numpy(x)
    ys = []
    with torch.no_grad():
        for t in range(L):
            y, conv_state, ssm_state = cd_mamba.mamba_core_step(p, xt[:, t], conv_state,
                                                                ssm_state)
            ys.append(y)
        full = port(xt).numpy()
    got = torch.stack(ys, 1).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(got - full).max() <= 1e-5 * np.abs(full).max()


def test_registry():
    """get_model("cd_mamba") builds on CUDA by default and raises without
    it (on the CPU it runs in tests/test_torch_smow_net.py's no-JAX
    subprocess). The full width is the JAX model's 10,341,325 parameters
    (the JAX package's count)."""
    assert "cd_mamba" in list_models()
    assert sum(p.numel() for p in cd_mamba.CDMamba().parameters()) == 10_341_325
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            get_model("cd_mamba")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model("seifnet", device="cpu")
