"""Three of the port's repairs against the JAX package on CPU: BatchNorm at
one value per channel (smow_net_tpu_torch/nn/layers.py), `resize_linear`
with align_corners=True (ops/resize.py) and the reference's unfused OFW
token route, `OFW.forward` and `TokenTransformerEncoder.forward`
(models/smow_net.py).

Bounds, each with its reason:
  - BatchNorm: 1e-6 (one value per channel: the normalised value is 0 on
    both sides, the gradients of x and of the scale are 0, the bias's is
    the cotangent; the running statistics move by one fp32 lerp);
  - resize: 1e-5 of the largest element (torch's CPU interpolation takes
    its source coordinates in fp32: against a float64 reference it reads
    3.6e-6 of the largest element on a 32 -> 12 or 32 -> 8 resize, JAX's
    matrices, made in float64, 8e-8);
  - OFW and its tokens: 1e-4, as results from a flow field are held in
    tests/test_torch_warp.py (torch's and jnp's linspace differ by 1 ulp);
  - the port's fused token route against its own unfused one: 1e-5 (the
    same function up to fp32 rounding, warps on the other side)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.models.smow_net import OFW as JaxOFW
from smow_net_tpu.models.smow_net import TokenTransformerEncoder as JaxTokens
from smow_net_tpu.nn.layers import batch_norm
from smow_net_tpu.ops import resize as jresize
from smow_net_tpu_torch.models.smow_net import OFW, TokenTransformerEncoder, ofw_tokens_fused
from smow_net_tpu_torch.nn.layers import BatchNorm2d
from smow_net_tpu_torch.ops import resize
from smow_net_tpu_torch.train.convert import _Writer
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)
from test_torch_smow_net import _seeded


def test_batchnorm_at_one_value_per_channel_matches_flax():
    """BatchNorm2d(4) in train mode at (1, 4, 1, 1): F.batch_norm raises
    there; flax takes a variance of 0. Output, the three gradients and the
    running statistics."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 1, 1, 4)).astype(np.float32)          # NHWC for flax
    r = rng.normal(size=(1, 1, 1, 4)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=4)).astype(np.float32)
    bias = (0.1 * rng.normal(size=4)).astype(np.float32)
    mean0 = (0.1 * rng.normal(size=4)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, size=4).astype(np.float32)

    bn_j = batch_norm("bn")

    def f(xx, s, b):
        y, mut = bn_j.apply({"params": {"scale": s, "bias": b},
                             "batch_stats": {"mean": mean0, "var": var0}},
                            xx, use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * r), (y, mut["batch_stats"])

    (_, (y_j, stats_j)), g_j = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))

    bn = BatchNorm2d(4)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    bn.train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).clone().requires_grad_()
    y = bn(xt)
    dx, dw, db = torch.autograd.grad(y, (xt, bn.weight, bn.bias),
                                     torch.from_numpy(r).permute(0, 3, 1, 2))
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_j), **tol)
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(), np.asarray(g_j[0]), **tol)
    np.testing.assert_allclose(dw.numpy(), np.asarray(g_j[1]), **tol)
    np.testing.assert_allclose(db.numpy(), np.asarray(g_j[2]), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats_j["mean"]), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats_j["var"]), **tol)
    assert np.abs(np.asarray(g_j[2])).max() > 0.1, "the bias gradient vanished"


@pytest.mark.parametrize("align_corners", [True, False], ids=["align", "half_pixel"])
@pytest.mark.parametrize("src,dst", [(8, 32), (32, 12), (5, 5)])
def test_resize_linear_matches_jax(src, dst, align_corners):
    """Both flags of `resize_linear` against JAX's interpolation matrices
    (JAX's default is align_corners=True)."""
    x = np.random.default_rng(src * dst).normal(size=(2, src, src, 3)).astype(np.float32)
    want = np.asarray(jresize.resize_linear(jnp.asarray(x), (dst, dst), (1, 2),
                                            align_corners=align_corners))
    got = resize.resize_linear(torch.from_numpy(x).permute(0, 3, 1, 2), (dst, dst),
                               align_corners=align_corners)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


B, C, H, W = 2, 16, 16, 16


@pytest.fixture(scope="module")
def ofw_pair():
    """JAX's OFW(16) and TokenTransformerEncoder(16) with numpy-seeded
    leaves, applied alone (eval mode) to numpy-seeded (B, 2, H, W, C)
    features; the port's twins with the same weights."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 2, H, W, C)).astype(np.float32)
    ofw_j, tok_j = JaxOFW(inplane=C), JaxTokens(in_chan=C)
    v_ofw = jax.eval_shape(lambda: ofw_j.init(jax.random.PRNGKey(0), jnp.asarray(x), False))
    x4 = jnp.zeros((B, 4, H, W, C), jnp.float32)
    v_tok = jax.eval_shape(lambda: tok_j.init(jax.random.PRNGKey(0), x4))
    v_ofw = {k: _seeded(v, rng) for k, v in v_ofw.items()}
    v_tok = {"params": _seeded(v_tok["params"], rng)}
    frames = ofw_j.apply(v_ofw, jnp.asarray(x), False)
    tokens = tok_j.apply(v_tok, frames)

    w = _Writer({"params": {"OFW": v_ofw["params"], "Transformer_Encoder": v_tok["params"]},
                 "batch_stats": {"OFW": v_ofw["batch_stats"]}})
    w.ofw_tokens()
    ofw, tok = OFW(C).eval(), TokenTransformerEncoder(C)
    for name, mod in (("OFW.", ofw), ("Transformer_Encoder.", tok)):
        mod.load_state_dict({k[len(name):]: v for k, v in w.sd.items() if k.startswith(name)},
                            strict=True)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous()      # (B, C, 2, H, W)
    return dict(x=xt, ofw=ofw, tok=tok, frames=np.asarray(frames), tokens=np.asarray(tokens))


def test_ofw_forward_matches_jax(ofw_pair):
    """[F0, warp(F0), warp(F1), F1] of the reference's OFW."""
    with torch.no_grad():
        frames = ofw_pair["ofw"](ofw_pair["x"])
    assert frames.shape == (B, C, 4, H, W)
    want = ofw_pair["frames"].transpose(0, 4, 1, 2, 3)
    np.testing.assert_allclose(frames.numpy(), want, rtol=1e-4, atol=1e-4)
    # the warped frames move: the check would be vacuous on an identity warp
    assert np.abs(want[:, :, 1] - want[:, :, 0]).max() > 1e-2


def test_token_encoder_forward_matches_jax(ofw_pair):
    """The pooled tokens of TokenTransformerEncoder(OFW(x))."""
    with torch.no_grad():
        tokens = ofw_pair["tok"](ofw_pair["ofw"](ofw_pair["x"]))
    assert tokens.shape == (B, 8, 4 * C)
    np.testing.assert_allclose(tokens.numpy(), ofw_pair["tokens"], rtol=1e-4, atol=1e-4)


def test_fused_token_route_equals_the_unfused_one(ofw_pair):
    """The route SMOWNet runs (the logits warped, `ofw_tokens_fused`) is
    the reference's unfused one: TokenTransformerEncoder(OFW(x)), in torch."""
    ofw, tok, x = ofw_pair["ofw"], ofw_pair["tok"], ofw_pair["x"]
    with torch.no_grad():
        want = tok(ofw(x))
        got = ofw_tokens_fused(ofw, tok, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
