"""The port's dim_head=1 cross-attention sublayer on CPU: the plain version
of kernel G (`cross_attn_head1_plain`, smow_net_tpu_torch/ops/xattn.py) and
its gradient under torch autograd (the plain version of G-bwd) against JAX's
`cross_attn_head1_auto` routed to the Pallas kernel G
(`cross_attn_head1_pallas`: forward `_fwd_kernel`, backward `_bwd_kernel`)
in interpret mode.

Shapes: (B, N) = (2, 512), h = 8 heads, M = 8 tokens, D = 128 (SMOW_Net's
decoder) and 256; without a permutation, with a random one-hot permutation
(as tests/test_xattn.py) and with the decoder's t-major -> c-major fold.
Bounds in fp32, rtol and atol: the forward 2e-5 and all eight gradients
2e-4, those tests/test_xattn.py holds the same kernel to against JAX's XLA
path: the Pallas kernel folds the LayerNorm affine and the permutation into
the q projection and sums its parameter gradients over rows in another
order, which changes only the rounding. bf16: 2e-2 (`test_bf16_fwd_close`'s
bound): the Pallas kernel rounds its matmul operands to bf16 at other places
than the plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.ops import xattn as jx
from smow_net_tpu.ops.pallas import xattn as px
from smow_net_tpu_torch.ops import xattn as tx
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

B, N, H_, M_ = 2, 512, 8, 8
NAMES = ("x", "ln_scale", "ln_bias", "wq", "k", "v", "w_out", "b_out")
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def pallas_attn():
    """Route `cross_attn_head1_auto` to the Pallas kernel G in interpret
    mode, then restore the default routing."""
    jx.set_xattn_impl("pallas", interpret=True)
    yield
    jx.set_xattn_impl("auto")


def _inputs(seed, D):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, off=0.0: (rng.normal(size=s) * scale + off).astype(np.float32)
    args = [f(B, N, D), f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, H_, scale=0.1),
            f(B, M_, H_), f(B, M_, H_), f(H_, D, scale=0.1), f(D, scale=0.1)]
    return args, f(B, N, D)


def _perm(kind, D):
    """None, a random one-hot permutation, or the decoder's fold
    P[t*C + c, c*T + t] = 1 (T = 4 frames of C = D / 4 channels)."""
    if kind == "none":
        return None
    p = np.zeros((D, D), np.float32)
    if kind == "random":
        p[np.arange(D), np.random.default_rng(D).permutation(D)] = 1.0
    else:
        t_idx, c_idx = np.divmod(np.arange(D), D // 4)
        p[np.arange(D), c_idx * 4 + t_idx] = 1.0
    return p


@pytest.mark.parametrize("kind", ["none", "random", "decoder"])
@pytest.mark.parametrize("D", [128, 256])
def test_plain_matches_pallas_forward_and_gradients(pallas_attn, D, kind):
    assert px.xattn_supported(N, D, H_, M_)    # else the route would take JAX's XLA path
    args, cot = _inputs(D + len(kind), D)
    perm = _perm(kind, D)
    scale = D ** -0.5
    jperm = None if perm is None else jnp.asarray(perm)

    @jax.jit
    def value_and_vjp(*a):
        y, vjp = jax.vjp(lambda *b: jx.cross_attn_head1_auto(*b, scale=scale, perm=jperm), *a)
        return y, vjp(jnp.asarray(cot))

    ref, ref_grads = value_and_vjp(*map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    tperm = None if perm is None else torch.from_numpy(perm)
    out = tx.cross_attn_head1_plain(*targs, scale=scale, perm=tperm)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **FWD_TOL)
    grads = torch.autograd.grad(out, targs, torch.from_numpy(cot))
    for name, g, want in zip(NAMES, grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **GRAD_TOL,
                                   err_msg=f"d{name}")


def test_plain_bf16_matches_pallas(pallas_attn):
    """x and the projections in bf16, the LayerNorm affine in fp32, as
    tests/test_xattn.py's `test_bf16_fwd_close`."""
    D = 128
    args, _ = _inputs(4, D)
    ref = jax.jit(lambda *a: jx.cross_attn_head1_auto(*a, scale=D ** -0.5))(
        *[jnp.asarray(a, jnp.float32 if i in (1, 2) else jnp.bfloat16)
          for i, a in enumerate(args)])
    out = tx.cross_attn_head1_plain(
        *[torch.from_numpy(a).to(torch.float32 if i in (1, 2) else torch.bfloat16)
          for i, a in enumerate(args)], scale=D ** -0.5)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_plain_softmax_shift_per_head_matches_xla():
    """Head 0's keys scaled by 400, so its logits lie far above the other
    heads'. The port's plain version (like kernels G and F) shifts each
    (pixel, head)'s softmax by its own max, as JAX's XLA path and the
    reference do, and matches that path at 2e-5. It is not held against the
    Pallas kernel: that one shifts a pixel's logits by one max over all its
    heads, under which the lower heads underflow to o = 0; on these inputs
    (interpret mode) it differed from the XLA path by 0.31 against a largest
    output of 4.59."""
    D = 128
    args, _ = _inputs(7, D)
    args[4][..., 0] *= 400.0
    ref = jax.jit(lambda *a: jx.cross_attn_head1(*a, scale=D ** -0.5))(*map(jnp.asarray, args))
    out = tx.cross_attn_head1_plain(*map(torch.from_numpy, args), scale=D ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


def test_routed_op_on_cpu_is_the_plain_version():
    D = 128
    args, cot = _inputs(5, D)
    perm = torch.from_numpy(_perm("decoder", D))
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    out = tx.cross_attn_head1(*targs, scale=D ** -0.5, perm=perm)
    want = tx.cross_attn_head1_plain(*targs, scale=D ** -0.5, perm=perm)
    assert torch.equal(out, want)
    gy = torch.from_numpy(cot)
    for g, w in zip(torch.autograd.grad(out, targs, gy), torch.autograd.grad(want, targs, gy)):
        assert torch.equal(g, w)


def test_layer_plain_version_calls_the_plain_attention(monkeypatch):
    """F's plain version runs the plain attention, never the routed op: on
    the card the routed op would launch kernel G inside F's yardstick."""
    def routed(*a, **k):
        raise AssertionError("cross_layer_head1_plain called the routed cross_attn_head1")

    monkeypatch.setattr(tx, "cross_attn_head1", routed)
    D, hid = 64, 128
    rng = np.random.default_rng(6)
    f = lambda *s: torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32))
    args = [f(B, 64, D), f(D) + 1, f(D), f(D, H_), f(B, M_, H_), f(B, M_, H_), f(H_, D),
            f(D), f(D) + 1, f(D), f(D, hid), f(hid), f(hid, D), f(D)]
    y = tx.cross_layer_head1_plain(*args, scale=D ** -0.5)
    assert y.shape == (B, 64, D) and bool(torch.isfinite(y).all())
