"""The rounding contract of the bf16 kernels F and F-bwd
(csrc/xattn_layer.cu, csrc/xattn_layer_bwd.cu), on the CPU: a plain-torch
emulation of where they round (weights at bf16 values; the MLP's products
on bf16 operands with fp32 accumulation, each fp32 activation operand split
into bf16 hi + lo; everything else in fp32; outputs rounded once to bf16)
stays within the bounds that the card holds the kernels to against the
fp32 plain version on the same bf16 inputs: 1e-4 (1e-5 for gradients) +
2^-8 of the largest element. No JAX; seconds."""

import numpy as np
import pytest
import torch

from smow_net_tpu_torch.ops.xattn import cross_layer_head1_plain, layer_norm32

BF16_REL = 2.0 ** -8
EPS = 1e-5


def _inputs(D, B=2, N=512, seed=11):
    """The layer's 14 inputs at bf16 values (as the card's checks make them)
    and a bf16 cotangent."""
    rng = np.random.default_rng(seed)
    h, M, hid = 8, 8, 2 * D

    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)
                                ).to(torch.bfloat16).float()

    args = [f(B, N, D), f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, h, scale=0.1),
            f(B, M, h), f(B, M, h), f(h, D, scale=0.1), f(D, scale=0.1),
            f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, hid, scale=D ** -0.5),
            f(hid, scale=0.1), f(hid, D, scale=hid ** -0.5), f(D, scale=0.1)]
    return args, f(B, N, D)


def _split(a):
    """fp32 -> (hi, lo), both at bf16 values: the kernels' operand split."""
    hi = a.to(torch.bfloat16).float()
    return hi, (a - hi).to(torch.bfloat16).float()


def _prefix(x, ln1_s, ln1_b, wq, k, v, w_out, b_out, ln2_s, ln2_b, scale):
    """y1 and LN2(y1) in fp32, as the kernels' CUDA-core steps compute them
    (one softmax shift per (pixel, head))."""
    xn = layer_norm32(x, ln1_s, ln1_b, EPS)
    q = xn @ wq
    attn = torch.softmax(q[..., None] * (k * scale).transpose(1, 2)[:, None], dim=-1)
    o = (attn * v.transpose(1, 2)[:, None]).sum(dim=-1)
    y1 = o @ w_out + b_out + x
    return y1, layer_norm32(y1, ln2_s, ln2_b, EPS)


def _gelu_parts(h):
    cdf = 0.5 * (1.0 + torch.erf(h * 0.7071067811865476))
    pdf = torch.exp(-0.5 * h * h) * 0.3989422804014327
    return cdf, pdf


def _emulated(args, gy, scale):
    """Kernel F's output and F-bwd's dx, dw1, dw2 as the bf16 kernels round
    them."""
    x, w1, b1, w2, b2 = args[0], args[10], args[11], args[12], args[13]
    xg = x.clone().requires_grad_()
    y1, yn = _prefix(xg, *args[1:10], scale)
    yh, yl = _split(yn.detach())
    hp = yh @ w1 + yl @ w1 + b1
    cdf, pdf = _gelu_parts(hp)
    gh, gl = _split(hp * cdf)
    out = (y1.detach() + b2 + gh @ w2 + gl @ w2).to(torch.bfloat16)

    dhg = gy @ w2.t()
    dh_h, dh_l = _split(dhg * (cdf + hp * pdf))
    dyn = dh_h @ w1.t() + dh_l @ w1.t()
    dx, = torch.autograd.grad((y1, yn), xg, (gy, dyn))
    yh2, yl2, dh2, dl2 = (t.reshape(-1, t.shape[-1]) for t in (yh, yl, dh_h, dh_l))
    dw1 = yh2.t() @ dh2 + yh2.t() @ dl2 + yl2.t() @ dh2
    g2 = gy.reshape(-1, gy.shape[-1])
    dw2 = gh.reshape(-1, gh.shape[-1]).t() @ g2 + gl.reshape(-1, gl.shape[-1]).t() @ g2
    return out, [t.to(torch.bfloat16) for t in (dx, dw1, dw2)]


@pytest.mark.parametrize("D", [64, 128])
def test_bf16_rounding_points_hold_the_kernels_bounds(D):
    torch.manual_seed(0)
    args, gy = _inputs(D)
    scale = D ** -0.5
    out, grads = _emulated(args, gy, scale)

    ref = [a.clone().requires_grad_() for a in args]
    want = cross_layer_head1_plain(*ref, scale=scale)
    err = (out.float() - want.detach()).abs().max().item()
    assert err <= 1e-4 + BF16_REL * want.abs().max().item(), err
    want_g = torch.autograd.grad(want, [ref[0], ref[10], ref[12]], gy)
    for name, got, w in zip(("dx", "dw1", "dw2"), grads, want_g):
        err = (got.float() - w).abs().max().item()
        assert err <= 1e-5 + BF16_REL * w.abs().max().item(), (name, err)
