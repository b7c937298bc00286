"""The rounding contract of the bf16 kernels F and F-bwd
(csrc/xattn_layer.cu, csrc/xattn_layer_bwd.cu) and G-bwd
(csrc/cross_attn_bwd.cu), on the CPU: a plain-torch emulation of where they
round (weights at bf16 values; the products on bf16 operands with fp32
accumulation, each fp32 activation operand split into bf16 hi + lo;
everything else in fp32; outputs rounded once to bf16) stays within the
bounds that the card holds the kernels to against the fp32 plain version on
the same bf16 inputs: 1e-4 (1e-5 for gradients) + 2^-8 of the largest
element. No JAX; seconds."""

import numpy as np
import pytest
import torch

from smow_net_tpu_torch.ops.xattn import (cross_attn_head1_plain, cross_layer_head1_plain,
                                         layer_norm32)

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


def _attn_emulated(args, gy, scale, src):
    """Kernel G-bwd's eight gradients as its bf16 body (D <= 128) rounds
    them: q = LN1(xc) wq in fp32; xhat split into hi + lo for xhat^T dq, dq
    for dxn = dq wq^T and xhat^T dq, o for g^T o; the LayerNorm's and wq's
    sums from xhat^T dq and sum dq; dx scattered through the permutation
    (source lanes `src`)."""
    x, ln_s, ln_b, wq, k, v, w_out, _ = args
    xc = x[..., src]
    mu = xc.mean(dim=-1, keepdim=True)
    rs = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) - mu * mu + EPS)
    xh = (xc - mu) * rs
    xh_h, xh_l = _split(xh)
    q = (xh * ln_s + ln_b) @ wq                                # (B, N, h)
    kT = (k * scale).transpose(1, 2)[:, None]                  # (B, 1, h, M)
    vT = v.transpose(1, 2)[:, None]
    logits = q[..., None] * kT
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    den = e.sum(dim=-1).clamp_min(1e-30)
    o = (e * vT).sum(dim=-1) / den
    dov = gy @ w_out.t()
    dnum, dden = dov / den, -dov * o / den
    dd = e * (dnum[..., None] * vT + dden[..., None])
    dq = (dd * kT).sum(dim=-1)
    dk = (q[..., None] * dd).sum(dim=1).transpose(1, 2) * scale    # (B, M, h)
    dv = (e * dnum[..., None]).sum(dim=1).transpose(1, 2)
    dq_h, dq_l = _split(dq)
    xh2 = xh_h + xh_l
    dxh = (dq_h @ wq.t() + dq_l @ wq.t()) * ln_s
    m1, m2 = dxh.mean(dim=-1, keepdim=True), (dxh * xh2).mean(dim=-1, keepdim=True)
    dx = torch.empty_like(x)
    dx[..., src] = rs * (dxh - m1 - xh2 * m2) + gy
    rows = lambda t: t.reshape(-1, t.shape[-1])
    xq = (rows(xh_h).t() @ rows(dq_h) + rows(xh_h).t() @ rows(dq_l)
          + rows(xh_l).t() @ rows(dq_h))                         # (D, h)
    sq = rows(dq).sum(dim=0)
    o_h, o_l = _split(o)
    dwo = rows(o_h).t() @ rows(gy) + rows(o_l).t() @ rows(gy)
    grads = (dx, (wq * xq).sum(dim=1), wq @ sq, ln_s[:, None] * xq + ln_b[:, None] * sq, dk,
             dv, dwo, rows(gy).sum(dim=0))
    return [t.to(torch.bfloat16) for t in grads]


@pytest.mark.parametrize("case", ["no_perm", "perm", "spread"])
@pytest.mark.parametrize("D", [64, 128])
def test_attn_bwd_bf16_rounding_points_hold_the_kernels_bound(D, case):
    """G-bwd's bf16 rounding points against torch.autograd.grad of
    `cross_attn_head1_plain` in fp32 on the same bf16 inputs, every one of
    the eight gradients to 1e-5 + 2^-8 of its largest element (phase 4d's
    bound); N = 1000 leaves a ragged 16-row tile. "spread" scales head 0's
    keys by 1e4 at N = 4096, as phase 4d's spread case does: its logits
    reach ~1e3, where q through bf16 hi + lo (2^-17) fails dln_bias."""
    args, gy = _inputs(D, N=4096 if case == "spread" else 1000, seed=D + 3)
    args, scale = args[:8], D ** -0.5
    use_perm = case == "perm"
    if case == "spread":
        args[4][..., 0] *= 1e4
    rng = np.random.default_rng(D)
    src = torch.from_numpy(rng.permutation(D)) if use_perm else torch.arange(D)
    perm = torch.zeros(D, D)
    perm[src, torch.arange(D)] = 1.0
    got = _attn_emulated(args, gy, scale, src)
    ref = [a.clone().requires_grad_() for a in args]
    want = torch.autograd.grad(
        cross_attn_head1_plain(*ref, scale=scale, perm=perm if use_perm else None), ref, gy)
    names = ("dx", "dln_scale", "dln_bias", "dwq", "dk", "dv", "dw_out", "db_out")
    for name, g, w in zip(names, got, want):
        err = (g.float() - w).abs().max().item()
        assert err <= 1e-5 + BF16_REL * w.abs().max().item(), (name, err)
