"""The dim_head=1 pixel cross-attention decoder layer (SMOW_Net's
Transformer_Decoder, reference models/SMOW_Net.py:270-303).

Port of smow_net_tpu/ops/xattn.py with the JAX package's signature: x
(B, N, D) queries; ln/bias vectors (D,); wq (D, h); k, v (B, M, h) projected
memory; w_out (h, D); w1 (D, hidden); w2 (hidden, D); an optional one-hot
lane permutation `perm` (D, D) with x_c = x @ perm. The permutation is
applied as an index gather, never as a matmul.

`cross_layer_head1` is kernel F (csrc/xattn_layer.cu) on a CUDA tensor and
`cross_layer_head1_plain` on a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _kernels

__all__ = ["cross_attn_head1", "cross_layer_head1", "cross_layer_head1_plain",
           "layer_norm32"]


def _perm_index(perm: torch.Tensor) -> torch.Tensor:
    """One-hot (D, D) matrix P -> source lane per output lane: (x P)[j] =
    x[src[j]] with P[src[j], j] = 1."""
    return perm.argmax(dim=0)


def layer_norm32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """LayerNorm in fp32 with the JAX package's statistics (E[x^2] - mu^2)."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 * x32).mean(dim=-1, keepdim=True) - mu * mu
    return (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def cross_attn_head1(x, ln_scale, ln_bias, wq, k, v, w_out, b_out, *,
                     scale, perm=None, eps=1e-5):
    """y = to_out(softmax_m(LN(x P) wq (x) k scale) . v) + x P."""
    dt = x.dtype
    x_c = x if perm is None else x[..., _perm_index(perm)]
    xn = layer_norm32(x_c, ln_scale, ln_bias, eps).to(dt)
    q = xn @ wq.to(dt)                                         # (B, N, h)
    kT = (k * scale).transpose(1, 2)[:, None].float()          # (B, 1, h, M)
    vT = v.transpose(1, 2)[:, None].float()
    attn = torch.softmax(q[..., None].float() * kT, dim=-1)    # (B, N, h, M)
    o = (attn * vT).sum(dim=-1).to(dt)
    return o @ w_out.to(dt) + b_out.to(dt) + x_c


def cross_layer_head1_plain(x, ln1_scale, ln1_bias, wq, k, v, w_out, b_out,
                            ln2_scale, ln2_bias, w1, b1, w2, b2, *,
                            scale, perm=None, eps=1e-5):
    """Plain version of kernel F: dim_head=1 cross-attention (+ residual),
    then the PreNorm exact-GELU MLP (+ residual)."""
    y1 = cross_attn_head1(x, ln1_scale, ln1_bias, wq, k, v, w_out, b_out,
                          scale=scale, perm=perm, eps=eps)
    dt = y1.dtype
    yn = layer_norm32(y1, ln2_scale, ln2_bias, eps).to(dt)
    h = yn @ w1.to(dt) + b1.to(dt)
    h = torch.nn.functional.gelu(h.float()).to(dt)
    return h @ w2.to(dt) + b2.to(dt) + y1


_LAYER_SHAPE = (128, 8, 8, 256)   # (D, heads, M, hidden) built into kernel F


def cross_layer_head1(x, ln1_scale, ln1_bias, wq, k, v, w_out, b_out,
                      ln2_scale, ln2_bias, w1, b1, w2, b2, *,
                      scale, perm=None, eps=1e-5):
    """The whole layer: kernel F on a CUDA tensor, the plain version on a
    CPU tensor."""
    args = (x, ln1_scale, ln1_bias, wq, k, v, w_out, b_out,
            ln2_scale, ln2_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return cross_layer_head1_plain(*args, scale=scale, perm=perm, eps=eps)
    if not x.is_cuda:
        raise ValueError(f"cross_layer_head1: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cross_layer_head1: dtype {x.dtype} not supported")
    if x.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("cross_layer_head1: x must be (B, N, D), k and v (B, M, h)")
    B, N, D = x.shape
    M, h = k.shape[1], k.shape[2]
    hidden = w1.shape[1]
    if (D, h, M, hidden) != _LAYER_SHAPE or k.shape[0] != B:
        raise ValueError(f"cross_layer_head1: kernel F is built for (D, heads, M, hidden)"
                         f" = {_LAYER_SHAPE}, got {(D, h, M, hidden)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("cross_layer_head1: x must be contiguous and 16-byte aligned")
    expect = {"ln1_scale": (D,), "ln1_bias": (D,), "wq": (D, h), "w_out": (h, D),
              "b_out": (D,), "ln2_scale": (D,), "ln2_bias": (D,), "w1": (D, hidden),
              "b1": (hidden,), "w2": (hidden, D), "b2": (D,)}
    w = {}
    for (name, shape), t in zip(expect.items(), args[1:4] + args[6:]):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"cross_layer_head1: {name} must be {shape} on {x.device}")
        w[name] = t.float().contiguous()
    if k.device != x.device or v.device != x.device:
        raise ValueError(f"cross_layer_head1: k and v must be on {x.device}")
    kexp = (k.float() * scale).transpose(1, 2).contiguous()   # (B, h, M)
    vexp = v.float().transpose(1, 2).contiguous()
    src = None
    if perm is not None:
        if tuple(perm.shape) != (D, D) or perm.device != x.device:
            raise ValueError(f"cross_layer_head1: perm must be ({D}, {D}) on {x.device}")
        src = _perm_index(perm).to(torch.int32).contiguous()
    out = torch.empty_like(x)
    _kernels.call(
        "xattn_layer_fwd", x.data_ptr(), None if src is None else src.data_ptr(),
        w["ln1_scale"].data_ptr(), w["ln1_bias"].data_ptr(), w["wq"].data_ptr(),
        kexp.data_ptr(), vexp.data_ptr(), w["w_out"].data_ptr(), w["b_out"].data_ptr(),
        w["ln2_scale"].data_ptr(), w["ln2_bias"].data_ptr(), w["w1"].data_ptr(),
        w["b1"].data_ptr(), w["w2"].data_ptr(), w["b2"].data_ptr(), out.data_ptr(),
        B, N, D, h, M, hidden, int(x.dtype == torch.bfloat16), float(eps),
        _kernels.stream_handle(x.device))
    return out
