"""The dim_head=1 pixel cross-attention decoder layer (SMOW_Net's
Transformer_Decoder, reference models/SMOW_Net.py:270-303).

Port of smow_net_tpu/ops/xattn.py with the JAX package's signature: x
(B, N, D) queries; ln/bias vectors (D,); wq (D, h); k, v (B, M, h) projected
memory; w_out (h, D); w1 (D, hidden); w2 (hidden, D); an optional one-hot
lane permutation `perm` (D, D) with x_c = x @ perm. The permutation is
applied as an index gather, never as a matmul.

`cross_layer_head1` is a torch.autograd.Function on a CUDA tensor, forward
kernel F (csrc/xattn_layer.cu) and backward kernel F-bwd
(csrc/xattn_layer_bwd.cu), and `cross_layer_head1_plain` under torch autograd
on a CPU tensor.
"""

from __future__ import annotations

import math

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


_LAYER_SHAPE = (128, 8, 8, 256)   # (D, heads, M, hidden) built into kernels F and F-bwd
_ARG_NAMES = ("x", "ln1_scale", "ln1_bias", "wq", "k", "v", "w_out", "b_out",
              "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")


def _slab_layout(D, h, hidden):
    """Kernel F-bwd's per-block partial sums: (argument, shape) in the order
    of the kOff* offsets in csrc/xattn_layer_bwd.cu."""
    return (("w1", (D, hidden)), ("w2", (hidden, D)), ("wq", (D, h)), ("w_out", (h, D)),
            ("ln1_scale", (D,)), ("ln1_bias", (D,)), ("ln2_scale", (D,)),
            ("ln2_bias", (D,)), ("b_out", (D,)), ("b2", (D,)), ("b1", (hidden,)))


def _kernel_args(args, scale, perm):
    """Check the layer's CUDA arguments against what kernels F and F-bwd
    take; returns the fp32 weights by name, kexp/vexp (B, h, M) with the
    softmax scale folded into kexp, and the permutation as source lanes."""
    x, k, v = args[0], args[4], args[5]
    if not x.is_cuda:
        raise ValueError(f"cross_layer_head1: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cross_layer_head1: dtype {x.dtype} not supported")
    if x.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError("cross_layer_head1: x must be (B, N, D), k and v (B, M, h)")
    B, N, D = x.shape
    M, h = k.shape[1], k.shape[2]
    hidden = args[10].shape[1]
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
        w[name] = t.detach().float().contiguous()
    if k.device != x.device or v.device != x.device:
        raise ValueError(f"cross_layer_head1: k and v must be on {x.device}")
    kexp = (k.detach().float() * scale).transpose(1, 2).contiguous()   # (B, h, M)
    vexp = v.detach().float().transpose(1, 2).contiguous()
    src = None
    if perm is not None:
        if tuple(perm.shape) != (D, D) or perm.device != x.device:
            raise ValueError(f"cross_layer_head1: perm must be ({D}, {D}) on {x.device}")
        src = _perm_index(perm).to(torch.int32).contiguous()
    return w, kexp, vexp, src


def _weight_ptrs(w, kexp, vexp):
    return [w["ln1_scale"].data_ptr(), w["ln1_bias"].data_ptr(), w["wq"].data_ptr(),
            kexp.data_ptr(), vexp.data_ptr(), w["w_out"].data_ptr(), w["b_out"].data_ptr(),
            w["ln2_scale"].data_ptr(), w["ln2_bias"].data_ptr(), w["w1"].data_ptr(),
            w["b1"].data_ptr(), w["w2"].data_ptr(), w["b2"].data_ptr()]


def _layer_fwd(args, scale, perm, eps):
    """Kernel F: the layer's output (B, N, D) in x.dtype."""
    x = args[0]
    w, kexp, vexp, src = _kernel_args(args, scale, perm)
    B, N, D = x.shape
    h, M, hidden = w["wq"].shape[1], kexp.shape[2], w["w1"].shape[1]
    out = torch.empty_like(x)
    _kernels.call("xattn_layer_fwd", x.data_ptr(), None if src is None else src.data_ptr(),
                  *_weight_ptrs(w, kexp, vexp), out.data_ptr(),
                  B, N, D, h, M, hidden, int(x.dtype == torch.bfloat16), float(eps),
                  _kernels.stream_handle(x.device))
    return out


def _layer_bwd(args, gy, scale, perm, eps):
    """Kernel F-bwd: the gradients of the layer's 14 inputs (`_ARG_NAMES`)
    for the output cotangent gy, each in its input's dtype. The kernel
    leaves one block's row sums per slab row; they are summed here."""
    x = args[0]
    w, kexp, vexp, src = _kernel_args(args, scale, perm)
    gy = gy.to(x.dtype).contiguous()
    B, N, D = x.shape
    h, M, hidden = w["wq"].shape[1], kexp.shape[2], w["w1"].shape[1]
    layout = _slab_layout(D, h, hidden)
    sizes = [math.prod(shape) for _, shape in layout]
    tiles = B * -(-N // 64)     # the kernel's 64-row tiles (kTile, csrc/xattn_layer.cuh)
    blocks = min(tiles, torch.cuda.get_device_properties(x.device).multi_processor_count)
    slab = torch.zeros(blocks, sum(sizes), dtype=torch.float32, device=x.device)
    dkexp = torch.zeros(B, h, M, dtype=torch.float32, device=x.device)
    dvexp = torch.zeros_like(dkexp)
    dx = torch.empty_like(x)
    _kernels.call("xattn_layer_bwd", x.data_ptr(), gy.data_ptr(),
                  None if src is None else src.data_ptr(), *_weight_ptrs(w, kexp, vexp),
                  dx.data_ptr(), slab.data_ptr(), dkexp.data_ptr(), dvexp.data_ptr(),
                  B, N, D, h, M, hidden, blocks, sum(sizes),
                  int(x.dtype == torch.bfloat16), float(eps), _kernels.stream_handle(x.device))
    grads = {name: part.reshape(shape) for (name, shape), part in
             zip(layout, slab.sum(dim=0).split(sizes))}
    grads["x"] = dx
    grads["k"] = dkexp.transpose(1, 2) * scale
    grads["v"] = dvexp.transpose(1, 2)
    return tuple(grads[name].to(a.dtype) for name, a in zip(_ARG_NAMES, args))


class _CrossLayerHead1(torch.autograd.Function):
    """Kernel F forward, kernel F-bwd backward; only the inputs are saved.
    perm gets no gradient."""

    @staticmethod
    def forward(ctx, perm, scale, eps, *args):
        ctx.scale, ctx.eps, ctx.perm = scale, eps, perm
        ctx.save_for_backward(*args)
        return _layer_fwd(args, scale, perm, eps)

    @staticmethod
    def backward(ctx, gy):
        grads = _layer_bwd(ctx.saved_tensors, gy, ctx.scale, ctx.perm, ctx.eps)
        return (None, None, None) + grads


def cross_layer_head1(x, ln1_scale, ln1_bias, wq, k, v, w_out, b_out,
                      ln2_scale, ln2_bias, w1, b1, w2, b2, *,
                      scale, perm=None, eps=1e-5):
    """The whole layer: kernel F (and F-bwd for its gradients) on a CUDA
    tensor, the plain version under torch autograd on a CPU tensor."""
    args = (x, ln1_scale, ln1_bias, wq, k, v, w_out, b_out,
            ln2_scale, ln2_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return cross_layer_head1_plain(*args, scale=scale, perm=perm, eps=eps)
    return _CrossLayerHead1.apply(perm, scale, eps, *args)
