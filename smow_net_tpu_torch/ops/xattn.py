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
on a CPU tensor. In bf16 both kernels run the MLP's products on the tensor
cores with each fp32 activation operand split into bf16 hi + lo; F-bwd's
thread-block clusters keep dw1 and dw2 on chip and write one record per
block (`layer_bwd_slab`, `layer_grid`). `cross_attn_head1`, the layer's
attention sublayer alone, is routed the same way: kernels G
(csrc/cross_attn.cu) and G-bwd (csrc/cross_attn_bwd.cu) on CUDA,
`cross_attn_head1_plain` on the CPU; in bf16 at D <= 128 G-bwd runs its
products on the tensor cores, warp-owned 16-row tiles, and writes one
record per block (`attn_bwd_blocks`). Both kernels and both plain versions
take one softmax shift per (pixel, head), as the reference's softmax does,
not the Pallas kernels' one per pixel.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _kernels

__all__ = ["attn_bwd_blocks", "cross_attn_head1", "cross_attn_head1_plain",
           "cross_layer_head1", "cross_layer_head1_plain", "layer_bwd_slab", "layer_grid",
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


def cross_attn_head1_plain(x, ln_scale, ln_bias, wq, k, v, w_out, b_out, *,
                           scale, perm=None, eps=1e-5):
    """Plain version of kernel G: y = to_out(softmax_m(LN(x P) wq (x) k
    scale) . v) + x P."""
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
    y1 = cross_attn_head1_plain(x, ln1_scale, ln1_bias, wq, k, v, w_out, b_out,
                                scale=scale, perm=perm, eps=eps)
    dt = y1.dtype
    yn = layer_norm32(y1, ln2_scale, ln2_bias, eps).to(dt)
    h = yn @ w1.to(dt) + b1.to(dt)
    h = torch.nn.functional.gelu(h.float()).to(dt)
    return h @ w2.to(dt) + b2.to(dt) + y1


# (D, heads, M, hidden) built into kernels F and F-bwd: SMOW_Net's and SMOW_Net_LW's decoders
_LAYER_SHAPES = ((128, 8, 8, 256), (64, 8, 8, 128))
# (D, heads, M) built into kernels G and G-bwd: the decoders' widths and the
# Pallas kernel's (D % 128 == 0, D <= 512) at SMOW_Net's 8 heads of 8 tokens
_ATTN_SHAPES = tuple((D, 8, 8) for D in (64, 128, 256, 384, 512))
# the layer's 14 inputs; the attention sublayer takes the first 8
_ARG_NAMES = ("x", "ln1_scale", "ln1_bias", "wq", "k", "v", "w_out", "b_out",
              "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")


def _slab_layout(D, h, hidden):
    """Kernel F-bwd's fp32 per-block partial sums: (argument, shape) in the
    order of the kOff* offsets of `Slab<D>` in csrc/xattn_layer_bwd.cu."""
    return (("w1", (D, hidden)), ("w2", (hidden, D)), ("wq", (D, h)), ("w_out", (h, D)),
            ("ln1_scale", (D,)), ("ln1_bias", (D,)), ("ln2_scale", (D,)),
            ("ln2_bias", (D,)), ("b_out", (D,)), ("b2", (D,)), ("b1", (hidden,)))


# hidden units per block of kernel F-bwd's bf16 clusters (tcb::kHS)
_BWD_SLICE = 64


def _record_layout(D, h):
    """Kernel F-bwd's bf16 record of one block: (argument, shape) in the
    order of `tcb::Layout<D>`: its slice of dw1 and dw2 and of db1, then its
    rows' small sums."""
    return (("w1", (D, _BWD_SLICE)), ("w2", (_BWD_SLICE, D)), ("b1", (_BWD_SLICE,)),
            ("wq", (D, h)), ("w_out", (h, D)), ("ln1_scale", (D,)), ("ln1_bias", (D,)),
            ("ln2_scale", (D,)), ("ln2_bias", (D,)), ("b_out", (D,)), ("b2", (D,)))


@functools.lru_cache(maxsize=None)
def _grid_query(entry, device_index, args, outputs):
    """The `outputs` int results of the grid entry `entry` (xattn_layer_grid,
    cross_attn_bwd_grid) for the int arguments `args`, once per device."""
    out = [ctypes.c_int(0) for _ in range(outputs)]
    lib = _kernels.library()
    with torch.cuda.device(device_index):
        rc = getattr(lib, entry)(*args, *map(ctypes.byref, out))
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} "
                           f"({lib.smow_cuda_error_string(rc).decode()})")
    return tuple(v.value for v in out)


def layer_grid(D, dtype, bwd, device):
    """Kernel F's (bwd False) or F-bwd's residency on the card for width D
    and dtype: (blocks in one full wave, shared memory a block in bytes).
    F-bwd's bf16 blocks come in clusters of 2D / 64."""
    index = torch.device(device).index or 0
    return _grid_query("xattn_layer_grid", index, (D, int(dtype == torch.bfloat16), int(bwd)), 2)


def layer_bwd_slab(B, N, D, dtype, device):
    """Kernel F-bwd's slab for one call: (blocks, floats a block). fp32: one
    block per SM (or per 64-row tile, if fewer), each adding into its row per
    tile; bf16: one wave of clusters (at most one per 64-row tile), each
    block writing its record once."""
    tiles = B * -(-N // 64)
    ctas, _ = layer_grid(D, dtype, True, device)
    if dtype != torch.bfloat16:
        return min(tiles, ctas), sum(math.prod(s) for _, s in _slab_layout(D, 8, 2 * D))
    per = 2 * D // _BWD_SLICE
    return min(ctas // per, tiles) * per, sum(math.prod(s) for _, s in _record_layout(D, 8))


def attn_bwd_blocks(B, N, D, dtype, device):
    """Kernel G-bwd's blocks for one call, one record each: one wave of its
    persistent grid, or fewer where the call has fewer tiles (bf16 at D <=
    128: one block of 8 warps per SM, a 16-row tile a warp at once; else two
    blocks per SM, kAttnRows<D> rows a tile)."""
    index = torch.device(device).index or 0
    ctas, rows, per = _grid_query("cross_attn_bwd_grid", index,
                                  (D, int(dtype == torch.bfloat16)), 3)
    return min(ctas, -(-(B * -(-N // rows)) // per))


def _part_layout(D, h):
    """Kernel G-bwd's per-block partial sums: (argument, shape) in the order
    of the kOff* offsets of `Part<D>` in csrc/cross_attn_bwd.cu."""
    return (("wq", (D, h)), ("w_out", (h, D)), ("ln1_scale", (D,)), ("ln1_bias", (D,)),
            ("b_out", (D,)))


def _kernel_args(args, scale, perm):
    """Check the CUDA arguments of the layer (its 14 inputs: kernels F and
    F-bwd) or of its attention sublayer (the first 8: kernels G and G-bwd)
    against what the kernels take; returns the weights by name (fp32; for
    the bf16 layer at the plain version's bf16 values, w1 and w2 as bf16),
    kexp/vexp (B, h, M) with the softmax scale folded into kexp, and the
    permutation as source lanes."""
    layer = len(args) == len(_ARG_NAMES)
    op, kernel = ("cross_layer_head1", "F") if layer else ("cross_attn_head1", "G")
    x, k, v = args[0], args[4], args[5]
    if not x.is_cuda:
        raise ValueError(f"{op}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{op}: dtype {x.dtype} not supported")
    if x.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"{op}: x must be (B, N, D), k and v (B, M, h)")
    B, N, D = x.shape
    M, h = k.shape[1], k.shape[2]
    if layer:
        hidden = args[10].shape[1]
        key, built, fields = (D, h, M, hidden), _LAYER_SHAPES, "(D, heads, M, hidden)"
    else:
        hidden = None
        key, built, fields = (D, h, M), _ATTN_SHAPES, "(D, heads, M)"
    if key not in built or k.shape[0] != B:
        raise ValueError(f"{op}: kernel {kernel} is built for {fields} in {built}, got {key}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{op}: x must be contiguous and 16-byte aligned")
    expect = {"ln1_scale": (D,), "ln1_bias": (D,), "wq": (D, h), "w_out": (h, D),
              "b_out": (D,), "ln2_scale": (D,), "ln2_bias": (D,), "w1": (D, hidden),
              "b1": (hidden,), "w2": (hidden, D), "b2": (D,)}
    weights = args[1:4] + args[6:]
    # the bf16 layer takes the weights at the plain version's bf16 values,
    # w1 and w2 as bf16 (tensor-core operands)
    rounded = ("wq", "w_out", "b_out", "w1", "b1", "w2", "b2")
    bf16_layer = layer and x.dtype == torch.bfloat16
    w = {}
    for (name, shape), t in zip(list(expect.items())[:len(weights)], weights):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"{op}: {name} must be {shape} on {x.device}")
        t = t.detach().to(torch.bfloat16) if bf16_layer and name in rounded else t.detach()
        w[name] = (t if bf16_layer and name in ("w1", "w2") else t.float()).contiguous()
    if k.device != x.device or v.device != x.device:
        raise ValueError(f"{op}: k and v must be on {x.device}")
    kexp = (k.detach().float() * scale).transpose(1, 2).contiguous()   # (B, h, M)
    vexp = v.detach().float().transpose(1, 2).contiguous()
    src = None
    if perm is not None:
        if tuple(perm.shape) != (D, D) or perm.device != x.device:
            raise ValueError(f"{op}: perm must be ({D}, {D}) on {x.device}")
        src = _perm_index(perm).to(torch.int32).contiguous()
    return w, kexp, vexp, src


def _weight_ptrs(w, kexp, vexp):
    """The C entries' weight arguments; the MLP's only for the layer."""
    return ([w["ln1_scale"].data_ptr(), w["ln1_bias"].data_ptr(), w["wq"].data_ptr(),
             kexp.data_ptr(), vexp.data_ptr(), w["w_out"].data_ptr(), w["b_out"].data_ptr()]
            + [w[n].data_ptr() for n in ("ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")
               if n in w])


def _kernel_fwd(args, scale, perm, eps):
    """Kernel F (the layer's 14 inputs) or G (the sublayer's 8): the output
    (B, N, D) in x.dtype."""
    x = args[0]
    w, kexp, vexp, src = _kernel_args(args, scale, perm)
    B, N, D = x.shape
    h, M = w["wq"].shape[1], kexp.shape[2]
    hidden = [w["w1"].shape[1]] if "w1" in w else []
    out = torch.empty_like(x)
    _kernels.call("xattn_layer_fwd" if hidden else "cross_attn_fwd", x.data_ptr(),
                  None if src is None else src.data_ptr(), *_weight_ptrs(w, kexp, vexp),
                  out.data_ptr(), B, N, D, h, M, *hidden, int(x.dtype == torch.bfloat16),
                  float(eps), _kernels.stream_handle(x.device))
    return out


def _kernel_bwd(args, gy, scale, perm, eps):
    """Kernel F-bwd (the layer's 14 inputs) or G-bwd (the sublayer's 8): the
    gradients of the inputs (`_ARG_NAMES`) for the output cotangent gy,
    each in its input's dtype. The kernel leaves one block's row sums per
    slab row (F-bwd's bf16 kernel: one record per block, `_from_records`);
    they are summed here."""
    x = args[0]
    w, kexp, vexp, src = _kernel_args(args, scale, perm)
    gy = gy.to(x.dtype).contiguous()
    B, N, D = x.shape
    h, M = w["wq"].shape[1], kexp.shape[2]
    if "w1" in w:
        hidden = [w["w1"].shape[1]]
        bf16 = x.dtype == torch.bfloat16
        layout = _record_layout(D, h) if bf16 else _slab_layout(D, h, hidden[0])
        blocks, _ = layer_bwd_slab(B, N, D, x.dtype, x.device)
        # fp32 adds into its slab row per tile: zeroed; bf16 writes its record once
        alloc = torch.empty if bf16 else torch.zeros
    else:
        hidden, bf16 = [], False
        layout = _part_layout(D, h)
        # G-bwd writes its row once
        blocks, alloc = attn_bwd_blocks(B, N, D, x.dtype, x.device), torch.empty
    sizes = [math.prod(shape) for _, shape in layout]
    slab = alloc(blocks, sum(sizes), dtype=torch.float32, device=x.device)
    dkexp = torch.zeros(B, h, M, dtype=torch.float32, device=x.device)
    dvexp = torch.zeros_like(dkexp)
    dx = torch.empty_like(x)
    _kernels.call("xattn_layer_bwd" if hidden else "cross_attn_bwd", x.data_ptr(),
                  gy.data_ptr(), None if src is None else src.data_ptr(),
                  *_weight_ptrs(w, kexp, vexp), dx.data_ptr(), slab.data_ptr(),
                  dkexp.data_ptr(), dvexp.data_ptr(), B, N, D, h, M, *hidden, blocks,
                  sum(sizes), int(x.dtype == torch.bfloat16), float(eps),
                  _kernels.stream_handle(x.device))
    if bf16:
        grads = _from_records(slab, layout, sizes, D, hidden[0])
    else:
        grads = {name: part.reshape(shape) for (name, shape), part in
                 zip(layout, slab.sum(dim=0).split(sizes))}
    grads["x"] = dx
    grads["k"] = dkexp.transpose(1, 2) * scale
    grads["v"] = dvexp.transpose(1, 2)
    return tuple(grads[name].to(a.dtype) for name, a in zip(_ARG_NAMES, args))


def _from_records(slab, layout, sizes, D, hidden):
    """F-bwd's bf16 records (blocks, floats) summed over clusters, the hidden
    slices of dw1, dw2 and db1 put side by side, the rows' sums added."""
    C = hidden // _BWD_SLICE
    parts = dict(zip((name for name, _ in layout),
                     slab.view(-1, C, slab.shape[1]).sum(dim=0).split(sizes, dim=1)))
    grads = {"w1": parts.pop("w1").reshape(C, D, _BWD_SLICE).permute(1, 0, 2).reshape(D, hidden),
             "w2": parts.pop("w2").reshape(hidden, D),
             "b1": parts.pop("b1").reshape(hidden)}
    shapes = dict(layout)
    grads.update({name: part.sum(dim=0).reshape(shapes[name]) for name, part in parts.items()})
    return grads


class _Head1Kernels(torch.autograd.Function):
    """Kernels F and F-bwd for the layer's 14 inputs, G and G-bwd for the
    attention sublayer's 8; only the inputs are saved. perm gets no
    gradient."""

    @staticmethod
    def forward(ctx, perm, scale, eps, *args):
        ctx.scale, ctx.eps, ctx.perm = scale, eps, perm
        ctx.save_for_backward(*args)
        return _kernel_fwd(args, scale, perm, eps)

    @staticmethod
    def backward(ctx, gy):
        grads = _kernel_bwd(ctx.saved_tensors, gy, ctx.scale, ctx.perm, ctx.eps)
        return (None, None, None) + grads


def cross_attn_head1(x, ln_scale, ln_bias, wq, k, v, w_out, b_out, *,
                     scale, perm=None, eps=1e-5):
    """The attention sublayer: kernel G (and G-bwd for its gradients) on a
    CUDA tensor, the plain version under torch autograd on a CPU tensor."""
    args = (x, ln_scale, ln_bias, wq, k, v, w_out, b_out)
    if x.device.type == "cpu":
        return cross_attn_head1_plain(*args, scale=scale, perm=perm, eps=eps)
    return _Head1Kernels.apply(perm, scale, eps, *args)


def cross_layer_head1(x, ln1_scale, ln1_bias, wq, k, v, w_out, b_out,
                      ln2_scale, ln2_bias, w1, b1, w2, b2, *,
                      scale, perm=None, eps=1e-5):
    """The whole layer: kernel F (and F-bwd for its gradients) on a CUDA
    tensor, the plain version under torch autograd on a CPU tensor."""
    args = (x, ln1_scale, ln1_bias, wq, k, v, w_out, b_out,
            ln2_scale, ln2_bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return cross_layer_head1_plain(*args, scale=scale, perm=perm, eps=eps)
    return _Head1Kernels.apply(perm, scale, eps, *args)
