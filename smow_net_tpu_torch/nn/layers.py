"""Transformer building blocks of SMOW_Net (port of smow_net_tpu/nn/layers.py).

Module nesting follows the reference so `state_dict()` keys are the
reference's (models/SMOW_Net.py:193-303): a PreNorm holds `norm` and `fn`,
attention projections are `to_qkv` / `to_q`, `to_k`, `to_v` and `to_out.0`,
the MLP is `net.0` / `net.3`. LayerNorm eps 1e-5, exact (erf) GELU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import xattn

__all__ = ["BatchNorm2d", "BatchNorm3d", "PreNorm", "Residual", "SelfAttentionBlock",
           "FeedForward", "TransformerLayer", "CrossAttentionBlock", "CrossTransformerLayer"]


class _FlaxBatchNorm:
    """BatchNorm with flax's train-mode semantics (the JAX package's
    `batch_norm`, nn/layers.py:154; momentum 0.9 there is torch's 0.1, eps
    1e-5), over every axis but the channels. In train mode it normalises
    with the biased batch statistics and moves the running statistics toward
    the batch mean and the BIASED batch variance E[x^2] - E[x]^2, both taken
    in fp32 (for bf16 input too); torch's own BatchNorm moves running_var
    toward the unbiased variance. With one value per channel (a 1x1 map at
    batch 1) the variance is 0, as in flax, where F.batch_norm would raise.
    Eval mode and the state_dict keys are torch's. Mixed into torch's
    BatchNorm2d and BatchNorm3d below."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = (0,) + tuple(range(2, x.dim()))
        stat = torch.promote_types(x.dtype, torch.float32)
        with torch.no_grad():
            mean = x.mean(dim=dims, dtype=stat)
            sq = torch.linalg.vector_norm(x, dim=dims, dtype=stat).square()
            var = (sq / (x.numel() // x.shape[1]) - mean.square()).clamp_min(0.0)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
            self.num_batches_tracked += 1
        if x.numel() // x.shape[1] == 1:
            # one value per channel: F.batch_norm raises, flax's variance is 0
            shape = (1, -1) + (1,) * (x.dim() - 2)
            xf = x.float()
            y = (xf - xf.mean(dim=dims, keepdim=True)) * self.eps ** -0.5
            return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    """Flax-semantics BatchNorm over (B, H, W) (MobileNetV2's)."""


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    """Flax-semantics BatchNorm over (B, T, H, W)."""


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class Residual(nn.Module):
    """The reference's Residual wrapper, kept for its `fn` key level; the
    decoder layer that holds it runs as one op."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


class SelfAttentionBlock(nn.Module):
    """Multi-head self-attention with an output projection. The SMOW
    flavour (models/SMOW_Net.py:222-251) scales the logits by dim_head^-0.5;
    BIT's (compare/BIT.py:685-717) passes `scale_by_dim` for dim^-0.5."""

    def __init__(self, dim: int, heads: int, dim_head: int, scale_by_dim: bool = False):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.scale = (dim if scale_by_dim else dim_head) ** -0.5
        inner = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.scale, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        return self.to_out(out)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0),
                                 nn.Linear(hidden, dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class TransformerLayer(nn.Module):
    """PreNorm(attn) + x; PreNorm(ff) + x (reference Transformer,
    models/SMOW_Net.py:193-208)."""

    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([
            PreNorm(dim, SelfAttentionBlock(dim, heads, dim_head)),
            PreNorm(dim, FeedForward(dim, mlp_dim))])])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        return x


class CrossAttentionBlock(nn.Module):
    """Parameters of the reference Cross_Attention with per-head dim 1
    (models/SMOW_Net.py:337-381). The layer below runs them through
    ops.xattn.cross_layer_head1."""

    def __init__(self, dim: int, heads: int, m_dim: int):
        super().__init__()
        self.to_q = nn.Linear(dim, heads, bias=False)
        self.to_k = nn.Linear(m_dim, heads, bias=False)
        self.to_v = nn.Linear(m_dim, heads, bias=False)
        self.to_out = nn.Sequential(nn.Linear(heads, dim))


class CrossTransformerLayer(nn.Module):
    """Reference TransformerDecoder layer with dim_head=1
    (models/SMOW_Net.py:285-303): one shared LayerNorm (norm1) normalizes
    the queries and the memory; then cross-attention + residual and the
    PreNorm MLP + residual, the whole layer as one op."""

    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.dim = dim
        self.layers = nn.ModuleList([nn.ModuleList([
            Residual(PreNorm(dim, CrossAttentionBlock(dim, heads, dim))),
            Residual(PreNorm(dim, FeedForward(dim, mlp_dim)))])])

    def forward(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """x (B, N, dim) queries, m (B, M, dim) memory tokens."""
        attn_block, ff_block = self.layers[0]
        norm1, attn = attn_block.fn.norm, attn_block.fn.fn
        norm2, ff = ff_block.fn.norm, ff_block.fn.fn
        m_n = xattn.layer_norm32(m, norm1.weight, norm1.bias, norm1.eps).to(m.dtype)
        return xattn.cross_layer_head1(
            x, norm1.weight, norm1.bias, attn.to_q.weight.t(),
            attn.to_k(m_n), attn.to_v(m_n),
            attn.to_out[0].weight.t(), attn.to_out[0].bias,
            norm2.weight, norm2.bias, ff.net[0].weight.t(), ff.net[0].bias,
            ff.net[3].weight.t(), ff.net[3].bias,
            scale=self.dim ** -0.5, eps=norm1.eps)
