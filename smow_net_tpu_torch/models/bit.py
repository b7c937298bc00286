"""BIT, the bitemporal image transformer (port of
smow_net_tpu/models/zoo/bit.py; reference compare/BIT.py:92-229, recipe
train.py:93-94: token_len 4, 4 ResNet stages, learned position embedding,
encoder depth 1, decoder depth 8, decoder dim_head 8).

A ResNet-18 whose layer3 loses its stride (the reference's dilation clamp,
nn/resnet.py) feeds, per image, a x2 nearest upsample and a 3x3 conv to 32
channels at stride 4; 4 semantic tokens an image, one transformer encoder
layer over the pair's 8 tokens, and 8 cross-attention decoder layers (one
set, applied to each image with its own tokens) refine the pixels; the
absolute difference, a x4 bilinear upsample and a two-conv classifier give
2-channel logits. Activations are NCHW; the transformers read (B, N, 32).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import BatchNorm2d, FeedForward, PreNorm, Residual, SelfAttentionBlock
from ..nn.resnet import WIDTHS, resnet18_config
from ..ops.resize import resize_linear, resize_nearest

__all__ = ["BIT", "BITCrossAttention"]


class BITCrossAttention(nn.Module):
    """compare/BIT.py:633-680: separate q, k, v projections, logits scaled
    by dim^-0.5, an output projection."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__()
        self.heads, self.dim_head, self.scale = heads, dim_head, dim ** -0.5
        inner = heads * dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        def split(t):
            return t.reshape(t.shape[0], t.shape[1], self.heads, self.dim_head).transpose(1, 2)

        q, k, v = split(self.to_q(x)), split(self.to_k(m)), split(self.to_v(m))
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.scale, dim=-1)
        out = (attn @ v).transpose(1, 2)
        return self.to_out(out.reshape(x.shape[0], x.shape[1], -1))


class _Stack(nn.Module):
    """The reference's `layers` key level: per layer a Residual(PreNorm(
    attention)) and a Residual(PreNorm(FeedForward))."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(nn.ModuleList([Residual(PreNorm(dim, attn)),
                                                   Residual(PreNorm(dim, FeedForward(dim, mlp)))])
                                    for dim, attn, mlp in layers)


class BIT(nn.Module):
    """forward(x1, x2), (B, 3, H, W) each with H and W multiples of 8 ->
    2-channel logits (B, output_nc, H, W)."""

    def __init__(self, input_nc: int = 3, output_nc: int = 2, token_len: int = 4,
                 resnet_stages_num: int = 4, with_pos: str = "learned", enc_depth: int = 1,
                 dec_depth: int = 8, dim_head: int = 64, decoder_dim_head: int = 8,
                 heads: int = 8):
        super().__init__()
        dim, mlp_dim = 32, 64
        n_stages = resnet_stages_num - 1           # stages_num counts the stem
        self.token_len = token_len
        self.resnet = resnet18_config(replace_stride_with_dilation=(False, True, True),
                                      num_stages=n_stages, in_ch=input_nc)
        self.conv_pred = nn.Conv2d(WIDTHS[n_stages - 1], 32, 3, 1, 1)
        self.conv_a = nn.Conv2d(32, token_len, 1, bias=False)
        self.pos_embedding = (nn.Parameter(torch.randn(1, 2 * token_len, dim))
                              if with_pos == "learned" else None)
        self.transformer = _Stack([(dim, SelfAttentionBlock(dim, heads, dim_head, scale_by_dim=True),
                                    mlp_dim) for _ in range(enc_depth)])
        self.transformer_decoder = _Stack([(dim, BITCrossAttention(dim, heads, decoder_dim_head),
                                            mlp_dim) for _ in range(dec_depth)])
        self.classifier = nn.Sequential(nn.Conv2d(32, 32, 3, 1, 1, bias=False), BatchNorm2d(32),
                                        nn.ReLU(), nn.Conv2d(32, output_nc, 3, 1, 1))

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        y = self.resnet(x)[-1]
        return self.conv_pred(resize_nearest(y, (y.shape[2] * 2, y.shape[3] * 2)))

    def _tokens(self, f: torch.Tensor) -> torch.Tensor:
        B, C, H, W = f.shape
        att = torch.softmax(self.conv_a(f).reshape(B, self.token_len, H * W), dim=-1)
        return att @ f.reshape(B, C, H * W).transpose(1, 2)

    def _decode(self, f: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        B, C, H, W = f.shape
        q = f.reshape(B, C, H * W).transpose(1, 2)
        for attn, ff in self.transformer_decoder.layers:
            norm = attn.fn.norm
            q = attn.fn.fn(norm(q), norm(m)) + q
            q = ff.fn(q) + q
        return q.transpose(1, 2).reshape(B, C, H, W)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        f1, f2 = self._features(x1), self._features(x2)
        tt = torch.cat([self._tokens(f1), self._tokens(f2)], dim=1)
        if self.pos_embedding is not None:
            tt = tt + self.pos_embedding
        for attn, ff in self.transformer.layers:
            tt = attn.fn(tt) + tt
            tt = ff.fn(tt) + tt
        t1, t2 = tt.chunk(2, dim=1)
        y = torch.abs(self._decode(f1, t1) - self._decode(f2, t2))
        y = resize_linear(y, (y.shape[2] * 4, y.shape[3] * 4))
        return self.classifier(y)
