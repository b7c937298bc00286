"""PA-Former: a prior-attention token transformer over a DeepLab-style
ResNet-18 (port of smow_net_tpu/models/zoo/pa_former.py; reference
compare/PA_Former.py:544-571, modules :9-235, PriorInterpreter :235-273,
the ResNet variant :399-520).

Each image goes through the backbone on its own (its BatchNorms see one
image's batch, as in the reference): a ResNet-18 at output stride 16 whose
layer4 is a multi-grid unit (dilations 2, 4, 8), four 1x1 heads at stride
4, and the PriorInterpreter, which warps the stride-4 stem map by a learned
flow (kernel A-fwd, A-bwd in training: zeros padding, align_corners=False,
on an unclamped grid). A token encoder pools each warped map into 8 tokens;
the pair's tokens, side by side, are the memory of one dim_head=1 decoder
layer over the stride-4 pixels (kernel F, F-bwd in training); a 1x1 conv
and the reference's sub-pixel shuffle give 2-channel logits at input size.

Activations are NCHW, except the warp and the token encoder, which read
the stride-4 map channels-last as the JAX package's ops do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm2d, CrossTransformerLayer, TransformerLayer
from ..nn.resnet import BasicBlock
from ..ops import warp
from ..ops.pixel_shuffle import smow_shuffle
from ..ops.pooling import max_pool
from ..ops.resize import resize_linear

__all__ = ["PAFormer", "PABackbone", "PriorInterpreter", "TokenEncoder"]


class PriorInterpreter(nn.Module):
    """Depthwise strided context and a flow warp (compare/PA_Former.py:
    235-273): three k3 s2 UNPADDED depthwise convs with BN and ReLU, resized
    back (bilinear, align_corners=True), a 3x3 conv of [x, context] to a
    flow, and x sampled at the identity grid plus flow / (W, H), NOT
    clamped, with torch grid_sample's defaults (zeros padding,
    align_corners=False). Returns the warped map channels-last."""

    def __init__(self, inplane: int):
        super().__init__()
        layers = []
        for _ in range(3):
            layers += [nn.Conv2d(inplane, inplane, 3, 2, 0, groups=inplane),
                       BatchNorm2d(inplane), nn.ReLU()]
        self.down = nn.Sequential(*layers)
        self.flow_make = nn.Conv2d(2 * inplane, 2, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, H, W) -> (B, H, W, C)."""
        H, W = x.shape[-2:]
        y = resize_linear(self.down(x), (H, W), align_corners=True)
        flow = self.flow_make(torch.cat([x, y], dim=1)).permute(0, 2, 3, 1)
        return warp.bilinear_warp(x.permute(0, 2, 3, 1), warp.offset_grid(flow, H, W),
                                  padding_mode="zeros", align_corners=False)


class PABackbone(nn.Module):
    """DeepLab ResNet-18 at output stride 16 (compare/PA_Former.py:400-516):
    stages of strides (1, 2, 2), then layer4's three blocks at stride 1 and
    dilations (2, 4, 8). forward(x) -> (the PriorInterpreter's warped stem
    map (B, H/4, W/4, f_c), the four 1x1 heads (B, f_c, H/4, W/4))."""

    def __init__(self, f_c: int = 64):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        c = 64
        for li, (planes, stride) in enumerate(((64, 1), (128, 2), (256, 2))):
            blocks = [BasicBlock(c, planes, stride), BasicBlock(planes, planes)]
            setattr(self, f"layer{li + 1}", nn.Sequential(*blocks))
            c = planes
        # DeepLab's blocks: the first conv dilated (nn/resnet.py BasicBlock)
        self.layer4 = nn.Sequential(*[BasicBlock(256 if j == 0 else 512, 512, 1, 2 * mg)
                                      for j, mg in enumerate((1, 2, 4))])
        q = f_c // 4
        self.last_conv = nn.Sequential(nn.Conv2d(512, q, 1))
        self.last_conv2 = nn.Sequential(nn.Conv2d(64, q, 1))
        self.last_conv3 = nn.Sequential(nn.Conv2d(128, q, 1))
        self.last_conv4 = nn.Sequential(nn.Conv2d(256, q, 1))
        self.PI = PriorInterpreter(f_c)

    def forward(self, x: torch.Tensor):
        low = max_pool(torch.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x2 = self.layer1(low)
        x3 = self.layer2(x2)
        x4 = self.layer3(x3)
        y = self.layer4(x4)
        size = low.shape[-2:]
        up = lambda v: resize_linear(v, size, align_corners=True)  # noqa: E731
        y, x3u, x4u = up(y), up(x3), up(x4)
        heads = torch.cat([self.last_conv2(x2), self.last_conv3(x3u), self.last_conv4(x4u),
                           self.last_conv(y)], dim=1)
        return self.PI(low), heads


class TokenEncoder(nn.Module):
    """compare/PA_Former.py:35-54: a softmax over the pixels of `token_len`
    1x1-conv logits pools the map into tokens, plus a learned position
    embedding, then one PreNorm self-attention layer (SMOW flavour)."""

    def __init__(self, in_chan: int = 64, token_len: int = 8, heads: int = 8):
        super().__init__()
        self.token_len = token_len
        self.pos_embedding = nn.Parameter(torch.randn(1, token_len, in_chan))
        self.conv_a = nn.Conv2d(in_chan, token_len, 1)
        self.transformer = TransformerLayer(in_chan, heads, 64, 64)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) channels-last -> (B, token_len, C)."""
        B, H, W, C = x.shape
        rows = x.reshape(B, H * W, C)
        att = F.linear(rows, self.conv_a.weight.flatten(1), self.conv_a.bias)
        att = torch.softmax(att.transpose(1, 2), dim=-1)
        return self.transformer(att @ rows + self.pos_embedding)


class _TokenDecoder(nn.Module):
    """The reference's key level `token_decoder.transformer_decoder`."""

    def __init__(self, dim: int, heads: int, mlp_dim: int):
        super().__init__()
        self.transformer_decoder = CrossTransformerLayer(dim, heads, mlp_dim)


class _Decoder(nn.Module):
    """The reference's head, `decoder.conv1`: a bias-free 1x1 conv."""

    def __init__(self, in_chan: int, out_chan: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chan, out_chan, 1, bias=False)


class PAFormer(nn.Module):
    """forward(img1, img2), (B, 3, H, W) each with H and W multiples of 16
    and at least 64 (the PriorInterpreter's three unpadded stride-2 convs)
    -> 2-channel logits (B, 2, H, W)."""

    def __init__(self, n_class: int = 2, f_c: int = 64):
        super().__init__()
        self.PriorFExtractor = PABackbone(f_c)
        self.token_encoder = TokenEncoder(f_c)
        self.token_decoder = _TokenDecoder(2 * f_c, 8, 4 * f_c)
        self.decoder = _Decoder(2 * f_c, n_class * 16)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        body1, s1 = self.PriorFExtractor(img1)
        body2, s2 = self.PriorFExtractor(img2)
        memory = torch.cat([self.token_encoder(body1), self.token_encoder(body2)], dim=-1)
        x16 = torch.cat([s1, s2], dim=1)
        B, C, H, W = x16.shape
        q = x16.flatten(2).transpose(1, 2).contiguous()
        q = self.token_decoder.transformer_decoder(q, memory)
        y = F.linear(q, self.decoder.conv1.weight.flatten(1))
        return smow_shuffle(y.reshape(B, H, W, -1), 4).permute(0, 3, 1, 2)
