"""ChangeMamba: a siamese VSSM encoder and a spatio-temporal VSS decoder
(port of smow_net_tpu/models/zoo/change_mamba.py; the reference's
ChangeMambaBCD with depths (2, 2, 9, 2), dims 96..768, d_state 16,
ssm_ratio 2, forward type v2, mlp_ratio 4, drop path 0.1). With
`use_checkpoint` every SS2D, the encoder's and the STBlocks', is recomputed
in the backward (the reference's use_checkpoint).

The encoder runs once over the 2B-stacked pair (exact: the VSSM has no
batch statistics). Each decoder level runs three STBlocks (1x1 conv then a
VSSBlock) over the pre/post features joined three ways: channel-concat,
column-interleaved (width 2W) and side by side (width 2W); five maps cut
back from them are fused by a 1x1 conv + BN + ReLU; an FPN of bilinear
upsample-adds and ResBlocks goes up to stride 4, then the 2-class head and
a bilinear resize to the input size.

Images are NCHW; the decoder works in NCHW like the reference (its VSSBlocks
permute to channels-last inside `st_block_*`). Submodule names give the
reference's state_dict keys (`encoder.*`, `decoder.st_block_{ij}.{0,2}`,
`decoder.fuse_layer_{i}.{0,1}`, `decoder.smooth_layer_{i}.*`, `main_clf`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm2d
from ..nn.ssm import VSSM, Permute, VSSBlock
from ..ops.resize import resize_linear

__all__ = ["ChangeMamba", "ResBlock", "STBlock"]


class ResBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + x)


class STBlock(nn.Sequential):
    """1x1 conv to 128 channels, then a VSSBlock (drop path 0.1; its SS2D
    recomputed in the backward with `remat`)."""

    def __init__(self, in_ch: int, remat: bool = False):
        super().__init__(nn.Conv2d(in_ch, 128, 1), Permute(0, 2, 3, 1),
                         VSSBlock(128, 0.1, remat=remat), Permute(0, 3, 1, 2))


class ChangeDecoder(nn.Module):
    def __init__(self, dims, remat: bool = False):
        super().__init__()
        for i, dim in zip((1, 2, 3, 4), dims):
            for j, in_ch in ((1, 2 * dim), (2, dim), (3, dim)):
                self.add_module(f"st_block_{i}{j}", STBlock(in_ch, remat))
            self.add_module(f"fuse_layer_{i}", nn.Sequential(
                nn.Conv2d(5 * 128, 128, 1), BatchNorm2d(128), nn.ReLU()))
        for i in (1, 2, 3):
            self.add_module(f"smooth_layer_{i}", ResBlock(128))

    def level(self, i: int, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        B, C, H, W = a.shape
        block = lambda j: getattr(self, f"st_block_{i}{j}")
        p1 = block(1)(torch.cat([a, b], dim=1))
        p2 = block(2)(torch.stack([a, b], dim=4).reshape(B, C, H, 2 * W))
        p3 = block(3)(torch.cat([a, b], dim=3))
        parts = [p1, p2[..., ::2], p2[..., 1::2], p3[..., :W], p3[..., W:]]
        return getattr(self, f"fuse_layer_{i}")(torch.cat(parts, dim=1))

    def forward(self, f_pre, f_post) -> torch.Tensor:
        p = [self.level(i, a, b) for i, a, b in zip((1, 2, 3, 4), f_pre, f_post)]
        y = p[3]
        for i in (3, 2, 1):
            y = resize_linear(y, p[i - 1].shape[2:]) + p[i - 1]
            y = getattr(self, f"smooth_layer_{i}")(y)
        return y


class ChangeMamba(nn.Module):
    def __init__(self, depths=(2, 2, 9, 2), dims=(96, 192, 384, 768),
                 drop_path_rate: float = 0.1, use_checkpoint: bool = False):
        super().__init__()
        self.encoder = VSSM(depths, dims, drop_path_rate, use_checkpoint=use_checkpoint)
        self.decoder = ChangeDecoder(dims, use_checkpoint)
        self.main_clf = nn.Conv2d(128, 2, 1)

    def forward(self, pre: torch.Tensor, post: torch.Tensor) -> torch.Tensor:
        """pre, post (B, 3, H, W) -> change logits (B, 2, H, W)."""
        B = pre.shape[0]
        feats = [f.permute(0, 3, 1, 2) for f in self.encoder(torch.cat([pre, post], dim=0))]
        y = self.decoder([f[:B] for f in feats], [f[B:] for f in feats])
        return resize_linear(self.main_clf(y), pre.shape[2:])
