"""RS-Mamba (RSM_CD): an encoder of 8-direction VSS blocks and a
concat-fuse, nearest-upsampling decoder (port of
smow_net_tpu/models/zoo/rs_mamba.py `RSMCD`; the reference's recipe: depths
(2, 2, 9, 2), dims 96..768, drop path 0.2, d_state 16, ssm_ratio 2,
mlp_ratio 4, K = 8, patch embed v2, downsample v3).

The encoder runs once over the 2B-stacked pair (exact: it has only
LayerNorms), so DropPath draws one (2B,) mask per call. Each stage after the
first starts with its downsample (3x3 stride-2 conv, LayerNorm). Each
scale's pre and post features are fused by a 1x1 conv + BN + ReLU; the
decoder goes up by nearest 2x resizes, each followed by a concat with the
next fused scale and a 1x1 conv + BN + ReLU; a x4 head (two 3x3 conv + BN +
ReLU, each followed by a corner-aligned bilinear 2x resize) and a 7x7 conv
give the 2-class logits.

Images are NCHW; the encoder works channels-last. Submodule names give the
reference's state_dict keys (zoo_specs "rs_mamba"): `patch_embed.{0,2,5,7}`,
`encoder_block{i}.blocks.{j}`, `encoder_block{i}.downsample.{1,3}` (i = 2,
3, 4), `fuse_block{i}.fuse.{0,1}`, `deocder_block{i}.fuse.{0,1}` (the
reference's spelling), `upsample_x4.{0,1,4,5}`, `conv_out_change`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn.layers import BatchNorm2d
from ..nn.ssm import Permute, VSSBlock
from ..ops.resize import resize_linear, resize_nearest

__all__ = ["RSMCD"]


class _EncoderBlock(nn.Module):
    def __init__(self, blocks: nn.Module, downsample: nn.Module):
        super().__init__()
        self.downsample, self.blocks = downsample, blocks

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.downsample(x))


class _Fuse(nn.Module):
    """1x1 conv (no bias) + BN + ReLU in the reference's `fuse` Sequential."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.fuse = nn.Sequential(nn.Conv2d(cin, cout, 1, bias=False), BatchNorm2d(cout),
                                  nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fuse(x)


class _Up2(nn.Module):
    """Corner-aligned bilinear 2x resize (the x4 head's upsampling)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_linear(x, (2 * x.shape[2], 2 * x.shape[3]), align_corners=True)


class RSMCD(nn.Module):
    def __init__(self, depths=(2, 2, 9, 2), dims=(96, 192, 384, 768),
                 drop_path_rate: float = 0.2, ssm_d_state: int = 16, ssm_ratio: float = 2.0,
                 mlp_ratio: float = 4.0, use_checkpoint: bool = False):
        super().__init__()
        d0 = dims[0]
        self.patch_embed = nn.Sequential(
            nn.Conv2d(3, d0 // 2, 3, 2, 1), Permute(0, 2, 3, 1),
            nn.LayerNorm(d0 // 2, eps=1e-5), Permute(0, 3, 1, 2), nn.GELU(),
            nn.Conv2d(d0 // 2, d0, 3, 2, 1), Permute(0, 2, 3, 1), nn.LayerNorm(d0, eps=1e-5))
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        cur = 0
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            blocks = nn.Sequential(*[
                VSSBlock(dim, float(dpr[cur + j]), ssm_d_state, ssm_ratio, mlp_ratio=mlp_ratio,
                         k_group=8, remat=use_checkpoint)
                for j in range(depth)])
            cur += depth
            down = nn.Identity() if i == 0 else nn.Sequential(
                Permute(0, 3, 1, 2), nn.Conv2d(dims[i - 1], dim, 3, 2, 1), Permute(0, 2, 3, 1),
                nn.LayerNorm(dim, eps=1e-5))
            self.add_module(f"encoder_block{i + 1}", _EncoderBlock(blocks, down))
        for i, dim in enumerate(dims):
            self.add_module(f"fuse_block{i + 1}", _Fuse(2 * dim, dim))
        for i in range(len(dims) - 1):
            self.add_module(f"deocder_block{i + 1}", _Fuse(dims[i + 1] + dims[i], dims[i]))
        self.upsample_x4 = nn.Sequential(
            nn.Conv2d(d0, d0 // 2, 3, 1, 1), BatchNorm2d(d0 // 2), nn.ReLU(), _Up2(),
            nn.Conv2d(d0 // 2, 8, 3, 1, 1), BatchNorm2d(8), nn.ReLU(), _Up2())
        self.conv_out_change = nn.Conv2d(8, 2, 7, 1, 3)
        self.stages = len(dims)

    def encode(self, x: torch.Tensor):
        """(N, 3, H, W) -> each stage's features, channels-last."""
        x = self.patch_embed(x)
        feats = []
        for i in range(self.stages):
            x = getattr(self, f"encoder_block{i + 1}")(x)
            feats.append(x)
        return feats

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """x1, x2 (B, 3, H, W) -> change logits (B, 2, H, W)."""
        B = x1.shape[0]
        feats = [f.permute(0, 3, 1, 2) for f in self.encode(torch.cat([x1, x2], dim=0))]
        fs = [getattr(self, f"fuse_block{i + 1}")(torch.cat([f[:B], f[B:]], dim=1))
              for i, f in enumerate(feats)]
        y = fs[-1]
        for i in reversed(range(self.stages - 1)):
            up = resize_nearest(y, (2 * y.shape[2], 2 * y.shape[3]))
            y = getattr(self, f"deocder_block{i + 1}")(torch.cat([up, fs[i]], dim=1))
        return self.conv_out_change(self.upsample_x4(y))
