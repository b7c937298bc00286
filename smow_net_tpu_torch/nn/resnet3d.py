"""Inflated (decomposed) 3D ResNet-18 encoder (port of
smow_net_tpu/nn/resnet3d.py, reference models/SMOW_Net.py:426-585).

Every 2D conv of ResNet-18 becomes a spatial (1, k, k) Conv3d plus three
1x1x1 temporal mixers over the T=2 frames, initialised so the block starts
temporally identity (time_2 = eye, time_1 = time_3 = 0). Activations are
NCDHW with D = T = 2; BatchNorm3d (flax train-mode statistics, nn/layers.py)
pools statistics over (B, T, H, W).
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm3d

__all__ = ["DecomposedConv3d", "BasicBlock3d", "ResNet3D"]


class DecomposedConv3d(nn.Module):
    """Spatial conv over each frame + cyclic temporal 1x1x1 mix for T=2
    (reference Decompose_conv): frame1 = time_2(F1) + time_3(F2),
    frame2 = time_1(F1) + time_2(F2)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        k, s, p = kernel_size, stride, padding
        self.conv3d_spatial = nn.Conv3d(in_ch, features, (1, k, k), (1, s, s),
                                        (0, p, p), bias=False)
        for i in (1, 2, 3):
            setattr(self, f"conv3d_time_{i}", nn.Conv3d(features, features, 1, bias=False))
        with torch.no_grad():
            nn.init.zeros_(self.conv3d_time_1.weight)
            nn.init.zeros_(self.conv3d_time_3.weight)
            self.conv3d_time_2.weight.copy_(
                torch.eye(features)[:, :, None, None, None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv3d_spatial(x)
        y_id = self.conv3d_time_2(y)
        f1 = y_id[:, :, 0:1] + self.conv3d_time_3(y[:, :, 1:2])
        f2 = self.conv3d_time_1(y[:, :, 0:1]) + y_id[:, :, 1:2]
        return torch.cat([f1, f2], dim=2)


class BasicBlock3d(nn.Module):
    """ResNet-18 BasicBlock, decomposed (reference Bottleneck3d)."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = DecomposedConv3d(in_ch, features, 3, stride, 1)
        self.bn1 = BatchNorm3d(features)
        self.conv2 = DecomposedConv3d(features, features, 3, 1, 1)
        self.bn2 = BatchNorm3d(features)
        self.downsample = None
        if stride != 1 or in_ch != features:
            self.downsample = nn.Sequential(
                nn.Conv3d(in_ch, features, 1, (1, stride, stride), bias=False),
                BatchNorm3d(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class ResNet3D(nn.Module):
    """Stem (7x7 s2 decomposed conv + BN + ReLU), max-pool, then 4 stages of
    2 BasicBlocks at widths 64/128/256/512 with strides 1/2/2/2.

    forward((B, 3, 2, H, W)) -> (stem output, [stage1..stage4 outputs])."""

    def __init__(self, widths=(64, 128, 256, 512), blocks_per_stage: int = 2):
        super().__init__()
        self.conv1 = DecomposedConv3d(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm3d(64)
        in_ch = 64
        for i, w in enumerate(widths):
            blocks = []
            for j in range(blocks_per_stage):
                blocks.append(BasicBlock3d(in_ch, w, 2 if (i > 0 and j == 0) else 1))
                in_ch = w
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(widths)

    def forward(self, x: torch.Tensor):
        x0 = torch.relu(self.bn1(self.conv1(x)))
        y = nn.functional.max_pool3d(x0, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        feats = []
        for i in range(self.num_stages):
            y = getattr(self, f"layer{i + 1}")(y)
            feats.append(y)
        return x0, feats
