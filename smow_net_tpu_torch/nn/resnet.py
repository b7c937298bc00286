"""2D ResNet backbone in torchvision's layout, with feature taps (port of
smow_net_tpu/nn/resnet.py; the zoo models that vendor torchvision ResNets,
e.g. the reference's compare/BIT.py:340-573).

`forward` returns (c0 stem ReLU @ /2, c1 @ /4, c2 @ /8, c3 @ /16, c4 @ /32)
for the stages it builds. `replace_stride_with_dilation` mirrors
torchvision: such a stage keeps stride 1 where it would halve the map. The
reference's vendored BasicBlock then resets its dilation to 1 (compare/
BIT.py:260-262, the NotImplementedError commented out), so the stage only
loses its stride and never dilates; the port keeps that quirk, as the JAX
package does. BatchNorm has flax's train-mode statistics (nn/layers.py).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.pooling import max_pool
from .layers import BatchNorm2d

__all__ = ["WIDTHS", "BasicBlock", "ResNet", "resnet18_config", "resnet34_config"]


class BasicBlock(nn.Module):
    """conv3x3-BN-ReLU, conv3x3-BN, the identity or a 1x1 conv + BN, ReLU.
    `dilation` dilates (and pads) the first conv: PA-Former's DeepLab
    blocks; the ResNet below never passes it (the reference's clamp)."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 3, stride, dilation, dilation, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or in_ch != planes:
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, planes, 1, stride, bias=False),
                                            BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + identity)


WIDTHS = (64, 128, 256, 512)     # the stages' widths; the stem's is the first


class ResNet(nn.Module):
    """The stem (7x7 s2 conv, BN, ReLU, 3x3 s2 max-pool) and the first
    `num_stages` stages of `layers` BasicBlocks at WIDTHS."""

    def __init__(self, layers=(2, 2, 2, 2), replace_stride_with_dilation=(False, False, False),
                 num_stages: int = 4, in_ch: int = 3):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, WIDTHS[0], 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(WIDTHS[0])
        self.num_stages = num_stages
        c = WIDTHS[0]
        for i, (planes, blocks) in enumerate(zip(WIDTHS[:num_stages], layers)):
            stride = 1 if i == 0 or replace_stride_with_dilation[i - 1] else 2
            stage = []
            for j in range(blocks):
                stage.append(BasicBlock(c, planes, stride if j == 0 else 1))
                c = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*stage))

    def forward(self, x: torch.Tensor):
        c0 = torch.relu(self.bn1(self.conv1(x)))
        y = max_pool(c0, 3, 2, 1)
        feats = [c0]
        for i in range(self.num_stages):
            y = getattr(self, f"layer{i + 1}")(y)
            feats.append(y)
        return tuple(feats)


def resnet18_config(**kw) -> ResNet:
    return ResNet(layers=(2, 2, 2, 2), **kw)


def resnet34_config(**kw) -> ResNet:
    return ResNet(layers=(3, 4, 6, 3), replace_stride_with_dilation=(False, True, True), **kw)
