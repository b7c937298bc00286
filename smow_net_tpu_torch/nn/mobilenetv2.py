"""MobileNetV2 feature backbone of SMOW_Net_LW (port of
smow_net_tpu/nn/mobilenetv2.py; reference models/SMOW_Net_LW.py:526-579).

torchvision's module layout, so the keys are the ones the JAX package's
loader reads (smow_net_tpu/train/convert.py `load_mobilenet_v2`):
`features.0` and `features.18` are conv / BN / ReLU6 triples (`.0`, `.1`),
`features.{1..17}.conv` the inverted residuals' [expand,] depthwise,
project-conv and project-BN layers. BatchNorms have flax's train-mode
statistics (nn/layers.py). The forward returns the taps after blocks 1, 3,
6, 13 and 17: 16 channels at /2, 24 at /4, 32 at /8, 96 at /16, 320 at /32.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm2d

__all__ = ["ConvBNReLU6", "InvertedResidual", "MobileNetV2"]

# (expand t, out c, repeats n, stride s)
_SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
_TAPS = (1, 3, 6, 13, 17)


class ConvBNReLU6(nn.Sequential):
    """Bias-free conv, BN, ReLU6, with 'same' padding for odd kernels."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1):
        super().__init__(
            nn.Conv2d(in_ch, out_ch, kernel, stride, (kernel - 1) // 2, groups=groups,
                      bias=False),
            BatchNorm2d(out_ch), nn.ReLU6())


class InvertedResidual(nn.Module):
    """1x1 expand (when expand != 1), 3x3 depthwise, 1x1 project + BN; the
    input is added back when the stride is 1 and the width is kept."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int):
        super().__init__()
        hidden = int(round(in_ch * expand))
        self.use_res = stride == 1 and in_ch == out_ch
        layers = [ConvBNReLU6(in_ch, hidden, 1)] if expand != 1 else []
        layers += [ConvBNReLU6(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, out_ch, 1, bias=False), BatchNorm2d(out_ch)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return x + y if self.use_res else y


class MobileNetV2(nn.Module):
    """forward((B, 3, H, W)) -> the five taps. `features.18` (1280 channels)
    feeds no tap; it runs in train mode only, where its BatchNorm statistics
    move as the JAX package's do (in eval it has no effect)."""

    def __init__(self):
        super().__init__()
        layers, in_ch = [ConvBNReLU6(3, 32, 3, 2)], 32
        for t, c, n, s in _SETTINGS:
            for i in range(n):
                layers.append(InvertedResidual(in_ch, c, s if i == 0 else 1, t))
                in_ch = c
        layers.append(ConvBNReLU6(in_ch, 1280, 1))
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor):
        taps = []
        for i, layer in enumerate(self.features[:-1]):
            x = layer(x)
            if i in _TAPS:
                taps.append(x)
        if self.training:
            self.features[-1](x)
        return taps
