"""VGG-16 feature extractor in torchvision's layout (port of
smow_net_tpu/nn/vgg.py; reference compare/IFN.py:7-19). The convs keep
torchvision's `features.<index>` keys; the taps follow the ReLUs at
indices 3, 8, 15, 22 and 29: 64 @ /1, 128 @ /2, 256 @ /4, 512 @ /8 and
512 @ /16.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.pooling import max_pool

__all__ = ["VGG16Features"]

# (out_channels, n_convs) per stage; a tap after each stage's last ReLU
_STAGES = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


class VGG16Features(nn.Module):
    def __init__(self, in_ch: int = 3):
        super().__init__()
        self.features = nn.ModuleDict()
        self._plan = []             # per stage: the `features` indices of its convs
        idx, c = 0, in_ch
        for s, (width, n) in enumerate(_STAGES):
            if s > 0:
                idx += 1            # the max-pool's index
            convs = []
            for _ in range(n):
                self.features[str(idx)] = nn.Conv2d(c, width, 3, 1, 1)
                convs.append(str(idx))
                c, idx = width, idx + 2     # conv, ReLU
            self._plan.append(convs)

    def forward(self, x: torch.Tensor):
        feats = []
        for s, convs in enumerate(self._plan):
            if s > 0:
                x = max_pool(x, 2, 2)
            for name in convs:
                x = torch.relu(self.features[name](x))
            feats.append(x)
        return feats
