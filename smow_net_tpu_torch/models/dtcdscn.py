"""DTCDSCN, the dual-task change-detection network: a siamese SE-ResNet-34
encoder, a dilated center block and SCSE decoder blocks on the difference
path (port of smow_net_tpu/models/zoo/dtcdscn.py; reference
compare/DTCDSCN.py:168-300). Only the reference's active "master"
difference path is wired; its per-image decoders (`decoder1-4`, `dblock`,
`finaldeconv1`, `finalconv2/3`) are dead code and left out, as in the JAX
package. Activations are NCHW; the output is 1-channel probabilities.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import BatchNorm2d
from ..ops.pooling import adaptive_avg_pool, max_pool

__all__ = ["DTCDSCN", "SELayer", "SEBasicBlock", "Dblock", "SCSEBlock", "DecoderBlock"]


class SELayer(nn.Module):
    """Squeeze-and-excitation: the global mean through a bias-free MLP."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(c, c // reduction, bias=False), nn.ReLU(),
                                nn.Linear(c // reduction, c, bias=False), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(adaptive_avg_pool(x, 1).flatten(1))[:, :, None, None]


class SEBasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.se = SELayer(planes)
        self.downsample = None
        if stride != 1 or in_ch != planes:
            self.downsample = nn.Sequential(nn.Conv2d(in_ch, planes, 1, stride, bias=False),
                                            BatchNorm2d(planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.se(self.bn2(self.conv2(y)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(y + residual)


class Dblock(nn.Module):
    """Chained dilated 3x3 convs (dilations 1, 2, 4, 8) with ReLU, every
    output added to the input (compare/DTCDSCN.py:49-69)."""

    def __init__(self, c: int):
        super().__init__()
        for i, d in enumerate((1, 2, 4, 8), 1):
            setattr(self, f"dilate{i}", nn.Conv2d(c, c, 3, 1, d, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = y = x
        for i in range(1, 5):
            y = torch.relu(getattr(self, f"dilate{i}")(y))
            out = out + y
        return out


class SCSEBlock(nn.Module):
    """Concurrent channel and spatial squeeze-and-excitation:
    x * channel gate + x * spatial gate."""

    def __init__(self, c: int, reduction: int = 16):
        super().__init__()
        self.channel_excitation = nn.Sequential(nn.Conv2d(c, c // reduction, 1, bias=False),
                                                nn.ReLU(),
                                                nn.Conv2d(c // reduction, c, 1, bias=False))
        self.spatial_se = nn.Sequential(nn.Conv2d(c, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        chn = torch.sigmoid(self.channel_excitation(adaptive_avg_pool(x, 1)))
        spa = torch.sigmoid(self.spatial_se(x))
        return x * chn + x * spa


class DecoderBlock(nn.Module):
    """1x1 conv to a quarter of the channels, BN, ReLU, + SCSE, a stride-2
    3x3 transposed conv, BN, ReLU, 1x1 conv to n_filters, BN, ReLU."""

    def __init__(self, in_ch: int, n_filters: int):
        super().__init__()
        c4 = in_ch // 4
        self.conv1 = nn.Conv2d(in_ch, c4, 1)
        self.norm1 = BatchNorm2d(c4)
        self.scse = SCSEBlock(c4)
        self.deconv2 = nn.ConvTranspose2d(c4, c4, 3, 2, 1, output_padding=1)
        self.norm2 = BatchNorm2d(c4)
        self.conv3 = nn.Conv2d(c4, n_filters, 1)
        self.norm3 = BatchNorm2d(n_filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = y + self.scse(y)
        y = torch.relu(self.norm2(self.deconv2(y)))
        return torch.relu(self.norm3(self.conv3(y)))


class DTCDSCN(nn.Module):
    """forward(xa, xb), (B, in_channels, H, W) each with H and W multiples
    of 32 -> change probabilities (B, num_classes, H, W)."""

    def __init__(self, in_channels: int = 3, layers=(3, 4, 6, 3), num_classes: int = 1):
        super().__init__()
        self.firstconv = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.firstbn = BatchNorm2d(64)
        c = 64
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stage = []
            for j in range(blocks):
                stage.append(SEBasicBlock(c, planes, 2 if (i > 0 and j == 0) else 1))
                c = planes
            setattr(self, f"encoder{i + 1}", nn.Sequential(*stage))
        self.dblock_master = Dblock(512)
        self.decoder4_master = DecoderBlock(512, 256)
        self.decoder3_master = DecoderBlock(256, 128)
        self.decoder2_master = DecoderBlock(128, 64)
        self.decoder1_master = DecoderBlock(64, 64)
        self.finaldeconv1_master = nn.ConvTranspose2d(64, 32, 4, 2, 1)
        self.finalconv2_master = nn.Conv2d(32, 32, 3, 1, 1)
        self.finalconv3_master = nn.Conv2d(32, num_classes, 3, 1, 1)

    def _encode(self, x: torch.Tensor):
        y = max_pool(torch.relu(self.firstbn(self.firstconv(x))), 3, 2, 1)
        feats = []
        for i in range(1, 5):
            y = getattr(self, f"encoder{i}")(y)
            feats.append(y)
        return feats

    def forward(self, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        e1x, e2x, e3x, e4x = self._encode(xa)
        e1y, e2y, e3y, e4y = self._encode(xb)
        e4 = self.dblock_master(e4x - e4y)
        d4 = self.decoder4_master(e4) + e3x - e3y
        d3 = self.decoder3_master(d4) + e2x - e2y
        d2 = self.decoder2_master(d3) + e1x - e1y
        d1 = self.decoder1_master(d2)
        out = torch.relu(self.finaldeconv1_master(d1))
        out = torch.relu(self.finalconv2_master(out))
        return torch.sigmoid(self.finalconv3_master(out))
