"""SNUNet-CD with ECAM: a siamese nested U-Net (UNet++) and an ensemble
channel-attention head (port of smow_net_tpu/models/zoo/snunet.py;
reference compare/SNUNet.py:60-148). Activations are NCHW.

The encoder runs image A through the four upper stages and image B through
all five (the reference's `x4_0` of A is never used); the nested decoder
joins both images' skips with stride-2 transposed-conv upsamplings, and
the four outputs of the top row are gated by two channel attentions.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import BatchNorm2d
from ..ops.pooling import adaptive_avg_pool, max_pool

__all__ = ["SNUNet", "ChannelAttention", "ConvBlockNested"]


class ConvBlockNested(nn.Module):
    """conv3x3 (its output the identity), BN, ReLU, conv3x3, BN, + identity,
    ReLU."""

    def __init__(self, in_ch: int, mid_ch: int, out_ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, mid_ch, 3, 1, 1)
        self.bn1 = BatchNorm2d(mid_ch)
        self.conv2 = nn.Conv2d(mid_ch, out_ch, 3, 1, 1)
        self.bn2 = BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = self.conv1(x)
        y = torch.relu(self.bn1(identity))
        return torch.relu(self.bn2(self.conv2(y)) + identity)


class ChannelAttention(nn.Module):
    """A sigmoid channel gate from the average- and max-pooled map through
    one shared bias-free 1x1-conv MLP (compare/SNUNet.py:43-56)."""

    def __init__(self, c: int, ratio: int = 16):
        super().__init__()
        self.fc1 = nn.Conv2d(c, c // ratio, 1, bias=False)
        self.fc2 = nn.Conv2d(c // ratio, c, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mlp = lambda v: self.fc2(torch.relu(self.fc1(v)))       # noqa: E731
        return torch.sigmoid(mlp(adaptive_avg_pool(x, 1))
                             + mlp(x.amax(dim=(2, 3), keepdim=True)))


class _Up(nn.Module):
    """The reference's `Up<i>_<j>.up`: a stride-2 2x2 transposed conv."""

    def __init__(self, c: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(c, c, 2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(x)


# nested block name -> (input channels in units of n1, output width in units of n1)
_BLOCKS = {"conv0_0": (0, 1), "conv1_0": (1, 2), "conv2_0": (2, 4), "conv3_0": (4, 8),
           "conv4_0": (8, 16), "conv0_1": (4, 1), "conv1_1": (8, 2), "conv0_2": (5, 1),
           "conv2_1": (16, 4), "conv1_2": (10, 2), "conv0_3": (6, 1), "conv3_1": (32, 8),
           "conv2_2": (20, 4), "conv1_3": (12, 2), "conv0_4": (7, 1)}
# upsampling name -> its width in units of n1
_UPS = {"Up1_0": 2, "Up2_0": 4, "Up1_1": 2, "Up3_0": 8, "Up2_1": 4, "Up1_2": 2, "Up4_0": 16,
        "Up3_1": 8, "Up2_2": 4, "Up1_3": 2}


class SNUNet(nn.Module):
    """forward(xa, xb), (B, in_ch, H, W) each with H and W multiples of 16
    -> logits (B, out_ch, H, W)."""

    def __init__(self, in_ch: int = 3, out_ch: int = 2, n1: int = 32):
        super().__init__()
        for name, (cin, cout) in _BLOCKS.items():
            setattr(self, name, ConvBlockNested(cin * n1 or in_ch, cout * n1, cout * n1))
        for name, c in _UPS.items():
            setattr(self, name, _Up(c * n1))
        self.ca1 = ChannelAttention(n1, 16 // 4)
        self.ca = ChannelAttention(4 * n1, 16)
        self.conv_final = nn.Conv2d(4 * n1, out_ch, 1)

    def forward(self, xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        pool = lambda v: max_pool(v, 2, 2)                   # noqa: E731
        x0a = self.conv0_0(xa)
        x1a = self.conv1_0(pool(x0a))
        x2a = self.conv2_0(pool(x1a))
        x3a = self.conv3_0(pool(x2a))
        x0b = self.conv0_0(xb)
        x1b = self.conv1_0(pool(x0b))
        x2b = self.conv2_0(pool(x1b))
        x3b = self.conv3_0(pool(x2b))
        x4b = self.conv4_0(pool(x3b))
        cat = lambda *xs: torch.cat(xs, dim=1)                   # noqa: E731
        x01 = self.conv0_1(cat(x0a, x0b, self.Up1_0(x1b)))
        x11 = self.conv1_1(cat(x1a, x1b, self.Up2_0(x2b)))
        x02 = self.conv0_2(cat(x0a, x0b, x01, self.Up1_1(x11)))
        x21 = self.conv2_1(cat(x2a, x2b, self.Up3_0(x3b)))
        x12 = self.conv1_2(cat(x1a, x1b, x11, self.Up2_1(x21)))
        x03 = self.conv0_3(cat(x0a, x0b, x01, x02, self.Up1_2(x12)))
        x31 = self.conv3_1(cat(x3a, x3b, self.Up4_0(x4b)))
        x22 = self.conv2_2(cat(x2a, x2b, x21, self.Up3_1(x31)))
        x13 = self.conv1_3(cat(x1a, x1b, x11, x12, self.Up2_2(x22)))
        x04 = self.conv0_4(cat(x0a, x0b, x01, x02, x03, self.Up1_3(x13)))
        out = cat(x01, x02, x03, x04)
        ca1 = self.ca1(x01 + x02 + x03 + x04)
        out = self.ca(out) * (out + ca1.repeat(1, 4, 1, 1))
        return self.conv_final(out)
