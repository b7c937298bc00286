"""DSIFN, the deeply supervised image fusion network (port of
smow_net_tpu/models/zoo/ifn.py; reference compare/IFN.py:57-179).

Two independent (not siamese) VGG-16 bases; five fusion branches from
stride 16 up to stride 1, each the concatenation of the upsampled branch
and both images' taps, an optional channel-attention gate, conv + PReLU +
BN + Dropout(0.6) blocks, a spatial-attention gate and a BN, joined by
stride-2 transposed convs; a 1x1 conv and a sigmoid give 1-channel
probabilities. The reference's intermediate supervision heads and its
unused `ca1`, `bn_ca1/2`, `o1_conv3` and `o2-4_conv4` are dead code and
left out, as in the JAX package. Activations are NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import BatchNorm2d
from ..nn.vgg import VGG16Features
from .snunet import ChannelAttention

__all__ = ["DSIFN", "SpatialAttention"]


class SpatialAttention(nn.Module):
    """A sigmoid spatial gate: a 7x7 conv of the channel mean and max."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(2, 1, 7, 1, 3, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv1(y))


def _block(in_ch: int, ch: int) -> nn.Sequential:
    """conv3x3 + PReLU + BN + Dropout(0.6) (compare/IFN.py:49-55)."""
    return nn.Sequential(nn.Conv2d(in_ch, ch, 3, 1, 1), nn.PReLU(1, 0.25), BatchNorm2d(ch),
                         nn.Dropout(0.6))


# per branch: (input channels, the convs' widths, channel attention)
_BRANCHES = ((1024, (512, 512), False), (1536, (512, 256, 256), True),
             (768, (256, 128, 128), True), (384, (128, 64, 64), True),
             (192, (64, 32, 16), True))


class DSIFN(nn.Module):
    """forward(t1, t2), (B, 3, H, W) each with H and W multiples of 16 ->
    change probabilities (B, 1, H, W)."""

    def __init__(self):
        super().__init__()
        self.t1_base = VGG16Features()
        self.t2_base = VGG16Features()
        for i, (in_ch, widths, ca) in enumerate(_BRANCHES, 1):
            if ca:
                setattr(self, f"ca{i}", ChannelAttention(in_ch, ratio=8))
            for j, ch in enumerate(widths, 1):
                setattr(self, f"o{i}_conv{j}", _block(in_ch, ch))
                in_ch = ch
            setattr(self, f"sa{i}", SpatialAttention())
            setattr(self, f"bn_sa{i}", BatchNorm2d(in_ch))
            if i < 5:
                setattr(self, f"trans_conv{i}", nn.ConvTranspose2d(in_ch, in_ch, 2, 2))
        self.o5_conv4 = nn.Conv2d(16, 1, 1)

    def forward(self, t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
        f1, f2 = self.t1_base(t1), self.t2_base(t2)
        x = None
        for i, (_, widths, ca) in enumerate(_BRANCHES, 1):
            parts = [f1[5 - i], f2[5 - i]]
            x = torch.cat(parts if x is None else [x] + parts, dim=1)
            if ca:
                x = getattr(self, f"ca{i}")(x) * x
            for j in range(1, len(widths) + 1):
                x = getattr(self, f"o{i}_conv{j}")(x)
            x = getattr(self, f"sa{i}")(x) * x
            x = getattr(self, f"bn_sa{i}")(x)
            if i < 5:
                x = getattr(self, f"trans_conv{i}")(x)
        return torch.sigmoid(self.o5_conv4(x))
