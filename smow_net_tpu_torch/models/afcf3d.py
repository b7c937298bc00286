"""AFCF3D-Net: adjacent-level cross-fusion of 3D convolutions over an
inflated ResNet-18, with a UNet3+-style decoder that concatenates along
time (port of smow_net_tpu/models/zoo/afcf3d.py; reference
compare/AFCF3D_NET.py:7-470, recipe channel 32).

The pair is one (B, 3, 2, H, W) volume through the port's ResNet3D (the
encoder SMOW_Net uses). Five reductions to 32 channels; the AFCF fusion
(AFCF1, one AFCF2 shared by levels 2-4, AFCF3; each a 3D conv pair and a
coordinate-attention gate on the time-folded map); the decoder's five
levels concatenate 5 maps of T = 2 along time (T = 10), gate them, and fold
T back down with (4, 3, 3) / 2 and (3 or 4, 1, 1) convs, sharing one
up- and one down-sampling conv across levels. A 2D head and a bilinear
resize give 1-channel probabilities. Weight sharing and the order of the
calls follow the reference (a shared BatchNorm's running statistics move
once per call). Activations are NCDHW with D = T.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import BatchNorm2d
from ..nn.resnet3d import ResNet3D
from ..ops.resize import resize_linear
from .smow_net import BasicConv3d

__all__ = ["AFCF3D", "CMAVariant"]


def _conv(in_ch: int, ch: int, k=(1, 1, 1), s=(1, 1, 1), p=(0, 0, 0)) -> BasicConv3d:
    return BasicConv3d(in_ch, ch, k, s, p)


def _conv333(in_ch: int, ch: int) -> BasicConv3d:
    return BasicConv3d(in_ch, ch, 3, 1, 1)


def _down(ch: int) -> BasicConv3d:
    """(1, 3, 3) stride (1, 2, 2): halves H and W."""
    return _conv(ch, ch, (1, 3, 3), (1, 2, 2), (0, 1, 1))


class CMAVariant(nn.Module):
    """Coordinate-attention gate on a (B, C, H, W) map (AFCF3D_NET.py:
    208-241): the map's means along W and along H, stacked, through a 1x1
    conv, BN and ReLU, then one sigmoid gate per axis."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c, c, 1)
        self.bn1 = BatchNorm2d(c)
        self.conv2 = nn.Conv2d(c, c, 1)
        self.conv3 = nn.Conv2d(c, c, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.shape[2]
        xh = x.mean(dim=3, keepdim=True)                        # (B, C, H, 1)
        xw = x.mean(dim=2, keepdim=True).transpose(2, 3)        # (B, C, W, 1)
        y = torch.relu(self.bn1(self.conv1(torch.cat([xh, xw], dim=2))))
        a_h = torch.sigmoid(self.conv2(y[:, :, :h]))
        a_w = torch.sigmoid(self.conv3(y[:, :, h:])).transpose(2, 3)
        return x * a_w * a_h


def _se_apply(se: CMAVariant, v: torch.Tensor) -> torch.Tensor:
    """The gate on (B, C, T, H, W) folded to (B, T*C, H, W), frame-major."""
    B, C, T, H, W = v.shape
    flat = se(v.transpose(1, 2).reshape(B, T * C, H, W))
    return flat.reshape(B, T, C, H, W).transpose(1, 2)


def _up2(v: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 of H and W of (B, C, T, H, W), align_corners=True."""
    B, C, T, H, W = v.shape
    y = resize_linear(v.reshape(B, C * T, H, W), (2 * H, 2 * W), align_corners=True)
    return y.reshape(B, C, T, 2 * H, 2 * W)


class _AFCF(nn.Module):
    """A fusion unit: its own up- and down-sampling convs where it has them,
    then a (3, 3, 3) and a 1x1x1 conv (`conv_cat`) and the gate (`SE`) on
    the time-folded map, plus the skip."""

    def __init__(self, ch: int, up: bool, down: bool):
        super().__init__()
        if up:
            self.conv_up = _conv333(ch, ch)
        if down:
            self.conv_down = _down(ch)
        self.conv_cat = nn.Sequential(_conv333(ch, ch), _conv(ch, ch))
        self.SE = CMAVariant(2 * ch)

    def fuse(self, summed: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return _se_apply(self.SE, self.conv_cat(summed)) + skip


class _Fuse(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.AFCF1 = _AFCF(ch, up=True, down=False)
        self.AFCF2 = _AFCF(ch, up=True, down=True)
        self.AFCF3 = _AFCF(ch, up=False, down=True)

    def forward(self, xs):
        a1, a2, a3 = self.AFCF1, self.AFCF2, self.AFCF3
        out = [a1.fuse(xs[0] + a1.conv_up(_up2(xs[1])), xs[0])]
        for i in (1, 2, 3):
            out.append(a2.fuse(a2.conv_down(xs[i - 1]) + xs[i] + a2.conv_up(_up2(xs[i + 1])),
                               xs[i]))
        out.append(a3.fuse(a3.conv_down(xs[3]) + xs[4], xs[4]))
        return out


class _ConvBN2d(nn.Module):
    """A bias-free 1x1 conv and BN, no activation (the head's
    `out.<i>.conv_bn` keys)."""

    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.conv_bn = nn.Sequential(nn.Conv2d(in_ch, ch, 1, bias=False), BatchNorm2d(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_bn(x)


class _Output(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv_upsample = _conv333(ch, ch)
        self.conv_downsample = _down(ch)
        for lvl in range(4):
            setattr(self, f"conv_cat_{lvl}", nn.Sequential(_conv333(ch, ch), _conv(ch, ch)))
            setattr(self, f"SE_{lvl}", CMAVariant(10 * ch))
        for name, k3 in (("downT3", 3), ("downT2", 3), ("downT1", 3), ("downfinal", 4)):
            setattr(self, name, nn.Sequential(_conv333(ch, ch),
                                              _conv(ch, ch, (4, 3, 3), (2, 1, 1), (0, 1, 1)),
                                              _conv(ch, ch, (k3, 1, 1))))
        self.out = nn.Sequential(_ConvBN2d(ch, 2 * ch), _ConvBN2d(2 * ch, ch),
                                 nn.Conv2d(ch, 1, 1))

    def level(self, parts, lvl: int) -> torch.Tensor:
        residual = torch.cat(parts, dim=2)                      # along T
        y = getattr(self, f"conv_cat_{lvl}")(residual)
        return residual + _se_apply(getattr(self, f"SE_{lvl}"), y)

    def forward(self, x0, f1, f2, f3, f4):
        up = lambda v: self.conv_upsample(_up2(v))              # noqa: E731
        down = self.conv_downsample
        x0d1 = down(x0)
        x0d2 = down(x0d1)
        x0d3 = down(x0d2)
        x1d2 = down(f1)
        x1d3 = down(x1d2)
        x2d3 = down(f2)
        x4u = up(f4)
        d3 = self.downT3(self.level([x4u, f3, x2d3, x1d3, x0d3], 3))
        x3u = up(d3)
        x4u = up(x4u)
        d2 = self.downT2(self.level([x4u, x3u, f2, x1d2, x0d2], 2))
        x2u = up(d2)
        x3u = up(x3u)
        x4u = up(x4u)
        d1 = self.downT1(self.level([x4u, x3u, x2u, f1, x0d1], 1))
        x1u = up(d1)
        x2u = up(x2u)
        x3u = up(x3u)
        x4u = up(x4u)
        d0 = self.downfinal(self.level([x0, x4u, x3u, x2u, x1u], 0))
        return self.out(d0[:, :, 0])                            # T = 1


class _Reduction(nn.Module):
    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.reduce = nn.Sequential(_conv(in_ch, ch), _conv333(ch, ch), _conv333(ch, ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduce(x)


class _Decoder(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        for i, c in enumerate((64, 64, 128, 256, 512)):
            setattr(self, f"reduction{i}", _Reduction(c, ch))
        self.AFCF_fuse = _Fuse(ch)
        self.output = _Output(ch)


class AFCF3D(nn.Module):
    """forward(x1, x2), (B, 3, H, W) each with H and W multiples of 32 ->
    change probabilities (B, 1, H, W)."""

    def __init__(self, features: int = 32):
        super().__init__()
        self.resnet = ResNet3D()
        self.decoder = _Decoder(features)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x0, feats = self.resnet(torch.stack([x1, x2], dim=2))
        dec = self.decoder
        xs = [getattr(dec, f"reduction{i}")(v) for i, v in enumerate([x0, *feats])]
        h = dec.output(*dec.AFCF_fuse(xs))
        return torch.sigmoid(resize_linear(h, x1.shape[-2:], align_corners=True))
