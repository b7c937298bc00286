"""SMOW_Net, the flagship bi-temporal change-detection model (port of
smow_net_tpu/models/smow_net.py; reference models/SMOW_Net.py:8-101).

Inflated ResNet-18 3D encoder over the stacked (T=2) image pair; an
optical-flow-warp (OFW) module whose token path warps the 8-channel
attention logits and scatters their softmax back (kernel D); a token
transformer; a T=2->4 temporal lift and a 3D U-Net decoder with cyclic
temporal-mixing transposed convs; one dim_head=1 pixel cross-attention
layer (kernel F); and a sub-pixel classifier head.

Activations are NCDHW with D = T. Each module is written once, in the
reference's shape; submodule names give the reference's state_dict keys.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm3d, CrossTransformerLayer, TransformerLayer
from ..nn.resnet3d import ResNet3D
from ..ops import warp
from ..ops.pixel_shuffle import smow_shuffle
from .temporal import CyclicTemporalMix

__all__ = ["SMOWNet", "BasicConv3d", "OFW", "TokenTransformerEncoder",
           "PixelTransformerDecoder", "ConvTransBlock3d", "ConvBlock23d",
           "Classifier", "ofw_tokens_fused", "lift24"]


class BasicConv3d(nn.Module):
    """Conv3d + BN + ReLU (reference BasicConv3d)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 1,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.conv_bn = nn.Sequential(
            nn.Conv3d(in_ch, features, kernel_size, stride, padding),
            BatchNorm3d(features), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_bn(x)


class OFW(nn.Module):
    """Optical-flow warp (reference models/SMOW_Net.py:587-637). Only the
    flow field is computed here; the token path warps the attention logits
    with it (`ofw_tokens_fused`)."""

    def __init__(self, inplane: int):
        super().__init__()
        layers = []
        for _ in range(3):
            layers += [nn.Conv3d(inplane, inplane, 3, (1, 2, 2), 1, groups=inplane),
                       BatchNorm3d(inplane), nn.ReLU()]
        self.down = nn.Sequential(*layers)
        self.flow_make = nn.Conv3d(2 * inplane, 2, 3, padding=1, bias=False)

    def flow(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, 2, H, W) -> flow (B, 2, 2, H, W), channel = (dx, dy).
        The trilinear lift goes to the actual input size (the reference
        hard-codes (2, 128, 128), identical at 256x256 input)."""
        T, H, W = x.shape[2:]
        y = F.interpolate(self.down(x), size=(T, H, W), mode="trilinear",
                          align_corners=True)
        return self.flow_make(torch.cat([x, y], dim=1))


class TokenTransformerEncoder(nn.Module):
    """Per-timestep soft spatial token pooling + 1-layer MHSA (reference
    Transformer_Encoder, models/SMOW_Net.py:161-190)."""

    def __init__(self, in_chan: int = 32, token_len: int = 8, heads: int = 8):
        super().__init__()
        self.in_chan, self.token_len = in_chan, token_len
        self.pos_embedding = nn.Parameter(torch.randn(4, token_len, in_chan))
        self.conv_a = nn.Conv2d(in_chan, token_len, 1)
        dim = 4 * in_chan
        self.transformer = TransformerLayer(dim, heads, dim, dim)

    def attention_logits(self, x: torch.Tensor) -> torch.Tensor:
        """(F, C, H, W) frames -> (F, token_len, H, W) logits."""
        return self.conv_a(x)

    def finish(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, 4, token_len, C) pooled tokens -> (B, token_len, 4*C)."""
        B = tokens.shape[0]
        tokens = (tokens + self.pos_embedding[None]).transpose(1, 2)
        return self.transformer(tokens.reshape(B, self.token_len, 4 * self.in_chan))


def ofw_tokens_fused(ofw: OFW, tenc: TokenTransformerEncoder,
                     x: torch.Tensor) -> torch.Tensor:
    """OFW + token pooling with the warps on the cheap side (see
    smow_net_tpu/models/smow_net.py:249-325): the token encoder's use of a
    warped frame W(F) only needs W(conv_a(F)) and the adjoint W^T of the
    softmaxed maps, so the 8-channel logits are warped and scattered back
    (kernel D) instead of warping the 32-channel features. The softmax
    normalization is folded out of the pixel axis: only exp(a - max) maps
    are pooled, and the pooled tokens are divided by max(z, 1e-30).

    x (B, C, 2, H, W) -> tokens (B, token_len, 4*C) for the frames
    [F0, warp(F0), warp(F1), F1]."""
    B, C, T, H, W = x.shape
    L = tenc.token_len
    n = H * W
    flow = ofw.flow(x)                                        # (B, 2, 2, H, W)
    fb = flow.permute(0, 2, 3, 4, 1).reshape(B * 2, H, W, 2)
    xb = x.transpose(1, 2).reshape(B * 2, C, H, W)
    a = tenc.attention_logits(xb).permute(0, 2, 3, 1).contiguous()   # (2B, H, W, L)
    ew, zaw = warp.token_softmax_scatter(a, fb)
    ew = ew.reshape(B, 2, n, L)
    zaw = zaw.reshape(B, 2, L)
    a = a.reshape(B, 2, n, L)
    ea = torch.exp(a - a.amax(dim=2, keepdim=True).detach())     # shift: no gradient
    za = ea.sum(dim=2)
    f = xb.reshape(B, 2, C, n)

    # with the shared-max shift z can underflow to 0 when a map's warped
    # logits spread by more than ~87 (the token_softmax_scatter contract)
    def pool(e, feats, z):
        return torch.einsum("bnl,bcn->blc", e, feats) / z.clamp_min(1e-30)[..., None]

    tok = torch.stack([pool(ea[:, 0], f[:, 0], za[:, 0]),
                       pool(ew[:, 0], f[:, 0], zaw[:, 0]),
                       pool(ew[:, 1], f[:, 1], zaw[:, 1]),
                       pool(ea[:, 1], f[:, 1], za[:, 1])], dim=1)   # (B, 4, L, C)
    return tenc.finish(tok)


class PixelTransformerDecoder(nn.Module):
    """Cross-attention of the H*W pixel queries against the token memory
    (reference Transformer_Decoder, models/SMOW_Net.py:270-283). The
    reference's view(b, c*t, h, w) makes the features c-major, so the layer
    runs with no lane permutation."""

    def __init__(self, in_chan: int = 128, heads: int = 8):
        super().__init__()
        self.transformer_decoder = CrossTransformerLayer(in_chan, heads, 2 * in_chan)

    def forward(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        """x (B, C, T, H, W), m (B, M, C*T) -> (B, H*W, C*T)."""
        B, C, T, H, W = x.shape
        q = x.reshape(B, C * T, H * W).transpose(1, 2).contiguous()
        return self.transformer_decoder(q, m)


class ConvTransBlock3d(CyclicTemporalMix):
    """Spatial ConvTranspose3d (x2 upsample), the cyclic temporal mix over
    T=4, BN and LeakyReLU(0.2) (reference conv_trans_block_3d)."""

    def __init__(self, in_ch: int, features: int, spatial_kernel: int = 5,
                 spatial_padding: int = 2):
        super().__init__(features)
        k, p = spatial_kernel, spatial_padding
        self.conv3d_spatial = nn.ConvTranspose3d(in_ch, features, (1, k, k), (1, 2, 2),
                                                 (0, p, p), output_padding=(0, 1, 1))
        self.batch = BatchNorm3d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.batch(super().forward(self.conv3d_spatial(x))), 0.2)


class ConvBlock23d(nn.Module):
    """Two 3x3x3 convs with BN, LeakyReLU only between them (reference
    conv_block_2_3d: no final activation)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv_block_2_3d = nn.Sequential(
            nn.Conv3d(in_ch, features, 3, 1, 1), BatchNorm3d(features),
            nn.LeakyReLU(0.2), nn.Conv3d(features, features, 3, 1, 1),
            BatchNorm3d(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_block_2_3d(x)


class Classifier(nn.Module):
    """1x1 conv to 4 channels, sigmoid, then the reference's sub-pixel
    shuffle x2 (the sigmoid commutes with the permutation)."""

    def __init__(self, in_chan: int = 128, out_chan: int = 4):
        super().__init__()
        self.conv1 = nn.Conv2d(in_chan, out_chan, 1, bias=False)

    def forward(self, y: torch.Tensor, H: int, W: int) -> torch.Tensor:
        """y (B, H*W, in_chan) pixel rows -> probabilities (B, 1, 2H, 2W)."""
        p = torch.sigmoid(F.linear(y, self.conv1.weight.flatten(1)))
        return smow_shuffle(p.reshape(y.shape[0], H, W, -1), 2).permute(0, 3, 1, 2)


def lift24(v: torch.Tensor) -> torch.Tensor:
    """Temporal lift T=2 -> 4 (trilinear, align_corners=True) of NCDHW:
    frames [F0, 2/3 F0 + 1/3 F1, 1/3 F0 + 2/3 F1, F1]."""
    f0, f1 = v[:, :, 0:1], v[:, :, 1:2]
    c = 1.0 / 3.0
    return torch.cat([f0, f0 * (1 - c) + f1 * c, f0 * c + f1 * (1 - c), f1], dim=2)


class SMOWNet(nn.Module):
    """forward(x1, x2) with x1, x2 (B, 3, H, W) normalized RGB -> change
    probabilities (B, 1, H, W). H and W must be multiples of 64."""

    def __init__(self):
        super().__init__()
        self.resnet = ResNet3D()
        self.Conv3d = BasicConv3d(64, 32)
        self.OFW = OFW(32)
        self.Transformer_Encoder = TokenTransformerEncoder(32)
        self.Conv3d1 = BasicConv3d(64, 32)
        self.Conv3d2 = BasicConv3d(128, 64)
        self.Conv3d3 = BasicConv3d(256, 128)
        self.Conv3d4 = BasicConv3d(512, 256)
        self.C3DT1 = ConvTransBlock3d(256, 256)
        self.C3D1 = ConvBlock23d(256 + 256, 128)
        self.C3DT2 = ConvTransBlock3d(128, 128)
        self.C3D2 = ConvBlock23d(128 + 128, 64)
        self.C3DT3 = ConvTransBlock3d(64, 64)
        self.C3D3 = ConvBlock23d(64 + 64, 64)
        self.C3DT4 = ConvTransBlock3d(64, 64)
        self.C3D4 = ConvBlock23d(64 + 32, 32)
        self.C3DT5 = ConvTransBlock3d(32, 32)
        self.C3D5 = ConvBlock23d(32 + 32, 32)
        self.Transformer_Decoder = PixelTransformerDecoder(128)
        self.decoder = Classifier(128, 4)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x0, (f1, f2, f3, f4) = self.resnet(torch.stack([x1, x2], dim=2))
        x0 = self.Conv3d(x0)
        tokens = ofw_tokens_fused(self.OFW, self.Transformer_Encoder, x0)
        skips = [lift24(v) for v in (x0, self.Conv3d1(f1), self.Conv3d2(f2),
                                     self.Conv3d3(f3), self.Conv3d4(f4))]
        y = F.max_pool3d(skips[4], (1, 2, 2), (1, 2, 2))
        stages = ((self.C3DT1, self.C3D1), (self.C3DT2, self.C3D2), (self.C3DT3, self.C3D3),
                  (self.C3DT4, self.C3D4), (self.C3DT5, self.C3D5))
        for (up, block), skip in zip(stages, reversed(skips)):
            y = block(torch.cat([up(y), skip], dim=1))
        H, W = y.shape[-2:]
        return self.decoder(self.Transformer_Decoder(y, tokens), H, W)
