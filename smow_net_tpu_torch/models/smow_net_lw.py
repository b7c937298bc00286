"""SMOW_Net_LW, the lightweight bi-temporal change-detection model (port of
smow_net_tpu/models/smow_net_lw.py; reference models/SMOW_Net_LW.py:9-98).

A siamese MobileNetV2 backbone runs on each image; its five taps are
stacked per stage into T=2 volumes. The OFW module and the token
transformer are SMOW_Net's at 16 channels (kernel D at inference; at
training the unfused warp chain, kernels A, B, C and A-bwd); the T=2->4
lift and a slimmer 3D U-Net decoder follow, whose blocks are (1, 3, 3)
spatial convs with a bias-free cyclic temporal mix; then one dim_head=1
pixel cross-attention layer at D = 64 (kernel F) and the sub-pixel
classifier head.

Activations are NCDHW with D = T, unfolded; submodule names give the
reference's state_dict keys (the ones smow_net_tpu/train/convert.py
`load_smownet_lw_state_dict` reads).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm3d
from ..nn.mobilenetv2 import MobileNetV2
from .smow_net import (OFW, Classifier, PixelTransformerDecoder, TokenTransformerEncoder,
                       lift24, ofw_tokens_fused)
from .temporal import CyclicTemporalMix

__all__ = ["SMOWNetLW", "ConvTransBlockLW", "ConvBlockLW"]


class ConvTransBlockLW(CyclicTemporalMix):
    """(1, 3, 3) ConvTranspose3d (x2 upsample), the bias-free cyclic mix
    `conv3d_time_*` (ConvTranspose3d, (I, O) weights), BN and LeakyReLU(0.2)
    (reference models/SMOW_Net_LW.py:102-137)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__(features, bias=False)
        self.conv3d_spatial = nn.ConvTranspose3d(in_ch, features, (1, 3, 3), (1, 2, 2),
                                                 (0, 1, 1), output_padding=(0, 1, 1))
        self.batch = BatchNorm3d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.batch(super().forward(self.conv3d_spatial(x))), 0.2)


class ConvBlockLW(CyclicTemporalMix):
    """(1, 3, 3) Conv3d, the bias-free cyclic mix `conv3d_t*` (Conv3d, (O, I)
    weights), BN and LeakyReLU(0.2) (reference models/SMOW_Net_LW.py:140-176;
    unlike SMOW_Net's ConvBlock23d it ends with the activation)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__(features, bias=False, conv=nn.Conv3d, prefix="conv3d_t")
        self.conv3d_s = nn.Conv3d(in_ch, features, (1, 3, 3), padding=(0, 1, 1))
        self.b = BatchNorm3d(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.b(super().forward(self.conv3d_s(x))), 0.2)


# decoder widths: (C3DT_i in -> out, C3D_i skip + stream -> out), i = 1..5
_STAGES = ((320, 320, 320, 160), (160, 160, 96, 64), (64, 64, 32, 32), (32, 32, 24, 28),
           (28, 28, 16, 16))


class SMOWNetLW(nn.Module):
    """forward(x1, x2) with x1, x2 (B, 3, H, W) normalized RGB -> change
    probabilities (B, 1, H, W). H and W must be multiples of 64."""

    def __init__(self):
        super().__init__()
        self.backbone = MobileNetV2()
        self.OFW = OFW(16)
        self.Transformer_Encoder = TokenTransformerEncoder(16)
        for i, (up_in, up_out, skip, out) in enumerate(_STAGES, 1):
            setattr(self, f"C3DT{i}", ConvTransBlockLW(up_in, up_out))
            setattr(self, f"C3D{i}", ConvBlockLW(up_out + skip, out))
        self.Transformer_Decoder = PixelTransformerDecoder(64)
        self.decoder = Classifier(64, 4)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.training:
            # two passes: each image's BatchNorm statistics in turn, as the
            # reference's sequential siamese calls
            taps1, taps2 = self.backbone(x1), self.backbone(x2)
        else:
            # running statistics: one pass over both images is exact
            taps = self.backbone(torch.cat([x1, x2]))
            taps1, taps2 = zip(*(t.chunk(2) for t in taps))
        x0, f1, f2, f3, f4 = (torch.stack(pair, dim=2) for pair in zip(taps1, taps2))
        # training takes the unfused token chain (kernels A, B, C, A-bwd),
        # the one the JAX package's routing names for this model
        # (smow_net_tpu/ops/warp.py:292-299). Its logits are (2B, H/2, W/2,
        # 8), W * C = 1024 at 256^2, where the shape rule alone would pick
        # the hybrid, so the model names its chain itself.
        tokens = ofw_tokens_fused(self.OFW, self.Transformer_Encoder, x0,
                                  train_chain="unfused")
        skips = [lift24(v) for v in (x0, f1, f2, f3, f4)]
        y = F.max_pool3d(skips[4], (1, 2, 2), (1, 2, 2))
        for i, skip in enumerate(reversed(skips), 1):
            up, block = getattr(self, f"C3DT{i}"), getattr(self, f"C3D{i}")
            y = block(torch.cat([up(y), skip], dim=1))
        H, W = y.shape[-2:]
        return self.decoder(self.Transformer_Decoder(y, tokens), H, W)
