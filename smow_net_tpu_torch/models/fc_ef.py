"""FC-EF, the early-fusion fully convolutional U-Net (Daudt 2018; port of
smow_net_tpu/models/zoo/fc_ef.py; reference compare/FC_EF.py:10-148).

The two images are stacked on channels; four conv stages with BN, ReLU,
channel Dropout2d(0.2) and max-pools; a decoder of transposed convs with
the skips concatenated. Returns 2-channel logits (the reference defines a
LogSoftmax it never applies). Activations are NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import BatchNorm2d
from ..ops.pooling import max_pool

__all__ = ["FCEF"]

# (name, in, out): encoder convs (Conv2d) per stage, then the decoder's
# transposed convs per stage, each after its stage's upconv
_ENCODER = ((("11", 0, 16), ("12", 16, 16)), (("21", 16, 32), ("22", 32, 32)),
            (("31", 32, 64), ("32", 64, 64), ("33", 64, 64)),
            (("41", 64, 128), ("42", 128, 128), ("43", 128, 128)))
_DECODER = ((128, (("43d", 256, 128), ("42d", 128, 128), ("41d", 128, 64))),
            (64, (("33d", 128, 64), ("32d", 64, 64), ("31d", 64, 32))),
            (32, (("22d", 64, 32), ("21d", 32, 16))),
            (16, (("12d", 32, 16),)))


class FCEF(nn.Module):
    """forward(x1, x2), (B, input_nbr, H, W) each -> logits (B, label_nbr,
    H, W); H and W multiples of 16 (odd stages are padded by replication,
    as the reference does)."""

    def __init__(self, label_nbr: int = 2, input_nbr: int = 3):
        super().__init__()
        for stage in _ENCODER:
            for name, cin, cout in stage:
                setattr(self, f"conv{name}", nn.Conv2d(cin or 2 * input_nbr, cout, 3, 1, 1))
                setattr(self, f"bn{name}", BatchNorm2d(cout))
                setattr(self, f"do{name}", nn.Dropout2d(0.2))
        for i, (width, convs) in zip((4, 3, 2, 1), _DECODER):
            setattr(self, f"upconv{i}", nn.ConvTranspose2d(width, width, 3, 2, 1, output_padding=1))
            for name, cin, cout in convs:
                setattr(self, f"conv{name}", nn.ConvTranspose2d(cin, cout, 3, 1, 1))
                setattr(self, f"bn{name}", BatchNorm2d(cout))
                setattr(self, f"do{name}", nn.Dropout2d(0.2))
        self.conv11d = nn.ConvTranspose2d(16, label_nbr, 3, 1, 1)

    def _cbr(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = torch.relu(getattr(self, f"bn{name}")(getattr(self, f"conv{name}")(x)))
        return getattr(self, f"do{name}")(y)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        y = torch.cat([x1, x2], dim=1)
        skips = []
        for stage in _ENCODER:
            for name, _, _ in stage:
                y = self._cbr(y, name)
            skips.append(y)
            y = max_pool(y, 2, 2)
        for i, (_, convs), skip in zip((4, 3, 2, 1), _DECODER, reversed(skips)):
            y = getattr(self, f"upconv{i}")(y)
            dh, dw = skip.shape[2] - y.shape[2], skip.shape[3] - y.shape[3]
            if dh or dw:
                y = F.pad(y, (0, dw, 0, dh), mode="replicate")
            y = torch.cat([y, skip], dim=1)
            for name, _, _ in convs:
                y = self._cbr(y, name)
        return self.conv11d(y)
