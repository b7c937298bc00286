"""Cyclic temporal 1x1x1 mixing over T=4 frames (port of
smow_net_tpu/models/temporal.py; reference conv_trans_block_3d,
models/SMOW_Net.py:104-139).

out_j = time_5(F_j) + time_{k+1}(F_k) with k = (j + 1) % 4, cyclically: the
identity mixer time_5 starts as eye, the four frame mixers time_1..4 as
zero. All five are biased 1x1x1 ConvTranspose3d, whose (I, O, 1, 1, 1)
weight layout is the one the checkpoint converter expects.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["CyclicTemporalMix"]


class CyclicTemporalMix(nn.Module):
    """Mixers registered as `conv3d_time_{1..5}` directly on the module, so
    a subclass (ConvTransBlock3d) keeps the reference's flat key names."""

    def __init__(self, features: int):
        super().__init__()
        for i in range(1, 6):
            setattr(self, f"conv3d_time_{i}", nn.ConvTranspose3d(features, features, 1))
        with torch.no_grad():
            for i in range(1, 5):
                nn.init.zeros_(getattr(self, f"conv3d_time_{i}").weight)
            self.conv3d_time_5.weight.copy_(torch.eye(features)[:, :, None, None, None])

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        """y (B, C, 4, H, W) -> same shape."""
        mixed = [getattr(self, f"conv3d_time_{t + 1}")(y[:, :, t:t + 1]) for t in range(4)]
        return self.conv3d_time_5(y) + torch.cat(mixed[1:] + mixed[:1], dim=2)
