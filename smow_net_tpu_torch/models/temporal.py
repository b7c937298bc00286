"""Cyclic temporal 1x1x1 mixing over T=4 frames (port of
smow_net_tpu/models/temporal.py; reference conv_trans_block_3d,
models/SMOW_Net.py:104-139, and SMOW_Net_LW's decoder blocks,
models/SMOW_Net_LW.py:102-176).

out_j = time_5(F_j) + time_{k+1}(F_k) with k = (j + 1) % 4, cyclically: the
identity mixer time_5 starts as eye, the four frame mixers time_1..4 as
zero. The mixers are 1x1x1 convs in one of the reference's two key layouts:
SMOW_Net's and SMOW_Net_LW's transposed-conv blocks hold ConvTranspose3d
`conv3d_time_{1..5}` with (I, O, 1, 1, 1) weights; SMOW_Net_LW's conv
blocks hold Conv3d `conv3d_t{1..5}` with (O, I, 1, 1, 1) weights. SMOW_Net's
mixers carry a bias, SMOW_Net_LW's do not.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["CyclicTemporalMix"]


class CyclicTemporalMix(nn.Module):
    """Mixers registered as `{prefix}{1..5}` directly on the module, so a
    subclass (the decoder blocks) keeps the reference's flat key names.
    `conv` is nn.ConvTranspose3d or nn.Conv3d."""

    def __init__(self, features: int, bias: bool = True, conv=nn.ConvTranspose3d,
                 prefix: str = "conv3d_time_"):
        super().__init__()
        self._mixers = [f"{prefix}{i}" for i in range(1, 6)]
        for name in self._mixers:
            setattr(self, name, conv(features, features, 1, bias=bias))
        with torch.no_grad():
            for name in self._mixers[:4]:
                nn.init.zeros_(getattr(self, name).weight)
            getattr(self, self._mixers[4]).weight.copy_(
                torch.eye(features)[:, :, None, None, None])

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        """y (B, C, 4, H, W) -> same shape."""
        mixed = [getattr(self, self._mixers[t])(y[:, :, t:t + 1]) for t in range(4)]
        return getattr(self, self._mixers[4])(y) + torch.cat(mixed[1:] + mixed[:1], dim=2)
