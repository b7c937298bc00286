"""Sub-pixel upsampling with the reference Classifier's ordering.

`smow_shuffle` reproduces the reference's bespoke permute/view chain
(models/SMOW_Net.py:390-408), which is NOT the `F.pixel_shuffle` channel
ordering: channels split into the width axis first and H/W swap twice.
Layout is channels-last (B, H, W, C), as in smow_net_tpu.ops.pixel_shuffle.
"""

from __future__ import annotations

import torch

__all__ = ["smow_shuffle"]


def smow_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H*s, W*s, C/s^2)."""
    B, H, W, C = x.shape
    s = scale
    y = x.reshape(B, H, W * s, C // s).transpose(1, 2)     # (B, W*s, H, C/s)
    y = y.reshape(B, W * s, H * s, C // (s * s))
    return y.transpose(1, 2)                                 # (B, H*s, W*s, C/s^2)
