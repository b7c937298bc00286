"""Linear resize (port of smow_net_tpu/ops/resize.py `resize_linear` over
two spatial axes with align_corners=False, ChangeMamba's): the JAX
package's per-axis interpolation matrices are then PyTorch's half-pixel
bilinear rule (source (dst + 0.5) * in / out - 0.5, clamped at 0), so the
port calls F.interpolate. Images are NCHW here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resize_linear"]


def resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to `size` = (H', W'), half-pixel
    centres (align_corners=False)."""
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="bilinear",
                         align_corners=False)
