"""Linear and nearest resize (port of smow_net_tpu/ops/resize.py
`resize_linear` over two spatial axes with align_corners=False,
ChangeMamba's, and `resize_nearest`, CD-Mamba's decoder upsampling): the JAX
package's per-axis interpolation matrices are then PyTorch's half-pixel
bilinear rule (source (dst + 0.5) * in / out - 0.5, clamped at 0), and its
nearest indices PyTorch's floor rule (source floor(dst * in / out)), so the
port calls F.interpolate. Images are NCHW here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resize_linear", "resize_nearest"]


def resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to `size` = (H', W'), half-pixel
    centres (align_corners=False)."""
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="bilinear",
                         align_corners=False)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest-neighbour resize of (B, C, H, W) to `size` = (H', W'):
    source index floor(dst * in / out)."""
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="nearest")
