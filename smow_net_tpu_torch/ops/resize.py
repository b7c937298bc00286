"""Linear and nearest resize (port of smow_net_tpu/ops/resize.py
`resize_linear` over two spatial axes, and `resize_nearest`, CD-Mamba's
decoder upsampling): the JAX package's per-axis interpolation matrices are
PyTorch's bilinear rule for either `align_corners` (False, ChangeMamba's:
half-pixel centres, source (dst + 0.5) * in / out - 0.5 clamped at 0; True:
source dst * (in - 1) / (out - 1)), and its nearest indices PyTorch's floor
rule (source floor(dst * in / out)), so the port calls F.interpolate.
Images are NCHW here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["resize_linear", "resize_nearest"]


def resize_linear(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to `size` = (H', W'): half-pixel
    centres by default, corner-aligned with `align_corners` (the JAX
    package's default, which ChangeMamba's calls do not take)."""
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="bilinear",
                         align_corners=align_corners)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest-neighbour resize of (B, C, H, W) to `size` = (H', W'):
    source index floor(dst * in / out)."""
    return F.interpolate(x, size=tuple(int(s) for s in size), mode="nearest")
