"""Max pooling (port of smow_net_tpu/ops/pooling.py `max_pool`, which
matches torch's: padded elements never win). Images are NCHW here."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["max_pool"]


def max_pool(x: torch.Tensor, kernel, stride=None, padding=0) -> torch.Tensor:
    """(B, C, H, W) -> max over `kernel` windows every `stride` (default:
    the kernel) with symmetric `padding`."""
    return F.max_pool2d(x, kernel, stride, padding)
