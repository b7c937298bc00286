"""Pooling (port of smow_net_tpu/ops/pooling.py `max_pool`, `avg_pool` and
`adaptive_avg_pool`, which match torch's: padded elements never win a max,
`count_include_pad` picks the average's divisor). XLA computed them with no
hand kernel, so the port calls torch's own. Images are NCHW here."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["max_pool", "avg_pool", "adaptive_avg_pool"]


def max_pool(x: torch.Tensor, kernel, stride=None, padding=0) -> torch.Tensor:
    """(B, C, H, W) -> max over `kernel` windows every `stride` (default:
    the kernel) with symmetric `padding`."""
    return F.max_pool2d(x, kernel, stride, padding)


def avg_pool(x: torch.Tensor, kernel, stride=None, padding=0,
             count_include_pad: bool = True) -> torch.Tensor:
    """(B, C, H, W) -> mean over `kernel` windows every `stride` (default:
    the kernel) with symmetric zero `padding`, divided by the window's size
    or, without `count_include_pad`, by its elements inside the image."""
    return F.avg_pool2d(x, kernel, stride, padding, count_include_pad=count_include_pad)


def adaptive_avg_pool(x: torch.Tensor, out_sizes) -> torch.Tensor:
    """torch's AdaptiveAvgPool2d to `out_sizes`; as in the JAX package, only
    sizes that divide the map (global pooling among them)."""
    H, W = x.shape[-2:]
    oh, ow = (out_sizes, out_sizes) if isinstance(out_sizes, int) else out_sizes
    if H % oh or W % ow:
        raise ValueError(f"adaptive_avg_pool: {(oh, ow)} does not divide {(H, W)}")
    return F.adaptive_avg_pool2d(x, (oh, ow))
