"""Cross-scan / cross-merge of the 2-D selective scan (port of
smow_net_tpu/ops/cross_scan.py `cross_scan` and `cross_merge`): plain
transposes, flips and reshapes, no kernel.

Direction order (the reference's CrossScan): 0 row-major, 1 column-major,
2 reversed row-major, 3 reversed column-major. Activations are
channels-last, as in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["cross_scan", "cross_merge"]


def cross_scan(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 4, H*W, C)."""
    B, H, W, C = x.shape
    x0 = x.reshape(B, H * W, C)
    x1 = x.transpose(1, 2).reshape(B, H * W, C)
    return torch.stack([x0, x1, x0.flip(1), x1.flip(1)], dim=1)


def cross_merge(ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, 4, H*W, C) -> (B, H*W, C): the sum of the four scans, each
    brought back to row-major order."""
    B, K, L, C = ys.shape

    def from_columns(y):
        return y.reshape(B, W, H, C).transpose(1, 2).reshape(B, L, C)

    return ys[:, 0] + from_columns(ys[:, 1]) + ys[:, 2].flip(1) + from_columns(ys[:, 3].flip(1))
