"""Causal 1-D convolution (port of smow_net_tpu/ops/convops.py
`causal_conv1d`, the reference's `causal_conv1d` CUDA op that CD-Mamba's
Mamba blocks call).

The JAX function takes x (B, L, C) and a (K, C/groups, C) kernel and pads
K-1 steps on the left; here the kernel is torch's Conv1d layout (C,
C/groups, K), the reference's `conv1d.weight`, and F.conv1d runs over the
(B, C, L) view. The output keeps x's dtype, as JAX's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["causal_conv1d"]


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor, bias=None,
                  groups: int = 1) -> torch.Tensor:
    """x (B, L, C), weight (C, C/groups, K), bias (C,) or None -> (B, L, C):
    y_l = sum_k weight[:, :, k] x_{l - K + 1 + k} (+ bias), x before step 0
    taken as zero."""
    K = weight.shape[-1]
    y = F.conv1d(F.pad(x.transpose(1, 2), (K - 1, 0)), weight, bias, groups=groups)
    return y.transpose(1, 2)
