"""Cross-scan / cross-merge of the 2-D selective scan (port of
smow_net_tpu/ops/cross_scan.py): plain transposes, flips, reshapes and
gathers by fixed permutations, no kernel.

Direction order (the reference's CrossScan): 0 row-major, 1 column-major,
2 reversed row-major, 3 reversed column-major; the 8-direction scan
(RS-Mamba's) adds 4 the wrapped diagonal, 5 the wrapped anti-diagonal, 6
and 7 their reverses. Activations are channels-last, as in the JAX package.

The diagonals are the reference's wrapped ones (`_diag_perm`): every
"diagonal" has H elements and wraps around the right edge. They are gathers
along L by a permutation; the backward of each gather is the gather by the
inverse permutation (`_Gather`), so no scatter with atomics enters the
backward and deterministic mode on the card accepts it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["cross_scan", "cross_merge", "cross_scan8", "cross_merge8", "cross_scan_1b1",
           "cross_scan_1d", "cross_merge_1d", "cross_scan_2d", "cross_merge_2d"]


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


def cross_scan_1b1(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4*c) -> (B, 4, H*W, c): channel group k rides traversal k
    only (the reference's CrossScanTriton1b1; SS2D's xv forms route their
    per-direction dt, B and C through it)."""
    B, H, W, KC = x.shape
    if KC % 4:
        raise ValueError(f"cross_scan_1b1: {KC} channels are not 4 groups")
    g = x.reshape(B, H, W, 4, KC // 4)
    x0 = g[..., 0, :].reshape(B, H * W, -1)
    x1 = g[..., 1, :].transpose(1, 2).reshape(B, H * W, -1)
    x2 = g[..., 2, :].reshape(B, H * W, -1).flip(1)
    x3 = g[..., 3, :].transpose(1, 2).reshape(B, H * W, -1).flip(1)
    return torch.stack([x0, x1, x2, x3], dim=1)


def cross_scan_1d(x: torch.Tensor) -> torch.Tensor:
    """SS2D's 1-direction ablation (CrossScan_Ab_1direction): the row-major
    traversal 4 times, so the parameters keep their K = 4 shapes."""
    B, H, W, C = x.shape
    return x.reshape(B, 1, H * W, C).expand(B, 4, H * W, C)


def cross_merge_1d(ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, 4, H*W, C) -> (B, H*W, C): the plain sum over K."""
    return ys.sum(1)


def cross_scan_2d(x: torch.Tensor) -> torch.Tensor:
    """SS2D's 2-direction ablation (CrossScan_Ab_2direction): [x, x,
    flip(x), flip(x)] in row-major order, no transposed traversal."""
    B, H, W, C = x.shape
    x0 = x.reshape(B, H * W, C)
    x2 = x0.flip(1)
    return torch.stack([x0, x0, x2, x2], dim=1)


def cross_merge_2d(ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, 4, H*W, C) -> (B, H*W, C): the two forward scans plus the two
    reverse scans flipped back."""
    return ys[:, 0] + ys[:, 1] + (ys[:, 2] + ys[:, 3]).flip(1)


@functools.lru_cache(maxsize=None)
def _diag_perm(H: int, W: int) -> np.ndarray:
    """Row-major -> the reference's wrapped diagonal traversal: for each
    shift s (outer, 0..W-1) walk the rows i (inner, 0..H-1) at column
    (i + s) mod W."""
    s = np.arange(W, dtype=np.int32)[:, None]
    i = np.arange(H, dtype=np.int32)[None, :]
    return (i * W + (i + s) % W).reshape(-1)


@functools.lru_cache(maxsize=None)
def _antidiag_perm(H: int, W: int) -> np.ndarray:
    """The wrapped anti-diagonal: column (s - i) mod W, shift outer, row
    inner."""
    s = np.arange(W, dtype=np.int32)[:, None]
    i = np.arange(H, dtype=np.int32)[None, :]
    return (i * W + (s - i) % W).reshape(-1)


def _inverse_perm(perm: np.ndarray) -> np.ndarray:
    inv = np.empty(perm.size, dtype=np.int32)
    inv[perm] = np.arange(perm.size, dtype=np.int32)
    return inv


@functools.lru_cache(maxsize=None)
def _indices(H: int, W: int, kind: str, device: torch.device):
    """(perm, inverse) of the diagonal (kind "diag") or anti-diagonal
    ("anti") traversal as int64 tensors on `device`, made once. Made outside
    inference mode whatever the first caller runs under: an eval step's
    inference tensor could not be saved for a later train step's backward."""
    perm = (_diag_perm if kind == "diag" else _antidiag_perm)(H, W)
    with torch.inference_mode(False):
        return tuple(torch.from_numpy(p.astype(np.int64)).to(device)
                     for p in (perm, _inverse_perm(perm)))


class _Gather(torch.autograd.Function):
    """y = x gathered along dim 1 by a permutation; the backward gathers
    the gradient by the inverse permutation (a bijection's adjoint)."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(perm, inv)
        return x.index_select(1, perm)

    @staticmethod
    def backward(ctx, g):
        perm, inv = ctx.saved_tensors
        return _Gather.apply(g, inv, perm), None, None


def _gather(x: torch.Tensor, H: int, W: int, kind: str, inverse: bool = False) -> torch.Tensor:
    perm, inv = _indices(H, W, kind, x.device)
    return _Gather.apply(x, inv, perm) if inverse else _Gather.apply(x, perm, inv)


def cross_scan8(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 8, H*W, C): the four axis-aligned traversals,
    then the wrapped diagonal, the anti-diagonal and their reverses."""
    B, H, W, C = x.shape
    flat = x.reshape(B, H * W, C)
    d0, a0 = _gather(flat, H, W, "diag"), _gather(flat, H, W, "anti")
    return torch.cat([cross_scan(x), torch.stack([d0, a0, d0.flip(1), a0.flip(1)], dim=1)],
                     dim=1)


def cross_merge8(ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, 8, H*W, C) -> (B, H*W, C): the eight scans, each brought back to
    row-major order, summed."""
    out = cross_merge(ys[:, :4], H, W)
    out = out + _gather(ys[:, 4] + ys[:, 6].flip(1), H, W, "diag", inverse=True)
    return out + _gather(ys[:, 5] + ys[:, 7].flip(1), H, W, "anti", inverse=True)
