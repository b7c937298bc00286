"""Bilinear sampling and the OFW token path's warped-softmax scatter.

Port of smow_net_tpu/ops/warp.py for the OFW recipe: torch `F.grid_sample`
semantics with bilinear sampling, border padding and align_corners=True.

Layout is channels-last, as in the JAX package: x (B, H, W, C),
grid (B, Hg, Wg, 2) with grid[..., 0] the x (width) coordinate and
grid[..., 1] the y (height) coordinate, both in [-1, 1].

`token_scatter` is kernel D (csrc/token_scatter.cu) on a CUDA tensor and its
plain version `token_scatter_plain` on a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _kernels

__all__ = ["grid_sample", "grid_sample_transpose", "flow_grid",
           "token_scatter", "token_scatter_plain", "token_softmax_scatter"]


def _corners(grid: torch.Tensor, H: int, W: int):
    """Flat corner indices (B, n, 4) and bilinear weights (B, n, 4) fp32,
    corners ordered (y0x0, y0x1, y1x0, y1x1); border padding, align_corners
    (coordinates clamped before the floor, x1 = min(x0 + 1, W - 1))."""
    B = grid.shape[0]
    ix = ((grid[..., 0].float() + 1.0) * 0.5 * (W - 1)).clamp(0.0, W - 1)
    iy = ((grid[..., 1].float() + 1.0) * 0.5 * (H - 1)).clamp(0.0, H - 1)
    ix0 = torch.floor(ix)
    iy0 = torch.floor(iy)
    tx = ix - ix0
    ty = iy - iy0
    x0, y0 = ix0.long(), iy0.long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    w = [(1 - tx) * (1 - ty), tx * (1 - ty), (1 - tx) * ty, tx * ty]
    idx = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1], -1)
    return idx.reshape(B, -1, 4), torch.stack(w, -1).reshape(B, -1, 4)


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample `x` at `grid` (border, align_corners=True). Returns
    (B, Hg, Wg, C) in x.dtype."""
    B, H, W, C = x.shape
    _, Hg, Wg, _ = grid.shape
    idx, w = _corners(grid, H, W)
    flat = x.reshape(B, H * W, C)
    out = 0
    for k in range(4):
        v = torch.gather(flat, 1, idx[..., k:k + 1].expand(-1, -1, C))
        out = out + v * w[..., k:k + 1]
    return out.reshape(B, Hg, Wg, C).to(x.dtype)


def grid_sample_transpose(g: torch.Tensor, grid: torch.Tensor, out_hw) -> torch.Tensor:
    """Adjoint of `grid_sample` as a primal op: out[m] = sum_n S[n, m] g[n]
    into an (H, W) = out_hw image, accumulated in fp32, returned in g.dtype."""
    B, Hg, Wg, C = g.shape
    H, W = out_hw
    idx, w = _corners(grid, H, W)
    gf = g.reshape(B, Hg * Wg, C).float()
    out = torch.zeros(B, H * W, C, dtype=torch.float32, device=g.device)
    for k in range(4):
        out.scatter_add_(1, idx[..., k:k + 1].expand(-1, -1, C), gf * w[..., k:k + 1])
    return out.reshape(B, H, W, C).to(g.dtype)


def flow_grid(flow: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Identity grid linspace(-1, 1) plus flow / (W, H), clamped to [-1, 1]
    (the reference OFW warp grid, models/SMOW_Net.py:612-631). fp32."""
    fy = torch.linspace(-1.0, 1.0, H, dtype=torch.float32, device=flow.device)
    fx = torch.linspace(-1.0, 1.0, W, dtype=torch.float32, device=flow.device)
    base = torch.stack(torch.meshgrid(fx, fy, indexing="xy"), dim=-1)   # (H, W, 2)
    norm = torch.tensor([W, H], dtype=torch.float32, device=flow.device)
    return (base[None] + flow.float() / norm).clamp(-1.0, 1.0)


def token_scatter_plain(a: torch.Tensor, grid: torch.Tensor, m: torch.Tensor):
    """Plain version of kernel D. a (F, H, W, C) logits, grid (F, H, W, 2),
    m (F, C) the shared shift. Computes in fp32 like the kernel and returns
    (ew, zaw) in a.dtype."""
    F_, H, W, C = a.shape
    aw = grid_sample(a.float(), grid)
    eaw = torch.exp(aw - m.float()[:, None, None, :])
    ew = grid_sample_transpose(eaw, grid, (H, W))
    return ew.to(a.dtype), eaw.sum(dim=(1, 2)).to(a.dtype)


def token_scatter(a: torch.Tensor, grid: torch.Tensor, m: torch.Tensor):
    """(ew, zaw) = (S^T exp(S a - m), sum_n exp(S a - m)): kernel D on a CUDA
    tensor, `token_scatter_plain` on a CPU tensor."""
    if a.device.type == "cpu":
        return token_scatter_plain(a, grid, m)
    if not a.is_cuda:
        raise ValueError(f"token_scatter: unsupported device {a.device}")
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"token_scatter: dtype {a.dtype} not supported")
    if a.dim() != 4 or a.shape[-1] not in (8, 16):
        raise ValueError(f"token_scatter: a must be (F, H, W, 8|16), got {tuple(a.shape)}")
    F_, H, W, C = a.shape
    if tuple(grid.shape) != (F_, H, W, 2) or grid.dtype != torch.float32:
        raise ValueError("token_scatter: grid must be fp32 (F, H, W, 2)")
    if tuple(m.shape) != (F_, C) or m.dtype != torch.float32:
        raise ValueError("token_scatter: m must be fp32 (F, C)")
    for name, t in (("a", a), ("grid", grid), ("m", m)):
        if t.device != a.device or not t.is_contiguous():
            raise ValueError(f"token_scatter: {name} must be contiguous on {a.device}")
    if a.data_ptr() % 16:
        raise ValueError("token_scatter: a must be 16-byte aligned")
    ew = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    zaw = torch.zeros((F_, C), dtype=torch.float32, device=a.device)
    _kernels.call("token_scatter_fwd", a.data_ptr(), grid.data_ptr(), m.data_ptr(),
                  ew.data_ptr(), zaw.data_ptr(), F_, H, W, C,
                  int(a.dtype == torch.bfloat16), _kernels.stream_handle(a.device))
    return ew.to(a.dtype), zaw.to(a.dtype)


def token_softmax_scatter(a: torch.Tensor, flow: torch.Tensor):
    """The OFW token chain (smow_net_tpu/ops/warp.py:217-257):

        aw  = flow_warp(a, flow)              (bilinear, border, align=True)
        eaw = exp(aw - m),  m = max_n a       per (frame, l)
        ew  = flow_warp_transpose(eaw, flow)
        zaw = sum_n eaw

    CONTRACT: ew and zaw share the per-(frame, l) scale exp(max_n aw - m);
    the caller divides ew by max(zaw, tiny). zaw >= 1 is not guaranteed: a
    warped-logit spread above ~87 underflows every exp and zaw -> 0."""
    B, H, W, C = a.shape
    grid = flow_grid(flow, H, W)
    m = a.amax(dim=(1, 2)).float()
    return token_scatter(a.contiguous(), grid, m)
