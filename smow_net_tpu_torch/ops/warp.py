"""Bilinear sampling and the OFW token path's warped-softmax scatter.

Port of smow_net_tpu/ops/warp.py for the OFW recipe: torch `F.grid_sample`
semantics with bilinear sampling, border padding and align_corners=True.

Layout is channels-last, as in the JAX package: x (B, H, W, C),
grid (B, Hg, Wg, 2) with grid[..., 0] the x (width) coordinate and
grid[..., 1] the y (height) coordinate, both in [-1, 1].

Kernels (csrc/), each with its plain version beside it; a wrapper takes the
plain version only for a CPU tensor and launches its kernel on a CUDA one:

  token_scatter        kernels D (csrc/token_scatter.cu, `token_scatter_fwd`)
                       and, with `residual=True`, E (`token_scatter_fwd_eaw`)
  grid_sample_t_vjp    kernel C (csrc/grid_sample_t_vjp.cu)
  grid_sample_bwd      kernel A's backward (csrc/grid_sample_bwd.cu)

`token_softmax_scatter` differentiates the token chain with a
torch.autograd.Function whose forward is E and whose backward is C, an
elementwise pass and A-bwd (the JAX hybrid lowering's VJP).

The weight-gradient rows the C and A-bwd kernels return are `dw`
(B, 4, Hg, Wg) fp32 in the order (dwy0, dwy1, dwx0, dwx1): the gradients
with respect to the separable lerp weights wy0 = 1 - ty, wy1 = ty,
wx0 = 1 - tx, wx1 = tx. `corner_weights_vjp` carries them to dgrid.
"""

from __future__ import annotations

import torch

from . import _kernels

__all__ = ["grid_sample", "grid_sample_transpose", "flow_grid", "corner_rows",
           "corner_weights_vjp", "token_scatter", "token_scatter_plain",
           "grid_sample_t_vjp", "grid_sample_t_vjp_plain", "grid_sample_bwd",
           "grid_sample_bwd_plain", "token_softmax_scatter"]


def corner_rows(grid: torch.Tensor, H: int, W: int):
    """Separable corners of `grid` into an (H, W) image (the JAX package's
    `_corner_indices_weights`, border padding, align_corners): int64 rows
    y0, y1, x0, x1 and fp32 lerp weights wy0, wy1, wx0, wx1, each
    grid.shape[:-1]. Coordinates are clamped before the floor and
    x1 = min(x0 + 1, W - 1). A NaN coordinate gets corner index 0 (as the
    kernels' fmaxf clamp and XLA's float -> int conversion give it) and NaN
    weights."""
    ix = ((grid[..., 0].float() + 1.0) * 0.5 * (W - 1)).clamp(0.0, W - 1)
    iy = ((grid[..., 1].float() + 1.0) * 0.5 * (H - 1)).clamp(0.0, H - 1)
    ix0, iy0 = torch.floor(ix), torch.floor(iy)
    tx, ty = ix - ix0, iy - iy0
    x0 = torch.nan_to_num(ix0, nan=0.0).long()
    y0 = torch.nan_to_num(iy0, nan=0.0).long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    return y0, y1, 1.0 - ty, ty, x0, x1, 1.0 - tx, tx


def corner_weights_vjp(grid: torch.Tensor, dw: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """dgrid (B, Hg, Wg, 2) fp32 from the weight-gradient rows dw (B, 4, Hg,
    Wg) = (dwy0, dwy1, dwx0, dwx1). The index rows carry no gradient; the
    weights are 1 - t and t with t = i - floor(i), so d/di = dw1 - dw0, and
    the clamp to [0, size - 1] passes the gradient where the unclamped
    coordinate lies inside it, ends included (torch.clamp's rule)."""
    ix = (grid[..., 0].float() + 1.0) * 0.5 * (W - 1)
    iy = (grid[..., 1].float() + 1.0) * 0.5 * (H - 1)
    dix = (dw[:, 3] - dw[:, 2]) * ((ix >= 0) & (ix <= W - 1)) * (0.5 * (W - 1))
    diy = (dw[:, 1] - dw[:, 0]) * ((iy >= 0) & (iy <= H - 1)) * (0.5 * (H - 1))
    return torch.stack([dix, diy], dim=-1)


def _corners(grid: torch.Tensor, H: int, W: int):
    """Flat corner indices (B, n, 4), corners ordered (y0x0, y0x1, y1x0,
    y1x1), and the separable weights (wy0, wy1, wx0, wx1), each (B, n) fp32."""
    B = grid.shape[0]
    y0, y1, wy0, wy1, x0, x1, wx0, wx1 = (r.reshape(B, -1) for r in corner_rows(grid, H, W))
    idx = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1], -1)
    return idx, (wy0, wy1, wx0, wx1)


def _bilinear(wy0, wy1, wx0, wx1):
    """The four corner weights, in the order of `_corners`' indices."""
    return wy0 * wx0, wy0 * wx1, wy1 * wx0, wy1 * wx1


def _gather_corners(x: torch.Tensor, idx: torch.Tensor):
    """The four corner rows of x (B, H, W, C) as fp32 (B, n, C) each."""
    B, H, W, C = x.shape
    flat = x.reshape(B, H * W, C).float()
    return [torch.gather(flat, 1, idx[..., k:k + 1].expand(-1, -1, C)) for k in range(4)]


def _scatter_corners(gf: torch.Tensor, idx: torch.Tensor, w, shape) -> torch.Tensor:
    """sum_k w_k gf scattered to corner k: an fp32 (B, H, W, C) image."""
    B, H, W, C = shape
    out = torch.zeros(B, H * W, C, dtype=torch.float32, device=gf.device)
    for k in range(4):
        out.scatter_add_(1, idx[..., k:k + 1].expand(-1, -1, C), gf * w[k][..., None])
    return out.reshape(shape)


def grid_sample(x: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample `x` at `grid` (border, align_corners=True). Returns
    (B, Hg, Wg, C) in x.dtype."""
    B, H, W, C = x.shape
    _, Hg, Wg, _ = grid.shape
    idx, sep = _corners(grid, H, W)
    out = sum(v * w[..., None] for v, w in zip(_gather_corners(x, idx), _bilinear(*sep)))
    return out.reshape(B, Hg, Wg, C).to(x.dtype)


def grid_sample_transpose(g: torch.Tensor, grid: torch.Tensor, out_hw) -> torch.Tensor:
    """Adjoint of `grid_sample` as a primal op: out[m] = sum_n S[n, m] g[n]
    into an (H, W) = out_hw image, accumulated in fp32, returned in g.dtype."""
    B, Hg, Wg, C = g.shape
    H, W = out_hw
    idx, sep = _corners(grid, H, W)
    return _scatter_corners(g.reshape(B, Hg * Wg, C).float(), idx, _bilinear(*sep),
                            (B, H, W, C)).to(g.dtype)


def flow_grid(flow: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Identity grid linspace(-1, 1) plus flow / (W, H), clamped to [-1, 1]
    (the reference OFW warp grid, models/SMOW_Net.py:612-631). fp32."""
    fy = torch.linspace(-1.0, 1.0, H, dtype=torch.float32, device=flow.device)
    fx = torch.linspace(-1.0, 1.0, W, dtype=torch.float32, device=flow.device)
    base = torch.stack(torch.meshgrid(fx, fy, indexing="xy"), dim=-1)   # (H, W, 2)
    norm = torch.tensor([W, H], dtype=torch.float32, device=flow.device)
    return (base[None] + flow.float() / norm).clamp(-1.0, 1.0)


def _weight_grads(corners, gf, wy0, wy1, wx0, wx1):
    """dw rows (B, 4, n) from the four corner rows and the pixel-side tensor
    gf (B, n, C): with s_kj = <corner (y_k, x_j) row, gf>, dwy_k = sum_j
    wx_j s_kj and dwx_j = sum_k wy_k s_kj."""
    s00, s01, s10, s11 = ((v * gf).sum(-1) for v in corners)
    return torch.stack([wx0 * s00 + wx1 * s01, wx0 * s10 + wx1 * s11,
                        wy0 * s00 + wy1 * s10, wy0 * s01 + wy1 * s11], dim=1)


def _check_cuda(name: str, t: torch.Tensor, channels=(8, 16)):
    if not t.is_cuda:
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {t.dtype} not supported")
    if t.dim() != 4 or t.shape[-1] not in channels:
        raise ValueError(f"{name}: expected (B, H, W, {'|'.join(map(str, channels))}), "
                         f"got {tuple(t.shape)}")


def _check_like(name: str, ref: torch.Tensor, **tensors):
    """Every tensor on ref's device, contiguous, 16-byte aligned."""
    for key, t in tensors.items():
        if t.device != ref.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous and 16-byte aligned "
                             f"on {ref.device}")


def _check_grid(name: str, grid: torch.Tensor, B: int):
    if grid.dim() != 4 or grid.shape[0] != B or grid.shape[-1] != 2 or grid.dtype != torch.float32:
        raise ValueError(f"{name}: grid must be fp32 ({B}, Hg, Wg, 2), got "
                         f"{grid.dtype} {tuple(grid.shape)}")


def token_scatter_plain(a: torch.Tensor, grid: torch.Tensor, m: torch.Tensor,
                        residual: bool = False):
    """Plain version of kernels D and E. a (F, H, W, C) logits, grid
    (F, H, W, 2), m (F, C) the shared shift. Computes in fp32 like the
    kernels and returns (ew, zaw) in a.dtype, and with `residual` also
    eaw = exp(S a - m) (F, H, W, C) in a.dtype."""
    F_, H, W, C = a.shape
    aw = grid_sample(a.float(), grid)
    eaw = torch.exp(aw - m.float()[:, None, None, :])
    ew = grid_sample_transpose(eaw, grid, (H, W))
    out = (ew.to(a.dtype), eaw.sum(dim=(1, 2)).to(a.dtype))
    return out + (eaw.to(a.dtype),) if residual else out


def token_scatter(a: torch.Tensor, grid: torch.Tensor, m: torch.Tensor,
                  residual: bool = False):
    """(ew, zaw) = (S^T exp(S a - m), sum_n exp(S a - m)), and with
    `residual` also eaw = exp(S a - m): kernel D (E with the residual) on a
    CUDA tensor, `token_scatter_plain` on a CPU tensor."""
    if a.device.type == "cpu":
        return token_scatter_plain(a, grid, m, residual)
    _check_cuda("token_scatter", a)
    F_, H, W, C = a.shape
    if tuple(grid.shape) != (F_, H, W, 2) or grid.dtype != torch.float32:
        raise ValueError("token_scatter: grid must be fp32 (F, H, W, 2)")
    if tuple(m.shape) != (F_, C) or m.dtype != torch.float32:
        raise ValueError("token_scatter: m must be fp32 (F, C)")
    _check_like("token_scatter", a, a=a, grid=grid, m=m)
    ew = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    zaw = torch.zeros((F_, C), dtype=torch.float32, device=a.device)
    eaw = torch.empty_like(a) if residual else None
    args = [a.data_ptr(), grid.data_ptr(), m.data_ptr(), ew.data_ptr(), zaw.data_ptr()]
    if residual:
        args.append(eaw.data_ptr())
    _kernels.call("token_scatter_fwd_eaw" if residual else "token_scatter_fwd", *args,
                  F_, H, W, C, int(a.dtype == torch.bfloat16), _kernels.stream_handle(a.device))
    out = (ew.to(a.dtype), zaw.to(a.dtype))
    return out + (eaw,) if residual else out


def grid_sample_t_vjp_plain(xbar: torch.Tensor, g: torch.Tensor, grid: torch.Tensor):
    """Plain version of kernel C: the VJP of `grid_sample_transpose(g, grid)`
    against the image-side cotangent xbar (B, H, W, C), given the primal
    pixel tensor g (B, Hg, Wg, C). Returns dg = S xbar (B, Hg, Wg, C) in
    g.dtype and the weight-gradient rows dw (B, 4, Hg, Wg) fp32."""
    B, H, W, C = xbar.shape
    _, Hg, Wg, _ = grid.shape
    idx, sep = _corners(grid, H, W)
    corners = _gather_corners(xbar, idx)
    gf = g.reshape(B, Hg * Wg, C).float()
    dg = sum(v * w[..., None] for v, w in zip(corners, _bilinear(*sep)))
    dw = _weight_grads(corners, gf, *sep)
    return dg.reshape(B, Hg, Wg, C).to(g.dtype), dw.reshape(B, 4, Hg, Wg)


def grid_sample_t_vjp(xbar: torch.Tensor, g: torch.Tensor, grid: torch.Tensor):
    """(dg, dw) of `grid_sample_t_vjp_plain`: kernel C on a CUDA tensor, the
    plain version on a CPU tensor. xbar takes g's dtype, as in the JAX
    package."""
    if g.device.type == "cpu":
        return grid_sample_t_vjp_plain(xbar, g, grid)
    _check_cuda("grid_sample_t_vjp", g)
    xbar = xbar.to(g.dtype)
    B, Hg, Wg, C = g.shape
    if xbar.dim() != 4 or xbar.shape[0] != B or xbar.shape[-1] != C:
        raise ValueError(f"grid_sample_t_vjp: xbar must be ({B}, H, W, {C})")
    _check_grid("grid_sample_t_vjp", grid, B)
    if tuple(grid.shape[1:3]) != (Hg, Wg):
        raise ValueError("grid_sample_t_vjp: grid must be (B, Hg, Wg, 2) like g")
    _check_like("grid_sample_t_vjp", g, xbar=xbar, g=g, grid=grid)
    H, W = xbar.shape[1:3]
    dg = torch.empty_like(g)
    dw = torch.empty((B, 4, Hg, Wg), dtype=torch.float32, device=g.device)
    _kernels.call("grid_sample_t_vjp", xbar.data_ptr(), g.data_ptr(), grid.data_ptr(),
                  dg.data_ptr(), dw.data_ptr(), B, H, W, Hg, Wg, C,
                  int(g.dtype == torch.bfloat16), _kernels.stream_handle(g.device))
    return dg, dw


def grid_sample_bwd_plain(x: torch.Tensor, gy: torch.Tensor, grid: torch.Tensor):
    """Plain version of kernel A's backward: the VJP of
    `grid_sample(x, grid)` against the pixel cotangent gy (B, Hg, Wg, C).
    Returns dx = S^T gy (B, H, W, C), accumulated in fp32 and returned in
    x.dtype, and the weight-gradient rows dw (B, 4, Hg, Wg) fp32."""
    B, H, W, C = x.shape
    _, Hg, Wg, _ = grid.shape
    idx, sep = _corners(grid, H, W)
    gf = gy.reshape(B, Hg * Wg, C).float()
    dw = _weight_grads(_gather_corners(x, idx), gf, *sep)
    dx = _scatter_corners(gf, idx, _bilinear(*sep), x.shape)
    return dx.to(x.dtype), dw.reshape(B, 4, Hg, Wg)


def grid_sample_bwd(x: torch.Tensor, gy: torch.Tensor, grid: torch.Tensor):
    """(dx, dw) of `grid_sample_bwd_plain`: kernel A-bwd on a CUDA tensor,
    the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return grid_sample_bwd_plain(x, gy, grid)
    _check_cuda("grid_sample_bwd", x)
    B, H, W, C = x.shape
    _check_grid("grid_sample_bwd", grid, B)
    Hg, Wg = grid.shape[1:3]
    if tuple(gy.shape) != (B, Hg, Wg, C) or gy.dtype != x.dtype:
        raise ValueError(f"grid_sample_bwd: gy must be {x.dtype} ({B}, {Hg}, {Wg}, {C})")
    _check_like("grid_sample_bwd", x, x=x, gy=gy, grid=grid)
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    dw = torch.empty((B, 4, Hg, Wg), dtype=torch.float32, device=x.device)
    _kernels.call("grid_sample_bwd", x.data_ptr(), gy.data_ptr(), grid.data_ptr(),
                  dx.data_ptr(), dw.data_ptr(), B, H, W, Hg, Wg, C,
                  int(x.dtype == torch.bfloat16), _kernels.stream_handle(x.device))
    return dx.to(x.dtype), dw


class _TokenSoftmaxScatter(torch.autograd.Function):
    """(ew, zaw) of the token chain with the JAX hybrid lowering's VJP
    (smow_net_tpu/ops/pallas/warp.py `_tok_hyb_bwd`): forward E, backward
    C, daw = (dg + dzaw) eaw, A-bwd, and the two ops' weight-gradient rows
    summed into dgrid. Each op routes by device."""

    @staticmethod
    def forward(ctx, a, grid):
        m = a.amax(dim=(1, 2)).float()
        ew, zaw, eaw = token_scatter(a, grid, m, residual=True)
        ctx.save_for_backward(a, grid, eaw)
        return ew, zaw

    @staticmethod
    def backward(ctx, ew_bar, dzaw):
        a, grid, eaw = ctx.saved_tensors
        H, W = a.shape[1:3]
        if ew_bar is None:
            ew_bar = torch.zeros_like(a)
        if dzaw is None:
            dzaw = torch.zeros(a.shape[0], a.shape[-1], device=a.device)
        dg, dw_c = grid_sample_t_vjp(ew_bar.contiguous(), eaw, grid)
        daw = ((dg.float() + dzaw.float()[:, None, None, :]) * eaw.float()).to(a.dtype)
        da, dw_a = grid_sample_bwd(a, daw, grid)
        return da, corner_weights_vjp(grid, dw_c + dw_a, H, W)


def token_softmax_scatter(a: torch.Tensor, flow: torch.Tensor):
    """The OFW token chain (smow_net_tpu/ops/warp.py:217-257):

        aw  = flow_warp(a, flow)              (bilinear, border, align=True)
        eaw = exp(aw - m),  m = max_n a       per (frame, l), no gradient
        ew  = flow_warp_transpose(eaw, flow)
        zaw = sum_n eaw

    CONTRACT: ew and zaw share the per-(frame, l) scale exp(max_n aw - m);
    the caller divides ew by max(zaw, tiny). zaw >= 1 is not guaranteed: a
    warped-logit spread above ~87 underflows every exp and zaw -> 0.

    Differentiable in a and flow when either needs a gradient (kernel E and
    the backward kernels); otherwise one kernel-D call with no residual."""
    B, H, W, C = a.shape
    grid = flow_grid(flow, H, W)
    a = a.contiguous()
    if torch.is_grad_enabled() and (a.requires_grad or grid.requires_grad):
        return _TokenSoftmaxScatter.apply(a, grid)
    return token_scatter(a, grid, a.amax(dim=(1, 2)).float())
