"""Bilinear sampling and the OFW token path's warped-softmax scatter.

Port of smow_net_tpu/ops/warp.py: torch `F.grid_sample` semantics with
bilinear sampling, `padding_mode` "border" or "zeros" and either
`align_corners` (the OFW recipe: border, align_corners=True, the defaults).

Layout is channels-last, as in the JAX package: x (B, H, W, C),
grid (B, Hg, Wg, 2) with grid[..., 0] the x (width) coordinate and
grid[..., 1] the y (height) coordinate, both in [-1, 1].

Kernels (csrc/), each with its plain version beside it; a wrapper takes the
plain version only for a CPU tensor and launches its kernel on a CUDA one:

  grid_sample            kernel A's forward (csrc/grid_sample_fwd.cu)
  grid_sample_transpose  kernel B (csrc/grid_sample_transpose.cu)
  token_scatter          kernels D (csrc/token_scatter.cu, `token_scatter_fwd`)
                         and, with `residual=True`, E (`token_scatter_fwd_eaw`)
  token_scatter_bwd      kernel D-bwd (`token_scatter_bwd`), the whole VJP of
                         the token chain in one pass
  grid_sample_t_vjp      kernel C (csrc/grid_sample_t_vjp.cu)
  grid_sample_bwd        kernel A's backward (csrc/grid_sample_bwd.cu)

A, B and C take both padding modes and both align_corners flags at C in
{8, 16, 32}; D, E and D-bwd the OFW recipe at C in {8, 16}.

`flow_warp` (forward A, backward A-bwd) and `flow_warp_transpose` (forward
B, backward C) are torch.autograd.Functions over a flow field.
`token_softmax_scatter` differentiates the token chain in one of the three
JAX train lowerings: the fused one, an autograd Function whose forward is D
and whose backward is D-bwd; the hybrid, whose forward is E and whose
backward is C, an elementwise pass and A-bwd; or the unfused composition of
the two flow warps around an exp.

The weight-gradient rows the C, A-bwd and D-bwd kernels return are `dw`
(B, 4, Hg, Wg) fp32 in the order (dwy0, dwy1, dwx0, dwx1): the gradients
with respect to the separable lerp weights wy0 = 1 - ty, wy1 = ty,
wx0 = 1 - tx, wx1 = tx (under zeros padding each times its corner's
validity). `corner_weights_vjp` carries them to dgrid.
"""

from __future__ import annotations

import torch

from . import _kernels

__all__ = ["grid_sample", "grid_sample_plain", "grid_sample_transpose",
           "grid_sample_transpose_plain", "flow_grid", "corner_rows",
           "corner_weights_vjp", "token_scatter", "token_scatter_plain",
           "token_scatter_bwd", "token_scatter_bwd_plain",
           "grid_sample_t_vjp", "grid_sample_t_vjp_plain", "grid_sample_bwd",
           "grid_sample_bwd_plain", "flow_warp", "flow_warp_transpose",
           "token_softmax_scatter"]

PADDING_MODES = ("border", "zeros")


def _unnormalize(g: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    """A [-1, 1] coordinate in pixels (the JAX package's `_unnormalize`)."""
    if align_corners:
        return (g.float() + 1.0) * 0.5 * (size - 1)
    return ((g.float() + 1.0) * size - 1.0) * 0.5


def _check_mode(padding_mode: str) -> None:
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"padding_mode must be one of {PADDING_MODES}, got {padding_mode!r}")


def corner_rows(grid: torch.Tensor, H: int, W: int, padding_mode: str = "border",
                align_corners: bool = True):
    """Separable corners of `grid` into an (H, W) image (the JAX package's
    `_corner_indices_weights`): int64 rows y0, y1, x0, x1 and fp32 lerp
    weights wy0, wy1, wx0, wx1, each grid.shape[:-1]. Under border padding
    the coordinate is clamped to [0, size - 1] before the floor; under zeros
    padding each per-axis weight is multiplied by its corner's validity.
    The indices are clamped into the image. A NaN coordinate gets NaN
    weights and corner index 0 (as XLA's float -> int conversion gives it),
    so its corners are rows and columns 0 and 1, in both padding modes."""
    _check_mode(padding_mode)
    ix = _unnormalize(grid[..., 0], W, align_corners)
    iy = _unnormalize(grid[..., 1], H, align_corners)
    if padding_mode == "border":
        ix, iy = ix.clamp(0.0, W - 1), iy.clamp(0.0, H - 1)
    ix0, iy0 = torch.floor(ix), torch.floor(iy)
    tx, ty = ix - ix0, iy - iy0
    wx0, wx1, wy0, wy1 = 1.0 - tx, tx, 1.0 - ty, ty
    if padding_mode == "zeros":
        wx0 = wx0 * ((ix0 >= 0) & (ix0 < W))
        wx1 = wx1 * ((ix0 + 1 >= 0) & (ix0 + 1 < W))
        wy0 = wy0 * ((iy0 >= 0) & (iy0 < H))
        wy1 = wy1 * ((iy0 + 1 >= 0) & (iy0 + 1 < H))
    # -1 .. size before the clamp, so a far coordinate stays in range
    x0 = torch.nan_to_num(ix0, nan=0.0).clamp(-1.0, W).long()
    y0 = torch.nan_to_num(iy0, nan=0.0).clamp(-1.0, H).long()
    x1, y1 = (x0 + 1).clamp(0, W - 1), (y0 + 1).clamp(0, H - 1)
    return y0.clamp(0, H - 1), y1, wy0, wy1, x0.clamp(0, W - 1), x1, wx0, wx1


def corner_weights_vjp(grid: torch.Tensor, dw: torch.Tensor, H: int, W: int,
                       padding_mode: str = "border", align_corners: bool = True) -> torch.Tensor:
    """dgrid (B, Hg, Wg, 2) fp32 from the weight-gradient rows dw (B, 4, Hg,
    Wg) = (dwy0, dwy1, dwx0, dwx1). The index rows carry no gradient; the
    weights are 1 - t and t with t = i - floor(i), so d/di = dw1 - dw0.
    Under border padding the clamp to [0, size - 1] passes the gradient
    where the unclamped coordinate lies inside it, ends included
    (torch.clamp's rule); under zeros padding the validities are constants
    of the floor, so d/di = dw1 valid(i0 + 1) - dw0 valid(i0), with a NaN
    floor taken as index 0 (`corner_rows`' corners). di/dg is (size - 1) /
    2 with align_corners, size / 2 without."""
    _check_mode(padding_mode)

    def axis(g, d0, d1, size):
        i = _unnormalize(g, size, align_corners)
        if padding_mode == "border":
            d = (d1 - d0) * ((i >= 0) & (i <= size - 1))
        else:
            i0 = torch.nan_to_num(torch.floor(i), nan=0.0)
            d = d1 * ((i0 + 1 >= 0) & (i0 + 1 < size)) - d0 * ((i0 >= 0) & (i0 < size))
        return d * (0.5 * (size - 1) if align_corners else 0.5 * size)

    return torch.stack([axis(grid[..., 0], dw[:, 2], dw[:, 3], W),
                        axis(grid[..., 1], dw[:, 0], dw[:, 1], H)], dim=-1)


def _corners(grid: torch.Tensor, H: int, W: int, mode=("border", True)):
    """Flat corner indices (B, n, 4), corners ordered (y0x0, y0x1, y1x0,
    y1x1), and the separable weights (wy0, wy1, wx0, wx1), each (B, n) fp32;
    `mode` = (padding_mode, align_corners)."""
    B = grid.shape[0]
    y0, y1, wy0, wy1, x0, x1, wx0, wx1 = (r.reshape(B, -1)
                                          for r in corner_rows(grid, H, W, *mode))
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


def grid_sample_plain(x: torch.Tensor, grid: torch.Tensor, padding_mode: str = "border",
                      align_corners: bool = True) -> torch.Tensor:
    """Plain version of kernel A's forward: bilinear sample `x` at `grid`,
    lerped in fp32. Returns (B, Hg, Wg, C) in x.dtype."""
    B, H, W, C = x.shape
    _, Hg, Wg, _ = grid.shape
    idx, sep = _corners(grid, H, W, (padding_mode, align_corners))
    out = sum(v * w[..., None] for v, w in zip(_gather_corners(x, idx), _bilinear(*sep)))
    return out.reshape(B, Hg, Wg, C).to(x.dtype)


def grid_sample_transpose_plain(g: torch.Tensor, grid: torch.Tensor, out_hw,
                                padding_mode: str = "border",
                                align_corners: bool = True) -> torch.Tensor:
    """Plain version of kernel B, the adjoint of `grid_sample` as a primal
    op: out[m] = sum_n S[n, m] g[n] into an (H, W) = out_hw image,
    accumulated in fp32, returned in g.dtype."""
    B, Hg, Wg, C = g.shape
    H, W = out_hw
    idx, sep = _corners(grid, H, W, (padding_mode, align_corners))
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


def _check_cuda(name: str, t: torch.Tensor, channels=(8, 16, 32)):
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


def _modes(padding_mode: str, align_corners: bool):
    """The kernels' (zeros, align) int flags."""
    _check_mode(padding_mode)
    return int(padding_mode == "zeros"), int(bool(align_corners))


def grid_sample(x: torch.Tensor, grid: torch.Tensor, padding_mode: str = "border",
                align_corners: bool = True) -> torch.Tensor:
    """`grid_sample_plain`'s function: kernel A-fwd on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return grid_sample_plain(x, grid, padding_mode, align_corners)
    _check_cuda("grid_sample", x)
    B, H, W, C = x.shape
    _check_grid("grid_sample", grid, B)
    _check_like("grid_sample", x, x=x, grid=grid)
    Hg, Wg = grid.shape[1:3]
    out = torch.empty((B, Hg, Wg, C), dtype=x.dtype, device=x.device)
    _kernels.call("grid_sample_fwd", x.data_ptr(), grid.data_ptr(), out.data_ptr(),
                  B, H, W, Hg, Wg, C, int(x.dtype == torch.bfloat16),
                  *_modes(padding_mode, align_corners), _kernels.stream_handle(x.device))
    return out


def grid_sample_transpose(g: torch.Tensor, grid: torch.Tensor, out_hw,
                          padding_mode: str = "border", align_corners: bool = True) -> torch.Tensor:
    """`grid_sample_transpose_plain`'s function: kernel B on a CUDA tensor,
    the plain version on a CPU tensor."""
    if g.device.type == "cpu":
        return grid_sample_transpose_plain(g, grid, out_hw, padding_mode, align_corners)
    _check_cuda("grid_sample_transpose", g)
    B, Hg, Wg, C = g.shape
    _check_grid("grid_sample_transpose", grid, B)
    if tuple(grid.shape[1:3]) != (Hg, Wg):
        raise ValueError("grid_sample_transpose: grid must be (B, Hg, Wg, 2) like g")
    _check_like("grid_sample_transpose", g, g=g, grid=grid)
    H, W = out_hw
    out = torch.zeros((B, H, W, C), dtype=torch.float32, device=g.device)
    _kernels.call("grid_sample_transpose", g.data_ptr(), grid.data_ptr(), out.data_ptr(),
                  B, H, W, Hg, Wg, C, int(g.dtype == torch.bfloat16),
                  *_modes(padding_mode, align_corners), _kernels.stream_handle(g.device))
    return out.to(g.dtype)


def token_scatter_plain(a: torch.Tensor, grid: torch.Tensor, m: torch.Tensor,
                        residual: bool = False):
    """Plain version of kernels D and E. a (F, H, W, C) logits, grid
    (F, H, W, 2), m (F, C) the shared shift. Computes in fp32 like the
    kernels and returns (ew, zaw) in a.dtype, and with `residual` also
    eaw = exp(S a - m) (F, H, W, C) in a.dtype."""
    F_, H, W, C = a.shape
    aw = grid_sample_plain(a.float(), grid)
    eaw = torch.exp(aw - m.float()[:, None, None, :])
    ew = grid_sample_transpose_plain(eaw, grid, (H, W))
    out = (ew.to(a.dtype), eaw.sum(dim=(1, 2)).to(a.dtype))
    return out + (eaw.to(a.dtype),) if residual else out


def token_scatter(a: torch.Tensor, grid: torch.Tensor, m: torch.Tensor,
                  residual: bool = False):
    """(ew, zaw) = (S^T exp(S a - m), sum_n exp(S a - m)), and with
    `residual` also eaw = exp(S a - m): kernel D (E with the residual) on a
    CUDA tensor, `token_scatter_plain` on a CPU tensor."""
    if a.device.type == "cpu":
        return token_scatter_plain(a, grid, m, residual)
    _check_cuda("token_scatter", a, channels=(8, 16))
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


def token_scatter_bwd_plain(a: torch.Tensor, grid: torch.Tensor, m: torch.Tensor,
                            ew_bar: torch.Tensor, dzaw: torch.Tensor):
    """Plain version of kernel D-bwd: the VJP of `token_scatter(a, grid, m)`
    (no residual) against the cotangents ew_bar (F, H, W, C) and dzaw
    (F, C), written step by step in fp32 (the JAX package's
    `_tok_bwd_kernel`):

        aw  = S a,  eaw = exp(aw - m)      recomputed
        dg  = S ew_bar
        daw = (dg + dzaw) eaw
        da  = S^T daw

    and the weight-gradient rows of both gathers, summed (they share the
    grid): with the corner rows of a and of ew_bar, sum_c daw_c (corners of
    a) + sum_c eaw_c (corners of ew_bar). Returns da in a.dtype and dw
    (F, 4, H, W) fp32."""
    F_, H, W, C = a.shape
    idx, sep = _corners(grid, H, W)
    w = _bilinear(*sep)
    va, ve = _gather_corners(a, idx), _gather_corners(ew_bar, idx)
    aw = sum(v * wk[..., None] for v, wk in zip(va, w))
    dg = sum(v * wk[..., None] for v, wk in zip(ve, w))
    eaw = torch.exp(aw - m.float()[:, None, :])
    daw = (dg + dzaw.float()[:, None, :]) * eaw
    da = _scatter_corners(daw, idx, w, a.shape)
    dw = _weight_grads(va, daw, *sep) + _weight_grads(ve, eaw, *sep)
    return da.to(a.dtype), dw.reshape(F_, 4, H, W)


def token_scatter_bwd(a: torch.Tensor, grid: torch.Tensor, m: torch.Tensor,
                      ew_bar: torch.Tensor, dzaw: torch.Tensor):
    """(da, dw) of `token_scatter_bwd_plain`: kernel D-bwd on a CUDA tensor,
    the plain version on a CPU tensor. ew_bar takes a's dtype, as in the JAX
    package; dzaw is read in fp32."""
    ew_bar = ew_bar.to(a.dtype).contiguous()
    dzaw = dzaw.float().contiguous()
    if a.device.type == "cpu":
        return token_scatter_bwd_plain(a, grid, m, ew_bar, dzaw)
    _check_cuda("token_scatter_bwd", a, channels=(8, 16))
    F_, H, W, C = a.shape
    if tuple(grid.shape) != (F_, H, W, 2) or grid.dtype != torch.float32:
        raise ValueError("token_scatter_bwd: grid must be fp32 (F, H, W, 2)")
    if tuple(m.shape) != (F_, C) or m.dtype != torch.float32 or tuple(dzaw.shape) != (F_, C):
        raise ValueError("token_scatter_bwd: m and dzaw must be fp32 (F, C)")
    if tuple(ew_bar.shape) != tuple(a.shape):
        raise ValueError("token_scatter_bwd: ew_bar must be shaped like a")
    _check_like("token_scatter_bwd", a, a=a, grid=grid, m=m, dzaw=dzaw, ew_bar=ew_bar)
    da = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    dw = torch.empty((F_, 4, H, W), dtype=torch.float32, device=a.device)
    _kernels.call("token_scatter_bwd", a.data_ptr(), grid.data_ptr(), m.data_ptr(),
                  dzaw.data_ptr(), ew_bar.data_ptr(), da.data_ptr(), dw.data_ptr(),
                  F_, H, W, C, int(a.dtype == torch.bfloat16), _kernels.stream_handle(a.device))
    return da.to(a.dtype), dw


def grid_sample_t_vjp_plain(xbar: torch.Tensor, g: torch.Tensor, grid: torch.Tensor,
                            padding_mode: str = "border", align_corners: bool = True):
    """Plain version of kernel C: the VJP of `grid_sample_transpose(g, grid)`
    against the image-side cotangent xbar (B, H, W, C), given the primal
    pixel tensor g (B, Hg, Wg, C). Returns dg = S xbar (B, Hg, Wg, C) in
    g.dtype and the weight-gradient rows dw (B, 4, Hg, Wg) fp32."""
    B, H, W, C = xbar.shape
    _, Hg, Wg, _ = grid.shape
    idx, sep = _corners(grid, H, W, (padding_mode, align_corners))
    corners = _gather_corners(xbar, idx)
    gf = g.reshape(B, Hg * Wg, C).float()
    dg = sum(v * w[..., None] for v, w in zip(corners, _bilinear(*sep)))
    dw = _weight_grads(corners, gf, *sep)
    return dg.reshape(B, Hg, Wg, C).to(g.dtype), dw.reshape(B, 4, Hg, Wg)


def grid_sample_t_vjp(xbar: torch.Tensor, g: torch.Tensor, grid: torch.Tensor,
                      padding_mode: str = "border", align_corners: bool = True):
    """(dg, dw) of `grid_sample_t_vjp_plain`: kernel C on a CUDA tensor, the
    plain version on a CPU tensor. xbar takes g's dtype, as in the JAX
    package."""
    if g.device.type == "cpu":
        return grid_sample_t_vjp_plain(xbar, g, grid, padding_mode, align_corners)
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
                  int(g.dtype == torch.bfloat16), *_modes(padding_mode, align_corners),
                  _kernels.stream_handle(g.device))
    return dg, dw


def grid_sample_bwd_plain(x: torch.Tensor, gy: torch.Tensor, grid: torch.Tensor,
                          padding_mode: str = "border", align_corners: bool = True):
    """Plain version of kernel A's backward: the VJP of
    `grid_sample(x, grid)` against the pixel cotangent gy (B, Hg, Wg, C).
    Returns dx = S^T gy (B, H, W, C), accumulated in fp32 and returned in
    x.dtype, and the weight-gradient rows dw (B, 4, Hg, Wg) fp32."""
    B, H, W, C = x.shape
    _, Hg, Wg, _ = grid.shape
    idx, sep = _corners(grid, H, W, (padding_mode, align_corners))
    gf = gy.reshape(B, Hg * Wg, C).float()
    dw = _weight_grads(_gather_corners(x, idx), gf, *sep)
    dx = _scatter_corners(gf, idx, _bilinear(*sep), x.shape)
    return dx.to(x.dtype), dw.reshape(B, 4, Hg, Wg)


def grid_sample_bwd(x: torch.Tensor, gy: torch.Tensor, grid: torch.Tensor,
                    padding_mode: str = "border", align_corners: bool = True):
    """(dx, dw) of `grid_sample_bwd_plain`: kernel A-bwd on a CUDA tensor,
    the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return grid_sample_bwd_plain(x, gy, grid, padding_mode, align_corners)
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
                  int(x.dtype == torch.bfloat16), *_modes(padding_mode, align_corners),
                  _kernels.stream_handle(x.device))
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


class _TokenSoftmaxScatterFused(torch.autograd.Function):
    """(ew, zaw) of the token chain with the JAX fused lowering's VJP
    (smow_net_tpu/ops/pallas/warp.py `token_scatter_pallas`, `_tok_bwd`):
    forward D with no residual, backward D-bwd and its summed
    weight-gradient rows into dgrid. Only (a, grid, m) are saved. Each op
    routes by device."""

    @staticmethod
    def forward(ctx, a, grid):
        m = a.amax(dim=(1, 2)).float()
        ctx.save_for_backward(a, grid, m)
        return token_scatter(a, grid, m)

    @staticmethod
    def backward(ctx, ew_bar, dzaw):
        a, grid, m = ctx.saved_tensors
        if ew_bar is None:
            ew_bar = torch.zeros_like(a)
        if dzaw is None:
            dzaw = torch.zeros(a.shape[0], a.shape[-1], device=a.device)
        da, dw = token_scatter_bwd(a, grid, m, ew_bar, dzaw)
        return da, corner_weights_vjp(grid, dw, *a.shape[1:3])


class _FlowWarp(torch.autograd.Function):
    """`grid_sample(x, grid)` with the VJP of the JAX package's
    `grid_sample_pallas` (smow_net_tpu/ops/pallas/warp.py `_fwd`/`_bwd`):
    forward A, backward A-bwd and the weight-gradient rows into dgrid. Each
    op routes by device."""

    @staticmethod
    def forward(ctx, x, grid):
        ctx.save_for_backward(x, grid)
        return grid_sample(x, grid)

    @staticmethod
    def backward(ctx, gy):
        x, grid = ctx.saved_tensors
        dx, dw = grid_sample_bwd(x, gy.to(x.dtype).contiguous(), grid)
        return dx, corner_weights_vjp(grid, dw, *x.shape[1:3])


class _FlowWarpTranspose(torch.autograd.Function):
    """`grid_sample_transpose(g, grid, (H, W))` with the VJP of the JAX
    package's `grid_sample_transpose` (smow_net_tpu/ops/warp.py:137-214):
    forward B, backward C and the weight-gradient rows into dgrid."""

    @staticmethod
    def forward(ctx, g, grid, H, W):
        ctx.save_for_backward(g, grid)
        return grid_sample_transpose(g, grid, (H, W))

    @staticmethod
    def backward(ctx, xbar):
        g, grid = ctx.saved_tensors
        dg, dw = grid_sample_t_vjp(xbar.contiguous(), g, grid)
        return dg, corner_weights_vjp(grid, dw, *xbar.shape[1:3]), None, None


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Warp x (B, H, W, C) by a pixel-space flow (B, H, W, 2) (the reference
    OFW warp, models/SMOW_Net.py:612-631): bilinear, border, align_corners,
    on `flow_grid(flow)`; differentiable in x and flow."""
    B, H, W, _ = x.shape
    return _FlowWarp.apply(x.contiguous(), flow_grid(flow, H, W))


def flow_warp_transpose(g: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Adjoint of `flow_warp` as a primal op, on its own grid from the same
    flow; differentiable in g and flow."""
    B, H, W, _ = g.shape
    return _FlowWarpTranspose.apply(g.contiguous(), flow_grid(flow, H, W), H, W)


def token_softmax_scatter(a: torch.Tensor, flow: torch.Tensor, train_chain=None):
    """The OFW token chain (smow_net_tpu/ops/warp.py:217-257):

        aw  = flow_warp(a, flow)              (bilinear, border, align=True)
        eaw = exp(aw - m),  m = max_n a       per (frame, l), no gradient
        ew  = flow_warp_transpose(eaw, flow)
        zaw = sum_n eaw

    CONTRACT: ew and zaw share the per-(frame, l) scale exp(max_n aw - m);
    the caller divides ew by max(zaw, tiny). zaw >= 1 is not guaranteed: a
    warped-logit spread above ~87 underflows every exp and zaw -> 0.

    Without a gradient it is one kernel-D call with no residual. When a or
    flow needs a gradient, `train_chain` picks one of the JAX package's
    train lowerings (smow_net_tpu/ops/warp.py:276-313; there a global,
    `set_token_train_impl`, here an argument):
      "fused"    kernel D forward, no residual; D-bwd backward;
      "hybrid"   kernel E forward; C, an elementwise pass and A-bwd backward
                 (exp of the fp32 warped logits);
      "unfused"  flow_warp (A, A-bwd), exp in a's dtype, flow_warp_transpose
                 (B, C), each warp on its own grid, in JAX's dtype flow;
      None       as the JAX package's default picks by shape
                 (smow_net_tpu/ops/warp.py:292-299): the hybrid at W * C <=
                 1024, the unfused chain above.
    Every chain takes C = 8 and 16 at any W; the rule only picks one."""
    B, H, W, C = a.shape
    a = a.contiguous()
    if not (torch.is_grad_enabled() and (a.requires_grad or flow.requires_grad)):
        return token_scatter(a, flow_grid(flow, H, W), a.amax(dim=(1, 2)).float())
    if train_chain is None:
        train_chain = "hybrid" if W * C <= 1024 else "unfused"
    if train_chain == "fused":
        return _TokenSoftmaxScatterFused.apply(a, flow_grid(flow, H, W))
    if train_chain == "hybrid":
        return _TokenSoftmaxScatter.apply(a, flow_grid(flow, H, W))
    if train_chain != "unfused":
        raise ValueError(f"token_softmax_scatter: unknown train_chain {train_chain!r}")
    m = a.detach().amax(dim=(1, 2), keepdim=True)
    eaw = torch.exp(flow_warp(a, flow) - m)
    return flow_warp_transpose(eaw, flow), eaw.sum(dim=(1, 2))
