"""2-D selective-scan state-space layers, the VMamba core (port of
smow_net_tpu/nn/ssm.py: `DropPath`, `SS2D` with its whole constructor (K =
4 or 8 directions, the 1d/2d ablations, any d_state, the xv forward family),
`Mlp`, `VSSBlock` with remat, `VSSM` with patch embed v1/v2 and downsample
v2/v3).

Activations are channels-last (B, H, W, C), as in the JAX package and the
reference's VSSM; a conv permutes to NCHW and back. Module nesting and
parameter names give the reference's state_dict keys (the ones
smow_net_tpu/train/convert_zoo.py reads with zoo_specs "change_mamba" and
"rs_mamba"): `patch_embed.{0,2,5,7}` (v1: `patch_embed.{0,2}`),
`layers.{i}.blocks.{j}.{norm, op, norm2, mlp}`, `layers.{i}.downsample.{1,3}`,
`outnorm{i}`; SS2D's x_proj_weight (K, R+2N, Di), dt_projs_weight (K, Di,
R), dt_projs_bias (K, Di), A_logs (K*Di, N) and Ds (K*Di), with A =
-exp(A_logs) in fp32. LayerNorm eps 1e-5, exact GELU.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import scan
from ..ops.cross_scan import (cross_merge, cross_merge8, cross_merge_1d, cross_merge_2d,
                              cross_scan, cross_scan8, cross_scan_1b1, cross_scan_1d,
                              cross_scan_2d)

__all__ = ["DropPath", "Permute", "SS2D", "Mlp", "VSSBlock", "VSSM", "parse_xv"]

_TRAVERSALS = {"cross": (cross_scan, cross_merge), "1d": (cross_scan_1d, cross_merge_1d),
               "2d": (cross_scan_2d, cross_merge_2d)}
_XV_OUT_NORMS = ("none", "dwconv3", "softmax", "sigmoid")


class DropPath(nn.Module):
    """Stochastic depth: in train mode each sample's branch is kept with
    probability 1 - rate and scaled by 1 / (1 - rate); the identity in eval.
    The keep mask is drawn from `generator` (a torch.Generator on the
    tensors' device, which the train state owns and attaches), one draw per
    call, so a run can be repeated."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def draw(self, x: torch.Tensor) -> torch.Tensor:
        """The keep mask, (B, 1, ..., 1) boolean."""
        if self.generator is None:
            raise RuntimeError("DropPath in train mode needs a generator "
                               "(train.trainer.create_train_state attaches one)")
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        return torch.rand(shape, generator=self.generator, device=x.device) < 1.0 - self.rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        return x * self.draw(x).to(x.dtype) / (1.0 - self.rate)


class Permute(nn.Module):
    """The reference's layout step inside nn.Sequential (keeps its indices)."""

    def __init__(self, *dims: int):
        super().__init__()
        self.dims = dims

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute(*self.dims)


def parse_xv(forward_type: str):
    """An xv forward type -> (mode, out-norm kind, mul, act), the postfixes
    taken off in the JAX package's order: no32, the out-norm tag, mul, act.
    no32 is accepted and changes nothing (the scan carries its recurrence
    in fp32 always)."""
    ft = forward_type
    if ft.endswith("no32"):
        ft = ft[:-len("no32")]
    norm = "ln"
    for tag in _XV_OUT_NORMS:
        if ft.endswith(tag):
            norm, ft = tag, ft[:-len(tag)]
            break
    mul = ft.endswith("mul")
    ft = ft[:-3] if mul else ft
    act = ft.endswith("act")
    ft = ft[:-3] if act else ft
    if ft not in ("xv1a", "xv2a", "xv3a"):
        raise ValueError(f"unsupported xv mode {forward_type!r}: only xv1a, xv2a and xv3a "
                         "with their postfixes exist")
    return ft, norm, mul, act


class SS2D(nn.Module):
    """The 2-D selective-scan block (reference SS2D).

    Forward type v2 (the default): in_proj to (x, z), a depthwise conv +
    SiLU on x, the cross-scan (K = 4: `scan_variant` "cross", or the "1d" /
    "2d" ablations; K = 8: RS-Mamba's eight directions), x_proj to (dt, B,
    C), dt_proj, the selective scan (ops.scan.cross_selective_scan: kernel
    I on the card where d_state is 16, the general route otherwise), the
    cross-merge, LayerNorm, the SiLU(z) gate and out_proj.

    Forward types xv1a, xv2a, xv3a (+ postfixes `act`, `mul`, an out-norm
    `none` / `dwconv3` / `softmax` / `sigmoid`, `no32`): a depthwise conv +
    SiLU on the d_model input, one in_proj to u, dt (rank R / Di channels /
    R per direction), B and C per direction (through `cross_scan_1b1`), K =
    4, no z gate. The out-norms other than LayerNorm act channel-first: the
    softmax over the spatial positions of each channel, the depthwise 3x3
    conv over the (H, W) map (the JAX package's semantics; the reference's
    channel-last composition is shape-inconsistent there)."""

    def __init__(self, d_model: int, d_state: int = 16, ssm_ratio: float = 2.0,
                 dt_rank="auto", d_conv: int = 3, conv_bias: bool = True, bias: bool = False,
                 k_group: int = 4, dropout: float = 0.0, scan_variant: str = "cross",
                 forward_type: str = "v2"):
        super().__init__()
        if k_group not in (4, 8):
            raise ValueError(f"SS2D: k_group must be 4 or 8, not {k_group}")
        if scan_variant not in _TRAVERSALS:
            raise ValueError(f"SS2D: scan_variant must be one of {tuple(_TRAVERSALS)}")
        Di = int(ssm_ratio * d_model)
        R = math.ceil(d_model / 16) if dt_rank == "auto" else int(dt_rank)
        N = d_state
        self.Di, self.R, self.N, self.d_conv = Di, R, N, d_conv
        self.xv = parse_xv(forward_type) if forward_type.startswith("xv") else None
        if self.xv is None:
            K = k_group
            self.traverse = ((cross_scan8, cross_merge8) if K == 8
                             else _TRAVERSALS[scan_variant])
            self.in_proj = nn.Linear(d_model, 2 * Di, bias=bias)
            conv_ch = Di
            self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2 * N, Di))
            has_dt_proj = True
        else:
            K = 4
            mode, norm, _, _ = self.xv
            dt_width = {"xv1a": R, "xv2a": Di, "xv3a": 4 * R}[mode]
            self.in_proj = nn.Linear(d_model, Di + dt_width + 8 * N, bias=bias)
            self.widths = [Di, dt_width, 4 * N, 4 * N]
            conv_ch = d_model
            has_dt_proj = mode != "xv2a"
        self.K = K
        self.conv2d = (nn.Conv2d(conv_ch, conv_ch, d_conv, padding=(d_conv - 1) // 2,
                                 groups=conv_ch, bias=conv_bias) if d_conv > 1 else None)
        self.dt_projs_weight = nn.Parameter(torch.empty(K, Di, R)) if has_dt_proj else None
        self.dt_projs_bias = nn.Parameter(torch.empty(K, Di))
        self.A_logs = nn.Parameter(torch.empty(K * Di, N))
        self.Ds = nn.Parameter(torch.empty(K * Di))
        norm = "ln" if self.xv is None else self.xv[1]
        if norm == "ln":
            self.out_norm = nn.LayerNorm(Di, eps=1e-5)
        elif norm == "dwconv3":
            self.out_norm = nn.Conv2d(Di, Di, 3, padding=1, groups=Di, bias=False)
        else:
            self.out_norm = None
        self.out_proj = nn.Linear(Di, d_model, bias=bias)
        self.do = nn.Dropout(dropout) if dropout > 0 else None
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """The reference's initialisation (the JAX package's initialisers)."""
        for lin in (self.in_proj, self.out_proj):
            nn.init.trunc_normal_(lin.weight, std=0.02, a=-0.04, b=0.04)
            if lin.bias is not None:
                lin.bias.zero_()
        if self.xv is None:
            bound = self.Di ** -0.5
            self.x_proj_weight.uniform_(-bound, bound)
        if self.dt_projs_weight is not None:
            self.dt_projs_weight.uniform_(-self.R ** -0.5, self.R ** -0.5)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(torch.rand(self.dt_projs_bias.shape) * (hi - lo) + lo).clamp_min(1e-4)
        self.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))    # inverse softplus
        self.A_logs.copy_(torch.log(torch.arange(1, self.N + 1, dtype=torch.float32))
                          .expand_as(self.A_logs))
        self.Ds.fill_(1.0)

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2d(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def _scan(self, xs, dts, Bs, Cs) -> torch.Tensor:
        A = -torch.exp(self.A_logs.float())
        return scan.cross_selective_scan(xs, dts, A, Bs, Cs, self.Ds,
                                         self.dt_projs_bias.reshape(-1), delta_softplus=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._forward_xv(x) if self.xv is not None else self._forward_v2(x)
        return y if self.do is None else self.do(y)

    def _forward_v2(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        xx, z = self.in_proj(x).chunk(2, dim=-1)
        if self.conv2d is not None:
            xx = self._conv(xx)
        xx = F.silu(xx)
        traverse, merge = self.traverse
        xs = traverse(xx)                                              # (B, K, L, Di)
        x_dbl = torch.einsum("bkld,kcd->bklc", xs, self.x_proj_weight)
        dts, Bs, Cs = torch.split(x_dbl, [self.R, self.N, self.N], dim=-1)
        dts = torch.einsum("bklr,kdr->bkld", dts, self.dt_projs_weight)
        ys = self._scan(xs, dts, Bs, Cs)
        y = self.out_norm(merge(ys, H, W)).reshape(B, H, W, self.Di)
        return self.out_proj(y * F.silu(z))

    def _forward_xv(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        mode, norm, mul, act = self.xv
        if self.conv2d is not None:
            x = F.silu(self._conv(x))
        us_raw, dts_raw, Bs_raw, Cs_raw = torch.split(self.in_proj(x), self.widths, dim=-1)
        us, Bs, Cs = cross_scan(us_raw), cross_scan_1b1(Bs_raw), cross_scan_1b1(Cs_raw)
        if mode == "xv2a":
            dts = cross_scan(dts_raw)                                 # no dt projection
        else:
            dts = (cross_scan if mode == "xv1a" else cross_scan_1b1)(dts_raw)
            dts = torch.einsum("bklr,kdr->bkld", dts, self.dt_projs_weight)
        y = cross_merge(self._scan(us, dts, Bs, Cs), H, W)             # (B, L, Di)
        if norm == "ln":
            y = self.out_norm(y)
        elif norm == "sigmoid":
            y = torch.sigmoid(y)
        elif norm == "softmax":
            y = torch.softmax(y, dim=1)                # over the positions of each channel
        y = y.reshape(B, H, W, self.Di)
        if norm == "dwconv3":
            y = self.out_norm(y.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        if act:
            y = F.gelu(y)
        if mul:
            y = y * us_raw
        return self.out_proj(y)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = nn.Dropout(drop) if drop > 0 else nn.Identity()
        for lin in (self.fc1, self.fc2):
            nn.init.trunc_normal_(lin.weight, std=0.02, a=-0.04, b=0.04)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(F.gelu(self.fc1(x)))))


class VSSBlock(nn.Module):
    """x + DropPath(SS2D(LN(x))), then x + DropPath(Mlp(LN(x))); either
    branch absent at a ratio of 0. With `remat` the SS2D runs under
    torch.utils.checkpoint (its activations recomputed in the backward,
    the JAX package's nn.remat around the SS2D only); the DropPath masks
    are drawn outside it, so a recompute never draws again."""

    def __init__(self, dim: int, drop_path: float = 0.0, ssm_d_state: int = 16,
                 ssm_ratio: float = 2.0, ssm_dt_rank="auto", ssm_conv: int = 3,
                 ssm_conv_bias: bool = True, ssm_drop_rate: float = 0.0, mlp_ratio: float = 4.0,
                 mlp_drop_rate: float = 0.0, k_group: int = 4, scan_variant: str = "cross",
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        if ssm_ratio > 0:
            self.norm = nn.LayerNorm(dim, eps=1e-5)
            self.op = SS2D(dim, ssm_d_state, ssm_ratio, ssm_dt_rank, ssm_conv, ssm_conv_bias,
                           dropout=ssm_drop_rate, k_group=k_group, scan_variant=scan_variant)
        else:
            self.op = None
        self.drop_path = DropPath(drop_path)
        if mlp_ratio > 0:
            self.norm2 = nn.LayerNorm(dim, eps=1e-5)
            self.mlp = Mlp(dim, int(dim * mlp_ratio), mlp_drop_rate)
        else:
            self.mlp = None

    def _ss2d(self, y: torch.Tensor) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return self.op(y)
        # the SS2D's parameters as the forward sees them (a train step's
        # functional_call swaps in bf16 copies) go in as inputs, so the
        # recompute uses the same tensors and their gradients flow back
        names, tensors = zip(*self.op.named_parameters())

        def run(y, *tensors):
            return torch.func.functional_call(self.op, dict(zip(names, tensors)), (y,))

        return checkpoint(run, y, *tensors, use_reentrant=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.op is not None:
            x = x + self.drop_path(self._ss2d(self.norm(x)))
        if self.mlp is not None:
            x = x + self.drop_path(self.mlp(self.norm2(x)))
        return x


class _Stage(nn.Module):
    def __init__(self, blocks: nn.Module, downsample: nn.Module):
        super().__init__()
        self.blocks, self.downsample = blocks, downsample


class VSSM(nn.Module):
    """The VSSM backbone: a patch embed (v2: two stride-2 3x3 convs with
    LayerNorm and GELU between; v1: one 4x4 stride-4 conv + LayerNorm), the
    VSS stages with drop-path rates rising linearly to `drop_path_rate`, a
    downsample after each stage but the last (v2: 2x2 stride-2 conv; v3:
    3x3 stride-2 pad-1 conv; then LayerNorm); returns the LayerNorm'd
    output (channels-last) of each stage in `out_indices`, taken before its
    downsample. The VSSBlocks take the ssm_* and mlp_* options, `k_group`
    and, with `use_checkpoint`, remat."""

    def __init__(self, depths=(2, 2, 9, 2), dims=(96, 192, 384, 768),
                 drop_path_rate: float = 0.1, *, ssm_d_state: int = 16, ssm_ratio: float = 2.0,
                 ssm_dt_rank="auto", ssm_conv: int = 3, ssm_conv_bias: bool = True,
                 ssm_drop_rate: float = 0.0, mlp_ratio: float = 4.0, mlp_drop_rate: float = 0.0,
                 patchembed_version: str = "v2", downsample_version: str = "v2",
                 k_group: int = 4, out_indices=(0, 1, 2, 3), use_checkpoint: bool = False):
        super().__init__()
        d0 = dims[0]
        if patchembed_version == "v1":
            self.patch_embed = nn.Sequential(
                nn.Conv2d(3, d0, 4, 4), Permute(0, 2, 3, 1), nn.LayerNorm(d0, eps=1e-5))
        else:
            self.patch_embed = nn.Sequential(
                nn.Conv2d(3, d0 // 2, 3, 2, 1), Permute(0, 2, 3, 1),
                nn.LayerNorm(d0 // 2, eps=1e-5), Permute(0, 3, 1, 2), nn.GELU(),
                nn.Conv2d(d0 // 2, d0, 3, 2, 1), Permute(0, 2, 3, 1), nn.LayerNorm(d0, eps=1e-5))
        k, p = (2, 0) if downsample_version == "v2" else (3, 1)
        self.out_indices = tuple(out_indices)
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        layers, cur = [], 0
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            blocks = nn.Sequential(*[
                VSSBlock(dim, float(dpr[cur + j]), ssm_d_state, ssm_ratio, ssm_dt_rank, ssm_conv,
                         ssm_conv_bias, ssm_drop_rate, mlp_ratio, mlp_drop_rate, k_group=k_group,
                         remat=use_checkpoint)
                for j in range(depth)])
            cur += depth
            down = (nn.Sequential(Permute(0, 3, 1, 2), nn.Conv2d(dim, dims[i + 1], k, 2, p),
                                  Permute(0, 2, 3, 1), nn.LayerNorm(dims[i + 1], eps=1e-5))
                    if i < len(dims) - 1 else nn.Identity())
            layers.append(_Stage(blocks, down))
            if i in self.out_indices:
                self.add_module(f"outnorm{i}", nn.LayerNorm(dim, eps=1e-5))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor):
        """x (B, C, H, W) -> the features (B, H/4/2^i, W/4/2^i, dims[i]) of
        the stages in out_indices."""
        x = self.patch_embed(x)
        outs = []
        for i, layer in enumerate(self.layers):
            x = layer.blocks(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"outnorm{i}")(x))
            x = layer.downsample(x)
        return outs
