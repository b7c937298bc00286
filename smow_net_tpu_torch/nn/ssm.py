"""2-D selective-scan state-space layers, the VMamba core (port of
smow_net_tpu/nn/ssm.py: `DropPath`, `SS2D` forward type v2 with the
4-direction cross-scan, `Mlp`, `VSSBlock`, `VSSM` with patch-embed v2 and
downsample v2).

Activations are channels-last (B, H, W, C), as in the JAX package and the
reference's VSSM; a conv permutes to NCHW and back. Module nesting and
parameter names give the reference's state_dict keys (the ones
smow_net_tpu/train/convert_zoo.py reads with zoo_specs "change_mamba"):
`patch_embed.{0,2,5,7}`, `layers.{i}.blocks.{j}.{norm, op, norm2, mlp}`,
`layers.{i}.downsample.{1,3}`, `outnorm{i}`; SS2D's x_proj_weight (K, R+2N,
Di), dt_projs_weight (K, Di, R), dt_projs_bias (K, Di), A_logs (K*Di, N) and
Ds (K*Di), with A = -exp(A_logs) in fp32. LayerNorm eps 1e-5, exact GELU.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import scan
from ..ops.cross_scan import cross_merge, cross_scan

__all__ = ["DropPath", "Permute", "SS2D", "Mlp", "VSSBlock", "VSSM"]


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


class SS2D(nn.Module):
    """The 2-D selective-scan block, forward type v2, K = 4 directions
    (reference SS2D forwardv2): in_proj to (x, z), depthwise 3x3 conv + SiLU
    on x, cross-scan, x_proj to (dt, B, C), dt_proj, the selective scan
    (ops.scan.cross_selective_scan: kernel I on the card), cross-merge,
    LayerNorm, the SiLU(z) gate and out_proj. d_state 16 and ssm_ratio 2, as
    every VMamba model of the repo uses."""

    N, K = 16, 4

    def __init__(self, d_model: int):
        super().__init__()
        Di, R, N, K = 2 * d_model, math.ceil(d_model / 16), self.N, self.K
        self.Di, self.R = Di, R
        self.in_proj = nn.Linear(d_model, 2 * Di, bias=False)
        self.conv2d = nn.Conv2d(Di, Di, 3, padding=1, groups=Di)
        self.x_proj_weight = nn.Parameter(torch.empty(K, R + 2 * N, Di))
        self.dt_projs_weight = nn.Parameter(torch.empty(K, Di, R))
        self.dt_projs_bias = nn.Parameter(torch.empty(K, Di))
        self.A_logs = nn.Parameter(torch.empty(K * Di, N))
        self.Ds = nn.Parameter(torch.empty(K * Di))
        self.out_norm = nn.LayerNorm(Di, eps=1e-5)
        self.out_proj = nn.Linear(Di, d_model, bias=False)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """The reference's initialisation (the JAX package's initialisers)."""
        for lin in (self.in_proj, self.out_proj):
            nn.init.trunc_normal_(lin.weight, std=0.02, a=-0.04, b=0.04)
        bound = self.Di ** -0.5
        self.x_proj_weight.uniform_(-bound, bound)
        self.dt_projs_weight.uniform_(-self.R ** -0.5, self.R ** -0.5)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(torch.rand(self.dt_projs_bias.shape) * (hi - lo) + lo).clamp_min(1e-4)
        self.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))    # inverse softplus
        self.A_logs.copy_(torch.log(torch.arange(1, self.N + 1, dtype=torch.float32))
                          .expand_as(self.A_logs))
        self.Ds.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, _ = x.shape
        xx, z = self.in_proj(x).chunk(2, dim=-1)
        xx = F.silu(self.conv2d(xx.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        xs = cross_scan(xx)                                            # (B, K, L, Di)
        x_dbl = torch.einsum("bkld,kcd->bklc", xs, self.x_proj_weight)
        dts, Bs, Cs = torch.split(x_dbl, [self.R, self.N, self.N], dim=-1)
        dts = torch.einsum("bklr,kdr->bkld", dts, self.dt_projs_weight)
        A = -torch.exp(self.A_logs.float())
        ys = scan.cross_selective_scan(xs, dts, A, Bs, Cs, self.Ds,
                                       self.dt_projs_bias.reshape(-1), delta_softplus=True)
        y = self.out_norm(cross_merge(ys, H, W)).reshape(B, H, W, self.Di)
        return self.out_proj(y * F.silu(z))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        for lin in (self.fc1, self.fc2):
            nn.init.trunc_normal_(lin.weight, std=0.02, a=-0.04, b=0.04)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class VSSBlock(nn.Module):
    """x + DropPath(SS2D(LN(x))), then x + DropPath(Mlp(LN(x))), the MLP
    4x wide."""

    def __init__(self, dim: int, drop_path: float = 0.0):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)
        self.op = SS2D(dim)
        self.drop_path = DropPath(drop_path)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, 4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path(self.op(self.norm(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class _Stage(nn.Module):
    def __init__(self, blocks: nn.Module, downsample: nn.Module):
        super().__init__()
        self.blocks, self.downsample = blocks, downsample


class VSSM(nn.Module):
    """The VSSM backbone: patch embed v2 (two stride-2 3x3 convs with
    LayerNorm and GELU between), the VSS stages with drop-path rates rising
    linearly to `drop_path_rate`, downsample v2 (2x2 stride-2 conv +
    LayerNorm); returns each stage's LayerNorm'd output (channels-last),
    taken before its downsample."""

    def __init__(self, depths=(2, 2, 9, 2), dims=(96, 192, 384, 768),
                 drop_path_rate: float = 0.1):
        super().__init__()
        d0 = dims[0]
        self.patch_embed = nn.Sequential(
            nn.Conv2d(3, d0 // 2, 3, 2, 1), Permute(0, 2, 3, 1),
            nn.LayerNorm(d0 // 2, eps=1e-5), Permute(0, 3, 1, 2), nn.GELU(),
            nn.Conv2d(d0 // 2, d0, 3, 2, 1), Permute(0, 2, 3, 1), nn.LayerNorm(d0, eps=1e-5))
        dpr = np.linspace(0, drop_path_rate, sum(depths))
        layers, cur = [], 0
        for i, (dim, depth) in enumerate(zip(dims, depths)):
            blocks = nn.Sequential(*[VSSBlock(dim, float(dpr[cur + j])) for j in range(depth)])
            cur += depth
            down = (nn.Sequential(Permute(0, 3, 1, 2), nn.Conv2d(dim, dims[i + 1], 2, 2),
                                  Permute(0, 2, 3, 1), nn.LayerNorm(dims[i + 1], eps=1e-5))
                    if i < len(dims) - 1 else nn.Identity())
            layers.append(_Stage(blocks, down))
            self.add_module(f"outnorm{i}", nn.LayerNorm(dim, eps=1e-5))
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor):
        """x (B, C, H, W) -> per-stage features (B, H/4/2^i, W/4/2^i, dims[i])."""
        x = self.patch_embed(x)
        outs = []
        for i, layer in enumerate(self.layers):
            x = layer.blocks(x)
            outs.append(getattr(self, f"outnorm{i}")(x))
            x = layer.downsample(x)
        return outs
