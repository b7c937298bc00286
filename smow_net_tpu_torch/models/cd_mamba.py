"""CD-Mamba: a MONAI-SegResNet-style encoder/decoder whose conv blocks are
ConvMamba (a bidirectional 1-D selective scan plus a conv local-relation
branch), with adaptive local/global gated fusion of the two temporal
branches (port of smow_net_tpu/models/zoo/cd_mamba.py; the reference's
recipe: init_filters 16, blocks_down (1, 2, 2, 4), blocks_up (1, 1, 1),
stage 2, GroupNorm(8), d_state 16, expand 2, "AGLGF" fusion, SRCM blocks,
"deepwise" decoder convs, ReLU gates).

Images are NCHW; the Mamba parts run on (B, L = H*W, C) sequences, L in
row-major (h, w) order as in the JAX package. LayerNorm normalises over
channels. Every selective scan goes through `ops.scan.selective_scan`
(kernel H on the card), called through its module so a test can swap it.

Module nesting and parameter names give the reference's state_dict keys
(the ones smow_net_tpu/train/convert_zoo.py reads with zoo_specs'
"cd_mamba"): `convInit`, `srcm_encoder_layers.{i}.{0: the down layer and
its pool, 1..: blocks}`, `l_gf{i}` / `g_gf{i}` (the L_GF encoder's
misspelt `lcoal_relation`), `ag{i}.gate`, `up_samples.{i}.0`,
`srcm_decoder_layers.{i}.0`, `conv_final.{0, 2}`; a Mamba's seven leaves
sit on the module that uses them, named `A_log`, `D`, `conv1d`, `x_proj`,
`dt_proj` with `_b` (backward direction) and `_g` (the global query's core)
variants (`A_b_log`, `D_b`, `conv1d_b`, ...). dt_proj's bias is the scan's
delta_bias (fp32, before the softplus), not the Linear's; x_proj has no
bias; A = -exp(A_log) in fp32; the dt rank is ceil(d_model / 16).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import scan
from ..ops.convops import causal_conv1d
from ..ops.pooling import max_pool
from ..ops.resize import resize_nearest

__all__ = ["CDMamba", "ConvMamba", "GatedFusionMamba", "GF", "SRCMLayer", "SRCMBlock",
           "Mamba1DCore", "Mamba1DParams", "declare_mamba_params", "mamba_core",
           "mamba_bidir", "mamba_cache_init", "mamba_core_step"]

D_STATE = 16
D_CONV = 4


def declare_mamba_params(owner: nn.Module, d_inner: int, dt_rank: int,
                         d_state: int = D_STATE, d_conv: int = D_CONV, sfx: str = "") -> None:
    """Register one direction's seven leaves on `owner` under the
    reference's names with suffix `sfx` ("", "_b" or "_g"), initialised as
    the reference does (the JAX package's initialisers)."""
    owner.add_module(f"conv1d{sfx}", nn.Conv1d(d_inner, d_inner, d_conv, groups=d_inner))
    owner.add_module(f"x_proj{sfx}", nn.Linear(d_inner, dt_rank + 2 * d_state, bias=False))
    dt_proj = nn.Linear(dt_rank, d_inner)
    with torch.no_grad():
        dt_proj.weight.uniform_(-dt_rank ** -0.5, dt_rank ** -0.5)
        lo, hi = math.log(1e-3), math.log(0.1)
        dt = torch.exp(torch.rand(d_inner) * (hi - lo) + lo).clamp_min(1e-4)
        dt_proj.bias.copy_(dt + torch.log(-torch.expm1(-dt)))        # inverse softplus
    owner.add_module(f"dt_proj{sfx}", dt_proj)
    owner.register_parameter(f"A{sfx}_log", nn.Parameter(
        torch.log(torch.arange(1, d_state + 1, dtype=torch.float32)).repeat(d_inner, 1)))
    owner.register_parameter(f"D{sfx}", nn.Parameter(torch.ones(d_inner)))


def Mamba1DParams(owner: nn.Module, sfx: str = "") -> dict:
    """One direction's leaves on `owner` (the JAX package's `Mamba1DParams`
    dict): conv1d, x_proj, dt_proj (modules), A_log, D (parameters)."""
    return {"conv1d": getattr(owner, f"conv1d{sfx}"), "x_proj": getattr(owner, f"x_proj{sfx}"),
            "dt_proj": getattr(owner, f"dt_proj{sfx}"), "A_log": getattr(owner, f"A{sfx}_log"),
            "D": getattr(owner, f"D{sfx}")}


def mamba_core(x: torch.Tensor, p: dict) -> torch.Tensor:
    """One direction of mamba_inner before the gate, (B, L, Di) -> (B, L,
    Di): causal depthwise conv, SiLU, the (dt, B, C) projections, the
    selective scan (G = 1)."""
    Di = x.shape[-1]
    R, N = p["dt_proj"].weight.shape[1], p["A_log"].shape[-1]
    x = F.silu(causal_conv1d(x, p["conv1d"].weight, p["conv1d"].bias, groups=Di))
    dt, Bm, Cm = torch.split(p["x_proj"](x), [R, N, N], dim=-1)
    delta = F.linear(dt, p["dt_proj"].weight)
    A = -torch.exp(p["A_log"].float())
    return scan.selective_scan(x, delta, A, Bm[:, :, None], Cm[:, :, None], p["D"],
                               p["dt_proj"].bias, delta_softplus=True)


def mamba_bidir(x: torch.Tensor, pf: dict, pb: dict) -> torch.Tensor:
    """fwd(x) + flip(bwd(flip(x))) as ONE selective scan with G = 2: the
    two directions folded into the feature axis (the depthwise convs
    concatenated, per-direction projections), each group with its own (B,
    C) gates; dt and u are per channel. The same function as two
    `mamba_core` calls (the JAX package's fold, zoo/cd_mamba.py:153-180),
    with twice the scan's rows."""
    B, L, Di = x.shape
    R, N = pf["dt_proj"].weight.shape[1], pf["A_log"].shape[-1]
    x2 = torch.cat([x, x.flip(1)], dim=-1)                                  # (B, L, 2Di)
    w = torch.cat([pf["conv1d"].weight, pb["conv1d"].weight], dim=0)
    b = torch.cat([pf["conv1d"].bias, pb["conv1d"].bias], dim=0)
    x2 = F.silu(causal_conv1d(x2, w, b, groups=2 * Di))
    xw = torch.stack([pf["x_proj"].weight, pb["x_proj"].weight])            # (2, R+2N, Di)
    dbl = torch.einsum("blde,dfe->bldf", x2.reshape(B, L, 2, Di), xw)
    dt, Bm, Cm = torch.split(dbl, [R, N, N], dim=-1)                        # (B, L, 2, .)
    dtw = torch.stack([pf["dt_proj"].weight, pb["dt_proj"].weight])         # (2, Di, R)
    delta = torch.einsum("bldr,der->blde", dt, dtw).reshape(B, L, 2 * Di)
    A = -torch.exp(torch.cat([pf["A_log"], pb["A_log"]], dim=0).float())
    D = torch.cat([pf["D"], pb["D"]], dim=0)
    dt_bias = torch.cat([pf["dt_proj"].bias, pb["dt_proj"].bias], dim=0)
    y = scan.selective_scan(x2, delta, A, Bm, Cm, D, dt_bias, delta_softplus=True)
    return y[..., :Di] + y[..., Di:].flip(1)


class Mamba1DCore(nn.Module):
    """One direction of mamba_inner with its own leaves (A_log, D, conv1d,
    x_proj, dt_proj): the JAX package's `Mamba1DCore`."""

    def __init__(self, d_inner: int, d_state: int = D_STATE, dt_rank: int = 2,
                 d_conv: int = D_CONV):
        super().__init__()
        declare_mamba_params(self, d_inner, dt_rank, d_state, d_conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mamba_core(x, Mamba1DParams(self))


def mamba_cache_init(batch: int, d_inner: int, d_state: int = D_STATE, d_conv: int = D_CONV,
                     dtype=torch.float32, device=None):
    """Decode-time cache of one direction: conv_state (B, d_conv, Di), the
    rolling window of inputs, and ssm_state (B, Di, N) fp32, the scan's
    carry (reference Mamba.allocate_inference_cache)."""
    return (torch.zeros(batch, d_conv, d_inner, dtype=dtype, device=device),
            torch.zeros(batch, d_inner, d_state, dtype=torch.float32, device=device))


def mamba_core_step(p: dict, x_t: torch.Tensor, conv_state: torch.Tensor,
                    ssm_state: torch.Tensor):
    """One token of `mamba_core` (reference Mamba.step): roll the conv
    window, the depthwise tap, SiLU, the projections, one scan step. x_t
    (B, Di). Returns (y_t, conv_state', ssm_state'); token by token over a
    sequence it gives `mamba_core`'s output."""
    kconv = p["conv1d"].weight[:, 0, :]                                     # (Di, d_conv)
    conv_state = torch.cat([conv_state[:, 1:], x_t[:, None]], dim=1)
    x = torch.einsum("bkd,dk->bd", conv_state.float(), kconv.float()).to(x_t.dtype)
    x = F.silu(x + p["conv1d"].bias)
    R, N = p["dt_proj"].weight.shape[1], p["A_log"].shape[-1]
    dt, Bm, Cm = torch.split(p["x_proj"](x), [R, N, N], dim=-1)
    delta = F.linear(dt, p["dt_proj"].weight)
    A = -torch.exp(p["A_log"].float())
    y, ssm_state = scan.selective_scan_step(ssm_state, x, delta, A, Bm[:, None], Cm[:, None],
                                            p["D"], p["dt_proj"].bias, delta_softplus=True)
    return y, conv_state, ssm_state


def _to_seq(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


def _to_map(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, H*W, C) -> (B, C, H, W)."""
    return x.transpose(1, 2).reshape(x.shape[0], -1, H, W)


class _DWConv(nn.Module):
    """Depthwise 3x3 then pointwise 1x1 (the reference's DWConv)."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.depthwise_conv = nn.Conv2d(c_in, c_in, 3, 1, 1, groups=c_in)
        self.pointwise_conv = nn.Conv2d(c_in, c_out, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise_conv(self.depthwise_conv(x))


def local_relation(c_in: int, d_inner: int, conv_mode: str = "orignal_dinner") -> nn.Module:
    """The conv branch (`_LocalRelation`): conv3 -> SiLU -> conv3
    ("orignal_dinner"), or depthwise + pointwise pairs ("deepwise")."""
    if conv_mode == "deepwise":
        return nn.Sequential(_DWConv(c_in, c_in), nn.SiLU(), _DWConv(c_in, d_inner))
    if conv_mode != "orignal_dinner":
        raise ValueError(f"conv_mode {conv_mode!r}")
    return nn.Sequential(nn.Conv2d(c_in, d_inner, 3, 1, 1), nn.SiLU(),
                         nn.Conv2d(d_inner, d_inner, 3, 1, 1))


class ConvMamba(nn.Module):
    """The bidirectional Mamba plus the additive conv local relation, on a
    (B, L, C) sequence of an H x W map."""

    def __init__(self, d_model: int, expand: int = 2, d_state: int = D_STATE,
                 conv_mode: str = "orignal_dinner"):
        super().__init__()
        Di, R = expand * d_model, math.ceil(d_model / 16)
        self.local_relation = local_relation(d_model, Di, conv_mode)
        self.in_proj = nn.Linear(d_model, 2 * Di, bias=False)
        declare_mamba_params(self, Di, R, d_state)
        declare_mamba_params(self, Di, R, d_state, sfx="_b")
        self.out_proj = nn.Linear(Di, d_model, bias=False)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        local = _to_seq(self.local_relation(_to_map(x, H, W)))
        xx, z = self.in_proj(x).chunk(2, dim=-1)
        y = mamba_bidir(xx, Mamba1DParams(self), Mamba1DParams(self, "_b")) * F.silu(z)
        return self.out_proj(y + local)


class GatedFusionMamba(nn.Module):
    """The bidirectional scan of x gated by ReLU of a query from the other
    image: the conv local relation ("local", L_GF) or a third Mamba, a
    single-direction core with its `_g` leaves ("global", G_GF)."""

    def __init__(self, d_model: int, mode: str, expand: int = 2, d_state: int = D_STATE):
        super().__init__()
        Di, R = expand * d_model, math.ceil(d_model / 16)
        self.mode = mode
        self.in_proj = nn.Linear(d_model, 2 * Di, bias=False)
        declare_mamba_params(self, Di, R, d_state)
        declare_mamba_params(self, Di, R, d_state, sfx="_b")
        if mode == "local":
            self.lcoal_relation = local_relation(d_model, Di)    # the reference's spelling
        elif mode == "global":
            self.in_proj_global = nn.Linear(d_model, 2 * Di, bias=False)
            declare_mamba_params(self, Di, R, d_state, sfx="_g")
        else:
            raise ValueError(f"mode {mode!r}")
        self.out_proj = nn.Linear(Di, d_model, bias=False)

    def forward(self, x: torch.Tensor, other: torch.Tensor, H: int, W: int) -> torch.Tensor:
        xx, z = self.in_proj(x).chunk(2, dim=-1)
        y = mamba_bidir(xx, Mamba1DParams(self), Mamba1DParams(self, "_b")) * F.silu(z)
        if self.mode == "local":
            q = _to_seq(self.lcoal_relation(_to_map(other, H, W)))
        else:
            ox, oz = self.in_proj_global(other).chunk(2, dim=-1)
            q = mamba_core(ox, Mamba1DParams(self, "_g")) * F.silu(oz)
        return self.out_proj(y * F.relu(q))


class GF(nn.Module):
    """L_GF / G_GF: LayerNorm both inputs, cross-query both ways through one
    2B-batched call (the ops are batch-independent, so this is exact)."""

    def __init__(self, dim: int, mode: str):
        super().__init__()
        self.fusionencoder = GatedFusionMamba(dim, mode)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        B, C, H, W = x1.shape
        a, b = self.norm1(_to_seq(x1)), self.norm2(_to_seq(x2))
        q = _to_map(self.fusionencoder(torch.cat([a, b]), torch.cat([b, a]), H, W), H, W)
        return q[:B], q[B:]


class SRCMLayer(nn.Module):
    """LN -> ConvMamba (+ skip_scale * x) -> the same LN -> Linear to
    out_dim (the reference reuses its one norm)."""

    def __init__(self, in_dim: int, out_dim: int, conv_mode: str = "orignal_dinner"):
        super().__init__()
        self.norm = nn.LayerNorm(in_dim, eps=1e-5)
        self.skip_scale = nn.Parameter(torch.ones(1))
        self.convmamba = ConvMamba(in_dim, conv_mode=conv_mode)
        self.proj = nn.Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        flat = _to_seq(x)
        y = self.convmamba(self.norm(flat), H, W) + self.skip_scale * flat
        return _to_map(self.proj(self.norm(y)), H, W)


class SRCMBlock(nn.Module):
    """GN8 -> ReLU -> SRCM -> GN8 -> ReLU -> SRCM -> + identity."""

    def __init__(self, channels: int, conv_mode: str = "orignal_dinner"):
        super().__init__()
        self.norm1 = nn.GroupNorm(8, channels, eps=1e-5)
        self.conv1 = SRCMLayer(channels, channels, conv_mode)
        self.norm2 = nn.GroupNorm(8, channels, eps=1e-5)
        self.conv2 = SRCMLayer(channels, channels, conv_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(y))) + x


class _Down(nn.Sequential):
    """An encoder stage's SRCM layer to its width, then a 2x2 max pool."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(SRCMLayer(in_dim, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool(self[0](x), 2, 2)


class _Up(nn.Sequential):
    """A decoder stage's bias-free 1x1 conv, then 2x nearest upsampling."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__(nn.Conv2d(in_dim, out_dim, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self[0](x)
        return resize_nearest(x, (2 * x.shape[2], 2 * x.shape[3]))


class _Gate(nn.Module):
    """The adaptive gate `ag{i}`: softmax weights for the local and global
    fusions from their pooled features."""

    def __init__(self, dim: int):
        super().__init__()
        self.gate = nn.Linear(2 * dim, 2, bias=False)

    def forward(self, l: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        s = torch.softmax(self.gate(torch.cat([l.mean((2, 3)), g.mean((2, 3))], dim=-1)), -1)
        return s[:, 0, None, None, None] * l + s[:, 1, None, None, None] * g


class CDMamba(nn.Module):
    def __init__(self, init_filters: int = 16, in_channels: int = 3, out_channels: int = 2,
                 blocks_down=(1, 2, 2, 4), blocks_up=(1, 1, 1), stage: int = 2):
        super().__init__()
        f = init_filters
        chans = [f, f * 2, f * 4, f * 8]
        self.stage = stage
        self.convInit = nn.Conv2d(in_channels, f, 3, 1, 1, bias=False)
        self.srcm_encoder_layers = nn.ModuleList([
            nn.Sequential(nn.Identity() if i == 0 else _Down(chans[i - 1], chans[i]),
                          *[SRCMBlock(chans[i]) for _ in range(n)])
            for i, n in enumerate(blocks_down)])
        for i in range(stage):
            self.add_module(f"l_gf{i + 1}", GF(chans[i], "local"))
            self.add_module(f"g_gf{i + 1}", GF(chans[i], "global"))
            self.add_module(f"ag{i + 1}", _Gate(chans[i]))
        ups = [(chans[len(chans) - 1 - i], chans[len(chans) - 2 - i])
               for i in range(len(blocks_up))]
        self.up_samples = nn.ModuleList([_Up(c_in, c_out) for c_in, c_out in ups])
        self.srcm_decoder_layers = nn.ModuleList([
            nn.Sequential(*[SRCMBlock(c_out, conv_mode="deepwise") for _ in range(n)])
            for (_, c_out), n in zip(ups, blocks_up)])
        self.conv_final = nn.Sequential(nn.GroupNorm(8, f, eps=1e-5), nn.ReLU(),
                                        nn.Conv2d(f, out_channels, 1))

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """x1, x2 (B, 3, H, W) -> change logits (B, 2, H, W). The siamese
        encoder runs once over the 2B-stacked pair (exact: every norm is a
        Layer or Group norm)."""
        Bn = x1.shape[0]
        v = self.convInit(torch.cat([x1, x2], dim=0))
        diffs = []
        for i, layer in enumerate(self.srcm_encoder_layers):
            v = layer(v)
            a, b = v[:Bn], v[Bn:]
            if i < self.stage:
                al, bl = getattr(self, f"l_gf{i + 1}")(a, b)
                ag, bg = getattr(self, f"g_gf{i + 1}")(a, b)
                gate = getattr(self, f"ag{i + 1}")
                a, b = gate(al, ag), gate(bl, bg)
            diffs.append((a - b).abs())
        diffs = diffs[::-1]
        x = diffs[0]
        for up, dec, skip in zip(self.up_samples, self.srcm_decoder_layers, diffs[1:]):
            x = dec(up(x) + skip)
        return self.conv_final(x)
