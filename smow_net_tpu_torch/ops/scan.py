"""Selective scan (Mamba S6) of the VMamba models (port of
smow_net_tpu/ops/scan.py `selective_scan` and `cross_selective_scan`, and of
the grouped entry `selective_scan_fused_grouped` of
smow_net_tpu/ops/pallas/scan_fused.py).

Recurrence per (batch row, channel d, state n) over the sequence l:
    dt_l = softplus(delta_l + delta_bias)     (when delta_softplus)
    h_l  = exp(dt_l A[d, n]) h_{l-1} + dt_l B_l[n] u_l
    y_l  = sum_n C_l[n] h_l[n] + D[d] u_l
in fp32 whatever the inputs' dtype; y leaves in u's dtype.

`cross_selective_scan` is the direction-major contract SS2D calls: xs, dts
(B, K, L, Dk), Bs, Cs (B, K, L, N), A (K*Dk, N), Ds and dt_bias (K*Dk). On a
CUDA tensor it is the autograd Function `_GroupedScan`: kernel I-fwd
forward; kernels I-ckpt and I-bwd, then the JAX package's epilogue
(`_grouped_bwd`, scan_fused.py:874-914) backward (csrc/selective_scan.cu,
N = 16). On a CPU tensor it is `cross_selective_scan_plain` under torch
autograd.

The plain versions run the recurrence as an associative scan over chunks of
64 steps (the JAX package's plain `selective_scan` scans the whole sequence
at once): inside a chunk, log2(64) doubling steps of the pair (a, b) ->
(a2 a1, a2 b1 + b2) with a = exp(dt A) <= 1, so no product overflows;
between chunks the state carries. It is the same function in exact
arithmetic. Under autograd each chunk is checkpointed, so the plain backward
keeps one (rows, Dk, N) state per chunk and no fp32 copy of the inputs.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import _kernels

__all__ = ["selective_scan", "cross_selective_scan", "cross_selective_scan_plain",
           "softplus"]

N_STATE = 16        # d_state built into the kernels (kN in csrc/selective_scan.cu)
CKPT_CHUNK = 16     # I-ckpt's checkpoint interval (kChunk)
BLOCK_CHANNELS = 16     # channels per I-bwd block: one dB/dC partial each (kChannels)
_PLAIN_CHUNK = 64


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log1p(exp(-|x|)) + max(x, 0), finite at both ends."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0.0)


def _scan_chunk(h0, u, delta, Bm, Cm, A, D, bias, delta_softplus):
    """One chunk of the plain recurrence from the state h0 (b, G, C, N)
    fp32: u, delta (b, G, Q, C) and Bm, Cm (b, G, Q, N) in their own dtype,
    A (G, C, N), D and bias (G, 1, C) or None, fp32. Returns y (b, G, Q, C)
    fp32 and the state after the chunk. Every fp32 intermediate lives in
    here, so a checkpointed chunk keeps none of them for the backward."""
    uf, dt = u.float(), delta.float()
    if bias is not None:
        dt = dt + bias
    if delta_softplus:
        dt = softplus(dt)
    a = torch.exp(dt[..., None] * A[:, None])                      # (b, G, Q, C, N)
    x = (dt * uf)[..., None] * Bm.float()[..., None, :]
    x = torch.cat([x[:, :, :1] + a[:, :, :1] * h0[:, :, None], x[:, :, 1:]], dim=2)
    Q, d = x.shape[2], 1
    while d < Q:        # inclusive scan of (a, x) under (a2 a1, a2 x1 + x2)
        x = torch.cat([x[:, :, :d], a[:, :, d:] * x[:, :, :-d] + x[:, :, d:]], dim=2)
        a = torch.cat([a[:, :, :d], a[:, :, d:] * a[:, :, :-d]], dim=2)
        d *= 2
    y = (x * Cm.float()[..., None, :]).sum(-1)
    if D is not None:
        y = y + uf * D
    return y, x[:, :, -1]


def _scan_plain(u, delta, Bm, Cm, A, D, bias, delta_softplus):
    """y (b, G, L, C) fp32 over the whole sequence (arguments as
    `_scan_chunk`'s, L long), chunk by chunk, each checkpointed under
    autograd."""
    b, G, L, C = u.shape
    h = torch.zeros(b, G, C, A.shape[-1], dtype=torch.float32, device=u.device)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (u, delta, Bm, Cm, A, D, bias))
    ys = []
    for l0 in range(0, L, _PLAIN_CHUNK):
        part = slice(l0, l0 + _PLAIN_CHUNK)
        args = (h, u[:, :, part], delta[:, :, part], Bm[:, :, part], Cm[:, :, part], A, D,
                bias, delta_softplus)
        if grad:
            y, h = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            y, h = _scan_chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=2)


def _vec(t, G, C):
    return None if t is None else t.float().reshape(G, 1, C)


def selective_scan(u, delta, A, Bmat, Cmat, D=None, delta_bias=None, delta_softplus=False):
    """The JAX package's flat contract: u, delta (B, L, Dch), A (Dch, N),
    Bmat, Cmat (B, L, G, N) with G dividing Dch, D and delta_bias (Dch,).
    Returns y (B, L, Dch) in u's dtype; fp32 internals (plain version)."""
    B, L, Dch = u.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    Cg = Dch // G
    if Cg * G != Dch:
        raise ValueError(f"selective_scan: {G} groups do not divide {Dch} channels")

    def grouped(t):         # (B, L, G*Cg) -> (B, G, L, Cg)
        return t.reshape(B, L, G, Cg).transpose(1, 2)

    y = _scan_plain(grouped(u), grouped(delta), Bmat.transpose(1, 2), Cmat.transpose(1, 2),
                    A.float().reshape(G, Cg, N), _vec(D, G, Cg), _vec(delta_bias, G, Cg),
                    delta_softplus)
    return y.transpose(1, 2).reshape(B, L, Dch).to(u.dtype)


def cross_selective_scan_plain(xs, dts, A, Bs, Cs, Ds=None, dt_bias=None, delta_softplus=True):
    """Plain version of kernel I (`cross_selective_scan`'s contract);
    torch autograd gives its backward."""
    B, K, L, Dk = xs.shape
    y = _scan_plain(xs, dts, Bs, Cs, A.float().reshape(K, Dk, -1), _vec(Ds, K, Dk),
                    _vec(dt_bias, K, Dk), delta_softplus)
    return y.to(xs.dtype)


class _Args:
    """The CUDA operands of kernel I: checked, contiguous, fp32 where the
    kernels read fp32 (A as (K, N, Dk), D and the bias zeros when absent)."""

    def __init__(self, xs, dts, A, Bs, Cs, Ds, dt_bias):
        if not xs.is_cuda:
            raise ValueError(f"cross_selective_scan: unsupported device {xs.device}")
        if xs.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"cross_selective_scan: dtype {xs.dtype} not supported")
        if xs.dim() != 4:
            raise ValueError("cross_selective_scan: xs must be (B, K, L, Dk)")
        B, K, L, Dk = xs.shape
        for name, t, shape in (("dts", dts, (B, K, L, Dk)), ("Bs", Bs, (B, K, L, N_STATE)),
                               ("Cs", Cs, (B, K, L, N_STATE))):
            if tuple(t.shape) != shape or t.dtype != xs.dtype or t.device != xs.device:
                raise ValueError(f"cross_selective_scan: {name} must be {shape} {xs.dtype} "
                                 f"on {xs.device} (kernel I is built for N = {N_STATE})")
        if tuple(A.shape) != (K * Dk, N_STATE) or A.device != xs.device:
            raise ValueError(f"cross_selective_scan: A must be ({K * Dk}, {N_STATE}) on "
                             f"{xs.device}")

        def vec(t):
            if t is None:
                return torch.zeros(K * Dk, dtype=torch.float32, device=xs.device)
            if tuple(t.shape) != (K * Dk,) or t.device != xs.device:
                raise ValueError(f"cross_selective_scan: Ds and dt_bias must be ({K * Dk},)")
            return t.detach().float().contiguous()

        self.shape = (B, K, L, Dk)
        self.bf16 = int(xs.dtype == torch.bfloat16)
        self.u, self.dt = xs.detach().contiguous(), dts.detach().contiguous()
        self.Bm, self.Cm = Bs.detach().contiguous(), Cs.detach().contiguous()
        self.A = A.detach().float().reshape(K, Dk, N_STATE).transpose(1, 2).contiguous()
        self.D, self.bias = vec(Ds), vec(dt_bias)

    def dims(self):
        B, K, L, Dk = self.shape
        return (B * K, L, Dk, K, self.bf16, _kernels.stream_handle(self.u.device))


def _scan_fwd(a: _Args) -> torch.Tensor:
    """Kernel I-fwd: y (B, K, L, Dk) in the inputs' dtype."""
    y = torch.empty_like(a.u)
    _kernels.call("selective_scan_fwd", a.u.data_ptr(), a.dt.data_ptr(), a.Bm.data_ptr(),
                  a.Cm.data_ptr(), a.A.data_ptr(), a.D.data_ptr(), a.bias.data_ptr(),
                  y.data_ptr(), *a.dims())
    return y


def _scan_ckpt(a: _Args) -> torch.Tensor:
    """Kernel I-ckpt: the state before every 16-step chunk, (B*K,
    ceil(L / 16), N, Dk) fp32."""
    B, K, L, Dk = a.shape
    hck = torch.empty(B * K, -(-L // CKPT_CHUNK), N_STATE, Dk, dtype=torch.float32,
                      device=a.u.device)
    _kernels.call("selective_scan_ckpt", a.u.data_ptr(), a.dt.data_ptr(), a.Bm.data_ptr(),
                  a.A.data_ptr(), a.bias.data_ptr(), hck.data_ptr(), *a.dims())
    return hck


def _scan_bwd(a: _Args, gy: torch.Tensor, hck: torch.Tensor):
    """Kernel I-bwd from I-ckpt's states: (dus, ddt, dB, dC, dA) in the JAX
    package's grouped layouts, fp32; ddt is with respect to dt after the
    softplus, dB and dC summed over the channel blocks here."""
    B, K, L, Dk = a.shape
    f32 = dict(dtype=torch.float32, device=a.u.device)
    dy = gy.to(a.u.dtype).contiguous()
    dus = torch.empty(B, K, L, Dk, **f32)
    ddt = torch.empty_like(dus)
    dBp = torch.empty(-(-Dk // BLOCK_CHANNELS), B, K, L, N_STATE, **f32)
    dCp = torch.empty_like(dBp)
    dA = torch.empty(B, K, N_STATE, Dk, **f32)
    _kernels.call("selective_scan_bwd", a.u.data_ptr(), a.dt.data_ptr(), a.Bm.data_ptr(),
                  a.Cm.data_ptr(), dy.data_ptr(), a.A.data_ptr(), a.bias.data_ptr(),
                  hck.data_ptr(), dus.data_ptr(), ddt.data_ptr(), dBp.data_ptr(),
                  dCp.data_ptr(), dA.data_ptr(), *a.dims())
    return dus, ddt, dBp.sum(0), dCp.sum(0), dA


class _GroupedScan(torch.autograd.Function):
    """Kernel I-fwd forward; I-ckpt, I-bwd and the JAX package's epilogue
    backward. dt = softplus(dts + dt_bias) always. Only the inputs are
    saved."""

    @staticmethod
    def forward(ctx, xs, dts, A, Bs, Cs, Ds, dt_bias):
        ctx.save_for_backward(xs, dts, A, Bs, Cs, Ds, dt_bias)
        return _scan_fwd(_Args(xs, dts, A, Bs, Cs, Ds, dt_bias))

    @staticmethod
    def backward(ctx, gy):
        xs, dts, A, Bs, Cs, Ds, dt_bias = ctx.saved_tensors
        a = _Args(xs, dts, A, Bs, Cs, Ds, dt_bias)
        B, K, L, Dk = a.shape
        hck = _scan_ckpt(a)
        dus, ddt, dB, dC, dA = _scan_bwd(a, gy, hck)
        gyf = gy.float()
        du, dD = dus, None
        if Ds is not None:
            du = du + gyf * a.D.reshape(1, K, 1, Dk)
            dD = (gyf * xs.float()).sum((0, 2)).reshape(K * Dk).to(Ds.dtype)
        ddt = ddt * torch.sigmoid(dts.float() + a.bias.reshape(1, K, 1, Dk))
        dbias = None if dt_bias is None else ddt.sum((0, 2)).reshape(K * Dk).to(dt_bias.dtype)
        dA = dA.sum(0).transpose(1, 2).reshape(K * Dk, N_STATE).to(A.dtype)
        return (du.to(xs.dtype), ddt.to(dts.dtype), dA, dB.to(Bs.dtype), dC.to(Cs.dtype),
                dD, dbias)


def cross_selective_scan(xs, dts, A, Bs, Cs, Ds=None, dt_bias=None, delta_softplus=True):
    """Direction-major selective scan, (B, K, L, Dk) -> (B, K, L, Dk) in
    xs's dtype: kernel I (and its backward kernels) on a CUDA tensor, the
    plain version under torch autograd on a CPU tensor. The kernels always
    take the softplus of dt, as every SS2D does."""
    if xs.device.type == "cpu":
        return cross_selective_scan_plain(xs, dts, A, Bs, Cs, Ds, dt_bias, delta_softplus)
    if not delta_softplus:
        raise ValueError("cross_selective_scan: kernel I always takes the softplus of dt")
    return _GroupedScan.apply(xs, dts, A, Bs, Cs, Ds, dt_bias)
