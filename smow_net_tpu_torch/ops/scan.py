"""Selective scan (Mamba S6) of the Mamba models (port of smow_net_tpu/ops/
scan.py `selective_scan`, `selective_scan_step` and `cross_selective_scan`,
and of smow_net_tpu/ops/pallas/scan_fused.py: `selective_scan_fused` with its
segmented long-L path, and the grouped entry `selective_scan_fused_grouped`).

Recurrence per (batch row, channel d, state n) over the sequence l:
    dt_l = softplus(delta_l + delta_bias)     (when delta_softplus)
    h_l  = exp(dt_l A[d, n]) h_{l-1} + dt_l B_l[n] u_l
    y_l  = sum_n C_l[n] h_l[n] + D[d] u_l
in fp32 whatever the inputs' dtype; y leaves in u's dtype.

Two contracts:
- `selective_scan`, the flat one CD-Mamba calls: u, delta (B, L, G*Cg), Bmat,
  Cmat (B, L, G, N), A (G*Cg, N), D and delta_bias (G*Cg). On a CUDA tensor
  it is the autograd Function `_FlatScan` (kernel H): kernel I's three
  sweeps over rows b*G + g, reading the flat layout in place; long rows are
  cut into segments (`seg_count`, below). On a CPU tensor it is
  `selective_scan_plain` under torch autograd.
- `cross_selective_scan`, the direction-major one SS2D calls: xs, dts (B, K,
  L, Dk), Bs, Cs (B, K, L, N), A (K*Dk, N), Ds and dt_bias (K*Dk). On a CUDA
  tensor it is `_GroupedScan` (kernel I); on a CPU tensor
  `cross_selective_scan_plain`.
Both backward passes run kernels I-ckpt and I-bwd, then the JAX package's
epilogue (`_fused_bwd`, scan_fused.py:771-812; `_grouped_bwd`, :874-914).

Kernels H and I are built for N = 16, the softplus of dt, and u, delta, B
and C of one dtype, fp32 or bf16. On a CUDA tensor every other call of
either contract (any N, delta_softplus=False, fp16 or float64 or mixed
dtypes; float64 computes in fp32, as JAX does, and leaves in u's dtype)
takes the general route, `_StatesScan` (the JAX package's
`selective_scan_pallas`, ops/pallas/scan.py:96-200): torch forms dA =
exp(dt A) and dBu = dt u B as fp32 (B, L, D*N) tensors, kernel J
(`scan_states`) walks h_t = dA_t h_{t-1} + dBu_t, and torch takes y = C h
+ D u; the backward runs J twice (h again, and the reverse adjoint) and
torch's einsums. The grouped layout is viewed as the flat one there.

The segmented path (`_fwd_segmented`, `_bwd_segmented`; scan_fused.py:630,
:657) cuts each row's L steps into S segments, so the card walks rows*S
shorter rows: the carry sweep gives each segment's final state from zero and
its dt sum, a combine over S (KB-sized torch) gives each segment's incoming
state, and I-fwd runs seeded with it. Backward: the carries and the combine
again, the adjoint carries (the reverse recurrence from zero) and their
reverse combine, then I-ckpt and I-bwd seeded with each segment's incoming
state, adjoint and next-step decay. On CPU tensors the same orchestration
runs on the plain versions (`scan_carry_plain`, `scan_adjcarry_plain`, the
plain scan seeded with h0).

The plain versions run the recurrence as an associative scan over chunks of
256 steps (the JAX package's plain `selective_scan` scans the whole sequence
at once): inside a chunk, log2(256) doubling steps of the pair (a, b) ->
(a2 a1, a2 b1 + b2) with a = exp(dt A) <= 1, so no product overflows;
between chunks the state carries. It is the same function in exact
arithmetic. Under autograd each chunk is checkpointed, so the plain backward
keeps one (rows, Dk, N) state per chunk and no fp32 copy of the inputs.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.checkpoint import checkpoint

from . import _kernels

__all__ = ["selective_scan", "selective_scan_plain", "selective_scan_step",
           "cross_selective_scan", "cross_selective_scan_plain", "softplus", "seg_count",
           "fwd_segmented", "bwd_segmented", "scan_carry_plain", "scan_adjcarry_plain",
           "scan_ckpt_plain", "scan_states", "scan_states_plain", "bwd_partials",
           "fwd_occupancy", "bwd_occupancy"]

N_STATE = 16        # d_state built into the kernels (kN in csrc/selective_scan.cu)
CKPT_CHUNK = 16     # I-ckpt's checkpoint interval (kChunk)
# seg_count's unit of work: 16 channels of one segment row. The forward and
# reverse sweeps run blocks of 32 channels, 4 warps each (kBlockChannels in
# csrc/scan_common.cuh), so where Cg is a multiple of 32 a unit is 2 of
# their warps; the adjoint carry's one-warp blocks hold 16 channels.
BLOCK_CHANNELS = 16
BWD_BLOCK_CHANNELS = 32     # channels per I-bwd block: one dB/dC partial each (kBlockChannels)
_PLAIN_CHUNK = 256

# The segmented route of the flat contract on the card (`seg_count`): rows of
# at least SEG_MIN_L steps are cut in two until the rows' units (rows x S x
# ceil(Cg / BLOCK_CHANNELS)) reach SEG_TARGET_BLOCKS or a segment would fall
# below SEG_MIN_K steps. Set from chip_smoke.py's A/B of the sequential and
# the segmented scan at CD-Mamba's shapes on an H100 (phase 20); with the
# 4-warp forward sweep no other S was faster by more than the run's spread
# at the shapes one target can tell apart (PERF.md).
SEG_MIN_L = 4096
SEG_TARGET_BLOCKS = 4096
SEG_MIN_K = 1024


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: log1p(exp(-|x|)) + max(x, 0), finite at both ends."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0.0)


def seg_count(rows: int, L: int, Cg: int) -> int:
    """Segments per row for a flat-contract call of `rows` = B*G rows of L
    steps and Cg channels (the port's twin of scan_fused.py `_seg_S`): a
    power of two dividing L; 1 = the sequential scan."""
    if L < SEG_MIN_L:
        return 1
    blocks = rows * -(-Cg // BLOCK_CHANNELS)
    S = 1
    while (blocks * S * 2 <= SEG_TARGET_BLOCKS and L % (S * 2) == 0
           and L // (S * 2) >= SEG_MIN_K):
        S *= 2
    return S


# ---------------------------------------------------------------- plain scan


def _scan_chunk(h0, u, delta, Bm, Cm, A, D, bias, delta_softplus):
    """One chunk of the plain recurrence from the state h0 (b, G, C, N)
    fp32: u, delta (b, G, Q, C) and Bm (b, G, Q, N) in their own dtype, Cm
    the same or None (no y), A (G, C, N) or (b, G, C, N), D and bias (G, 1,
    C) or None, fp32. Returns y (b, G, Q, C) fp32 (None without Cm) and the
    state after the chunk. Every fp32 intermediate lives in here, so a
    checkpointed chunk keeps none of them for the backward."""
    uf, dt = u.float(), delta.float()
    if bias is not None:
        dt = dt + bias
    if delta_softplus:
        dt = softplus(dt)
    a = torch.exp(dt[..., None] * A.unsqueeze(-3))                 # (b, G, Q, C, N)
    x = (dt * uf)[..., None] * Bm.float()[..., None, :]
    x = torch.cat([x[:, :, :1] + a[:, :, :1] * h0[:, :, None], x[:, :, 1:]], dim=2)
    x = _doubling_scan(a, x)
    if Cm is None:
        return None, x[:, :, -1]
    y = (x * Cm.float()[..., None, :]).sum(-1)
    if D is not None:
        y = y + uf * D
    return y, x[:, :, -1]


def _doubling_scan(a, x):
    """Inclusive scan of x_l = a_l x_{l-1} + x_l along dim 2, log2(Q) steps."""
    Q, d = x.shape[2], 1
    while d < Q:        # inclusive scan of (a, x) under (a2 a1, a2 x1 + x2)
        x = torch.cat([x[:, :, :d], a[:, :, d:] * x[:, :, :-d] + x[:, :, d:]], dim=2)
        a = torch.cat([a[:, :, :d], a[:, :, d:] * a[:, :, :-d]], dim=2)
        d *= 2
    return x


def _scan_plain(u, delta, Bm, Cm, A, D, bias, delta_softplus, h0=None):
    """(y (b, G, L, C) fp32, the state after the last step (b, G, C, N))
    over the whole sequence from h0 (zeros when None), arguments as
    `_scan_chunk`'s, L long; chunk by chunk, each checkpointed under
    autograd. With Cm None, y is None (the carry)."""
    b, G, L, C = u.shape
    h = (torch.zeros(b, G, C, A.shape[-1], dtype=torch.float32, device=u.device)
         if h0 is None else h0)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (u, delta, Bm, Cm, A, D, bias, h0))
    ys = []
    for l0 in range(0, L, _PLAIN_CHUNK):
        part = slice(l0, l0 + _PLAIN_CHUNK)
        args = (h, u[:, :, part], delta[:, :, part], Bm[:, :, part],
                None if Cm is None else Cm[:, :, part], A, D, bias, delta_softplus)
        if grad:
            y, h = checkpoint(_scan_chunk, *args, use_reentrant=False)
        else:
            y, h = _scan_chunk(*args)
        ys.append(y)
    return (None if Cm is None else torch.cat(ys, dim=2)), h


def _vec(t, G, C):
    return None if t is None else t.float().reshape(G, 1, C)


def selective_scan_plain(u, delta, A, Bmat, Cmat, D=None, delta_bias=None,
                         delta_softplus=False):
    """Plain version of the flat contract (kernel H): u, delta (B, L, Dch),
    A (Dch, N), Bmat, Cmat (B, L, G, N) with G dividing Dch, D and
    delta_bias (Dch,). Returns y (B, L, Dch) in u's dtype; fp32 internals;
    torch autograd gives its backward."""
    B, L, Dch = u.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    Cg = Dch // G
    if Cg * G != Dch:
        raise ValueError(f"selective_scan: {G} groups do not divide {Dch} channels")

    def grouped(t):         # (B, L, G*Cg) -> (B, G, L, Cg)
        return t.reshape(B, L, G, Cg).transpose(1, 2)

    y, _ = _scan_plain(grouped(u), grouped(delta), Bmat.transpose(1, 2), Cmat.transpose(1, 2),
                       A.float().reshape(G, Cg, N), _vec(D, G, Cg), _vec(delta_bias, G, Cg),
                       delta_softplus)
    return y.transpose(1, 2).reshape(B, L, Dch).to(u.dtype)


def cross_selective_scan_plain(xs, dts, A, Bs, Cs, Ds=None, dt_bias=None, delta_softplus=True):
    """Plain version of kernel I (`cross_selective_scan`'s contract);
    torch autograd gives its backward."""
    B, K, L, Dk = xs.shape
    y, _ = _scan_plain(xs, dts, Bs, Cs, A.float().reshape(K, Dk, -1), _vec(Ds, K, Dk),
                       _vec(dt_bias, K, Dk), delta_softplus)
    return y.to(xs.dtype)


def selective_scan_step(h, u, delta, A, Bvec, Cvec, D=None, delta_bias=None,
                        delta_softplus=False):
    """One step of the flat contract's recurrence with an explicit state:
    h (B, Dch, N) fp32, u and delta (B, Dch), A (Dch, N), Bvec and Cvec (B,
    G, N). Returns (y (B, Dch) in u's dtype, h') with h' = exp(dt A) h + dt
    B u and y = sum_n C[n] h'[n] + D u (the decode path; JAX ops/scan.py
    `selective_scan_step`)."""
    Bb, Dch = u.shape
    G, N = Bvec.shape[1], Bvec.shape[2]
    uf, dt = u.float(), delta.float()
    if delta_bias is not None:
        dt = dt + delta_bias.float()
    if delta_softplus:
        dt = softplus(dt)
    dA = torch.exp(dt[..., None] * A.float())                          # (B, Dch, N)
    dBu = (dt * uf).reshape(Bb, G, -1)[..., None] * Bvec.float()[:, :, None, :]
    h = h.float() * dA + dBu.reshape(Bb, Dch, N)
    y = torch.einsum("bgcn,bgn->bgc", h.reshape(Bb, G, -1, N), Cvec.float()).reshape(Bb, Dch)
    if D is not None:
        y = y + uf * D.float()
    return y.to(u.dtype), h


# ------------------------------------------------------------ kernel operands


class _Args:
    """The operands of kernel I for rows b*G + g, in one of two layouts:
    grouped (flat=False: u, dt (B, G, L, Cg), Bm, Cm (B, G, L, N)) or flat
    (u, dt (B, L, G*Cg), Bm, Cm (B, L, G, N)); contiguous, in their dtype,
    and A as (G, N, Cg), D and the bias as (G*Cg,) in fp32 (zeros when
    absent). The kernel wrappers take them on a CUDA device; the plain
    versions beside them on any."""

    def __init__(self, u, dt, A, Bm, Cm, D, bias, flat=False):
        who = "selective_scan" if flat else "cross_selective_scan"
        if u.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{who}: dtype {u.dtype} not supported")
        if flat:
            if u.dim() != 3 or Bm.dim() != 4:
                raise ValueError(f"{who}: u must be (B, L, G*Cg) and Bmat (B, L, G, N)")
            B, L, G = Bm.shape[:3]
            Cg = u.shape[2] // G
            shapes = ((B, L, G * Cg), (B, L, G, N_STATE))
        else:
            if u.dim() != 4:
                raise ValueError(f"{who}: xs must be (B, K, L, Dk)")
            B, G, L, Cg = u.shape
            shapes = ((B, G, L, Cg), (B, G, L, N_STATE))
        for name, t, shape in (("u", u, shapes[0]), ("delta", dt, shapes[0]),
                               ("B", Bm, shapes[1]), ("C", Cm, shapes[1])):
            if tuple(t.shape) != shape or t.dtype != u.dtype or t.device != u.device:
                raise ValueError(f"{who}: {name} must be {shape} {u.dtype} on {u.device} "
                                 f"(kernel I is built for N = {N_STATE})")
        if tuple(A.shape) != (G * Cg, N_STATE) or A.device != u.device:
            raise ValueError(f"{who}: A must be ({G * Cg}, {N_STATE}) on {u.device}")

        def vec(t):
            if t is None:
                return torch.zeros(G * Cg, dtype=torch.float32, device=u.device)
            if tuple(t.shape) != (G * Cg,) or t.device != u.device:
                raise ValueError(f"{who}: D and the bias must be ({G * Cg},)")
            return t.detach().float().contiguous()

        self.B, self.L, self.G, self.Cg, self.rows, self.flat = B, L, G, Cg, B * G, flat
        self.bf16 = int(u.dtype == torch.bfloat16)
        self.u, self.dt = u.detach().contiguous(), dt.detach().contiguous()
        self.Bm, self.Cm = Bm.detach().contiguous(), Cm.detach().contiguous()
        self.A = A.detach().float().reshape(G, Cg, N_STATE).transpose(1, 2).contiguous()
        self.D, self.bias = vec(D), vec(bias)

    def dims(self, S):
        if not self.u.is_cuda:
            raise ValueError(f"selective scan kernels: unsupported device {self.u.device}")
        if self.L % S:
            raise ValueError(f"selective scan: {S} segments do not divide L = {self.L}")
        return (self.rows * S, self.L // S, self.Cg, self.G, S, int(self.flat), self.bf16,
                _kernels.stream_handle(self.u.device))

    def label(self, name):
        return name + "_flat" if self.flat else name

    def states(self, S):
        """An empty (rows*S, N, Cg) fp32 tensor: one state per segment row."""
        return torch.empty(self.rows * S, N_STATE, self.Cg, dtype=torch.float32,
                           device=self.u.device)

    # the plain versions' view: (B, G*S, L/S, W) rows and per-row parameters

    def seg(self, t, S):
        """u-like (width Cg) or B-like (width N) tensor -> (B, G*S, L/S, W)."""
        W = t.shape[-1] if not self.flat or t.dim() == 4 else self.Cg
        if self.flat:
            t = t.reshape(self.B, self.L, self.G, W).transpose(1, 2)
        return t.reshape(self.B, self.G * S, self.L // S, W)

    def unseg(self, t, like):
        """(B, G*S, L/S, W) -> `like`'s layout."""
        W = t.shape[-1]
        t = t.reshape(self.B, self.G, self.L, W)
        if self.flat:
            t = t.transpose(1, 2)
        return t.reshape(like.shape)

    def first_steps(self, S):
        """dt at each segment's first step, (B, G, S, Cg) fp32."""
        K = self.L // S
        if self.flat:
            return self.dt.reshape(self.B, S, K, self.G, self.Cg)[:, :, 0].transpose(1, 2).float()
        return self.dt.reshape(self.B, self.G, S, K, self.Cg)[:, :, :, 0].float()

    def seg_params(self, S):
        """A (G*S, Cg, N) and D, bias (G*S, 1, Cg), each group's repeated S
        times."""
        rep = lambda t: t.repeat_interleave(S, 0)
        return (rep(self.A.transpose(1, 2)), rep(self.D.reshape(self.G, 1, self.Cg)),
                rep(self.bias.reshape(self.G, 1, self.Cg)))

    def to_rows(self, h, S):
        """(rows*S, N, Cg) kernel-layout states -> (B, G*S, Cg, N)."""
        return h.reshape(self.B, self.G * S, N_STATE, self.Cg).transpose(-1, -2)

    def from_rows(self, h):
        """(B, G*S, Cg, N) -> (rows*S, N, Cg)."""
        return h.transpose(-1, -2).reshape(-1, N_STATE, self.Cg).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


# -------------------------------------------------------- kernel wrappers


def _scan_fwd(a: _Args, S: int = 1, h0=None) -> torch.Tensor:
    """Kernel I-fwd: y in u's layout and dtype, each of the rows*S segment
    rows from h0 (rows*S, N, Cg) fp32 (zeros when None)."""
    y = torch.empty_like(a.u)
    _kernels.call("selective_scan_fwd", a.u.data_ptr(), a.dt.data_ptr(), a.Bm.data_ptr(),
                  a.Cm.data_ptr(), a.A.data_ptr(), a.D.data_ptr(), a.bias.data_ptr(), _ptr(h0),
                  y.data_ptr(), *a.dims(S), label=a.label("selective_scan_fwd"))
    return y


def _scan_ckpt(a: _Args, S: int = 1, h0=None) -> torch.Tensor:
    """Kernel I-ckpt: the state before every 16-step chunk of each segment
    row, (rows*S, ceil(L / S / 16), N, Cg) fp32."""
    hck = torch.empty(a.rows * S, -(-(a.L // S) // CKPT_CHUNK), N_STATE, a.Cg,
                      dtype=torch.float32, device=a.u.device)
    _kernels.call("selective_scan_ckpt", a.u.data_ptr(), a.dt.data_ptr(), a.Bm.data_ptr(),
                  a.A.data_ptr(), a.bias.data_ptr(), _ptr(h0), hck.data_ptr(), *a.dims(S),
                  label=a.label("selective_scan_ckpt"))
    return hck


def bwd_partials(Cg: int) -> int:
    """The dB and dC partials kernel I-bwd writes for Cg channels: one per
    block of BWD_BLOCK_CHANNELS."""
    return -(-Cg // BWD_BLOCK_CHANNELS)


def _scan_bwd(a: _Args, gy: torch.Tensor, hck: torch.Tensor, S: int = 1, g0=None, a0=None):
    """Kernel I-bwd from I-ckpt's states (and, per segment row, the incoming
    adjoint g0 and decay a0, (rows*S, N, Cg)): (dus, ddt) in u's layout, (dB,
    dC) in Bm's, fp32, summed over the channel blocks' partials here (a
    single partial is returned as it is), and dA (rows*S, N, Cg); ddt is
    with respect to dt after the softplus."""
    f32 = dict(dtype=torch.float32, device=a.u.device)
    dy = gy.to(a.u.dtype).contiguous()
    dus = torch.empty(a.u.shape, **f32)
    ddt = torch.empty_like(dus)
    dBp = torch.empty((bwd_partials(a.Cg),) + tuple(a.Bm.shape), **f32)
    dCp = torch.empty_like(dBp)
    dA = a.states(S)
    _kernels.call("selective_scan_bwd", a.u.data_ptr(), a.dt.data_ptr(), a.Bm.data_ptr(),
                  a.Cm.data_ptr(), dy.data_ptr(), a.A.data_ptr(), a.bias.data_ptr(),
                  hck.data_ptr(), _ptr(g0), _ptr(a0), dus.data_ptr(), ddt.data_ptr(),
                  dBp.data_ptr(), dCp.data_ptr(), dA.data_ptr(), *a.dims(S),
                  label=a.label("selective_scan_bwd"))
    if len(dBp) == 1:
        return dus, ddt, dBp[0], dCp[0], dA
    return dus, ddt, dBp.sum(0), dCp.sum(0), dA


def _occupancy(entry: str, *args) -> tuple:
    warps, smem = ctypes.c_int(0), ctypes.c_int(0)
    lib = _kernels.library()
    rc = getattr(lib, entry)(*args, ctypes.byref(warps), ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc} ({lib.smow_cuda_error_string(rc).decode()})")
    return warps.value, smem.value


FWD_MODES = ("fwd", "ckpt", "carry")    # scan_fwd_kernel's modes (kModeFwd, kModeCkpt, kModeCarry)


def fwd_occupancy(mode: str, flat: bool, bf16: bool) -> tuple:
    """The forward sweep's (I-fwd, I-ckpt or the carry: `mode` of FWD_MODES)
    resident warps per SM on the current card
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and its shared memory
    per block in bytes, for the layout and dtype."""
    return _occupancy("selective_scan_fwd_occupancy", FWD_MODES.index(mode), int(flat), int(bf16))


def bwd_occupancy(flat: bool, bf16: bool) -> tuple:
    """Kernel I-bwd's resident warps per SM on the current card and its
    shared memory per block in bytes, for the layout and dtype."""
    return _occupancy("selective_scan_bwd_occupancy", int(flat), int(bf16))


def scan_carry(a: _Args, S: int):
    """Kernel H-seg carry: each segment row's state after its last step from
    zero, (rows*S, N, Cg), and its sum of dt, (rows*S, Cg); fp32."""
    hend, csum = a.states(S), torch.empty(a.rows * S, a.Cg, dtype=torch.float32,
                                          device=a.u.device)
    _kernels.call("selective_scan_carry", a.u.data_ptr(), a.dt.data_ptr(), a.Bm.data_ptr(),
                  a.A.data_ptr(), a.bias.data_ptr(), None, hend.data_ptr(), csum.data_ptr(),
                  *a.dims(S))
    return hend, csum


def scan_adjcarry(a: _Args, gy: torch.Tensor, S: int) -> torch.Tensor:
    """Kernel H-seg adjcarry: each segment row's adjoint at its first step
    from zero incoming, (rows*S, N, Cg) fp32."""
    dy = gy.to(a.u.dtype).contiguous()
    gout = a.states(S)
    _kernels.call("selective_scan_adjcarry", a.dt.data_ptr(), a.Cm.data_ptr(), dy.data_ptr(),
                  a.A.data_ptr(), a.bias.data_ptr(), gout.data_ptr(), *a.dims(S))
    return gout


# ----------------------------------------------- plain versions of the sweeps


def scan_fwd_plain(a: _Args, S: int = 1, h0=None) -> torch.Tensor:
    """Plain I-fwd over segment rows: y in u's layout and dtype, each
    segment row from h0 (rows*S, N, Cg) fp32 or zeros."""
    A, D, bias = a.seg_params(S)
    y, _ = _scan_plain(a.seg(a.u, S), a.seg(a.dt, S), a.seg(a.Bm, S), a.seg(a.Cm, S), A, D,
                       bias, True, None if h0 is None else a.to_rows(h0, S))
    return a.unseg(y, a.u).to(a.u.dtype)


def scan_ckpt_plain(a: _Args, S: int = 1, h0=None) -> torch.Tensor:
    """Plain I-ckpt over segment rows: the fp32 state before every
    CKPT_CHUNK steps of each of the rows*S segment rows from h0 (rows*S, N,
    Cg) or zeros, in the kernel's layout (rows*S, ceil(L / S / 16), N, Cg)."""
    A, _, bias = a.seg_params(S)
    u, dt, Bm = a.seg(a.u, S), a.seg(a.dt, S), a.seg(a.Bm, S)
    h = (torch.zeros(a.B, a.G * S, a.Cg, N_STATE, device=a.u.device) if h0 is None
         else a.to_rows(h0, S))
    out = []
    with torch.no_grad():
        for l0 in range(0, a.L // S, CKPT_CHUNK):
            out.append(h)
            part = slice(l0, l0 + CKPT_CHUNK)
            _, h = _scan_chunk(h, u[:, :, part], dt[:, :, part], Bm[:, :, part], None, A, None,
                               bias, True)
    return torch.stack(out, 2).transpose(-1, -2).reshape(a.rows * S, len(out), N_STATE, a.Cg)


def scan_carry_plain(a: _Args, S: int):
    """Plain H-seg carry: (hend (rows*S, N, Cg), csum (rows*S, Cg)), fp32."""
    A, _, bias = a.seg_params(S)
    dts = a.seg(a.dt, S)
    _, h = _scan_plain(a.seg(a.u, S), dts, a.seg(a.Bm, S), None, A, None, bias, True)
    csum = softplus(dts.float() + bias).sum(2)
    return a.from_rows(h), csum.reshape(-1, a.Cg)


def scan_adjcarry_plain(a: _Args, gy: torch.Tensor, S: int) -> torch.Tensor:
    """Plain H-seg adjcarry: g_l = C_l dy_l + exp(dt_{l+1} A) g_{l+1} from
    zero after each segment row's last step, chunked like `_scan_plain` over
    the reversed rows; g at the first step, (rows*S, N, Cg) fp32."""
    A, _, bias = a.seg_params(S)
    dt = softplus(a.seg(a.dt, S).float() + bias).flip(2)
    Cm, dy = a.seg(a.Cm, S).float().flip(2), a.seg(gy, S).float().flip(2)
    b, GS, K, Cg = dt.shape
    g = torch.zeros(b, GS, Cg, N_STATE, dtype=torch.float32, device=dt.device)
    a_in = torch.zeros_like(g)      # exp(dt A) of the step after the chunk
    for l0 in range(0, K, _PLAIN_CHUNK):
        part = slice(l0, l0 + _PLAIN_CHUNK)
        decay = torch.exp(dt[:, :, part, :, None] * A.unsqueeze(-3))      # (b, GS, Q, Cg, N)
        # reversed step q takes the decay of the step after it: q - 1's
        shifted = torch.cat([a_in[:, :, None], decay[:, :, :-1]], dim=2)
        x = dy[:, :, part, :, None] * Cm[:, :, part, None, :]
        x = torch.cat([x[:, :, :1] + shifted[:, :, :1] * g[:, :, None], x[:, :, 1:]], dim=2)
        g, a_in = _doubling_scan(shifted, x)[:, :, -1], decay[:, :, -1]
    return a.from_rows(g)


def scan_bwd_plain(a: _Args, gy: torch.Tensor, S: int = 1, h0=None, g0=None, a0=None):
    """Plain seeded I-ckpt + I-bwd: torch autograd of the plain scan over
    segment rows from h0, with the loss sum(y dy) + sum(g0 a0 h_last) (the
    adjoint entering from the step after each segment). Returns (dus, ddt)
    in u's layout, (dB, dC) in Bm's, fp32, and dA (rows*S, N, Cg); ddt with
    respect to dt after the softplus, dus without the D term."""
    A, _, bias = a.seg_params(S)
    with torch.enable_grad():
        u = a.seg(a.u, S).float().requires_grad_()
        dt = softplus(a.seg(a.dt, S).float() + bias).detach().requires_grad_()
        Bm = a.seg(a.Bm, S).float().requires_grad_()
        Cm = a.seg(a.Cm, S).float().requires_grad_()
        Ar = A.expand((a.B,) + A.shape).clone().requires_grad_()
        y, h = _scan_plain(u, dt, Bm, Cm, Ar, None, None, False,
                           None if h0 is None else a.to_rows(h0, S))
        loss = (y * a.seg(gy, S).float()).sum()
        if g0 is not None:
            loss = loss + (h * a.to_rows(g0 * a0, S)).sum()
        du, ddt, dB, dC, dA = torch.autograd.grad(loss, (u, dt, Bm, Cm, Ar))
    return (a.unseg(du, a.u), a.unseg(ddt, a.u), a.unseg(dB, a.Bm), a.unseg(dC, a.Bm),
            a.from_rows(dA))


# --------------------------------------------------- the segmented orchestration


def _scan_ops(a: _Args):
    """The sweeps of the orchestration: the kernels for CUDA operands, the
    plain versions for CPU ones."""
    if a.u.is_cuda:
        return dict(carry=scan_carry, adjcarry=scan_adjcarry, fwd=_scan_fwd,
                    bwd=lambda a, gy, S, h0, g0, a0: _scan_bwd(a, gy, _scan_ckpt(a, S, h0), S,
                                                               g0, a0))
    return dict(carry=scan_carry_plain, adjcarry=scan_adjcarry_plain,
                fwd=scan_fwd_plain, bwd=scan_bwd_plain)


def _inclusive(P, h):
    """Inclusive scan over dim 1 (the segments) of h_s = P_s h_{s-1} + h_s."""
    S, d = P.shape[1], 1
    while d < S:
        h = torch.cat([h[:, :d], P[:, d:] * h[:, :-d] + h[:, d:]], dim=1)
        P = torch.cat([P[:, :d], P[:, d:] * P[:, :-d]], dim=1)
        d *= 2
    return h


def _decay(a: _Args, c):
    """exp(c A) of per-(row, segment, channel) dt sums c (rows, S, Cg):
    (rows, S, N, Cg)."""
    A = a.A.repeat(a.B, 1, 1)                                       # (rows, N, Cg)
    return torch.exp(c[:, :, None, :] * A[:, None])


def _incoming_states(a: _Args, S, ops):
    """Each segment row's state before its first step, (rows*S, N, Cg): the
    carries, then the combine over S (scan_fused.py:639-651)."""
    hend, csum = ops["carry"](a, S)
    P = _decay(a, csum.reshape(a.rows, S, a.Cg))
    Hinc = _inclusive(P, hend.reshape(a.rows, S, N_STATE, a.Cg))
    Hprev = torch.cat([torch.zeros_like(Hinc[:, :1]), Hinc[:, :-1]], dim=1)
    return Hprev.reshape(a.rows * S, N_STATE, a.Cg), csum


def _fwd_segmented(a: _Args, S: int) -> torch.Tensor:
    """y in u's layout: carries, combine, I-fwd seeded (scan_fused.py:630)."""
    ops = _scan_ops(a)
    h0, _ = _incoming_states(a, S, ops)
    return ops["fwd"](a, S, h0)


def _segment_seeds(a: _Args, gy: torch.Tensor, S: int, ops=None):
    """The seeds of the segmented backward's sweeps, each (rows*S, N, Cg)
    fp32: every segment row's incoming state h0, incoming adjoint g0 and the
    decay a0 of the step after it (scan_fused.py:657-700): carries and the
    forward combine; adjoint carries and the reverse combine."""
    ops = ops or _scan_ops(a)
    h0, csum = _incoming_states(a, S, ops)
    csum = csum.reshape(a.rows, S, a.Cg)
    gloc = ops["adjcarry"](a, gy, S).reshape(a.rows, S, N_STATE, a.Cg)
    # dt at each segment's first step, and at the next segment's (0 past the end)
    cfirst = softplus(a.first_steps(S) + a.bias.reshape(a.G, 1, a.Cg)).reshape(a.rows, S, a.Cg)
    cnext = torch.cat([cfirst[:, 1:], torch.zeros_like(cfirst[:, :1])], dim=1)
    Q = _decay(a, csum - cfirst + cnext)
    E = _inclusive(Q.flip(1), gloc.flip(1)).flip(1)     # E_s = gloc_s + Q_s E_{s+1}
    g0 = torch.cat([E[:, 1:], torch.zeros_like(E[:, :1])], dim=1)
    a0 = _decay(a, cnext)
    a0[:, -1] = 0.0
    flat = lambda t: t.reshape(a.rows * S, N_STATE, a.Cg).contiguous()
    return h0, flat(g0), flat(a0)


def _bwd_segmented(a: _Args, gy: torch.Tensor, S: int):
    """(dus, ddt, dB, dC, dA (rows, N, Cg)) as `_scan_bwd` gives them for the
    whole rows (scan_fused.py:657): I-ckpt and I-bwd over the segment rows,
    seeded by `_segment_seeds`."""
    ops = _scan_ops(a)
    dus, ddt, dB, dC, dA = ops["bwd"](a, gy, S, *_segment_seeds(a, gy, S, ops))
    return dus, ddt, dB, dC, dA.reshape(a.rows, S, N_STATE, a.Cg).sum(1)


def fwd_segmented(u, delta, A, Bmat, Cmat, D=None, delta_bias=None, S=1):
    """The flat contract's y (delta_softplus) by S segments per row: the
    kernels on CUDA tensors, the plain sweeps on CPU ones."""
    return _fwd_segmented(_Args(u, delta, A, Bmat, Cmat, D, delta_bias, flat=True), S)


def bwd_segmented(u, delta, A, Bmat, Cmat, gy, D=None, delta_bias=None, S=1):
    """The flat contract's sweep gradients by S segments per row, before the
    epilogue: (dus, ddt) (B, L, Dch), (dB, dC) (B, L, G, N), dA (B*G, N, Cg),
    fp32; ddt with respect to dt after the softplus."""
    return _bwd_segmented(_Args(u, delta, A, Bmat, Cmat, D, delta_bias, flat=True), gy, S)


# ---------------------------------------------------------- autograd functions


def _epilogue(a: _Args, gy, u, delta, A, Bm, Cm, D, bias, sweeps):
    """The seven input gradients from the sweeps' (dus, ddt, dB, dC, dA
    (rows, N, Cg)): the JAX package's epilogue (scan_fused.py:791-812 and
    :890-913): du + gy D, dD, ddt through the softplus's sigmoid, the
    bias's sum, dA summed over the batch."""
    dus, ddt, dB, dC, dA = sweeps
    # a (G*Cg) vector against u's layout, and the axes that are not channels
    vec = (lambda v: v) if a.flat else (lambda v: v.reshape(1, a.G, 1, a.Cg))
    axes = (0, 1) if a.flat else (0, 2)
    gyf = gy.float()
    du, dD = dus, None
    if D is not None:
        du = du + gyf * vec(a.D)
        dD = (gyf * u.float()).sum(axes).reshape(-1).to(D.dtype)
    ddt = ddt * torch.sigmoid(delta.float() + vec(a.bias))
    dbias = None if bias is None else ddt.sum(axes).reshape(-1).to(bias.dtype)
    dA = dA.reshape(a.B, a.G, N_STATE, a.Cg).sum(0).transpose(1, 2).reshape(-1, N_STATE)
    return (du.to(u.dtype), ddt.to(delta.dtype), dA.to(A.dtype), dB.to(Bm.dtype),
            dC.to(Cm.dtype), dD, dbias)


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
        saved = ctx.saved_tensors
        a = _Args(*saved)
        return _epilogue(a, gy, *saved, _scan_bwd(a, gy, _scan_ckpt(a)))


class _FlatScan(torch.autograd.Function):
    """Kernel H: the flat contract through kernel I's sweeps over rows b*G +
    g, sequential or segmented as `seg_count` decides; the JAX package's
    epilogue backward. dt = softplus(delta + delta_bias) always. Only the
    inputs are saved."""

    @staticmethod
    def forward(ctx, u, delta, A, Bmat, Cmat, D, delta_bias):
        ctx.save_for_backward(u, delta, A, Bmat, Cmat, D, delta_bias)
        a = _Args(u, delta, A, Bmat, Cmat, D, delta_bias, flat=True)
        S = seg_count(a.rows, a.L, a.Cg)
        return _fwd_segmented(a, S) if S > 1 else _scan_fwd(a)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        a = _Args(*saved, flat=True)
        S = seg_count(a.rows, a.L, a.Cg)
        sweeps = (_bwd_segmented(a, gy, S) if S > 1
                  else _scan_bwd(a, gy, _scan_ckpt(a)))
        return _epilogue(a, gy, *saved, sweeps)


# ------------------------------------------------ the general route (kernel J)


def scan_states_plain(dA: torch.Tensor, dBu: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Plain version of kernel J: h_t = dA_t h_{t-1} + dBu_t along dim 1 of
    fp32 (B, L, ...) operands from h = 0 (with `reverse`, h_t = dA_t h_{t+1}
    + dBu_t from the end), as chunks of `_PLAIN_CHUNK` doubling steps with
    the state carried between them."""
    if reverse:
        return scan_states_plain(dA.flip(1), dBu.flip(1)).flip(1)
    B, L = dA.shape[:2]
    a, x = dA.reshape(B, 1, L, -1), dBu.reshape(B, 1, L, -1)
    h, out = torch.zeros_like(x[:, :, 0]), []
    for l0 in range(0, L, _PLAIN_CHUNK):
        ac, xc = a[:, :, l0:l0 + _PLAIN_CHUNK], x[:, :, l0:l0 + _PLAIN_CHUNK]
        xc = _doubling_scan(ac, torch.cat([xc[:, :, :1] + ac[:, :, :1] * h[:, :, None],
                                           xc[:, :, 1:]], dim=2))
        out.append(xc)
        h = xc[:, :, -1]
    return torch.cat(out, dim=2).reshape(dBu.shape)


def scan_states(dA: torch.Tensor, dBu: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """`scan_states_plain`'s function over fp32 (B, L, ...) operands: kernel
    J on a CUDA tensor, the plain version on a CPU tensor."""
    if dA.device.type == "cpu":
        return scan_states_plain(dA, dBu, reverse)
    if (dA.dim() < 2 or dA.shape != dBu.shape or dA.dtype != torch.float32
            or dBu.dtype != torch.float32 or dBu.device != dA.device):
        raise ValueError("scan_states: dA and dBu must be fp32 (B, L, ...) of one shape on "
                         "one device")
    dA, dBu = dA.contiguous(), dBu.contiguous()
    h = torch.empty_like(dA)
    B, L = dA.shape[:2]
    _kernels.call("scan_states", dA.data_ptr(), dBu.data_ptr(), h.data_ptr(), B, L,
                  dA[0, 0].numel(), int(reverse), _kernels.stream_handle(dA.device))
    return h


def _states_operands(u, delta, A, Bmat, delta_bias, delta_softplus):
    """The general route's fp32 operands (ops/pallas/scan.py `_forward`):
    u, dt before and after the softplus (B, L, Dch), dA = exp(dt A) and dBu
    = dt u B (B, L, Dch, N), and dt u (B, L, G, Cg)."""
    B, L, Dch = u.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    uf, dt_in = u.float(), delta.float()
    if delta_bias is not None:
        dt_in = dt_in + delta_bias.float()
    dt = softplus(dt_in) if delta_softplus else dt_in
    dA = torch.exp(dt[..., None] * A.float())
    dtu = (dt * uf).reshape(B, L, G, Dch // G)
    dBu = (dtu[..., None] * Bmat.float()[:, :, :, None, :]).reshape(B, L, Dch, N)
    return uf, dt_in, dt, dA, dtu, dBu


class _StatesScan(torch.autograd.Function):
    """The flat contract on the general route: the JAX package's
    `selective_scan_pallas` (ops/pallas/scan.py:96-200) with kernel J for
    its three state recurrences (`scan_states`: the plain version on CPU
    tensors). Any N; the softplus of dt optional; any float dtype, computed
    in fp32. Only the inputs are saved."""

    @staticmethod
    def forward(ctx, u, delta, A, Bmat, Cmat, D, delta_bias, delta_softplus):
        ctx.save_for_backward(u, delta, A, Bmat, Cmat, D, delta_bias)
        ctx.delta_softplus = delta_softplus
        B, L, Dch = u.shape
        G, N = Bmat.shape[2], Bmat.shape[3]
        uf, _, _, dA, _, dBu = _states_operands(u, delta, A, Bmat, delta_bias, delta_softplus)
        h = scan_states(dA, dBu)
        y = torch.einsum("blgcn,blgn->blgc", h.reshape(B, L, G, Dch // G, N),
                         Cmat.float()).reshape(B, L, Dch)
        if D is not None:
            y = y + uf * D.float()
        return y.to(u.dtype)

    @staticmethod
    def backward(ctx, gy):
        u, delta, A, Bmat, Cmat, D, delta_bias = ctx.saved_tensors
        B, L, Dch = u.shape
        G, N = Bmat.shape[2], Bmat.shape[3]
        Cg = Dch // G
        uf, dt_in, dt, a, dtu, b = _states_operands(u, delta, A, Bmat, delta_bias,
                                                    ctx.delta_softplus)
        Af, Bf, Cf, gyf = A.float(), Bmat.float(), Cmat.float(), gy.float()
        h = scan_states(a, b)                                       # recompute
        # the reverse adjoint g_t = C_t dy_t + a_{t+1} g_{t+1}
        c = (gyf.reshape(B, L, G, Cg)[..., None] * Cf[:, :, :, None, :]).reshape(B, L, Dch, N)
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        g = scan_states(a_next, c, reverse=True)
        del c, a_next
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], dim=1)
        g4, h4 = g.reshape(B, L, G, Cg, N), h.reshape(B, L, G, Cg, N)
        dC = torch.einsum("blgc,blgcn->blgn", gyf.reshape(B, L, G, Cg), h4)
        dD = (gyf * uf).sum((0, 1)) if D is not None else None
        du = gyf * D.float() if D is not None else torch.zeros_like(uf)
        gB = torch.einsum("blgcn,blgn->blgc", g4, Bf).reshape(B, L, Dch)
        du = du + gB * dt
        ddt = gB * uf
        dB = torch.einsum("blgcn,blgc->blgn", g4, dtu)
        gha = g * h_prev * a
        ddt = ddt + torch.einsum("bldn,dn->bld", gha, Af)
        dA = torch.einsum("bldn,bld->dn", gha, dt)
        if ctx.delta_softplus:
            ddt = ddt * torch.sigmoid(dt_in)
        dbias = ddt.sum((0, 1)).to(delta_bias.dtype) if delta_bias is not None else None
        return (du.to(u.dtype), ddt.to(delta.dtype), dA.to(A.dtype), dB.to(Bmat.dtype),
                dC.to(Cmat.dtype), None if D is None else dD.to(D.dtype), dbias, None)


def _fused_kernels_take(u, delta, Bmat, Cmat, delta_softplus) -> bool:
    """Whether kernels H and I take the call: N = 16, the softplus of dt,
    u, delta, B and C of one dtype, fp32 or bf16."""
    return (delta_softplus and Bmat.shape[-1] == N_STATE
            and u.dtype in (torch.float32, torch.bfloat16)
            and all(t.dtype == u.dtype for t in (delta, Bmat, Cmat)))


def selective_scan(u, delta, A, Bmat, Cmat, D=None, delta_bias=None, delta_softplus=False):
    """The flat contract, (B, L, Dch) -> (B, L, Dch) in u's dtype: on a CUDA
    tensor kernel H (and its backward kernels) where it takes the call, the
    general route (`_StatesScan`, kernel J) otherwise; the plain version
    under torch autograd on a CPU tensor."""
    if u.device.type == "cpu":
        return selective_scan_plain(u, delta, A, Bmat, Cmat, D, delta_bias, delta_softplus)
    if not _fused_kernels_take(u, delta, Bmat, Cmat, delta_softplus):
        return _StatesScan.apply(u, delta, A, Bmat, Cmat, D, delta_bias, delta_softplus)
    return _FlatScan.apply(u, delta, A, Bmat, Cmat, D, delta_bias)


def cross_selective_scan(xs, dts, A, Bs, Cs, Ds=None, dt_bias=None, delta_softplus=True):
    """Direction-major selective scan, (B, K, L, Dk) -> (B, K, L, Dk) in
    xs's dtype: on a CUDA tensor kernel I (and its backward kernels) where
    it takes the call, the general route (`_StatesScan` over the flat view)
    otherwise; the plain version under torch autograd on a CPU tensor."""
    if xs.device.type == "cpu":
        return cross_selective_scan_plain(xs, dts, A, Bs, Cs, Ds, dt_bias, delta_softplus)
    if not _fused_kernels_take(xs, dts, Bs, Cs, delta_softplus):
        B, K, L, Dk = xs.shape
        flat = lambda t: t.transpose(1, 2).reshape(B, L, K * t.shape[-1])
        y = _StatesScan.apply(flat(xs), flat(dts), A, Bs.transpose(1, 2), Cs.transpose(1, 2),
                              Ds, dt_bias, delta_softplus)
        return y.reshape(B, L, K, Dk).transpose(1, 2)
    return _GroupedScan.apply(xs, dts, A, Bs, Cs, Ds, dt_bias)
