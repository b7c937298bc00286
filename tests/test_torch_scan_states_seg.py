"""Kernel J's arithmetic (smow_net_tpu_torch/csrc/scan_states.cu) on the
CPU: a torch model of where it rounds, with the chained segments its
wrapper chooses (`scan.states_seg_count`), against the JAX package's Pallas
`_scan_states` (interpret mode, patched inside tests/test_torch_scan_states.py)
and a float64 serial recurrence, forward and reverse.

The model: segment 0 walks h = fma(a, h, b) from h = 0 and its end state is
its inclusive state I_0; every later segment s walks from zero to E_s with
P_s, the product of its a's (one fp32 rounding a step), takes
I_s = fma(P_s, I_{s-1}, E_s) in segment order, and walks again from the
seed I_{s-1}. An fp32 FMA is the float64 product and sum (the product is
exact) rounded to fp32. Bounds: 1e-5 of the largest state, as the card holds
J against its plain version. No model compile; seconds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu_torch.ops import scan
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)
from test_torch_scan_states import interpret_mode  # noqa: F401  (autouse: Pallas interpreted)


def _fma(a, x, b):
    return (a.double() * x.double() + b.double()).float()


def seg_steps(L, S):
    """Steps of each of J's S segments but the last: ceil(L / S) rounded up
    to whole chunks of scan.STATES_CHUNK (kSteps); L when S == 1."""
    if S == 1:
        return L
    per = -(-L // S)
    return -(-per // scan.STATES_CHUNK) * scan.STATES_CHUNK


def kernel_model(dA, dBu, reverse=False):
    """h of fp32 (B, L, K) operands as kernel J computes it in the segments
    its wrapper chooses."""
    if reverse:
        return kernel_model(dA.flip(1), dBu.flip(1)).flip(1)
    B, L, K = dA.shape
    S = scan.states_seg_count(B, L, K)
    seg = seg_steps(L, S)
    assert -(-L // seg) == S
    h = torch.empty_like(dA)
    zero = torch.zeros_like(dA[:, 0])
    inclusive = None
    for s in range(S):
        steps = range(s * seg, min(L, (s + 1) * seg))
        if s == 0:
            x = zero
        else:
            e, p = zero, torch.ones_like(zero)
            for t in steps:
                e, p = _fma(dA[:, t], e, dBu[:, t]), p * dA[:, t]
            x, inclusive = inclusive, _fma(p, inclusive, e)
        for t in steps:
            x = _fma(dA[:, t], x, dBu[:, t])
            h[:, t] = x
        if s == 0:
            inclusive = x
    return h


def _serial64(dA, dBu, reverse):
    a, b = dA.astype(np.float64), dBu.astype(np.float64)
    order = range(a.shape[1] - 1, -1, -1) if reverse else range(a.shape[1])
    h, x = np.empty_like(a), np.zeros_like(a[:, 0])
    for t in order:
        x = a[:, t] * x + b[:, t]
        h[:, t] = x
    return h


def _pallas(dA, dBu, reverse, D, N):
    """JAX's `_scan_states` over the (B, L, D, N) view; reversed as its
    adjoint sweep takes it (flipped operands, flipped back)."""
    from smow_net_tpu.ops.pallas.scan import _scan_states

    B, L, _ = dA.shape
    flip = (lambda x: np.flip(x, 1).copy()) if reverse else (lambda x: x)
    h = _scan_states(jnp.asarray(flip(dA).reshape(B, L, D, N)),
                     jnp.asarray(flip(dBu).reshape(B, L, D, N)))
    return flip(np.asarray(h).reshape(B, L, D * N))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# (B, L, D, N, decay): the wrapper's segments (few strips: ceil(L / 192));
# dA = exp(-decay U)
CASES = {
    "shipped": (2, 1000, 8, 4, 1.0),          # 6 segments of 192 steps, the last of 40
    "two": (2, 200, 4, 3, 1.0),               # 128 steps and 72
    "last_one_step": (2, 385, 4, 3, 1.0),     # 192, 192 and 1
    "short": (2, 50, 4, 3, 1.0),              # shorter than one segment: one
    "l1": (3, 1, 8, 4, 1.0),
    "underflow": (2, 600, 8, 4, 100.0),       # every segment's product underflows to 0
    "near_one": (2, 2000, 8, 4, 1e-3),        # the seeds carry through 11 segments
}


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_model_matches_pallas_and_float64(case, reverse):
    """The model of J's segmented arithmetic against JAX's Pallas
    `_scan_states` and a float64 serial walk, 1e-5 of the largest state."""
    B, L, D, N, decay = CASES[case]
    rng = np.random.default_rng(len(case) + 10 * reverse)
    dA = np.exp(-decay * rng.uniform(size=(B, L, D * N))).astype(np.float32)
    dBu = rng.normal(size=(B, L, D * N)).astype(np.float32)
    got = kernel_model(torch.from_numpy(dA), torch.from_numpy(dBu), reverse).numpy()
    if case == "underflow":
        prods = np.cumprod(dA[:, :120].astype(np.float64), axis=1)[:, -1]
        assert (prods.astype(np.float32) == 0).all()
    assert _rel(got, _serial64(dA, dBu, reverse)) <= 1e-5
    assert _rel(got, _pallas(dA, dBu, reverse, D, N)) <= 1e-5
    plain = scan.scan_states_plain(torch.from_numpy(dA), torch.from_numpy(dBu), reverse)
    assert _rel(got, plain.numpy()) <= 1e-5


@pytest.mark.parametrize("shape, S", [
    ((13, 62500, 1024), 1),        # phase 24's timed shape: 416 strips stream
    ((2, 62500, 256), 326),        # the narrow long-L shape: 16 strips, 192 steps a segment
    ((4, 2048, 64), 11),           # phase 24's route checks, K = 2 * 32 * N, N = 1 ...
    ((4, 2048, 256), 11),
    ((4, 2048, 512), 11),
    ((4, 2048, 1024), 11),         # 128 strips
    ((4, 2048, 2048), 1),          # ... N = 32: 256 strips stream
    ((6, 62500, 1024), 1),         # 192 strips
    ((5, 62500, 1024), 326),       # 160
    ((2, 20000, 256), 105),        # the card tests' narrow shape
    ((1, 1, 33), 1), ((2, 7, 33), 1), ((3, 1000, 33), 6),
])
def test_states_seg_count_pins(shape, S):
    assert scan.states_seg_count(*shape) == S


def test_states_segments_fit_the_tile():
    """Every choice cuts L into exactly S segments of whole chunks, at most
    STATES_SEG_STEPS steps, none empty (the count the kernel checks)."""
    for B in (1, 2, 3, 8):
        for K in (1, 33, 64, 256, 1024):
            for L in (1, 2, 31, 32, 33, 127, 128, 129, 192, 193, 385, 1000, 4099, 62500):
                S = scan.states_seg_count(B, L, K)
                seg = seg_steps(L, S)
                assert S >= 1 and (S - 1) * seg < L <= S * seg
                if S > 1:
                    assert seg % scan.STATES_CHUNK == 0 and seg <= scan.STATES_SEG_STEPS
    assert seg_steps(62500, 326) == 192 and seg_steps(200, 2) == 128
