"""The port's general selective-scan route (smow_net_tpu_torch/ops/scan.py
`_StatesScan`, kernel J's route, and `scan_states_plain`, J's plain
version) against the JAX package's `selective_scan_pallas` and its
`_scan_states` on CPU, with `pl.pallas_call` in interpret mode inside this
file (as tests/test_pallas_scan.py runs it).

On a CPU tensor `_StatesScan` runs the plain `scan_states_plain` in J's
place, so these tests hold the whole route: the operands, y = C h + D u,
and the backward's two state recurrences and einsums. It serves the calls
that kernels H and I do not take: N != 16, delta_softplus=False, dtypes
other than fp32 and bf16.

Bounds: 1e-5 of each output's largest element (fp32 on both sides, sums
in another order: a chunked doubling scan against a sequential one), for y
and all seven gradients as for the states."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu_torch.ops import scan
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

ORDER = ("u", "delta", "A", "Bm", "Cm", "D", "bias")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    from jax.experimental import pallas as pl

    import smow_net_tpu.ops.pallas.scan as ps

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _inputs(seed, N, B=2, L=32, G=2, Dch=16):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(u=f(B, L, Dch), delta=f(B, L, Dch, scale=0.5),
                A=-np.exp(f(Dch, N, scale=0.5)), Bm=f(B, L, G, N), Cm=f(B, L, G, N),
                D=f(Dch), bias=f(Dch, scale=0.1))


@pytest.mark.parametrize("softplus", [True, False], ids=["softplus", "no_softplus"])
@pytest.mark.parametrize("N", [4, 32])
def test_states_scan_route_matches_selective_scan_pallas(N, softplus):
    """y and the seven input gradients of `_StatesScan` against jax.vjp of
    `selective_scan_pallas` (its `_forward` and `_bwd`, kernel `_scan_kernel`
    in interpret mode)."""
    from smow_net_tpu.ops.pallas.scan import selective_scan_pallas

    inp = _inputs(N + int(softplus), N)
    gy = np.random.default_rng(99).normal(size=inp["u"].shape).astype(np.float32)
    y_j, vjp = jax.vjp(lambda *a: selective_scan_pallas(*a, delta_softplus=softplus),
                       *[jnp.asarray(inp[k]) for k in ORDER])
    grads_j = vjp(jnp.asarray(gy))
    args = [torch.from_numpy(inp[k]).requires_grad_() for k in ORDER]
    y = scan._StatesScan.apply(*args, softplus)
    grads = torch.autograd.grad(y, args, torch.from_numpy(gy))
    assert y.dtype == torch.float32 and y.shape == inp["u"].shape
    assert _rel(y.detach().numpy(), y_j) <= 1e-5
    for name, g, w in zip(ORDER, grads, grads_j):
        assert g.shape == args[ORDER.index(name)].shape
        assert _rel(g.numpy(), w) <= 1e-5, name


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_scan_states_plain_matches_pallas_scan_states(reverse):
    """J's plain version against the Pallas `_scan_states` on the same
    (B, L, D, N) operands; J's reverse direction against `_scan_states` of
    the flipped operands, flipped back (JAX's adjoint sweep). L = 300 runs
    two of the plain version's chunks and a ragged third."""
    from smow_net_tpu.ops.pallas.scan import _scan_states

    rng = np.random.default_rng(7 + reverse)
    shape = (2, 300, 16, 4)
    dA = np.exp(-rng.uniform(0.0, 0.5, size=shape)).astype(np.float32)
    dBu = rng.normal(size=shape).astype(np.float32)
    if reverse:
        want = np.flip(np.asarray(_scan_states(jnp.asarray(np.flip(dA, 1).copy()),
                                               jnp.asarray(np.flip(dBu, 1).copy()))), 1)
    else:
        want = np.asarray(_scan_states(jnp.asarray(dA), jnp.asarray(dBu)))
    got = scan.scan_states_plain(torch.from_numpy(dA), torch.from_numpy(dBu), reverse=reverse)
    assert got.shape == shape
    assert _rel(got.numpy(), want) <= 1e-5


def test_fused_kernels_take_only_their_contract():
    """On a CUDA tensor the calls that kernels H and I refuse go to the
    general route: N != 16, no softplus, fp16, float64 and mixed dtypes."""
    def take(N=16, softplus=True, dtype=torch.float32, b_dtype=None):
        u = torch.zeros(1, 4, 2, dtype=dtype)
        Bm = torch.zeros(1, 4, 1, N, dtype=b_dtype or dtype)
        return scan._fused_kernels_take(u, u, Bm, Bm, softplus)

    assert take() and take(dtype=torch.bfloat16)
    assert not take(N=8) and not take(N=32) and not take(softplus=False)
    assert not take(dtype=torch.float16) and not take(dtype=torch.float64)
    assert not take(b_dtype=torch.bfloat16)


def test_states_scan_takes_float64_and_the_grouped_layout():
    """float64 inputs compute in fp32 and leave in float64 (as JAX's route
    does); the grouped (B, K, L, Dk) contract viewed as the flat one gives
    `cross_selective_scan_plain`'s y."""
    inp = _inputs(3, 8)
    args = [torch.from_numpy(inp[k]) for k in ORDER]
    y64 = scan._StatesScan.apply(*[a.double() for a in args], False)
    y32 = scan._StatesScan.apply(*args, False)
    assert y64.dtype == torch.float64 and torch.equal(y64, y32.double())
    B, L, Dch = args[0].shape
    G = 2
    grouped = lambda t: t.reshape(B, L, G, -1).transpose(1, 2).contiguous()
    xs, dts = grouped(args[0]), grouped(args[1])
    Bs, Cs = args[3].transpose(1, 2).contiguous(), args[4].transpose(1, 2).contiguous()
    want = scan.cross_selective_scan_plain(xs, dts, args[2], Bs, Cs, args[5], args[6], True)
    flat = lambda t: t.transpose(1, 2).reshape(B, L, -1)
    got = scan._StatesScan.apply(flat(xs), flat(dts), args[2], Bs.transpose(1, 2),
                                 Cs.transpose(1, 2), args[5], args[6], True)
    assert _rel(got.reshape(B, L, G, -1).transpose(1, 2).numpy(), want.numpy()) <= 1e-5
