"""The port's selective scan and its layout ops (smow_net_tpu_torch/ops/
{scan,cross_scan,resize}.py) against the JAX package on CPU.

On a CPU tensor `cross_selective_scan` is `cross_selective_scan_plain`, the
plain version of kernel I; it is held against JAX's Pallas kernel I in
interpret mode (`selective_scan_fused_grouped(..., interpret=True)`) and
against JAX's own `cross_selective_scan` (on the CPU, its associative scan),
on the same numpy-seeded inputs. Bounds:
  - cross_scan / cross_merge: exact (pure data movement);
  - resize_linear: 1e-6 (fp32 interpolation weights from float64 in JAX);
  - the scan forward: 1e-5 of the largest output, as
    tests/test_pallas_scan_fused.py holds the Pallas kernel (fp32 sums in
    another order: a chunked doubling scan against a sequential or
    associative one);
  - all seven input gradients: 2e-4 of each gradient's largest element
    (sums over L and over the batch in fp32);
  - bf16 inputs: one bf16 rounding (2^-8) of the largest output, against
    JAX fed the same bf16 values;
  - softplus at |x| > 20: finite and equal to jax.nn.softplus to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.ops import cross_scan as jcs
from smow_net_tpu.ops import resize as jresize
from smow_net_tpu.ops import scan as jscan
from smow_net_tpu.ops.pallas.scan_fused import selective_scan_fused_grouped
from smow_net_tpu_torch.ops import cross_scan, resize, scan

SHAPE = (2, 4, 64, 16)      # (B, K, L, Dk)
N = 16


def _inputs(seed, shape=SHAPE, dt_scale=0.5):
    B, K, L, Dk = shape
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    return dict(xs=f(B, K, L, Dk), dts=f(B, K, L, Dk, scale=dt_scale),
                A=-np.exp(f(K * Dk, N, scale=0.5)), Bs=f(B, K, L, N), Cs=f(B, K, L, N),
                Ds=f(K * Dk), dt_bias=f(K * Dk, scale=0.1))


ORDER = ("xs", "dts", "A", "Bs", "Cs", "Ds", "dt_bias")
# JAX's plain scans jitted: compiling one costs less CPU than dispatching it eagerly
_jax_cross = jax.jit(jscan.cross_selective_scan)
_jax_flat = jax.jit(jscan.selective_scan, static_argnames="delta_softplus")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while JAX shares the process. This
    avoids a known wrong result of torch's own exp; it is not a fix. With
    torch's default thread pool, now and then (3 of 11 runs of a probe of
    this file) one OpenMP thread's 2048-element chunk of `torch.exp` (the
    MKL VML path; here the softplus's exp inside the plain scan) comes out
    up to 1.5e-4 relative off, and the scan output up to 3.6e-5 of its
    largest element. A bare `torch.exp` of 8192 values, the first in a
    process that had run a jitted JAX op, showed it once in 60 processes
    (none in 60 without JAX). The cause inside torch or MKL is not known."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _torch(inp, dtype=torch.float32, grad=False):
    return [torch.from_numpy(inp[k]).to(dtype if k in ("xs", "dts", "Bs", "Cs") else
                                        torch.float32).requires_grad_(grad) for k in ORDER]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def test_cross_scan_and_merge_match_jax():
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    xs = cross_scan.cross_scan(torch.from_numpy(x))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jcs.cross_scan(jnp.asarray(x))))
    ys = np.random.default_rng(1).normal(size=(2, 4, 35, 3)).astype(np.float32)
    got = cross_scan.cross_merge(torch.from_numpy(ys), 5, 7).numpy()
    want = np.asarray(jcs.cross_merge(jnp.asarray(ys), 5, 7))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)    # the same adds, any order


@pytest.mark.parametrize("src,dst,C", [(1, 2, 4), (8, 16, 8), (16, 32, 8), (32, 64, 8),
                                       (64, 256, 2)])
def test_resize_linear_matches_jax(src, dst, C):
    """ChangeMamba's FPN upsample-adds (stride 32 -> 4 at 256^2) and the
    head's resize from stride 4 to the input, align_corners=False."""
    x = np.random.default_rng(src).normal(size=(2, src, src, C)).astype(np.float32)
    want = np.asarray(jresize.resize_linear(jnp.asarray(x), (dst, dst), (1, 2),
                                            align_corners=False))
    got = resize.resize_linear(torch.from_numpy(x).permute(0, 3, 1, 2), (dst, dst))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_grouped():
    """JAX's Pallas kernel I (interpret mode): the output and the seven
    gradients for a fixed cotangent; and JAX's cross_selective_scan."""
    inp = _inputs(0)
    gy = np.random.default_rng(9).normal(size=SHAPE).astype(np.float32)
    args = [jnp.asarray(inp[k]) for k in ORDER]

    def loss(*a):
        y = selective_scan_fused_grouped(*a, True, True)
        return jnp.sum(y * gy), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(7)), has_aux=True))(*args)
    plain = _jax_cross(*args)

    return dict(inp=inp, gy=gy, y=np.asarray(y), grads=[np.asarray(t) for t in g],
                jax_plain=np.asarray(plain))


def test_scan_forward_matches_jax(jax_grouped):
    y = scan.cross_selective_scan(*_torch(jax_grouped["inp"]), delta_softplus=True)
    assert y.dtype == torch.float32 and y.shape == SHAPE
    assert _rel(y.numpy(), jax_grouped["y"]) <= 1e-5
    assert _rel(y.numpy(), jax_grouped["jax_plain"]) <= 1e-5


def test_scan_gradients_match_jax(jax_grouped):
    """All seven input gradients against JAX's kernel I backward (I-ckpt,
    I-bwd and its epilogue), through torch autograd of the plain version."""
    args = _torch(jax_grouped["inp"], grad=True)
    y = scan.cross_selective_scan(*args, delta_softplus=True)
    grads = torch.autograd.grad(y, args, torch.from_numpy(jax_grouped["gy"]))
    for name, got, want in zip(ORDER, grads, jax_grouped["grads"]):
        assert got.shape == want.shape, name
        assert _rel(got.numpy(), want) <= 2e-4, (name, _rel(got.numpy(), want))


def test_scan_bf16_matches_jax():
    """bf16 xs, dts, Bs, Cs (the eval step's dtypes): y in bf16, within one
    bf16 rounding of JAX's plain scan on the same bf16 values."""
    inp = _inputs(1)
    args = _torch(inp, torch.bfloat16)
    y = scan.cross_selective_scan(*args, delta_softplus=True)
    assert y.dtype == torch.bfloat16
    jargs = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
             if k in ("xs", "dts", "Bs", "Cs") else jnp.asarray(inp[k])
             for k, a in zip(ORDER, args)]
    want = np.asarray(_jax_cross(*jargs), np.float32)
    assert _rel(y.float().numpy(), want) <= 2.0 ** -8


def test_softplus_large_arguments():
    x = np.array([-80.0, -30.0, -20.5, -1.0, 0.5, 20.5, 30.0, 80.0], np.float32)
    got = scan.softplus(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-30)
    # a scan whose raw dt sits beyond +-20 stays finite and matches JAX
    inp = _inputs(2, (1, 4, 32, 8), dt_scale=30.0)
    y = scan.cross_selective_scan(*_torch(inp), delta_softplus=True)
    want = _jax_cross(*[jnp.asarray(inp[k]) for k in ORDER])
    assert np.isfinite(y.numpy()).all() and _rel(y.numpy(), want) <= 1e-5


@pytest.mark.parametrize("G,softplus,L", [(4, True, 300), (1, False, 64)])
def test_flat_selective_scan_matches_jax(G, softplus, L):
    """The flat (B, L, D) contract with G groups; L = 300 leaves a ragged
    last chunk in the plain scan."""
    rng = np.random.default_rng(G)
    Dch, Bn = 32, 2
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    delta = f(Bn, L, Dch, scale=0.5)
    if not softplus:
        delta = np.abs(delta)    # a raw negative dt makes exp(dt A) > 1: keep the scan bounded
    a = [f(Bn, L, Dch), delta, -np.exp(f(Dch, N, scale=0.5)), f(Bn, L, G, N), f(Bn, L, G, N),
         f(Dch), f(Dch, scale=0.1)]
    got = scan.selective_scan(*map(torch.from_numpy, a), delta_softplus=softplus)
    want = _jax_flat(*map(jnp.asarray, a), delta_softplus=softplus)
    assert _rel(got.numpy(), want) <= 1e-5
