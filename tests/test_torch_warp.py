"""The port's plain warp ops (smow_net_tpu_torch/ops/warp.py) against the JAX
package on CPU: `token_scatter_plain` (the plain version of kernel D)
against JAX's Pallas `token_scatter_pallas` in interpret mode and JAX's XLA
`token_softmax_scatter`; `grid_sample_plain` and `grid_sample_transpose_plain`
(the plain versions of kernels A and B) against their JAX twins.

Tolerance 1e-5 (rtol and atol) in fp32, as tests/test_pallas_warp.py uses
for the same kernel: both sides lerp and exponentiate in fp32 and differ
only in summation order. The end-to-end test from a flow field states its
own bound."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.ops import warp as jwarp
from smow_net_tpu.ops.pallas.warp import pallas_warp_supported, token_scatter_pallas
from smow_net_tpu_torch.ops import warp as twarp

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, H, W, C): the small square case, then W*C = 1024 (SMOW_Net's C = 8
# chain width) and 2048 (SMOW_Net_LW's C = 16)
SHAPES = [(2, 32, 32, 8), (1, 8, 128, 8), (1, 8, 128, 16)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while JAX shares the process, as in
    tests/test_torch_scan.py: with torch's default thread pool, now and then
    one OpenMP thread's 2048-element chunk of `torch.exp` (the MKL VML path;
    here the scatter's exp of the logits) comes out up to 1.5e-4 relative
    off once a JAX op has run in the process. This avoids that known wrong
    result; it is not a fix."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    B, H, W, C = shape
    a = rng.normal(size=shape).astype(np.float32)
    flow = (rng.normal(size=(B, H, W, 2)) * 3.0).astype(np.float32)
    return a, flow


def _grid(flow):
    B, H, W, _ = flow.shape
    return np.array(jwarp._flow_grid(jnp.asarray(flow), H, W))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_token_scatter_plain_matches_pallas_and_xla(shape):
    """Same logits and the same (JAX-built) grid through the port's plain
    kernel-D version, JAX's Pallas kernel (interpret mode) and JAX's XLA
    chain."""
    a, flow = _inputs(shape, 0)
    assert pallas_warp_supported(shape, shape[:3] + (2,))
    grid = _grid(flow)
    at = torch.from_numpy(a)
    ew, zaw = twarp.token_scatter_plain(at, torch.from_numpy(grid), at.amax(dim=(1, 2)))
    ew_p, zaw_p = token_scatter_pallas(jnp.asarray(a), jnp.asarray(grid), True)
    ew_x, zaw_x = jwarp.token_softmax_scatter(jnp.asarray(a), jnp.asarray(flow))
    for ref_ew, ref_z in ((ew_p, zaw_p), (ew_x, zaw_x)):
        np.testing.assert_allclose(ew.numpy(), np.asarray(ref_ew), **TOL)
        np.testing.assert_allclose(zaw.numpy(), np.asarray(ref_z), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_token_softmax_scatter_matches_xla(shape):
    """End to end from the flow field. torch's and jnp's linspace differ by
    up to 1 ulp (1.2e-7), which moves a sample by up to 1e-5 pixel at
    W = 128; times logit slopes of a few units per pixel that reaches ~2e-5
    in ew, so this comparison allows 1e-4."""
    a, flow = _inputs(shape, 0)
    ew, zaw = twarp.token_softmax_scatter(torch.from_numpy(a), torch.from_numpy(flow))
    ew_x, zaw_x = jwarp.token_softmax_scatter(jnp.asarray(a), jnp.asarray(flow))
    np.testing.assert_allclose(ew.numpy(), np.asarray(ew_x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(zaw.numpy(), np.asarray(zaw_x), rtol=1e-4, atol=1e-4)


def test_token_scatter_large_spread_underflows_to_zero():
    """A logit spike > 87 above everything the grid samples: every exp of
    that channel underflows, zaw -> 0 exactly and ew -> 0, on both sides;
    the caller's max(zaw, 1e-30) clamp keeps the division finite."""
    a, _ = _inputs((2, 32, 32, 8), 1)
    a[:, :, 0, 0] = 150.0                       # spike along the left column
    flow = np.zeros((2, 32, 32, 2), np.float32)
    flow[..., 0] = 3 * 32.0                     # sample only the right column
    grid = _grid(flow)
    at = torch.from_numpy(a)
    ew, zaw = twarp.token_scatter_plain(at, torch.from_numpy(grid), at.amax(dim=(1, 2)))
    ew_p, zaw_p = token_scatter_pallas(jnp.asarray(a), jnp.asarray(grid), True)
    np.testing.assert_allclose(ew.numpy(), np.asarray(ew_p), **TOL)
    np.testing.assert_allclose(zaw.numpy(), np.asarray(zaw_p), **TOL)
    assert np.all(zaw.numpy()[:, 0] == 0.0) and np.all(ew.numpy()[..., 0] == 0.0)
    assert np.all(zaw.numpy()[:, 1:] > 0.0)
    pooled = ew / zaw.clamp_min(1e-30)[:, None, None, :]
    assert torch.isfinite(pooled).all()


def test_grid_sample_and_transpose_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 24, 8)).astype(np.float32)
    g = rng.normal(size=(2, 16, 24, 8)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, size=(2, 16, 24, 2)).astype(np.float32)
    out = twarp.grid_sample_plain(torch.from_numpy(x), torch.from_numpy(grid))
    ref = jwarp.grid_sample(jnp.asarray(x), jnp.asarray(grid), "border", True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    out_t = twarp.grid_sample_transpose_plain(torch.from_numpy(g), torch.from_numpy(grid),
                                              (16, 24))
    ref_t = jwarp.grid_sample_transpose(jnp.asarray(g), jnp.asarray(grid), (16, 24),
                                        "border", True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_t), **TOL)


def test_flow_grid_matches_jax():
    _, flow = _inputs((2, 32, 32, 8), 3)
    out = twarp.flow_grid(torch.from_numpy(flow), 32, 32)
    np.testing.assert_allclose(out.numpy(), _grid(flow), rtol=0, atol=1e-6)


def test_token_scatter_routes_cpu_tensors_to_the_plain_version():
    """On a CPU tensor the wrapper is the plain version and launches nothing."""
    from smow_net_tpu_torch.ops import _kernels

    a, flow = _inputs((2, 32, 32, 8), 4)
    at = torch.from_numpy(a)
    grid = twarp.flow_grid(torch.from_numpy(flow), 32, 32)
    m = at.amax(dim=(1, 2))
    before = _kernels.launches["token_scatter_fwd"]
    for got, want in zip(twarp.token_scatter(at, grid, m),
                         twarp.token_scatter_plain(at, grid, m)):
        assert torch.equal(got, want)
    assert _kernels.launches["token_scatter_fwd"] == before
