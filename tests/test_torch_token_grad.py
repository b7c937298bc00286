"""The port's token-chain gradient (smow_net_tpu_torch/ops/warp.py
`token_softmax_scatter`, the autograd Function over kernels E, C and A-bwd)
and the plain versions of C and A-bwd against the JAX package on CPU.

On a CPU tensor every op of the Function is its plain version, so these
tests hold the plain E, C and A-bwd and the Function's chain rule to JAX's
Pallas kernels in interpret mode (`token_scatter_hybrid_pallas`,
`grid_sample_transpose_vjp_pallas`, `grid_sample_pallas`) and to JAX's XLA
train chain.

Tolerance 1e-5 (rtol and atol) in fp32, as tests/test_pallas_warp.py uses:
both sides compute in fp32 and differ in summation order. Two stated
exceptions:
  * from a flow field, torch's and jnp's linspace differ by up to 1 ulp
    (tests/test_torch_warp.py), which moves a sample by up to 1e-5 pixel;
    times logit slopes of a few units that reaches ~2e-5, so 1e-4;
  * dgrid is compared off the border ties (|grid| == 1, where the inner
    clamp's bound is hit exactly): torch.clamp passes the whole gradient at
    a tie and jnp.clip half of it, so there the port's dgrid is twice
    JAX's. dflow never sees this: the outer clip of the flow grid already
    zeroes the gradient wherever the grid was clipped. dgrid is a
    difference of two weight-gradient sums (d/di = dw1 - dw0) that cancel,
    so its rounding scales with the sums: its atol is 1e-5 of its largest
    element."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.ops import warp as jwarp
from smow_net_tpu.ops.pallas.warp import (grid_sample_pallas, grid_sample_transpose_vjp_pallas,
                                          pallas_warp_supported, token_scatter_hybrid_pallas)
from smow_net_tpu_torch.ops import warp as twarp

TOL = dict(rtol=1e-5, atol=1e-5)
FLOW_TOL = dict(rtol=1e-4, atol=1e-4)

# (F, H, W, C): SMOW_Net's C = 8, and C = 16 (SMOW_Net_LW's chain width)
SHAPES = [(4, 16, 16, 8), (4, 16, 16, 16)]
CASES = [(s, False) for s in SHAPES] + [(SHAPES[0], True)]
IDS = ["4x16x16x8", "4x16x16x16", "spread>87"]


def _inputs(shape, seed, spike=False):
    rng = np.random.default_rng(seed)
    F_, H, W, C = shape
    a = (rng.normal(size=shape) * 2.0).astype(np.float32)
    flow = (rng.normal(size=(F_, H, W, 2)) * 3.0).astype(np.float32)
    if spike:   # spike along the left column; the grid samples only the right one
        a[:, :, 0, 0] = 150.0
        flow[..., 0] = 3.0 * W
    r = rng.normal(size=shape).astype(np.float32)
    s = rng.normal(size=(F_, C)).astype(np.float32)
    return a, flow, r, s


def _jax_grads(fn, a, flow, r, s):
    """(da, dflow) of sum(ew r) + sum(zaw s) for (ew, zaw) = fn(a, flow)."""
    (ew, zaw), vjp = jax.vjp(fn, jnp.asarray(a), jnp.asarray(flow))
    da, dflow = vjp((jnp.asarray(r, ew.dtype), jnp.asarray(s, zaw.dtype)))
    return np.asarray(da), np.asarray(dflow)


def _port_grads(a, flow, r, s):
    at = torch.from_numpy(a).requires_grad_()
    ft = torch.from_numpy(flow).requires_grad_()
    ew, zaw = twarp.token_softmax_scatter(at, ft)
    loss = (ew * torch.from_numpy(r)).sum() + (zaw * torch.from_numpy(s)).sum()
    da, dflow = torch.autograd.grad(loss, (at, ft))
    return da.numpy(), dflow.numpy()


def _close_dgrid(got, want, inside):
    np.testing.assert_allclose(got[inside], want[inside], rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _off_ties(grid):
    """Mask (.., 2) of grid coordinates strictly inside [-1, 1]."""
    return np.abs(grid) < 1.0


@pytest.mark.parametrize("shape,spike", CASES, ids=IDS)
def test_token_chain_gradient_matches_pallas_hybrid_and_xla(shape, spike):
    a, flow, r, s = _inputs(shape, 0, spike)
    F_, H, W, C = shape
    assert pallas_warp_supported(shape, (F_, H, W, 2))
    da, dflow = _port_grads(a, flow, r, s)
    assert np.isfinite(da).all() and np.isfinite(dflow).all()
    hybrid = lambda x, f: token_scatter_hybrid_pallas(x, jwarp._flow_grid(f, H, W), True)
    for fn in (hybrid, jwarp.token_softmax_scatter_train):
        da_j, dflow_j = _jax_grads(fn, a, flow, r, s)
        np.testing.assert_allclose(da, da_j, **FLOW_TOL)
        np.testing.assert_allclose(dflow, dflow_j, **FLOW_TOL)
    assert np.abs(dflow).max() > 1e-3, "dflow vanished: the check would be vacuous"


@pytest.mark.parametrize("shape,spike", CASES, ids=IDS)
def test_token_chain_gradient_on_one_grid_matches_pallas_hybrid(shape, spike):
    """The Function itself on the JAX-built grid: (da, dgrid) at 1e-5."""
    a, flow, r, s = _inputs(shape, 1, spike)
    F_, H, W, C = shape
    grid = np.array(jwarp._flow_grid(jnp.asarray(flow), H, W))
    at = torch.from_numpy(a).requires_grad_()
    gt = torch.from_numpy(grid).requires_grad_()
    ew, zaw = twarp._TokenSoftmaxScatter.apply(at, gt)
    loss = (ew * torch.from_numpy(r)).sum() + (zaw * torch.from_numpy(s)).sum()
    da, dgrid = (t.numpy() for t in torch.autograd.grad(loss, (at, gt)))
    (ew_j, zaw_j), vjp = jax.vjp(lambda x, g: token_scatter_hybrid_pallas(x, g, True),
                                 jnp.asarray(a), jnp.asarray(grid))
    np.testing.assert_allclose(ew.detach().numpy(), np.asarray(ew_j), **TOL)
    np.testing.assert_allclose(zaw.detach().numpy(), np.asarray(zaw_j), **TOL)
    da_j, dgrid_j = (np.asarray(t) for t in vjp((jnp.asarray(r), jnp.asarray(s))))
    np.testing.assert_allclose(da, da_j, **TOL)
    inside = _off_ties(grid)
    _close_dgrid(dgrid, dgrid_j, inside)
    # at the ties: torch.clamp passes the whole gradient, jnp.clip half
    assert (~inside).any()
    _close_dgrid(dgrid, 2.0 * dgrid_j, ~inside)
    if spike:
        assert np.all(zaw.detach().numpy()[:, 0] == 0.0)


def _sample_inputs(C, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 16, 16, C)).astype(np.float32)
    g = rng.normal(size=(2, 16, 16, C)).astype(np.float32)
    # some coordinates beyond [-1, 1]: clamped to the border
    grid = rng.uniform(-1.2, 1.2, size=(2, 16, 16, 2)).astype(np.float32)
    return x, g, grid


@pytest.mark.parametrize("C", [8, 16])
def test_grid_sample_t_vjp_plain_matches_pallas(C):
    """Plain kernel C: (dg, dgrid) of the scatter op against the Pallas
    `_t_vjp_kernel` (interpret mode)."""
    xbar, g, grid = _sample_inputs(C, 2)
    dg, dw = twarp.grid_sample_t_vjp_plain(torch.from_numpy(xbar), torch.from_numpy(g),
                                           torch.from_numpy(grid))
    dgrid = twarp.corner_weights_vjp(torch.from_numpy(grid), dw, 16, 16).numpy()
    dg_j, dgrid_j = grid_sample_transpose_vjp_pallas(
        jnp.asarray(g), jnp.asarray(grid), jnp.asarray(xbar), interpret=True)
    np.testing.assert_allclose(dg.numpy(), np.asarray(dg_j), **TOL)
    inside = _off_ties(np.clip(grid, -1, 1))
    _close_dgrid(dgrid, np.asarray(dgrid_j), inside)
    # where the grid is clamped (|grid| > 1) neither side passes a gradient
    assert np.all(dgrid[np.abs(grid) > 1] == 0.0)


@pytest.mark.parametrize("C", [8, 16])
def test_grid_sample_bwd_plain_matches_pallas(C):
    """Plain kernel A-bwd: (dx, dgrid) of the sampling op against jax.vjp of
    `grid_sample_pallas` (interpret mode, the `_bwd_kernel` body)."""
    x, gy, grid = _sample_inputs(C, 3)
    dx, dw = twarp.grid_sample_bwd_plain(torch.from_numpy(x), torch.from_numpy(gy),
                                         torch.from_numpy(grid))
    dgrid = twarp.corner_weights_vjp(torch.from_numpy(grid), dw, 16, 16).numpy()
    _, vjp = jax.vjp(lambda xx, gg: grid_sample_pallas(xx, gg, "border", True, True),
                     jnp.asarray(x), jnp.asarray(grid))
    dx_j, dgrid_j = (np.asarray(t) for t in vjp(jnp.asarray(gy)))
    np.testing.assert_allclose(dx.numpy(), dx_j, **TOL)
    inside = _off_ties(np.clip(grid, -1, 1))
    _close_dgrid(dgrid, dgrid_j, inside)


def test_plain_backward_ops_are_the_autograd_of_the_plain_forward():
    """The hand-written plain VJPs against torch autograd of the plain
    primal ops, dgrid included (torch's clamp rule on both sides)."""
    x, g, grid = _sample_inputs(8, 4)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    grt = torch.from_numpy(grid).requires_grad_()
    xr = xt.clone().requires_grad_()
    out = twarp.grid_sample(xr, grt)
    dx_a, dgrid_a = torch.autograd.grad(out, (xr, grt), gt)
    dx, dw = twarp.grid_sample_bwd_plain(xt, gt, grt.detach())
    np.testing.assert_allclose(dx.numpy(), dx_a.numpy(), **TOL)
    np.testing.assert_allclose(twarp.corner_weights_vjp(grt.detach(), dw, 16, 16).numpy(),
                               dgrid_a.numpy(), **TOL)
    gr = gt.clone().requires_grad_()
    out = twarp.grid_sample_transpose(gr, grt, (16, 16))
    dg_a, dgrid_a = torch.autograd.grad(out, (gr, grt), xt)
    dg, dw = twarp.grid_sample_t_vjp_plain(xt, gt, grt.detach())
    np.testing.assert_allclose(dg.numpy(), dg_a.numpy(), **TOL)
    np.testing.assert_allclose(twarp.corner_weights_vjp(grt.detach(), dw, 16, 16).numpy(),
                               dgrid_a.numpy(), **TOL)


def test_nan_grid_gives_in_range_corner_indices():
    """A NaN coordinate maps to corner index 0 (as the kernels' fmaxf clamp
    and XLA's float -> int conversion do) with NaN weights, so the plain
    gathers and scatters never index out of range."""
    grid = torch.zeros(1, 4, 4, 2)
    grid[0, 1, 2, 0] = float("nan")
    grid[0, 3, 3, 1] = float("nan")
    y0, y1, wy0, wy1, x0, x1, wx0, wx1 = twarp.corner_rows(grid, 8, 8)
    for idx in (y0, y1, x0, x1):
        assert int(idx.min()) >= 0 and int(idx.max()) <= 7
    assert int(x0[0, 1, 2]) == 0 and int(y0[0, 3, 3]) == 0
    assert torch.isnan(wx0[0, 1, 2]) and torch.isnan(wy1[0, 3, 3])
    x = torch.randn(1, 8, 8, 8, generator=torch.Generator().manual_seed(0))
    out = twarp.grid_sample(x, grid)
    assert torch.isnan(out[0, 1, 2]).all() and torch.isfinite(out[0, 0]).all()
