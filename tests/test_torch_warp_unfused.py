"""The port's unfused token chain and its two warps (smow_net_tpu_torch/ops/
warp.py: `grid_sample`, kernel A's forward; `grid_sample_transpose`, kernel
B; `flow_warp`, `flow_warp_transpose`; `token_softmax_scatter` with
train_chain="unfused") against the JAX package on CPU.

On a CPU tensor every op is its plain version, so these tests hold the plain
A-fwd and B to JAX's Pallas kernels in interpret mode (`grid_sample_pallas`
`_kernel`, `grid_sample_transpose_pallas` `_t_kernel`) and to JAX's XLA
ops, and the two autograd Functions and the chain to jax.vjp of JAX's
`flow_warp`, `flow_warp_transpose` and `token_softmax_scatter_train` (on
CPU JAX runs the unfused chain, smow_net_tpu/ops/warp.py:291).

The four (padding_mode, align_corners) pairs of the warps and their VJPs
(kernels A-fwd, B, C and A-bwd take them all) are held the same way at
C = 8 and 32: on random grids beyond [-1, 1] no coordinate sits exactly on
a clamp bound, so dgrid is compared everywhere, to 1e-5 of its largest
element (d/di = dw1 - dw0 cancels).

Tolerance 1e-5 (rtol and atol) in fp32, as tests/test_pallas_warp.py uses:
both sides lerp in fp32 and differ in summation order. From a flow field
torch's and jnp's linspace differ by up to 1 ulp, which moves a sample by up
to 1e-5 pixel; times slopes of a few units that reaches ~2e-5, so results
from a flow are held to 1e-4 (tests/test_torch_warp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.ops import warp as jwarp
from smow_net_tpu.ops.pallas.warp import (grid_sample_pallas, grid_sample_transpose_pallas,
                                          grid_sample_transpose_vjp_pallas,
                                          pallas_warp_supported)
from smow_net_tpu_torch.ops import _kernels
from smow_net_tpu_torch.ops import warp as twarp
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

TOL = dict(rtol=1e-5, atol=1e-5)
FLOW_TOL = dict(rtol=1e-4, atol=1e-4)

# (F, H, W, C): SMOW_Net_LW's chain width C = 8 and C = 16, then the
# large-spread case (a logit spike > 87 the grid never samples)
SHAPES = [(4, 16, 16, 8), (4, 16, 16, 16)]
CASES = [(s, False) for s in SHAPES] + [(SHAPES[0], True)]
IDS = ["4x16x16x8", "4x16x16x16", "spread>87"]


def _inputs(shape, seed, spike=False):
    """Logits, a flow (border-clamped in the spike case) and cotangents."""
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


@pytest.mark.parametrize("C", [8, 16])
def test_grid_sample_plain_matches_pallas_and_xla(C):
    """Plain kernel A-fwd: the same image and grid (some coordinates beyond
    [-1, 1], clamped to the border) through the Pallas `_kernel` in
    interpret mode and JAX's XLA gather."""
    rng = np.random.default_rng(C)
    x = rng.normal(size=(2, 16, 16, C)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(2, 16, 16, 2)).astype(np.float32)
    assert pallas_warp_supported(x.shape, grid.shape)
    out = twarp.grid_sample_plain(torch.from_numpy(x), torch.from_numpy(grid)).numpy()
    ref_p = grid_sample_pallas(jnp.asarray(x), jnp.asarray(grid), "border", True, True)
    ref_x = jwarp.grid_sample(jnp.asarray(x), jnp.asarray(grid), "border", True)
    np.testing.assert_allclose(out, np.asarray(ref_p), **TOL)
    np.testing.assert_allclose(out, np.asarray(ref_x), **TOL)


@pytest.mark.parametrize("C", [8, 16])
def test_grid_sample_transpose_plain_matches_pallas_and_xla(C):
    """Plain kernel B: the scatter through the Pallas `_t_kernel` in
    interpret mode and JAX's XLA adjoint (a VJP of its gather)."""
    rng = np.random.default_rng(10 + C)
    g = rng.normal(size=(2, 16, 16, C)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(2, 16, 16, 2)).astype(np.float32)
    out = twarp.grid_sample_transpose_plain(torch.from_numpy(g), torch.from_numpy(grid),
                                            (16, 16)).numpy()
    ref_p = grid_sample_transpose_pallas(jnp.asarray(g), jnp.asarray(grid), (16, 16),
                                         "border", True, True)
    ref_x = jwarp.grid_sample_transpose(jnp.asarray(g), jnp.asarray(grid), (16, 16),
                                        "border", True)     # XLA on the CPU
    np.testing.assert_allclose(out, np.asarray(ref_p), **TOL)
    np.testing.assert_allclose(out, np.asarray(ref_x), **TOL)


MODES = [("border", True), ("border", False), ("zeros", True), ("zeros", False)]
MODE_IDS = ["border_align", "border_half", "zeros_align", "zeros_half"]


def _mode_inputs(C, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 16, 16, C)).astype(np.float32)
    g = rng.normal(size=(2, 16, 16, C)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, size=(2, 16, 16, 2)).astype(np.float32)
    return x, g, grid


def _close_dgrid(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("C", [8, 32])
def test_warp_modes_match_pallas_and_xla(C, mode):
    """Plain A-fwd and B in each padding mode and align_corners flag against
    the Pallas `_kernel` and `_t_kernel` (interpret mode) and JAX's XLA
    `grid_sample` and `grid_sample_transpose`."""
    x, g, grid = _mode_inputs(C, 20 + C)
    assert pallas_warp_supported(x.shape, grid.shape)
    xt, gt, grt = map(torch.from_numpy, (x, g, grid))
    out = twarp.grid_sample_plain(xt, grt, *mode).numpy()
    np.testing.assert_allclose(out, np.asarray(grid_sample_pallas(
        jnp.asarray(x), jnp.asarray(grid), *mode, True)), **TOL)
    np.testing.assert_allclose(out, np.asarray(jwarp.grid_sample(
        jnp.asarray(x), jnp.asarray(grid), *mode)), **TOL)
    out_t = twarp.grid_sample_transpose_plain(gt, grt, (16, 16), *mode).numpy()
    np.testing.assert_allclose(out_t, np.asarray(grid_sample_transpose_pallas(
        jnp.asarray(g), jnp.asarray(grid), (16, 16), *mode, True)), **TOL)
    np.testing.assert_allclose(out_t, np.asarray(jwarp.grid_sample_transpose(
        jnp.asarray(g), jnp.asarray(grid), (16, 16), *mode)), **TOL)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("C", [8, 32])
def test_warp_vjps_in_each_mode_match_pallas(C, mode):
    """Plain A-bwd and C with `corner_weights_vjp` in each mode: (dx, dgrid)
    against jax.vjp of `grid_sample_pallas` (its `_bwd_kernel`), (dg, dgrid)
    against `grid_sample_transpose_vjp_pallas` (`_t_vjp_kernel`), both in
    interpret mode, and both dgrids against jax.vjp of XLA's `grid_sample`."""
    x, gy, grid = _mode_inputs(C, 40 + C)
    xt, gyt, grt = map(torch.from_numpy, (x, gy, grid))
    dx, dw = twarp.grid_sample_bwd_plain(xt, gyt, grt, *mode)
    dgrid = twarp.corner_weights_vjp(grt, dw, 16, 16, *mode).numpy()
    _, vjp = jax.vjp(lambda xx, gg: grid_sample_pallas(xx, gg, *mode, True),
                     jnp.asarray(x), jnp.asarray(grid))
    dx_j, dgrid_j = (np.asarray(t) for t in vjp(jnp.asarray(gy)))
    np.testing.assert_allclose(dx.numpy(), dx_j, **TOL)
    _close_dgrid(dgrid, dgrid_j)
    _, vjp_x = jax.vjp(lambda xx, gg: jwarp.grid_sample(xx, gg, *mode),
                       jnp.asarray(x), jnp.asarray(grid))
    _close_dgrid(dgrid, np.asarray(vjp_x(jnp.asarray(gy))[1]))
    assert np.abs(dgrid_j).max() > 1e-3, "dgrid vanished: the check would be vacuous"
    # kernel C: the scatter op's VJP, with xbar = x and the primal g = gy
    dg, dw_c = twarp.grid_sample_t_vjp_plain(xt, gyt, grt, *mode)
    dg_j, dgrid_tj = grid_sample_transpose_vjp_pallas(
        jnp.asarray(gy), jnp.asarray(grid), jnp.asarray(x), *mode, interpret=True)
    np.testing.assert_allclose(dg.numpy(), np.asarray(dg_j), **TOL)
    _close_dgrid(twarp.corner_weights_vjp(grt, dw_c, 16, 16, *mode).numpy(), np.asarray(dgrid_tj))


def test_new_wrappers_route_cpu_tensors_to_the_plain_versions():
    """On a CPU tensor A-fwd's and B's wrappers are their plain versions
    and launch nothing."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 8, 16, 8)).astype(np.float32))
    grid = torch.from_numpy(rng.uniform(-1, 1, size=(2, 8, 16, 2)).astype(np.float32))
    before = dict(_kernels.launches)
    assert torch.equal(twarp.grid_sample(x, grid), twarp.grid_sample_plain(x, grid))
    assert torch.equal(twarp.grid_sample_transpose(x, grid, (8, 16)),
                       twarp.grid_sample_transpose_plain(x, grid, (8, 16)))
    assert dict(_kernels.launches) == before


def _jax_vjp(fn, primals, cotangent):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, primals))
    return out, [np.asarray(g) for g in vjp(jax.tree_util.tree_map(jnp.asarray, cotangent))]


@pytest.mark.parametrize("shape,spike", CASES, ids=IDS)
def test_flow_warps_and_gradients_match_jax(shape, spike):
    """`flow_warp` and `flow_warp_transpose`, values and (dx, dflow), against
    jax.vjp of JAX's flow warps."""
    a, flow, r, _ = _inputs(shape, 1, spike)
    for port_fn, jax_fn in ((twarp.flow_warp, jwarp.flow_warp),
                            (twarp.flow_warp_transpose, jwarp.flow_warp_transpose)):
        out_j, (dx_j, dflow_j) = _jax_vjp(jax_fn, (a, flow), r)
        at = torch.from_numpy(a).requires_grad_()
        ft = torch.from_numpy(flow).requires_grad_()
        out = port_fn(at, ft)
        dx, dflow = torch.autograd.grad(out, (at, ft), torch.from_numpy(r))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **FLOW_TOL)
        np.testing.assert_allclose(dx.numpy(), dx_j, **FLOW_TOL)
        np.testing.assert_allclose(dflow.numpy(), dflow_j, **FLOW_TOL)
        assert np.abs(dflow_j).max() > 1e-3, "dflow vanished: the check would be vacuous"


@pytest.mark.parametrize("shape,spike", CASES, ids=IDS)
def test_unfused_chain_and_gradients_match_jax(shape, spike):
    """The unfused chain's (ew, zaw) and (da, dflow) against JAX's train
    chain on CPU; dflow sums four weight-gradient routes (A-bwd and C, each
    through its own grid's clip)."""
    a, flow, r, s = _inputs(shape, 2, spike)
    (ew_j, zaw_j), (da_j, dflow_j) = _jax_vjp(jwarp.token_softmax_scatter_train,
                                              (a, flow), (r, s))
    at = torch.from_numpy(a).requires_grad_()
    ft = torch.from_numpy(flow).requires_grad_()
    ew, zaw = twarp.token_softmax_scatter(at, ft, train_chain="unfused")
    loss = (ew * torch.from_numpy(r)).sum() + (zaw * torch.from_numpy(s)).sum()
    da, dflow = torch.autograd.grad(loss, (at, ft))
    np.testing.assert_allclose(ew.detach().numpy(), np.asarray(ew_j), **FLOW_TOL)
    np.testing.assert_allclose(zaw.detach().numpy(), np.asarray(zaw_j), **FLOW_TOL)
    np.testing.assert_allclose(da.numpy(), da_j, **FLOW_TOL)
    np.testing.assert_allclose(dflow.numpy(), dflow_j, **FLOW_TOL)
    assert np.abs(dflow_j).max() > 1e-3, "dflow vanished: the check would be vacuous"
    if spike:
        assert np.all(zaw.detach().numpy()[:, 0] == 0.0)
        assert np.isfinite(da.numpy()).all() and np.isfinite(dflow.numpy()).all()


def test_unfused_chain_follows_jax_dtype_flow_in_bf16():
    """In bf16 JAX rounds aw to a's dtype and takes the exp there
    (smow_net_tpu/ops/warp.py:309-312); the port's chain does the same, so
    its eaw equals exp(bf16(aw) - m) computed in bf16."""
    a, flow, _, _ = _inputs((2, 16, 16, 8), 3)
    at = torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
    ft = torch.from_numpy(flow).requires_grad_()
    ew, zaw = twarp.token_softmax_scatter(at, ft, train_chain="unfused")
    assert ew.dtype == zaw.dtype == torch.bfloat16
    with torch.no_grad():
        aw = twarp.flow_warp(at, ft)
        eaw = torch.exp(aw - at.amax(dim=(1, 2), keepdim=True))
        assert torch.equal(zaw, eaw.sum(dim=(1, 2)))
        assert torch.equal(ew, twarp.flow_warp_transpose(eaw, ft))


def test_train_chain_rule_picks_by_shape():
    """With no train_chain the rule is the JAX package's default: the hybrid
    (kernel E's residual Function) at W * C <= 1024, the unfused chain
    above; both give the same function."""
    for shape in ((2, 8, 128, 8), (2, 8, 128, 16)):
        a, flow, _, _ = _inputs(shape, 4)
        at = torch.from_numpy(a).requires_grad_()
        ft = torch.from_numpy(flow).requires_grad_()
        ew, _ = twarp.token_softmax_scatter(at, ft)
        hybrid = ew.grad_fn.name().startswith("_TokenSoftmaxScatter")
        assert hybrid == (shape[2] * shape[3] <= 1024)
        ew_u, _ = twarp.token_softmax_scatter(at, ft, train_chain="unfused")
        ew_h, _ = twarp.token_softmax_scatter(at, ft, train_chain="hybrid")
        np.testing.assert_allclose(ew_u.detach().numpy(), ew_h.detach().numpy(), **TOL)
    with pytest.raises(ValueError):
        twarp.token_softmax_scatter(at, ft, train_chain="bogus")
