"""The port's plain warps on grids with NaN coordinates against the JAX
package's XLA warps (smow_net_tpu/ops/warp.py `grid_sample` and
`grid_sample_transpose`, called directly, and jax.vjp of each), on the CPU.

This is the contract the warp kernels are held to on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py phase 3f): a NaN
coordinate makes NaN lerp weights, its corners are rows and columns 0 and 1
(XLA converts a NaN floor to index 0), so the sample at that pixel is NaN
and a scatter puts NaN into cells (0, 0), (0, 1), (1, 0) and (1, 1). Under
border padding the clamp passes no gradient to a NaN coordinate's axis;
under zeros padding it passes dw1 - dw0 of the corners at index 0 and 1.

Cases: a NaN x, a NaN y, or both, at an interior pixel of the first image
and at the last pixel of the second; both padding modes and both
align_corners flags; C = 8 on a 2 x 8 x 8 image, numpy-seeded. Comparison:
the NaN masks equal, the finite elements to 1e-6 of the largest finite one
(fp32 on both sides, summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.ops import warp as jwarp
from smow_net_tpu_torch.ops import warp as twarp
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

B, H, W, C = 2, 8, 8, 8
NAN_AT = ((0, 3, 4), (1, H - 1, W - 1))      # an interior pixel, the last pixel
AXES = {"x": [0], "y": [1], "xy": [0, 1]}


def _inputs(axes, seed=0):
    """x (B, H, W, C), a grid reaching beyond [-1, 1] with NaN on `axes` at
    NAN_AT, and a pixel-side tensor g (B, H, W, C)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    grid = rng.uniform(-1.1, 1.1, size=(B, H, W, 2)).astype(np.float32)
    for at in NAN_AT:
        grid[at + (AXES[axes],)] = np.nan
    g = rng.normal(size=(B, H, W, C)).astype(np.float32)
    return x, grid, g


def _port(fn, x, grid, g, mode):
    """The port's plain function's outputs as numpy arrays (dgrid from the
    weight-gradient rows where it returns them)."""
    tx, tgrid, tg = map(torch.from_numpy, (x, grid, g))
    if fn == "grid_sample":
        return [twarp.grid_sample_plain(tx, tgrid, *mode)]
    if fn == "grid_sample_transpose":
        return [twarp.grid_sample_transpose_plain(tg, tgrid, (H, W), *mode)]
    if fn == "grid_sample_bwd":
        dx, dw = twarp.grid_sample_bwd_plain(tx, tg, tgrid, *mode)
    else:
        dx, dw = twarp.grid_sample_t_vjp_plain(tx, tg, tgrid, *mode)
    return [dx, twarp.corner_weights_vjp(tgrid, dw, H, W, *mode)]


def _jax(fn, x, grid, g, mode):
    """The same outputs from the JAX package's XLA functions."""
    x, grid, g = map(jnp.asarray, (x, grid, g))
    if fn == "grid_sample":
        return [jwarp.grid_sample(x, grid, *mode)]
    if fn == "grid_sample_transpose":
        return [jwarp.grid_sample_transpose(g, grid, (H, W), *mode)]
    if fn == "grid_sample_bwd":          # the VJP of grid_sample against g
        _, vjp = jax.vjp(lambda a, gr: jwarp.grid_sample(a, gr, *mode), x, grid)
        return list(vjp(g))
    _, vjp = jax.vjp(lambda a, gr: jwarp.grid_sample_transpose(a, gr, (H, W), *mode), g, grid)
    return list(vjp(x))                  # the VJP of the transpose against x


@pytest.mark.parametrize("axes", list(AXES), ids=[f"nan_{a}" for a in AXES])
@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("fn", ["grid_sample", "grid_sample_transpose", "grid_sample_bwd",
                                "grid_sample_t_vjp"])
def test_plain_warps_match_xla_on_nan_grids(fn, padding_mode, axes):
    x, grid, g = _inputs(axes)
    for align in (True, False):
        mode = (padding_mode, align)
        for got, want in zip(_port(fn, x, grid, g, mode), _jax(fn, x, grid, g, mode)):
            got, want = np.asarray(got), np.asarray(want)
            assert got.shape == want.shape
            nan = np.isnan(want)
            np.testing.assert_array_equal(np.isnan(got), nan)
            assert nan.any()
            scale = np.abs(want[~nan]).max()
            np.testing.assert_allclose(got[~nan], want[~nan], rtol=0, atol=1e-6 * scale)
