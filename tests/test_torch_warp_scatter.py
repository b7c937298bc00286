"""The plain versions of kernels B and A-bwd (smow_net_tpu_torch/ops/warp.py
`grid_sample_transpose_plain`, `grid_sample_bwd_plain`) against the JAX
package on CPU, at the inputs the card tests hold the kernels to
(tests/test_torch_kernels_cuda.py `test_tile_scatter_kernels_match_plain`):
B = 3 grids of 37 x 45 pixels, no multiple of any of the kernels' tiles,
into a 48 x 50 image, on a smooth flow (each tile's corners in a small
box) and on a grid whose corners cover the whole image. The card tests
trust the plain versions; these tests are what that trust rests on.

- B's plain version against JAX's XLA adjoint (`grid_sample_transpose`,
  a VJP of its gather) at those inputs, and against the Pallas `_t_kernel`
  (`grid_sample_transpose_pallas`, interpret mode) on a 24 x 48 grid into a
  16 x 32 image, the nearest shape it takes (Hg Wg a multiple of 128, W a
  power of two, H a multiple of 8).
- A-bwd's plain version, dx and the weight rows carried to dgrid by
  `corner_weights_vjp`, against jax.vjp of JAX's `grid_sample`.

Each in every (padding_mode, align_corners) pair at C = 8, and at C = 16
and 32 in the OFW recipe (border, align_corners). Tolerance 1e-5, as
tests/test_torch_warp_unfused.py: both sides lerp in fp32 and differ in
summation order; dgrid to 1e-5 of its largest element (d/di = dw1 - dw0
cancels)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.ops import warp as jwarp
from smow_net_tpu.ops.pallas.warp import grid_sample_transpose_pallas, pallas_warp_supported
from smow_net_tpu_torch.ops import warp as twarp
from test_torch_kernels_cuda import MODES, scatter_grid
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

TOL = dict(rtol=1e-5, atol=1e-5)
B, HG, WG, H, W = 3, 37, 45, 48, 50          # the card tests' shape

CASES = ([(m, k, 8) for m in MODES for k in ("smooth", "far")]
         + [(MODES[0], k, c) for c in (16, 32) for k in ("smooth", "far")])
IDS = [f"{m[0]}_{'align' if m[1] else 'half'}_{k}_C{c}" for m, k, c in CASES]


def _inputs(kind, C, Hg=HG, Wg=WG, h=H, w=W, batch=B):
    """The card test's grid (same seed) and numpy-seeded x (batch, h, w, C)
    and g (batch, Hg, Wg, C), fp32."""
    grid = scatter_grid(kind, batch, Hg, Wg, 50 + C)
    rng = np.random.default_rng(60 + C)
    x = rng.normal(size=(batch, h, w, C)).astype(np.float32)
    g = rng.normal(size=(batch, Hg, Wg, C)).astype(np.float32)
    return x, g, grid


@pytest.mark.parametrize("mode,kind,C", CASES, ids=IDS)
def test_grid_sample_transpose_plain_matches_jax(mode, kind, C):
    """Plain kernel B at the card tests' inputs against JAX's XLA adjoint;
    on the nearest shape the Pallas `_t_kernel` takes, against it too."""
    _, g, grid = _inputs(kind, C)
    out = twarp.grid_sample_transpose_plain(torch.from_numpy(g), torch.from_numpy(grid),
                                            (H, W), *mode).numpy()
    ref = jwarp.grid_sample_transpose(jnp.asarray(g), jnp.asarray(grid), (H, W), *mode)
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)

    x, g, grid = _inputs(kind, C, Hg=24, Wg=48, h=16, w=32, batch=2)
    assert pallas_warp_supported(x.shape, grid.shape)
    out = twarp.grid_sample_transpose_plain(torch.from_numpy(g), torch.from_numpy(grid),
                                            (16, 32), *mode).numpy()
    ref_p = grid_sample_transpose_pallas(jnp.asarray(g), jnp.asarray(grid), (16, 32), *mode,
                                         interpret=True)
    ref_x = jwarp.grid_sample_transpose(jnp.asarray(g), jnp.asarray(grid), (16, 32), *mode)
    np.testing.assert_allclose(out, np.asarray(ref_p), **TOL)
    np.testing.assert_allclose(out, np.asarray(ref_x), **TOL)


@pytest.mark.parametrize("mode,kind,C", CASES, ids=IDS)
def test_grid_sample_bwd_plain_matches_jax_vjp(mode, kind, C):
    """Plain kernel A-bwd at the card tests' inputs: dx, and dgrid from its
    weight rows through `corner_weights_vjp`, against jax.vjp of JAX's
    `grid_sample` (XLA) with the same cotangent."""
    x, gy, grid = _inputs(kind, C)
    dx, dw = twarp.grid_sample_bwd_plain(torch.from_numpy(x), torch.from_numpy(gy),
                                         torch.from_numpy(grid), *mode)
    dgrid = twarp.corner_weights_vjp(torch.from_numpy(grid), dw, H, W, *mode).numpy()
    _, vjp = jax.vjp(lambda xx, gg: jwarp.grid_sample(xx, gg, *mode),
                     jnp.asarray(x), jnp.asarray(grid))
    dx_j, dgrid_j = (np.asarray(t) for t in vjp(jnp.asarray(gy)))
    np.testing.assert_allclose(dx.numpy(), dx_j, **TOL)
    np.testing.assert_allclose(dgrid, dgrid_j, rtol=1e-5, atol=1e-5 * np.abs(dgrid_j).max())
    assert np.abs(dgrid_j).max() > 1e-3, "dgrid vanished: the check would be vacuous"
