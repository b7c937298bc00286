"""The port's plain `cross_layer_head1` (smow_net_tpu_torch/ops/xattn.py, the
plain version of kernel F) against JAX's `cross_layer_head1_auto` routed to
the Pallas layer kernel in interpret mode on CPU.

Shapes: N = 512 pixels, h = 8 heads, M = 8 tokens, and D = 128, hidden 256
(SMOW_Net's decoder) or D = 64, hidden 128 (SMOW_Net_LW's, which JAX runs
packed two rows to a lane), with and without the lane permutation. Tolerance 2e-5 (rtol and atol) in
fp32, the bound tests/test_xattn.py holds the same kernel to: the Pallas
kernel folds the LayerNorm affine into the projections and shares the
softmax max across heads, which changes only the rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.ops import xattn as jx
from smow_net_tpu.ops.pallas import xattn as px
from smow_net_tpu_torch.ops import xattn as tx

B, N, D, H_, M_, HID = 2, 512, 128, 8, 8, 256
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture
def pallas_layer():
    """Force the Pallas layer kernel (interpret mode) with tiles that fit
    N = 512, then restore the previous routing and tiles."""
    tiles = (px._TILE_L, px._TILE_L_BWD)
    px.set_xlayer_tiles(fwd=256, bwd=256)
    jx.set_xattn_impl("pallas", interpret=True)
    assert px.xlayer_supported(N, D, H_, M_, HID)
    yield
    px.set_xlayer_tiles(fwd=tiles[0], bwd=tiles[1])
    jx.set_xattn_impl("auto")


def _inputs(seed, D=D, HID=HID):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, off=0.0: (rng.normal(size=s) * scale + off).astype(np.float32)
    return [f(B, N, D), f(D, scale=0.2, off=1.0), f(D, scale=0.1),
            f(D, H_, scale=0.1), f(B, M_, H_), f(B, M_, H_),
            f(H_, D, scale=0.1), f(D, scale=0.1), f(D, scale=0.2, off=1.0),
            f(D, scale=0.1), f(D, HID, scale=D ** -0.5), f(HID, scale=0.1),
            f(HID, D, scale=HID ** -0.5), f(D, scale=0.1)]


def _perm(D=D):
    """The decoder's t-major -> c-major fold, P[t*C + c, c*T + t] = 1."""
    T, C = 4, D // 4
    t_idx, c_idx = np.divmod(np.arange(D), C)
    p = np.zeros((D, D), np.float32)
    p[np.arange(D), c_idx * T + t_idx] = 1.0
    return p


def _check_plain_against_pallas(use_perm, D, HID):
    assert px.xlayer_supported(N, D, H_, M_, HID)
    args = _inputs(0, D, HID)
    perm = _perm(D) if use_perm else None
    scale = D ** -0.5
    ref = jx.cross_layer_head1_auto(*map(jnp.asarray, args), scale=scale,
                                    perm=None if perm is None else jnp.asarray(perm))
    tperm = None if perm is None else torch.from_numpy(perm)
    out = tx.cross_layer_head1_plain(*map(torch.from_numpy, args), scale=scale, perm=tperm)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    # on a CPU tensor the routed op is the plain version
    routed = tx.cross_layer_head1(*map(torch.from_numpy, args), scale=scale, perm=tperm)
    assert torch.equal(routed, out)


@pytest.mark.parametrize("use_perm", [False, True], ids=["no_perm", "perm"])
def test_cross_layer_head1_plain_matches_pallas(pallas_layer, use_perm):
    _check_plain_against_pallas(use_perm, D, HID)


@pytest.mark.parametrize("use_perm", [False, True], ids=["no_perm", "perm"])
def test_cross_layer_head1_plain_matches_pallas_d64(pallas_layer, use_perm):
    """SMOW_Net_LW's decoder layer, D = 64, hidden 128."""
    _check_plain_against_pallas(use_perm, 64, 128)


def test_perm_is_an_index_gather():
    perm = torch.from_numpy(_perm())
    x = torch.randn(3, 5, D, generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(x[..., tx._perm_index(perm)].numpy(), (x @ perm).numpy())
