"""The gradient of the port's `cross_layer_head1` on CPU (the plain version
under torch autograd, the plain backward of kernel F-bwd) against jax.vjp of
JAX's `cross_layer_head1_auto` routed to the Pallas layer kernel, whose
backward is `_layer_bwd_kernel`, in interpret mode.

Shapes: N = 512 pixels, h = 8 heads, M = 8 tokens, and D = 128, hidden 256
(SMOW_Net's decoder) or D = 64, hidden 128 (SMOW_Net_LW's, which JAX runs
packed two rows to a lane), with and without the lane permutation; all 14
input gradients. Bound, per
gradient: 2e-5 relative plus 2e-5 of the gradient's largest element, in
fp32. The Pallas kernel folds the LayerNorm affines into the projections
(its gradients come back through the folds) and sums its weight gradients
over 1024 rows in another order, which changes only the rounding; the
forward test (tests/test_torch_xattn.py) holds the outputs to 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.ops import xattn as jx
from smow_net_tpu.ops.pallas import xattn as px
from smow_net_tpu_torch.ops import xattn as tx
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

B, N, D, H_, M_, HID = 2, 512, 128, 8, 8, 256
NAMES = ("x", "ln1_scale", "ln1_bias", "wq", "k", "v", "w_out", "b_out",
         "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")


@pytest.fixture
def pallas_layer():
    """Force the Pallas layer kernel (interpret mode) with tiles that fit
    N = 512, then restore the previous routing and tiles."""
    tiles = (px._TILE_L, px._TILE_L_BWD)
    px.set_xlayer_tiles(fwd=256, bwd=256)
    jx.set_xattn_impl("pallas", interpret=True)
    # else cross_layer_head1_auto falls back to XLA and the test would
    # compare against plain autodiff instead of the Pallas backward
    assert px.xlayer_supported(N, D, H_, M_, HID)
    yield
    px.set_xlayer_tiles(fwd=tiles[0], bwd=tiles[1])
    jx.set_xattn_impl("auto")


def _inputs(seed, D=D, HID=HID):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0, off=0.0: (rng.normal(size=s) * scale + off).astype(np.float32)
    args = [f(B, N, D), f(D, scale=0.2, off=1.0), f(D, scale=0.1),
            f(D, H_, scale=0.1), f(B, M_, H_), f(B, M_, H_),
            f(H_, D, scale=0.1), f(D, scale=0.1), f(D, scale=0.2, off=1.0),
            f(D, scale=0.1), f(D, HID, scale=D ** -0.5), f(HID, scale=0.1),
            f(HID, D, scale=HID ** -0.5), f(D, scale=0.1)]
    return args, f(B, N, D)


def _perm(D=D):
    """The decoder's t-major -> c-major fold, P[t*C + c, c*T + t] = 1."""
    T, C = 4, D // 4
    t_idx, c_idx = np.divmod(np.arange(D), C)
    p = np.zeros((D, D), np.float32)
    p[np.arange(D), c_idx * T + t_idx] = 1.0
    return p


def _check_gradients_against_pallas(use_perm, D, HID):
    assert px.xlayer_supported(N, D, H_, M_, HID)
    args, gy = _inputs(1, D, HID)
    perm = _perm(D) if use_perm else None
    scale = D ** -0.5
    jperm = None if perm is None else jnp.asarray(perm)
    _, vjp = jax.vjp(lambda *a: jx.cross_layer_head1_auto(*a, scale=scale, perm=jperm),
                     *map(jnp.asarray, args))
    want = [np.asarray(g) for g in vjp(jnp.asarray(gy))]
    targs = [torch.from_numpy(a).requires_grad_() for a in args]
    tperm = None if perm is None else torch.from_numpy(perm)
    out = tx.cross_layer_head1(*targs, scale=scale, perm=tperm)
    got = torch.autograd.grad(out, targs, torch.from_numpy(gy))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("use_perm", [False, True], ids=["no_perm", "perm"])
def test_cross_layer_head1_gradients_match_pallas(pallas_layer, use_perm):
    _check_gradients_against_pallas(use_perm, D, HID)


@pytest.mark.parametrize("use_perm", [False, True], ids=["no_perm", "perm"])
def test_cross_layer_head1_gradients_match_pallas_d64(pallas_layer, use_perm):
    """SMOW_Net_LW's decoder layer, D = 64, hidden 128."""
    _check_gradients_against_pallas(use_perm, 64, 128)
