"""The port's hand-written CUDA kernels (D, E, D-bwd, C, A-fwd, A-bwd, B
in every padding mode and align_corners flag, A-fwd and A-bwd also at C =
64, the tile scatter of B, A-bwd,
D, E and D-bwd on grids that take its sorted path and its direct one, F and
F-bwd, the layer at D = 128 and 64; the selective scan's I-fwd, I-ckpt and
I-bwd, over the grouped layout (I, K = 4 and 8) and the flat one (H),
seeded, at any number of rows, a K = 8 train step in deterministic mode, the forward sweep on misaligned rows; H-seg's carry and
adjoint carry (ragged, misaligned, bf16, bitwise alike twice); the general
scan's J; G, the layer's attention sublayer, at D = 64, 128 and 512, and
G-bwd at every built width, their bf16 tensor-core bodies bitwise alike
twice, and both in fp32 on a logit spread against float64) against their
plain versions, on the card. Marked
`cuda`; each test skips when no CUDA device is present (there is no
interpret mode for a CUDA kernel). On a GPU machine without JAX,
skip tests/conftest.py (it configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Bounds as chip_smoke.py states them: fp32 kernels differ from the fp32
plain versions only in summation order; bf16 kernels compute in fp32 (F's
and F-bwd's MLP products and G-bwd's products on the tensor cores with each
fp32 activation operand split into bf16 hi + lo, to about 2^-17 of the
product) and round
once, so they are held to one bf16 rounding (2^-8 relative) of the fp32
plain result on the same inputs. F, F-bwd and G's and G-bwd's bf16 bodies
also wrap their persistent grids, run bitwise alike twice, spill nothing and
hold tensor-core instructions."""

import numpy as np
import pytest
import torch

from smow_net_tpu_torch.ops import _kernels, scan, warp, xattn

pytestmark = pytest.mark.cuda

BF16_REL = 2.0 ** -8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _close(got, want, atol, rtol):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert err <= atol + rtol * want.abs().max().item(), err


def _close_nan(got, want, atol, rtol):
    """NaN at the same elements, the finite ones as `_close` holds them."""
    got, want = got.float(), want.float()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    _close(got[~nan], want[~nan], atol, rtol)


def _token_flow(rng, kind, F_, H, W):
    """A flow field (F, H, W, 2) in pixels: "iid", normal with std 3, or
    "smooth", an 8x8 field of std 3 upsampled (each tile's corners within a
    box the tile scatter sorts), or "far", uniform over twice the image's
    size each way (the grid clamps it to the borders: every tile's box spans
    the whole image, wider than the sorted window at H x W > 2048, so the
    direct vector reductions run)."""
    if kind == "iid":
        return rng.normal(size=(F_, H, W, 2)) * 3
    if kind == "smooth":
        return smooth_field(rng, F_, H, W, 3.0)
    return rng.uniform(-2.0, 2.0, size=(F_, H, W, 2)) * np.array([W, H])


def _assert_branch(grid, C, kind):
    """Every tile of the grid takes the branch its flow kind is made for."""
    H, W = grid.shape[1:3]
    n_sorted, n_direct = warp.tile_scatter_branches(grid, H, W, C)
    assert (n_sorted if kind == "far" else n_direct) == 0, (n_sorted, n_direct)


@pytest.mark.parametrize("kind", ["iid", "far"])
@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_token_scatter_kernel_matches_plain(dev, C, dtype, kind):
    """Kernel D, whose blocks gather a tile of grid pixels and scatter it
    through the tile scatter: on an i.i.d. flow at (4, 24, 64) (the sorted
    branch) and a far-scattered one at (4, 48, 64) (the direct branch)."""
    rng = np.random.default_rng(C)
    shape = (4, 24, 64) if kind == "iid" else (4, 48, 64)
    a = torch.from_numpy(rng.normal(size=shape + (C,)).astype(np.float32)).to(dev, dtype)
    flow = torch.from_numpy(_token_flow(rng, kind, *shape).astype(np.float32)).to(dev)
    grid = warp.flow_grid(flow, *shape[1:])
    _assert_branch(grid, C, kind)
    m = a.amax(dim=(1, 2)).float()
    before = _kernels.launches["token_scatter_fwd"]
    ew, zaw = warp.token_scatter(a, grid, m)
    torch.cuda.synchronize()
    assert _kernels.launches["token_scatter_fwd"] == before + 1
    ew_p, zaw_p = warp.token_scatter_plain(a.float(), grid, m)
    rtol = 1e-5 if dtype == torch.float32 else BF16_REL
    _close(ew, ew_p, 1e-5, rtol)
    _close(zaw, zaw_p, 1e-5, rtol)


def _layer_inputs(dev, rng, D, B=2, N=1000):
    """The decoder layer's 14 inputs at width D (h = 8, M = 8, hidden 2D) and
    a cotangent; N = 1000 leaves a ragged tail of the kernels' 16- and
    64-row tiles."""
    h, M, hid = 8, 8, 2 * D

    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    return [f(B, N, D), f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, h, scale=0.1),
            f(B, M, h), f(B, M, h), f(h, D, scale=0.1), f(D, scale=0.1),
            f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, hid, scale=D ** -0.5),
            f(hid, scale=0.1), f(hid, D, scale=hid ** -0.5), f(D, scale=0.1)], f(B, N, D)


def _random_perm(dev, rng, D):
    perm = torch.zeros(D, D, device=dev)
    perm[torch.arange(D), torch.from_numpy(rng.permutation(D)).to(dev)] = 1.0
    return perm


@pytest.mark.parametrize("use_perm", [False, True], ids=["no_perm", "perm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_xattn_layer_kernel_matches_plain_d64(dev, use_perm, dtype):
    """Kernel F at SMOW_Net_LW's width, D = 64, hidden 128."""
    rng = np.random.default_rng(3)
    args, _ = _layer_inputs(dev, rng, 64)
    args = [a.to(dtype) for a in args]
    perm = _random_perm(dev, rng, 64) if use_perm else None
    before = _kernels.launches["xattn_layer_fwd"]
    out = xattn.cross_layer_head1(*args, scale=64 ** -0.5, perm=perm)
    torch.cuda.synchronize()
    assert _kernels.launches["xattn_layer_fwd"] == before + 1
    want = xattn.cross_layer_head1_plain(*[a.float() for a in args], scale=64 ** -0.5,
                                         perm=perm)
    _close(out, want, 1e-4, 1e-5 if dtype == torch.float32 else BF16_REL)


@pytest.mark.parametrize("use_perm", [False, True], ids=["no_perm", "perm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_xattn_layer_bwd_kernel_matches_plain_d64(dev, use_perm, dtype):
    """Kernel F-bwd at D = 64: the 14 input gradients, bounds as at D = 128."""
    rng = np.random.default_rng(4)
    args, gy = _layer_inputs(dev, rng, 64)
    args = [a.to(dtype).requires_grad_() for a in args]
    perm = _random_perm(dev, rng, 64) if use_perm else None
    before = _kernels.launches["xattn_layer_bwd"]
    out = xattn.cross_layer_head1(*args, scale=64 ** -0.5, perm=perm)
    got = torch.autograd.grad(out, args, gy.to(dtype))
    torch.cuda.synchronize()
    assert _kernels.launches["xattn_layer_bwd"] == before + 1
    ref = [a.detach().float().requires_grad_() for a in args]
    want = torch.autograd.grad(
        xattn.cross_layer_head1_plain(*ref, scale=64 ** -0.5, perm=perm), ref,
        gy.to(dtype).float())
    for g, w, a in zip(got, want, args):
        assert g.dtype == a.dtype and g.shape == a.shape
        _close(g, w, 1e-5, 1e-4 if dtype == torch.float32 else BF16_REL)


@pytest.mark.parametrize("use_perm", [False, True], ids=["no_perm", "perm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_xattn_layer_kernel_matches_plain(dev, use_perm, dtype):
    rng = np.random.default_rng(1)
    D, h, M, hid, B, N = 128, 8, 8, 256, 2, 1000       # N: a ragged tail

    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    args = [f(B, N, D), f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, h, scale=0.1),
            f(B, M, h), f(B, M, h), f(h, D, scale=0.1), f(D, scale=0.1),
            f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, hid, scale=D ** -0.5),
            f(hid, scale=0.1), f(hid, D, scale=hid ** -0.5), f(D, scale=0.1)]
    args = [a.to(dtype) for a in args]
    perm = None
    if use_perm:
        perm = torch.zeros(D, D, device=dev)
        perm[torch.arange(D), torch.from_numpy(rng.permutation(D)).to(dev)] = 1.0
    before = _kernels.launches["xattn_layer_fwd"]
    out = xattn.cross_layer_head1(*args, scale=D ** -0.5, perm=perm)
    torch.cuda.synchronize()
    assert _kernels.launches["xattn_layer_fwd"] == before + 1
    want = xattn.cross_layer_head1_plain(*[a.float() for a in args], scale=D ** -0.5,
                                         perm=perm)
    _close(out, want, 1e-4, 1e-5 if dtype == torch.float32 else BF16_REL)


def _token_inputs(dev, C, dtype, seed, shape=(4, 24, 64), kind="iid"):
    rng = np.random.default_rng(seed)
    F_, H, W = shape
    a = torch.from_numpy(rng.normal(size=(F_, H, W, C)).astype(np.float32)).to(dev, dtype)
    flow = torch.from_numpy(_token_flow(rng, kind, F_, H, W).astype(np.float32)).to(dev)
    other = torch.from_numpy(rng.normal(size=(F_, H, W, C)).astype(np.float32)).to(dev, dtype)
    return a, warp.flow_grid(flow, H, W), other


@pytest.mark.parametrize("kind", ["iid", "far"])
@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_token_scatter_residual_kernel_matches_plain(dev, C, dtype, kind):
    """Kernel E: kernel D plus the eaw residual in a's dtype, on the flows
    of `test_token_scatter_kernel_matches_plain`."""
    shape = (4, 24, 64) if kind == "iid" else (4, 48, 64)
    a, grid, _ = _token_inputs(dev, C, dtype, 10 + C, shape, kind)
    _assert_branch(grid, C, kind)
    m = a.amax(dim=(1, 2)).float()
    before = _kernels.launches["token_scatter_fwd_eaw"]
    got = warp.token_scatter(a, grid, m, residual=True)
    torch.cuda.synchronize()
    assert _kernels.launches["token_scatter_fwd_eaw"] == before + 1
    assert got[2].dtype == dtype
    rtol = 1e-5 if dtype == torch.float32 else BF16_REL
    for g, w in zip(got, warp.token_scatter_plain(a.float(), grid, m, residual=True)):
        _close(g, w, 1e-5, rtol)


@pytest.mark.parametrize("op", ["t_vjp", "bwd"])
@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_warp_backward_kernels_match_plain(dev, op, C, dtype):
    """Kernel C (`grid_sample_t_vjp`) and kernel A-bwd (`grid_sample_bwd`):
    the tensor output is held to one rounding of its dtype, the fp32
    weight-gradient rows to 1e-5 relative (fp32 arithmetic on the same
    inputs, another summation order)."""
    a, grid, other = _token_inputs(dev, C, dtype, 20 + C)
    name = "grid_sample_t_vjp" if op == "t_vjp" else "grid_sample_bwd"
    kernel, plain = getattr(warp, name), getattr(warp, name + "_plain")
    before = _kernels.launches[name]
    out, dw = kernel(a, other, grid)
    torch.cuda.synchronize()
    assert _kernels.launches[name] == before + 1
    out_p, dw_p = plain(a.float(), other.float(), grid)
    _close(out, out_p, 1e-5, 1e-5 if dtype == torch.float32 else BF16_REL)
    _close(dw, dw_p, 1e-5, 1e-5)


def test_token_softmax_scatter_gradient_kernel_path_matches_plain(dev):
    """The token chain's whole VJP (da, dflow), fp32: kernels E, C, A-bwd
    against the same Function with the plain ops (another summation order
    in the atomics: 1e-4 of the largest element)."""
    rng = np.random.default_rng(5)
    a0 = rng.normal(size=(4, 32, 64, 8)).astype(np.float32)
    flow0 = (rng.normal(size=(4, 32, 64, 2)) * 3).astype(np.float32)
    r = torch.from_numpy(rng.normal(size=(4, 32, 64, 8)).astype(np.float32)).to(dev)
    s = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)).to(dev)

    def grads():
        a = torch.from_numpy(a0).to(dev).requires_grad_()
        flow = torch.from_numpy(flow0).to(dev).requires_grad_()
        ew, zaw = warp.token_softmax_scatter(a, flow)
        return torch.autograd.grad((ew * r).sum() + (zaw * s).sum(), (a, flow))

    names = ("token_scatter_fwd_eaw", "grid_sample_t_vjp", "grid_sample_bwd")
    before = {n: _kernels.launches[n] for n in names}
    got = grads()
    torch.cuda.synchronize()
    assert all(_kernels.launches[n] == before[n] + 1 for n in names)
    saved = warp.token_scatter, warp.grid_sample_t_vjp, warp.grid_sample_bwd
    warp.token_scatter, warp.grid_sample_t_vjp, warp.grid_sample_bwd = (
        warp.token_scatter_plain, warp.grid_sample_t_vjp_plain, warp.grid_sample_bwd_plain)
    try:
        want = grads()
    finally:
        warp.token_scatter, warp.grid_sample_t_vjp, warp.grid_sample_bwd = saved
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-4)


@pytest.mark.parametrize("kind", ["iid", "smooth", "far"])
@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_token_scatter_bwd_kernel_matches_plain(dev, C, dtype, kind):
    """Kernel D-bwd, whose blocks scatter daw through the tile scatter: da
    to one rounding of its dtype, the fp32 summed weight-gradient rows to
    1e-4 relative (two gathers' sums added), at (4, 48, 64) on an i.i.d.
    and a smooth flow (the sorted branch) and a far one (the direct
    branch)."""
    a, grid, ew_bar = _token_inputs(dev, C, dtype, 50 + C, (4, 48, 64), kind)
    _assert_branch(grid, C, kind)
    m = a.amax(dim=(1, 2)).float()
    dz = torch.from_numpy(np.random.default_rng(C).normal(size=(4, C)).astype(np.float32)).to(dev)
    before = _kernels.launches["token_scatter_bwd"]
    da, dw = warp.token_scatter_bwd(a, grid, m, ew_bar, dz)
    torch.cuda.synchronize()
    assert _kernels.launches["token_scatter_bwd"] == before + 1 and da.dtype == dtype
    da_p, dw_p = warp.token_scatter_bwd_plain(a.float(), grid, m, ew_bar.float(), dz)
    _close(da, da_p, 1e-5, 1e-5 if dtype == torch.float32 else BF16_REL)
    _close(dw, dw_p, 1e-5, 1e-4)


def test_fused_token_chain_gradient_kernel_path_matches_plain(dev):
    """The fused chain's whole VJP (da, dflow), fp32: kernels D and D-bwd
    against the same Function with the plain ops (1e-4 of the largest
    element, as the hybrid's test)."""
    rng = np.random.default_rng(7)
    a0 = rng.normal(size=(4, 32, 64, 8)).astype(np.float32)
    flow0 = (rng.normal(size=(4, 32, 64, 2)) * 3).astype(np.float32)
    r = torch.from_numpy(rng.normal(size=(4, 32, 64, 8)).astype(np.float32)).to(dev)
    s = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)).to(dev)

    def grads():
        a = torch.from_numpy(a0).to(dev).requires_grad_()
        flow = torch.from_numpy(flow0).to(dev).requires_grad_()
        ew, zaw = warp.token_softmax_scatter(a, flow, train_chain="fused")
        return torch.autograd.grad((ew * r).sum() + (zaw * s).sum(), (a, flow))

    names = ("token_scatter_fwd", "token_scatter_bwd")
    before = {n: _kernels.launches[n] for n in names}
    got = grads()
    torch.cuda.synchronize()
    assert all(_kernels.launches[n] == before[n] + 1 for n in names)
    saved = warp.token_scatter, warp.token_scatter_bwd
    warp.token_scatter, warp.token_scatter_bwd = (warp.token_scatter_plain,
                                                  warp.token_scatter_bwd_plain)
    try:
        want = grads()
    finally:
        warp.token_scatter, warp.token_scatter_bwd = saved
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-4)


MODES = [("border", True), ("border", False), ("zeros", True), ("zeros", False)]


@pytest.mark.parametrize("mode", MODES, ids=["border_align", "border_half", "zeros_align",
                                             "zeros_half"])
@pytest.mark.parametrize("C", [8, 32])
def test_warp_kernels_in_each_mode_match_plain(dev, C, mode):
    """A-fwd, B, C and A-bwd in each (padding_mode, align_corners) pair, fp32,
    on a grid reaching beyond [-1, 1]: outputs to 1e-5, the weight-gradient
    rows to 1e-4 (another summation order), and dgrid from them."""
    g = torch.Generator(dev).manual_seed(C)
    x = torch.randn(2, 24, 64, C, device=dev, generator=g)
    other = torch.randn(2, 24, 64, C, device=dev, generator=g)
    grid = torch.rand(2, 24, 64, 2, device=dev, generator=g) * 2.4 - 1.2
    size = (24, 64)
    pairs = (("grid_sample_fwd", warp.grid_sample(x, grid, *mode),
              warp.grid_sample_plain(x, grid, *mode)),
             ("grid_sample_transpose", warp.grid_sample_transpose(other, grid, size, *mode),
              warp.grid_sample_transpose_plain(other, grid, size, *mode)),
             ("grid_sample_t_vjp", warp.grid_sample_t_vjp(x, other, grid, *mode),
              warp.grid_sample_t_vjp_plain(x, other, grid, *mode)),
             ("grid_sample_bwd", warp.grid_sample_bwd(x, other, grid, *mode),
              warp.grid_sample_bwd_plain(x, other, grid, *mode)))
    torch.cuda.synchronize()
    for name, got, want in pairs:
        if isinstance(got, tuple):
            _close(got[0], want[0], 1e-5, 1e-5)
            _close(got[1], want[1], 1e-5, 1e-4)
            _close(warp.corner_weights_vjp(grid, got[1], *size, *mode),
                   warp.corner_weights_vjp(grid, want[1], *size, *mode), 1e-5, 1e-4)
        else:
            _close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("use_perm", [False, True], ids=["no_perm", "perm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_xattn_layer_bwd_kernel_matches_plain(dev, use_perm, dtype):
    """Kernel F-bwd: the 14 input gradients against torch.autograd.grad of
    the plain version in fp32 on the same inputs. fp32: the row sums run in
    another order, 1e-4 of each gradient's largest element; bf16: the
    kernel computes in fp32 and rounds once, one bf16 rounding (2^-8)."""
    rng = np.random.default_rng(2)
    D, h, M, hid, B, N = 128, 8, 8, 256, 2, 1000       # N: a ragged tail

    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    args = [f(B, N, D), f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, h, scale=0.1),
            f(B, M, h), f(B, M, h), f(h, D, scale=0.1), f(D, scale=0.1),
            f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, hid, scale=D ** -0.5),
            f(hid, scale=0.1), f(hid, D, scale=hid ** -0.5), f(D, scale=0.1)]
    gy = f(B, N, D)
    args = [a.to(dtype).requires_grad_() for a in args]
    perm = None
    if use_perm:
        perm = torch.zeros(D, D, device=dev)
        perm[torch.arange(D), torch.from_numpy(rng.permutation(D)).to(dev)] = 1.0
    before = _kernels.launches["xattn_layer_bwd"]
    out = xattn.cross_layer_head1(*args, scale=D ** -0.5, perm=perm)
    got = torch.autograd.grad(out, args, gy.to(dtype))
    torch.cuda.synchronize()
    assert _kernels.launches["xattn_layer_bwd"] == before + 1
    ref = [a.detach().float().requires_grad_() for a in args]
    want = torch.autograd.grad(
        xattn.cross_layer_head1_plain(*ref, scale=D ** -0.5, perm=perm), ref,
        gy.to(dtype).float())
    for g, w, a in zip(got, want, args):
        assert g.dtype == a.dtype and g.shape == a.shape
        _close(g, w, 1e-5, 1e-4 if dtype == torch.float32 else BF16_REL)


_LAYER_NAMES = ("x", "ln1_scale", "ln1_bias", "wq", "k", "v", "w_out", "b_out",
                "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")


def _layer_run(args, gy, D):
    """Kernel F's output and F-bwd's 14 gradients (one launch each)."""
    args = [a.detach().requires_grad_() for a in args]
    out = xattn.cross_layer_head1(*args, scale=D ** -0.5)
    return out, torch.autograd.grad(out, args, gy)


@pytest.mark.parametrize("D", [128, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_xattn_layer_kernels_wrap_their_persistent_grid(dev, D, dtype):
    """F and F-bwd at (4, 16384, D), more tiles than one wave of blocks takes
    (F's bf16 warps walk 16-row tiles, F-bwd's blocks or clusters 64-row
    ones), against the plain version in fp32, at the bounds above."""
    rng = np.random.default_rng(12)
    args, gy = _layer_inputs(dev, rng, D, B=4, N=16384)
    args, gy = [a.to(dtype) for a in args], gy.to(dtype)
    ctas, _ = xattn.layer_grid(D, dtype, True, dev)
    assert 4 * 16384 // 64 > ctas
    if dtype == torch.bfloat16:
        assert 4 * 16384 // 16 > 8 * xattn.layer_grid(D, dtype, False, dev)[0]
    out, got = _layer_run(args, gy, D)
    ref = [a.float().requires_grad_() for a in args]
    want = xattn.cross_layer_head1_plain(*ref, scale=D ** -0.5)
    rtol = 1e-5 if dtype == torch.float32 else BF16_REL
    _close(out, want, 1e-4, rtol)
    rtol = 1e-4 if dtype == torch.float32 else BF16_REL
    for g, w in zip(got, torch.autograd.grad(want, ref, gy.float())):
        _close(g, w, 1e-5, rtol)


@pytest.mark.parametrize("D", [128, 64])
def test_xattn_layer_bf16_kernels_are_deterministic(dev, D):
    """bf16 F's output, and every F-bwd gradient but dk and dv (added across
    blocks with atomicAdd), bitwise equal in two runs at (4, 16384, D)."""
    rng = np.random.default_rng(13)
    args, gy = _layer_inputs(dev, rng, D, B=4, N=16384)
    args, gy = [a.to(torch.bfloat16) for a in args], gy.to(torch.bfloat16)
    first, second = _layer_run(args, gy, D), _layer_run(args, gy, D)
    assert torch.equal(first[0], second[0])
    for name, a, b in zip(_LAYER_NAMES, first[1], second[1]):
        if name not in ("k", "v"):
            assert torch.equal(a, b), name


def _layer_ptxas(sources=("xattn_layer.cu", "xattn_layer_bwd.cu")):
    """ptxas's lines (function, registers, spill bytes) for the sources (F's
    and F-bwd's by default), compiled as the build compiles them."""
    import subprocess
    import tempfile

    lines = {}
    with tempfile.TemporaryDirectory() as work:
        for src in sources:
            proc = subprocess.run(
                [_kernels._nvcc(), "-gencode", _kernels.GENCODE, "-std=c++17", "-O3", "-c",
                 "-Xptxas", "-v", "-I", str(_kernels.CSRC), "-o", f"{work}/{src}.o",
                 str(_kernels.CSRC / src)], capture_output=True, text=True, check=True)
            current = ""
            for line in (proc.stdout + proc.stderr).splitlines():
                if "Compiling entry function" in line or "Function properties for" in line:
                    current = line.split("'")[1] if "'" in line else line.split()[-1]
                elif current:
                    lines.setdefault(current, []).append(line)
    return lines


def test_xattn_layer_bf16_build_fits_its_design(dev):
    """The bf16 instantiations of F and F-bwd spill nothing, and one wave
    holds one block of 8 warps on every SM (F) or on the SMs that clusters
    of 2D / 64 blocks can take (F-bwd)."""
    lines = _layer_ptxas()
    tc = {name: text for name, text in lines.items()
          if "layer_fwd_tc" in name or "layer_bwd_tc" in name}
    assert len(tc) == 4, sorted(lines)
    for name, text in tc.items():
        joined = " ".join(text)
        assert "0 bytes spill stores" in joined and "0 bytes spill loads" in joined, (name, joined)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for D in (128, 64):
        ctas, smem = xattn.layer_grid(D, torch.bfloat16, False, dev)
        assert ctas == sms and 0 < smem <= 232448, (D, ctas, smem)
        ctas, smem = xattn.layer_grid(D, torch.bfloat16, True, dev)
        C = 2 * D // 64
        assert ctas % C == 0 and sms // 2 < ctas <= sms and 0 < smem <= 232448, (D, ctas, smem)


def _hmma_counts():
    """Tensor-core instructions (HMMA or HGMMA) per function in `cuobjdump
    -sass` of the built library, or None without cuobjdump."""
    import shutil
    import subprocess
    from pathlib import Path

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(_kernels.build())], capture_output=True,
                          text=True, check=True).stdout
    counts, current = {}, ""
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :")[1].strip()
        elif "HMMA" in line or "HGMMA" in line:
            counts[current] = counts.get(current, 0) + 1
    return counts


def test_xattn_layer_bf16_kernels_run_on_tensor_cores(dev):
    """The machine code of F's and F-bwd's bf16 kernels holds tensor-core
    instructions (HMMA or HGMMA in `cuobjdump -sass` of the built library)."""
    counts = _hmma_counts()
    if counts is None:
        pytest.skip("needs cuobjdump (the CUDA toolkit)")
    for kernel in ("layer_fwd_tcILi128", "layer_fwd_tcILi64", "layer_bwd_tcILi128",
                   "layer_bwd_tcILi64"):
        assert any(kernel in name and n > 0 for name, n in counts.items()), (kernel, counts)


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_grid_sample_kernels_match_plain(dev, C, dtype):
    """Kernels A-fwd (`grid_sample`) and B (`grid_sample_transpose`) on free
    and border-clamped flows: one rounding of the dtype of the fp32 plain
    result on the same inputs."""
    rtol = 1e-5 if dtype == torch.float32 else BF16_REL
    for clamp in (False, True):
        a, grid, other = _token_inputs(dev, C, dtype, 40 + C)
        if clamp:
            grid = grid.clone()
            grid[..., 0] = 1.0
        for name, fn, plain, x, size in (
                ("grid_sample_fwd", warp.grid_sample, warp.grid_sample_plain, a, ()),
                ("grid_sample_transpose", warp.grid_sample_transpose,
                 warp.grid_sample_transpose_plain, other, ((24, 64),))):
            before = _kernels.launches[name]
            out = fn(x, grid, *size)
            torch.cuda.synchronize()
            assert _kernels.launches[name] == before + 1 and out.dtype == dtype
            _close(out, plain(x.float(), grid, *size), 1e-5, rtol)


def smooth_field(rng, B, H, W, std, n=8):
    """A (B, n, n, 2) normal field of `std`, bilinearly upsampled to (B, H,
    W, 2) with the corners aligned."""
    field = rng.normal(size=(B, n, n, 2)) * std

    def lerp_axis(f, size, axis):
        pos = np.linspace(0.0, n - 1.0, size)
        i0 = np.minimum(np.floor(pos).astype(int), n - 2)
        t = (pos - i0).reshape([-1 if a == axis else 1 for a in range(4)])
        return np.take(f, i0, axis) * (1 - t) + np.take(f, i0 + 1, axis) * t

    return lerp_axis(lerp_axis(field, H, 1), W, 2)


def scatter_grid(kind, B, Hg, Wg, seed):
    """A (B, Hg, Wg, 2) fp32 grid for the tile scatter of kernels B and
    A-bwd. "smooth": the identity plus a smooth flow (an 8x8 field of std 3
    in flow units, /(W, H), as `flow_grid` scales it): each tile's corners
    stay in a small box. "far": uniform in [-1.2, 1.2]: every tile's
    corners cover the whole image. "clamped": the smooth grid with x = 1,
    so a tile row's pixels all hit one column (the most corners in one
    cell). "nan": the smooth grid with a NaN at the last pixel, whose
    corners at (0, 0) stretch its tile's box over the image."""
    rng = np.random.default_rng(seed)
    if kind == "far":
        return rng.uniform(-1.2, 1.2, size=(B, Hg, Wg, 2)).astype(np.float32)
    base = np.stack(np.meshgrid(np.linspace(-1, 1, Wg), np.linspace(-1, 1, Hg)), -1)
    grid = base[None] + smooth_field(rng, B, Hg, Wg, 3.0) / np.array([Wg, Hg])
    if kind == "clamped":
        grid[..., 0] = 1.0
    if kind == "nan":
        grid[-1, -1, -1] = np.nan
    return grid.astype(np.float32)


# (mode, kind): every grid kind in each (padding_mode, align_corners) pair
SCATTER_CASES = [(m, k) for m in MODES for k in ("smooth", "far", "clamped", "nan")]


@pytest.mark.parametrize("mode,kind", SCATTER_CASES,
                         ids=[f"{m[0]}_{'align' if m[1] else 'half'}_{k}"
                              for m, k in SCATTER_CASES])
@pytest.mark.parametrize("C", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_tile_scatter_kernels_match_plain(dev, mode, kind, C, dtype):
    """Kernels B (`grid_sample_transpose`) and A-bwd (`grid_sample_bwd`),
    whose blocks sort a tile of grid pixels' corners by the cells of their
    box in shared memory or, when the box has 2048 cells or more, add them
    straight to device memory, on B = 3 grids of 37 x 45 pixels (no
    multiple of any tile) into a 48 x 50 image: the outputs to 1e-5 of the
    largest element in fp32 and to one bf16 rounding in bf16, A-bwd's fp32
    weight rows to 1e-5.

    The "smooth" and "clamped" grids take the sorted path, "far" the direct
    one (the whole image's 2400 cells), "nan" both in one launch. On the
    NaN grid both sides are held on the same grid (the contract of
    tests/test_torch_warp_nan.py: NaN weights, corners at rows and columns
    0 and 1), NaN at the same elements."""
    B, Hg, Wg, H, W = 3, 37, 45, 48, 50
    grid = torch.from_numpy(scatter_grid(kind, B, Hg, Wg, 50 + C)).to(dev)
    rng = np.random.default_rng(60 + C)
    x = torch.from_numpy(rng.normal(size=(B, H, W, C)).astype(np.float32)).to(dev, dtype)
    g = torch.from_numpy(rng.normal(size=(B, Hg, Wg, C)).astype(np.float32)).to(dev, dtype)
    rtol = 1e-5 if dtype == torch.float32 else BF16_REL
    before = {n: _kernels.launches[n] for n in ("grid_sample_transpose", "grid_sample_bwd")}
    out = warp.grid_sample_transpose(g, grid, (H, W), *mode)
    dx, dw = warp.grid_sample_bwd(x, g, grid, *mode)
    torch.cuda.synchronize()
    assert all(_kernels.launches[n] == c + 1 for n, c in before.items())
    assert out.dtype == dx.dtype == dtype and out.shape == dx.shape == x.shape
    _close_nan(out, warp.grid_sample_transpose_plain(g.float(), grid, (H, W), *mode), 0.0, rtol)
    dx_p, dw_p = warp.grid_sample_bwd_plain(x.float(), g.float(), grid, *mode)
    _close_nan(dx, dx_p, 0.0, rtol)
    _close_nan(dw, dw_p, 0.0, 1e-5)
    assert (kind == "nan") == bool(torch.isnan(out).any())


def _with_nans(grid):
    """A copy of `grid` (B >= 2, Hg >= 4, Wg >= 5) with a NaN x, a NaN y and
    both NaN at interior pixels, and both NaN at the last pixel."""
    grid = grid.clone()
    grid[0, 1, 2, 0] = float("nan")
    grid[0, 2, 3, 1] = float("nan")
    grid[1, 3, 4] = float("nan")
    grid[-1, -1, -1] = float("nan")
    return grid


@pytest.mark.parametrize("mode", MODES, ids=["border_align", "border_half", "zeros_align",
                                             "zeros_half"])
@pytest.mark.parametrize("C", [8, 32])
def test_warp_kernels_on_a_nan_grid_match_plain(dev, C, mode):
    """A-fwd, B, C and A-bwd in each (padding_mode, align_corners) pair on
    one grid with NaN coordinates, against their plain versions on the same
    grid, fp32: NaN at the same elements of every output, the weight rows
    and dgrid; the finite elements at the tolerances of
    `test_warp_kernels_in_each_mode_match_plain`."""
    g = torch.Generator(dev).manual_seed(70 + C)
    x = torch.randn(2, 24, 64, C, device=dev, generator=g)
    other = torch.randn(2, 24, 64, C, device=dev, generator=g)
    grid = _with_nans(torch.rand(2, 24, 64, 2, device=dev, generator=g) * 2.4 - 1.2)
    size = (24, 64)
    pairs = ((warp.grid_sample(x, grid, *mode), warp.grid_sample_plain(x, grid, *mode)),
             (warp.grid_sample_transpose(other, grid, size, *mode),
              warp.grid_sample_transpose_plain(other, grid, size, *mode)),
             (warp.grid_sample_t_vjp(x, other, grid, *mode),
              warp.grid_sample_t_vjp_plain(x, other, grid, *mode)),
             (warp.grid_sample_bwd(x, other, grid, *mode),
              warp.grid_sample_bwd_plain(x, other, grid, *mode)))
    torch.cuda.synchronize()
    for got, want in pairs:
        if isinstance(got, tuple):
            _close_nan(got[0], want[0], 1e-5, 1e-5)
            _close_nan(got[1], want[1], 1e-5, 1e-4)
            _close_nan(warp.corner_weights_vjp(grid, got[1], *size, *mode),
                       warp.corner_weights_vjp(grid, want[1], *size, *mode), 1e-5, 1e-4)
        else:
            _close_nan(got, want, 1e-5, 1e-5)
            assert bool(torch.isnan(got).any())


@pytest.mark.parametrize("mode", MODES, ids=["border_align", "border_half", "zeros_align",
                                             "zeros_half"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_warp_kernels_at_c64_match_plain(dev, dtype, mode):
    """A-fwd and A-bwd at C = 64 (PA-Former's width; built for A only) in
    each mode against their plain versions, on a grid reaching past the
    image with NaN coordinates (NaN at the same elements), counted as
    `grid_sample_{fwd,bwd}_c64`; fp32 at the tolerances of the other
    widths, bf16 to one rounding of the plain result on the same inputs."""
    g = torch.Generator(dev).manual_seed(64)
    x = torch.randn(2, 24, 64, 64, device=dev, generator=g).to(dtype)
    gy = torch.randn(2, 24, 64, 64, device=dev, generator=g).to(dtype)
    grid = _with_nans(torch.rand(2, 24, 64, 2, device=dev, generator=g) * 2.4 - 1.2)
    before = {n: _kernels.launches[n] for n in ("grid_sample_fwd_c64", "grid_sample_bwd_c64")}
    out = warp.grid_sample(x, grid, *mode)
    dx, dw = warp.grid_sample_bwd(x, gy, grid, *mode)
    torch.cuda.synchronize()
    assert {n: _kernels.launches[n] - k for n, k in before.items()} == {
        "grid_sample_fwd_c64": 1, "grid_sample_bwd_c64": 1}
    rtol = 1e-5 if dtype == torch.float32 else BF16_REL
    dx_p, dw_p = warp.grid_sample_bwd_plain(x.float(), gy.float(), grid, *mode)
    _close_nan(out, warp.grid_sample_plain(x.float(), grid, *mode), 1e-5, rtol)
    _close_nan(dx, dx_p, 1e-5, rtol)
    _close_nan(dw, dw_p, 1e-5, 1e-4)
    _close_nan(warp.corner_weights_vjp(grid, dw, 24, 64, *mode),
               warp.corner_weights_vjp(grid, dw_p, 24, 64, *mode), 1e-5, 1e-4)


def test_warp_wrappers_raise_at_unbuilt_widths(dev):
    """C = 64 is built for A-fwd and A-bwd only; C = 40 for none."""
    grid = torch.zeros(2, 8, 8, 2, device=dev)
    for C in (40, 64):
        x = torch.zeros(2, 8, 8, C, device=dev)
        with pytest.raises(ValueError):
            warp.grid_sample_transpose(x, grid, (8, 8))
        with pytest.raises(ValueError):
            warp.grid_sample_t_vjp(x, x, grid)
    x = torch.zeros(2, 8, 8, 40, device=dev)
    with pytest.raises(ValueError):
        warp.grid_sample(x, grid)
    with pytest.raises(ValueError):
        warp.grid_sample_bwd(x, x, grid)


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_token_kernels_on_a_nan_grid_match_plain(dev, C, dtype):
    """D, E and D-bwd (border padding, align_corners) on a flow grid with
    NaN coordinates against their plain versions on the same grid: NaN at
    the same elements, the finite ones as the token kernels' tests hold
    them. At (4, 48, 64) the tile of the last pixel, whose NaN corners lie
    at the image's origin, takes the tile scatter's direct branch, the
    others the sorted one."""
    a, grid, ew_bar = _token_inputs(dev, C, dtype, 80 + C, (4, 48, 64))
    grid = _with_nans(grid)
    n_sorted, n_direct = warp.tile_scatter_branches(grid, 48, 64, C)
    assert n_sorted > 0 and n_direct > 0, (n_sorted, n_direct)
    m = a.amax(dim=(1, 2)).float()
    dz = torch.from_numpy(np.random.default_rng(C).normal(size=(4, C)).astype(np.float32)).to(dev)
    names = ("token_scatter_fwd", "token_scatter_fwd_eaw", "token_scatter_bwd")
    before = {n: _kernels.launches[n] for n in names}
    got = (warp.token_scatter(a, grid, m), warp.token_scatter(a, grid, m, residual=True),
           warp.token_scatter_bwd(a, grid, m, ew_bar, dz))
    torch.cuda.synchronize()
    assert all(_kernels.launches[n] == c + 1 for n, c in before.items())
    want = (warp.token_scatter_plain(a.float(), grid, m),
            warp.token_scatter_plain(a.float(), grid, m, residual=True),
            warp.token_scatter_bwd_plain(a.float(), grid, m, ew_bar.float(), dz))
    rtol = 1e-5 if dtype == torch.float32 else BF16_REL
    for outs, refs in zip(got[:2], want[:2]):
        for g, w in zip(outs, refs):
            _close_nan(g, w, 1e-5, rtol)
    _close_nan(got[2][0], want[2][0], 1e-5, rtol)
    _close_nan(got[2][1], want[2][1], 1e-5, 1e-4)
    assert all(bool(torch.isnan(t).any()) for t in got[0] + got[1] + got[2])


def test_unfused_token_chain_gradient_kernel_path_matches_plain(dev):
    """The unfused chain's whole VJP (da, dflow), fp32: kernels A-fwd, B, C,
    A-bwd against the same chain on the plain ops (1e-4 of the largest
    element, as the hybrid's test)."""
    rng = np.random.default_rng(6)
    a0 = rng.normal(size=(4, 32, 64, 8)).astype(np.float32)
    flow0 = (rng.normal(size=(4, 32, 64, 2)) * 3).astype(np.float32)
    r = torch.from_numpy(rng.normal(size=(4, 32, 64, 8)).astype(np.float32)).to(dev)
    s = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32)).to(dev)

    def grads():
        a = torch.from_numpy(a0).to(dev).requires_grad_()
        flow = torch.from_numpy(flow0).to(dev).requires_grad_()
        ew, zaw = warp.token_softmax_scatter(a, flow, train_chain="unfused")
        return torch.autograd.grad((ew * r).sum() + (zaw * s).sum(), (a, flow))

    names = ("grid_sample_fwd", "grid_sample_transpose", "grid_sample_t_vjp",
             "grid_sample_bwd")
    before = {n: _kernels.launches[n] for n in names}
    got = grads()
    torch.cuda.synchronize()
    assert all(_kernels.launches[n] == before[n] + 1 for n in names)
    ops = ("grid_sample", "grid_sample_transpose", "grid_sample_t_vjp", "grid_sample_bwd")
    saved = [getattr(warp, n) for n in ops]
    for n in ops:
        setattr(warp, n, getattr(warp, n + "_plain"))
    try:
        want = grads()
    finally:
        for n, fn in zip(ops, saved):
            setattr(warp, n, fn)
    for g, w in zip(got, want):
        _close(g, w, 1e-5, 1e-4)


def test_wrappers_raise_on_shapes_the_kernels_do_not_take(dev):
    a = torch.zeros(2, 8, 8, 4, device=dev)             # C = 4: no kernel built
    grid = torch.zeros(2, 8, 8, 2, device=dev)
    with pytest.raises(ValueError):
        warp.token_scatter(a, grid, torch.zeros(2, 4, device=dev))
    with pytest.raises(ValueError):
        warp.grid_sample(a, grid)
    with pytest.raises(ValueError):
        warp.grid_sample_transpose(a, grid, (8, 8))
    with pytest.raises(ValueError):                    # grid in bf16
        warp.grid_sample(torch.zeros(2, 8, 8, 8, device=dev), grid.bfloat16())
    args, _ = _layer_inputs(dev, np.random.default_rng(0), 96, N=64)
    with pytest.raises(ValueError):                    # D = 96: no kernel built
        xattn.cross_layer_head1(*args, scale=96 ** -0.5)


def _scan_inputs(dev, shape, seed):
    """Kernel I's seven inputs, numpy-seeded: xs, dts (B, K, L, Dk), A
    (K*Dk, 16) = -exp(.), Bs, Cs (B, K, L, 16), Ds, dt_bias (K*Dk)."""
    B, K, L, Dk = shape
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    return [f(B, K, L, Dk), f(B, K, L, Dk, scale=0.5), -torch.exp(f(K * Dk, 16, scale=0.5)),
            f(B, K, L, 16), f(B, K, L, 16), f(K * Dk, scale=0.5, off=1.0),
            f(K * Dk, scale=0.5, off=-3.0)]


# Dk = 40 leaves an idle tail of the 32-channel blocks; L = 100 a ragged
# last 16-step chunk
@pytest.mark.parametrize("shape", [(2, 4, 256, 64), (1, 4, 100, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_scan_fwd_kernel_matches_plain(dev, shape, dtype):
    args = _scan_inputs(dev, shape, 20)
    args = [a.to(dtype) if i in (0, 1, 3, 4) else a for i, a in enumerate(args)]
    before = _kernels.launches["selective_scan_fwd"]
    y = scan.cross_selective_scan(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["selective_scan_fwd"] == before + 1 and y.dtype == dtype
    want = scan.cross_selective_scan_plain(*[a.float() for a in args])
    _close(y, want, 1e-6, 1e-5 if dtype == torch.float32 else BF16_REL)


# Dk = 40 and 8 leave an idle tail of I-bwd's 32-channel blocks; L = 100 a
# ragged last chunk
@pytest.mark.parametrize("shape", [(2, 4, 256, 64), (1, 4, 100, 40), (1, 4, 100, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_scan_bwd_kernels_match_autograd_of_plain(dev, shape, dtype):
    """I-ckpt + I-bwd + the epilogue: all seven input gradients (fp32: 1e-4
    of each largest element; bf16: against the plain version in fp32 on the
    same bf16 values, one rounding of the cast)."""
    args = _scan_inputs(dev, shape, 21)
    args = [(a.to(dtype) if i in (0, 1, 3, 4) else a).requires_grad_()
            for i, a in enumerate(args)]
    gy = torch.from_numpy(np.random.default_rng(22).normal(size=shape).astype(np.float32)).to(
        dev, dtype)
    before = {n: _kernels.launches[n] for n in ("selective_scan_ckpt", "selective_scan_bwd")}
    got = torch.autograd.grad(scan.cross_selective_scan(*args), args, gy)
    torch.cuda.synchronize()
    assert all(_kernels.launches[n] == c + 1 for n, c in before.items())
    ref = [a.detach().float().requires_grad_() for a in args]
    want = torch.autograd.grad(scan.cross_selective_scan_plain(*ref), ref, gy.float())
    for g, w, a in zip(got, want, args):
        assert g.dtype == a.dtype
        _close(g, w, 1e-6, 1e-4 if dtype == torch.float32 else BF16_REL)


# K = 8: RS-Mamba's eight directions, twice the rows of a K = 4 call at the
# same batch; Dk = 40 and L = 100 as above
@pytest.mark.parametrize("shape", [(2, 8, 256, 64), (1, 8, 100, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_scan_kernels_at_k8_match_plain(dev, shape, dtype):
    """I-fwd, and I-ckpt + I-bwd + the epilogue, at K = 8 against the plain
    version (bounds as the K = 4 tests)."""
    args = _scan_inputs(dev, shape, 23)
    args = [(a.to(dtype) if i in (0, 1, 3, 4) else a).requires_grad_()
            for i, a in enumerate(args)]
    gy = torch.from_numpy(np.random.default_rng(24).normal(size=shape).astype(np.float32)).to(
        dev, dtype)
    before = {n: _kernels.launches[n] for n in ("selective_scan_fwd", "selective_scan_ckpt",
                                                "selective_scan_bwd")}
    y = scan.cross_selective_scan(*args)
    got = torch.autograd.grad(y, args, gy)
    torch.cuda.synchronize()
    assert all(_kernels.launches[n] == c + 1 for n, c in before.items())
    ref = [a.detach().float().requires_grad_() for a in args]
    want_y = scan.cross_selective_scan_plain(*ref)
    want = torch.autograd.grad(want_y, ref, gy.float())
    _close(y, want_y, 1e-6, 1e-5 if dtype == torch.float32 else BF16_REL)
    for g, w, a in zip(got, want, args):
        assert g.dtype == a.dtype
        _close(g, w, 1e-6, 1e-4 if dtype == torch.float32 else BF16_REL)


def test_cross_scan8_train_step_runs_in_deterministic_mode(dev, monkeypatch):
    """A train step of a VSSBlock at K = 8 (cross_scan8's gathers, whose
    backward gathers by the inverse permutation; kernel I; AdamW) under
    torch.use_deterministic_algorithms: it raises nothing, and two runs
    from one seed give the same bits."""
    from smow_net_tpu_torch.nn.ssm import VSSBlock

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for _ in range(2):
            torch.manual_seed(25)
            block = VSSBlock(32, k_group=8).to(dev)
            opt = torch.optim.AdamW(block.parameters(), lr=1e-3)
            x = torch.randn(2, 16, 12, 32, device=dev,
                            generator=torch.Generator(dev).manual_seed(26))
            before = _kernels.launches["selective_scan_bwd"]
            block(x).square().mean().backward()
            opt.step()
            assert _kernels.launches["selective_scan_bwd"] == before + 1
            runs.append([p.detach().clone() for p in block.parameters()])
    finally:
        torch.use_deterministic_algorithms(prev)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def _no_softplus(args):
    """The scan's inputs for a call without the softplus: dt = softplus(dts
    + bias) taken here (dt >= 0, as the callers of such a call give it; a
    negative dt makes exp(dt A) > 1 and the state grow without bound) and a
    zero bias."""
    args = list(args)
    bias = args[6].reshape(args[1].shape[1], 1, -1) if args[1].dim() == 4 else args[6]
    args[1] = scan.softplus(args[1].float() + bias).to(args[1].dtype)
    args[6] = torch.zeros_like(args[6])
    return args


def test_scan_kernels_always_take_the_softplus(dev):
    """Kernel I is built for SS2D's dt = softplus(dts + bias); a CUDA call
    without the softplus launches no kernel I and goes to the general route
    (kernel J), which computes that other function: against the plain
    version, y and the seven gradients, fp32."""
    args = [a.requires_grad_() for a in _no_softplus(_scan_inputs(dev, (1, 4, 32, 16), 23))]
    gy = torch.randn(1, 4, 32, 16, device=dev, generator=torch.Generator(dev).manual_seed(24))
    before = dict(_kernels.launches)
    y = scan.cross_selective_scan(*args, delta_softplus=False)
    got = torch.autograd.grad(y, args, gy)
    torch.cuda.synchronize()
    runs = {n: c - before.get(n, 0) for n, c in _kernels.launches.items() if c != before.get(n, 0)}
    assert runs == {"scan_states": 3}
    want_y = scan.cross_selective_scan_plain(*args, delta_softplus=False)
    want = torch.autograd.grad(want_y, args, gy)
    _close(y, want_y, 1e-6, 1e-5)
    for g, w in zip(got, want):
        _close(g, w, 1e-6, 1e-4)


def _flat_inputs(dev, B, L, G, Cg, seed, dtype=torch.float32):
    """The flat contract's seven inputs (kernel H's), numpy-seeded: u, delta
    (B, L, G*Cg), A (G*Cg, 16) = -exp(.), Bmat, Cmat (B, L, G, 16), D,
    delta_bias (G*Cg); u, delta, Bmat, Cmat in `dtype`."""
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    Dch = G * Cg
    return [f(B, L, Dch).to(dtype), f(B, L, Dch, scale=0.5).to(dtype),
            -torch.exp(f(Dch, 16, scale=0.5)), f(B, L, G, 16).to(dtype),
            f(B, L, G, 16).to(dtype), f(Dch, scale=0.5, off=1.0), f(Dch, scale=0.5, off=-3.0)]


FLAT = ("selective_scan_fwd_flat", "selective_scan_ckpt_flat", "selective_scan_bwd_flat")
SEG = ("selective_scan_carry", "selective_scan_adjcarry")


# Cg = 40 and 8 leave an idle tail of the sweeps' 32-channel blocks; L =
# 100 a ragged last 16-step chunk; (16, 16384, 2, 64) is one of CD-Mamba's
# shapes, which the shipped route (`seg_count`) cuts into 16 segments per
# row
@pytest.mark.parametrize("B,L,G,Cg", [(2, 256, 2, 32), (2, 100, 1, 40), (2, 100, 2, 8),
                                      (16, 16384, 2, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_flat_scan_kernels_match_plain(dev, B, L, G, Cg, dtype):
    """Kernel H: I's three sweeps reading the flat layout in place, the
    forward and all seven input gradients (bf16: one rounding of the
    forward; the gradients of the plain version in fp32 on the same bf16
    values, to 1e-4 and one rounding of the cast); on a segmented route
    the carry runs in the forward and the backward, the adjcarry in the
    backward."""
    args = [a.requires_grad_() for a in _flat_inputs(dev, B, L, G, Cg, 30, dtype)]
    gy = torch.randn(args[0].shape, device=dev, generator=torch.Generator(dev).manual_seed(31))
    before = {n: _kernels.launches[n] for n in FLAT + SEG}
    y = scan.selective_scan(*args, delta_softplus=True)
    got = torch.autograd.grad(y, args, gy.to(dtype))
    torch.cuda.synchronize()
    assert y.dtype == dtype
    segmented = scan.seg_count(B * G, L, Cg) > 1
    assert segmented == (L == 16384)
    runs = {n: _kernels.launches[n] - c for n, c in before.items()}
    assert runs == {**dict.fromkeys(FLAT, 1), "selective_scan_carry": 2 * segmented,
                    "selective_scan_adjcarry": int(segmented)}
    ref = [a.detach().float().requires_grad_() for a in args]
    want_y = scan.selective_scan_plain(*ref, delta_softplus=True)
    want = torch.autograd.grad(want_y, ref, gy.to(dtype).float())
    fp32 = dtype == torch.float32
    _close(y, want_y, 1e-6, 1e-5 if fp32 else BF16_REL)
    for g, w in zip(got, want):
        _close(g, w, 1e-6, 1e-4 if fp32 else BF16_REL)


# "even": 4 segments of 64 steps; "ragged": 4 of 50 (a 2-step last chunk,
# the first the adjoint carry walks); "misaligned": 4 of 50 with u, delta,
# B, C and dy one element past a 16-byte boundary. Cg = 40 leaves an idle
# tail of a 32-channel block in each.
@pytest.mark.parametrize("case", ["even", "ragged", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("flat", [True, False], ids=["flat", "grouped"])
def test_seg_carry_and_adjcarry_kernels_match_plain(dev, flat, dtype, case):
    """H-seg's carry (final state and dt sum of each segment row from zero)
    and adjoint carry (the adjoint at each segment row's first step from
    zero), both modes of the forward sweep, against their plain versions on
    the same values in fp32: the fp32 outputs to 1e-5 of their largest
    element, in both dtypes."""
    L = 256 if case == "even" else 200
    args = _flat_inputs(dev, 2, L, 2, 40, 32, dtype)
    if not flat:                        # the same values in the grouped layout
        args = [args[0].reshape(2, L, 2, 40).transpose(1, 2).contiguous(),
                args[1].reshape(2, L, 2, 40).transpose(1, 2).contiguous(), args[2],
                args[3].transpose(1, 2).contiguous(), args[4].transpose(1, 2).contiguous(),
                args[5], args[6]]
    gy = torch.randn(args[0].shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(33)).to(dtype)
    if case == "misaligned":
        args = [_misaligned(t) if i in (0, 1, 3, 4) else t for i, t in enumerate(args)]
        gy = _misaligned(gy)
        assert args[0].data_ptr() % 16 != 0 and gy.data_ptr() % 16 != 0
    a = scan._Args(*args, flat=flat)
    before = {n: _kernels.launches[n] for n in SEG}
    hend, csum = scan.scan_carry(a, 4)
    gloc = scan.scan_adjcarry(a, gy, 4)
    torch.cuda.synchronize()
    assert all(_kernels.launches[n] == c + 1 for n, c in before.items())
    ref = _as_fp32(a)
    hend_p, csum_p = scan.scan_carry_plain(ref, 4)
    _close(hend, hend_p, 1e-6, 1e-5)
    _close(csum, csum_p, 1e-6, 1e-5)
    _close(gloc, scan.scan_adjcarry_plain(ref, gy.float(), 4), 1e-6, 1e-5)


def _seeded_args(dev, flat, dtype, Cg, L, seed):
    """A scan of 2 x 2 rows of L steps and Cg channels in the flat or the
    grouped layout, u, delta, B and C in `dtype`, as `scan._Args`."""
    args = _flat_inputs(dev, 2, L, 2, Cg, seed, dtype)
    if not flat:                        # the same values in the grouped layout
        args = [args[0].reshape(2, L, 2, Cg).transpose(1, 2),
                args[1].reshape(2, L, 2, Cg).transpose(1, 2), args[2],
                args[3].transpose(1, 2), args[4].transpose(1, 2), args[5], args[6]]
    return scan._Args(*args, flat=flat)


@pytest.mark.parametrize("Cg", [40, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("flat", [True, False], ids=["flat", "grouped"])
def test_seeded_sweeps_match_plain(dev, flat, dtype, Cg):
    """I-fwd, I-ckpt and I-bwd seeded with a state h0, an adjoint g0 and a
    decay a0 per segment row, on 4 segment rows of 100 steps (a ragged last
    chunk) in either layout, against the plain seeded scan and its autograd
    on the same values in fp32 (y: 1e-5, or one rounding in bf16; the
    sweeps' fp32 outputs: 1e-4)."""
    a = _seeded_args(dev, flat, dtype, Cg, 400, 34)
    g = torch.Generator(dev).manual_seed(35)
    h0, g0 = (torch.randn(a.rows * 4, 16, Cg, device=dev, generator=g) for _ in range(2))
    a0 = torch.rand(a.rows * 4, 16, Cg, device=dev, generator=g)
    gy = torch.randn(a.u.shape, device=dev, generator=g).to(dtype)
    y = scan._scan_fwd(a, 4, h0)
    sweeps = scan._scan_bwd(a, gy, scan._scan_ckpt(a, 4, h0), 4, g0, a0)
    torch.cuda.synchronize()
    _close(y, scan.scan_fwd_plain(a, 4, h0).float(), 1e-6,
           1e-5 if dtype == torch.float32 else BF16_REL)
    for got, want in zip(sweeps, scan.scan_bwd_plain(a, gy, 4, h0, g0, a0)):
        _close(got, want, 1e-6, 1e-4)


def _misaligned(t):
    """A contiguous copy of t whose first element lies one element past a
    16-byte boundary: the kernels must take it by element loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _fwd_sweeps_match_plain(a, ref, S, h0):
    """I-fwd (y), I-ckpt (the chunk-start states) and the carry (each
    segment row's last state and dt sum, from zero) of `scan_fwd_kernel` on
    a's S segment rows, seeded with h0 where the wrapper takes it, each one
    launch, against their plain versions on ref (a's values in fp32): y to
    1e-5 of its largest element in fp32 or one bf16 rounding, the fp32
    states and sums to 1e-5."""
    labels = (a.label("selective_scan_fwd"), a.label("selective_scan_ckpt"),
              "selective_scan_carry")
    before = {n: _kernels.launches[n] for n in labels}
    y = scan._scan_fwd(a, S, h0)
    hck = scan._scan_ckpt(a, S, h0)
    hend, csum = scan.scan_carry(a, S)
    torch.cuda.synchronize()
    assert all(_kernels.launches[n] == c + 1 for n, c in before.items())
    assert y.dtype == a.u.dtype and y.shape == a.u.shape
    _close(y, scan.scan_fwd_plain(ref, S, h0), 1e-6,
           1e-5 if a.u.dtype == torch.float32 else BF16_REL)
    _close(hck, scan.scan_ckpt_plain(ref, S, h0), 1e-6, 1e-5)
    hend_p, csum_p = scan.scan_carry_plain(ref, S)
    _close(hend, hend_p, 1e-6, 1e-5)
    _close(csum, csum_p, 1e-6, 1e-5)


def _as_fp32(a):
    """`scan._Args` of a's values in fp32 (the plain versions' operands)."""
    A = a.A.transpose(1, 2).reshape(-1, 16)
    return scan._Args(a.u.float(), a.dt.float(), A, a.Bm.float(), a.Cm.float(), a.D, a.bias,
                      flat=a.flat)


# L = 1 and 15: one ragged chunk; 100: a ragged last chunk (25-step
# segments); Cg = 8, 40 and 200: an idle tail of a 32-channel block
@pytest.mark.parametrize("L,Cg", [(L, Cg) for L in (1, 15, 100, 4096) for Cg in (8, 40, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("flat", [True, False], ids=["flat", "grouped"])
def test_fwd_sweep_modes_match_plain(dev, flat, dtype, L, Cg):
    """The forward sweep's three modes on 2 x 2 rows of L steps, 4 segments
    a row where L allows (else 1), seeded with a state per segment row."""
    a = _seeded_args(dev, flat, dtype, Cg, L, 50)
    S = 4 if L % 4 == 0 else 1
    h0 = torch.randn(a.rows * S, 16, Cg, device=dev, generator=torch.Generator(dev).manual_seed(51))
    _fwd_sweeps_match_plain(a, _as_fp32(a), S, h0)


@pytest.mark.parametrize("case", ["cg20", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fwd_sweep_on_misaligned_rows_matches_plain(dev, case, dtype):
    """The flat layout where the 16-byte vectors do not line up: Cg = 20
    (in bf16 a group's rows start 40 bytes apart, and a row is no whole
    number of vectors), or u, delta, B and C one element past a 16-byte
    boundary; 2 segments of 150 steps a row, seeded."""
    Cg = 20 if case == "cg20" else 40
    args = _flat_inputs(dev, 2, 300, 2, Cg, 52, dtype)
    if case == "offset":
        args = [_misaligned(t) if i in (0, 1, 3, 4) else t for i, t in enumerate(args)]
        assert args[0].data_ptr() % 16 != 0
    a = scan._Args(*args, flat=True)
    h0 = torch.randn(a.rows * 2, 16, Cg, device=dev, generator=torch.Generator(dev).manual_seed(53))
    _fwd_sweeps_match_plain(a, _as_fp32(a), 2, h0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("flat", [True, False], ids=["flat", "grouped"])
def test_fwd_sweep_is_deterministic(dev, flat, dtype):
    """I-fwd's y, I-ckpt's states and the adjoint carry's adjoints bitwise
    equal in two runs on the same seeded inputs (Cg = 72, 4 segment rows of
    100 steps)."""
    a = _seeded_args(dev, flat, dtype, 72, 400, 54)
    g = torch.Generator(dev).manual_seed(55)
    h0 = torch.randn(a.rows * 4, 16, 72, device=dev, generator=g)
    gy = torch.randn(a.u.shape, device=dev, generator=g).to(dtype)
    first = scan._scan_fwd(a, 4, h0), scan._scan_ckpt(a, 4, h0), scan.scan_adjcarry(a, gy, 4)
    second = scan._scan_fwd(a, 4, h0), scan._scan_ckpt(a, 4, h0), scan.scan_adjcarry(a, gy, 4)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_fwd_sweep_holds_32_warps_per_sm(dev):
    """The forward sweep's design residency: in every mode (the adjoint
    carry's included), layout and dtype, 8 blocks of 4 warps per SM (at most 64 registers a thread by its
    launch bounds) and under 48 KB of static shared memory a block."""
    for mode in scan.FWD_MODES:
        for flat in (False, True):
            for bf16 in (False, True):
                warps, smem = scan.fwd_occupancy(mode, flat, bf16)
                assert warps >= 32 and 0 < smem < 48 * 1024, (mode, flat, bf16, warps, smem)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("flat", [True, False], ids=["flat", "grouped"])
def test_scan_bwd_kernel_is_deterministic(dev, flat, dtype):
    """I-bwd sums without float atomics: two runs on the same seeded inputs
    (Cg = 72: two full 32-channel blocks and an idle tail; 4 segment rows of
    100 steps) give bitwise equal dus, ddt, dB, dC and dA."""
    a = _seeded_args(dev, flat, dtype, 72, 400, 36)
    g = torch.Generator(dev).manual_seed(37)
    h0, g0 = (torch.randn(a.rows * 4, 16, 72, device=dev, generator=g) for _ in range(2))
    a0 = torch.rand(a.rows * 4, 16, 72, device=dev, generator=g)
    gy = torch.randn(a.u.shape, device=dev, generator=g).to(dtype)
    hck = scan._scan_ckpt(a, 4, h0)
    first = scan._scan_bwd(a, gy, hck, 4, g0, a0)
    second = scan._scan_bwd(a, gy, hck, 4, g0, a0)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("Cg", [8, 32, 40, 64, 72])
def test_scan_bwd_writes_one_partial_per_32_channels(dev, Cg):
    """I-bwd writes ceil(Cg / 32) partials of dB and dC, which the wrapper
    sums (one partial is returned as it is, a view of its buffer), and the
    result is the plain version's (fp32, 1e-4)."""
    a = _seeded_args(dev, True, torch.float32, Cg, 64, 38)
    gy = torch.randn(a.u.shape, device=dev, generator=torch.Generator(dev).manual_seed(39))
    parts = scan.bwd_partials(Cg)
    assert parts == -(-Cg // 32)
    dus, ddt, dB, dC, dA = scan._scan_bwd(a, gy, scan._scan_ckpt(a))
    torch.cuda.synchronize()
    for t in (dB, dC):
        assert (t._base is not None and t._base.shape[0] == 1) == (parts == 1)
    for got, want in zip((dus, ddt, dB, dC, dA), scan.scan_bwd_plain(a, gy)):
        _close(got, want, 1e-6, 1e-4)


@pytest.mark.parametrize("S", [2, 8])
def test_segmented_scan_matches_sequential(dev, S):
    """The segmented orchestration on the kernels against the sequential
    kernels and the plain scan: the forward and the sweeps' gradients."""
    args = _flat_inputs(dev, 2, 1024, 2, 32, 36)
    a = scan._Args(*args, flat=True)
    gy = torch.randn(a.u.shape, device=dev, generator=torch.Generator(dev).manual_seed(37))
    before = {n: _kernels.launches[n] for n in SEG}
    y = scan._fwd_segmented(a, S)
    got = scan._bwd_segmented(a, gy, S)
    torch.cuda.synchronize()
    assert _kernels.launches["selective_scan_carry"] == before["selective_scan_carry"] + 2
    assert _kernels.launches["selective_scan_adjcarry"] == before["selective_scan_adjcarry"] + 1
    _close(y, scan._scan_fwd(a), 1e-6, 1e-5)
    _close(y, scan.selective_scan_plain(*args, delta_softplus=True), 1e-6, 1e-5)
    seq = scan._scan_bwd(a, gy, scan._scan_ckpt(a))
    seq = seq[:4] + (seq[4].reshape(a.rows, 1, 16, 32).sum(1),)
    for g, w in zip(got, seq):
        _close(g, w, 1e-6, 1e-4)


def test_flat_scan_raises_on_what_the_kernels_do_not_take(dev):
    """Kernel H is built for N = 16 and the softplus of dt; the flat
    contract on a CUDA tensor sends every other call to the general route
    (kernel J) instead of raising, and no call raises for its number of
    rows (65536 here, past the grid's y extent)."""
    args = _flat_inputs(dev, 1, 32, 2, 16, 38)
    before = _kernels.launches["scan_states"]
    y = scan.selective_scan(*_no_softplus(args), delta_softplus=False)
    _close(y, scan.selective_scan_plain(*_no_softplus(args), delta_softplus=False), 1e-6, 1e-5)
    small = args[:3] + [args[3][..., :8], args[4][..., :8]] + args[5:]
    small[2] = small[2][:, :8]
    y = scan.selective_scan(*small, delta_softplus=True)           # N = 8
    torch.cuda.synchronize()
    assert _kernels.launches["scan_states"] == before + 2
    _close(y, scan.selective_scan_plain(*small, delta_softplus=True), 1e-6, 1e-5)
    big = _flat_inputs(dev, 32768, 16, 2, 16, 39)      # 65536 rows
    before = _kernels.launches["selective_scan_fwd_flat"]
    y = scan.selective_scan(*big, delta_softplus=True)
    torch.cuda.synchronize()
    assert _kernels.launches["selective_scan_fwd_flat"] == before + 1
    _close(y, scan.selective_scan_plain(*big, delta_softplus=True), 1e-6, 1e-5)


# (B, L, K) on the segments the wrapper chooses: the narrow long-L shape cut
# to L = 20000 (105 segments), K = 33 (rows not 16-byte aligned: 4-byte
# copies) at 6 strips (6 segments) and at 180 (one segment streamed through
# the ring), 100 (a last strip of 4 lanes), 1024 at 64 strips (4 segments)
# and at 192 (one, just above STATES_MIN_STRIPS), L = 1 and 7, L not a
# multiple of the segment or of the chunk (200: 128 + 72 steps; 385: 192 +
# 192 + 1), rows 4 bytes past a 16-byte boundary (4-byte copies); one strip
# (a block's two warps walk consecutive segments of it) and three (a
# block's tickets straddle two segments)
_STATES_CASES = {"narrow": (2, 20000, 256), "k33": (3, 1000, 33),
                 "k33_stream": (90, 400, 33), "k100": (3, 1000, 100),
                 "k1024": (2, 700, 1024), "k1024_stream": (6, 700, 1024), "l1": (2, 1, 64),
                 "l7": (2, 7, 33), "l200_seg": (2, 200, 64), "l385_seg": (1, 385, 64),
                 "misaligned": (2, 1000, 64), "one_strip": (1, 2000, 32),
                 "three_strips": (3, 1000, 32)}


def _states_operands(dev, B, L, K, seed, misaligned=False, decay=1.0):
    g = torch.Generator(dev).manual_seed(seed)
    dA = torch.exp(-decay * torch.rand(B, L, K, device=dev, generator=g))
    dBu = torch.randn(B, L, K, device=dev, generator=g)
    if misaligned:      # contiguous, 4 bytes past a 16-byte boundary
        dA, dBu = [torch.cat([t.new_zeros(1), t.flatten()])[1:].view(B, L, K) for t in (dA, dBu)]
        assert dA.data_ptr() % 16 == 4 and dA.is_contiguous()
    return dA, dBu


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("case", list(_STATES_CASES))
def test_scan_states_kernel_matches_plain(dev, case, reverse):
    """Kernel J over fp32 (B, L, K) operands, forward and reverse, on the
    shipped segment count: one launch a call, 1e-5 of the largest state
    (fp32, a sequential walk with chained segment seeds against a chunked
    doubling scan)."""
    B, L, K = _STATES_CASES[case]
    dA, dBu = _states_operands(dev, B, L, K, 40 + reverse, misaligned=case == "misaligned")
    before = _kernels.launches["scan_states"]
    h = scan.scan_states(dA, dBu, reverse)
    torch.cuda.synchronize()
    assert _kernels.launches["scan_states"] == before + 1
    _close(h, scan.scan_states_plain(dA, dBu, reverse), 1e-6, 1e-5)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_scan_states_kernel_bitwise_twice(dev, reverse):
    """J's chained segments give the same bits in two runs: each seed is
    the chain's own FMAs in segment order wherever the look-back stopped.
    At (2, 20000, 256) (105 segments a strip) and (13, 2000, 1024) (one)."""
    for B, L, K, seed in ((2, 20000, 256, 42), (13, 2000, 1024, 43)):
        dA, dBu = _states_operands(dev, B, L, K, seed + reverse)
        first = scan.scan_states(dA, dBu, reverse)
        for _ in range(2):
            assert torch.equal(scan.scan_states(dA, dBu, reverse), first)


def test_scan_states_kernel_underflowing_segments(dev):
    """Decays so small that each segment's product of dA underflows to 0
    (every seed's weight vanishes), and decays near 1 (the seeds carry
    far): both against the plain version at 1e-5."""
    for decay in (100.0, 1e-3):
        dA, dBu = _states_operands(dev, 2, 3000, 64, 44, decay=decay)
        for reverse in (False, True):
            h = scan.scan_states(dA, dBu, reverse)
            _close(h, scan.scan_states_plain(dA, dBu, reverse), 1e-6, 1e-5)


@pytest.mark.parametrize("N", [4, 32])
def test_states_scan_route_matches_plain(dev, N):
    """The general route (`_StatesScan`: J once forward, twice backward) on
    the flat contract with softplus off: y to 1e-5 and the seven gradients
    to 1e-4 of their largest elements, fp32; bf16, fp16 and float64 inputs
    give y within one rounding of their dtype (float64 computes in fp32)."""
    rng = np.random.default_rng(N)
    B, L, G, Cg = 2, 300, 2, 24

    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    args = [f(B, L, G * Cg), f(B, L, G * Cg, scale=0.5), -torch.exp(f(G * Cg, N, scale=0.5)),
            f(B, L, G, N), f(B, L, G, N), f(G * Cg), f(G * Cg, scale=0.5, off=-3.0)]
    args = [a.requires_grad_() for a in _no_softplus(args)]
    gy = f(B, L, G * Cg)
    before = _kernels.launches["scan_states"]
    y = scan.selective_scan(*args, delta_softplus=False)
    got = torch.autograd.grad(y, args, gy)
    torch.cuda.synchronize()
    assert _kernels.launches["scan_states"] == before + 3
    want_y = scan.selective_scan_plain(*args, delta_softplus=False)
    want = torch.autograd.grad(want_y, args, gy)
    _close(y, want_y, 1e-6, 1e-5)
    for g, w in zip(got, want):
        _close(g, w, 1e-6, 1e-4)
    for dtype, rel in ((torch.bfloat16, BF16_REL), (torch.float16, 2.0 ** -11),
                       (torch.float64, 1e-5)):
        cast = [a.detach().to(dtype) for a in args]
        y = scan.selective_scan(*cast, delta_softplus=False)
        assert y.dtype == dtype
        _close(y, scan.selective_scan_plain(*[a.float() for a in cast], delta_softplus=False),
               1e-6, rel)


@pytest.mark.parametrize("Cg", [16, 8])
@pytest.mark.parametrize("flat", [True, False], ids=["flat_H", "grouped_I"])
def test_scan_kernels_take_more_rows_than_the_grid_y_extent(dev, flat, Cg):
    """About 70000 rows of 16 steps, Cg channels (8: an idle tail of every
    block): H (flat) and I (grouped) forward and backward against the plain
    version, fp32."""
    if flat:
        args = _flat_inputs(dev, 35000, 16, 2, Cg, 41)
        fn, plain = scan.selective_scan, scan.selective_scan_plain
    else:
        args = _scan_inputs(dev, (17500, 4, 16, Cg), 42)
        fn, plain = scan.cross_selective_scan, scan.cross_selective_scan_plain
    args = [a.requires_grad_() for a in args]
    gy = torch.randn(args[0].shape, device=dev, generator=torch.Generator(dev).manual_seed(43))
    y = fn(*args, delta_softplus=True)
    got = torch.autograd.grad(y, args, gy)
    want_y = plain(*args, delta_softplus=True)
    want = torch.autograd.grad(want_y, args, gy)
    _close(y, want_y, 1e-6, 1e-5)
    for g, w in zip(got, want):
        _close(g, w, 1e-6, 1e-4)


def _attn_inputs(dev, rng, D, h=8, M=8, B=2, N=1000):
    """Kernel G's 8 inputs (the decoder layer's first 8) and a cotangent;
    N = 1000 leaves a ragged tail of G's 64- and 32-row tiles."""
    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    return [f(B, N, D), f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, h, scale=0.1),
            f(B, M, h), f(B, M, h), f(h, D, scale=0.1), f(D, scale=0.1)], f(B, N, D)


@pytest.mark.parametrize("B,N", [(2, 1000), (3, 16411)], ids=["2x1000", "3x16411"])
@pytest.mark.parametrize("D", [64, 128, 512])
@pytest.mark.parametrize("use_perm", [False, True], ids=["no_perm", "perm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cross_attn_kernel_matches_plain(dev, D, use_perm, dtype, B, N):
    """Kernel G (the layer's attention sublayer) against the plain version in
    fp32 on the same inputs, one launch per call. N is ragged for every tile
    (16, 32 and 64 rows); at (3, 16411) the bf16 body's warps take several
    tiles each, across a batch's end."""
    rng = np.random.default_rng(D + 11)
    args, _ = _attn_inputs(dev, rng, D, B=B, N=N)
    args = [a.to(dtype) for a in args]
    perm = _random_perm(dev, rng, D) if use_perm else None
    before = _kernels.launches["cross_attn_fwd"]
    out = xattn.cross_attn_head1(*args, scale=D ** -0.5, perm=perm)
    torch.cuda.synchronize()
    assert _kernels.launches["cross_attn_fwd"] == before + 1 and out.dtype == dtype
    want = xattn.cross_attn_head1_plain(*[a.float() for a in args], scale=D ** -0.5,
                                        perm=perm)
    _close(out, want, 1e-4 if dtype == torch.bfloat16 else 0.0,
           1e-5 if dtype == torch.float32 else BF16_REL)


@pytest.mark.parametrize("B,N", [(2, 1000), (3, 16411)], ids=["2x1000", "3x16411"])
@pytest.mark.parametrize("D", [64, 128, 256, 384, 512])
@pytest.mark.parametrize("use_perm", [False, True], ids=["no_perm", "perm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_cross_attn_bwd_kernel_matches_plain(dev, D, use_perm, dtype, B, N):
    """Kernel G-bwd: the 8 input gradients against torch.autograd.grad of
    the plain version in fp32 on the same inputs (fp32: 1e-4 of each
    gradient's largest element, the row sums run in another order; bf16:
    one rounding), one launch of G and of G-bwd, at every built width. N is
    ragged for every tile (16, 32 and 64 rows); at (3, 16411) the bf16 body's
    warps take several tiles each, across a batch's end."""
    rng = np.random.default_rng(D + 12)
    args, gy = _attn_inputs(dev, rng, D, B=B, N=N)
    args = [a.to(dtype).requires_grad_() for a in args]
    perm = _random_perm(dev, rng, D) if use_perm else None
    before = {n: _kernels.launches[n] for n in ("cross_attn_fwd", "cross_attn_bwd")}
    out = xattn.cross_attn_head1(*args, scale=D ** -0.5, perm=perm)
    got = torch.autograd.grad(out, args, gy.to(dtype))
    torch.cuda.synchronize()
    assert all(_kernels.launches[n] == before[n] + 1 for n in before)
    ref = [a.detach().float().requires_grad_() for a in args]
    want = torch.autograd.grad(
        xattn.cross_attn_head1_plain(*ref, scale=D ** -0.5, perm=perm), ref,
        gy.to(dtype).float())
    for g, w, a in zip(got, want, args):
        assert g.dtype == a.dtype and g.shape == a.shape
        _close(g, w, 1e-5 if dtype == torch.bfloat16 else 0.0,
               1e-4 if dtype == torch.float32 else BF16_REL)


@pytest.mark.parametrize("D", [64, 128, 256])
def test_cross_attn_bwd_bf16_kernel_on_a_logit_spread_matches_plain(dev, D):
    """bf16 G-bwd (the tensor-core body at D = 64 and 128, the first design
    at 256) as `test_cross_attn_bwd_kernel_matches_plain` holds it, with
    head 0's keys scaled by 1e4 at (2, 4096, D): its logits lie ~1e3 above
    the other heads' (chip_smoke.py's spread case), where q must be exact
    to fp32 for the softmax's gradient to hold the bound (q through bf16 hi
    + lo failed it)."""
    rng = np.random.default_rng(D + 15)
    args, gy = _attn_inputs(dev, rng, D, N=4096)
    args[4][..., 0] *= 1e4
    args = [a.to(torch.bfloat16).requires_grad_() for a in args]
    gy = gy.to(torch.bfloat16)
    got = torch.autograd.grad(xattn.cross_attn_head1(*args, scale=D ** -0.5), args, gy)
    ref = [a.detach().float().requires_grad_() for a in args]
    want = torch.autograd.grad(xattn.cross_attn_head1_plain(*ref, scale=D ** -0.5), ref,
                               gy.float())
    for g, w in zip(got, want):
        _close(g, w, 1e-5, BF16_REL)


def _attn_f64(x, ln_s, ln_b, wq, k, v, w_out, b_out, *, scale, eps=1e-5):
    """`cross_attn_head1_plain`'s arithmetic in the dtype of its inputs
    throughout, float64 here: the plain version's own LayerNorm
    (`layer_norm32`) computes in fp32 whatever its input's dtype."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x * x).mean(dim=-1, keepdim=True) - mu * mu
    q = ((x - mu) * torch.rsqrt(var + eps) * ln_s + ln_b) @ wq
    attn = torch.softmax(q[..., None] * (k * scale).transpose(1, 2)[:, None], dim=-1)
    return (attn * v.transpose(1, 2)[:, None]).sum(dim=-1) @ w_out + b_out + x


@pytest.mark.parametrize("D", [64, 128, 256, 384, 512])
def test_cross_attn_fp32_kernels_on_a_logit_spread_match_float64(dev, D):
    """fp32 G's output and G-bwd's eight gradients with head 0's keys scaled
    by 1e4 at (2, 4096, D) (its logits ~1e3 apart; near a tie between two
    tokens the gradient moves with q's absolute error) against autograd of
    the plain version's arithmetic in float64, each within 1e-4 of its
    largest element. Before xattn_layer.cuh `attention_rows` took LN1 and q
    in float64, an fp32 LayerNorm and one serial fp32 sum for q put dx at
    2.05x the bound at D = 128 and dln_bias at 7.28x at D = 512 (NVIDIA
    H100 80GB HBM3, 700 W)."""
    rng = np.random.default_rng(D + 15)
    args, gy = _attn_inputs(dev, rng, D, N=4096)
    args[4][..., 0] *= 1e4
    args = [a.requires_grad_() for a in args]
    out = xattn.cross_attn_head1(*args, scale=D ** -0.5)
    got = (out,) + torch.autograd.grad(out, args, gy)
    ref = [a.detach().double().requires_grad_() for a in args]
    want = _attn_f64(*ref, scale=D ** -0.5)
    want = (want,) + torch.autograd.grad(want, ref, gy.double())
    for name, g, w in zip(("y",) + xattn._ARG_NAMES[:8], got, want):
        err = (g.double() - w).abs().max().item()
        assert err <= 1e-4 * w.abs().max().item(), (name, err / (1e-4 * w.abs().max().item()))


@pytest.mark.parametrize("D", [128, 64])
def test_cross_attn_bf16_kernel_is_deterministic(dev, D):
    """bf16 G's output bitwise equal in two runs at (4, 16384, D)."""
    rng = np.random.default_rng(D + 16)
    args, _ = _attn_inputs(dev, rng, D, B=4, N=16384)
    args = [a.to(torch.bfloat16) for a in args]
    first = xattn.cross_attn_head1(*args, scale=D ** -0.5)
    second = xattn.cross_attn_head1(*args, scale=D ** -0.5)
    assert torch.equal(first, second)


def test_cross_attn_bf16_build_fits_its_design(dev):
    """G's bf16 body (D = 64 and 128) spills nothing, holds at most 128
    registers a thread, and one wave holds two blocks of 8 warps on every SM,
    a 16-row tile a warp."""
    import re

    lines = _layer_ptxas(("cross_attn.cu",))
    tc = {name: " ".join(text) for name, text in lines.items() if "cross_attn_fwd_tc" in name}
    assert len(tc) == 2, sorted(lines)
    for name, joined in tc.items():
        assert "0 bytes spill stores" in joined and "0 bytes spill loads" in joined, (name, joined)
        assert int(re.search(r"Used (\d+) registers", joined).group(1)) <= 128, (name, joined)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for D in (128, 64):
        assert xattn.attn_fwd_grid(D, torch.bfloat16, dev) == (2 * sms, 16, 8)


def test_cross_attn_bf16_kernel_runs_on_tensor_cores(dev):
    """The machine code of G's bf16 body holds tensor-core instructions
    (HMMA in `cuobjdump -sass` of the built library)."""
    counts = _hmma_counts()
    if counts is None:
        pytest.skip("needs cuobjdump (the CUDA toolkit)")
    for kernel in ("cross_attn_fwd_tcILi128", "cross_attn_fwd_tcILi64"):
        assert any(kernel in name and n > 0 for name, n in counts.items()), (kernel, counts)


@pytest.mark.parametrize("D", [128, 64])
def test_cross_attn_bwd_bf16_kernel_is_deterministic(dev, D):
    """bf16 G-bwd's dx, and every gradient but dk and dv (added across warps
    with atomicAdd), bitwise equal in two runs at (4, 16384, D)."""
    rng = np.random.default_rng(D + 14)
    args, gy = _attn_inputs(dev, rng, D, B=4, N=16384)
    args, gy = [a.to(torch.bfloat16) for a in args], gy.to(torch.bfloat16)
    first = xattn._kernel_bwd(args, gy, D ** -0.5, None, 1e-5)
    second = xattn._kernel_bwd(args, gy, D ** -0.5, None, 1e-5)
    for name, a, b in zip(xattn._ARG_NAMES, first, second):
        if name not in ("k", "v"):
            assert torch.equal(a, b), name


def test_cross_attn_bwd_bf16_build_fits_its_design(dev):
    """G-bwd's bf16 body (D = 64 and 128) spills nothing, holds tensor-core
    instructions (HMMA in `cuobjdump -sass`, where the toolkit has it), and
    one wave holds one block of 8 warps on every SM."""
    lines = _layer_ptxas(("cross_attn_bwd.cu",))
    tc = {name: " ".join(text) for name, text in lines.items() if "cross_attn_bwd_tc" in name}
    assert len(tc) == 2, sorted(lines)
    for name, joined in tc.items():
        assert "0 bytes spill stores" in joined and "0 bytes spill loads" in joined, (name, joined)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for D in (128, 64):
        assert xattn.attn_bwd_blocks(16, 16384, D, torch.bfloat16, dev) == sms
    counts = _hmma_counts()
    if counts is not None:
        for kernel in ("cross_attn_bwd_tcILi128", "cross_attn_bwd_tcILi64"):
            assert any(kernel in name and n > 0 for name, n in counts.items()), (kernel, counts)


def test_cross_attn_raises_on_what_the_kernels_do_not_take(dev):
    """h = 16 (which JAX's G takes), M = 16, D = 96 and fp16 raise rather
    than fall back to the plain version."""
    before = _kernels.launches["cross_attn_fwd"]
    for kwargs in (dict(D=128, h=16), dict(D=128, M=16), dict(D=96)):
        args, _ = _attn_inputs(dev, np.random.default_rng(0), N=64, **kwargs)
        with pytest.raises(ValueError):
            xattn.cross_attn_head1(*args, scale=0.1)
    args, _ = _attn_inputs(dev, np.random.default_rng(0), 128, N=64)
    with pytest.raises(ValueError):
        xattn.cross_attn_head1(*[a.half() for a in args], scale=0.1)
    assert _kernels.launches["cross_attn_fwd"] == before
