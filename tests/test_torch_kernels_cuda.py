"""The port's hand-written CUDA kernels against their plain versions, on the
card. Marked `cuda`; each test skips when no CUDA device is present (there
is no interpret mode for a CUDA kernel). On a GPU machine without JAX,
skip tests/conftest.py (it configures JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

Bounds as chip_smoke.py states them: fp32 kernels differ from the fp32
plain versions only in summation order; bf16 kernels compute in fp32 and
round once, so they are held to one bf16 rounding (2^-8 relative) of the
fp32 plain result on the same inputs."""

import numpy as np
import pytest
import torch

from smow_net_tpu_torch.ops import _kernels, warp, xattn

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


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_token_scatter_kernel_matches_plain(dev, C, dtype):
    rng = np.random.default_rng(C)
    a = torch.from_numpy(rng.normal(size=(4, 24, 64, C)).astype(np.float32)).to(dev, dtype)
    flow = torch.from_numpy((rng.normal(size=(4, 24, 64, 2)) * 3).astype(np.float32)).to(dev)
    grid = warp.flow_grid(flow, 24, 64)
    m = a.amax(dim=(1, 2)).float()
    before = _kernels.launches["token_scatter_fwd"]
    ew, zaw = warp.token_scatter(a, grid, m)
    torch.cuda.synchronize()
    assert _kernels.launches["token_scatter_fwd"] == before + 1
    ew_p, zaw_p = warp.token_scatter_plain(a.float(), grid, m)
    rtol = 1e-5 if dtype == torch.float32 else BF16_REL
    _close(ew, ew_p, 1e-5, rtol)
    _close(zaw, zaw_p, 1e-5, rtol)


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


def _token_inputs(dev, C, dtype, seed, shape=(4, 24, 64)):
    rng = np.random.default_rng(seed)
    F_, H, W = shape
    a = torch.from_numpy(rng.normal(size=(F_, H, W, C)).astype(np.float32)).to(dev, dtype)
    flow = torch.from_numpy((rng.normal(size=(F_, H, W, 2)) * 3).astype(np.float32)).to(dev)
    other = torch.from_numpy(rng.normal(size=(F_, H, W, C)).astype(np.float32)).to(dev, dtype)
    return a, warp.flow_grid(flow, H, W), other


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_token_scatter_residual_kernel_matches_plain(dev, C, dtype):
    """Kernel E: kernel D plus the eaw residual in a's dtype."""
    a, grid, _ = _token_inputs(dev, C, dtype, 10 + C)
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


def test_wrappers_raise_on_shapes_the_kernels_do_not_take(dev):
    a = torch.zeros(2, 8, 8, 4, device=dev)             # C = 4: no kernel built
    with pytest.raises(ValueError):
        warp.token_scatter(a, torch.zeros(2, 8, 8, 2, device=dev), torch.zeros(2, 4, device=dev))
