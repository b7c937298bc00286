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


def test_wrappers_raise_on_shapes_the_kernels_do_not_take(dev):
    a = torch.zeros(2, 8, 8, 4, device=dev)             # C = 4: no kernel built
    with pytest.raises(ValueError):
        warp.token_scatter(a, torch.zeros(2, 8, 8, 2, device=dev), torch.zeros(2, 4, device=dev))
