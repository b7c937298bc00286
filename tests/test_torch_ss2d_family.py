"""The port's VMamba layer family (smow_net_tpu_torch/ops/cross_scan.py and
nn/ssm.py) against the JAX package's on CPU, at tiny shapes, with no
whole-model JAX compile.

- The eight-direction traversal's wrapped (anti-)diagonal permutations,
  and every cross-scan / cross-merge pair (4 and 8 directions, the 1d and
  2d ablations, the one-by-one scan of the xv forms), forward and VJP, at
  a non-square (H, W) = (3, 5): exact (they move values, and the VJPs add
  at most eight of them).
- The xv forms' postfix parsing, in JAX's order. SS2D's forms themselves
  are held in tests/test_torch_ss2d_forms.py.
- VSSBlock at K = 8 and with either branch off, and VSSM with patch embed
  v1 and downsample v3, eval mode, the output to 1e-5.
- remat: VSSBlock with and without it give bitwise-equal outputs and
  gradients, also when a functional_call swaps the parameters for cast
  copies (as the bf16 train step does); so does a tiny RS-Mamba with and
  without use_checkpoint, which reaches every VSSBlock (ChangeMamba's too).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.nn import ssm as jssm
from smow_net_tpu.ops import cross_scan as jcs
from smow_net_tpu_torch.nn.ssm import VSSM, VSSBlock, parse_xv
from smow_net_tpu_torch.ops import cross_scan as tcs
from smow_net_tpu_torch.train.convert import state_dict_from_jax
from test_torch_change_mamba import _seeded
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

H, W = 3, 5


def run_compiled(fn, *args):
    """fn(*args) through one XLA compile at backend optimisation level 0:
    the same arithmetic, half the compile time of these tiny references."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return compiled(*args)


def _port_sd(params, prefix=""):
    """JAX params -> the port's keys (the change_mamba walk: bare module
    names are the port's)."""
    tree = {"params": {"encoder": params} if prefix else params, "batch_stats": {}}
    sd = state_dict_from_jax(tree, model="change_mamba")
    return {k[len(prefix):]: v for k, v in sd.items()}


def test_diagonal_permutations_match_jax():
    for h, w in ((3, 5), (4, 4), (5, 2)):
        d, a = tcs._diag_perm(h, w), tcs._antidiag_perm(h, w)
        np.testing.assert_array_equal(d, jcs._diag_perm(h, w))
        np.testing.assert_array_equal(a, jcs._antidiag_perm(h, w))
        for p in (d, a):
            assert sorted(p) == list(range(h * w))      # a bijection
            np.testing.assert_array_equal(tcs._inverse_perm(p),
                                          jcs._inverse_perm(p.tobytes(), h * w))
    # the wrapped diagonal: shift s, row i -> column (i + s) % W, H elements each
    assert list(tcs._diag_perm(3, 5)[:6]) == [0, 6, 12, 1, 7, 13]
    assert list(tcs._antidiag_perm(3, 5)[:6]) == [0, 9, 13, 1, 5, 14]


@pytest.mark.parametrize("pair", ["cross", "8", "1d", "2d", "1b1"])
def test_cross_scan_and_merge_match_jax(pair):
    rng = np.random.default_rng(1)
    C = 8
    x = rng.normal(size=(2, H, W, C)).astype(np.float32)
    scan, merge = {"cross": ("cross_scan", "cross_merge"), "8": ("cross_scan8", "cross_merge8"),
                   "1d": ("cross_scan_1d", "cross_merge_1d"),
                   "2d": ("cross_scan_2d", "cross_merge_2d"), "1b1": ("cross_scan_1b1", None)}[pair]
    xt = torch.from_numpy(x).requires_grad_()
    ys = getattr(tcs, scan)(xt)
    want, vjp = jax.vjp(getattr(jcs, scan), jnp.asarray(x))
    np.testing.assert_array_equal(ys.detach().numpy(), np.asarray(want))
    gy = rng.normal(size=want.shape).astype(np.float32)
    ys.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(gy))[0]),
                               rtol=0, atol=1e-5)
    if merge is None:
        return
    ym = rng.normal(size=want.shape).astype(np.float32)
    yt = torch.from_numpy(ym).requires_grad_()
    out = getattr(tcs, merge)(yt, H, W)
    want, vjp = jax.vjp(lambda y: getattr(jcs, merge)(y, H, W), jnp.asarray(ym))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    go = rng.normal(size=want.shape).astype(np.float32)
    out.backward(torch.from_numpy(go))
    np.testing.assert_array_equal(yt.grad.numpy(), np.asarray(vjp(jnp.asarray(go))[0]))
    if pair in ("cross", "8"):      # every traversal a bijection: merge(scan(x)) = K x
        K = 8 if pair == "8" else 4
        got = getattr(tcs, merge)(getattr(tcs, scan)(torch.from_numpy(x)), H, W)
        torch.testing.assert_close(got, K * torch.from_numpy(x).reshape(2, H * W, C),
                                   rtol=0, atol=1e-5)


def test_gather_backward_is_a_gather():
    """The diagonal gather's backward is the gather by the inverse
    permutation: it runs under torch's deterministic mode, which refuses
    index_add's atomics on the card."""
    x = torch.randn(2, H * W, 4, requires_grad=True)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        y = tcs._gather(x, H, W, "anti")
        g = torch.randn_like(y)
        (gx,) = torch.autograd.grad(y, x, g)
    finally:
        torch.use_deterministic_algorithms(prev)
    perm = torch.from_numpy(tcs._antidiag_perm(H, W).astype(np.int64))
    torch.testing.assert_close(y, x[:, perm], rtol=0, atol=0)
    want = torch.zeros_like(x).index_add_(1, perm, g)
    torch.testing.assert_close(gx, want, rtol=0, atol=0)


def test_cross_scan8_trains_after_an_inference_mode_call():
    """The permutations' index tensors are cached per (H, W, device); made
    by a first call under inference mode (an eval step) they must still
    serve a later train step's backward."""
    tcs._indices.cache_clear()
    x = torch.randn(2, 4, 6, 3)
    with torch.inference_mode():
        tcs.cross_scan8(x)
    xt = x.clone().requires_grad_()
    tcs.cross_merge8(tcs.cross_scan8(xt), 4, 6).sum().backward()
    torch.testing.assert_close(xt.grad, torch.full_like(x, 8.0), rtol=0, atol=0)


def test_parse_xv_takes_postfixes_in_jax_order():
    assert parse_xv("xv1aactmulsoftmaxno32") == ("xv1a", "softmax", True, True)
    assert parse_xv("xv3a") == ("xv3a", "ln", False, False)
    with pytest.raises(ValueError, match="xv1"):
        parse_xv("xv1")
    with pytest.raises(ValueError):
        parse_xv("xv2amulact")      # act before mul: the JAX order refuses it too


@pytest.mark.parametrize("kw", [dict(k_group=8, drop_path=0.2), dict(mlp_ratio=0.0),
                                dict(ssm_ratio=0.0, mlp_ratio=2.0)],
                         ids=["k8", "no_mlp", "no_ssm"])
def test_vss_block_matches_jax(kw):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, H, W, 8)).astype(np.float32)
    jmod = jssm.VSSBlock(8, **kw)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = _seeded(shapes["params"], rng)
    want = np.asarray(run_compiled(jmod.apply, {"params": params}, jnp.asarray(x)))
    port = VSSBlock(8, **kw)
    port.load_state_dict(_port_sd(params), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_vssm_v1_v3_matches_jax():
    """Patch embed v1, downsample v3, K = 8, the last two stages tapped."""
    rng = np.random.default_rng(4)
    kw = dict(depths=(1, 1, 1), dims=(8, 16, 24), patchembed_version="v1",
              downsample_version="v3", k_group=8, out_indices=(1, 2))
    x = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    jmod = jssm.VSSM(**kw)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = _seeded(shapes["params"], rng)
    want = [np.asarray(o) for o in run_compiled(jmod.apply, {"params": params}, jnp.asarray(x))]
    port = VSSM(**kw)
    port.load_state_dict(_port_sd(params, prefix="encoder."), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [g.shape for g in got] == [(2, 2, 2, 16), (2, 1, 1, 24)] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("swap", [False, True], ids=["plain", "functional_call"])
def test_vss_block_remat_is_bitwise(swap):
    """The SS2D under torch.utils.checkpoint gives the bits of the plain
    block, output and gradients; `swap` runs both under a functional_call
    with float64 copies of the float32 parameters, as the bf16 train step
    swaps in bf16 copies (the recompute must use the copies)."""
    results = []
    for remat in (False, True):
        torch.manual_seed(5)
        block = VSSBlock(8, drop_path=0.3, k_group=8, remat=remat).train()
        block.drop_path.generator = torch.Generator().manual_seed(6)
        x = torch.from_numpy(np.random.default_rng(7).normal(size=(4, H, W, 8)))
        x = x.float().requires_grad_()
        if swap:
            params = {n: p.double() for n, p in block.named_parameters()}
            y = torch.func.functional_call(block, params, (x.double(),))
        else:
            y = block(x)
        y.square().sum().backward()
        results.append([y.detach(), x.grad] + [p.grad for p in block.parameters()])
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_model_use_checkpoint_is_bitwise():
    """use_checkpoint (the reference's flag) puts every SS2D of the model
    under remat (ChangeMamba's encoder and STBlocks alike, counted on the
    meta device) and changes no bit of RS-Mamba's train-mode output or
    gradients."""
    from smow_net_tpu_torch.models.change_mamba import ChangeMamba
    from smow_net_tpu_torch.models.rs_mamba import RSMCD

    tiny = dict(depths=(1, 1, 1, 1), dims=(16, 32, 48, 64))
    with torch.device("meta"):
        for remat in (False, True):
            blocks = [m for m in ChangeMamba(**tiny, use_checkpoint=remat).modules()
                      if isinstance(m, VSSBlock)]
            assert len(blocks) == 16 and all(b.remat == remat for b in blocks)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 3, 32, 32)).astype(np.float32))
    results = []
    for remat in (False, True):
        torch.manual_seed(9)
        model = RSMCD(**tiny, use_checkpoint=remat).train()
        blocks = [m for m in model.modules() if isinstance(m, VSSBlock)]
        assert len(blocks) == 4 and all(b.remat == remat for b in blocks)
        for b in blocks:
            b.drop_path.generator = torch.Generator().manual_seed(10)
        out = model(x, x.flip(-1))
        out.square().mean().backward()
        results.append([out.detach()] + [p.grad for p in model.parameters()])
    for a, b in zip(*results):
        assert torch.equal(a, b)
