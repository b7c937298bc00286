"""The port's flat selective-scan contract (kernel H's) and its segmented
long-L orchestration (kernel H-seg's), smow_net_tpu_torch/ops/scan.py, and
CD-Mamba's small ops (ops/convops.py, ops/pooling.py, ops/resize.py)
against the JAX package on CPU.

On a CPU tensor `selective_scan` is `selective_scan_plain`, and the
segmented orchestration (`fwd_segmented`, `bwd_segmented`) runs on the plain
sweeps (`scan_fwd_plain` seeded with h0, `scan_carry_plain`,
`scan_adjcarry_plain`, `scan_bwd_plain`). They are held against JAX's
Pallas kernels in interpret mode (`selective_scan_fused(..., interpret=
True)`, `_fwd_segmented`, `_bwd_segmented`, `_carry_core`,
`_adjcarry_core`), on the same numpy-seeded inputs; the epilogue that the
card's backward runs (`scan._epilogue`) is held here over the plain sweeps.
Bounds:
  - outputs and states: 1e-5 of the largest element (fp32 sums in another
    order: a chunked doubling scan against a sequential one);
  - gradients and the backward sweeps' outputs: 2e-4 of each one's largest
    element (sums over L and over the batch in fp32), as
    tests/test_torch_scan.py holds kernel I's;
  - the segmented path against the unsegmented plain scan: the same bounds;
  - causal_conv1d, max_pool, resize_nearest: 1e-6 (fp32 conv sums) or
    exact (data movement);
  - selective_scan_step token by token against JAX's step and the full
    scan: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smow_net_tpu.ops import convops as jconv
from smow_net_tpu.ops import pooling as jpool
from smow_net_tpu.ops import resize as jresize
from smow_net_tpu.ops import scan as jscan
from smow_net_tpu.ops.pallas import scan_fused as sf
from smow_net_tpu_torch.ops import convops, pooling, resize, scan
from test_torch_scan import one_torch_thread  # noqa: F401  (autouse: the port on one thread)

N = 16
ORDER = ("u", "delta", "A", "Bm", "Cm", "D", "bias")


def _inputs(seed, B=2, L=128, G=2, Cg=16):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)
    Dch = G * Cg
    return dict(u=f(B, L, Dch), delta=f(B, L, Dch, scale=0.5),
                A=-np.exp(f(Dch, N, scale=0.5)), Bm=f(B, L, G, N), Cm=f(B, L, G, N),
                D=f(Dch), bias=f(Dch, scale=0.1))


def _torch(inp, grad=False):
    return [torch.from_numpy(inp[k]).requires_grad_(grad) for k in ORDER]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _jax_fused_grads(inp, gy):
    """JAX's kernel H in interpret mode: y and the seven gradients."""
    args = [jnp.asarray(inp[k]) for k in ORDER]

    def loss(*a):
        y = sf.selective_scan_fused(*a, True, True)
        return jnp.sum(y * gy), y

    (_, y), g = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(7)), has_aux=True))(*args)
    return np.asarray(y), [np.asarray(t) for t in g]


@pytest.mark.parametrize("G", [1, 2])
def test_flat_contract_matches_fused_kernel(G):
    """The output and all seven input gradients against JAX's kernel H
    (`selective_scan_fused` with its I-ckpt, I-bwd and epilogue); the
    gradients through torch autograd of the plain version, and again
    through the port's own epilogue (the one the card's backward runs) over
    the plain sweeps."""
    inp = _inputs(G, G=G, Cg=32 // G)
    gy = np.random.default_rng(9).normal(size=inp["u"].shape).astype(np.float32)
    y_j, g_j = _jax_fused_grads(inp, gy)
    args = _torch(inp, grad=True)
    y = scan.selective_scan(*args, delta_softplus=True)
    assert y.dtype == torch.float32 and y.shape == inp["u"].shape
    assert _rel(y.detach().numpy(), y_j) <= 1e-5
    grads = torch.autograd.grad(y, args, torch.from_numpy(gy))
    a = scan._Args(*_torch(inp), flat=True)
    epi = scan._epilogue(a, torch.from_numpy(gy), *_torch(inp),
                         scan.scan_bwd_plain(a, torch.from_numpy(gy)))
    for name, got, via_epi, want in zip(ORDER, grads, epi, g_j):
        assert got.shape == want.shape, name
        assert _rel(got.numpy(), want) <= 2e-4, (name, _rel(got.numpy(), want))
        assert _rel(via_epi.numpy(), want) <= 2e-4, (name, _rel(via_epi.numpy(), want))


def _jax_grouped(inp, gy, S):
    """JAX's regrouped operands and its segmented sweeps at S segments
    (interpret mode): y (BG, L, Cg) and (dus, ddt2, dB2, dC2, dA2)."""
    args = [jnp.asarray(inp[k]) for k in ORDER]
    u2, dt2, B2, C2, A2, (B, L, Dch, G, Cg, _), regroup = sf._regrouped(
        args[0], args[1], args[2], args[3], args[4], args[6])
    Dv = args[5].reshape(G, 1, Cg)
    dims = (B * G, L, Cg, G, N)
    A_full, D_full = sf._expand_rows(A2, G, B * G), sf._expand_rows(Dv, G, B * G)
    fwd = jax.jit(lambda: sf._fwd_segmented(dt2, u2, B2, C2, A_full, D_full, dims, S, True,
                                            True)[0])
    bwd = jax.jit(lambda: sf._bwd_segmented(dt2, u2, B2, C2, regroup(jnp.asarray(gy)), A_full,
                                            dims, S, True, True))
    return np.asarray(fwd()), [np.asarray(t) for t in bwd()]


def _regroup(t, G):
    """The port's flat (B, L, G*W) or (B, L, G, W) -> JAX's (B*G, L, W)."""
    B, L = t.shape[:2]
    return t.reshape(B, L, G, -1).transpose(0, 2, 1, 3).reshape(B * G, L, -1)


@pytest.mark.parametrize("S", [2, 4])
def test_segmented_orchestration_matches_jax(S):
    """`fwd_segmented` and `bwd_segmented` on the plain sweeps against JAX's
    `_fwd_segmented` and `_bwd_segmented` over its Pallas kernels (carry,
    adjcarry, seeded I-fwd, I-ckpt and I-bwd) in interpret mode, and
    against the unsegmented plain scan and its backward sweeps."""
    inp = _inputs(20 + S)
    G = inp["Bm"].shape[2]
    gy = np.random.default_rng(S).normal(size=inp["u"].shape).astype(np.float32)
    y_j, sweeps_j = _jax_grouped(inp, gy, S)
    args = _torch(inp)
    y = scan.fwd_segmented(*args, S=S)
    y_full = scan.selective_scan_plain(*args, delta_softplus=True)
    assert _rel(_regroup(y.numpy(), G), y_j) <= 1e-5
    assert _rel(y.numpy(), y_full.numpy()) <= 1e-5
    gy_t = torch.from_numpy(gy)
    got = scan.bwd_segmented(*args[:5], gy_t, *args[5:], S=S)
    full = scan.bwd_segmented(*args[:5], gy_t, *args[5:], S=1)
    for name, g, f, want in zip(("dus", "ddt", "dB", "dC", "dA"), got, full, sweeps_j):
        g = g.numpy() if name == "dA" else _regroup(g.numpy(), G)
        f = f.numpy() if name == "dA" else _regroup(f.numpy(), G)
        assert g.shape == want.shape, name
        assert _rel(g, want) <= 2e-4, (name, _rel(g, want))
        assert _rel(g, f) <= 2e-4, (name, _rel(g, f))


def test_forced_segmentation_gradients_match_fused():
    """JAX's kernel H with segmentation forced on by its module constants
    (as tests/test_pallas_scan_fused.py does, restored afterwards) against
    the port's segmented sweeps and epilogue at the same S."""
    inp = _inputs(31)
    gy = np.random.default_rng(32).normal(size=inp["u"].shape).astype(np.float32)
    old = (sf._SEG_MIN_L, sf._SEG_MIN_K, sf._SEG_TARGET_ROWS)
    try:
        sf._SEG_MIN_L, sf._SEG_MIN_K, sf._SEG_TARGET_ROWS = 64, 16, 32
        S = sf._seg_S(4, 128)
        assert S > 1
        y_j, g_j = _jax_fused_grads(inp, gy)
    finally:
        sf._SEG_MIN_L, sf._SEG_MIN_K, sf._SEG_TARGET_ROWS = old
    args, gy_t = _torch(inp), torch.from_numpy(gy)
    a = scan._Args(*args, flat=True)
    assert _rel(scan._fwd_segmented(a, S).numpy(), y_j) <= 1e-5
    grads = scan._epilogue(a, gy_t, *args, scan._bwd_segmented(a, gy_t, S))
    for name, got, want in zip(ORDER, grads, g_j):
        assert _rel(got.numpy(), want) <= 2e-4, (name, _rel(got.numpy(), want))


def test_carry_and_adjcarry_match_jax_kernels():
    """The plain carry (final state from zero, and the dt sum) and adjoint
    carry (the adjoint at each segment row's first step from zero) against
    JAX's `_carry_core` and `_adjcarry_core` in interpret mode, on 4
    segments of 32 steps."""
    inp, S = _inputs(40), 4
    gy = np.random.default_rng(41).normal(size=inp["u"].shape).astype(np.float32)
    args = [jnp.asarray(inp[k]) for k in ORDER]
    u2, dt2, B2, C2, A2, (B, L, Dch, G, Cg, _), regroup = sf._regrouped(
        args[0], args[1], args[2], args[3], args[4], args[6])
    K, rows = L // S, B * G * S
    seg = lambda t: t.reshape(rows, K, t.shape[-1])
    A_seg = jnp.repeat(sf._expand_rows(A2, G, B * G), S, axis=0)
    sdims = (rows, K, Cg, rows, N)
    hend_j = jax.jit(lambda: sf._carry_core(seg(dt2), seg(u2), seg(B2), A_seg,
                                            jnp.zeros((rows, N, Cg)), sdims, True, True))()
    gloc_j = jax.jit(lambda: sf._adjcarry_core(seg(dt2), seg(C2), seg(regroup(jnp.asarray(gy))),
                                               A_seg, sdims, True, True))()
    csum_j = jax.nn.softplus(seg(dt2)).sum(1)
    a = scan._Args(*_torch(inp), flat=True)
    hend, csum = scan.scan_carry_plain(a, S)
    gloc = scan.scan_adjcarry_plain(a, torch.from_numpy(gy), S)
    assert hend.shape == gloc.shape == (rows, N, Cg) and csum.shape == (rows, Cg)
    assert _rel(hend.numpy(), hend_j) <= 1e-5
    assert _rel(csum.numpy(), csum_j) <= 1e-5
    assert _rel(gloc.numpy(), gloc_j) <= 1e-5


def _card_adjcarry(a, gy, S):
    """The card's adjoint carry (`scan_fwd_kernel` in kModeAdj,
    csrc/selective_scan.cu) written out in torch: each segment row's 16-step
    chunks walked last to first, the ragged last chunk first, the steps of a
    chunk last to first, g = exp2(dt' A log2 e) g + C dy with dt' the dt of
    the step after, carried from step to step and across the chunk boundary
    (0 before the first step walked, where g is 0)."""
    A, _, bias = a.seg_params(S)
    dt = scan.softplus(a.seg(a.dt, S).float() + bias)          # (B, G*S, K, Cg)
    Cm, dy = a.seg(a.Cm, S).float(), a.seg(gy, S).float()
    a2 = A * 1.4426950408889634                                 # (G*S, Cg, N)
    K, chunk = dt.shape[2], scan.CKPT_CHUNK
    g = torch.zeros(dt.shape[:2] + a2.shape[1:])
    dt_next = torch.zeros(dt.shape[:2] + dt.shape[3:])
    for j in reversed(range(-(-K // chunk))):
        for t in reversed(range(j * chunk, min(K, (j + 1) * chunk))):
            g = torch.exp2(dt_next[..., None] * a2) * g + dy[:, :, t, :, None] * Cm[:, :, t, None]
            dt_next = dt[:, :, t]
    return a.from_rows(g)


@pytest.mark.parametrize("S", [1, 2])
def test_card_adjcarry_recurrence_matches_plain_and_jax(S):
    """The adjoint carry's reformulation on the card (`_card_adjcarry`)
    against `scan_adjcarry_plain` and JAX's `_adjcarry_core` in interpret
    mode, on S segments of 40 steps (a ragged 8-step chunk walked first),
    fp32, to 1e-5 of the largest element."""
    inp = _inputs(44 + S, L=40 * S)
    gy = np.random.default_rng(46 + S).normal(size=inp["u"].shape).astype(np.float32)
    args = [jnp.asarray(inp[k]) for k in ORDER]
    _, dt2, _, C2, A2, (B, L, Dch, G, Cg, _), regroup = sf._regrouped(
        args[0], args[1], args[2], args[3], args[4], args[6])
    K, rows = L // S, B * G * S
    seg = lambda t: t.reshape(rows, K, t.shape[-1])
    A_seg = jnp.repeat(sf._expand_rows(A2, G, B * G), S, axis=0)
    gloc_j = jax.jit(lambda: sf._adjcarry_core(seg(dt2), seg(C2), seg(regroup(jnp.asarray(gy))),
                                               A_seg, (rows, K, Cg, rows, N), True, True))()
    a = scan._Args(*_torch(inp), flat=True)
    got = _card_adjcarry(a, torch.from_numpy(gy), S)
    assert got.shape == (rows, N, Cg)
    assert _rel(got.numpy(), scan.scan_adjcarry_plain(a, torch.from_numpy(gy), S).numpy()) <= 1e-5
    assert _rel(got.numpy(), gloc_j) <= 1e-5


def test_carries_over_several_plain_chunks():
    """The plain carry and adjoint carry when a segment spans several of
    the plain scan's chunks (2 segments of 300 steps: 256 + 44), against a
    step-by-step float64 loop."""
    inp = _inputs(42, B=1, L=600, G=2, Cg=4)
    gy = np.random.default_rng(43).normal(size=inp["u"].shape)
    a = scan._Args(*_torch(inp), flat=True)
    hend, csum = scan.scan_carry_plain(a, 2)
    gloc = scan.scan_adjcarry_plain(a, torch.from_numpy(gy.astype(np.float32)), 2)
    f = {k: inp[k].astype(np.float64) for k in ORDER}
    dt = np.logaddexp(0.0, f["delta"] + f["bias"]).reshape(1, 2, 300, 2, 4)       # (b, s, l, g, c)
    A = f["A"].reshape(2, 4, N)
    decay = np.exp(dt[..., None] * A)                                             # (.., g, c, n)
    x = (dt * f["u"].reshape(1, 2, 300, 2, 4))[..., None] * f["Bm"].reshape(1, 2, 300, 2, 1, N)
    c = f["Cm"].reshape(1, 2, 300, 2, 1, N) * gy.reshape(1, 2, 300, 2, 4)[..., None]
    h, g = np.zeros((1, 2, 2, 4, N)), np.zeros((1, 2, 2, 4, N))
    for l in range(300):
        h = decay[:, :, l] * h + x[:, :, l]
        g = c[:, :, 299 - l] + (decay[:, :, 300 - l] * g if l else 0.0)
    # kernel layout: row (b * G + g) * S + s, then (N, Cg)
    rows = lambda t: t.transpose(0, 2, 1, 4, 3).reshape(4, N, 4)
    assert _rel(hend.numpy(), rows(h)) <= 1e-5
    assert _rel(gloc.numpy(), rows(g)) <= 1e-5
    assert _rel(csum.numpy(), dt.sum(2).transpose(0, 2, 1, 3).reshape(4, 4)) <= 1e-5


def test_seg_count():
    """A power of two dividing L; 1 below SEG_MIN_L; segments no shorter
    than SEG_MIN_K; the rows' 16-channel units (BLOCK_CHANNELS: two warps
    of the sweeps' 4-warp, 32-channel blocks) no more than
    SEG_TARGET_BLOCKS; and the S that CD-Mamba's scan shapes take (the
    shipped route that the card's A/B measures)."""
    shipped = {(64, 65536, 32): 32, (32, 65536, 32): 64, (64, 16384, 64): 16,
               (32, 16384, 64): 16, (64, 4096, 128): 4, (32, 4096, 128): 4,
               (64, 1024, 256): 1, (3, 40000, 20): 32}
    for (rows, L, Cg), want in shipped.items():
        S = scan.seg_count(rows, L, Cg)
        assert S == want
        assert S >= 1 and S & (S - 1) == 0 and L % S == 0
        if L < scan.SEG_MIN_L:
            assert S == 1
        if S > 1:
            assert L // S >= scan.SEG_MIN_K
            assert rows * S * -(-Cg // scan.BLOCK_CHANNELS) <= scan.SEG_TARGET_BLOCKS


def test_selective_scan_step_matches_jax_and_full_scan():
    """Token by token against JAX's `selective_scan_step` and against the
    whole-sequence plain scan (the decode path's contract)."""
    inp = _inputs(50, B=2, L=19, G=2, Cg=6)
    args = _torch(inp)
    full = scan.selective_scan_plain(*args, delta_softplus=True)
    u, delta, A, Bm, Cm, D, bias = args
    h = torch.zeros(2, 12, N)
    ys = []
    j = [jnp.asarray(inp[k]) for k in ORDER]
    hj = jnp.zeros((2, 12, N), jnp.float32)
    for t in range(19):
        y, h = scan.selective_scan_step(h, u[:, t], delta[:, t], A, Bm[:, t], Cm[:, t], D, bias,
                                        delta_softplus=True)
        yj, hj = jscan.selective_scan_step(hj, j[0][:, t], j[1][:, t], j[2], j[3][:, t],
                                           j[4][:, t], j[5], j[6], delta_softplus=True)
        assert _rel(y.numpy(), yj) <= 1e-5 and _rel(h.numpy(), hj) <= 1e-5
        ys.append(y)
    assert _rel(torch.stack(ys, 1).numpy(), full.numpy()) <= 1e-5


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("flat", [True, False], ids=["flat", "grouped"])
def test_scan_ckpt_plain_matches_jax_steps(flat, S):
    """The plain I-ckpt (`scan_ckpt_plain`, which the card holds kernels
    I-ckpt and H-ckpt against) against JAX's `selective_scan_step` iterated
    step by step: the state before every 16th step of each of the S
    segments of 100 steps, each segment from its own seeded state h0;
    Cg = 40, G = 2, in the flat and the grouped layout; 1e-5."""
    B, L, G, Cg = 2, 100, 2, 40
    inp = _inputs(60, B=B, L=L, G=G, Cg=Cg)
    K = L // S
    h0 = np.random.default_rng(61).normal(size=(B * G * S, N, Cg)).astype(np.float32)
    step = jax.jit(lambda h, u, d, Bv, Cv: jscan.selective_scan_step(
        h, u, d, jnp.asarray(inp["A"]), Bv, Cv, jnp.asarray(inp["D"]), jnp.asarray(inp["bias"]),
        delta_softplus=True)[1])
    want = []
    for s in range(S):            # the state (B, G*Cg, N) of segment s from its own h0
        h = jnp.asarray(h0.reshape(B, G, S, N, Cg)[:, :, s].transpose(0, 1, 3, 2)
                        .reshape(B, G * Cg, N))
        states = []
        for t in range(s * K, (s + 1) * K):
            if (t - s * K) % 16 == 0:
                states.append(np.asarray(h))
            h = step(h, inp["u"][:, t], inp["delta"][:, t], inp["Bm"][:, t], inp["Cm"][:, t])
        # (B, chunks, G*Cg, N) -> (B, G, chunks, N, Cg)
        want.append(np.stack(states, 1).reshape(B, -1, G, Cg, N).transpose(0, 2, 1, 4, 3))
    want = np.stack(want, 2).reshape(B * G * S, -1, N, Cg)
    args = _torch(inp)
    if not flat:                  # the same values in the grouped layout
        args = [args[0].reshape(B, L, G, Cg).transpose(1, 2),
                args[1].reshape(B, L, G, Cg).transpose(1, 2), args[2],
                args[3].transpose(1, 2), args[4].transpose(1, 2), args[5], args[6]]
    a = scan._Args(*args, flat=flat)
    got = scan.scan_ckpt_plain(a, S, torch.from_numpy(h0))
    assert got.shape == want.shape == (B * G * S, -(-K // 16), N, Cg)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("C,K", [(8, 4), (12, 3)])
def test_causal_conv1d_matches_jax(C, K):
    """Depthwise causal conv, the reference's conv1d layout (C, 1, K)
    against JAX's (K, 1, C) kernel, bias added after as JAX does."""
    rng = np.random.default_rng(C)
    x = rng.normal(size=(2, 17, C)).astype(np.float32)
    w = rng.normal(size=(C, 1, K)).astype(np.float32)
    b = rng.normal(size=(C,)).astype(np.float32)
    want = np.asarray(jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w.transpose(2, 1, 0)),
                                          groups=C)) + b
    got = convops.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                groups=C).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    bf = convops.causal_conv1d(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                               groups=C)
    assert bf.dtype == torch.bfloat16      # x's dtype out, as JAX keeps it


@pytest.mark.parametrize("src,dst", [(4, 8), (16, 32), (5, 10), (6, 4)])
def test_resize_nearest_and_max_pool_match_jax(src, dst):
    """CD-Mamba's decoder upsampling (x2) and encoder pooling (2x2): the
    floor rule of nearest resize, and max pooling, exact."""
    x = np.random.default_rng(src).normal(size=(2, src, src, 3)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    want = np.asarray(jresize.resize_nearest(jnp.asarray(x), (dst, dst), (1, 2)))
    got = resize.resize_nearest(xt, (dst, dst)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)
    if src % 2 == 0:
        want = np.asarray(jpool.max_pool(jnp.asarray(x), 2, 2))
        np.testing.assert_array_equal(pooling.max_pool(xt, 2, 2).permute(0, 2, 3, 1).numpy(),
                                      want)
