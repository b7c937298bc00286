#!/usr/bin/env python
"""Drive the PyTorch/CUDA port of SMOW_Net on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no result line is printed):
  1. card name and power limit (nvidia-smi); TF32 off for the fp32 phases
  2. build the hand-written kernels (smow_net_tpu_torch/csrc, nvcc sm_90a)
  3. kernel D (token scatter) vs its plain version: fp32 and bf16 at
     (32, 128, 128, 8), a logit spread > 87 (zaw underflow), C = 16
  3b. the token chain's train kernels vs their plain versions, same cases:
     E (D plus the eaw residual), C (`grid_sample_t_vjp`), A-bwd
     (`grid_sample_bwd`); then the whole `token_softmax_scatter` VJP
     (da, dflow), kernel path vs plain path, in fp32
  4. kernel F (decoder layer) vs its plain version: (16, 16384, 128),
     h = 8, M = 8, hidden 256, with and without the lane permutation
  4b. kernel F-bwd vs torch.autograd.grad of the plain layer: all 14 input
     gradients at (16, 16384, 128) with and without the permutation, fp32
     and bf16, and the ragged N = 1000
  5. main path: get_model("smow_net") with numpy-seeded weights in bf16,
     make_eval_step over 3 batches of 16 x 256^2 pairs; each kernel's launch
     count must rise by exactly one per batch; then ms/batch (CUDA events)
     of the kernel path and of the same model forced through the plain ops,
     in alternating rounds; then torch.profiler over 3 kernel-path batches:
     the device's busy time per batch, and the profiler table written to
     chiprun_out/profile/
  6. whole model in fp32, kernel path vs plain path, batch 2 at 256^2
  7. main path, training: get_model("smow_net") with numpy-seeded fp32
     master weights, make_optimizer(cosine) and make_train_step with bf16
     compute, 6 steps on one repeated batch of 16 x 256^2 pairs: the loss
     finite and falling, the parameters fp32, finite and changed, the BN
     running statistics moved, and each train kernel (E, C, A-bwd, F, F-bwd)
     launched exactly once per step; then ms/step of the kernel path and the
     plain path in alternating rounds, and torch.profiler over 3 steps
     (its table beside phase 5's)
  8. whole-model fp32 train gradients (TF32 off), kernel path vs plain
     path, batch 2 at 256^2
  9. the kernels' JSON line, then the result line as the last line

Bounds: fp32 kernels against fp32 plain versions differ only in summation
order (atomics in D, E and A-bwd, a different reduction order in C, F and
F-bwd): 1e-5 of the largest output, 1e-4 where a sum runs over many rows
or the atomics contend (F-bwd's weight gradients, the token chain's whole
VJP). bf16 kernels compute in fp32 and round once on output, so they are
held against the plain version run in fp32 on the same bf16 inputs, to one
bf16 rounding (2^-8 relative) of the largest output.

Each kernel's `bound_ms` is the least time the card could take for its
work at the timed shape (bf16): the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its FLOPs over 989
TFLOP/s (the H100 SXM data sheet, bf16 dense).

"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

BF16_REL = 2.0 ** -8
PROFILE_DIR = os.path.join("chiprun_out", "profile")


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(label: str, got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float) -> float:
    """max |got - want| against atol + rtol * max |want|; raises if above."""
    got, want = got.float(), want.float()
    require(got.shape == want.shape, f"{label}: shape {got.shape} != {want.shape}")
    require(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    err = (got - want).abs().max().item()
    bound = atol + rtol * want.abs().max().item()
    log(f"  {label}: max_abs_err {err:.3e} (bound {bound:.3e})")
    require(err <= bound, f"{label}: max_abs_err {err} exceeds {bound}")
    return err


HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def bound(n_bytes: float, flops: float) -> dict:
    """bound_ms and bound_by for work of `n_bytes` and `flops` in bf16."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def device_events(averages):
    """The profiler's kernels on the card; a user annotation's range (the
    optimizer's step) also shows as a device event, and counting it would
    count its kernels twice."""
    return [e for e in averages
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


@contextlib.contextmanager
def plain_ops():
    """Route the model's kernel ops through their plain versions (for timing
    and the fp32 comparisons only; the model never does this): the token
    chain's three ops and the decoder layer, whose plain version then runs
    under torch autograd."""
    from smow_net_tpu_torch.ops import warp, xattn

    names = ("token_scatter", "grid_sample_t_vjp", "grid_sample_bwd")
    saved = [getattr(warp, n) for n in names], xattn.cross_layer_head1
    for n in names:
        setattr(warp, n, getattr(warp, n + "_plain"))
    xattn.cross_layer_head1 = xattn.cross_layer_head1_plain
    try:
        yield
    finally:
        for n, f in zip(names, saved[0]):
            setattr(warp, n, f)
        xattn.cross_layer_head1 = saved[1]


def phase_kernel_d(dev) -> dict:
    from smow_net_tpu_torch.ops import warp

    log("phase 3: kernel D token_scatter_fwd vs token_scatter_plain")
    rng = np.random.default_rng(3)
    result = {}

    def case(label, shape, spike=False):
        F_, H, W, C = shape
        a = torch.from_numpy((rng.normal(size=shape) * 2.0).astype(np.float32)).to(dev)
        flow = torch.from_numpy((rng.normal(size=(F_, H, W, 2)) * 3.0).astype(np.float32))
        if spike:   # spike along the left column; the grid samples only the right one
            a[:, :, 0, 0] = 150.0
            flow[..., 0] = 3.0 * W
        grid = warp.flow_grid(flow.to(dev), H, W)
        for dt in (torch.float32, torch.bfloat16):
            x = a.to(dt)
            m = x.amax(dim=(1, 2)).float()
            ew, zaw = warp.token_scatter(x, grid, m)
            ew_p, zaw_p = warp.token_scatter_plain(x.float(), grid, m)
            rtol = 1e-5 if dt == torch.float32 else BF16_REL
            name = f"{label} {str(dt)[6:]}"
            err = max(check(name + " ew", ew, ew_p, 1e-5, rtol),
                      check(name + " zaw", zaw, zaw_p, 1e-5, rtol))
            if spike:
                require(bool((zaw[:, 0] == 0).all() and (zaw_p[:, 0] == 0).all()),
                        "large-spread case: zaw of the spiked channel must underflow to 0")
                require(bool(torch.isfinite(ew / zaw.clamp_min(1e-30)[:, None, None, :]).all()),
                        "large-spread case: ew / max(zaw, 1e-30) must be finite")
            if label == "slice" and dt == torch.bfloat16:
                result["max_abs_err"] = err
                result["ms"] = cuda_ms(lambda: warp.token_scatter(x, grid, m))
                result["plain_ms"] = cuda_ms(lambda: warp.token_scatter_plain(x, grid, m))
                result.update(bound(nbytes(x, grid, m, ew, zaw), 18 * x.numel()),
                              library_ms=None)
                log(f"  slice bf16 time: kernel {result['ms']:.4f} ms, "
                    f"plain {result['plain_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms")

    case("slice", (32, 128, 128, 8))
    case("spread>87", (32, 128, 128, 8), spike=True)
    case("W*C=2048", (32, 128, 128, 16))
    return result


def _token_inputs(dev, shape, seed, spike=False):
    """Logits a, the flow grid, and two cotangent-like tensors, numpy-seeded;
    with `spike`, a logit spike > 87 on the left column that the grid never
    samples (the zaw underflow case)."""
    from smow_net_tpu_torch.ops import warp

    rng = np.random.default_rng(seed)
    F_, H, W, C = shape
    a = (rng.normal(size=shape) * 2.0).astype(np.float32)
    flow = (rng.normal(size=(F_, H, W, 2)) * 3.0).astype(np.float32)
    if spike:
        a[:, :, 0, 0] = 150.0
        flow[..., 0] = 3.0 * W
    r, s = (torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(dev)
            for sh in (shape, (F_, C)))
    flow = torch.from_numpy(flow).to(dev)
    return torch.from_numpy(a).to(dev), flow, warp.flow_grid(flow, H, W), r, s


def phase_token_backward(dev) -> dict:
    """Kernels E, C and A-bwd against their plain versions, then the whole
    token-chain VJP on the kernel path against the plain path."""
    from smow_net_tpu_torch.ops import warp

    log("phase 3b: token chain train kernels E, C, A-bwd vs their plain versions")
    results = {"token_scatter_fwd_eaw": {}, "grid_sample_t_vjp": {}, "grid_sample_bwd": {}}

    def case(label, shape, spike=False):
        a, flow, grid, r, _ = _token_inputs(dev, shape, 30, spike)
        for dt in (torch.float32, torch.bfloat16):
            x, xbar = a.to(dt), r.to(dt)
            rtol = 1e-5 if dt == torch.float32 else BF16_REL
            name = f"{label} {str(dt)[6:]}"
            m = x.amax(dim=(1, 2)).float()
            got = warp.token_scatter(x, grid, m, residual=True)
            want = warp.token_scatter_plain(x.float(), grid, m, residual=True)
            err_e = max(check(f"E {name} {part}", g, w, 1e-5, rtol)
                        for part, g, w in zip(("ew", "zaw", "eaw"), got, want))
            eaw = got[2]
            dg, dw_c = warp.grid_sample_t_vjp(xbar, eaw, grid)
            dg_p, dw_c_p = warp.grid_sample_t_vjp_plain(xbar.float(), eaw.float(), grid)
            err_c = max(check(f"C {name} dg", dg, dg_p, 1e-5, rtol),
                        check(f"C {name} dw", dw_c, dw_c_p, 1e-5, 1e-5))
            daw = ((dg.float() + 1.0) * eaw.float()).to(dt)
            da, dw_a = warp.grid_sample_bwd(x, daw, grid)
            da_p, dw_a_p = warp.grid_sample_bwd_plain(x.float(), daw.float(), grid)
            err_a = max(check(f"A-bwd {name} dx", da, da_p, 1e-5, rtol),
                        check(f"A-bwd {name} dw", dw_a, dw_a_p, 1e-5, 1e-5))
            if spike:
                require(bool((got[1][:, 0] == 0).all() and (eaw[..., 0] == 0).all()),
                        "large-spread case: zaw and eaw of the spiked channel must be 0")
                require(bool((daw[..., 0] == 0).all()),
                        "large-spread case: daw = (dg + dzaw) eaw must be 0 there")
            if label == "slice" and dt == torch.bfloat16:
                e, c, ab = (results[k] for k in results)
                e.update(max_abs_err=err_e, library_ms=None,
                         ms=cuda_ms(lambda: warp.token_scatter(x, grid, m, residual=True)),
                         plain_ms=cuda_ms(lambda: warp.token_scatter_plain(
                             x, grid, m, residual=True)),
                         **bound(nbytes(x, grid, m, *got), 18 * x.numel()))
                c.update(max_abs_err=err_c, library_ms=None,
                         ms=cuda_ms(lambda: warp.grid_sample_t_vjp(xbar, eaw, grid)),
                         plain_ms=cuda_ms(lambda: warp.grid_sample_t_vjp_plain(
                             xbar, eaw, grid)),
                         **bound(nbytes(xbar, eaw, grid, dg, dw_c), 26 * x.numel()))
                # the one PyTorch call for A-bwd's function: the backward of
                # F.grid_sample (bilinear, border, align_corners) in NCHW,
                # which returns dgrid where A-bwd returns the weight rows
                x_nchw = x.permute(0, 3, 1, 2).contiguous()
                g_nchw = daw.permute(0, 3, 1, 2).contiguous()
                grid_dt = grid.to(dt)
                ab.update(max_abs_err=err_a,
                          ms=cuda_ms(lambda: warp.grid_sample_bwd(x, daw, grid)),
                          plain_ms=cuda_ms(lambda: warp.grid_sample_bwd_plain(x, daw, grid)),
                          library_ms=cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                              g_nchw, x_nchw, grid_dt, 0, 1, True, [True, True])),
                          **bound(nbytes(x, daw, grid, da, dw_a), 26 * x.numel()))
                for k, v in results.items():
                    log(f"  slice bf16 time {k}: kernel {v['ms']:.4f} ms, plain "
                        f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms"
                        + ("" if v["library_ms"] is None
                           else f", library {v['library_ms']:.4f} ms (NCHW)"))

    case("slice", (32, 128, 128, 8))
    case("spread>87", (32, 128, 128, 8), spike=True)
    case("W*C=2048", (32, 128, 128, 16))

    log("  token_softmax_scatter VJP, fp32: kernel path vs plain path (bound 1e-4 "
        "of the largest element: atomics order, and dgrid = dw1 - dw0 cancels)")
    for label, spike in (("slice", False), ("spread>87", True)):
        a, flow, _, r, s = _token_inputs(dev, (32, 128, 128, 8), 31, spike)

        def grads():
            at, ft = a.clone().requires_grad_(), flow.clone().requires_grad_()
            ew, zaw = warp.token_softmax_scatter(at, ft)
            return torch.autograd.grad((ew * r).sum() + (zaw * s).sum(), (at, ft))

        got = grads()
        with plain_ops():
            want = grads()
        for part, g, w in zip(("da", "dflow"), got, want):
            check(f"{label} {part}", g, w, 1e-6, 1e-4)
    return results


def _layer_args(dev, B, N, D=128, h=8, M=8, hid=256, seed=4):
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    return [f(B, N, D), f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, h, scale=0.1),
            f(B, M, h), f(B, M, h), f(h, D, scale=0.1), f(D, scale=0.1),
            f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, hid, scale=D ** -0.5),
            f(hid, scale=0.1), f(hid, D, scale=hid ** -0.5), f(D, scale=0.1)]


def _layer_flops(B, N, D, h=8, M=8, hid=256, mlp_products=2):
    """FLOPs of the decoder layer per call: per row the MLP's products of
    D x hid (2 in the forward; the backward's minimum is 5: h, dhg, dyn,
    dw1, dw2), plus the projections, attention, LayerNorms and GELU."""
    return B * N * (mlp_products * 2 * D * hid + 4 * D * h + 6 * h * M + 16 * D + 20 * hid)


def _decoder_perm(dev, D=128, T=4):
    t_idx, c_idx = np.divmod(np.arange(D), D // T)
    p = np.zeros((D, D), np.float32)
    p[np.arange(D), c_idx * T + t_idx] = 1.0
    return torch.from_numpy(p).to(dev)


def phase_kernel_f(dev) -> dict:
    from smow_net_tpu_torch.ops import xattn

    log("phase 4: kernel F xattn_layer_fwd vs cross_layer_head1_plain")
    result = {}
    scale = 128 ** -0.5
    args32 = _layer_args(dev, 16, 16384)
    for use_perm in (False, True):
        perm = _decoder_perm(dev) if use_perm else None
        for dt in (torch.float32, torch.bfloat16):
            # weights too at bf16 values, so the fp32 plain run sees the same numbers
            args = [a.to(dt) for a in args32]
            out = xattn.cross_layer_head1(*args, scale=scale, perm=perm)
            want = xattn.cross_layer_head1_plain(*[a.float() for a in args], scale=scale,
                                                 perm=perm)
            name = f"(16,16384,128) perm={use_perm} {str(dt)[6:]}"
            if dt == torch.float32:
                err = check(name, out, want, 1e-4, 1e-5)
            else:
                err = check(name, out, want, 1e-4, BF16_REL)
                plain16 = xattn.cross_layer_head1_plain(*args, scale=scale, perm=perm)
                log(f"  (info) plain bf16 vs plain fp32: max_abs "
                    f"{(plain16.float() - want).abs().max().item():.3e}")
                if not use_perm:
                    result["max_abs_err"] = err
                    result["ms"] = cuda_ms(lambda: xattn.cross_layer_head1(
                        *args, scale=scale))
                    result["plain_ms"] = cuda_ms(lambda: xattn.cross_layer_head1_plain(
                        *args, scale=scale))
                    weights = [a.float() for a in args[1:]]
                    result.update(bound(nbytes(args[0], out, *weights),
                                        _layer_flops(*args[0].shape)), library_ms=None)
                    log(f"  bf16 time: kernel {result['ms']:.4f} ms, "
                        f"plain {result['plain_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms")
    # ragged tail: N not a multiple of the kernel's 64-row tile
    args = _layer_args(dev, 2, 1000, seed=5)
    check("ragged (2,1000,128) fp32", xattn.cross_layer_head1(*args, scale=scale),
          xattn.cross_layer_head1_plain(*args, scale=scale), 1e-4, 1e-5)
    # what the decoder pays to reach (B, N, D) rows from NCDHW before kernel F
    y = torch.randn(16, 32, 4, 128, 128, device=dev, dtype=torch.bfloat16)
    t_ms = cuda_ms(lambda: y.reshape(16, 128, 16384).transpose(1, 2).contiguous())
    log(f"  (info) NCDHW -> (B, N, D) transpose before kernel F, bf16 bs16: {t_ms:.4f} ms")
    return result


def phase_kernel_f_bwd(dev) -> dict:
    """Kernel F-bwd: the 14 input gradients against torch.autograd.grad of
    the plain layer in fp32 on the same inputs."""
    from smow_net_tpu_torch.ops import xattn

    log("phase 4b: kernel F-bwd xattn_layer_bwd vs autograd of cross_layer_head1_plain")
    names = ("x", "ln1_scale", "ln1_bias", "wq", "k", "v", "w_out", "b_out",
             "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")
    scale = 128 ** -0.5
    result = {}

    def compare(label, args32, gy32, perm, dt):
        args = [a.to(dt).requires_grad_() for a in args32]
        gy = gy32.to(dt)
        got = torch.autograd.grad(xattn.cross_layer_head1(*args, scale=scale, perm=perm),
                                  args, gy)
        ref = [a.detach().float().requires_grad_() for a in args]
        want = torch.autograd.grad(
            xattn.cross_layer_head1_plain(*ref, scale=scale, perm=perm), ref, gy.float())
        rtol = 1e-4 if dt == torch.float32 else BF16_REL
        return max(check(f"{label} {str(dt)[6:]} d{n}", g, w, 1e-5, rtol)
                   for n, g, w in zip(names, got, want)), args, gy

    args32 = _layer_args(dev, 16, 16384)
    gy32 = torch.from_numpy(np.random.default_rng(6).normal(
        size=(16, 16384, 128)).astype(np.float32)).to(dev)
    for use_perm in (False, True):
        perm = _decoder_perm(dev) if use_perm else None
        for dt in (torch.float32, torch.bfloat16):
            err, args, gy = compare(f"(16,16384,128) perm={use_perm}", args32, gy32, perm, dt)
            if dt == torch.bfloat16 and not use_perm:
                result["max_abs_err"] = err
                result["ms"] = cuda_ms(lambda: xattn._layer_bwd(args, gy, scale, None, 1e-5))
                out = xattn.cross_layer_head1_plain(*args, scale=scale)
                result["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    out, args, gy, retain_graph=True))
                weights = [a.detach().float() for a in args[1:]]
                result.update(bound(nbytes(args[0], gy, args[0], *weights, *weights),
                                    _layer_flops(16, 16384, 128, mlp_products=5)),
                              library_ms=None)
                log(f"  bf16 time: kernel {result['ms']:.4f} ms, plain backward "
                    f"{result['plain_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms")
    compare("ragged (2,1000,128)", _layer_args(dev, 2, 1000, seed=5),
            torch.from_numpy(np.random.default_rng(7).normal(
                size=(2, 1000, 128)).astype(np.float32)).to(dev), None, torch.float32)
    return result


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Numpy-seeded values for every parameter and buffer: fan-in scaled
    weights (the zero/identity-initialised temporal mixers included, so every
    branch carries signal) and BN running statistics away from identity."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, v in model.state_dict().items():
        leaf, shape = key.rsplit(".", 1)[-1], tuple(v.shape)
        if leaf == "num_batches_tracked":
            sd[key] = v
            continue
        n = rng.normal(size=shape)
        if leaf == "running_var":
            val = rng.uniform(0.5, 1.5, size=shape)
        elif leaf == "weight" and len(shape) == 1:      # BN / LN scale
            val = 1.0 + 0.1 * n
        elif leaf == "weight":
            val = n / np.sqrt(shape[1] * int(np.prod(shape[2:], dtype=np.int64)))
        elif leaf == "pos_embedding":
            val = n
        else:                                            # biases, running means
            val = 0.1 * n
        sd[key] = torch.from_numpy(val.astype(np.float32))
    return sd


def make_batches(dev, count, batch, size, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        b = {"A": rng.normal(size=(batch, size, size, 3)),
             "B": rng.normal(size=(batch, size, size, 3)),
             "mask": (rng.random((batch, size, size)) > 0.9),
             "valid": np.ones(batch)}
        out.append({k: torch.from_numpy(np.asarray(v, np.float32)).to(dev) for k, v in b.items()})
    return out


def phase_main_path(dev) -> dict:
    from smow_net_tpu_torch.models import get_model
    from smow_net_tpu_torch.ops import _kernels
    from smow_net_tpu_torch.train.metrics import cm2score
    from smow_net_tpu_torch.train.trainer import make_eval_step

    log("phase 5: main path, SMOW_Net eval step, bf16, 3 batches of 16 x 256^2")
    model = get_model("smow_net")
    model.load_state_dict(seeded_state_dict(model, 0))
    model = model.to(torch.bfloat16)
    step = make_eval_step(model)
    batches = make_batches(dev, 3, 16, 256, seed=7)
    step(batches[0])                                     # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    names = ("token_scatter_fwd", "xattn_layer_fwd")
    _kernels.launches.clear()
    cm_total = torch.zeros(2, 2, device=dev)
    for i, batch in enumerate(batches):
        cm, loss, pred = step(batch)
        counts = {n: _kernels.launches[n] for n in names}
        require(all(c == i + 1 for c in counts.values()),
                f"launch counts {counts} after batch {i + 1}")
        require(pred.shape == (16, 256, 256) and bool(torch.isfinite(pred).all()),
                "predictions must be finite, (16, 256, 256)")
        require(float(pred.min()) >= 0.0 and float(pred.max()) <= 1.0,
                "predictions must lie in [0, 1]")
        require(bool(torch.isfinite(loss)) and float(cm.sum()) == 16 * 256 * 256,
                "loss must be finite and the confusion matrix count every pixel")
        cm_total += cm
        log(f"  batch {i}: loss {float(loss):.6f} cm {cm.tolist()} "
            f"pred mean {float(pred.mean()):.4f} std {float(pred.std()):.4f}")
    launches = {n: _kernels.launches[n] for n in names}
    log(f"  launches {launches}; cm2score {json.dumps(cm2score(cm_total))}")

    # timing: rounds of 5 batches (one untimed batch first), alternating the
    # kernel path and the plain path and flipping their order every round
    def round_ms(n=5):
        step(batches[0])
        torch.cuda.synchronize()
        out = []
        for i in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(batches[i % len(batches)])
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return out

    timing, wins = {"kernel": [], "plain": []}, 0
    for r in range(6):
        for path in (("kernel", "plain") if r % 2 == 0 else ("plain", "kernel")):
            if path == "plain":
                before = dict(_kernels.launches)
                with plain_ops():
                    timing[path].append(round_ms())
                require(dict(_kernels.launches) == before, "plain path launched a kernel")
            else:
                timing[path].append(round_ms())
        wins += int(np.median(timing["kernel"][-1]) < np.median(timing["plain"][-1]))
    medians = {}
    for path, rounds in timing.items():
        q1, medians[path], q3 = np.percentile(np.concatenate(rounds), [25, 50, 75])
        log(f"  {path} path ms/batch: median {medians[path]:.3f} (q1 {q1:.3f}, q3 {q3:.3f}, "
            f"{len(rounds)} rounds x 5)")
    log(f"  kernel path faster in {wins} of {len(timing['kernel'])} rounds")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            step(batch)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    on_device = device_events(averages)
    busy = sum(e.self_device_time_total for e in on_device) / 1e3 / len(batches)
    per_batch = sum(e.count for e in on_device) / len(batches)
    log(f"  profile: device busy {busy:.3f} ms/batch in {per_batch:.0f} kernels/batch, "
        f"{busy / medians['kernel']:.3f} of the unprofiled kernel-path median")
    os.makedirs(PROFILE_DIR, exist_ok=True)
    with open(os.path.join(PROFILE_DIR, "eval_bf16_bs16_profile.txt"), "w") as fh:
        fh.write(averages.table(sort_by="cuda_time_total", row_limit=40))
    log(f"  profile table written to {PROFILE_DIR}")
    return launches


def phase_fp32_model(dev) -> None:
    from smow_net_tpu_torch.models import get_model

    log("phase 6: whole model fp32 (TF32 off), kernel path vs plain path, batch 2, 256^2")
    model = get_model("smow_net")
    model.load_state_dict(seeded_state_dict(model, 0))
    model = model.eval()
    rng = np.random.default_rng(11)
    x1, x2 = (torch.from_numpy(rng.normal(size=(2, 3, 256, 256)).astype(np.float32)).to(dev)
              for _ in range(2))
    with torch.inference_mode():
        got = model(x1, x2)
        with plain_ops():
            want = model(x1, x2)
    require(got.shape == (2, 1, 256, 256), f"output shape {tuple(got.shape)}")
    log(f"  probabilities mean {float(want.mean()):.4f} std {float(want.std()):.4f}")
    # fp32 everywhere; the two paths differ only in the kernels' summation order
    check("SMOWNet fp32 probabilities", got, want, 1e-4, 0.0)


TRAIN_KERNELS = ("token_scatter_fwd_eaw", "grid_sample_t_vjp", "grid_sample_bwd",
                 "xattn_layer_fwd", "xattn_layer_bwd")


def _train_setup(compute_dtype, steps):
    from smow_net_tpu_torch.models import get_model
    from smow_net_tpu_torch.train.schedule import get_schedule
    from smow_net_tpu_torch.train.trainer import (create_train_state, make_optimizer,
                                                  make_train_step)

    model = get_model("smow_net")
    model.load_state_dict(seeded_state_dict(model, 0))
    opt = make_optimizer(get_schedule("cosine", 1e-4, epochs=1, iters_per_epoch=steps))(
        model.parameters())
    return model, create_train_state(model, opt), make_train_step(model, opt, compute_dtype)


def phase_train(dev) -> dict:
    from smow_net_tpu_torch.ops import _kernels

    log("phase 7: main path, SMOW_Net train step, bf16 compute over fp32 masters, "
        "6 steps on one repeated batch of 16 x 256^2")
    steps = 6
    model, state, step = _train_setup(torch.bfloat16, steps)
    batch = make_batches(dev, 1, 16, 256, seed=8)[0]
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.detach().clone() for n, b in model.named_buffers() if "running" in n}
    torch.cuda.synchronize()

    _kernels.launches.clear()
    losses = []
    for i in range(steps):
        losses.append(float(step(state, batch)))
        counts = {n: _kernels.launches[n] for n in TRAIN_KERNELS}
        require(all(c == i + 1 for c in counts.values()),
                 f"launch counts {counts} after train step {i + 1}")
        require(_kernels.launches["token_scatter_fwd"] == 0,
                "the train step must take kernel E, not the inference kernel D")
        log(f"  step {i}: loss {losses[-1]:.6f}")
    launches = {n: _kernels.launches[n] for n in TRAIN_KERNELS}
    log(f"  launches {launches}; cm {state.cm.tolist()}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"the loss must be finite and fall on a repeated batch: {losses}")
    still = []
    for n, p in model.named_parameters():
        require(p.dtype == torch.float32 and bool(torch.isfinite(p).all()),
                f"{n}: master parameters must stay fp32 and finite")
        if torch.equal(p.detach(), params0[n]):
            still.append(n)
    log(f"  {len(params0) - len(still)} of {len(params0)} parameter tensors changed; "
        f"unchanged: {still}")
    # a conv bias right before a train-mode BatchNorm has a zero gradient in
    # exact arithmetic, so it may not move; every other tensor must
    require(len(still) <= 0.1 * len(params0), "the parameters did not change")
    require(all(b.dtype == torch.float32 and not torch.equal(b, stats0[n])
                for n, b in model.named_buffers() if n in stats0),
            "every BN running statistic must stay fp32 and move")
    require(float(state.loss_count) == steps and float(state.cm.sum()) == steps * 16 * 256 ** 2,
            "the step must accumulate its metrics on the device")

    def round_ms(n=5):
        step(state, batch)
        torch.cuda.synchronize()
        out = []
        for _ in range(n):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, batch)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return out

    torch.cuda.reset_peak_memory_stats()
    timing, wins = {"kernel": [], "plain": []}, 0
    for r in range(4):
        for path in (("kernel", "plain") if r % 2 == 0 else ("plain", "kernel")):
            if path == "plain":
                before = dict(_kernels.launches)
                with plain_ops():
                    timing[path].append(round_ms())
                require(dict(_kernels.launches) == before, "plain path launched a kernel")
            else:
                timing[path].append(round_ms())
        wins += int(np.median(timing["kernel"][-1]) < np.median(timing["plain"][-1]))
    medians = {}
    for path, rounds in timing.items():
        q1, medians[path], q3 = np.percentile(np.concatenate(rounds), [25, 50, 75])
        log(f"  {path} path ms/step: median {medians[path]:.3f} (q1 {q1:.3f}, q3 {q3:.3f}, "
            f"{len(rounds)} rounds x 5)")
    log(f"  kernel path faster in {wins} of {len(timing['kernel'])} rounds; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(state, batch)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    on_device = device_events(averages)
    busy = sum(e.self_device_time_total for e in on_device) / 1e3 / 3
    per_step = sum(e.count for e in on_device) / 3
    log(f"  profile: device busy {busy:.3f} ms/step in {per_step:.0f} kernels/step, "
        f"{busy / medians['kernel']:.3f} of the unprofiled kernel-path median")
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"    {e.self_device_time_total / 1e3 / 3:8.3f} ms/step  {e.count // 3:4d}x  "
            f"{e.key[:90]}")
    os.makedirs(PROFILE_DIR, exist_ok=True)
    with open(os.path.join(PROFILE_DIR, "train_bf16_bs16_profile.txt"), "w") as fh:
        fh.write(averages.table(sort_by="cuda_time_total", row_limit=60))
    return launches


def phase_fp32_train_grads(dev) -> None:
    from smow_net_tpu_torch.models import get_model
    from smow_net_tpu_torch.train.loss import bce_dice_loss
    from smow_net_tpu_torch.train.trainer import select_pred

    log("phase 8: whole-model fp32 train gradients (TF32 off, deterministic cuDNN), "
        "kernel path vs plain path, batch 2, 256^2")
    model = get_model("smow_net")
    model.load_state_dict(seeded_state_dict(model, 0))
    model.train()
    batch = make_batches(dev, 1, 2, 256, seed=12)[0]
    x1, x2 = (batch[k].permute(0, 3, 1, 2) for k in ("A", "B"))

    def grads():
        model.zero_grad(set_to_none=True)
        loss = bce_dice_loss(select_pred(model(x1, x2)).float(), batch["mask"])
        loss.backward()
        return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()}

    # ConvTranspose3d's forward is cuDNN's backward-data, whose default
    # algorithms add with atomics: run to run, an activation next to a
    # LeakyReLU kink could take the other branch. Deterministic algorithms
    # keep the two paths' forward identical outside the kernels' ops.
    torch.backends.cudnn.deterministic = True
    try:
        loss_k, got = grads()
        with plain_ops():
            loss_p, want = grads()
            _, again = grads()
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"  loss kernel path {loss_k:.7f}, plain path {loss_p:.7f}")
    require(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), "the two paths' losses differ")
    largest = max(float(w.abs().max()) for w in want.values())
    rows = []
    for n, w in want.items():
        require(bool(torch.isfinite(got[n]).all()), f"{n}: non-finite gradient")
        # leaves whose gradient is zero in exact arithmetic (a conv bias right
        # before a train-mode BatchNorm) are held to the model's largest one
        scale = float(w.abs().max())
        ref = scale if scale >= 1e-6 * largest else largest
        rows.append((float((got[n] - w).abs().max()) / ref,
                     float((again[n] - w).abs().max()) / ref, n))
    rows.sort(reverse=True)
    for err, noise, n in rows[:5]:
        log(f"  {n}: kernel vs plain {err:.3e}, plain vs plain {noise:.3e} of its largest element")
    worst_noise = max(r[1] for r in rows)
    log(f"  worst plain-vs-plain spread over all leaves: {worst_noise:.3e}")
    require(rows[0][0] <= 1e-3, f"{rows[0][2]}: gradient differs by {rows[0][0]:.3e} of its "
            "largest element (bound 1e-3: fp32 sums in other orders and atomics)")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs the port on an NVIDIA GPU")
    from smow_net_tpu_torch.ops import _kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log("phase 1: card (nvidia-smi --query-gpu=name,power.limit):")
    log(smi.stdout.strip())
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.library()
    log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.2f} s: {path.name}")
    for line in _kernels.build_report.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("  ptxas " + line.strip())

    d = phase_kernel_d(dev)
    tok = phase_token_backward(dev)
    f = phase_kernel_f(dev)
    fb = phase_kernel_f_bwd(dev)
    launches = phase_main_path(dev)
    phase_fp32_model(dev)
    train_launches = phase_train(dev)
    phase_fp32_train_grads(dev)

    log("phase 9: results (launches: D and F from the eval path of phase 5, the train "
        f"kernels from phase 7; F in phase 7: {train_launches['xattn_layer_fwd']})")
    csrc, pallas = "smow_net_tpu_torch/csrc/", "smow_net_tpu/ops/pallas/"
    kernels = [
        dict(name="token_scatter_fwd", route="cuda", source=csrc + "token_scatter.cu",
             replaces=pallas + "warp.py:781", launches=launches["token_scatter_fwd"], **d),
        dict(name="xattn_layer_fwd", route="cuda", source=csrc + "xattn_layer.cu",
             replaces=pallas + "xattn.py:609", launches=launches["xattn_layer_fwd"], **f),
        dict(name="token_scatter_fwd_eaw", route="cuda", source=csrc + "token_scatter.cu",
             replaces=pallas + "warp.py:928",
             launches=train_launches["token_scatter_fwd_eaw"], **tok["token_scatter_fwd_eaw"]),
        dict(name="grid_sample_t_vjp", route="cuda", source=csrc + "grid_sample_t_vjp.cu",
             replaces=pallas + "warp.py:954",
             launches=train_launches["grid_sample_t_vjp"], **tok["grid_sample_t_vjp"]),
        dict(name="grid_sample_bwd", route="cuda", source=csrc + "grid_sample_bwd.cu",
             replaces=pallas + "warp.py:989",
             launches=train_launches["grid_sample_bwd"], **tok["grid_sample_bwd"]),
        dict(name="xattn_layer_bwd", route="cuda", source=csrc + "xattn_layer_bwd.cu",
             replaces=pallas + "xattn.py:633",
             launches=train_launches["xattn_layer_bwd"], **fb),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
