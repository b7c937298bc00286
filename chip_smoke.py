#!/usr/bin/env python
"""Drive the PyTorch/CUDA port of SMOW_Net, SMOW_Net_LW and ChangeMamba on
one NVIDIA GPU and check it.

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
  3c. kernels A-fwd (`grid_sample`) and B (`grid_sample_transpose`) vs their
     plain versions, fp32 and bf16, at (32, 128, 128, 8) (SMOW_Net_LW's
     token chain), with border-clamped flows, and C = 16
  3d. the unfused token chain's VJP (da, dflow), kernel path vs plain path,
     fp32; then the hybrid and the unfused chain timed, forward plus
     backward, bf16 at (32, 128, 128, 8)
  4. kernel F (decoder layer) vs its plain version: (16, 16384, D), h = 8,
     M = 8, hidden 2D, with and without the lane permutation, at D = 128
     (SMOW_Net) and D = 64 (SMOW_Net_LW), and the ragged N = 1000
  4b. kernel F-bwd vs torch.autograd.grad of the plain layer: all 14 input
     gradients at (16, 16384, D) with and without the permutation, fp32
     and bf16, and the ragged N = 1000, at D = 128 and D = 64
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
  9-12. phases 5-8 for get_model("smow_net_lw"): the eval step (D and F at
     D = 64 once per batch), the fp32 model, the train step (A-fwd, B, C,
     A-bwd, F and F-bwd at D = 64 once per step, D and E never) and its
     fp32 gradients
  13. kernel I-fwd (`selective_scan_fwd`) vs `cross_selective_scan_plain`,
     fp32 and bf16, at (B, K, L, Dk) = (32, 4, 4096, 192), (32, 4, 256, 768),
     (16, 4, 8192, 256) and (2, 4, 1000, 200) (Dk not a multiple of the
     16-channel blocks, L not of the 16-step chunks); then its time summed
     over the 27 calls of one ChangeMamba forward at 16 x 256^2, bf16
  14. kernel I-ckpt's chunk-start states vs a plain step-by-step loop, and
     I-ckpt + I-bwd (with the epilogue) vs torch.autograd.grad of the plain
     version: all seven input gradients at (32, 4, 1024, 384) and
     (16, 4, 8192, 256), fp32; then I-ckpt's and I-bwd's times summed over
     the 27 calls of one train step, bf16
  15-18. phases 5-8 for get_model("change_mamba") (16 x 256^2, batch 16;
     numpy-seeded weights with A_logs, Ds and dt_projs_bias perturbed around
     the reference's initialisation): the eval step (I-fwd 27 times per
     batch), the fp32 model, the train step (I-fwd, I-ckpt and I-bwd 27
     times per step, no other kernel) and its fp32 gradients, every pass
     drawing the same DropPath masks (the generator reseeded before each).
     The gradients are held at 1e-3 against a reference that runs I-fwd
     forward and the plain version's backward (its forward is bitwise the
     kernel path's: the plain scan's ulp-level differences move a decoder
     ReLU across its kink and whole leaves by ~1e-2), and against the
     strict plain path: its loss to 1e-5, its worst leaf to 4x the spread
     that a +-1e-6 nudge of the plain scan's output causes
  19. the kernels' JSON line, the card's line, then the result line last

Bounds: fp32 kernels against fp32 plain versions differ only in summation
order (atomics in D, E, A-bwd and B, a different reduction order in A-fwd,
C, F and F-bwd): 1e-5 of the largest output, 1e-4 where a sum runs over
many rows or the atomics contend (F-bwd's weight gradients, the token
chain's whole VJP). bf16 kernels compute in fp32 and round once on output,
so they are held against the plain version run in fp32 on the same bf16
inputs, to one bf16 rounding (2^-8 relative) of the largest output.

Times: a warp kernel's device time (D, E, C, A-bwd, A-fwd, B, each 0.02-0.3
ms) is taken from a CUDA graph of 20 calls of its wrapper, replayed and
timed with CUDA events, so the host's Python and ctypes overhead is out of
the reading (as are their plain versions and the library calls); the
profiler's time of the kernel alone is logged beside it. The decoder
layer's kernels (0.5-7 ms) are timed with CUDA events over 20 calls.

Each kernel's `bound_ms` is the least time the card could take for its
work at the timed shape (bf16): the larger of its bytes (each input read
once, each output written once) over 3.35 TB/s and its FLOPs over 989
TFLOP/s (the H100 SXM data sheet, bf16 dense). Kernel I's arithmetic is
fp32 outside the tensor cores, and one exp per state update: its bound is
the largest of the bytes term, its FLOPs over 67 TFLOP/s (fp32, the data
sheet) and its exps (and the softplus's exp and log) over the
multi-function units' rate, 16 per clock per SM x the SMs x the card's
maximum SM clock (nvidia-smi clocks.max.sm), printed by the run.

I-fwd, I-ckpt and I-bwd are timed at every shape ChangeMamba gives them
(CUDA events over 5 calls), and their rows carry the sums over one
forward's 27 calls (one train step's for I-ckpt and I-bwd), with the bound
of the same work. Their plain times: the plain scan (no grad) for I-fwd and
for I-ckpt (it computes the states I-ckpt keeps); for I-bwd the plain
backward (autograd through the checkpointed plain scan, which recomputes
each chunk), timed as forward + backward less the forward with its graph.

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


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one call of `fn`: a CUDA graph of `iters` calls
    (captured after warm-up on a side stream), replayed `replays` times
    between CUDA events. The host's per-call overhead is out of the reading;
    launch gaps inside the graph stay in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def kernel_only_ms(fn, kernel: str, iters: int = 20, sessions: int = 4) -> float:
    """The profiler's device time per call of the CUDA kernels whose name
    contains `kernel` (the kernel alone, without its wrapper's memset and
    cast), over `iters` calls of `fn`.

    A profiler session on the H100 has come back once without the records of
    a 20-call run of an 11 us kernel (C, phase 3b), although the kernel ran
    and its result was held against the plain version. Such a session is
    logged and the run profiled again, up to `sessions` times; a kernel that
    no session sees fails the script."""
    fn()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in device_events(prof.key_averages()) if kernel in e.key]
        if events:
            return sum(e.self_device_time_total for e in events) / 1e3 / iters
        seen = sorted({e.key[:60] for e in device_events(prof.key_averages())})
        log(f"  profiler session {session} of {sessions} saw no kernel named like "
            f"{kernel} (its device events: {seen or 'none'})")
    raise RuntimeError(f"the profiler saw no kernel named like {kernel} in {sessions} sessions")


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
    chains' five ops, the decoder layer and the selective scan, whose plain
    versions then run under torch autograd."""
    from smow_net_tpu_torch.ops import scan, warp, xattn

    names = ("token_scatter", "grid_sample_t_vjp", "grid_sample_bwd", "grid_sample",
             "grid_sample_transpose")
    saved = ([getattr(warp, n) for n in names], xattn.cross_layer_head1,
             scan.cross_selective_scan)
    for n in names:
        setattr(warp, n, getattr(warp, n + "_plain"))
    xattn.cross_layer_head1 = xattn.cross_layer_head1_plain
    scan.cross_selective_scan = scan.cross_selective_scan_plain
    try:
        yield
    finally:
        for n, f in zip(names, saved[0]):
            setattr(warp, n, f)
        xattn.cross_layer_head1 = saved[1]
        scan.cross_selective_scan = saved[2]


class _KernelValuePlainGrad(torch.autograd.Function):
    """The selective scan with kernel I-fwd's output and the plain version's
    gradient (torch autograd through cross_selective_scan_plain at the same
    inputs): the reference of phase 18, whose forward is then bitwise the
    kernel path's, so no ReLU of the decoder sits on the other side of its
    kink."""

    @staticmethod
    def forward(ctx, xs, dts, A, Bs, Cs, Ds, dt_bias):
        from smow_net_tpu_torch.ops import scan

        ctx.save_for_backward(xs, dts, A, Bs, Cs, Ds, dt_bias)
        return scan._scan_fwd(scan._Args(xs, dts, A, Bs, Cs, Ds, dt_bias))

    @staticmethod
    def backward(ctx, gy):
        from smow_net_tpu_torch.ops import scan

        args = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            return torch.autograd.grad(scan.cross_selective_scan_plain(*args), args, gy)


@contextlib.contextmanager
def swap_scan(fn):
    """Route the model's selective scan through `fn(xs, dts, A, Bs, Cs, Ds,
    dt_bias)` (the model always takes the softplus)."""
    from smow_net_tpu_torch.ops import scan

    saved = scan.cross_selective_scan

    def call(xs, dts, A, Bs, Cs, Ds=None, dt_bias=None, delta_softplus=True):
        require(delta_softplus, "the model's scans take the softplus")
        return fn(xs, dts, A, Bs, Cs, Ds, dt_bias)

    scan.cross_selective_scan = call
    try:
        yield
    finally:
        scan.cross_selective_scan = saved


def log_times(results: dict, label: str) -> None:
    for k, v in results.items():
        log(f"  {label} bf16 time {k}: kernel {v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, "
            f"bound {v['bound_ms']:.4f} ms"
            + ("" if v["library_ms"] is None else f", library {v['library_ms']:.4f} ms (NCHW)")
            + " (CUDA graph)")


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
                call = lambda: warp.token_scatter(x, grid, m)
                result["ms"] = graph_ms(call)
                result["plain_ms"] = graph_ms(lambda: warp.token_scatter_plain(x, grid, m))
                result.update(bound(nbytes(x, grid, m, ew, zaw), 18 * x.numel()),
                              library_ms=None)
                log(f"  slice bf16 time: kernel {result['ms']:.4f} ms, "
                    f"plain {result['plain_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms "
                    f"(CUDA graph); kernel alone {kernel_only_ms(call, 'token_scatter'):.4f} "
                    f"ms (profiler); 20 calls between events {cuda_ms(call):.4f} ms (host-bound "
                    "where the host is slower than the card)")

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
                         ms=graph_ms(lambda: warp.token_scatter(x, grid, m, residual=True)),
                         plain_ms=graph_ms(lambda: warp.token_scatter_plain(
                             x, grid, m, residual=True)),
                         **bound(nbytes(x, grid, m, *got), 18 * x.numel()))
                c_call = lambda: warp.grid_sample_t_vjp(xbar, eaw, grid)
                c.update(max_abs_err=err_c, library_ms=None, ms=graph_ms(c_call),
                         plain_ms=graph_ms(lambda: warp.grid_sample_t_vjp_plain(
                             xbar, eaw, grid)),
                         **bound(nbytes(xbar, eaw, grid, dg, dw_c), 26 * x.numel()))
                log(f"  C alone {kernel_only_ms(c_call, 'grid_sample_t_vjp'):.4f} ms "
                    f"(profiler); 20 calls between events {cuda_ms(c_call):.4f} ms "
                    "(the host's call rate, not the kernel)")
                # the one PyTorch call for A-bwd's function: the backward of
                # F.grid_sample (bilinear, border, align_corners) in NCHW,
                # which returns dgrid where A-bwd returns the weight rows
                x_nchw = x.permute(0, 3, 1, 2).contiguous()
                g_nchw = daw.permute(0, 3, 1, 2).contiguous()
                grid_dt = grid.to(dt)
                ab.update(max_abs_err=err_a,
                          ms=graph_ms(lambda: warp.grid_sample_bwd(x, daw, grid)),
                          plain_ms=graph_ms(lambda: warp.grid_sample_bwd_plain(x, daw, grid)),
                          library_ms=graph_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                              g_nchw, x_nchw, grid_dt, 0, 1, True, [True, True])),
                          **bound(nbytes(x, daw, grid, da, dw_a), 26 * x.numel()))
                log_times(results, label)

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


def phase_warps(dev) -> dict:
    """Kernels A-fwd and B against their plain versions, fp32 and bf16, on
    free and border-clamped flows; then their times at SMOW_Net_LW's token
    chain shape beside the library calls."""
    from smow_net_tpu_torch.ops import warp

    log("phase 3c: kernels A-fwd grid_sample_fwd and B grid_sample_transpose vs their "
        "plain versions")
    results = {"grid_sample_fwd": {}, "grid_sample_transpose": {}}

    def case(label, shape, spike=False):
        a, _, grid, r, _ = _token_inputs(dev, shape, 32, spike)
        F_, H, W, C = shape
        for dt in (torch.float32, torch.bfloat16):
            x, g = a.to(dt), r.to(dt)
            rtol = 1e-5 if dt == torch.float32 else BF16_REL
            name = f"{label} {str(dt)[6:]}"
            out = warp.grid_sample(x, grid)
            err_a = check(f"A-fwd {name}", out, warp.grid_sample_plain(x.float(), grid),
                          1e-5, rtol)
            out_t = warp.grid_sample_transpose(g, grid, (H, W))
            err_b = check(f"B {name}", out_t,
                          warp.grid_sample_transpose_plain(g.float(), grid, (H, W)), 1e-5, rtol)
            require(out.dtype == out_t.dtype == dt, "A-fwd and B return the input dtype")
            if label == "LW chain" and dt == torch.bfloat16:
                fwd, tr = results["grid_sample_fwd"], results["grid_sample_transpose"]
                # the one PyTorch call for each: F.grid_sample (bilinear, border,
                # align_corners) in NCHW, and its input gradient S^T g
                x_nchw = x.permute(0, 3, 1, 2).contiguous()
                g_nchw = g.permute(0, 3, 1, 2).contiguous()
                grid_dt = grid.to(dt)
                a_call = lambda: warp.grid_sample(x, grid)
                b_call = lambda: warp.grid_sample_transpose(g, grid, (H, W))
                fwd.update(max_abs_err=err_a, ms=graph_ms(a_call),
                           plain_ms=graph_ms(lambda: warp.grid_sample_plain(x, grid)),
                           library_ms=graph_ms(lambda: torch.nn.functional.grid_sample(
                               x_nchw, grid_dt, "bilinear", "border", True)),
                           **bound(nbytes(x, grid, out), 8 * x.numel()))
                tr.update(max_abs_err=err_b, ms=graph_ms(b_call),
                          plain_ms=graph_ms(lambda: warp.grid_sample_transpose_plain(
                              g, grid, (H, W))),
                          library_ms=graph_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                              g_nchw, x_nchw, grid_dt, 0, 1, True, [True, False])),
                          **bound(nbytes(g, grid, out_t), 8 * g.numel()))
                log_times(results, label)
                log(f"  kernels alone (profiler): A-fwd "
                    f"{kernel_only_ms(a_call, 'grid_sample_fwd'):.4f} ms, B "
                    f"{kernel_only_ms(b_call, 'grid_sample_transpose'):.4f} ms")

    case("LW chain", (32, 128, 128, 8))
    case("border-clamped", (32, 128, 128, 8), spike=True)
    case("C=16", (32, 128, 128, 16))
    return results


def phase_unfused_chain(dev) -> None:
    """The unfused token chain's VJP on the kernel path against the plain
    path; then the two train chains timed at SMOW_Net_LW's shape."""
    from smow_net_tpu_torch.ops import _kernels, warp

    log("phase 3d: unfused token chain VJP, fp32: kernel path (A-fwd, B, C, A-bwd) vs "
        "plain path (bound 1e-4 of the largest element, as phase 3b)")
    names = ("grid_sample_fwd", "grid_sample_transpose", "grid_sample_t_vjp", "grid_sample_bwd")
    for label, spike in (("LW chain", False), ("spread>87", True)):
        a, flow, _, r, s = _token_inputs(dev, (32, 128, 128, 8), 33, spike)

        def grads():
            at, ft = a.clone().requires_grad_(), flow.clone().requires_grad_()
            ew, zaw = warp.token_softmax_scatter(at, ft, train_chain="unfused")
            return torch.autograd.grad((ew * r).sum() + (zaw * s).sum(), (at, ft))

        before = {n: _kernels.launches[n] for n in names}
        got = grads()
        require(all(_kernels.launches[n] == before[n] + 1 for n in names),
                "the unfused chain must run each of A-fwd, B, C, A-bwd once")
        with plain_ops():
            want = grads()
        for part, g, w in zip(("da", "dflow"), got, want):
            check(f"{label} {part}", g, w, 1e-6, 1e-4)

    a, flow, _, r, s = _token_inputs(dev, (32, 128, 128, 8), 34)
    a, r, s = a.to(torch.bfloat16), r.to(torch.bfloat16), s.to(torch.bfloat16)
    times = {}
    for chain in ("hybrid", "unfused", "hybrid", "unfused"):
        def fwd_bwd():
            at, ft = a.clone().requires_grad_(), flow.clone().requires_grad_()
            ew, zaw = warp.token_softmax_scatter(at, ft, train_chain=chain)
            torch.autograd.grad((ew * r).sum() + (zaw * s).sum(), (at, ft))

        times.setdefault(chain, []).append(cuda_ms(fwd_bwd))
    log("  (finding) train chain forward + backward, bf16 (32, 128, 128, 8), CUDA events "
        "over 20 calls, in turns: "
        + ", ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms" for k, v in times.items()))


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


def phase_kernel_f(dev, D: int) -> dict:
    from smow_net_tpu_torch.ops import xattn

    log(f"phase 4: kernel F xattn_layer_fwd vs cross_layer_head1_plain at D = {D}")
    result = {}
    scale = D ** -0.5
    args32 = _layer_args(dev, 16, 16384, D=D, hid=2 * D)
    for use_perm in (False, True):
        perm = _decoder_perm(dev, D) if use_perm else None
        for dt in (torch.float32, torch.bfloat16):
            # weights too at bf16 values, so the fp32 plain run sees the same numbers
            args = [a.to(dt) for a in args32]
            out = xattn.cross_layer_head1(*args, scale=scale, perm=perm)
            want = xattn.cross_layer_head1_plain(*[a.float() for a in args], scale=scale,
                                                 perm=perm)
            name = f"(16,16384,{D}) perm={use_perm} {str(dt)[6:]}"
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
                                        _layer_flops(*args[0].shape, hid=2 * D)),
                                  library_ms=None)
                    log(f"  bf16 time: kernel {result['ms']:.4f} ms, "
                        f"plain {result['plain_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms")
    # ragged tail: N not a multiple of the kernel's 64-row tile
    args = _layer_args(dev, 2, 1000, D=D, hid=2 * D, seed=5)
    check(f"ragged (2,1000,{D}) fp32", xattn.cross_layer_head1(*args, scale=scale),
          xattn.cross_layer_head1_plain(*args, scale=scale), 1e-4, 1e-5)
    # what the decoder pays to reach (B, N, D) rows from NCDHW before kernel F
    y = torch.randn(16, D // 4, 4, 128, 128, device=dev, dtype=torch.bfloat16)
    t_ms = cuda_ms(lambda: y.reshape(16, D, 16384).transpose(1, 2).contiguous())
    log(f"  (info) NCDHW -> (B, N, D) transpose before kernel F, bf16 bs16: {t_ms:.4f} ms")
    return result


def phase_kernel_f_bwd(dev, D: int) -> dict:
    """Kernel F-bwd: the 14 input gradients against torch.autograd.grad of
    the plain layer in fp32 on the same inputs."""
    from smow_net_tpu_torch.ops import xattn

    log(f"phase 4b: kernel F-bwd xattn_layer_bwd vs autograd of cross_layer_head1_plain "
        f"at D = {D}")
    names = ("x", "ln1_scale", "ln1_bias", "wq", "k", "v", "w_out", "b_out",
             "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")
    scale = D ** -0.5
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

    args32 = _layer_args(dev, 16, 16384, D=D, hid=2 * D)
    gy32 = torch.from_numpy(np.random.default_rng(6).normal(
        size=(16, 16384, D)).astype(np.float32)).to(dev)
    for use_perm in (False, True):
        perm = _decoder_perm(dev, D) if use_perm else None
        for dt in (torch.float32, torch.bfloat16):
            err, args, gy = compare(f"(16,16384,{D}) perm={use_perm}", args32, gy32, perm, dt)
            if dt == torch.bfloat16 and not use_perm:
                result["max_abs_err"] = err
                result["ms"] = cuda_ms(lambda: xattn._layer_bwd(args, gy, scale, None, 1e-5))
                out = xattn.cross_layer_head1_plain(*args, scale=scale)
                result["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    out, args, gy, retain_graph=True))
                weights = [a.detach().float() for a in args[1:]]
                result.update(bound(nbytes(args[0], gy, args[0], *weights, *weights),
                                    _layer_flops(16, 16384, D, hid=2 * D, mlp_products=5)),
                              library_ms=None)
                log(f"  bf16 time: kernel {result['ms']:.4f} ms, plain backward "
                    f"{result['plain_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms")
    compare(f"ragged (2,1000,{D})", _layer_args(dev, 2, 1000, D=D, hid=2 * D, seed=5),
            torch.from_numpy(np.random.default_rng(7).normal(
                size=(2, 1000, D)).astype(np.float32)).to(dev), None, torch.float32)
    return result


# (B, K, L, Dk) of every selective-scan call in one ChangeMamba forward at
# 16 x 256^2 (the 2B-batched encoder's four stages, then the decoder's
# STBlocks at Dk = 256), with its number of calls
SCAN_CALLS = (((32, 4, 4096, 192), 2), ((32, 4, 1024, 384), 2), ((32, 4, 256, 768), 9),
              ((32, 4, 64, 1536), 2), ((16, 4, 64, 256), 1), ((16, 4, 128, 256), 2),
              ((16, 4, 256, 256), 1), ((16, 4, 512, 256), 2), ((16, 4, 1024, 256), 1),
              ((16, 4, 2048, 256), 2), ((16, 4, 4096, 256), 1), ((16, 4, 8192, 256), 2))
FP32_FLOP_PER_S = 67e12


def mufu_per_s() -> float:
    """The multi-function units' exp rate: 16 per clock per SM x SMs x the
    maximum SM clock that nvidia-smi reports."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return 16 * torch.cuda.get_device_properties(0).multi_processor_count * float(mhz) * 1e6


def scan_bound(n_bytes: float, flops: float, exps: float, rate: float) -> dict:
    """bound_ms and bound_by for fp32 FMA work with exps on the MUFU."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOP_PER_S, exps / rate) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _scan_args(dev, shape, seed, dtype=torch.float32):
    """Kernel I's inputs at `shape` = (B, K, L, Dk), numpy-seeded in
    SS2D's ranges: dt = softplus(dts + bias) mostly in [1e-3, 0.1] with a
    tail above, A = -exp(log(1..16) + noise)."""
    B, K, L, Dk = shape
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    A = -torch.exp(torch.log(torch.arange(1, 17, device=dev, dtype=torch.float32))
                   + f(K * Dk, 16, scale=0.1))
    bias = torch.from_numpy(rng.uniform(np.log(1e-3), np.log(0.1), K * Dk).astype(np.float32))
    return [f(B, K, L, Dk).to(dtype), f(B, K, L, Dk).to(dtype), A, f(B, K, L, 16).to(dtype),
            f(B, K, L, 16).to(dtype), f(K * Dk, scale=0.1, off=1.0), bias.to(dev)]


def phase_scan_fwd(dev, rate: float) -> dict:
    from smow_net_tpu_torch.ops import scan

    log("phase 13: kernel I-fwd selective_scan_fwd vs cross_selective_scan_plain (fp32: 1e-5 "
        "of the largest output; bf16: one bf16 rounding of the plain version in fp32)")
    result = {}
    for shape in ((32, 4, 4096, 192), (32, 4, 256, 768), (16, 4, 8192, 256), (2, 4, 1000, 200)):
        args32 = _scan_args(dev, shape, 40)
        for dt in (torch.float32, torch.bfloat16):
            args = [a.to(dt) if i in (0, 1, 3, 4) else a for i, a in enumerate(args32)]
            with torch.no_grad():
                y = scan.cross_selective_scan(*args)
                want = scan.cross_selective_scan_plain(*[a.float() for a in args])
            require(y.dtype == dt, "I-fwd returns the input dtype")
            err = check(f"{shape} {str(dt)[6:]}", y, want, 0.0,
                        1e-5 if dt == torch.float32 else BF16_REL)
            if shape == (32, 4, 4096, 192) and dt == torch.bfloat16:
                result["max_abs_err"] = err
            del y, want
    # the 27 calls of one bf16 eval forward
    ms = plain_ms = n_bytes = flops = exps = 0.0
    for shape, count in SCAN_CALLS:
        args = _scan_args(dev, shape, 41, torch.bfloat16)
        with torch.no_grad():
            t = cuda_ms(lambda: scan.cross_selective_scan(*args), iters=5, warmup=1)
            tp = cuda_ms(lambda: scan.cross_selective_scan_plain(*args), iters=2, warmup=1)
        B, K, L, Dk = shape
        elems = B * K * L * Dk
        log(f"  {shape} x{count}: kernel {t:.4f} ms, plain {tp:.4f} ms")
        ms, plain_ms = ms + count * t, plain_ms + count * tp
        n_bytes += count * (nbytes(*args) + 2 * elems)          # + y in bf16
        flops += count * 5 * 16 * elems
        exps += count * 18 * elems                              # 16 states + softplus
    result.update(ms=ms, plain_ms=plain_ms, library_ms=None,
                  **scan_bound(n_bytes, flops, exps, rate))
    log(f"  one forward's 27 calls, bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{result['bound_ms']:.4f} ms ({result['bound_by']}; {exps:.3e} exps, "
        f"{n_bytes:.3e} bytes)")
    return result


def _plain_chunk_states(args, chunk):
    """The scan's state before every `chunk` steps, (B, K, L/chunk, 16,
    Dk), by a plain fp32 loop over L."""
    from smow_net_tpu_torch.ops import scan

    xs, dts, A, Bs, Cs, Ds, bias = args
    B, K, L, Dk = xs.shape
    dt = scan.softplus(dts.float() + bias.reshape(1, K, 1, Dk))
    A3 = A.reshape(K, Dk, 16)
    h = torch.zeros(B, K, Dk, 16, device=xs.device)
    out = []
    for l in range(L):
        if l % chunk == 0:
            out.append(h)
        h = (torch.exp(dt[:, :, l, :, None] * A3) * h
             + (dt[:, :, l] * xs[:, :, l].float())[..., None] * Bs[:, :, l, None, :].float())
    return torch.stack(out, dim=2).transpose(-1, -2)


def phase_scan_bwd(dev, rate: float) -> dict:
    from smow_net_tpu_torch.ops import scan

    log("phase 14: kernels I-ckpt selective_scan_ckpt and I-bwd selective_scan_bwd vs the "
        "plain version (fp32: states 1e-5 of the largest, gradients 1e-4 of each largest)")
    names = ("xs", "dts", "A", "Bs", "Cs", "Ds", "dt_bias")
    results = {"selective_scan_ckpt": {}, "selective_scan_bwd": {}}
    args = _scan_args(dev, (32, 4, 1024, 384), 42)
    hck = scan._scan_ckpt(scan._Args(*args))
    err_ck = check("I-ckpt (32, 4, 1024, 384) chunk-start states",
                   hck.reshape(32, 4, 64, 16, 384), _plain_chunk_states(args, 16), 0.0, 1e-5)
    results["selective_scan_ckpt"]["max_abs_err"] = err_ck
    for shape in ((32, 4, 1024, 384), (16, 4, 8192, 256)):
        args = [a.requires_grad_() for a in _scan_args(dev, shape, 43)]
        gy = torch.from_numpy(
            np.random.default_rng(44).normal(size=shape).astype(np.float32)).to(dev)
        got = torch.autograd.grad(scan.cross_selective_scan(*args), args, gy)
        want = torch.autograd.grad(scan.cross_selective_scan_plain(*args), args, gy)
        err = max(check(f"I-bwd {shape} d{n}", g, w, 0.0, 1e-4)
                  for n, g, w in zip(names, got, want))
        if shape == (32, 4, 1024, 384):
            results["selective_scan_bwd"]["max_abs_err"] = err
        del got, want
    # the 27 calls of one bf16 train step's backward
    ck = results["selective_scan_ckpt"]
    bw = results["selective_scan_bwd"]
    tot = dict(ck=0.0, bw=0.0, ck_plain=0.0, bw_plain=0.0, ck_bytes=0.0, bw_bytes=0.0,
               elems=0.0)
    for shape, count in SCAN_CALLS:
        args = _scan_args(dev, shape, 45, torch.bfloat16)
        gy = torch.randn(shape, device=dev, dtype=torch.bfloat16)
        a = scan._Args(*args)
        hck = scan._scan_ckpt(a)
        t_ck = cuda_ms(lambda: scan._scan_ckpt(a), iters=5, warmup=1)
        t_bw = cuda_ms(lambda: scan._scan_bwd(a, gy, hck), iters=5, warmup=1)
        with torch.no_grad():
            t_fwd = cuda_ms(lambda: scan.cross_selective_scan_plain(*args), iters=2, warmup=1)
        ref = [x.detach().requires_grad_() for x in args]
        t_graph = cuda_ms(lambda: scan.cross_selective_scan_plain(*ref), iters=2, warmup=1)
        t_both = cuda_ms(lambda: torch.autograd.grad(scan.cross_selective_scan_plain(*ref), ref,
                                                     gy), iters=2, warmup=1)
        grads = scan._scan_bwd(a, gy, hck)
        B, K, L, Dk = shape
        log(f"  {shape} x{count}: I-ckpt {t_ck:.4f} ms, I-bwd {t_bw:.4f} ms; plain forward "
            f"{t_fwd:.4f}, plain backward {t_both - t_graph:.4f} ms")
        tot["ck"] += count * t_ck
        tot["bw"] += count * t_bw
        tot["ck_plain"] += count * t_fwd
        tot["bw_plain"] += count * (t_both - t_graph)
        tot["ck_bytes"] += count * nbytes(a.u, a.dt, a.Bm, hck)
        tot["bw_bytes"] += count * nbytes(a.u, a.dt, a.Bm, a.Cm, gy, hck, *grads)
        tot["elems"] += count * B * K * L * Dk
        del hck, grads
    e = tot["elems"]
    ck.update(ms=tot["ck"], plain_ms=tot["ck_plain"], library_ms=None,
              **scan_bound(tot["ck_bytes"], 3 * 16 * e, 18 * e, rate))
    # I-bwd's function needs each state's exp(dt A) once (the kernel takes it
    # twice, in the recompute and in the reverse sweep) and the softplus's
    # exp and log: 18 per element, as I-fwd and I-ckpt
    bw.update(ms=tot["bw"], plain_ms=tot["bw_plain"], library_ms=None,
              **scan_bound(tot["bw_bytes"], 20 * 16 * e, 18 * e, rate))
    for label, r in (("I-ckpt", ck), ("I-bwd", bw)):
        log(f"  one train step's 27 calls, bf16: {label} {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return results


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Numpy-seeded values for every parameter and buffer: fan-in scaled
    weights (the zero/identity-initialised temporal mixers included, so every
    branch carries signal), BN running statistics away from identity, and
    the selective scan's A_logs, Ds and dt_projs_bias perturbed around the
    reference's initialisation (log(1..16), 1, the inverse softplus of dt in
    [1e-3, 0.1])."""
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
        elif leaf == "A_logs":
            val = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * n
        elif leaf == "Ds":
            val = 1.0 + 0.1 * n
        elif leaf == "dt_projs_bias":
            val = rng.uniform(np.log(1e-3), np.log(0.1), size=shape) + 0.1 * n
        elif leaf in ("x_proj_weight", "dt_projs_weight"):     # (K, out, fan-in)
            val = n / np.sqrt(shape[-1])
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


SCAN_KERNELS = ("selective_scan_fwd", "selective_scan_ckpt", "selective_scan_bwd")
# each model's eval-step kernels and their launches per batch
EVAL_KERNELS = {
    "smow_net": {"token_scatter_fwd": 1, "xattn_layer_fwd": 1},
    "smow_net_lw": {"token_scatter_fwd": 1, "xattn_layer_fwd": 1},
    "change_mamba": {"selective_scan_fwd": 27},
}
# the train step's kernels per model and their launches per step, and the
# kernels it must not launch
TRAIN_KERNELS = {
    "smow_net": dict.fromkeys(("token_scatter_fwd_eaw", "grid_sample_t_vjp", "grid_sample_bwd",
                               "xattn_layer_fwd", "xattn_layer_bwd"), 1),
    "smow_net_lw": dict.fromkeys(("grid_sample_fwd", "grid_sample_transpose",
                                  "grid_sample_t_vjp", "grid_sample_bwd", "xattn_layer_fwd",
                                  "xattn_layer_bwd"), 1),
    "change_mamba": dict.fromkeys(SCAN_KERNELS, 27),
}
TRAIN_ABSENT = {
    "smow_net": ("token_scatter_fwd", "grid_sample_fwd", "grid_sample_transpose")
    + SCAN_KERNELS,
    "smow_net_lw": ("token_scatter_fwd", "token_scatter_fwd_eaw") + SCAN_KERNELS,
    "change_mamba": ("token_scatter_fwd", "token_scatter_fwd_eaw", "grid_sample_fwd",
                     "grid_sample_transpose", "grid_sample_t_vjp", "grid_sample_bwd",
                     "xattn_layer_fwd", "xattn_layer_bwd"),
}


def phase_main_path(dev, name: str, phase: int, rounds: int, per_round: int = 5) -> dict:
    from smow_net_tpu_torch.models import get_model
    from smow_net_tpu_torch.ops import _kernels
    from smow_net_tpu_torch.train.metrics import cm2score
    from smow_net_tpu_torch.train.trainer import make_eval_step

    log(f"phase {phase}: main path, {name} eval step, bf16, 3 batches of 16 x 256^2")
    model = get_model(name)
    model.load_state_dict(seeded_state_dict(model, 0))
    model = model.to(torch.bfloat16)
    step = make_eval_step(model)
    batches = make_batches(dev, 3, 16, 256, seed=7)
    step(batches[0])                                     # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    _kernels.launches.clear()
    cm_total = torch.zeros(2, 2, device=dev)
    for i, batch in enumerate(batches):
        cm, loss, pred = step(batch)
        counts = dict(_kernels.launches)
        require(counts == {n: k * (i + 1) for n, k in EVAL_KERNELS[name].items()},
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
    launches = {n: _kernels.launches[n] for n in EVAL_KERNELS[name]}
    log(f"  launches {launches}; cm2score {json.dumps(cm2score(cm_total))}")

    # timing: rounds of `per_round` batches (one untimed batch first),
    # alternating the kernel path and the plain path and flipping their
    # order every round
    def round_ms(n=per_round):
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

    medians = alternate_rounds(round_ms, rounds, "batch", per_round)

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
    for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"    {e.self_device_time_total / 1e3 / len(batches):8.3f} ms/batch  "
            f"{e.count // len(batches):4d}x  {e.key[:90]}")
    os.makedirs(PROFILE_DIR, exist_ok=True)
    with open(os.path.join(PROFILE_DIR, f"{name}_eval_bf16_bs16_profile.txt"), "w") as fh:
        fh.write(averages.table(sort_by="cuda_time_total", row_limit=40))
    log(f"  profile table written to {PROFILE_DIR}")
    return launches


def alternate_rounds(round_ms, rounds: int, unit: str, per_round: int) -> dict:
    """Rounds of `round_ms()` alternating the kernel path and the plain path
    (their order flipped every round; the plain path must launch no
    kernel); logs and returns each path's median."""
    from smow_net_tpu_torch.ops import _kernels

    timing, wins = {"kernel": [], "plain": []}, 0
    for r in range(rounds):
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
    for path, rows in timing.items():
        q1, medians[path], q3 = np.percentile(np.concatenate(rows), [25, 50, 75])
        log(f"  {path} path ms/{unit}: median {medians[path]:.3f} (q1 {q1:.3f}, q3 {q3:.3f}, "
            f"{len(rows)} rounds x {per_round})")
    log(f"  kernel path faster in {wins} of {rounds} rounds")
    return medians


def phase_fp32_model(dev, name: str, phase: int) -> None:
    from smow_net_tpu_torch.models import get_model
    from smow_net_tpu_torch.train.trainer import select_pred

    log(f"phase {phase}: whole {name} fp32 (TF32 off), kernel path vs plain path, batch 2, "
        "256^2")
    model = get_model(name)
    model.load_state_dict(seeded_state_dict(model, 0))
    model = model.eval()
    rng = np.random.default_rng(11)
    x1, x2 = (torch.from_numpy(rng.normal(size=(2, 3, 256, 256)).astype(np.float32)).to(dev)
              for _ in range(2))
    with torch.inference_mode():
        got = model(x1, x2)
        with plain_ops():
            want = model(x1, x2)
    require(got.shape[0] == 2 and got.shape[2:] == (256, 256), f"output {tuple(got.shape)}")
    got, want = select_pred(got), select_pred(want)
    log(f"  probabilities mean {float(want.mean()):.4f} std {float(want.std()):.4f}")
    # fp32 everywhere; the two paths differ only in the kernels' summation order
    check(f"{name} fp32 probabilities", got, want, 1e-4, 0.0)


def _train_setup(name, compute_dtype, steps):
    from smow_net_tpu_torch.models import get_model
    from smow_net_tpu_torch.train.schedule import get_schedule
    from smow_net_tpu_torch.train.trainer import (create_train_state, make_optimizer,
                                                  make_train_step)

    model = get_model(name)
    model.load_state_dict(seeded_state_dict(model, 0))
    opt = make_optimizer(get_schedule("cosine", 1e-4, epochs=1, iters_per_epoch=steps))(
        model.parameters())
    return model, create_train_state(model, opt), make_train_step(model, opt, compute_dtype)


def phase_train(dev, name: str, phase: int, rounds: int, per_round: int = 5) -> dict:
    from smow_net_tpu_torch.ops import _kernels

    log(f"phase {phase}: main path, {name} train step, bf16 compute over fp32 masters, "
        "6 steps on one repeated batch of 16 x 256^2")
    steps = 6
    model, state, step = _train_setup(name, torch.bfloat16, steps)
    batch = make_batches(dev, 1, 16, 256, seed=8)[0]
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.detach().clone() for n, b in model.named_buffers() if "running" in n}
    torch.cuda.synchronize()

    _kernels.launches.clear()
    losses = []
    for i in range(steps):
        losses.append(float(step(state, batch)))
        counts = dict(_kernels.launches)
        require(counts == {n: k * (i + 1) for n, k in TRAIN_KERNELS[name].items()},
                f"launch counts {counts} after train step {i + 1}: per step "
                f"{TRAIN_KERNELS[name]}, and never {TRAIN_ABSENT[name]}")
        log(f"  step {i}: loss {losses[-1]:.6f}")
    launches = {n: _kernels.launches[n] for n in tuple(TRAIN_KERNELS[name]) + TRAIN_ABSENT[name]}
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
    # exact arithmetic, so it may not move, nor may SMOW_Net_LW's
    # backbone.features.18 (it feeds no tap: zero gradient, and a weight decay
    # of lr * wd = 1e-8 that fp32 rounds away); every other tensor must
    require(len(still) <= 0.1 * len(params0), "the parameters did not change")
    require(all(n.startswith("backbone.features.18.") or n.endswith("bias") for n in still),
            f"weights that did not move: {still}")
    require(all(b.dtype == torch.float32 and not torch.equal(b, stats0[n])
                for n, b in model.named_buffers() if n in stats0),
            "every BN running statistic must stay fp32 and move")
    require(float(state.loss_count) == steps and float(state.cm.sum()) == steps * 16 * 256 ** 2,
            "the step must accumulate its metrics on the device")

    def round_ms(n=per_round):
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
    medians = alternate_rounds(round_ms, rounds, "step", per_round)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

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
    with open(os.path.join(PROFILE_DIR, f"{name}_train_bf16_bs16_profile.txt"), "w") as fh:
        fh.write(averages.table(sort_by="cuda_time_total", row_limit=60))
    return launches


def leaf_errors(want: dict, got: dict) -> list:
    """(max |got - want| / the leaf's largest |want|, name), worst first;
    leaves whose gradient is zero in exact arithmetic (a conv bias right
    before a train-mode BatchNorm) are held to the model's largest one."""
    largest = max(float(w.abs().max()) for w in want.values())
    rows = []
    for n, w in want.items():
        scale = float(w.abs().max())
        ref = scale if scale >= 1e-6 * largest else largest
        rows.append((float((got[n] - w).abs().max()) / ref, n))
    return sorted(rows, reverse=True)


def phase_fp32_train_grads(dev, name: str, phase: int) -> None:
    from smow_net_tpu_torch.models import get_model
    from smow_net_tpu_torch.nn.ssm import DropPath
    from smow_net_tpu_torch.train.loss import bce_dice_loss
    from smow_net_tpu_torch.train.trainer import select_pred

    log(f"phase {phase}: whole-model {name} fp32 train gradients (TF32 off, deterministic "
        "cuDNN), kernel path vs plain path (ChangeMamba: the plain scan's backward on I-fwd's "
        "values), batch 2, 256^2")
    model = get_model(name)
    model.load_state_dict(seeded_state_dict(model, 0))
    model.train()
    batch = make_batches(dev, 1, 2, 256, seed=12)[0]
    x1, x2 = (batch[k].permute(0, 3, 1, 2) for k in ("A", "B"))
    # the same DropPath masks on both paths: one generator, reseeded before each pass
    generator = torch.Generator(device=dev)
    for m in model.modules():
        if isinstance(m, DropPath):
            m.generator = generator

    def grads():
        generator.manual_seed(0)
        model.zero_grad(set_to_none=True)
        loss = bce_dice_loss(select_pred(model(x1, x2)).float(), batch["mask"])
        loss.backward()
        # a parameter that feeds no output (SMOW_Net_LW's backbone.features.18)
        # gets no gradient on either path
        return float(loss.detach()), {n: p.grad.clone() for n, p in model.named_parameters()
                                      if p.grad is not None}

    # ConvTranspose3d's forward is cuDNN's backward-data, whose default
    # algorithms add with atomics: run to run, an activation next to a
    # LeakyReLU kink could take the other branch. Deterministic algorithms
    # keep the two paths' forward identical outside the kernels' ops. The
    # selective scan's own forward differs from its plain version by ulps
    # (exp2 against exp, other sums), enough to move a decoder ReLU across
    # its kink: ChangeMamba's gradients are held at 1e-3 against I-fwd's
    # values with the plain backward, and against the strict plain path
    # (I-fwd's train-mode output then feeds the comparison) on its loss and
    # on a bound set by this run's kink sensitivity: the spread that a
    # +-1e-6 relative nudge of the plain scan's output causes.
    scan_model = any(isinstance(m, DropPath) for m in model.modules())
    reference = swap_scan(_KernelValuePlainGrad.apply) if scan_model else plain_ops()
    torch.backends.cudnn.deterministic = True
    try:
        loss_k, got = grads()
        with reference:
            loss_p, want = grads()
            _, again = grads()
        if scan_model:
            from smow_net_tpu_torch.ops import scan

            with plain_ops():
                loss_s, strict = grads()
            kink = []
            for eps in (1e-6, -1e-6):
                with swap_scan(lambda *a, eps=eps: scan.cross_selective_scan_plain(*a) * (1 + eps)):
                    kink.append((leaf_errors(strict, grads()[1])[0], eps))
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"  loss kernel path {loss_k:.7f}, reference path {loss_p:.7f}")
    if scan_model:
        for (err, n), eps in kink:
            log(f"  kink sensitivity: strict plain path vs plain with the scan's output x "
                f"(1 {eps:+.0e}): worst leaf {n} {err:.3e} of its largest element")
        spread = max(err for (err, _), _ in kink)
        err, n = leaf_errors(strict, got)[0]
        bound = max(1e-3, 4 * spread)
        log(f"  kernel path vs strict plain path: loss {loss_k:.7f} vs {loss_s:.7f}, worst leaf "
            f"{n} {err:.3e} of its largest element (bound {bound:.3e}: 4x the nudges' spread)")
        require(abs(loss_k - loss_s) <= 1e-5 * abs(loss_s),
                "the kernel path's loss differs from the strict plain path's")
        require(err <= bound, f"{n}: kernel path vs strict plain path {err:.3e} of its largest "
                f"element, over 4x the kink sensitivity")
    require(got.keys() == want.keys() and len(want) >= len(list(model.parameters())) - 3,
            "the two paths must give gradients to the same parameters")
    require(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), "the two paths' losses differ")
    for n, g in got.items():
        require(bool(torch.isfinite(g).all()), f"{n}: non-finite gradient")
    noise = dict((n, e) for e, n in leaf_errors(want, again))
    rows = [(err, noise[n], n) for err, n in leaf_errors(want, got)]
    rows.sort(reverse=True)
    for err, spread, n in rows[:5]:
        log(f"  {n}: kernel vs reference {err:.3e}, reference vs reference {spread:.3e} of its "
            "largest element")
    worst_noise = max(r[1] for r in rows)
    log(f"  worst reference-vs-reference spread over all leaves: {worst_noise:.3e}")
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
    warps = phase_warps(dev)
    phase_unfused_chain(dev)
    f = {D: phase_kernel_f(dev, D) for D in (128, 64)}
    fb = {D: phase_kernel_f_bwd(dev, D) for D in (128, 64)}
    launches = phase_main_path(dev, "smow_net", 5, rounds=6)
    phase_fp32_model(dev, "smow_net", 6)
    train_launches = phase_train(dev, "smow_net", 7, rounds=4)
    phase_fp32_train_grads(dev, "smow_net", 8)
    lw_launches = phase_main_path(dev, "smow_net_lw", 9, rounds=6)
    phase_fp32_model(dev, "smow_net_lw", 10)
    lw_train_launches = phase_train(dev, "smow_net_lw", 11, rounds=4)
    phase_fp32_train_grads(dev, "smow_net_lw", 12)
    rate = mufu_per_s()
    log(f"  exp rate for kernel I's bound: {rate:.4e} /s (16 per clock per SM, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, clocks.max.sm)")
    scan_fwd = phase_scan_fwd(dev, rate)
    scan_bwd = phase_scan_bwd(dev, rate)
    cm_launches = phase_main_path(dev, "change_mamba", 15, rounds=4, per_round=3)
    phase_fp32_model(dev, "change_mamba", 16)
    cm_train_launches = phase_train(dev, "change_mamba", 17, rounds=2, per_round=2)
    phase_fp32_train_grads(dev, "change_mamba", 18)

    log("phase 19: results (launches: D and F at D = 128 from SMOW_Net's eval path (phase "
        "5), E, C, A-bwd and F-bwd at D = 128 from its train step (phase 7), A-fwd and B "
        "from SMOW_Net_LW's train step (phase 11), F and F-bwd at D = 64 from SMOW_Net_LW's "
        "eval path (phase 9) and train step (phase 11), I-fwd from ChangeMamba's eval path "
        "(phase 15, 3 batches), I-ckpt and I-bwd from its train step (phase 17, 6 steps); "
        f"SMOW_Net's train step ran F {train_launches['xattn_layer_fwd']} times, "
        f"SMOW_Net_LW's ran C {lw_train_launches['grid_sample_t_vjp']} and A-bwd "
        f"{lw_train_launches['grid_sample_bwd']} times, ChangeMamba's I-fwd "
        f"{cm_train_launches['selective_scan_fwd']} times)")
    csrc, pallas = "smow_net_tpu_torch/csrc/", "smow_net_tpu/ops/pallas/"

    def row(name, source, replaces, launch_count, numbers, **extra):
        return dict(name=name, route="cuda", source=csrc + source, replaces=pallas + replaces,
                    launches=launch_count, **numbers, **extra)

    kernels = [
        row("token_scatter_fwd", "token_scatter.cu", "warp.py:781",
            launches["token_scatter_fwd"], d),
        row("xattn_layer_fwd", "xattn_layer.cu", "xattn.py:609", launches["xattn_layer_fwd"],
            f[128]),
        row("token_scatter_fwd_eaw", "token_scatter.cu", "warp.py:928",
            train_launches["token_scatter_fwd_eaw"], tok["token_scatter_fwd_eaw"]),
        row("grid_sample_t_vjp", "grid_sample_t_vjp.cu", "warp.py:300",
            train_launches["grid_sample_t_vjp"], tok["grid_sample_t_vjp"]),
        row("grid_sample_bwd", "grid_sample_bwd.cu", "warp.py:519",
            train_launches["grid_sample_bwd"], tok["grid_sample_bwd"]),
        row("xattn_layer_bwd", "xattn_layer_bwd.cu", "xattn.py:633",
            train_launches["xattn_layer_bwd"], fb[128]),
        row("grid_sample_fwd", "grid_sample_fwd.cu", "warp.py:508",
            lw_train_launches["grid_sample_fwd"], warps["grid_sample_fwd"]),
        row("grid_sample_transpose", "grid_sample_transpose.cu", "warp.py:385",
            lw_train_launches["grid_sample_transpose"], warps["grid_sample_transpose"]),
        row("xattn_layer_fwd_d64", "xattn_layer.cu", "xattn.py:609",
            lw_launches["xattn_layer_fwd"], f[64]),
        row("xattn_layer_bwd_d64", "xattn_layer_bwd.cu", "xattn.py:633",
            lw_train_launches["xattn_layer_bwd"], fb[64]),
        row("selective_scan_fwd", "selective_scan.cu", "scan_fused.py:147",
            cm_launches["selective_scan_fwd"], scan_fwd),
        row("selective_scan_ckpt", "selective_scan.cu", "scan_fused.py:261",
            cm_train_launches["selective_scan_ckpt"], scan_bwd["selective_scan_ckpt"]),
        row("selective_scan_bwd", "selective_scan.cu", "scan_fused.py:291",
            cm_train_launches["selective_scan_bwd"], scan_bwd["selective_scan_bwd"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
