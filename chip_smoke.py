#!/usr/bin/env python
"""Drive the PyTorch/CUDA port of SMOW_Net, SMOW_Net_LW, ChangeMamba,
CD-Mamba and RS-Mamba, its general selective scan, the VMamba layer family,
and its train and test CLIs from PNG files, on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no result line is printed):
  1. card name and power limit (nvidia-smi); TF32 off for the fp32 phases
  2. build the hand-written kernels (smow_net_tpu_torch/csrc, nvcc sm_90a)
  3. kernel D (token scatter) vs its plain version: fp32 and bf16 at
     (32, 128, 128, 8), a logit spread > 87 (zaw underflow), C = 16, and a
     far-scattered flow (every tile's box too wide to sort: the tile
     scatter's direct branch); each case logs its tiles' branches
  3b. the token chain's train kernels vs their plain versions, same cases:
     E (D plus the eaw residual), C (`grid_sample_t_vjp`), A-bwd
     (`grid_sample_bwd`); A-bwd also on a smooth flow (a numpy-seeded 8x8
     field upsampled to 128x128), timed beside the i.i.d. flow with the
     kernel alone and the library call; then the whole
     `token_softmax_scatter` VJP (da, dflow), kernel path vs plain path, in
     fp32
  3c. kernels A-fwd (`grid_sample`) and B (`grid_sample_transpose`) vs their
     plain versions, fp32 and bf16, at (32, 128, 128, 8) (SMOW_Net_LW's
     token chain), with border-clamped flows, and C = 16; B also on the
     smooth flow of 3b, timed as there
  3d. the unfused token chain's VJP (da, dflow), kernel path vs plain path,
     fp32; then the hybrid, the unfused and the fused chain timed, forward
     plus backward, bf16 at (32, 128, 128, 8), in turns
  3e. kernel D-bwd (`token_scatter_bwd`, the fused chain's backward) vs its
     plain version at (32, 128, 128, 8) (and a spread > 87, C = 16, and the
     far flow of 3), fp32 and bf16, one launch per call; its ptxas lines
     (no spills) and each case's tile-scatter branches; then the fused
     chain's whole VJP (da, dflow), kernel path (D, D-bwd) vs plain path,
     fp32
  3f. kernels A-fwd, B, C and A-bwd in the four (padding_mode,
     align_corners) pairs at (32, 128, 128, C), C = 8 and 32, fp32; each
     also on its grid with NaN coordinates (a NaN x, y, both; interior and
     last pixel), and D, E and D-bwd on such a flow grid at C = 8 and 16,
     against their plain versions on the same grid: NaN at the same
     elements, the finite ones at the phase's bounds
  3g. the reference's unfused OFW route, TokenTransformerEncoder(OFW(x))
     (A-fwd and A-bwd at C = 32), vs the fused route SMOWNet runs, on
     (16, 32, 2, 128, 128) features with numpy-seeded weights, fp32
  4. kernel F (decoder layer) vs its plain version: (16, 16384, D), h = 8,
     M = 8, hidden 2D, with and without the lane permutation, at D = 128
     (SMOW_Net) and D = 64 (SMOW_Net_LW), and the ragged N = 1000
  4b. kernel F-bwd vs torch.autograd.grad of the plain layer: all 14 input
     gradients at (16, 16384, D) with and without the permutation, fp32
     and bf16, and the ragged N = 1000, at D = 128 and D = 64; F-bwd's
     slab bytes per call (bf16: one record per block, written once) and
     both kernels' ptxas lines
  4c. kernel G (`cross_attn_fwd`, the layer's attention sublayer alone; an
     op path, no model runs it) vs `cross_attn_head1_plain`, fp32 (1e-5 of
     the largest output) and bf16: (16, 16384, D) at D = 128 and 64 with no
     permutation, the decoder's lane fold and a random one; D = 256, 384
     and 512 at (2, 4096, D); the ragged (2, 1000, D) at every built width;
     head 0's logits ~1e3 above the others' (one softmax shift per (pixel,
     head)); one launch per call; an unbuilt (h, M), D = 96 and fp16 raise
     ValueError; the ptxas lines of its bf16 tensor-core body (no spills)
     and its grid; two bf16 runs bitwise equal; then its bf16 time at (16,
     16384, 128) (and D = 64), a CUDA graph of 20 calls and the kernel
     alone, beside its bound
  4d. kernel G-bwd (`cross_attn_bwd`) vs torch.autograd.grad of the plain
     version in fp32: all eight input gradients at the cases of 4c (fp32 at
     1e-4 of each leaf's largest element; the spread case's fp32 against
     the plain arithmetic in float64, `attn_f64`, since the fp32 plain
     version misses that bound there itself), one launch per backward; the
     ptxas lines of its bf16 tensor-core body (no spills); two bf16 runs
     bitwise equal but for dk and dv, and its record bytes per call; then
     its bf16 time; then fp32 G and G-bwd on the 1e4 key spread at (2,
     4096, D), every built D, against the plain arithmetic in float64
     (`attn_f64`): the output and all eight gradients within 1e-4 of their
     largest element. No later phase may launch G or G-bwd: every counter
     reset (phases 5, 7, 8b, 9, 11, 15, 17, 21, 23, 24, 28, 30, 32, 26) and
     phase 25 check it
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
  8b. SMOW_Net's train step on the fused token chain
     (`token_train_chain="fused"`): D, D-bwd, F and F-bwd once per step, no
     other kernel; then the whole bf16 step on the hybrid, the unfused and
     the fused chain, 2 rounds in turns
  8c. phase 8 on the fused chain (D and D-bwd on the kernel path)
  9-12. phases 5-8 for get_model("smow_net_lw"): the eval step (D and F at
     D = 64 once per batch), the fp32 model, the train step (A-fwd, B, C,
     A-bwd, F and F-bwd at D = 64 once per step, D and E never) and its
     fp32 gradients
  13. kernel I-fwd (`selective_scan_fwd`) vs `cross_selective_scan_plain`,
     fp32 and bf16, at (B, K, L, Dk) = (32, 4, 4096, 192), (32, 4, 256, 768),
     (16, 4, 8192, 256) and (2, 4, 1000, 200) (Dk not a multiple of the
     32-channel blocks, L not of the 16-step chunks); the forward sweep's
     registers and spills (ptxas) and its resident warps per SM and shared
     memory per block (the CUDA occupancy calculator) in the grouped layout;
     then its time summed over the 27 calls of one ChangeMamba forward at
     16 x 256^2, bf16
  14. kernel I-ckpt's chunk-start states vs the plain I-ckpt, and
     I-ckpt + I-bwd (with the epilogue) vs torch.autograd.grad of the plain
     version: all seven input gradients at (32, 4, 1024, 384) and
     (16, 4, 8192, 256), fp32; I-bwd's registers and spills (ptxas), its
     resident warps per SM in both layouts and dtypes (the CUDA occupancy
     calculator) and two runs bitwise equal; then I-ckpt's and I-bwd's
     times summed over the 27 calls of one train step, bf16, I-bwd also
     alone (its launches between CUDA events)
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
  19. kernel H: the flat contract (`selective_scan`, CD-Mamba's) through
     I-fwd, I-ckpt and I-bwd reading the (B, L, G*Cg) layout in place,
     sequential, vs `selective_scan_plain`: the output and all seven input
     gradients at (rows, L, Cg) = (64, 65536, 32) G = 2 (fp32 and bf16),
     (32, 65536, 32) G = 1, (64, 16384, 64), (64, 4096, 128) (fp32 and bf16)
     and (64, 1024, 256), and H-ckpt's chunk-start states at (64, 1024, 256)
     against the plain I-ckpt; the forward sweep's build and residency in
     the flat layout (as phase 13); then H-fwd's time summed over the 33
     calls of one CD-Mamba forward at 16 x 256^2, and H-ckpt's and H-bwd's
     over one train step's, bf16, on the shipped route (each call cut into
     `seg_count` segments, seeded, as the main path runs them) and
     sequential
  20. the shipped route (each call cut into `seg_count` segments) at every
     CD-Mamba scan shape, fp32 and bf16: kernels H-seg carry and adjcarry,
     and H-fwd, H-ckpt and H-bwd seeded as the segmented route seeds them,
     vs their plain versions (the H rows' and the carry's and adjcarry's
     max_abs_err come from here, bf16); the carry and adjcarry on ragged
     segments (L % 16 != 0, Cg % 32 != 0) in both layouts; the adjcarry's
     build (at most 64 registers, no spills) and residency (32 warps per
     SM) and two runs bitwise equal; the segmented forward and backward
     at S = 4 and the shipped S vs the sequential kernels and the plain scan
     at (64, 65536, 32) and (64, 16384, 64); the carry's and adjcarry's
     times at (64, 65536, 32) on the shipped S; then the A/B that sets
     `scan.seg_count`'s constants: every CD-Mamba shape with L >= 4096,
     sequential vs segmented at each S, forward and forward + backward, bf16
  21. phase 5 for get_model("cd_mamba") (10.34 M parameters; numpy-seeded
     weights with A_log, D, dt_proj.bias and skip_scale around the
     reference's initialisation): the eval step at 16 x 256^2, H-fwd 33 times
     per batch and the carry once per segmented call; then the (B, L, G, Cg)
     of every scan call of one batch, recorded, must equal the table
     `CDM_CALLS` that phases 19 and 20 use
  22. phases 6 and 8 for CD-Mamba on the shipped route (H-seg's kernels on
     the model path), deterministic cuDNN: fp32 probabilities to 1e-4 or 4x
     the spread that a +-1e-6 nudge of the plain scan's output causes (a
     plain rerun logged beside it), with two controls logged against that
     bound (the segmented kernels without their seeds, which must exceed
     it, and the kernels on bf16 inputs); the gradients against the plain
     scan's backward on kernel H's values (1e-3) and the strict plain path's
     loss (1e-5); the strict path's worst leaf and the nudges' spread logged
  23. phase 7 for CD-Mamba: the train step at 16 x 256^2, H-fwd, H-ckpt and
     H-bwd 33 times per step (and, per segmented call, the carry twice and
     the adjcarry once), no other kernel; the kernel path's rounds alone
  24. kernel J (`scan_states`) and the general route (`_StatesScan`) vs
     `selective_scan_plain`: N in {1, 4, 8, 16, 32}, softplus on and off,
     fp32 y and all seven gradients; the calls kernels H and I refuse (N !=
     16, no softplus, fp16, float64) through both contracts; J alone at
     (B, 62500, 1024) fp32 (one segment) and at (2, 62500, 256) (16
     strips: chained segments), both directions, bitwise twice; the A/B
     of J's route against H at L = 62500, Dch 64, G 2, N 16, forward and
     forward + backward, bf16; H and I at 70000 rows, forward and backward
  27. kernel I at K = 8 (RS-Mamba's eight directions, 256 rows a call):
     I-fwd vs `cross_selective_scan_plain` at the four stage shapes of 16 x
     256^2 ((32, 8, L, Dk) for (L, Dk) in (4096, 192), (1024, 384), (256,
     768), (64, 1536)), fp32 and bf16, one launch a call; I-ckpt's states and I-ckpt + I-bwd's seven
     gradients vs the plain version at (4, 8, 1024, 384), fp32; what
     `scan.seg_count` gives at each of RS-Mamba's four stage shapes (logged:
     the grouped contract never segments); then I-fwd's time summed over the
     15 calls of one RS-Mamba forward at 16 x 256^2 and I-ckpt's and I-bwd's
     over one train step's, bf16, beside their bounds (phase 13's formula)
  28-31. phases 5-8 for get_model("rs_mamba") (51.95 M parameters; weights
     seeded as phase 15's): the eval step (I-fwd 15 times per batch), the
     fp32 model, the train step (I-fwd, I-ckpt and I-bwd 15 times per step,
     no other kernel; the kernel path's rounds alone: the plain scan's
     checkpointed backward does not fit the card at K = 8 and batch 16) and
     its fp32 gradients, held as phase 18 holds ChangeMamba's, every pass
     drawing the same DropPath masks
  32. the layer family: SS2D at K = 8, scan_variant 1d and 2d, xv1aact,
     xv2amul and xv3asoftmax (kernel I: I-fwd once a forward, I-ckpt and
     I-bwd once a backward), and d_state 8 (kernel J: once forward, twice
     backward), fp32 at (2, 32, 32, 96), kernel path vs plain path; then
     RS-Mamba's fp32 forward + backward at batch 2, 256^2, with
     use_checkpoint (remat) vs without: the loss to 1e-6, every gradient
     within 1e-6 of the leaf's largest element (or, above that, 4x the
     spread between two runs without remat: the head's bilinear backward
     adds with atomics), I-fwd 30 launches (15 more: the recompute) against
     15, and both peaks of device memory; then one bf16 train step
     (`make_train_step`, bf16 copies of the masters swapped in) at batch 2
     with and without remat: the loss to 1e-6, I-fwd 30 and 15 launches
  26. (before 25's results) the CLIs from PNG files: the synthetic set
     at 256^2 (32 train, 16 val, 16 test) written by `data/png.py`;
     `cli.train` on SMOW_Net (bf16, batch 16, 8 loader threads, 2 epochs,
     --profile): E, C, A-bwd, F and F-bwd exactly once per train step, D
     and F (fp32) once per val batch, a finite loss, train.txt, val.txt and
     metrics.jsonl with a line per epoch, `best` and `last`, and a profiler
     trace that names those kernels' device functions; `--resume last` to
     epoch 3: the resume line, the parameters, BN buffers, optimizer count
     (4) and moments bitwise `last`'s before the first step, epoch 3 in
     train.txt; `cli.test` on `best` on the kernel path and the plain path:
     D and F 16 times on the kernel path, none on the plain one, confusion
     matrices within 1e-4 of the pixel count, and the 16 PNGs decoded (by
     `data/png.py`) to `colorize` of a prediction whose pixel classes sum
     to the matrix; then, with the card's name and power limit, the
     loader's batches/s (the engine, through `prefetch_to_device`, and PNG
     decode alone), the CLI's ms per train step beside phase 7's and its
     fp32 validation's ms per batch
  25. the kernels' JSON line, the card's line, then the result line last

Bounds: fp32 kernels against fp32 plain versions differ only in summation
order (atomics in D, E, A-bwd and B, a different reduction order in A-fwd,
C, F and F-bwd): 1e-5 of the largest output, 1e-4 where a sum runs over
many rows or the atomics contend (F-bwd's weight gradients, the token
chain's whole VJP). bf16 kernels compute in fp32 and round once on output,
so they are held against the plain version run in fp32 on the same bf16
inputs, to one bf16 rounding (2^-8 relative) of the largest output. The
bf16 F and F-bwd run the MLP's products (two in F: h, out; five in F-bwd:
h, dhg, dyn, dw1, dw2) on the tensor cores, bf16 operands with fp32
accumulation: the weights at their bf16 values (the plain version rounds
them so), g as given, and each fp32 activation operand (LN2(y1), GELU(h),
dh; both sides of dw1) split into bf16 hi + lo, which puts a product within
about 2^-17 of its fp32 value; everything else is fp32 on the CUDA cores,
and the outputs round once, so the bound is the same.

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
each chunk), timed as forward + backward less the forward with its graph;
each plain time is one call with no warm-up, as phase 19 takes H's (the
plain scans' seconds would otherwise crowd the script's time limit). The
timed scans' inputs (phases 13, 14, 19, 20's A/B, 27) are drawn on the
card from a seed: numpy's draws at these sizes took most of those phases'
seconds; the checks' inputs are numpy-seeded.

"""

from __future__ import annotations

import collections
import contextlib
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

# CD-Mamba's train step allocates tensors of many sizes around its segmented
# scans; expandable segments keep the cache from fragmenting across phases
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

BF16_REL = 2.0 ** -8
PROFILE_DIR = os.path.join("chiprun_out", "profile")


START = time.perf_counter()


def log(msg: str) -> None:
    """Print a line; a phase's heading ends with the seconds since the start."""
    if msg.startswith("phase "):
        msg += f" [{time.perf_counter() - START:.0f} s]"
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


def launch_ms(fn, entry: str, iters: int = 5) -> float:
    """Device time per call of `fn` of the launches of C entry `entry` alone:
    CUDA events recorded on the current stream just before and just after
    each such launch (`_kernels.call`), so the casts, allocations and sums
    that `fn` does around the kernel stay out; after one warm-up call. Not
    the profiler (`kernel_only_ms`): in phase 19, after the plain scan's
    long runs, its sessions have come back without any device event."""
    from smow_net_tpu_torch.ops import _kernels

    fn()
    call, pairs = _kernels.call, []

    def timed(name, *args, **kwargs):
        if name != entry:
            return call(name, *args, **kwargs)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call(name, *args, **kwargs)
        end.record()
        pairs.append((start, end))

    _kernels.call = timed
    try:
        for _ in range(iters):
            fn()
    finally:
        _kernels.call = call
    torch.cuda.synchronize()
    require(pairs, f"{entry} was not launched in {iters} calls")
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


def ptxas_lines(kernel: str) -> list:
    """The build's ptxas lines (registers, spills, shared memory) of every
    instantiation whose mangled name contains `kernel`, each prefixed with
    that name."""
    from smow_net_tpu_torch.ops import _kernels

    lines, current = [], ""
    for line in _kernels.build_report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            current = m.group(1)
        elif kernel in current and ("registers" in line or "spill" in line):
            lines.append(f"{current}: {line.strip()}")
    return lines


def require_no_spills(kernel: str, count: int, label: str) -> None:
    """Log the ptxas lines of `kernel` and require `count` instantiations,
    none spilling (the kernels must have been built by this process)."""
    from smow_net_tpu_torch.ops import _kernels

    require(_kernels.build_report, "this process built the kernels (ptxas lines to read)")
    lines = ptxas_lines(kernel)
    for line in lines:
        log(f"  ptxas {line}")
    spills = [line for line in lines if "spill stores" in line]
    require(len(spills) == count and all("0 bytes spill stores, 0 bytes spill loads" in line
                                         for line in spills),
            f"{label} spill nothing: {spills}")


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


def check_nan(label: str, got: torch.Tensor, want: torch.Tensor, atol: float,
              rtol: float) -> float:
    """`check` for outputs that hold NaN: NaN at the same elements (at least
    one), the finite ones within atol + rtol * their largest."""
    got, want = got.float(), want.float()
    nan = torch.isnan(want)
    require(bool(nan.any()), f"{label}: the plain version gives no NaN")
    require(torch.equal(torch.isnan(got), nan),
            f"{label}: NaN at {int(torch.isnan(got).sum())} elements, the plain version at "
            f"{int(nan.sum())}, or at others")
    return check(f"{label} ({int(nan.sum())} NaN)", got[~nan], want[~nan], atol, rtol)


def with_nans(grid: torch.Tensor) -> torch.Tensor:
    """A copy of `grid` (B >= 2, Hg >= 4, Wg >= 5) with a NaN x, a NaN y and
    both NaN at interior pixels, and both NaN at the last pixel."""
    grid = grid.clone()
    grid[0, 1, 2, 0] = float("nan")
    grid[0, 2, 3, 1] = float("nan")
    grid[1, 3, 4] = float("nan")
    grid[-1, -1, -1] = float("nan")
    return grid


HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def bound(n_bytes: float, flops: float) -> dict:
    """bound_ms and bound_by for work of `n_bytes` and `flops` in bf16."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def log_port_kernels(on_device, calls: int, unit: str) -> None:
    """The port's own kernels (each `__global__` function of csrc/) among
    the profiler's device events, each instantiation's device time per
    `unit` over `calls` calls: the template arguments tell the modes of one
    kernel apart (the forward sweep's mode 3 is the adjcarry)."""
    from smow_net_tpu_torch.ops import _kernels

    names = set()
    for src in _kernels.CSRC.glob("*.cu*"):
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                                src.read_text()))
    ours = [e for e in on_device if any(f"::{n}<" in e.key or f"::{n}(" in e.key for n in names)]
    for e in sorted(ours, key=lambda e: -e.self_device_time_total):
        name = e.key.split("::", 1)[1].split("(", 1)[0]
        log(f"    port kernel {e.self_device_time_total / 1e3 / calls:8.3f} ms/{unit}  "
            f"{e.count // calls:4d}x  {name}")


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
    chains' six ops, the decoder layer and the two selective scans, whose
    plain versions then run under torch autograd."""
    from smow_net_tpu_torch.ops import scan, warp, xattn

    names = ("token_scatter", "token_scatter_bwd", "grid_sample_t_vjp", "grid_sample_bwd",
             "grid_sample", "grid_sample_transpose")
    saved = ([getattr(warp, n) for n in names], xattn.cross_layer_head1,
             scan.cross_selective_scan, scan.selective_scan)
    for n in names:
        setattr(warp, n, getattr(warp, n + "_plain"))
    xattn.cross_layer_head1 = xattn.cross_layer_head1_plain
    scan.cross_selective_scan = scan.cross_selective_scan_plain
    scan.selective_scan = scan.selective_scan_plain
    try:
        yield
    finally:
        for n, f in zip(names, saved[0]):
            setattr(warp, n, f)
        xattn.cross_layer_head1 = saved[1]
        scan.cross_selective_scan = saved[2]
        scan.selective_scan = saved[3]


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


class _FlatKernelValuePlainGrad(torch.autograd.Function):
    """`_KernelValuePlainGrad` for the flat contract (CD-Mamba's): kernel
    H's output on the current route, the plain version's gradient."""

    @staticmethod
    def forward(ctx, u, delta, A, Bm, Cm, D, bias):
        from smow_net_tpu_torch.ops import scan

        ctx.save_for_backward(u, delta, A, Bm, Cm, D, bias)
        return scan._FlatScan.apply(u, delta, A, Bm, Cm, D, bias)

    @staticmethod
    def backward(ctx, gy):
        from smow_net_tpu_torch.ops import scan

        args = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = scan.selective_scan_plain(*args, delta_softplus=True)
            return torch.autograd.grad(y, args, gy)


@contextlib.contextmanager
def swap_scan(fn, flat=False):
    """Route the model's selective scan (`cross_selective_scan`, or with
    `flat` the flat contract's `selective_scan`) through `fn(u, dt, A, B, C,
    D, dt_bias)` (the models always take the softplus)."""
    from smow_net_tpu_torch.ops import scan

    name = "selective_scan" if flat else "cross_selective_scan"
    saved = getattr(scan, name)

    def call(xs, dts, A, Bs, Cs, Ds=None, dt_bias=None, delta_softplus=True):
        require(delta_softplus, "the model's scans take the softplus")
        return fn(xs, dts, A, Bs, Cs, Ds, dt_bias)

    setattr(scan, name, call)
    try:
        yield
    finally:
        setattr(scan, name, saved)


@contextlib.contextmanager
def seg_route(min_l: int):
    """The flat scan's route with `scan.SEG_MIN_L` set to `min_l` (1 << 30:
    the sequential route, never segmented)."""
    from smow_net_tpu_torch.ops import scan

    saved = scan.SEG_MIN_L
    scan.SEG_MIN_L = min_l
    try:
        yield
    finally:
        scan.SEG_MIN_L = saved


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

    def case(label, shape, spike=False, far=False):
        F_, H, W, C = shape
        a = torch.from_numpy((rng.normal(size=shape) * 2.0).astype(np.float32)).to(dev)
        flow = torch.from_numpy((rng.normal(size=(F_, H, W, 2)) * 3.0).astype(np.float32))
        if spike:   # spike along the left column; the grid samples only the right one
            a[:, :, 0, 0] = 150.0
            flow[..., 0] = 3.0 * W
        if far:
            flow = torch.from_numpy(far_flow(rng, F_, H, W))
        grid = warp.flow_grid(flow.to(dev), H, W)
        log_branches(label, grid, C, far)
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
    case("far flow", (32, 128, 128, 8), far=True)
    return result


def far_flow(rng, F_, H, W) -> np.ndarray:
    """A far-scattered flow (F, H, W, 2) fp32 in pixels, uniform over twice
    the image's size each way: the grid clamps it to the borders, so every
    tile's corners span the image, too wide a box for the tile scatter to
    sort (its direct branch)."""
    return (rng.uniform(-2.0, 2.0, size=(F_, H, W, 2)) * np.array([W, H])).astype(np.float32)


def log_branches(label: str, grid: torch.Tensor, C: int, far: bool = False) -> None:
    """Log how many tiles of the grid the tile scatter (kernels B, A-bwd, D,
    E) sorts and how many it adds directly; a far-scattered grid must take
    the direct branch."""
    from smow_net_tpu_torch.ops import warp

    n_sorted, n_direct = warp.tile_scatter_branches(grid, *grid.shape[1:3], C)
    log(f"  {label}: tile scatter at C = {C}: {n_sorted} tiles sorted, {n_direct} direct")
    require(not far or n_direct > 0, f"{label}: the far flow takes the direct branch")


def _token_inputs(dev, shape, seed, spike=False, far=False):
    """Logits a, the flow grid, and two cotangent-like tensors, numpy-seeded;
    with `spike`, a logit spike > 87 on the left column that the grid never
    samples (the zaw underflow case); with `far`, a far-scattered flow."""
    from smow_net_tpu_torch.ops import warp

    rng = np.random.default_rng(seed)
    F_, H, W, C = shape
    a = (rng.normal(size=shape) * 2.0).astype(np.float32)
    flow = (rng.normal(size=(F_, H, W, 2)) * 3.0).astype(np.float32)
    if spike:
        a[:, :, 0, 0] = 150.0
        flow[..., 0] = 3.0 * W
    if far:
        flow = far_flow(rng, F_, H, W)
    r, s = (torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(dev)
            for sh in (shape, (F_, C)))
    flow = torch.from_numpy(flow).to(dev)
    return torch.from_numpy(a).to(dev), flow, warp.flow_grid(flow, H, W), r, s


def _smooth_grid(dev, shape, seed):
    """The flow grid of a smooth flow: a numpy-seeded (F, 8, 8) field of two
    channels with std 3 (the units of `_token_inputs`' i.i.d. flow),
    bilinearly upsampled to (H, W)."""
    from smow_net_tpu_torch.ops import warp

    F_, H, W, _ = shape
    field = (np.random.default_rng(seed).normal(size=(F_, 2, 8, 8)) * 3.0).astype(np.float32)
    flow = torch.nn.functional.interpolate(torch.from_numpy(field).to(dev), size=(H, W),
                                           mode="bilinear", align_corners=True)
    return warp.flow_grid(flow.permute(0, 2, 3, 1).contiguous(), H, W)


def smooth_flow_case(dev, name: str, x: torch.Tensor, g: torch.Tensor) -> None:
    """Kernel A-bwd (`grid_sample_bwd` of image x and cotangent g) or B
    (`grid_sample_transpose` of g into x's shape) on the smooth flow at x's
    shape, bf16: held against its plain version, then its time from a CUDA
    graph, alone (profiler) and the library call's on the same inputs.
    Logged only: the JSON line keeps the i.i.d. flow's numbers."""
    from smow_net_tpu_torch.ops import warp

    H, W = x.shape[1:3]
    grid = _smooth_grid(dev, x.shape, 37)
    if name == "grid_sample_bwd":
        label, mask = "A-bwd", [True, True]
        call = lambda: warp.grid_sample_bwd(x, g, grid)
        (dx, dw), (dx_p, dw_p) = call(), warp.grid_sample_bwd_plain(x.float(), g.float(), grid)
        check("A-bwd smooth flow bf16 dx", dx, dx_p, 1e-5, BF16_REL)
        check("A-bwd smooth flow bf16 dw", dw, dw_p, 1e-5, 1e-5)
    else:
        label, mask = "B", [True, False]
        call = lambda: warp.grid_sample_transpose(g, grid, (H, W))
        check("B smooth flow bf16", call(),
              warp.grid_sample_transpose_plain(g.float(), grid, (H, W)), 1e-5, BF16_REL)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    g_nchw = g.permute(0, 3, 1, 2).contiguous()
    grid_dt = grid.to(x.dtype)
    library = graph_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
        g_nchw, x_nchw, grid_dt, 0, 1, True, mask))
    log(f"  {label} smooth flow bf16 time: kernel {graph_ms(call):.4f} ms (CUDA graph), "
        f"alone {kernel_only_ms(call, name):.4f} ms (profiler), library {library:.4f} ms "
        "(NCHW, CUDA graph)")


def phase_token_backward(dev) -> dict:
    """Kernels E, C and A-bwd against their plain versions, then the whole
    token-chain VJP on the kernel path against the plain path."""
    from smow_net_tpu_torch.ops import warp

    log("phase 3b: token chain train kernels E, C, A-bwd vs their plain versions")
    results = {"token_scatter_fwd_eaw": {}, "grid_sample_t_vjp": {}, "grid_sample_bwd": {}}

    def case(label, shape, spike=False, far=False):
        a, flow, grid, r, _ = _token_inputs(dev, shape, 30, spike, far)
        log_branches(label, grid, shape[-1], far)
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
                ab_call = lambda: warp.grid_sample_bwd(x, daw, grid)
                ab.update(max_abs_err=err_a, ms=graph_ms(ab_call),
                          plain_ms=graph_ms(lambda: warp.grid_sample_bwd_plain(x, daw, grid)),
                          library_ms=graph_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
                              g_nchw, x_nchw, grid_dt, 0, 1, True, [True, True])),
                          **bound(nbytes(x, daw, grid, da, dw_a), 26 * x.numel()))
                log_times(results, label)
                log(f"  A-bwd alone {kernel_only_ms(ab_call, 'grid_sample_bwd'):.4f} ms "
                    "(profiler)")
                smooth_flow_case(dev, "grid_sample_bwd", x, daw)

    case("slice", (32, 128, 128, 8))
    case("spread>87", (32, 128, 128, 8), spike=True)
    case("W*C=2048", (32, 128, 128, 16))
    case("far flow", (32, 128, 128, 8), far=True)

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
                smooth_flow_case(dev, "grid_sample_transpose", x, g)

    case("LW chain", (32, 128, 128, 8))
    case("border-clamped", (32, 128, 128, 8), spike=True)
    case("C=16", (32, 128, 128, 16))
    return results


def phase_unfused_chain(dev) -> None:
    """The unfused token chain's VJP on the kernel path against the plain
    path; then the three train chains timed at SMOW_Net's and SMOW_Net_LW's
    shape."""
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
    for chain in ("hybrid", "unfused", "fused", "fused", "unfused", "hybrid"):
        def fwd_bwd():
            at, ft = a.clone().requires_grad_(), flow.clone().requires_grad_()
            ew, zaw = warp.token_softmax_scatter(at, ft, train_chain=chain)
            torch.autograd.grad((ew * r).sum() + (zaw * s).sum(), (at, ft))

        times.setdefault(chain, []).append(cuda_ms(fwd_bwd))
    log("  (finding) train chain forward + backward, bf16 (32, 128, 128, 8), CUDA events "
        "over 20 calls, in turns: "
        + ", ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ms" for k, v in times.items()))


def phase_token_bwd(dev) -> dict:
    """Kernel D-bwd against its plain version, and the fused chain's whole
    VJP on the kernel path against the plain path; then D-bwd's time."""
    from smow_net_tpu_torch.ops import _kernels, warp

    log("phase 3e: kernel D-bwd token_scatter_bwd vs token_scatter_bwd_plain (fp32: da and the "
        "summed weight rows to 1e-4 of the largest element, atomics order and two gathers' "
        "sums; bf16: one bf16 rounding of the plain version in fp32 on the same inputs)")
    require_no_spills("token_scatter_bwd_kernel", 4, "D-bwd's four instantiations")
    result = {}

    def case(label, shape, spike=False, far=False):
        a, _, grid, r, s = _token_inputs(dev, shape, 35, spike, far)
        log_branches(f"D-bwd {label}", grid, shape[-1], far)
        for dt in (torch.float32, torch.bfloat16):
            x, ew_bar = a.to(dt), r.to(dt)
            m = x.amax(dim=(1, 2)).float()
            before = _kernels.launches["token_scatter_bwd"]
            da, dw = warp.token_scatter_bwd(x, grid, m, ew_bar, s)
            torch.cuda.synchronize()
            require(_kernels.launches["token_scatter_bwd"] == before + 1,
                    "D-bwd launched once per call")
            da_p, dw_p = warp.token_scatter_bwd_plain(x.float(), grid, m, ew_bar.float(), s)
            name = f"D-bwd {label} {str(dt)[6:]}"
            fp32 = dt == torch.float32
            err = max(check(f"{name} da", da, da_p, 1e-6, 1e-4 if fp32 else BF16_REL),
                      check(f"{name} dw", dw, dw_p, 1e-6, 1e-4),
                      check(f"{name} dgrid", warp.corner_weights_vjp(grid, dw, *shape[1:3]),
                            warp.corner_weights_vjp(grid, dw_p, *shape[1:3]), 1e-6, 1e-4))
            if spike:
                require(bool((da[..., 0] == 0).all()),
                        "large-spread case: eaw, daw and da of the spiked channel must be 0")
            if label == "slice" and dt == torch.bfloat16:
                call = lambda: warp.token_scatter_bwd(x, grid, m, ew_bar, s)
                result.update(max_abs_err=err, library_ms=None, ms=graph_ms(call),
                              plain_ms=graph_ms(lambda: warp.token_scatter_bwd_plain(
                                  x, grid, m, ew_bar, s)),
                              **bound(nbytes(x, grid, m, ew_bar, s, da, dw), 40 * x.numel()))
                log(f"  slice bf16 time: kernel {result['ms']:.4f} ms, plain "
                    f"{result['plain_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms (CUDA "
                    f"graph); kernel alone {kernel_only_ms(call, 'token_scatter_bwd'):.4f} ms "
                    "(profiler)")

    case("slice", (32, 128, 128, 8))
    case("spread>87", (32, 128, 128, 8), spike=True)
    case("W*C=2048", (32, 128, 128, 16))
    case("far flow", (32, 128, 128, 8), far=True)

    log("  fused token_softmax_scatter VJP, fp32: kernel path (D, D-bwd) vs plain path (bound "
        "1e-4 of the largest element, as phase 3b)")
    for label, spike in (("slice", False), ("spread>87", True)):
        a, flow, _, r, s = _token_inputs(dev, (32, 128, 128, 8), 36, spike)

        def grads():
            at, ft = a.clone().requires_grad_(), flow.clone().requires_grad_()
            ew, zaw = warp.token_softmax_scatter(at, ft, train_chain="fused")
            return torch.autograd.grad((ew * r).sum() + (zaw * s).sum(), (at, ft))

        before = dict(_kernels.launches)
        got = grads()
        runs = {n: c - before.get(n, 0) for n, c in _kernels.launches.items()
                if c != before.get(n, 0)}
        require(runs == {"token_scatter_fwd": 1, "token_scatter_bwd": 1},
                f"the fused chain runs D and D-bwd once each: {runs}")
        with plain_ops():
            want = grads()
        for part, g, w in zip(("da", "dflow"), got, want):
            check(f"{label} {part}", g, w, 1e-6, 1e-4)
    return result


WARP_MODES = (("border", True), ("border", False), ("zeros", True), ("zeros", False))


def phase_warp_modes(dev) -> None:
    """Kernels A-fwd, B, C and A-bwd in each (padding_mode, align_corners)
    pair at C = 8 and 32 against their plain versions, fp32."""
    from smow_net_tpu_torch.ops import _kernels, warp

    log("phase 3f: kernels A-fwd, B, C, A-bwd in the four (padding_mode, align_corners) pairs "
        "at (32, 128, 128, C), C = 8 and 32, fp32, on grids reaching beyond [-1, 1] (outputs "
        "1e-5 of the largest element, weight rows and dgrid 1e-4), then on the same grids with "
        "NaN coordinates (NaN at the same elements, the finite ones at those bounds)")
    names = ("grid_sample_fwd", "grid_sample_transpose", "grid_sample_t_vjp", "grid_sample_bwd")
    for C in (8, 32):
        g = torch.Generator(dev).manual_seed(60 + C)
        x = torch.randn(32, 128, 128, C, device=dev, generator=g)
        other = torch.randn(32, 128, 128, C, device=dev, generator=g)
        grid = torch.rand(32, 128, 128, 2, device=dev, generator=g) * 2.4 - 1.2
        hw = (128, 128)
        for mode in WARP_MODES:
            before = {n: _kernels.launches[n] for n in names}
            got = (warp.grid_sample(x, grid, *mode),
                   warp.grid_sample_transpose(other, grid, hw, *mode),
                   warp.grid_sample_t_vjp(x, other, grid, *mode),
                   warp.grid_sample_bwd(x, other, grid, *mode))
            torch.cuda.synchronize()
            require(all(_kernels.launches[n] == before[n] + 1 for n in names),
                    "each warp kernel launched once per mode")
            want = (warp.grid_sample_plain(x, grid, *mode),
                    warp.grid_sample_transpose_plain(other, grid, hw, *mode),
                    warp.grid_sample_t_vjp_plain(x, other, grid, *mode),
                    warp.grid_sample_bwd_plain(x, other, grid, *mode))
            label = f"C={C} {mode[0]} align={mode[1]}"
            check(f"A-fwd {label}", got[0], want[0], 0.0, 1e-5)
            check(f"B {label}", got[1], want[1], 0.0, 1e-5)
            for kname, (o, dw), (o_p, dw_p) in (("C", got[2], want[2]),
                                                ("A-bwd", got[3], want[3])):
                check(f"{kname} {label} out", o, o_p, 0.0, 1e-5)
                check(f"{kname} {label} dw", dw, dw_p, 0.0, 1e-4)
                check(f"{kname} {label} dgrid", warp.corner_weights_vjp(grid, dw, *hw, *mode),
                      warp.corner_weights_vjp(grid, dw_p, *hw, *mode), 0.0, 1e-4)
            # the same grid with NaN coordinates: both sides on it, NaN at
            # the same elements (tests/test_torch_warp_nan.py's contract)
            nan_grid = with_nans(grid)
            got = (warp.grid_sample(x, nan_grid, *mode),
                   warp.grid_sample_transpose(other, nan_grid, hw, *mode),
                   warp.grid_sample_t_vjp(x, other, nan_grid, *mode),
                   warp.grid_sample_bwd(x, other, nan_grid, *mode))
            want = (warp.grid_sample_plain(x, nan_grid, *mode),
                    warp.grid_sample_transpose_plain(other, nan_grid, hw, *mode),
                    warp.grid_sample_t_vjp_plain(x, other, nan_grid, *mode),
                    warp.grid_sample_bwd_plain(x, other, nan_grid, *mode))
            check_nan(f"A-fwd {label} NaN grid", got[0], want[0], 0.0, 1e-5)
            check_nan(f"B {label} NaN grid", got[1], want[1], 0.0, 1e-5)
            for kname, (o, dw), (o_p, dw_p) in (("C", got[2], want[2]),
                                                ("A-bwd", got[3], want[3])):
                check_nan(f"{kname} {label} NaN grid out", o, o_p, 0.0, 1e-5)
                check_nan(f"{kname} {label} NaN grid dw", dw, dw_p, 0.0, 1e-4)
                check_nan(f"{kname} {label} NaN grid dgrid",
                          warp.corner_weights_vjp(nan_grid, dw, *hw, *mode),
                          warp.corner_weights_vjp(nan_grid, dw_p, *hw, *mode), 0.0, 1e-4)
        del x, other, grid, nan_grid, got, want

    log("  kernels D, E and D-bwd (border, align_corners) at (32, 128, 128, C), C = 8 and 16, "
        "fp32, on a flow grid with NaN coordinates vs their plain versions on it (ew, zaw, eaw "
        "1e-5 of the largest finite element; da, dw 1e-4)")
    for C in (8, 16):
        a, _, grid, r, s = _token_inputs(dev, (32, 128, 128, C), 38)
        grid = with_nans(grid)
        log_branches(f"NaN grid C={C}", grid, C)
        m = a.amax(dim=(1, 2)).float()
        names = ("token_scatter_fwd", "token_scatter_fwd_eaw", "token_scatter_bwd")
        before = {n: _kernels.launches[n] for n in names}
        got = (warp.token_scatter(a, grid, m), warp.token_scatter(a, grid, m, residual=True),
               warp.token_scatter_bwd(a, grid, m, r, s))
        torch.cuda.synchronize()
        require(all(_kernels.launches[n] == before[n] + 1 for n in names),
                "D, E and D-bwd launched once each on the NaN grid")
        want = (warp.token_scatter_plain(a, grid, m),
                warp.token_scatter_plain(a, grid, m, residual=True),
                warp.token_scatter_bwd_plain(a, grid, m, r, s))
        for kname, outs, refs in (("D", got[0], want[0]), ("E", got[1], want[1])):
            for part, o, o_p in zip(("ew", "zaw", "eaw"), outs, refs):
                check_nan(f"{kname} C={C} NaN grid {part}", o, o_p, 1e-6, 1e-5)
        check_nan(f"D-bwd C={C} NaN grid da", got[2][0], want[2][0], 1e-6, 1e-4)
        check_nan(f"D-bwd C={C} NaN grid dw", got[2][1], want[2][1], 1e-6, 1e-4)
        del a, grid, r, s, got, want


def phase_ofw_route(dev) -> None:
    """The reference's unfused OFW token route (OFW.forward, A-fwd and
    A-bwd at C = 32) against the fused one SMOWNet runs, on SMOW_Net's
    (16, 32, 2, 128, 128) features with numpy-seeded weights, fp32."""
    from smow_net_tpu_torch.models import get_model
    from smow_net_tpu_torch.models.smow_net import ofw_tokens_fused
    from smow_net_tpu_torch.ops import _kernels

    log("phase 3g: TokenTransformerEncoder(OFW(x)) (A-fwd, A-bwd at C = 32) vs "
        "ofw_tokens_fused (D; E, C, A-bwd at C = 8) at (16, 32, 2, 128, 128), fp32, eval-mode "
        "BN: the tokens and the features' gradient to 1e-4 of the largest element (two routes "
        "that sum over 16384 pixels in other orders)")
    model = get_model("smow_net")
    model.load_state_dict(seeded_state_dict(model, 0))
    ofw, tok = model.OFW.eval(), model.Transformer_Encoder
    rng = np.random.default_rng(13)
    x0 = torch.from_numpy(rng.normal(size=(16, 32, 2, 128, 128)).astype(np.float32)).to(dev)
    r = torch.from_numpy(rng.normal(size=(16, 8, 128)).astype(np.float32)).to(dev)

    def run(route):
        x = x0.clone().requires_grad_()
        out = route(x)
        return out.detach(), torch.autograd.grad((out * r).sum(), x)[0]

    before = dict(_kernels.launches)
    got, dx = run(lambda x: tok(ofw(x)))
    runs = {n: c - before.get(n, 0) for n, c in _kernels.launches.items()
            if c != before.get(n, 0)}
    require(runs == {"grid_sample_fwd": 1, "grid_sample_bwd": 1},
            f"OFW.forward's warp runs A-fwd and A-bwd once each at C = 32: {runs}")
    want, dx_f = run(lambda x: ofw_tokens_fused(ofw, tok, x))
    check("tokens, OFW route vs fused route", got, want, 0.0, 1e-4)
    check("dx, OFW route vs fused route", dx, dx_f, 0.0, 1e-4)
    del model, x0, dx, dx_f


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
                result["ms"] = cuda_ms(lambda: xattn._kernel_bwd(args, gy, scale, None, 1e-5))
                out = xattn.cross_layer_head1_plain(*args, scale=scale)
                result["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    out, args, gy, retain_graph=True))
                weights = [a.detach().float() for a in args[1:]]
                result.update(bound(nbytes(args[0], gy, args[0], *weights, *weights),
                                    _layer_flops(16, 16384, D, hid=2 * D, mlp_products=5)),
                              library_ms=None)
                log(f"  bf16 time: kernel {result['ms']:.4f} ms, plain backward "
                    f"{result['plain_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms")
    for dt, how in ((torch.bfloat16, "each block's record written once"),
                    (torch.float32, "a block's row added into per 64-row tile")):
        blocks, floats = xattn.layer_bwd_slab(16, 16384, D, dt, dev)
        log(f"  F-bwd slab per call at (16,16384,{D}) {str(dt)[6:]}: {blocks} blocks x "
            f"{floats} floats = {blocks * floats * 4} bytes ({how})")
    for kernel in ("layer_fwd_tc", "layer_bwd_tc"):
        for line in ptxas_lines(kernel):
            log(f"  ptxas {line}")
    compare(f"ragged (2,1000,{D})", _layer_args(dev, 2, 1000, D=D, hid=2 * D, seed=5),
            torch.from_numpy(np.random.default_rng(7).normal(
                size=(2, 1000, D)).astype(np.float32)).to(dev), None, torch.float32)
    return result


G_KERNELS = ("cross_attn_fwd", "cross_attn_bwd")


def reset_launches() -> None:
    """Set every launch count to 0. Kernels G and G-bwd run only on their op
    path (phases 4c and 4d, which take their counts and zero them): each
    reset first checks that no phase since the last one launched them."""
    from smow_net_tpu_torch.ops import _kernels

    runs = {n: _kernels.launches[n] for n in G_KERNELS if _kernels.launches[n]}
    require(not runs, f"a model or plain path launched kernel G or G-bwd: {runs}")
    _kernels.launches.clear()


def _attn_args(dev, B, N, D, h=8, M=8, seed=8, spread=False):
    """Kernel G's 8 inputs (the decoder layer's first 8) and a cotangent,
    numpy-seeded; with `spread`, head 0's keys scaled by 1e4, so that its
    logits lie ~1e3 above the other heads' (a shared per-pixel softmax shift
    would underflow those heads to o = 0)."""
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    args = [f(B, N, D), f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, h, scale=0.1),
            f(B, M, h), f(B, M, h), f(h, D, scale=0.1), f(D, scale=0.1)]
    if spread:
        args[4][..., 0] *= 1e4
    return args, f(B, N, D)


def attn_f64(x, ln_s, ln_b, wq, k, v, w_out, b_out, *, scale, eps=1e-5):
    """`cross_attn_head1_plain`'s arithmetic in the dtype of its inputs
    throughout (float64 for a reference): the plain version's own LayerNorm
    (`layer_norm32`) computes in fp32 whatever its input's dtype."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x * x).mean(dim=-1, keepdim=True) - mu * mu
    q = ((x - mu) * torch.rsqrt(var + eps) * ln_s + ln_b) @ wq
    attn = torch.softmax(q[..., None] * (k * scale).transpose(1, 2)[:, None], dim=-1)
    return (attn * v.transpose(1, 2)[:, None]).sum(dim=-1) @ w_out + b_out + x


def _random_perm(dev, D, seed=9):
    p = np.zeros((D, D), np.float32)
    p[np.arange(D), np.random.default_rng(seed).permutation(D)] = 1.0
    return torch.from_numpy(p).to(dev)


def _attn_flops(B, N, D, h=8, M=8, backward=False):
    """FLOPs of the attention sublayer per call: per row the two
    projections (2 D h each), the softmax over M and o, LayerNorm and the
    residual; the backward recomputes q and o and adds do, dxn, dwq and dwo
    (2 D h each), the softmax's and LayerNorm's backward."""
    if backward:
        return B * N * (12 * D * h + 16 * h * M + 20 * D)
    return B * N * (4 * D * h + 6 * h * M + 10 * D)


def _attn_cases(dev):
    """(label, args, cotangent, perm, dtypes) of phases 4c and 4d: the full
    width (16, 16384, D) at D = 128 and 64 with no permutation, the
    decoder's lane fold and a random one; D = 256, 384 and 512 at (2, 4096,
    D); the ragged N = 1000 at every built width; the logit spread."""
    from smow_net_tpu_torch.ops import xattn

    both = (torch.float32, torch.bfloat16)
    for D in (128, 64):
        args, gy = _attn_args(dev, 16, 16384, D)
        for kind, perm in (("none", None), ("decoder", _decoder_perm(dev, D)),
                           ("random", _random_perm(dev, D))):
            yield f"(16,16384,{D}) perm={kind}", args, gy, perm, both
    for D in (256, 384, 512):
        args, gy = _attn_args(dev, 2, 4096, D, seed=D)
        for kind, perm in (("none", None), ("random", _random_perm(dev, D))):
            yield f"(2,4096,{D}) perm={kind}", args, gy, perm, both
    for D, _, _ in xattn._ATTN_SHAPES:
        args, gy = _attn_args(dev, 2, 1000, D, seed=D + 1)
        yield f"ragged (2,1000,{D}) perm=random", args, gy, _random_perm(dev, D), both
    args, gy = _attn_args(dev, 2, 4096, 128, seed=10, spread=True)
    yield "spread (2,4096,128) perm=none", args, gy, None, both


def phase_kernel_g(dev) -> tuple:
    """Kernel G (`cross_attn_fwd`) vs `cross_attn_head1_plain`: an op path,
    since no model runs the attention sublayer alone. Returns G's row and
    the number of launches its checks made (one per call, checked)."""
    from smow_net_tpu_torch.ops import _kernels, xattn

    log("phase 4c: kernel G cross_attn_fwd vs cross_attn_head1_plain (op path)")
    t0 = time.perf_counter()
    require_no_spills("cross_attn_fwd_tc", 2, "G's bf16 body (D = 64, 128)")
    for D in (128, 64):
        ctas, rows, per = xattn.attn_fwd_grid(D, torch.bfloat16, dev)
        log(f"  G's bf16 grid at D = {D}: {ctas} blocks resident in one wave, {per} tiles of "
            f"{rows} rows a block at once")
    before, calls = _kernels.launches["cross_attn_fwd"], 0
    for label, args32, _, perm, dtypes in _attn_cases(dev):
        scale = args32[0].shape[-1] ** -0.5
        for dt in dtypes:
            # weights too at bf16 values, so the fp32 plain run sees the same numbers
            args = [a.to(dt) for a in args32]
            out = xattn.cross_attn_head1(*args, scale=scale, perm=perm)
            calls += 1
            want = xattn.cross_attn_head1_plain(*[a.float() for a in args], scale=scale,
                                                perm=perm)
            require(out.dtype == dt, f"{label}: output dtype {out.dtype}")
            if dt == torch.float32:
                check(f"{label} fp32", out, want, 0.0, 1e-5)
            else:
                check(f"{label} bf16", out, want, 1e-4, BF16_REL)
    torch.cuda.synchronize()
    require(_kernels.launches["cross_attn_fwd"] == before + calls,
            f"kernel G launched once per call: {_kernels.launches['cross_attn_fwd'] - before} "
            f"launches for {calls} calls")
    args32, _ = _attn_args(dev, 2, 64, 128)
    for bad, why in ((_attn_args(dev, 2, 64, 128, h=16)[0], "h = 16"),
                     (_attn_args(dev, 2, 64, 128, M=16)[0], "M = 16"),
                     (_attn_args(dev, 2, 64, 96)[0], "D = 96"),
                     ([a.half() for a in args32], "float16")):
        try:
            xattn.cross_attn_head1(*bad, scale=0.1)
        except ValueError as e:
            log(f"  {why}: ValueError ({e})")
        else:
            raise RuntimeError(f"kernel G's wrapper took {why}, which it is not built for")

    # time, bf16 at SMOW_Net's decoder shape, no permutation
    args32, _ = _attn_args(dev, 16, 16384, 128)
    args = [a.to(torch.bfloat16) for a in args32]
    scale = 128 ** -0.5
    call = lambda: xattn.cross_attn_head1(*args, scale=scale)
    out = call()
    want = xattn.cross_attn_head1_plain(*[a.float() for a in args], scale=scale)
    result = {"max_abs_err": check("timed (16,16384,128) bf16", out, want, 1e-4, BF16_REL)}
    require(torch.equal(out, call()), "G's bf16 output bitwise equal in two runs")
    result["ms"] = graph_ms(call)
    result["plain_ms"] = graph_ms(lambda: xattn.cross_attn_head1_plain(*args, scale=scale))
    result.update(bound(nbytes(args[0], out, *[a.float() for a in args[1:]]),
                        _attn_flops(16, 16384, 128)), library_ms=None)
    alone = launch_ms(call, "cross_attn_fwd", iters=20)
    log(f"  two runs bitwise equal; bf16 time: kernel {result['ms']:.4f} ms (CUDA graph of 20 "
        f"calls), alone {alone:.4f} ms (CUDA events around each launch), plain "
        f"{result['plain_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms ({result['bound_by']}): "
        f"{result['bound_ms'] / result['ms']:.0%} of the bound; 20 calls between events "
        f"{cuda_ms(call):.4f} ms; no PyTorch call computes G (SDPA covers only the softmax . v "
        "core, not the LayerNorm, projections and residual)")
    args64 = [a.to(torch.bfloat16) for a in _attn_args(dev, 16, 16384, 64)[0]]
    call64 = lambda: xattn.cross_attn_head1(*args64, scale=64 ** -0.5)
    ms64, bound64 = graph_ms(call64), nbytes(args64[0], args64[0]) / HBM_BYTES_PER_S * 1e3
    log(f"  (info) bf16 at (16,16384,64): kernel {ms64:.4f} ms (CUDA graph of 20 calls), alone "
        f"{launch_ms(call64, 'cross_attn_fwd', iters=20):.4f} ms, byte bound {bound64:.4f} ms: "
        f"{bound64 / ms64:.0%} of it")
    log(f"  phase 4c took {time.perf_counter() - t0:.1f} s")
    _kernels.launches["cross_attn_fwd"] = 0
    return result, calls


def phase_kernel_g_bwd(dev) -> tuple:
    """Kernel G-bwd (`cross_attn_bwd`): all eight input gradients against
    torch.autograd.grad of the plain version in fp32 on the same inputs.
    Returns G-bwd's row and the number of launches its checks made."""
    from smow_net_tpu_torch.ops import _kernels, xattn

    log("phase 4d: kernel G-bwd cross_attn_bwd vs autograd of cross_attn_head1_plain "
        "(op path)")
    t0 = time.perf_counter()
    require_no_spills("cross_attn_bwd_tc", 2, "G-bwd's bf16 body (D = 64, 128)")
    names = ("x", "ln_scale", "ln_bias", "wq", "k", "v", "w_out", "b_out")
    before = {n: _kernels.launches[n] for n in G_KERNELS}
    calls = 0
    for label, args32, gy32, perm, dtypes in _attn_cases(dev):
        scale = args32[0].shape[-1] ** -0.5
        for dt in dtypes:
            args = [a.to(dt).requires_grad_() for a in args32]
            gy = gy32.to(dt)
            got = torch.autograd.grad(xattn.cross_attn_head1(*args, scale=scale, perm=perm),
                                      args, gy)
            calls += 1
            ref = [a.detach().float().requires_grad_() for a in args]
            want = torch.autograd.grad(
                xattn.cross_attn_head1_plain(*ref, scale=scale, perm=perm), ref, gy.float())
            if dt == torch.float32 and label.startswith("spread"):
                # the fp32 plain version's LayerNorm and q miss 1e-4 here
                # themselves (logits ~1e3): fp32 is held against float64
                plain32 = want
                ref = [a.detach().double().requires_grad_() for a in args]
                want = torch.autograd.grad(attn_f64(*ref, scale=scale), ref, gy.double())
                units = [(u.double() - w).abs().max().item() / (1e-4 * w.abs().max().item())
                         for u, w in zip(plain32, want)]
                log(f"  (info) {label}: the fp32 plain version against float64, in units of "
                    "1e-4 of each leaf's largest element: " +
                    ", ".join(f"d{n} {u:.2f}" for n, u in zip(names, units)))
                want = [w.float() for w in want]
            for n, g, w, a in zip(names, got, want, args):
                require(g.dtype == a.dtype and g.shape == a.shape, f"{label} d{n}: "
                        f"{g.dtype} {tuple(g.shape)}")
                if dt == torch.float32:
                    check(f"{label} fp32 d{n}", g, w, 0.0, 1e-4)
                else:
                    check(f"{label} bf16 d{n}", g, w, 1e-5, BF16_REL)
    torch.cuda.synchronize()
    runs = {n: _kernels.launches[n] - before[n] for n in G_KERNELS}
    require(runs == dict.fromkeys(G_KERNELS, calls),
            f"kernels G and G-bwd launched once per forward and backward: {runs} for {calls}")

    # time, bf16 at SMOW_Net's decoder shape, no permutation: G-bwd alone
    # (the wrapper's backward) and the plain backward
    args32, gy32 = _attn_args(dev, 16, 16384, 128)
    args = [a.to(torch.bfloat16).requires_grad_() for a in args32]
    gy = gy32.to(torch.bfloat16)
    scale = 128 ** -0.5
    got = torch.autograd.grad(xattn.cross_attn_head1(*args, scale=scale), args, gy)
    ref = [a.detach().float().requires_grad_() for a in args]
    want = torch.autograd.grad(xattn.cross_attn_head1_plain(*ref, scale=scale), ref, gy.float())
    result = {"max_abs_err": max(check(f"timed (16,16384,128) bf16 d{n}", g, w, 1e-5, BF16_REL)
                                 for n, g, w in zip(names, got, want))}
    call = lambda: xattn._kernel_bwd(args, gy, scale, None, 1e-5)
    first, second = call(), call()
    same = [n for n, a, b in zip(names, first, second) if n in ("k", "v") or torch.equal(a, b)]
    require(len(same) == len(names), f"G-bwd's dx and records bitwise equal in two runs: only "
            f"{same}")
    blocks = xattn.attn_bwd_blocks(16, 16384, 128, torch.bfloat16, dev)
    log(f"  two runs: dx and every gradient but dk, dv bitwise equal; {blocks} blocks, each "
        f"writing a record of {19 * 128 * 4} bytes ({blocks * 19 * 128 * 4} bytes a call)")
    result["ms"] = graph_ms(call)
    out = xattn.cross_attn_head1_plain(*args, scale=scale)
    result["plain_ms"] = cuda_ms(lambda: torch.autograd.grad(out, args, gy, retain_graph=True))
    weights = [a.detach().float() for a in args[1:]]
    result.update(bound(nbytes(args[0], gy, args[0], *weights, *weights),
                        _attn_flops(16, 16384, 128, backward=True)), library_ms=None)
    log(f"  bf16 time: kernel {result['ms']:.4f} ms (CUDA graph of 20 calls), plain backward "
        f"{result['plain_ms']:.4f} ms (CUDA events), bound {result['bound_ms']:.4f} ms "
        f"({result['bound_by']}); kernel alone {kernel_only_ms(call, 'cross_attn_bwd'):.4f} ms "
        f"(profiler); 20 calls between events {cuda_ms(call):.4f} ms")

    # fp32 on the 1e4 key spread against float64: near a tie between two of
    # head 0's tokens the gradient moves with q's absolute error
    before, spread_calls = {n: _kernels.launches[n] for n in G_KERNELS}, 0
    for D, _, _ in xattn._ATTN_SHAPES:
        args32, gy32 = _attn_args(dev, 2, 4096, D, seed=D + 15, spread=True)
        args = [a.requires_grad_() for a in args32]
        out = xattn.cross_attn_head1(*args, scale=D ** -0.5)
        got = (out,) + torch.autograd.grad(out, args, gy32)
        spread_calls += 1
        ref = [a.detach().double().requires_grad_() for a in args32]
        want = attn_f64(*ref, scale=D ** -0.5)
        want = (want,) + torch.autograd.grad(want, ref, gy32.double())
        for n, g, w in zip(("y",) + names, got, want):
            check(f"spread (2,4096,{D}) fp32 vs float64 {n if n == 'y' else 'd' + n}", g,
                  w.float(), 0.0, 1e-4)
    torch.cuda.synchronize()
    runs = {n: _kernels.launches[n] - before[n] for n in G_KERNELS}
    require(runs == dict.fromkeys(G_KERNELS, spread_calls),
            f"the spread checks launched G and G-bwd once each: {runs} for {spread_calls}")
    log(f"  phase 4d took {time.perf_counter() - t0:.1f} s")
    calls += spread_calls
    for n in G_KERNELS:
        _kernels.launches[n] = 0
    return result, calls


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


def _scan_args(dev, shape, seed, dtype=torch.float32, on_device=False):
    """Kernel I's inputs at `shape` = (B, K, L, Dk), numpy-seeded (with
    `on_device`, drawn on the card from the seed: seconds less per call at
    these sizes) in SS2D's ranges: dt = softplus(dts + bias) mostly in
    [1e-3, 0.1] with a tail above, A = -exp(log(1..16) + noise)."""
    B, K, L, Dk = shape
    rng = np.random.default_rng(seed)
    gen = torch.Generator(dev).manual_seed(seed) if on_device else None

    def f(*s, scale=1.0, off=0.0):
        if on_device:
            return torch.randn(s, generator=gen, device=dev) * scale + off
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    A = -torch.exp(torch.log(torch.arange(1, 17, device=dev, dtype=torch.float32))
                   + f(K * Dk, 16, scale=0.1))
    bias = torch.from_numpy(rng.uniform(np.log(1e-3), np.log(0.1), K * Dk).astype(np.float32))
    return [f(B, K, L, Dk).to(dtype), f(B, K, L, Dk).to(dtype), A, f(B, K, L, 16).to(dtype),
            f(B, K, L, 16).to(dtype), f(K * Dk, scale=0.1, off=1.0), bias.to(dev)]


def log_fwd_build(flat: bool) -> None:
    """The forward sweep's (`scan_fwd_kernel`: I-fwd, I-ckpt, the carry and
    the adjcarry) build and residency in one layout: the ptxas lines
    (registers, spills) of its instantiations in both dtypes and four
    modes, and its resident warps per SM and shared memory per block (the
    CUDA occupancy calculator)."""
    from smow_net_tpu_torch.ops import scan

    for line in ptxas_lines("scan_fwd_kernel"):
        m = re.search(r"scan_fwd_kernelI\w+?Li\dELb([01])E", line)
        if m and m.group(1) == str(int(flat)):
            log("  ptxas " + line)
    for mode in scan.FWD_MODES:
        for bf16 in (False, True):
            warps, smem = scan.fwd_occupancy(mode, flat, bf16)
            log(f"  forward sweep occupancy, {mode} {'flat' if flat else 'grouped'} "
                f"{'bf16' if bf16 else 'fp32'}: {warps} resident warps per SM, {smem} bytes of "
                "shared memory a block")


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
    log_fwd_build(flat=False)
    result.update(fwd_call_times(dev, SCAN_CALLS, rate))
    return result


def fwd_call_times(dev, calls, rate: float) -> dict:
    """I-fwd's bf16 time summed over `calls` ((B, K, L, Dk), count), one
    eval forward's scan calls, beside the plain scan's (one call each, no
    warm-up) and the bound of the same work; inputs as `_scan_args` draws
    them on the card."""
    from smow_net_tpu_torch.ops import scan

    ms = plain_ms = n_bytes = flops = exps = 0.0
    for shape, count in calls:
        args = _scan_args(dev, shape, 41, torch.bfloat16, on_device=True)
        with torch.no_grad():
            t = cuda_ms(lambda: scan.cross_selective_scan(*args), iters=5, warmup=1)
            tp = cuda_ms(lambda: scan.cross_selective_scan_plain(*args), iters=1, warmup=0)
        B, K, L, Dk = shape
        elems = B * K * L * Dk
        log(f"  {shape} x{count}: kernel {t:.4f} ms, plain {tp:.4f} ms")
        ms, plain_ms = ms + count * t, plain_ms + count * tp
        n_bytes += count * (nbytes(*args) + 2 * elems)          # + y in bf16
        flops += count * 5 * 16 * elems
        exps += count * 18 * elems                              # 16 states + softplus
    result = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                  **scan_bound(n_bytes, flops, exps, rate))
    n = sum(count for _, count in calls)
    log(f"  one forward's {n} calls, bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{result['bound_ms']:.4f} ms ({result['bound_by']}; {exps:.3e} exps, "
        f"{n_bytes:.3e} bytes)")
    return result


def phase_scan_bwd(dev, rate: float) -> dict:
    from smow_net_tpu_torch.ops import scan

    log("phase 14: kernels I-ckpt selective_scan_ckpt and I-bwd selective_scan_bwd vs the "
        "plain version (fp32: states 1e-5 of the largest, gradients 1e-4 of each largest)")
    names = ("xs", "dts", "A", "Bs", "Cs", "Ds", "dt_bias")
    results = {"selective_scan_ckpt": {}, "selective_scan_bwd": {}}
    args = _scan_args(dev, (32, 4, 1024, 384), 42)
    a = scan._Args(*args)
    err_ck = check("I-ckpt (32, 4, 1024, 384) chunk-start states", scan._scan_ckpt(a),
                   scan.scan_ckpt_plain(a), 0.0, 1e-5)
    del a
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
    # I-bwd's build and residency: registers and spills (ptxas), resident
    # warps per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
    for line in ptxas_lines("scan_bwd_kernel"):
        log("  ptxas " + line)
    for flat in (False, True):
        for bf16 in (False, True):
            warps, smem = scan.bwd_occupancy(flat, bf16)
            log(f"  I-bwd occupancy, {'flat' if flat else 'grouped'} "
                f"{'bf16' if bf16 else 'fp32'}: {warps} resident warps per SM, {smem} bytes of "
                f"shared memory a block, {scan.bwd_partials(384)} dB/dC partials at Dk = 384")
    # determinism: no float atomics, so two runs give the same bits
    a = scan._Args(*_scan_args(dev, (16, 4, 1000, 200), 46))
    gy = torch.randn(a.u.shape, device=dev, generator=torch.Generator(dev).manual_seed(47))
    hck = scan._scan_ckpt(a)
    first, second = scan._scan_bwd(a, gy, hck), scan._scan_bwd(a, gy, hck)
    require(all(torch.equal(x, y) for x, y in zip(first, second)),
            "I-bwd gives the same bits on two runs")
    log("  I-bwd at (16, 4, 1000, 200), fp32, twice: dus, ddt, dB, dC and dA bitwise equal")
    del a, gy, hck, first, second
    ck, bw = bwd_call_times(dev, SCAN_CALLS, rate)
    results["selective_scan_ckpt"].update(ck)
    results["selective_scan_bwd"].update(bw)
    return results


def bwd_call_times(dev, calls, rate: float) -> tuple:
    """I-ckpt's and I-bwd's bf16 times summed over `calls` ((B, K, L, Dk),
    count), one train step's scan calls (I-bwd also alone: its launches
    between CUDA events), beside the plain versions' (one call each, no
    warm-up) and the bounds of the same work; inputs as `_scan_args` draws
    them on the card."""
    from smow_net_tpu_torch.ops import scan

    ck, bw = {}, {}
    tot = dict(ck=0.0, bw=0.0, bw_kernel=0.0, ck_plain=0.0, bw_plain=0.0, ck_bytes=0.0,
               bw_bytes=0.0, elems=0.0)
    for shape, count in calls:
        args = _scan_args(dev, shape, 45, torch.bfloat16, on_device=True)
        gy = torch.randn(shape, device=dev, dtype=torch.bfloat16)
        a = scan._Args(*args)
        hck = scan._scan_ckpt(a)
        t_ck = cuda_ms(lambda: scan._scan_ckpt(a), iters=5, warmup=1)
        t_bw = cuda_ms(lambda: scan._scan_bwd(a, gy, hck), iters=5, warmup=1)
        t_bk = launch_ms(lambda: scan._scan_bwd(a, gy, hck), "selective_scan_bwd")
        with torch.no_grad():
            t_fwd = cuda_ms(lambda: scan.cross_selective_scan_plain(*args), iters=1, warmup=0)
        ref = [x.detach().requires_grad_() for x in args]
        t_graph = cuda_ms(lambda: scan.cross_selective_scan_plain(*ref), iters=1, warmup=0)
        t_both = cuda_ms(lambda: torch.autograd.grad(scan.cross_selective_scan_plain(*ref), ref,
                                                     gy), iters=1, warmup=0)
        grads = scan._scan_bwd(a, gy, hck)
        B, K, L, Dk = shape
        log(f"  {shape} x{count}: I-ckpt {t_ck:.4f} ms, I-bwd {t_bw:.4f} ms (kernel alone "
            f"{t_bk:.4f}); plain forward {t_fwd:.4f}, plain backward {t_both - t_graph:.4f} ms")
        tot["ck"] += count * t_ck
        tot["bw"] += count * t_bw
        tot["bw_kernel"] += count * t_bk
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
    n = sum(count for _, count in calls)
    for label, r in (("I-ckpt", ck), ("I-bwd", bw)):
        log(f"  one train step's {n} calls, bf16: {label} {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    log(f"  one train step's {n} calls, bf16: I-bwd's kernel alone {tot['bw_kernel']:.4f} ms "
        "(CUDA events; the wrapper adds the dy cast and the sum of the dB and dC partials)")
    return ck, bw


# (B, K, L, Dk) of every selective-scan call in one RS-Mamba forward at 16 x
# 256^2 (the 2B-batched encoder's four stages, K = 8), with its number of calls
RS_SCAN_CALLS = (((32, 8, 4096, 192), 2), ((32, 8, 1024, 384), 2), ((32, 8, 256, 768), 9),
                 ((32, 8, 64, 1536), 2))


def phase_scan_k8(dev, rate: float) -> dict:
    """Kernel I at K = 8, RS-Mamba's eight directions: 256 rows a call."""
    from smow_net_tpu_torch.ops import _kernels, scan

    log("phase 27: kernel I at K = 8 (RS-Mamba): I-fwd vs cross_selective_scan_plain at "
        "RS-Mamba's four stage shapes (fp32: 1e-5 of the largest output; bf16: one bf16 "
        "rounding of the plain version in fp32), I-ckpt's states and I-ckpt + I-bwd's seven "
        "gradients vs the plain version at (32, 8, 1024, 384) and (32, 8, 64, 1536) (fp32: "
        "1e-5; 1e-4 of each largest), then the times over one RS-Mamba forward's and train step's 15 calls, bf16")
    names = ("xs", "dts", "A", "Bs", "Cs", "Ds", "dt_bias")
    results = {"selective_scan_fwd": {}, "selective_scan_ckpt": {}, "selective_scan_bwd": {}}
    for shape, count in RS_SCAN_CALLS:
        B, K, L, Dk = shape
        log(f"  {shape} x{count}: {B * K} rows; scan.seg_count(rows, L, Dk) = "
            f"{scan.seg_count(B * K, L, Dk)} (the grouped contract runs every row whole)")
    for shape, _ in RS_SCAN_CALLS:
        args32 = _scan_args(dev, shape, 50, on_device=True)
        for dt in (torch.float32, torch.bfloat16):
            args = [a.to(dt) if i in (0, 1, 3, 4) else a for i, a in enumerate(args32)]
            before = _kernels.launches["selective_scan_fwd"]
            with torch.no_grad():
                y = scan.cross_selective_scan(*args)
                want = scan.cross_selective_scan_plain(*[a.float() for a in args])
            require(_kernels.launches["selective_scan_fwd"] == before + 1 and y.dtype == dt,
                    "I-fwd launched once and returns the input dtype")
            err = check(f"I-fwd {shape} {str(dt)[6:]}", y, want, 0.0,
                        1e-5 if dt == torch.float32 else BF16_REL)
            if shape == (32, 8, 4096, 192) and dt == torch.bfloat16:
                results["selective_scan_fwd"]["max_abs_err"] = err
            del y, want, args
        del args32
    # the train step's second and last stages: 256 rows a call, as phase 14
    # holds K = 4 at ChangeMamba's (32, 4, 1024, 384)
    err_ck = err_bw = 0.0
    for shape in ((32, 8, 1024, 384), (32, 8, 64, 1536)):
        a = scan._Args(*_scan_args(dev, shape, 51, on_device=True))
        err_ck = max(err_ck, check(f"I-ckpt {shape} chunk-start states", scan._scan_ckpt(a),
                                   scan.scan_ckpt_plain(a), 0.0, 1e-5))
        del a
        args = [t.requires_grad_() for t in _scan_args(dev, shape, 52, on_device=True)]
        gy = torch.randn(shape, device=dev, generator=torch.Generator(dev).manual_seed(53))
        got = torch.autograd.grad(scan.cross_selective_scan(*args), args, gy)
        want = torch.autograd.grad(scan.cross_selective_scan_plain(*args), args, gy)
        err_bw = max(err_bw, *(check(f"I-bwd {shape} d{n}", g, w, 0.0, 1e-4)
                               for n, g, w in zip(names, got, want)))
        del got, want, args, gy
    results["selective_scan_ckpt"]["max_abs_err"] = err_ck
    results["selective_scan_bwd"]["max_abs_err"] = err_bw
    results["selective_scan_fwd"].update(fwd_call_times(dev, RS_SCAN_CALLS, rate))
    ck, bw = bwd_call_times(dev, RS_SCAN_CALLS, rate)
    results["selective_scan_ckpt"].update(ck)
    results["selective_scan_bwd"].update(bw)
    return results


# (B, L, G, Cg) of every selective-scan call in one CD-Mamba forward at
# 16 x 256^2, with its number of calls: the 2B-batched encoder's
# bidirectional scans and the GF stages' (G = 2, 64 rows), the GF global
# query's single-direction core (G = 1, 32 rows) and the decoder's (B = 16,
# G = 2, 32 rows)
CDM_CALLS = (((32, 65536, 2, 32), 5), ((32, 65536, 1, 32), 1), ((16, 65536, 2, 32), 2),
             ((32, 16384, 2, 64), 7), ((32, 16384, 1, 64), 1), ((16, 16384, 2, 64), 2),
             ((32, 4096, 2, 128), 5), ((16, 4096, 2, 128), 2), ((32, 1024, 2, 256), 8))
FLAT_KERNELS = ("selective_scan_fwd_flat", "selective_scan_ckpt_flat", "selective_scan_bwd_flat")
SEG_KERNELS = ("selective_scan_carry", "selective_scan_adjcarry")


def cdm_launches(train: bool, calls=CDM_CALLS) -> dict:
    """Each kernel's launches per CD-Mamba eval batch (or train step) on
    the flat scan's current route: H-fwd once per call; a segmented call's
    forward runs the carry first, its backward the carry again and the
    adjoint carry."""
    from smow_net_tpu_torch.ops import scan

    counts = collections.Counter()
    for (B, L, G, Cg), n in calls:
        segmented = scan.seg_count(B * G, L, Cg) > 1
        counts["selective_scan_fwd_flat"] += n
        counts["selective_scan_carry"] += n * segmented * (2 if train else 1)
        if train:
            counts["selective_scan_ckpt_flat"] += n
            counts["selective_scan_bwd_flat"] += n
            counts["selective_scan_adjcarry"] += n * segmented
    return {k: v for k, v in counts.items() if v}


def _flat_args(dev, B, L, G, Cg, seed, dtype=torch.float32, on_device=False):
    """Kernel H's inputs at (B, L, G, Cg), numpy-seeded (or, with
    `on_device`, drawn on the card) in CD-Mamba's ranges (as `_scan_args`):
    u, delta (B, L, G*Cg), A (G*Cg, 16), Bmat, Cmat (B, L, G, 16), D,
    delta_bias (G*Cg)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(dev).manual_seed(seed) if on_device else None

    def f(*s, scale=1.0, off=0.0):
        if on_device:
            return torch.randn(s, generator=gen, device=dev) * scale + off
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    Dch = G * Cg
    A = -torch.exp(torch.log(torch.arange(1, 17, device=dev, dtype=torch.float32))
                   + f(Dch, 16, scale=0.1))
    bias = torch.from_numpy(rng.uniform(np.log(1e-3), np.log(0.1), Dch).astype(np.float32))
    return [f(B, L, Dch).to(dtype), f(B, L, Dch).to(dtype), A, f(B, L, G, 16).to(dtype),
            f(B, L, G, 16).to(dtype), f(Dch, scale=0.1, off=1.0), bias.to(dev)]


FLAT_NAMES = ("u", "delta", "A", "B", "C", "D", "bias")


def phase_flat_scan(dev, rate: float) -> dict:
    from smow_net_tpu_torch.ops import _kernels, scan

    log("phase 19: kernel H (the flat contract through I-fwd, I-ckpt and I-bwd, sequential) vs "
        "selective_scan_plain at CD-Mamba's shapes (fp32: y, du, ddelta, dB, dC to 1e-5 of each "
        "largest element, dA, dD, dbias, summed over the batch and L, to 1e-4; bf16: one bf16 "
        "rounding of the plain version in fp32 on the same inputs)")
    log_fwd_build(flat=True)
    results = {n: {} for n in FLAT_KERNELS}
    cases = (((32, 65536, 2, 32), (torch.float32, torch.bfloat16)),
             ((32, 65536, 1, 32), (torch.float32,)), ((32, 16384, 2, 64), (torch.float32,)),
             ((32, 4096, 2, 128), (torch.float32, torch.bfloat16)),
             ((32, 1024, 2, 256), (torch.float32,)))
    with seg_route(1 << 30):
        for (B, L, G, Cg), dtypes in cases:
            for dt in dtypes:
                args = [a.requires_grad_() for a in _flat_args(dev, B, L, G, Cg, 50, dt)]
                gy = torch.randn(args[0].shape, device=dev,
                                 generator=torch.Generator(dev).manual_seed(51)).to(dt)
                before = dict(_kernels.launches)
                y = scan.selective_scan(*args, delta_softplus=True)
                got = torch.autograd.grad(y, args, gy)
                require(all(_kernels.launches[n] == before.get(n, 0) + 1 for n in FLAT_KERNELS),
                        "kernel H's three sweeps each launched once")
                ref = [a.detach().float().requires_grad_() for a in args]
                want_y = scan.selective_scan_plain(*ref, delta_softplus=True)
                want = torch.autograd.grad(want_y, ref, gy.float())
                label = f"H ({B * G} rows, {L}, {Cg}) G={G} {str(dt)[6:]}"
                fp32 = dt == torch.float32
                check(f"{label} y", y, want_y, 0.0, 1e-5 if fp32 else BF16_REL)
                for n, g, w in zip(FLAT_NAMES, got, want):
                    check(f"{label} d{n}", g, w, 0.0,
                          (1e-5 if n in ("u", "delta", "B", "C") else 1e-4) if fp32 else BF16_REL)
                del args, got, want, y, want_y, ref
        # H-ckpt's chunk-start states on the flat layout against the plain
        # I-ckpt, fp32
        B, L, G, Cg = 32, 1024, 2, 256
        a = scan._Args(*_flat_args(dev, B, L, G, Cg, 53), flat=True)
        check(f"H-ckpt ({B * G} rows, {L}, {Cg}) chunk-start states", scan._scan_ckpt(a),
              scan.scan_ckpt_plain(a), 0.0, 1e-5)
        del a
    # the 33 calls of one bf16 forward, and of one train step's backward, on
    # the shipped route (the main path's: each call's seg_count segments,
    # seeded) and sequential
    tot = collections.defaultdict(float)
    for (B, L, G, Cg), n in CDM_CALLS:
        args = _flat_args(dev, B, L, G, Cg, 52, torch.bfloat16, on_device=True)
        gy = torch.randn(args[0].shape, device=dev, dtype=torch.bfloat16)
        a = scan._Args(*args, flat=True)
        S = scan.seg_count(a.rows, L, Cg)
        seeds = [torch.rand(a.rows * S, 16, Cg, device=dev) for _ in range(3)] if S > 1 else [
            None] * 3
        hck = scan._scan_ckpt(a, S, seeds[0])
        t_fwd = cuda_ms(lambda: scan._scan_fwd(a, S, seeds[0]), iters=3, warmup=1)
        t_ck = cuda_ms(lambda: scan._scan_ckpt(a, S, seeds[0]), iters=3, warmup=1)
        t_bw = cuda_ms(lambda: scan._scan_bwd(a, gy, hck, S, *seeds[1:]), iters=3, warmup=1)
        t_bk = launch_ms(lambda: scan._scan_bwd(a, gy, hck, S, *seeds[1:]),
                         "selective_scan_bwd", iters=3)
        hck_seq = scan._scan_ckpt(a)
        seq = (cuda_ms(lambda: scan._scan_fwd(a), iters=3, warmup=1),
               cuda_ms(lambda: scan._scan_ckpt(a), iters=3, warmup=1),
               cuda_ms(lambda: scan._scan_bwd(a, gy, hck_seq), iters=3, warmup=1))
        del hck_seq
        with torch.no_grad():
            p_fwd = cuda_ms(lambda: scan.selective_scan_plain(*args, delta_softplus=True),
                            iters=1, warmup=0)
        ref = [x.detach().requires_grad_() for x in args]
        p_graph = cuda_ms(lambda: scan.selective_scan_plain(*ref, delta_softplus=True), iters=1,
                          warmup=0)
        p_both = cuda_ms(lambda: torch.autograd.grad(
            scan.selective_scan_plain(*ref, delta_softplus=True), ref, gy), iters=1, warmup=0)
        grads = scan._scan_bwd(a, gy, hck, S, *seeds[1:])
        elems = B * G * L * Cg
        log(f"  ({B * G} rows, {L}, {Cg}) G={G} x{n}, S={S}: H-fwd {t_fwd:.4f} ms, H-ckpt "
            f"{t_ck:.4f}, H-bwd {t_bw:.4f} (kernel alone {t_bk:.4f}; sequential {seq[0]:.4f}, "
            f"{seq[1]:.4f}, {seq[2]:.4f}); plain forward {p_fwd:.4f}, plain backward "
            f"{p_both - p_graph:.4f}")
        tot["fwd"] += n * t_fwd
        tot["ck"] += n * t_ck
        tot["bw"] += n * t_bw
        tot["bw_kernel"] += n * t_bk
        for k, t in zip(("fwd_seq", "ck_seq", "bw_seq"), seq):
            tot[k] += n * t
        tot["fwd_plain"] += n * p_fwd
        tot["bw_plain"] += n * (p_both - p_graph)
        tot["fwd_bytes"] += n * (nbytes(*args) + 2 * elems)
        tot["ck_bytes"] += n * nbytes(a.u, a.dt, a.Bm, hck)
        tot["bw_bytes"] += n * nbytes(a.u, a.dt, a.Bm, a.Cm, gy, hck, *grads)
        tot["elems"] += n * elems
        del hck, grads, args, ref, a, seeds
    e = tot["elems"]
    results["selective_scan_fwd_flat"].update(
        ms=tot["fwd"], plain_ms=tot["fwd_plain"], library_ms=None,
        **scan_bound(tot["fwd_bytes"], 5 * 16 * e, 18 * e, rate))
    results["selective_scan_ckpt_flat"].update(
        ms=tot["ck"], plain_ms=tot["fwd_plain"], library_ms=None,
        **scan_bound(tot["ck_bytes"], 3 * 16 * e, 18 * e, rate))
    results["selective_scan_bwd_flat"].update(
        ms=tot["bw"], plain_ms=tot["bw_plain"], library_ms=None,
        **scan_bound(tot["bw_bytes"], 20 * 16 * e, 18 * e, rate))
    log(f"  one forward's 33 calls: {e:.4e} (row, step, channel) elements, {18 * e:.4e} exps; "
        f"on the sequential route H-fwd {tot['fwd_seq']:.4f} ms, H-ckpt {tot['ck_seq']:.4f} ms, "
        f"H-bwd {tot['bw_seq']:.4f} ms; H-bwd's kernel alone on the shipped route "
        f"{tot['bw_kernel']:.4f} ms (CUDA events)")
    for label, r in zip(("H-fwd (one forward, shipped route)",
                         "H-ckpt (one train step, shipped route)",
                         "H-bwd (one train step, shipped route)"), results.values()):
        log(f"  {label}, bf16: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return results


def _shipped_route_errors(dev, B, L, G, Cg, dtype) -> dict:
    """One CD-Mamba scan shape on the shipped route (S = seg_count): the
    carry and adjcarry (where S > 1), then I-fwd, I-ckpt and I-bwd seeded as
    the segmented orchestration seeds them, each against its plain version on
    the same inputs and seeds. y is held to 1e-5 of its largest element in
    fp32 and to one rounding in bf16; the fp32 outputs (states, dt sums,
    adjoints, the sweeps' gradients) to 1e-5, dA (a sum over each segment's
    steps) to 1e-4. Returns each kernel's max_abs_err."""
    from smow_net_tpu_torch.ops import _kernels, scan

    a = scan._Args(*_flat_args(dev, B, L, G, Cg, 60, dtype), flat=True)
    gy = torch.randn(a.u.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(61)).to(dtype)
    S = scan.seg_count(a.rows, L, Cg)
    label = f"({a.rows} rows, {L}, {Cg}) G={G} S={S} {str(dtype)[6:]}"
    errs = {}
    h0 = g0 = a0 = None
    if S > 1:
        before = dict(_kernels.launches)
        hend, csum = scan.scan_carry(a, S)
        gloc = scan.scan_adjcarry(a, gy, S)
        require(all(_kernels.launches[n] == before.get(n, 0) + 1 for n in SEG_KERNELS),
                "the carry and adjcarry kernels each launched once")
        hend_p, csum_p = scan.scan_carry_plain(a, S)
        errs["selective_scan_carry"] = max(check(f"carry {label} hend", hend, hend_p, 0.0, 1e-5),
                                           check(f"carry {label} csum", csum, csum_p, 0.0, 1e-5))
        errs["selective_scan_adjcarry"] = check(f"adjcarry {label} g", gloc,
                                                scan.scan_adjcarry_plain(a, gy, S), 0.0, 1e-5)
        h0, g0, a0 = scan._segment_seeds(a, gy, S)
        del hend, csum, gloc, hend_p, csum_p
    before = dict(_kernels.launches)
    y = scan._scan_fwd(a, S, h0)
    hck = scan._scan_ckpt(a, S, h0)
    sweeps = scan._scan_bwd(a, gy, hck, S, g0, a0)
    require(all(_kernels.launches[n] == before.get(n, 0) + 1 for n in FLAT_KERNELS),
            "H-fwd, H-ckpt and H-bwd each launched once")
    errs["selective_scan_fwd_flat"] = check(
        f"H-fwd {label} y (seeded)", y, scan.scan_fwd_plain(a, S, h0), 0.0,
        1e-5 if dtype == torch.float32 else BF16_REL)
    errs["selective_scan_ckpt_flat"] = check(f"H-ckpt {label} states (seeded)", hck,
                                             scan.scan_ckpt_plain(a, S, h0), 0.0, 1e-5)
    del y, hck
    want = scan.scan_bwd_plain(a, gy, S, h0, g0, a0)
    errs["selective_scan_bwd_flat"] = max(
        check(f"H-bwd {label} {n} (seeded)", g, w, 0.0, 1e-4 if n == "dA" else 1e-5)
        for n, g, w in zip(("dus", "ddt", "dB", "dC", "dA"), sweeps, want))
    return errs


def _ragged_seg_errors(dev, flat: bool) -> None:
    """The carry and adjcarry on 4 segments of 1000 steps (an 8-step last
    chunk, the adjcarry's first) of 8 rows at Cg = 40 (an idle tail of a
    32-channel block), in the flat or the grouped layout, fp32 and bf16,
    against their plain versions on the same values in fp32 (1e-5 of the
    largest element, as phase 20's)."""
    from smow_net_tpu_torch.ops import scan

    B, L, G, Cg, S = 4, 4000, 2, 40, 4
    for dtype in (torch.float32, torch.bfloat16):
        args = _flat_args(dev, B, L, G, Cg, 64, dtype)
        gy = torch.randn(args[0].shape, device=dev,
                         generator=torch.Generator(dev).manual_seed(65)).to(dtype)
        if not flat:              # the same values in the grouped layout
            grouped = lambda t, w: t.reshape(B, L, G, w).transpose(1, 2).contiguous()
            args = [grouped(args[0], Cg), grouped(args[1], Cg), args[2], grouped(args[3], 16),
                    grouped(args[4], 16), args[5], args[6]]
            gy = grouped(gy, Cg)
        a = scan._Args(*args, flat=flat)
        ref = scan._Args(*[t.float() for t in args], flat=flat)
        label = f"ragged ({a.rows} rows, {L}, {Cg}) S={S} {'flat' if flat else 'grouped'} " \
                f"{str(dtype)[6:]}"
        hend, csum = scan.scan_carry(a, S)
        hend_p, csum_p = scan.scan_carry_plain(ref, S)
        check(f"carry {label} hend", hend, hend_p, 0.0, 1e-5)
        check(f"carry {label} csum", csum, csum_p, 0.0, 1e-5)
        check(f"adjcarry {label} g", scan.scan_adjcarry(a, gy, S),
              scan.scan_adjcarry_plain(ref, gy.float(), S), 0.0, 1e-5)


def check_adjcarry_build() -> None:
    """The adjcarry (`scan_fwd_kernel` in mode 3, kModeAdj): the ptxas lines
    of its four instantiations (2 dtypes x 2 layouts), each at most 64
    registers and 0 spill bytes, and 32 resident warps per SM in each."""
    from smow_net_tpu_torch.ops import _kernels, scan

    require(_kernels.build_report, "this process built the kernels (ptxas lines to read)")
    lines = [line for line in ptxas_lines("scan_fwd_kernel")
             if re.search(r"scan_fwd_kernelI\w+?Li3ELb[01]E", line)]
    regs = [int(m.group(1)) for m in (re.search(r"Used (\d+) registers", x) for x in lines) if m]
    spills = [int(a) + int(b) for a, b in
              (re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", x).groups()
               for x in lines if "spill stores" in x)]
    for line in lines:
        log("  ptxas " + line)
    require(len(regs) == len(spills) == 4 and max(regs) <= 64 and not any(spills),
            f"the adjcarry builds at most 64 registers, no spills, in 4 instantiations: "
            f"registers {regs}, spill bytes {spills}")
    for flat in (False, True):
        for bf16 in (False, True):
            warps, smem = scan.fwd_occupancy("adjcarry", flat, bf16)
            log(f"  adjcarry occupancy, {'flat' if flat else 'grouped'} "
                f"{'bf16' if bf16 else 'fp32'}: {warps} resident warps per SM, {smem} bytes of "
                "shared memory a block")
            require(warps >= 32, "the adjcarry holds 32 warps per SM")


def phase_seg_scan(dev, rate: float) -> dict:
    from smow_net_tpu_torch.ops import scan

    log("phase 20: the shipped route (S = seg_count) at every CD-Mamba scan shape, fp32 and "
        "bf16: kernels H-seg carry (selective_scan_carry) and adjcarry "
        "(selective_scan_adjcarry), and H-fwd, H-ckpt, H-bwd seeded as the segmented route "
        "seeds them, vs their plain versions (y 1e-5 fp32, one rounding bf16; fp32 outputs "
        "1e-5, dA 1e-4); the segmented forward and backward vs the sequential kernels and the "
        "plain scan at two S (y 1e-5, the sweeps' gradients 1e-4: other sums, products of "
        "decays over segments); the carry's and adjcarry's times; the A/B")
    # every kernel's max_abs_err on the route and S that its time is taken on:
    # bf16, the shipped route, the worst over CD-Mamba's shapes (the carry and
    # adjcarry: at the L = 65536 shape their row is timed at)
    errors = collections.defaultdict(float)
    for (B, L, G, Cg), _ in CDM_CALLS:
        for dtype in (torch.float32, torch.bfloat16):
            errs = _shipped_route_errors(dev, B, L, G, Cg, dtype)
            if dtype == torch.bfloat16:
                for n, e in errs.items():
                    if n in FLAT_KERNELS or (B, L, G, Cg) == (32, 65536, 2, 32):
                        errors[n] = max(errors[n], e)
    results = {n: {"max_abs_err": errors[n]} for n in FLAT_KERNELS + SEG_KERNELS}
    for flat in (True, False):
        _ragged_seg_errors(dev, flat)
    check_adjcarry_build()
    for (B, L, G, Cg) in ((32, 65536, 2, 32), (32, 16384, 2, 64)):
        args = _flat_args(dev, B, L, G, Cg, 62)
        a = scan._Args(*args, flat=True)
        gy = torch.randn(a.u.shape, device=dev, generator=torch.Generator(dev).manual_seed(63))
        label = f"({B * G} rows, {L}, {Cg})"
        y_seq = scan._scan_fwd(a)
        seq = scan._scan_bwd(a, gy, scan._scan_ckpt(a))
        seq = seq[:4] + (seq[4].reshape(a.rows, 1, 16, Cg).sum(1),)
        y_plain = scan.selective_scan_plain(*args, delta_softplus=True)
        for S in (4, scan.seg_count(a.rows, L, Cg)):
            y = scan._fwd_segmented(a, S)
            check(f"segmented {label} S={S} y vs sequential", y, y_seq, 0.0, 1e-5)
            check(f"segmented {label} S={S} y vs plain", y, y_plain, 0.0, 1e-5)
            for n, g, w in zip(("dus", "ddt", "dB", "dC", "dA"), scan._bwd_segmented(a, gy, S),
                               seq):
                check(f"segmented {label} S={S} {n} vs sequential", g, w, 0.0, 1e-4)
        del args, a, gy, seq, y_seq, y_plain
    # times at the L = 65536 shape (64 rows, Cg 32), bf16, on the shipped S
    B, L, G, Cg = 32, 65536, 2, 32
    S = scan.seg_count(B * G, L, Cg)
    require(S > 1, "the shipped route segments the L = 65536 shape")
    args = _flat_args(dev, B, L, G, Cg, 62, torch.bfloat16)
    a = scan._Args(*args, flat=True)
    gy = torch.randn(a.u.shape, device=dev, dtype=torch.bfloat16)
    elems = B * G * L * Cg
    c, ad = results["selective_scan_carry"], results["selective_scan_adjcarry"]
    hend, csum = scan.scan_carry(a, S)
    c.update(ms=cuda_ms(lambda: scan.scan_carry(a, S), iters=5, warmup=1),
             plain_ms=cuda_ms(lambda: scan.scan_carry_plain(a, S), iters=1, warmup=0),
             library_ms=None,
             **scan_bound(nbytes(a.u, a.dt, a.Bm, hend, csum), 3 * 16 * elems, 18 * elems, rate))
    ad.update(ms=cuda_ms(lambda: scan.scan_adjcarry(a, gy, S), iters=5, warmup=1),
              plain_ms=cuda_ms(lambda: scan.scan_adjcarry_plain(a, gy, S), iters=1, warmup=0),
              library_ms=None,
              **scan_bound(nbytes(a.dt, a.Cm, gy, hend), 2 * 16 * elems, 18 * elems, rate))
    for label, r in (("carry", c), ("adjcarry", ad)):
        log(f"  {label} at ({B * G} rows, {L}, {Cg}) S={S}, bf16: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    require(torch.equal(scan.scan_adjcarry(a, gy, S), scan.scan_adjcarry(a, gy, S)),
            "the adjcarry gives the same bits on two runs")
    log("  adjcarry at the timed shape, twice: bitwise equal")
    del a, args, gy
    # the A/B: sequential against segmented, bf16, forward and forward + backward
    log("  A/B, bf16, ms per call (CUDA events, 3 calls): sequential (S=1) vs segmented")
    log(f"  {'shape':>28} {'S':>3} {'fwd':>9} {'fwd+bwd':>9}")
    table = []
    for (B, L, G, Cg), n in CDM_CALLS:
        if L < 4096:
            continue
        args = _flat_args(dev, B, L, G, Cg, 63, torch.bfloat16, on_device=True)
        a = scan._Args(*args, flat=True)
        gy = torch.randn(a.u.shape, device=dev, dtype=torch.bfloat16)
        for S in (1, 2, 4, 8, 16, 32, 64):
            if S > 1 and (L // S < 512 or a.rows * S > 65535):
                continue
            if S == 1:
                fwd = lambda: scan._scan_fwd(a)
                both = lambda: scan._scan_bwd(a, gy, scan._scan_ckpt(a))
            else:
                fwd = lambda S=S: scan._fwd_segmented(a, S)
                both = lambda S=S: scan._bwd_segmented(a, gy, S)
            t_f = cuda_ms(fwd, iters=3, warmup=1)
            t_b = cuda_ms(lambda: (fwd(), both()), iters=3, warmup=1)
            table.append(((a.rows, L, Cg, G), n, S, t_f, t_b))
            log(f"  {str((a.rows, L, Cg)) + f' G={G} x{n}':>28} {S:>3} {t_f:9.4f} {t_b:9.4f}")
        del a, args, gy
    # the verdict per shape, and the sum over one forward's and one train
    # step's calls at each shape's best S and on the shipped route
    best, shipped = {}, {"fwd": 0.0, "both": 0.0}
    seq = {"fwd": 0.0, "both": 0.0}
    for shape, n, S, t_f, t_b in table:
        if shape not in best or t_b < best[shape][2]:
            best[shape] = (S, t_f, t_b)
        rows, L, Cg, _ = shape
        if S == 1:
            seq["fwd"] += n * t_f
            seq["both"] += n * t_b
        if S == scan.seg_count(rows, L, Cg):
            shipped["fwd"] += n * t_f
            shipped["both"] += n * t_b
    for shape, (S, t_f, t_b) in best.items():
        log(f"  fastest forward + backward at {shape[:3]} G={shape[3]}: S={S} ({t_b:.4f} ms)")
    log(f"  the L >= 4096 calls of one forward: sequential {seq['fwd']:.4f} ms, shipped route "
        f"(SEG_MIN_L {scan.SEG_MIN_L}, SEG_TARGET_BLOCKS {scan.SEG_TARGET_BLOCKS}, SEG_MIN_K "
        f"{scan.SEG_MIN_K}) {shipped['fwd']:.4f} ms; of one train step (forward + backward): "
        f"sequential {seq['both']:.4f} ms, shipped {shipped['both']:.4f} ms")
    return results


def _states_args(dev, B, L, G, Cg, N, softplus, seed, dtype=torch.float32):
    """The flat contract's inputs at any N, numpy-seeded as `_flat_args`;
    without the softplus dt >= 0 is passed as delta (the softplus taken
    here) with a zero bias, as such a call's caller gives it."""
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    Dch = G * Cg
    A = -torch.exp(torch.log(torch.arange(1, N + 1, device=dev, dtype=torch.float32))
                   + f(Dch, N, scale=0.1))
    bias = torch.from_numpy(rng.uniform(np.log(1e-3), np.log(0.1), Dch).astype(np.float32)).to(dev)
    delta = f(B, L, Dch)
    if not softplus:
        from smow_net_tpu_torch.ops import scan

        delta, bias = scan.softplus(delta + bias), torch.zeros_like(bias)
    return [f(B, L, Dch).to(dtype), delta.to(dtype), A, f(B, L, G, N).to(dtype),
            f(B, L, G, N).to(dtype), f(Dch, scale=0.1, off=1.0), bias]


def phase_scan_states(dev) -> tuple:
    """Kernel J and the general route (`_StatesScan`) against their plain
    versions; the A/B of J against H at the odd-L shape JAX's router sends
    to J; the kernels H and I past 65535 rows."""
    from smow_net_tpu_torch.ops import _kernels, scan

    gc.collect()
    torch.cuda.empty_cache()
    log("phase 24: the general selective-scan route (_StatesScan: kernel J once forward, twice "
        "backward) vs selective_scan_plain, (B, L, G, Cg) = (4, 2048, 2, 32), N in {1, 4, 8, "
        "16, 32}, softplus on and off (fp32: y 1e-5, the seven gradients 1e-4 of each largest "
        "element; bf16, fp16: y to one rounding; float64: y to 1e-5)")
    reset_launches()
    for N in (1, 4, 8, 16, 32):
        for softplus in (True, False):
            args = [a.requires_grad_() for a in _states_args(dev, 4, 2048, 2, 32, N, softplus,
                                                               70 + N)]
            gy = torch.randn(args[0].shape, device=dev,
                             generator=torch.Generator(dev).manual_seed(71))
            before = _kernels.launches["scan_states"]
            y = scan._StatesScan.apply(*args, softplus)
            got = torch.autograd.grad(y, args, gy)
            require(_kernels.launches["scan_states"] == before + 3,
                    "the general route runs J once forward and twice backward")
            want_y = scan.selective_scan_plain(*args, delta_softplus=softplus)
            want = torch.autograd.grad(want_y, args, gy)
            label = f"J route N={N} softplus={softplus}"
            check(f"{label} y", y, want_y, 0.0, 1e-5)
            for n, g, w in zip(FLAT_NAMES, got, want):
                check(f"{label} d{n}", g, w, 0.0, 1e-4)
    # the calls kernels H and I refuse reach J through both contracts
    for N, softplus, dt in ((8, True, torch.float32), (16, False, torch.float32),
                            (16, True, torch.float16), (16, True, torch.float64),
                            (32, True, torch.bfloat16)):
        args = _states_args(dev, 4, 2048, 2, 32, N, softplus, 72, dt)
        before = dict(_kernels.launches)
        with torch.no_grad():
            y = scan.selective_scan(*args, delta_softplus=softplus)
            B, L, Dch = args[0].shape
            grouped = [args[0].reshape(B, L, 2, 32).transpose(1, 2), args[1].reshape(
                B, L, 2, 32).transpose(1, 2), args[2], args[3].transpose(1, 2),
                args[4].transpose(1, 2), args[5], args[6]]
            yg = scan.cross_selective_scan(*grouped, delta_softplus=softplus)
            want = scan.selective_scan_plain(*[a.float() for a in args], delta_softplus=softplus)
        runs = {n: c - before.get(n, 0) for n, c in _kernels.launches.items()
                if c != before.get(n, 0)}
        require(runs == {"scan_states": 2} and y.dtype == dt,
                f"N={N} softplus={softplus} {dt}: both contracts take the general route: {runs}")
        rel = {torch.float32: 1e-5, torch.float64: 1e-5, torch.bfloat16: BF16_REL,
               torch.float16: 2.0 ** -11}[dt]
        label = f"routed N={N} softplus={softplus} {str(dt)[6:]}"
        check(f"{label} y (flat)", y, want, 0.0, rel)
        check(f"{label} y (grouped)", yg.transpose(1, 2).reshape(B, L, Dch), want, 0.0, rel)
    launches = _kernels.launches["scan_states"]
    log(f"  kernel J launched {launches} times in this phase's route checks")

    # kernel J at the shape of the A/B below: its time, bound and error
    L, G, Cg, N = 62500, 2, 32, 16
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    per_row = L * G * Cg * N * 4                # one fp32 (1, L, D, N) tensor
    B = max(1, min(16, int(0.5 * free / (12 * per_row))))
    log(f"  J vs H at L = {L} (= 250^2, the shape JAX's route_scan_impl names), Dch {G * Cg}, G "
        f"{G}, N {N}: batch {B} (half of the {free / 2 ** 30:.1f} GiB free over ~12 fp32 "
        "(B, L, D, N) tensors of the general route's backward)")
    g = torch.Generator(dev).manual_seed(73)
    dA = torch.exp(-torch.rand(B, L, G * Cg * N, device=dev, generator=g) * 0.1)
    dBu = torch.randn(B, L, G * Cg * N, device=dev, generator=g)
    h = scan.scan_states(dA, dBu)
    h_p = scan.scan_states_plain(dA, dBu)
    err = check(f"J ({B}, {L}, {G * Cg * N}) fp32 states", h, h_p, 0.0, 1e-5)
    del h, h_p
    result = dict(max_abs_err=err, library_ms=None,
                  ms=cuda_ms(lambda: scan.scan_states(dA, dBu), iters=5, warmup=1),
                  plain_ms=cuda_ms(lambda: scan.scan_states_plain(dA, dBu), iters=1, warmup=1),
                  **bound(3 * dA.numel() * 4, 2 * dA.numel()))
    rev_ms = cuda_ms(lambda: scan.scan_states(dA, dBu, True), iters=5, warmup=1)
    log(f"  J alone, fp32 ({B}, {L}, {G * Cg * N}), S = {scan.states_seg_count(*dA.shape)}: "
        f"kernel {result['ms']:.4f} ms forward, {rev_ms:.4f} reverse, plain "
        f"{result['plain_ms']:.4f} ms, bound {result['bound_ms']:.4f} ms ({result['bound_by']}: "
        f"12 bytes per element; {result['bound_ms'] / result['ms']:.1%} of it forward)")
    del dA, dBu
    gc.collect()
    torch.cuda.empty_cache()
    # the narrow long-L shape (L = 250^2, N = 4, Dch = 64, batch 2): 16 strips
    # of 32 lanes, cut into chained segments; both directions, bitwise twice
    Bn, Kn = 2, 256
    dA = torch.exp(-torch.rand(Bn, L, Kn, device=dev, generator=g) * 0.1)
    dBu = torch.randn(Bn, L, Kn, device=dev, generator=g)
    Sn, bound_n = scan.states_seg_count(Bn, L, Kn), 12 * dA.numel() / HBM_BYTES_PER_S * 1e3
    for reverse in (False, True):
        h = scan.scan_states(dA, dBu, reverse)
        check(f"J ({Bn}, {L}, {Kn}) fp32 states, S = {Sn}, reverse={reverse}", h,
              scan.scan_states_plain(dA, dBu, reverse), 0.0, 1e-5)
        require(torch.equal(h, scan.scan_states(dA, dBu, reverse)),
                f"J ({Bn}, {L}, {Kn}) reverse={reverse}: two runs differ")
        ms = cuda_ms(lambda: scan.scan_states(dA, dBu, reverse), iters=5, warmup=1)
        log(f"  (finding) J alone, fp32 ({Bn}, {L}, {Kn}), S = {Sn}, "
            f"{'reverse' if reverse else 'forward'}: kernel {ms:.4f} ms, bound {bound_n:.4f} ms "
            f"({bound_n / ms:.1%} of it); bitwise equal twice")
    del dA, dBu, h
    gc.collect()
    torch.cuda.empty_cache()

    # the A/B: H (the shipped route, seg_count's segments) against the
    # general route on the same bf16 inputs, forward and forward + backward
    args = _flat_args(dev, B, L, G, Cg, 74, torch.bfloat16)
    gy = torch.randn(args[0].shape, device=dev, generator=g).to(torch.bfloat16)
    ref = [a.detach().requires_grad_() for a in args]
    routes = {"H": lambda *a: scan._FlatScan.apply(*a),
              "J": lambda *a: scan._StatesScan.apply(*a, True)}
    times = {(k, part): [] for k in routes for part in ("fwd", "fwd+bwd")}
    for k in ("H", "J", "J", "H"):
        fn = routes[k]
        with torch.no_grad():
            times[(k, "fwd")].append(cuda_ms(lambda: fn(*args), iters=3, warmup=1))
        times[(k, "fwd+bwd")].append(cuda_ms(lambda: torch.autograd.grad(fn(*ref), ref, gy),
                                             iters=2, warmup=1))
    S = scan.seg_count(B * G, L, Cg)
    for (k, part), row in times.items():
        log(f"  (finding) {part} {k}{f' (S = {S})' if k == 'H' else ''}: "
            + " / ".join(f"{t:.4f}" for t in row) + " ms")
    del args, ref, gy
    gc.collect()
    torch.cuda.empty_cache()

    log("  H and I past 65535 rows: (B, L, G, Cg) = (35000, 16, 2, 16) flat and (B, K, L, Dk) = "
        "(17500, 4, 16, 16) grouped, 70000 rows of 16 steps, forward and backward vs the plain "
        "version, fp32 (y 1e-5, the gradients 1e-4)")
    for flat in (True, False):
        args = (_flat_args(dev, 35000, 16, 2, 16, 75) if flat
                else _scan_args(dev, (17500, 4, 16, 16), 76))
        fn, plain = ((scan.selective_scan, scan.selective_scan_plain) if flat
                     else (scan.cross_selective_scan, scan.cross_selective_scan_plain))
        args = [a.requires_grad_() for a in args]
        gy = torch.randn(args[0].shape, device=dev, generator=g)
        before = dict(_kernels.launches)
        y = fn(*args, delta_softplus=True)
        got = torch.autograd.grad(y, args, gy)
        names = FLAT_KERNELS if flat else SCAN_KERNELS
        require(all(_kernels.launches[n] == before.get(n, 0) + 1 for n in names),
                f"{names} each launched once at 70000 rows")
        want_y = plain(*args, delta_softplus=True)
        want = torch.autograd.grad(want_y, args, gy)
        label = "H flat" if flat else "I grouped"
        check(f"{label} 70000 rows y", y, want_y, 0.0, 1e-5)
        for n, gr, w in zip(FLAT_NAMES, got, want):
            check(f"{label} 70000 rows d{n}", gr, w, 0.0, 1e-4)
        del args, got, want, y, want_y
    return launches, result


def seeded_state_dict(model: torch.nn.Module, seed: int) -> dict:
    """Numpy-seeded values for every parameter and buffer: fan-in scaled
    weights (the zero/identity-initialised temporal mixers included, so every
    branch carries signal), BN running statistics away from identity, and
    the selective scans' A_logs, Ds and dt_projs_bias (CD-Mamba's A_log, D
    and dt_proj.bias with their _b and _g twins, and skip_scale) perturbed
    around the reference's initialisation (log(1..16), 1, the inverse
    softplus of dt in [1e-3, 0.1], 1)."""
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
        elif leaf in ("A_logs", "A_log", "A_b_log", "A_g_log"):
            val = np.log(np.arange(1, shape[-1] + 1)) + 0.1 * n
        elif leaf in ("Ds", "D", "D_b", "D_g", "skip_scale"):
            val = 1.0 + 0.1 * n
        elif leaf == "dt_projs_bias" or re.search(r"\.dt_proj(_b|_g)?\.bias$", key):
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
    "rs_mamba": {"selective_scan_fwd": 15},
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
    "rs_mamba": dict.fromkeys(SCAN_KERNELS, 15),
}
TRAIN_ABSENT = {
    "smow_net": ("token_scatter_fwd", "grid_sample_fwd", "grid_sample_transpose")
    + SCAN_KERNELS,
    "smow_net_lw": ("token_scatter_fwd", "token_scatter_fwd_eaw") + SCAN_KERNELS,
    "change_mamba": ("token_scatter_fwd", "token_scatter_fwd_eaw", "grid_sample_fwd",
                     "grid_sample_transpose", "grid_sample_t_vjp", "grid_sample_bwd",
                     "xattn_layer_fwd", "xattn_layer_bwd"),
    "rs_mamba": ("token_scatter_fwd", "token_scatter_fwd_eaw", "grid_sample_fwd",
                 "grid_sample_transpose", "grid_sample_t_vjp", "grid_sample_bwd",
                 "xattn_layer_fwd", "xattn_layer_bwd"),
    "cd_mamba": ("token_scatter_fwd", "token_scatter_fwd_eaw", "grid_sample_fwd",
                 "grid_sample_transpose", "grid_sample_t_vjp", "grid_sample_bwd",
                 "xattn_layer_fwd", "xattn_layer_bwd") + SCAN_KERNELS,
}


def phase_main_path(dev, name: str, phase: int, rounds: int, per_round: int = 5) -> dict:
    from smow_net_tpu_torch.models import get_model
    from smow_net_tpu_torch.ops import _kernels
    from smow_net_tpu_torch.train.metrics import cm2score
    from smow_net_tpu_torch.train.trainer import make_eval_step

    log(f"phase {phase}: main path, {name} eval step, bf16, 3 batches of 16 x 256^2")
    gc.collect()
    torch.cuda.empty_cache()
    model = get_model(name)
    model.load_state_dict(seeded_state_dict(model, 0))
    model = model.to(torch.bfloat16)
    step = make_eval_step(model)
    batches = make_batches(dev, 3, 16, 256, seed=7)
    step(batches[0])                                     # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
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
    log(f"  peak device memory, kernel path: {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        "GiB")

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
    log_port_kernels(on_device, len(batches), "batch")
    os.makedirs(PROFILE_DIR, exist_ok=True)
    with open(os.path.join(PROFILE_DIR, f"{name}_eval_bf16_bs16_profile.txt"), "w") as fh:
        fh.write(averages.table(sort_by="cuda_time_total", row_limit=40,
                                max_name_column_width=100))
    log(f"  profile table written to {PROFILE_DIR}")
    return launches


def check_cdm_calls(dev) -> None:
    """The (B, L, G, Cg) of every call that CD-Mamba's bf16 eval step makes to
    `scan.selective_scan` at 16 x 256^2, recorded through the scan swap, must
    be CDM_CALLS: the table that phases 19 and 20 time and hold and
    `cdm_launches` counts from."""
    from smow_net_tpu_torch.models import get_model
    from smow_net_tpu_torch.ops import scan
    from smow_net_tpu_torch.train.trainer import make_eval_step

    model = get_model("cd_mamba")
    model.load_state_dict(seeded_state_dict(model, 0))
    step = make_eval_step(model.to(torch.bfloat16))
    seen, kernel = collections.Counter(), scan.selective_scan

    def record(u, dt, A, Bm, Cm, D, bias):
        seen[(u.shape[0], u.shape[1], Bm.shape[2], u.shape[2] // Bm.shape[2])] += 1
        return kernel(u, dt, A, Bm, Cm, D, bias, delta_softplus=True)

    with swap_scan(record, flat=True):
        step(make_batches(dev, 1, 16, 256, seed=7)[0])
    log(f"  the scan calls of one eval batch, (B, L, G, Cg): count: {dict(seen)}")
    require(seen == collections.Counter(dict(CDM_CALLS)), "CD-Mamba's scan calls are not CDM_CALLS")


def alternate_rounds(round_ms, rounds: int, unit: str, per_round: int,
                     plain: bool = True) -> dict:
    """Rounds of `round_ms()` alternating the kernel path and the plain path
    (their order flipped every round; the plain path must launch no
    kernel); logs and returns each path's median. Without `plain`, the
    kernel path's rounds alone."""
    from smow_net_tpu_torch.ops import _kernels

    if not plain:
        rows = [round_ms() for _ in range(rounds)]
        q1, median, q3 = np.percentile(np.concatenate(rows), [25, 50, 75])
        log(f"  kernel path ms/{unit}: median {median:.3f} (q1 {q1:.3f}, q3 {q3:.3f}, "
            f"{rounds} rounds x {per_round}); the plain path is not timed here")
        return {"kernel": median}
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

    log(f"phase {phase}: whole {name} fp32 (TF32 off, deterministic cuDNN), kernel path vs "
        "plain path, batch 2, 256^2")
    model = get_model(name)
    model.load_state_dict(seeded_state_dict(model, 0))
    model = model.eval()
    rng = np.random.default_rng(11)
    x1, x2 = (torch.from_numpy(rng.normal(size=(2, 3, 256, 256)).astype(np.float32)).to(dev)
              for _ in range(2))
    probs = lambda: select_pred(model(x1, x2))
    torch.backends.cudnn.deterministic = True
    try:
        with torch.inference_mode():
            out = model(x1, x2)
            require(out.shape[0] == 2 and out.shape[2:] == (256, 256), f"output {tuple(out.shape)}")
            got = select_pred(out)
            with plain_ops():
                want, again = probs(), probs()
            if name == "cd_mamba":
                cdm = _cdm_sensitivity(probs, want)
    finally:
        torch.backends.cudnn.deterministic = False
    log(f"  probabilities mean {float(want.mean()):.4f} std {float(want.std()):.4f}; plain vs "
        f"plain rerun {float((again - want).abs().max()):.3e}")
    bound = 1e-4
    if name == "cd_mamba":
        # the model carries the scan's last bits far: the plain path moves by
        # ~1e-3 when its scan's output is nudged by 1e-6 (H100; the plain
        # rerun beside it separates that from run-to-run noise), so no two
        # fp32 scans meet 1e-4. Hold the probabilities to 4x the spread of
        # those nudges, as phase 18 holds ChangeMamba's gradients, and show
        # that the bound catches a segmented scan that drops its seeds
        nudged, seq, dropped, bf16 = cdm
        bound = max(bound, 4 * max(nudged))
        log(f"  plain vs plain with the scan's output x (1 +-1e-6): {nudged[0]:.3e}, "
            f"{nudged[1]:.3e}; kernel path on the sequential route vs plain {seq:.3e}")
        log(f"  controls against the bound {bound:.3e}: the segmented kernels with each segment "
            f"started from zero (no seeds) {dropped:.3e}; the shipped kernels on bf16 inputs "
            f"{bf16:.3e} ({'over' if bf16 > bound else 'within'} the bound)")
        require(dropped > bound, "the probabilities' bound does not catch a segmented scan "
                "without its seeds")
    # fp32 everywhere; the two paths differ only in the kernels' summation order
    check(f"{name} fp32 probabilities", got, want, bound, 0.0)


def _cdm_sensitivity(probs, want) -> tuple:
    """CD-Mamba's probabilities' max |difference| from the plain path's
    `want`: the plain scan's output nudged by x (1 +-1e-6) (two readings),
    the kernel path on the sequential route, and two controls: the shipped
    route's segmented kernels with every segment started from zero, and the
    shipped kernels on inputs rounded to bf16."""
    from smow_net_tpu_torch.ops import scan

    diff = lambda: float((probs() - want).abs().max())
    nudged = []
    for eps in (1e-6, -1e-6):
        with swap_scan(lambda *a, eps=eps: scan.selective_scan_plain(
                *a, delta_softplus=True) * (1 + eps), flat=True):
            nudged.append(diff())
    with seg_route(1 << 30):
        seq = diff()

    def unseeded(*args):
        a = scan._Args(*args, flat=True)
        return scan._scan_fwd(a, scan.seg_count(a.rows, a.L, a.Cg))

    def bf16(u, dt, A, Bm, Cm, D, bias):
        return scan._FlatScan.apply(u.bfloat16(), dt.bfloat16(), A, Bm.bfloat16(),
                                    Cm.bfloat16(), D, bias).float()

    controls = []
    for fn in (unseeded, bf16):
        with swap_scan(fn, flat=True):
            controls.append(diff())
    return (nudged, seq, *controls)


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


def phase_train(dev, name: str, phase: int, rounds: int, per_round: int = 5,
                bs: int = 16, plain: bool = True) -> dict:
    from smow_net_tpu_torch.ops import _kernels

    gc.collect()
    torch.cuda.empty_cache()

    log(f"phase {phase}: main path, {name} train step, bf16 compute over fp32 masters, "
        f"6 steps on one repeated batch of {bs} x 256^2")
    steps = 6
    model, state, step = _train_setup(name, torch.bfloat16, steps)
    batch = make_batches(dev, 1, bs, 256, seed=8)[0]
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.detach().clone() for n, b in model.named_buffers() if "running" in n}
    torch.cuda.synchronize()

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for i in range(steps):
        losses.append(float(step(state, batch)))
        log(f"  step {i}: device memory allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
            f"GiB, peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        counts = dict(_kernels.launches)
        require(counts == {n: k * (i + 1) for n, k in TRAIN_KERNELS[name].items()},
                f"launch counts {counts} after train step {i + 1}: per step "
                f"{TRAIN_KERNELS[name]}, and never {TRAIN_ABSENT[name]}")
        log(f"  step {i}: loss {losses[-1]:.6f}")
    launches = {n: _kernels.launches[n] for n in tuple(TRAIN_KERNELS[name]) + TRAIN_ABSENT[name]}
    log(f"  launches {launches}; cm {state.cm.tolist()}")
    log(f"  peak device memory, kernel path: {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
        "GiB")
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
    require(float(state.loss_count) == steps and float(state.cm.sum()) == steps * bs * 256 ** 2,
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
    medians = alternate_rounds(round_ms, rounds, "step", per_round, plain)
    STEP_MEDIANS[name] = medians["kernel"]
    log(f"  peak device memory, both paths' rounds: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

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
    log_port_kernels(on_device, 3, "step")
    os.makedirs(PROFILE_DIR, exist_ok=True)
    with open(os.path.join(PROFILE_DIR, f"{name}_train_bf16_bs16_profile.txt"), "w") as fh:
        fh.write(averages.table(sort_by="cuda_time_total", row_limit=60,
                                max_name_column_width=100))
    return launches


# each model's kernel-path median ms per bf16 train step on one repeated batch
# (phases 7, 11, 17, 23), for phase 26's comparison with the train CLI's step
STEP_MEDIANS = {}

FUSED_TRAIN_KERNELS = dict.fromkeys(("token_scatter_fwd", "token_scatter_bwd", "xattn_layer_fwd",
                                     "xattn_layer_bwd"), 1)


def phase_token_chains(dev, rounds: int = 2, per_round: int = 5) -> dict:
    """SMOW_Net's bf16 train step at 16 x 256^2 on the fused token chain
    (D forward, D-bwd backward), launches counted; then the whole step on
    each of the three chains in turns."""
    from smow_net_tpu_torch.ops import _kernels

    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 8b: SMOW_Net train step on the fused token chain (token_train_chain='fused'), "
        f"bf16 compute over fp32 masters, one repeated batch of 16 x 256^2; then the three "
        f"chains' whole steps in turns ({rounds} rounds x {per_round} steps)")
    steps = 3
    model, state, step = _train_setup("smow_net", torch.bfloat16, steps)
    batch = make_batches(dev, 1, 16, 256, seed=8)[0]
    model.token_train_chain = "fused"
    torch.cuda.synchronize()
    reset_launches()
    losses = []
    for i in range(steps):
        losses.append(float(step(state, batch)))
        counts = dict(_kernels.launches)
        require(counts == {n: k * (i + 1) for n, k in FUSED_TRAIN_KERNELS.items()},
                f"launch counts {counts} after train step {i + 1} on the fused chain: per step "
                f"{FUSED_TRAIN_KERNELS}, no other kernel")
    launches = dict(_kernels.launches)
    log(f"  losses {losses}; launches {launches}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"the loss must be finite and fall on a repeated batch: {losses}")

    def round_ms():
        step(state, batch)
        torch.cuda.synchronize()
        out = []
        for _ in range(per_round):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, batch)
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return float(np.median(out))

    chains = ("hybrid", "unfused", "fused")
    table = {c: [] for c in chains}
    for r in range(rounds):
        for chain in (chains if r % 2 == 0 else chains[::-1]):
            model.token_train_chain = chain
            table[chain].append(round_ms())
    for chain, row in table.items():
        log(f"  (finding) SMOW_Net train step, chain {chain}: median ms/step per round "
            + " / ".join(f"{t:.3f}" for t in row))
    model.token_train_chain = None
    del model, state, step
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


def phase_fp32_train_grads(dev, name: str, phase, **model_kwargs) -> None:
    from smow_net_tpu_torch.models import get_model
    from smow_net_tpu_torch.nn.ssm import DropPath
    from smow_net_tpu_torch.train.loss import bce_dice_loss
    from smow_net_tpu_torch.train.trainer import select_pred

    log(f"phase {phase}: whole-model {name} {model_kwargs or ''} fp32 train gradients (TF32 "
        "off, deterministic cuDNN), kernel path vs plain path (the Mamba models: the plain "
        "scan's backward on the kernel's values), batch 2, 256^2")
    model = get_model(name, **model_kwargs)
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
    # the scan models: ChangeMamba's direction-major scan, CD-Mamba's flat one
    flat = name == "cd_mamba"
    scan_model = flat or any(isinstance(m, DropPath) for m in model.modules())
    hybrid = _FlatKernelValuePlainGrad if flat else _KernelValuePlainGrad
    reference = swap_scan(hybrid.apply, flat) if scan_model else plain_ops()
    torch.backends.cudnn.deterministic = True
    try:
        loss_k, got = grads()
        with reference:
            loss_p, want = grads()
            again = grads()[1]              # the reference again: its run-to-run spread
        if scan_model:
            from smow_net_tpu_torch.ops import scan

            plain = scan.selective_scan_plain if flat else scan.cross_selective_scan_plain
            with plain_ops():
                loss_s, strict = grads()
            kink = []
            for eps in (1e-6, -1e-6):
                with swap_scan(lambda *a, eps=eps: plain(*a, delta_softplus=True) * (1 + eps),
                               flat):
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
            f"{n} {err:.3e} of its largest element (4x the nudges' spread: {bound:.3e})")
        require(abs(loss_k - loss_s) <= 1e-5 * abs(loss_s),
                "the kernel path's loss differs from the strict plain path's")
        # CD-Mamba's kinks move whole leaves (the nudges' spread is ~0.5 of a
        # leaf, and a bound over 1 would pass a zero gradient): its gradients
        # are held by the hybrid reference below and the strict path's loss
        require(flat or err <= bound, f"{n}: kernel path vs strict plain path {err:.3e} of its "
                "largest element, over 4x the kink sensitivity")
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


# phase 32's SS2D forms: keyword arguments at width 96 on a 32 x 32 map
FAMILY_CASES = {"k8": dict(k_group=8), "1d": dict(scan_variant="1d"),
                "2d": dict(scan_variant="2d"), "xv1aact": dict(forward_type="xv1aact"),
                "xv2amul": dict(forward_type="xv2amul"),
                "xv3asoftmax": dict(forward_type="xv3asoftmax"), "dstate8": dict(d_state=8)}


def _resize_by_matmul(x: torch.Tensor, size, align_corners: bool = False) -> torch.Tensor:
    """`ops.resize.resize_linear` with align_corners (the only form
    RS-Mamba's head takes) as two products with the per-axis interpolation
    matrices: its backward is matmuls, with no atomics."""
    require(align_corners, "the matmul resize is corner-aligned only")

    def weights(n_in, n_out):
        src = torch.arange(n_out, device=x.device, dtype=torch.float64) * (
            (n_in - 1) / max(n_out - 1, 1))
        lo = src.floor().clamp(max=n_in - 1)
        frac = src - lo
        m = torch.zeros(n_out, n_in, device=x.device, dtype=torch.float64)
        m[torch.arange(n_out), lo.long()] += 1 - frac
        m[torch.arange(n_out), (lo.long() + 1).clamp(max=n_in - 1)] += frac
        return m.to(x.dtype)

    return torch.einsum("oh,bchw,pw->bcop", weights(x.shape[2], size[0]), x,
                        weights(x.shape[3], size[1]))


def phase_layer_family(dev) -> dict:
    """SS2D's other forms and RS-Mamba's remat on the card: each form's
    output and gradients, kernel path vs plain path; RS-Mamba's step with
    remat vs without."""
    from smow_net_tpu_torch.models import get_model, rs_mamba
    from smow_net_tpu_torch.nn.ssm import SS2D, DropPath
    from smow_net_tpu_torch.ops import _kernels
    from smow_net_tpu_torch.ops.resize import resize_linear
    from smow_net_tpu_torch.train.loss import bce_dice_loss
    from smow_net_tpu_torch.train.schedule import get_schedule
    from smow_net_tpu_torch.train.trainer import (create_train_state, make_optimizer,
                                                  make_train_step, select_pred)

    log("phase 32: the layer family: SS2D at K = 8, scan_variant 1d and 2d, xv1a, xv2a and xv3a "
        "with a postfix each (kernel I once per forward, I-ckpt and I-bwd once per backward) "
        "and d_state 8 (kernel J: once forward, twice backward), fp32 at (2, 32, 32, 96), "
        "kernel path vs plain path (output 1e-5 of its largest element, each gradient 1e-4 "
        "of its largest); then an RS-Mamba fp32 forward + backward at batch 2, 256^2, with "
        "use_checkpoint vs without, the head resizing by matmuls (the loss to 1e-6, every "
        "gradient within 1e-6 of the leaf's largest element), and one bf16 train step at "
        "batch 2 with and without it")
    rng = np.random.default_rng(60)
    x = torch.from_numpy(rng.normal(size=(2, 32, 32, 96)).astype(np.float32)).to(dev)
    for name, kw in FAMILY_CASES.items():
        torch.manual_seed(61)
        m = SS2D(96, **kw).to(dev)
        leaves = [x.detach().requires_grad_()] + list(m.parameters())
        gy = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32)).to(dev)

        def run():
            m.zero_grad(set_to_none=True)
            y = m(leaves[0])
            return y.detach(), torch.autograd.grad(y, leaves, gy)

        reset_launches()
        y, grads = run()
        counts = dict(_kernels.launches)
        want_counts = ({"scan_states": 3} if "d_state" in kw
                       else dict.fromkeys(SCAN_KERNELS, 1))
        require(counts == want_counts, f"SS2D {name}: launches {counts}, not {want_counts}")
        with plain_ops():
            y_p, grads_p = run()
        require(dict(_kernels.launches) == counts, f"SS2D {name}: the plain path launched")
        log(f"  SS2D {name}: launches {counts}")
        check(f"SS2D {name} output", y, y_p, 0.0, 1e-5)
        names = ["x"] + [n for n, _ in m.named_parameters()]
        for n, g, w in zip(names, grads, grads_p):
            check(f"SS2D {name} d{n}", g, w, 0.0, 1e-4)
        del m, leaves, grads, grads_p

    batch = make_batches(dev, 1, 2, 256, seed=62)[0]
    x1, x2 = (batch[k].permute(0, 3, 1, 2) for k in ("A", "B"))
    generator = torch.Generator(device=dev)
    sd, runs = None, []
    # the head's bilinear resize adds its CUDA backward with atomics, so two
    # runs of one step would differ in the last bits of every gradient
    # upstream: these passes resize by interpolation matrices instead, whose
    # backward is two matmuls
    torch.backends.cudnn.deterministic = True
    rs_mamba.resize_linear = _resize_by_matmul
    try:
        for remat in (False, False, True):
            model = get_model("rs_mamba", use_checkpoint=remat).train()
            if sd is None:
                sd = seeded_state_dict(model, 0)
            model.load_state_dict(sd)
            for mod in model.modules():
                if isinstance(mod, DropPath):
                    mod.generator = generator
            generator.manual_seed(0)
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            loss = bce_dice_loss(select_pred(model(x1, x2)), batch["mask"])
            loss.backward()
            runs.append((float(loss.detach()), dict(_kernels.launches),
                         {n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None},
                         torch.cuda.max_memory_allocated() / 2 ** 30))
            del model, loss
    finally:
        torch.backends.cudnn.deterministic = False
        rs_mamba.resize_linear = resize_linear
    (loss0, counts0, g0, mem0), (_, _, again, _), (loss1, counts1, g1, mem1) = runs
    log(f"  RS-Mamba without remat: loss {loss0:.7f}, launches {counts0}, peak {mem0:.2f} GiB")
    log(f"  RS-Mamba with remat: loss {loss1:.7f}, launches {counts1}, peak {mem1:.2f} GiB")
    require(counts0 == dict.fromkeys(SCAN_KERNELS, 15), "the step without remat runs I 15 times")
    require(counts1 == {"selective_scan_fwd": 30, "selective_scan_ckpt": 15,
                        "selective_scan_bwd": 15},
            "the remat step runs I-fwd once more per call (the recompute)")
    require(abs(loss1 - loss0) <= 1e-6 * abs(loss0), "remat changed the loss")
    require(g0.keys() == g1.keys(), "remat changed which parameters get gradients")
    spread, n_s = leaf_errors(g0, again)[0]
    err, n = leaf_errors(g0, g1)[0]
    log(f"  remat vs no remat: worst leaf {n} {err:.3e} of its largest element; no remat vs "
        f"itself: {n_s} {spread:.3e} (bound 1e-6)")
    require(err <= 1e-6, f"{n}: remat changed the gradient by {err:.3e} of its largest "
            "element, over 1e-6")
    del g0, g1, again

    # the bf16 train step swaps bf16 copies of the masters in: the recompute
    # must run on them (1 step at batch 2, remat against no remat)
    losses = {}
    for remat in (False, True):
        model = get_model("rs_mamba", use_checkpoint=remat)
        model.load_state_dict(sd)
        opt = make_optimizer(get_schedule("cosine", 1e-4, epochs=1, iters_per_epoch=1))(
            model.parameters())
        state = create_train_state(model, opt, seed=3)
        reset_launches()
        losses[remat] = float(make_train_step(model, opt, torch.bfloat16)(state, batch))
        counts = dict(_kernels.launches)
        require(counts == {"selective_scan_fwd": 30 if remat else 15, "selective_scan_ckpt": 15,
                           "selective_scan_bwd": 15}, f"bf16 step, remat {remat}: {counts}")
        require(all(bool(torch.isfinite(p).all()) for p in model.parameters()),
                "the bf16 remat step's parameters must stay finite")
        del model, opt, state
    log(f"  bf16 train step at batch 2: loss {losses[False]:.6f}, with remat "
        f"{losses[True]:.6f}; I-fwd 15 and 30 launches")
    require(abs(losses[True] - losses[False]) <= 1e-6 * abs(losses[False]),
            "remat changed the bf16 step's loss")
    return {"remat_peak_gib": mem1, "peak_gib": mem0}


# the device functions of SMOW_Net's bf16 train-step kernels (E, C, A-bwd, F,
# F-bwd), which the train CLI's profiler trace must name
CLI_TRACE_FUNCTIONS = ("token_scatter_fwd_kernel", "grid_sample_t_vjp_kernel",
                          "grid_sample_bwd_kernel", "layer_fwd_tc", "layer_bwd_tc")
# the four colours of `cli.test.colorize` as the PNG stores them (RGB)
VIS_RGB = {(0, 0, 0): (0, 0), (255, 255, 255): (1, 1), (255, 0, 0): (1, 0), (0, 255, 0): (0, 1)}


def _cli(fn, *args):
    """Run a CLI entry with its standard output captured, then log it."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    for line in buf.getvalue().splitlines():
        log("    | " + line)
    return out, buf.getvalue()


def _watch(run, timings) -> None:
    """Wrap the CLI's train and eval steps: each call must launch exactly
    SMOW_Net's train kernels (E, C, A-bwd, F, F-bwd) or eval kernels (D, F
    in fp32) once; its host time to the end of its device work is logged
    (this measurement synchronises after each call)."""
    from smow_net_tpu_torch.ops import _kernels

    def watched(step, expect, key):
        def call(*args):
            before = dict(_kernels.launches)
            t0 = time.perf_counter()
            timings[key + "_starts"].append(t0)
            out = step(*args)
            torch.cuda.synchronize()
            timings[key].append((time.perf_counter() - t0) * 1e3)
            ran = {n: c - before.get(n, 0) for n, c in _kernels.launches.items()
                   if c != before.get(n, 0)}
            require(ran == expect, f"the CLI's {key} step launched {ran}, not {expect}")
            return out
        return call

    run.train_step = watched(run.train_step, TRAIN_KERNELS["smow_net"], "train")
    run.eval_step = watched(run.eval_step, EVAL_KERNELS["smow_net"], "val")


def _check_outputs(out: str, epochs: int, log_text: str) -> None:
    lines = {n: open(os.path.join(out, n)).read().splitlines()
             for n in ("train.txt", "val.txt", "metrics.jsonl")}
    require(all(len(v) == epochs for v in lines.values()),
            f"train.txt, val.txt and metrics.jsonl hold {epochs} lines each: "
            f"{ {n: len(v) for n, v in lines.items()} }")
    require(lines["train.txt"][-1].startswith(f"Epoch: {epochs}, IoU: "),
            f"epoch {epochs} lands in train.txt: {lines['train.txt'][-1]}")
    records = [json.loads(r) for r in lines["metrics.jsonl"]]
    losses = [float(x) for x in re.findall(r"Loss: (\S+)", log_text)]
    require(losses and np.isfinite(losses).all()
            and np.isfinite([r["train_loss"] for r in records]).all(),
            f"the train loss is finite: printed {losses}")
    require(all(os.path.isfile(os.path.join(out, n)) for n in ("best", "last")),
            "`best` and `last` are written")


def _check_visualisations(vis: str, data: str, cm: np.ndarray) -> None:
    """Every PNG the test CLI wrote decodes (through png.py) to `colorize` of
    a prediction: only its four colours; the ground truth it shows is the
    label file's, and its TP, FP, FN and TN pixels sum to the CLI's
    confusion matrix."""
    from smow_net_tpu_torch.cli.test import colorize
    from smow_net_tpu_torch.data import png

    names = open(os.path.join(data, "list", "test.txt")).read().split()
    counts = np.zeros((2, 2))
    for name in names:
        rgb = np.rint(png.read_png(os.path.join(vis, name)) * 255).astype(np.uint8)
        gt = (png.read_png(os.path.join(data, "label", name)) > 0.5).astype(np.uint8)
        pred = np.zeros_like(gt)
        seen = np.zeros(gt.shape, bool)
        for colour, (p, g) in VIS_RGB.items():
            at = (rgb == colour).all(-1)
            pred[at] = p
            seen |= at
            require(bool((gt[at] == g).all()), f"{name}: a {colour} pixel over ground truth "
                    f"{1 - g}")
            counts[g, p] += at.sum()
        require(bool(seen.all()), f"{name}: pixels outside the four colours")
        require(np.array_equal(rgb, colorize(pred, gt)[..., ::-1]),
                f"{name}: the file is not colorize(prediction, ground truth)")
    require(np.array_equal(counts, cm), f"the PNGs' pixel classes {counts.tolist()} are the "
            f"CLI's confusion matrix {cm.tolist()}")


def phase_clis(dev, smi: str) -> None:
    """Phase 26: the train and test CLIs on the card from PNG files."""
    from concurrent.futures import ThreadPoolExecutor

    from smow_net_tpu_torch.cli import test as cli_test
    from smow_net_tpu_torch.cli import train as cli_train
    from smow_net_tpu_torch.data import png
    from smow_net_tpu_torch.data.dataset import (CDDataset, DataLoader,
                                                 generate_synthetic_dataset, prefetch_to_device)
    from smow_net_tpu_torch.ops import _kernels

    log("phase 26: the CLIs from files: the synthetic set at 256^2 (32 train, 16 val, 16 "
        "test), cli.train on smow_net (bf16, batch 16, 2 epochs, 8 threads, --profile), "
        "--resume to epoch 3, cli.test on `best`, kernel path then plain path")
    gc.collect()
    torch.cuda.empty_cache()
    work = os.path.join("_scratch", "chip_smoke_clis")     # gitignored; removed at the end
    shutil.rmtree(work, ignore_errors=True)
    data, out, trace = (os.path.join(work, n) for n in ("data", "out", "trace"))
    t0 = time.perf_counter()
    generate_synthetic_dataset(data, n_train=32, n_val=16, size=256, seed=0)
    log(f"  synthetic set written in {time.perf_counter() - t0:.2f} s")

    reset_launches()
    args = ["--model", "smow_net", "--data_dir", data, "--output_dir", out, "--batchsize", "16",
            "--bf16", "--num_workers", "8"]
    timings = collections.defaultdict(list)
    opt = cli_train.parse_option(args + ["--epochs", "2", "--profile", trace])
    run, _ = _cli(cli_train.setup, opt)
    _watch(run, timings)
    _, text = _cli(cli_train.fit, opt, run)
    _check_outputs(out, 2, text)
    with open(os.path.join(trace, "trace.json")) as fh:
        kernels = {e["name"] for e in json.load(fh)["traceEvents"] if e.get("cat") == "kernel"}
    missing = [f for f in CLI_TRACE_FUNCTIONS if not any(f in k for k in kernels)]
    require(not missing, f"the profiler trace names no {missing}")
    ours = sorted(k[:80] for k in kernels if any(f in k for f in CLI_TRACE_FUNCTIONS))
    log(f"  the trace ({len(kernels)} kernel names) names the train kernels: {ours}")

    last = torch.load(os.path.join(out, "last"), map_location=dev, weights_only=True)
    opt = cli_train.parse_option(args + ["--epochs", "3", "--resume", os.path.join(out, "last")])
    run, text = _cli(cli_train.setup, opt)
    require(f"resumed from {os.path.join(out, 'last')} at epoch 3" in text, "the resume line")
    state = run.model.state_dict()
    require(set(state) == set(last["model"]) and all(torch.equal(state[k], v)
                                                     for k, v in last["model"].items()),
            "the resumed parameters and BN buffers equal `last`'s, bitwise")
    moments = run.state.optimizer.state_dict()["inner"]["state"]
    require(run.state.optimizer.count == last["optimizer"]["count"] == 4
            and all(torch.equal(moments[i][k], v)
                    for i, st in last["optimizer"]["inner"]["state"].items()
                    for k, v in st.items()),
            "the optimizer count (4) and moments equal `last`'s, bitwise")
    _watch(run, timings)
    _, text = _cli(cli_train.fit, opt, run)
    _check_outputs(out, 3, text)
    log(f"  launches per CLI train step {TRAIN_KERNELS['smow_net']} over "
        f"{len(timings['train'])} steps, per val batch {EVAL_KERNELS['smow_net']} over "
        f"{len(timings['val'])} batches: held")

    cms = {}
    for path in ("kernel", "plain"):
        before = dict(_kernels.launches)
        test_opt = cli_test.parse_option([
            "--model", "smow_net", "--data_dir", data, "--checkpoint", os.path.join(out, "best"),
            "--output_dir", os.path.join(work, f"vis_{path}")])
        with plain_ops() if path == "plain" else contextlib.nullcontext():
            (_, cms[path]), _ = _cli(cli_test.main, test_opt)
        ran = {n: c - before.get(n, 0) for n, c in _kernels.launches.items()
               if c != before.get(n, 0)}
        want = {n: 16 * k for n, k in EVAL_KERNELS["smow_net"].items()} if path == "kernel" else {}
        require(ran == want, f"cli.test on the {path} path launched {ran}, not {want}")
    pixels = 16 * 256 * 256
    diff = float(np.abs(cms["kernel"] - cms["plain"]).max())
    log(f"  cli.test confusion matrices: kernel {cms['kernel'].tolist()}, plain "
        f"{cms['plain'].tolist()}; max difference {diff:.0f} pixels "
        f"({diff / pixels:.2e} of {pixels}; bound 1e-4)")
    require(diff <= 1e-4 * pixels, "the test CLI's kernel and plain paths agree")
    _check_visualisations(os.path.join(work, "vis_kernel"), data, cms["kernel"])
    log("  16 visualisations decode to colorize(prediction, ground truth), their pixels "
        "summing to the confusion matrix")

    # what sets the pace: the input pipeline or the step
    log(f"  timings on {smi.strip()}:")
    loader = DataLoader(CDDataset(data, "train"), 16, shuffle=True, num_workers=8)
    list(loader)
    t0 = time.perf_counter()
    n = sum(1 for _ in range(3) for _ in loader)
    log(f"    loader, native engine: {n / (time.perf_counter() - t0):.2f} batches/s "
        f"(16 x 256^2, 8 threads, {n} batches)")
    t0 = time.perf_counter()
    for _ in range(3):
        for batch in prefetch_to_device(iter(loader), dev):
            pass
    torch.cuda.synchronize()
    log(f"    the same through prefetch_to_device (pinned, non-blocking copies): "
        f"{6 / (time.perf_counter() - t0):.2f} batches/s")
    files = [os.path.join(data, sub, name) for name in CDDataset(data, "train").names
             for sub in ("A", "B", "label")]
    with ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        for _ in range(3):
            list(pool.map(png.read_png, files))
        log(f"    PNG decode alone: {6 / (time.perf_counter() - t0):.2f} batches/s "
            f"({len(files) // 2} files a batch, 8 threads)")
    steps, starts = timings["train"][1:], timings["train_starts"]
    gaps = [b - a for a, b in zip(starts, starts[1:])]
    log(f"    cli.train step (synchronised): median {np.median(steps):.2f} ms over "
        f"{len(steps)} steps after the first; start-to-start within an epoch "
        f"{[round(g * 1e3, 2) for g in gaps[0::2]]} ms; phase 7's step on one repeated "
        f"batch {STEP_MEDIANS['smow_net']:.2f} ms")
    log(f"    cli.train validation, fp32 eval step: {np.median(timings['val']):.2f} ms/batch "
        f"(median of {len(timings['val'])}: {[round(v, 2) for v in timings['val']]})")
    shutil.rmtree(work, ignore_errors=True)


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
    dbwd = phase_token_bwd(dev)
    phase_warp_modes(dev)
    phase_ofw_route(dev)
    f = {D: phase_kernel_f(dev, D) for D in (128, 64)}
    fb = {D: phase_kernel_f_bwd(dev, D) for D in (128, 64)}
    g, g_launches = phase_kernel_g(dev)
    gb, gb_launches = phase_kernel_g_bwd(dev)
    launches = phase_main_path(dev, "smow_net", 5, rounds=4)
    phase_fp32_model(dev, "smow_net", 6)
    train_launches = phase_train(dev, "smow_net", 7, rounds=2)
    phase_fp32_train_grads(dev, "smow_net", 8)
    fused_launches = phase_token_chains(dev)
    before = dict(_kernels.launches)
    phase_fp32_train_grads(dev, "smow_net", "8c", token_train_chain="fused")
    runs = {n: c - before.get(n, 0) for n, c in _kernels.launches.items() if c != before.get(n, 0)}
    require(runs == FUSED_TRAIN_KERNELS, f"phase 8c's kernel path ran D, D-bwd, F, F-bwd once "
            f"each: {runs}")
    lw_launches = phase_main_path(dev, "smow_net_lw", 9, rounds=4)
    phase_fp32_model(dev, "smow_net_lw", 10)
    lw_train_launches = phase_train(dev, "smow_net_lw", 11, rounds=2)
    phase_fp32_train_grads(dev, "smow_net_lw", 12)
    rate = mufu_per_s()
    log(f"  exp rate for kernel I's bound: {rate:.4e} /s (16 per clock per SM, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, clocks.max.sm)")
    scan_fwd = phase_scan_fwd(dev, rate)
    scan_bwd = phase_scan_bwd(dev, rate)
    cm_launches = phase_main_path(dev, "change_mamba", 15, rounds=2, per_round=3)
    phase_fp32_model(dev, "change_mamba", 16)
    cm_train_launches = phase_train(dev, "change_mamba", 17, rounds=1, per_round=2)
    phase_fp32_train_grads(dev, "change_mamba", 18)
    flat = phase_flat_scan(dev, rate)
    seg = phase_seg_scan(dev, rate)
    for n in FLAT_KERNELS:                   # their errors on the shipped route, phase 20
        flat[n]["max_abs_err"] = seg.pop(n)["max_abs_err"]
    # CD-Mamba on the shipped route: its kernels' launches per batch and step
    EVAL_KERNELS["cd_mamba"] = cdm_launches(train=False)
    TRAIN_KERNELS["cd_mamba"] = cdm_launches(train=True)
    log(f"  CD-Mamba's launches on the shipped route: per eval batch {EVAL_KERNELS['cd_mamba']}, "
        f"per train step {TRAIN_KERNELS['cd_mamba']}")
    cdm_eval = phase_main_path(dev, "cd_mamba", 21, rounds=2, per_round=2)
    check_cdm_calls(dev)
    phase_fp32_model(dev, "cd_mamba", 22)
    phase_fp32_train_grads(dev, "cd_mamba", 22)
    cdm_train = phase_train(dev, "cd_mamba", 23, rounds=2, per_round=2, plain=False)
    require(all(cdm_train.get(n, 0) > 0 for n in SEG_KERNELS),
            "CD-Mamba's train step launched the carry and adjcarry kernels")
    j_launches, j = phase_scan_states(dev)
    rs_scan = phase_scan_k8(dev, rate)
    rs_launches = phase_main_path(dev, "rs_mamba", 28, rounds=1, per_round=3)
    phase_fp32_model(dev, "rs_mamba", 29)
    # the plain scan's checkpointed backward does not fit the card at K = 8
    # and batch 16: the kernel path's rounds alone, as phase 23's
    rs_train_launches = phase_train(dev, "rs_mamba", 30, rounds=2, per_round=2, plain=False)
    phase_fp32_train_grads(dev, "rs_mamba", 31)
    phase_layer_family(dev)
    phase_clis(dev, smi.stdout)
    reset_launches()            # and no phase since phase 26's reset launched G or G-bwd

    log("phase 25: results (launches: D and F at D = 128 from SMOW_Net's eval path (phase "
        "5), E, C, A-bwd and F-bwd at D = 128 from its train step (phase 7), A-fwd and B "
        "from SMOW_Net_LW's train step (phase 11), F and F-bwd at D = 64 from SMOW_Net_LW's "
        "eval path (phase 9) and train step (phase 11), I-fwd from ChangeMamba's eval path "
        "(phase 15, 3 batches), I-ckpt and I-bwd from its train step (phase 17, 6 steps), "
        "H-fwd from CD-Mamba's eval path (phase 21, 3 batches), H-ckpt and H-bwd from its "
        "train step (phase 23, 6 steps), the carry and adjcarry from that train step; "
        f"SMOW_Net's train step ran F {train_launches['xattn_layer_fwd']} times, "
        f"SMOW_Net_LW's ran C {lw_train_launches['grid_sample_t_vjp']} and A-bwd "
        f"{lw_train_launches['grid_sample_bwd']} times, ChangeMamba's I-fwd "
        f"{cm_train_launches['selective_scan_fwd']} times, CD-Mamba's H-fwd "
        f"{cdm_train['selective_scan_fwd_flat']} times; D-bwd from SMOW_Net's train step on "
        f"the fused chain (phase 8b, 3 steps), J from the general route's checks (phase 24), "
        "an op path: no model has N != 16 or the softplus off; G and G-bwd from their checks "
        "(phases 4c and 4d), an op path: no model runs the attention sublayer alone, and "
        "every counter reset from phase 5 on found them at 0; the K = 8 rows: I-fwd from "
        "RS-Mamba's eval path (phase 28, 3 batches), I-ckpt and I-bwd from its train step "
        f"(phase 30, 6 steps; its I-fwd {rs_train_launches['selective_scan_fwd']} times), their "
        "errors and times from phase 27)")
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
        row("selective_scan_bwd", "selective_scan_bwd.cu", "scan_fused.py:291",
            cm_train_launches["selective_scan_bwd"], scan_bwd["selective_scan_bwd"]),
        row("selective_scan_fwd_flat", "selective_scan.cu", "scan_fused.py:754",
            cdm_eval["selective_scan_fwd_flat"], flat["selective_scan_fwd_flat"]),
        row("selective_scan_ckpt_flat", "selective_scan.cu", "scan_fused.py:754",
            cdm_train["selective_scan_ckpt_flat"], flat["selective_scan_ckpt_flat"]),
        row("selective_scan_bwd_flat", "selective_scan_bwd.cu", "scan_fused.py:754",
            cdm_train["selective_scan_bwd_flat"], flat["selective_scan_bwd_flat"]),
        row("selective_scan_carry", "selective_scan.cu", "scan_fused.py:188",
            cdm_train["selective_scan_carry"], seg["selective_scan_carry"]),
        row("selective_scan_adjcarry", "selective_scan.cu", "scan_fused.py:223",
            cdm_train["selective_scan_adjcarry"], seg["selective_scan_adjcarry"]),
        row("token_scatter_bwd", "token_scatter.cu", "warp.py:807",
            fused_launches["token_scatter_bwd"], dbwd),
        row("scan_states", "scan_states.cu", "scan.py:61", j_launches, j),
        row("cross_attn_fwd", "cross_attn.cu", "xattn.py:211", g_launches, g),
        row("cross_attn_bwd", "cross_attn_bwd.cu", "xattn.py:234", gb_launches, gb),
        row("selective_scan_fwd_k8", "selective_scan.cu", "scan_fused.py:147",
            rs_launches["selective_scan_fwd"], rs_scan["selective_scan_fwd"]),
        row("selective_scan_ckpt_k8", "selective_scan.cu", "scan_fused.py:261",
            rs_train_launches["selective_scan_ckpt"], rs_scan["selective_scan_ckpt"]),
        row("selective_scan_bwd_k8", "selective_scan_bwd.cu", "scan_fused.py:291",
            rs_train_launches["selective_scan_bwd"], rs_scan["selective_scan_bwd"]),
    ]
    require(all(k["launches"] > 0 for k in kernels), "every kernel of the JSON line launched")
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
