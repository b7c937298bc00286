#!/usr/bin/env python
"""Drive the PyTorch/CUDA port of SMOW_Net on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no result line is printed):
  1. card name and power limit (nvidia-smi); TF32 off for the fp32 phases
  2. build the hand-written kernels (smow_net_tpu_torch/csrc, nvcc sm_90a)
  3. kernel D (token scatter) vs its plain version: fp32 and bf16 at
     (32, 128, 128, 8), a logit spread > 87 (zaw underflow), C = 16
  4. kernel F (decoder layer) vs its plain version: (16, 16384, 128),
     h = 8, M = 8, hidden 256, with and without the lane permutation
  5. main path: get_model("smow_net") with numpy-seeded weights in bf16,
     make_eval_step over 3 batches of 16 x 256^2 pairs; each kernel's launch
     count must rise by exactly one per batch; then ms/batch (CUDA events)
     of the kernel path and of the same model forced through the plain ops,
     in alternating rounds; then torch.profiler over 3 kernel-path batches:
     the device's busy time per batch, and the profiler table written to
     chiprun_out/profile/
  6. whole model in fp32, kernel path vs plain path, batch 2 at 256^2
  7. the kernels' JSON line, then the result line as the last line

Bounds: fp32 kernels against fp32 plain versions differ only in summation
order (atomics in D, a different reduction order in F). bf16 kernels compute
in fp32 and round once on output, so they are held against the plain
version run in fp32 on the same bf16 inputs, to one bf16 rounding (2^-8
relative) of the largest output.

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


@contextlib.contextmanager
def plain_ops():
    """Route the model's two kernel ops through their plain versions (for
    timing and the fp32 comparison only; the model never does this)."""
    from smow_net_tpu_torch.ops import warp, xattn

    saved = warp.token_scatter, xattn.cross_layer_head1
    warp.token_scatter, xattn.cross_layer_head1 = (warp.token_scatter_plain,
                                                   xattn.cross_layer_head1_plain)
    try:
        yield
    finally:
        warp.token_scatter, xattn.cross_layer_head1 = saved


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
                log(f"  slice bf16 time: kernel {result['ms']:.4f} ms, "
                    f"plain {result['plain_ms']:.4f} ms")

    case("slice", (32, 128, 128, 8))
    case("spread>87", (32, 128, 128, 8), spike=True)
    case("W*C=2048", (32, 128, 128, 16))
    return result


def _layer_args(dev, B, N, D=128, h=8, M=8, hid=256, seed=4):
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    return [f(B, N, D), f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, h, scale=0.1),
            f(B, M, h), f(B, M, h), f(h, D, scale=0.1), f(D, scale=0.1),
            f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, hid, scale=D ** -0.5),
            f(hid, scale=0.1), f(hid, D, scale=hid ** -0.5), f(D, scale=0.1)]


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
                    log(f"  bf16 time: kernel {result['ms']:.4f} ms, "
                        f"plain {result['plain_ms']:.4f} ms")
    # ragged tail: N not a multiple of the kernel's 64-row tile
    args = _layer_args(dev, 2, 1000, seed=5)
    check("ragged (2,1000,128) fp32", xattn.cross_layer_head1(*args, scale=scale),
          xattn.cross_layer_head1_plain(*args, scale=scale), 1e-4, 1e-5)
    # what the decoder pays to reach (B, N, D) rows from NCDHW before kernel F
    y = torch.randn(16, 32, 4, 128, 128, device=dev, dtype=torch.bfloat16)
    t_ms = cuda_ms(lambda: y.reshape(16, 128, 16384).transpose(1, 2).contiguous())
    log(f"  (info) NCDHW -> (B, N, D) transpose before kernel F, bf16 bs16: {t_ms:.4f} ms")
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
    model = model.to(dev).to(torch.bfloat16)
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
    on_device = [e for e in averages if e.device_type == DeviceType.CUDA]
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
    model = model.to(dev).eval()
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
    f = phase_kernel_f(dev)
    launches = phase_main_path(dev)
    phase_fp32_model(dev)

    kernels = [
        dict(name="token_scatter_fwd", route="cuda",
             source="smow_net_tpu_torch/csrc/token_scatter.cu",
             replaces="smow_net_tpu/ops/pallas/warp.py:781",
             launches=launches["token_scatter_fwd"], **d),
        dict(name="xattn_layer_fwd", route="cuda",
             source="smow_net_tpu_torch/csrc/xattn_layer.cu",
             replaces="smow_net_tpu/ops/pallas/xattn.py:609",
             launches=launches["xattn_layer_fwd"], **f),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
