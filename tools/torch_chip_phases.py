"""Run some of chip_smoke.py's kernel phases alone, on one NVIDIA GPU.

    python tools/torch_chip_phases.py 3b 3c          # from a checkout's root
    python tools/torch_chip_phases.py --tree PATH 3b # the checkout at PATH
    python tools/torch_chip_phases.py --tree PATH fwd bwd
    python tools/torch_chip_phases.py --tree PATH 4 4b layer
    python tools/torch_chip_phases.py --tree PATH adjcarry scatter
    python tools/torch_chip_phases.py --tree PATH 4c 4d attn
    python tools/torch_chip_phases.py --tree PATH states route
    python tools/torch_chip_phases.py 27 28 29 30 31 32   # RS-Mamba and the layer family

Builds the kernels of the checkout it runs from (or of --tree), sets the
fp32 comparisons' flags as chip_smoke.py does (TF32 off) and runs the named
phases: 3 (D), 3b (E, C, A-bwd), 3c (A-fwd, B), 3d (the unfused chain), 3e
(D-bwd), 3f (the warp modes and NaN grids), 3g (the OFW route), 13 (I-fwd),
14 (I-ckpt and I-bwd), 19 (kernel H), 20 (H on the shipped segmented
route, and its A/B), 4 and 4b (F and F-bwd, the decoder layer, at D = 128
and 64), 4c and 4d (G and G-bwd, its attention sublayer, an op path), 27
(kernel I at K = 8), 28-31 (RS-Mamba: the eval step, the fp32 model, the
train step, the fp32 gradients) and 32 (SS2D's other forms, and remat). Each
phase holds its kernels against their plain
versions and logs their times, as in the whole script; a phase that
returns the JSON line's numbers prints them.

`fwd` and `bwd` time the selective scan's sweeps alone, bf16, on inputs
made on the card from a seed (the phases' numpy-seeded inputs take minutes
to make at these sizes), summed over the calls of one ChangeMamba forward
or train step (chip_smoke.SCAN_CALLS, 27 calls: I-fwd, I-ckpt, I-bwd) and
of one CD-Mamba forward or train step (chip_smoke.CDM_CALLS, 33 calls on
the shipped segmented route, seeded: H-fwd, H-ckpt, H-bwd, and the carry,
once per segmented call of a forward). `fwd` takes I-fwd, I-ckpt, H-fwd,
H-ckpt and the carry, `bwd` I-bwd and H-bwd. Each is timed as the wrapper
(`scan._scan_fwd`, `_scan_ckpt`, `scan_carry`, `_scan_bwd`: its
allocations, casts and the sum of I-bwd's dB and dC partials; CUDA events
over 5 calls) and as the kernel alone (`launch_ms`: CUDA events around
each launch, as phases 14 and 19 time it).
It takes its timers from the chip_smoke.py beside this tool, whatever
--tree is, and only `ops.scan` from the tree, so one run per tree compares
any two trees since the kernels' port.

`layer` times kernels F and F-bwd alone, bf16, at (16, 16384, D) for D =
128 and 64 (SMOW_Net's and SMOW_Net_LW's decoder layer at 16 x 256^2), on
inputs made on the card from a seed: F through `xattn.cross_layer_head1`,
F-bwd through `xattn._kernel_bwd`, each as the wrapper (CUDA events over 20
calls) and as the kernel alone (`launch_ms`, CUDA events around each
launch, over 20 calls).

`adjcarry` times H-seg's adjoint carry (`scan.scan_adjcarry`) and, beside
it, the carry (`scan.scan_carry`, the same sweep forwards) at (64 rows,
65536, 32), G = 2, on the tree's shipped S (`scan.seg_count`), bf16, on
inputs made on the card from a seed: the wrapper (CUDA events over 5
calls) and the kernel alone (`launch_ms`, over 5 calls).

`scatter` times kernels D and E (`warp.token_scatter`, without and with
the residual), D-bwd (`warp.token_scatter_bwd`) and, beside them, B
(`warp.grid_sample_transpose`, the same tile scatter) at (32, 128, 128, 8)
bf16 on an i.i.d. flow of std 3 pixels (chip_smoke.py phase 3's), made on
the card from a seed: the wrapper from a CUDA graph of 20 calls
(`graph_ms`; its zeroed accumulators and casts included) and the kernel
alone (`kernel_only_ms`, the profiler).

`attn` times kernels G (`xattn.cross_attn_head1`) and G-bwd
(`xattn._kernel_bwd`: the kernel, its allocations and the sum of its
per-block records) at (16, 16384, D) bf16, D = 128 (phases 4c and 4d's
timed shape) and 64, on inputs made on the card from a seed: the wrapper
from a CUDA graph of 20 calls (`graph_ms`) and the kernel alone
(`launch_ms`, CUDA events around each launch, over 20 calls). Run it per
tree in turns (parent, change, change, parent) for G's and G-bwd's A/B.

`states` times kernel J (`scan.scan_states`) at (13, 62500, 1024), the
shape of phase 24's timing (416 strips of 32 lanes), and at (2, 62500, 256)
(L = 250^2 at N = 4, Dch = 64, batch 2: 16 strips), fp32, forward and
reverse, on inputs made on the card from a seed: the wrapper (CUDA events
over 5 calls: its scratch included) and the kernel alone (`launch_ms`, over
5 calls), beside the byte bound (12 bytes per element over 3.35 TB/s).
`states_strips` times J in chained segments against one segment a strip
(`scan.STATES_MIN_STRIPS` set to 0 or past every count for the calls) at
L = 62500 and 16 to 416 strips, forward: the A/B that sets
`scan.STATES_MIN_STRIPS`.

`route` is phase 24's A/B alone: the general route (`scan._StatesScan`: J
once forward, twice backward) against kernel H's (`scan._FlatScan`) on the
same bf16 inputs at L = 62500, Dch 64, G 2, N 16 and phase 24's batch,
forward and forward + backward (CUDA events over 3 and 2 calls).

For an A/B of two trees on one card, call it once per tree in turns
(parent, change, change, parent).
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

PHASES = ["3", "3b", "3c", "3d", "3e", "3f", "3g", "4", "4b", "4c", "4d", "13", "14", "19",
          "20", "27", "28", "29", "30", "31", "32", "fwd", "bwd", "layer", "adjcarry", "scatter",
          "attn", "states", "states_strips", "route"]
# the sweeps each timing mode takes
SWEEPS = {"fwd": ("I-fwd", "I-ckpt", "H-fwd", "H-ckpt", "carry"), "bwd": ("I-bwd", "H-bwd")}


def own_chip_smoke():
    """The chip_smoke.py of this tool's own checkout, loaded beside the
    tree's: its timers time every tree alike."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_timers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep_times(dev, mode: str) -> dict:
    """The sweeps of SWEEPS[mode], bf16, each summed over one forward's or
    train step's calls: the wrapper and the kernel alone (see the module's
    docstring)."""
    import torch

    from smow_net_tpu_torch.ops import scan

    cs = own_chip_smoke()
    gen = torch.Generator(dev).manual_seed(90)
    names = SWEEPS[mode]

    def rand(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, device=dev, generator=gen).to(dtype)

    def decays(channels):
        return -torch.exp(torch.log(torch.arange(1, 17, device=dev, dtype=torch.float32))
                          + 0.1 * rand(channels, 16, dtype=torch.float32))

    def biases(channels):
        lo, hi = torch.log(torch.tensor([1e-3, 0.1]))
        return lo + (hi - lo) * torch.rand(channels, device=dev, generator=gen)

    def timed(label, n, calls):
        """Time calls[name] = (fn, C entry) for each of this mode's names."""
        for name in names:
            if name not in calls:
                continue
            fn, entry = calls[name]
            t = cs.cuda_ms(fn, iters=5, warmup=1)
            tk = cs.launch_ms(fn, entry, iters=5)
            print(f"  {name} {label} x{n}: wrapper {t:.4f} ms, kernel {tk:.4f} ms", flush=True)
            out[name] += n * t
            out[name + " kernel"] += n * tk

    out = dict.fromkeys([k for n in names for k in (n, n + " kernel")], 0.0)
    for (B, K, L, Dk), n in cs.SCAN_CALLS:
        a = scan._Args(rand(B, K, L, Dk), rand(B, K, L, Dk), decays(K * Dk), rand(B, K, L, 16),
                       rand(B, K, L, 16), 1 + 0.1 * rand(K * Dk, dtype=torch.float32),
                       biases(K * Dk))
        calls = {"I-fwd": (lambda: scan._scan_fwd(a), "selective_scan_fwd"),
                 "I-ckpt": (lambda: scan._scan_ckpt(a), "selective_scan_ckpt")}
        if mode == "bwd":
            gy, hck = rand(B, K, L, Dk), scan._scan_ckpt(a)
            calls["I-bwd"] = (lambda: scan._scan_bwd(a, gy, hck), "selective_scan_bwd")
        timed(str((B, K, L, Dk)), n, calls)
        del a, calls
    for (B, L, G, Cg), n in cs.CDM_CALLS:
        a = scan._Args(rand(B, L, G * Cg), rand(B, L, G * Cg), decays(G * Cg),
                       rand(B, L, G, 16), rand(B, L, G, 16),
                       1 + 0.1 * rand(G * Cg, dtype=torch.float32), biases(G * Cg), flat=True)
        S = scan.seg_count(a.rows, L, Cg)
        seeds = [torch.rand(a.rows * S, 16, Cg, device=dev, generator=gen) if S > 1 else None
                 for _ in range(3)]
        calls = {"H-fwd": (lambda: scan._scan_fwd(a, S, seeds[0]), "selective_scan_fwd"),
                 "H-ckpt": (lambda: scan._scan_ckpt(a, S, seeds[0]), "selective_scan_ckpt")}
        if S > 1:
            calls["carry"] = (lambda: scan.scan_carry(a, S), "selective_scan_carry")
        if mode == "bwd":
            gy, hck = rand(B, L, G * Cg), scan._scan_ckpt(a, S, seeds[0])
            calls["H-bwd"] = (lambda: scan._scan_bwd(a, gy, hck, S, *seeds[1:]),
                              "selective_scan_bwd")
        timed(f"({B * G} rows, {L}, {Cg}) G={G} S={S}", n, calls)
        del a, calls, seeds
    return out


def layer_times(dev) -> dict:
    """Kernels F and F-bwd, bf16, at (16, 16384, D), D = 128 and 64: the
    wrapper and the kernel alone (see the module's docstring)."""
    import torch

    from smow_net_tpu_torch.ops import xattn

    cs = own_chip_smoke()
    gen = torch.Generator(dev).manual_seed(91)
    out = {}
    for D in (128, 64):
        def rand(*shape, scale=1.0, off=0.0):
            return (torch.randn(shape, device=dev, generator=gen) * scale + off).to(torch.bfloat16)

        args = [rand(16, 16384, D), rand(D, scale=0.2, off=1.0), rand(D, scale=0.1),
                rand(D, 8, scale=0.1), rand(16, 8, 8), rand(16, 8, 8), rand(8, D, scale=0.1),
                rand(D, scale=0.1), rand(D, scale=0.2, off=1.0), rand(D, scale=0.1),
                rand(D, 2 * D, scale=D ** -0.5), rand(2 * D, scale=0.1),
                rand(2 * D, D, scale=(2 * D) ** -0.5), rand(D, scale=0.1)]
        gy, scale = rand(16, 16384, D), D ** -0.5
        calls = {f"F D={D}": (lambda: xattn.cross_layer_head1(*args, scale=scale),
                              "xattn_layer_fwd"),
                 f"F-bwd D={D}": (lambda: xattn._kernel_bwd(args, gy, scale, None, 1e-5),
                                  "xattn_layer_bwd")}
        for name, (fn, entry) in calls.items():
            t = cs.cuda_ms(fn, iters=20, warmup=3)
            tk = cs.launch_ms(fn, entry, iters=20)
            print(f"  {name}: wrapper {t:.4f} ms, kernel {tk:.4f} ms", flush=True)
            out[name], out[name + " kernel"] = t, tk
        del args, gy
    return out


def adjcarry_times(dev) -> dict:
    """The adjoint carry and the carry at (64, 65536, 32) on the shipped S,
    bf16: the wrapper and the kernel alone (see the module's docstring)."""
    import torch

    from smow_net_tpu_torch.ops import scan

    cs = own_chip_smoke()
    gen = torch.Generator(dev).manual_seed(92)
    B, L, G, Cg = 32, 65536, 2, 32

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)

    A = -torch.exp(torch.log(torch.arange(1, 17, device=dev, dtype=torch.float32))
                   + 0.1 * torch.randn(G * Cg, 16, device=dev, generator=gen))
    lo, hi = torch.log(torch.tensor([1e-3, 0.1]))
    bias = lo + (hi - lo) * torch.rand(G * Cg, device=dev, generator=gen)
    a = scan._Args(rand(B, L, G * Cg), rand(B, L, G * Cg), A, rand(B, L, G, 16),
                   rand(B, L, G, 16), torch.ones(G * Cg, device=dev), bias, flat=True)
    gy = rand(B, L, G * Cg)
    S = scan.seg_count(a.rows, L, Cg)
    out = {}
    for name, fn, entry in (("adjcarry", lambda: scan.scan_adjcarry(a, gy, S),
                             "selective_scan_adjcarry"),
                            ("carry", lambda: scan.scan_carry(a, S), "selective_scan_carry")):
        t = cs.cuda_ms(fn, iters=5, warmup=1)
        tk = cs.launch_ms(fn, entry, iters=5)
        print(f"  {name} ({a.rows} rows, {L}, {Cg}) S={S}: wrapper {t:.4f} ms, kernel {tk:.4f} "
              "ms", flush=True)
        out[name], out[name + " kernel"] = t, tk
    return out


def scatter_times(dev) -> dict:
    """Kernels D and E, and B beside them, at (32, 128, 128, 8) bf16: the
    wrapper from a CUDA graph and the kernel alone (see the module's
    docstring)."""
    import torch

    from smow_net_tpu_torch.ops import warp

    cs = own_chip_smoke()
    gen = torch.Generator(dev).manual_seed(93)
    F_, H, W, C = 32, 128, 128, 8
    a = (2.0 * torch.randn(F_, H, W, C, device=dev, generator=gen)).to(torch.bfloat16)
    grid = warp.flow_grid(3.0 * torch.randn(F_, H, W, 2, device=dev, generator=gen), H, W)
    m = a.amax(dim=(1, 2)).float()
    ew_bar = torch.randn(F_, H, W, C, device=dev, generator=gen).to(torch.bfloat16)
    dz = torch.randn(F_, C, device=dev, generator=gen)
    out = {}
    for name, fn, kernel in (("D", lambda: warp.token_scatter(a, grid, m), "token_scatter_fwd"),
                             ("E", lambda: warp.token_scatter(a, grid, m, residual=True),
                              "token_scatter_fwd"),
                             ("D-bwd", lambda: warp.token_scatter_bwd(a, grid, m, ew_bar, dz),
                              "token_scatter_bwd"),
                             ("B", lambda: warp.grid_sample_transpose(a, grid, (H, W)),
                              "grid_sample_transpose")):
        t = cs.graph_ms(fn)
        tk = cs.kernel_only_ms(fn, kernel)
        print(f"  {name} ({F_}, {H}, {W}, {C}) bf16: wrapper {t:.4f} ms (CUDA graph), kernel "
              f"{tk:.4f} ms (profiler)", flush=True)
        out[name], out[name + " kernel"] = t, tk
    return out


def attn_times(dev) -> dict:
    """Kernels G and G-bwd, bf16, at (16, 16384, D), D = 128 and 64: the
    wrapper and the kernel alone (see the module's docstring)."""
    import torch

    from smow_net_tpu_torch.ops import xattn

    cs = own_chip_smoke()
    gen = torch.Generator(dev).manual_seed(94)
    out = {}
    for D in (128, 64):
        def rand(*shape, scale=1.0, off=0.0):
            return (torch.randn(shape, device=dev, generator=gen) * scale + off).to(torch.bfloat16)

        args = [rand(16, 16384, D), rand(D, scale=0.2, off=1.0), rand(D, scale=0.1),
                rand(D, 8, scale=0.1), rand(16, 8, 8), rand(16, 8, 8), rand(8, D, scale=0.1),
                rand(D, scale=0.1)]
        gy, scale = rand(16, 16384, D), D ** -0.5
        calls = {f"G D={D}": (lambda: xattn.cross_attn_head1(*args, scale=scale),
                              "cross_attn_fwd"),
                 f"G-bwd D={D}": (lambda: xattn._kernel_bwd(args, gy, scale, None, 1e-5),
                                  "cross_attn_bwd")}
        for name, (fn, entry) in calls.items():
            t = cs.graph_ms(fn)
            tk = cs.launch_ms(fn, entry, iters=20)
            print(f"  {name}: wrapper {t:.4f} ms (CUDA graph), kernel {tk:.4f} ms", flush=True)
            out[name], out[name + " kernel"] = t, tk
        del args, gy
    return out


def _states_entry(scan, B, L, K) -> str:
    """The C entry that launches J at this shape (a parent tree has one)."""
    seg = getattr(scan, "states_seg_count", None)
    return "scan_states_seg" if seg is not None and seg(B, L, K) > 1 else "scan_states"


def states_times(dev) -> dict:
    """Kernel J at (13, 62500, 1024) and (2, 62500, 256), fp32, forward and
    reverse: the wrapper and the kernel alone (see the module's docstring)."""
    import torch

    from smow_net_tpu_torch.ops import scan

    cs = own_chip_smoke()
    gen = torch.Generator(dev).manual_seed(95)
    out = {}
    for B, L, K in ((13, 62500, 1024), (2, 62500, 256)):
        dA = torch.exp(-0.1 * torch.rand(B, L, K, device=dev, generator=gen))
        dBu = torch.randn(B, L, K, device=dev, generator=gen)
        entry = _states_entry(scan, B, L, K)
        bound_ms = 12 * dA.numel() / 3.35e12 * 1e3
        for reverse in (False, True):
            fn = lambda: scan.scan_states(dA, dBu, reverse)
            t = cs.cuda_ms(fn, iters=5, warmup=1)
            tk = cs.launch_ms(fn, entry, iters=5)
            name = f"J ({B}, {L}, {K}) {'reverse' if reverse else 'forward'}"
            print(f"  {name} [{entry}]: wrapper {t:.4f} ms, kernel {tk:.4f} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_ms / tk:.1%} of it)", flush=True)
            out[name], out[name + " kernel"] = t, tk
        del dA, dBu
        torch.cuda.empty_cache()
    return out


def states_strips_times(dev) -> dict:
    """J in chained segments against one segment a strip at L = 62500, 16
    to 416 strips of 32 lanes, forward: the kernel alone."""
    import torch

    from smow_net_tpu_torch.ops import scan

    cs = own_chip_smoke()
    gen = torch.Generator(dev).manual_seed(96)
    out = {}
    L = 62500
    shipped = scan.STATES_MIN_STRIPS
    for strips in (16, 64, 128, 160, 192, 256, 416):
        B, K = strips // 8, 256
        dA = torch.exp(-0.1 * torch.rand(B, L, K, device=dev, generator=gen))
        dBu = torch.randn(B, L, K, device=dev, generator=gen)
        row = []
        try:
            for segmented in (False, True, True, False):
                scan.STATES_MIN_STRIPS = strips + 1 if segmented else 0
                entry = "scan_states_seg" if segmented else "scan_states"
                row.append(cs.launch_ms(lambda: scan.scan_states(dA, dBu), entry, iters=3))
                if segmented:
                    S = scan.states_seg_count(B, L, K)
        finally:
            scan.STATES_MIN_STRIPS = shipped
        bound_ms = 12 * dA.numel() / 3.35e12 * 1e3
        print(f"  J ({B}, {L}, {K}), {strips} strips: S = 1 / {S} / {S} / 1: "
              + " / ".join(f"{t:.4f}" for t in row) + f" ms (bound {bound_ms:.4f}; shipped S "
              f"{scan.states_seg_count(B, L, K)})", flush=True)
        out[f"{strips} strips S=1"] = (row[0] + row[3]) / 2
        out[f"{strips} strips S={S}"] = (row[1] + row[2]) / 2
        del dA, dBu
        torch.cuda.empty_cache()
    return out


def route_times(dev) -> dict:
    """Phase 24's A/B of the general route against H's, bf16 (see the
    module's docstring)."""
    import torch

    from smow_net_tpu_torch.ops import scan

    cs = own_chip_smoke()
    L, G, Cg, N = 62500, 2, 32, 16
    torch.cuda.empty_cache()
    B = max(1, min(16, int(0.5 * torch.cuda.mem_get_info()[0] / (12 * L * G * Cg * N * 4))))
    args = cs._flat_args(dev, B, L, G, Cg, 74, torch.bfloat16)
    gen = torch.Generator(dev).manual_seed(73)
    gy = torch.randn(args[0].shape, device=dev, generator=gen).to(torch.bfloat16)
    ref = [a.detach().requires_grad_() for a in args]
    routes = {"H": lambda *a: scan._FlatScan.apply(*a),
              "J": lambda *a: scan._StatesScan.apply(*a, True)}
    out = {}
    for k, fn in routes.items():
        with torch.no_grad():
            t = cs.cuda_ms(lambda: fn(*args), iters=3, warmup=1)
        tb = cs.cuda_ms(lambda: torch.autograd.grad(fn(*ref), ref, gy), iters=2, warmup=1)
        print(f"  {k}'s route, bf16 ({B}, {L}, {G * Cg}), N {N}: forward {t:.4f} ms, "
              f"forward + backward {tb:.4f} ms", flush=True)
        out[f"{k} fwd"], out[f"{k} fwd+bwd"] = t, tb
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=".", help="checkout whose kernels to build and run")
    parser.add_argument("phases", nargs="+", choices=PHASES)
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs
    from smow_net_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        sys.exit("torch_chip_phases: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _kernels.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"kernels of {args.tree} built and loaded in {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)
    if hasattr(cs, "ptxas_lines"):
        chosen = set(args.phases)
        if {"4", "4b", "layer"} & chosen:
            kernels = ("layer_",)
        elif {"states", "states_strips", "route"} >= chosen:
            kernels = ("scan_states_kernel",)
        elif {"4c", "4d", "attn"} & chosen:
            kernels = ("cross_attn_fwd_tc", "cross_attn_fwd_kernel", "cross_attn_bwd_tc",
                       "cross_attn_bwd_kernel")
        else:
            kernels = ("scan_fwd_kernel", "scan_bwd_kernel", "token_scatter_fwd_kernel",
                       "token_scatter_bwd_kernel")
        for kernel in kernels:
            for line in cs.ptxas_lines(kernel):
                print("  ptxas " + line, flush=True)
    rate = cs.mufu_per_s()
    phases = {"3": cs.phase_kernel_d, "3b": cs.phase_token_backward, "3c": cs.phase_warps,
              "3d": cs.phase_unfused_chain, "3e": cs.phase_token_bwd,
              "3f": cs.phase_warp_modes, "3g": cs.phase_ofw_route,
              "13": lambda d: cs.phase_scan_fwd(d, rate),
              "14": lambda d: cs.phase_scan_bwd(d, rate),
              "19": lambda d: cs.phase_flat_scan(d, rate),
              "20": lambda d: cs.phase_seg_scan(d, rate),
              "27": lambda d: cs.phase_scan_k8(d, rate),
              "28": lambda d: cs.phase_main_path(d, "rs_mamba", 28, rounds=1, per_round=3),
              "29": lambda d: cs.phase_fp32_model(d, "rs_mamba", 29),
              "30": lambda d: cs.phase_train(d, "rs_mamba", 30, rounds=2, per_round=2,
                                             plain=False),
              "31": lambda d: cs.phase_fp32_train_grads(d, "rs_mamba", 31),
              "32": cs.phase_layer_family,
              "4": lambda d: {D: cs.phase_kernel_f(d, D) for D in (128, 64)},
              "4b": lambda d: {D: cs.phase_kernel_f_bwd(d, D) for D in (128, 64)},
              "4c": lambda d: cs.phase_kernel_g(d)[0], "4d": lambda d: cs.phase_kernel_g_bwd(d)[0],
              "fwd": lambda d: sweep_times(d, "fwd"), "bwd": lambda d: sweep_times(d, "bwd"),
              "layer": layer_times, "adjcarry": adjcarry_times, "scatter": scatter_times,
              "attn": attn_times, "states": states_times, "states_strips": states_strips_times,
              "route": route_times}
    for name in args.phases:
        result = phases[name](dev)
        if isinstance(result, dict):
            print(f"phase {name} numbers: {json.dumps(result)}", flush=True)


if __name__ == "__main__":
    main()
