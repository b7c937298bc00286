#!/usr/bin/env python
"""Kernels G and G-bwd on a logit spread, against a float64 plain version, on
one NVIDIA GPU.

    python tools/torch_attn_spread_f64.py [--widths 64,128,256,384,512]

At (2, 4096, D), with the inputs of tests/test_torch_kernels_cuda.py's
`_attn_inputs` (numpy seed D + 15) and head 0's keys scaled by 1e4 (its
logits ~1e3 above the other heads'), runs `xattn.cross_attn_head1` (kernel
G) and its gradients (kernel G-bwd) in fp32 and in bf16, and
`cross_attn_head1_plain` and its autograd gradients in fp32, and the same
arithmetic in float64 (chip_smoke.py's `attn_f64`: the plain version's own
LayerNorm, `layer_norm32`, computes in fp32 whatever its input's dtype,
which puts an error of its own into a reference taken from it on this
case), on the same values. Prints, per dtype and width, the output's error and each
of the eight gradients' errors in units of the card's bound (fp32: 1e-4,
bf16: 2^-8 of the leaf's largest element in float64) as
kernel-f64 / plain32-f64 / kernel-plain32: how far the kernel and the fp32
plain version each lie from the float64 result, and from each other (what
the card tests compare). The last line gives the worst leaf per dtype and
width, kernel against float64.
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import attn_f64  # noqa: E402
from smow_net_tpu_torch.ops import xattn  # noqa: E402

NAMES = ("y", "x", "ln_s", "ln_b", "wq", "k", "v", "wo", "bo")


def inputs(dev, D, B=2, N=4096, h=8, M=8):
    """The sublayer's 8 inputs and a cotangent as the card tests make them,
    head 0's keys scaled by 1e4."""
    rng = np.random.default_rng(D + 15)

    def f(*s, scale=1.0, off=0.0):
        return torch.from_numpy((rng.normal(size=s) * scale + off).astype(np.float32)).to(dev)

    args = [f(B, N, D), f(D, scale=0.2, off=1.0), f(D, scale=0.1), f(D, h, scale=0.1),
            f(B, M, h), f(B, M, h), f(h, D, scale=0.1), f(D, scale=0.1)]
    gy = f(B, N, D)
    args[4][..., 0] *= 1e4
    return args, gy


def outputs(fn, args, gy):
    """(output, its eight input gradients) of `fn` at `args`."""
    out = fn(*args, scale=args[0].shape[-1] ** -0.5)
    return (out.detach(),) + torch.autograd.grad(out, args, gy)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--widths", default="64,128,256,384,512")
    widths = [int(w) for w in parser.parse_args().widths.split(",")]
    if not torch.cuda.is_available():
        sys.exit("torch_attn_spread_f64: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    worst = {}
    for D in widths:
        args, gy = inputs(dev, D)
        for dt in (torch.float32, torch.bfloat16):
            a = [t.to(dt).requires_grad_() for t in args]
            got = outputs(xattn.cross_attn_head1, a, gy.to(dt))

            def plain(fn, dtype):
                r = [t.detach().to(dtype).requires_grad_() for t in a]
                return outputs(fn, r, gy.to(dt).to(dtype))

            p32 = plain(xattn.cross_attn_head1_plain, torch.float32)
            p64 = plain(attn_f64, torch.float64)
            rel = 1e-4 if dt == torch.float32 else 2.0 ** -8
            cells, errs = [], []
            for name, k, w, v in zip(NAMES, got, p32, p64):
                bound = rel * v.abs().max().item()
                err = lambda u, t: (u.double() - t.double()).abs().max().item() / bound
                errs.append((err(k, v), name))
                cells.append(f"{name} {err(k, v):.2f}/{err(w, v):.2f}/{err(k, w):.2f}")
            worst[f"D={D} {str(dt)[6:]}"] = max(errs)
            print(f"D={D} {str(dt)[6:]} kernel-f64/plain32-f64/kernel-plain32: "
                  + "  ".join(cells), flush=True)
    print("worst leaf, kernel-f64 in units of the bound: "
          + "  ".join(f"{k} {v:.2f} ({n})" for k, (v, n) in worst.items()), flush=True)


if __name__ == "__main__":
    main()
