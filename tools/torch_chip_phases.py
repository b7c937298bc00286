"""Run some of chip_smoke.py's kernel phases alone, on one NVIDIA GPU.

    python tools/torch_chip_phases.py 3b 3c          # from a checkout's root
    python tools/torch_chip_phases.py --tree PATH 3b # the checkout at PATH

Builds the kernels of the checkout it runs from (or of --tree), sets the
fp32 comparisons' flags as chip_smoke.py does (TF32 off) and runs the named
phases: 3 (D), 3b (E, C, A-bwd), 3c (A-fwd, B), 3d (the unfused chain), 3e
(D-bwd), 3f (the warp modes), 3g (the OFW route). Each phase holds its
kernels against their plain versions and logs their times, as in the whole
script; a phase that returns the JSON line's numbers prints them. For an
A/B of two trees on one card, call it once per tree in turns (parent,
change, change, parent).
"""

import argparse
import os
import sys
import time


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=".", help="checkout whose kernels to build and run")
    parser.add_argument("phases", nargs="+", choices=["3", "3b", "3c", "3d", "3e", "3f", "3g"])
    args = parser.parse_args()
    os.chdir(args.tree)
    sys.path.insert(0, os.getcwd())
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
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"({torch.cuda.get_device_name(0)})", flush=True)
    phases = {"3": cs.phase_kernel_d, "3b": cs.phase_token_backward, "3c": cs.phase_warps,
              "3d": cs.phase_unfused_chain, "3e": cs.phase_token_bwd,
              "3f": cs.phase_warp_modes, "3g": cs.phase_ofw_route}
    for name in args.phases:
        result = phases[name](dev)
        if isinstance(result, dict):
            print(f"phase {name} numbers: {result}", flush=True)


if __name__ == "__main__":
    main()
