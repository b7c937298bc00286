#!/usr/bin/env python
"""Time one model's bf16 eval step, or its train step, from a given checkout
of the PyTorch port, on one NVIDIA GPU, for A/B runs between two commits.

    python tools/torch_eval_step_ab.py --tree PATH [--model smow_net] [--rounds 6]
    python tools/torch_eval_step_ab.py --tree PATH --step train --model change_mamba
    python tools/torch_eval_step_ab.py --tree PATH --step train --chain fused

Imports `smow_net_tpu_torch` and `chip_smoke` from PATH (the root of a
checkout, e.g. a `git archive` of the parent commit unpacked into a
directory that .gitignore lists), builds the model on the card with
`chip_smoke.seeded_state_dict`'s numpy-seeded weights and runs, on 16 pairs
at 256 x 256, either `make_eval_step` in bf16 on 3 batches or, with `--step
train`, chip_smoke.py's train step (`_train_setup`: bf16 compute over fp32
masters, clip + AdamW) on one repeated batch (`--chain` sets SMOW_Net's
token-chain train lowering, `model.token_train_chain`: "fused" runs kernels
D and D-bwd): one warm-up call, then
`rounds` rounds of 5 calls, each timed with CUDA events; then 3 calls under
torch.profiler, whose device events give the device's busy time per call
and the kernels it launches per call. Prints one JSON line: the tree, the
card's name and power limit, the median and quartiles of ms per call, and
the busy ms and share (busy over the median: the rest of the step the card
waits). Run it in separate processes for parent, change, change, parent
within one call, and compare the medians there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="root of the checkout to time")
    ap.add_argument("--model", default="smow_net")
    ap.add_argument("--step", choices=("eval", "train"), default="eval")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--chain", choices=("hybrid", "fused", "unfused"), default=None,
                    help="SMOW_Net's token-chain train lowering (default: the model's own)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_eval_step_ab: no CUDA device")
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from smow_net_tpu_torch.models import get_model
    from smow_net_tpu_torch.ops import _kernels
    from smow_net_tpu_torch.train.trainer import make_eval_step

    if os.path.dirname(os.path.abspath(chip_smoke.__file__)) != tree:
        sys.exit(f"torch_eval_step_ab: imported {chip_smoke.__file__}, not from {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    _kernels.library()
    if args.step == "train":
        model, state, step = chip_smoke._train_setup(args.model, torch.bfloat16, 100)
        if args.chain:
            model.token_train_chain = args.chain
        batch = chip_smoke.make_batches(dev, 1, 16, 256, seed=8)[0]
        run = lambda i: step(state, batch)
    else:
        model = get_model(args.model)
        model.load_state_dict(chip_smoke.seeded_state_dict(model, 0))
        step = make_eval_step(model.to(torch.bfloat16))
        batches = chip_smoke.make_batches(dev, 3, 16, 256, seed=7)
        run = lambda i: step(batches[i % len(batches)])
    run(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(args.rounds):
        for i in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(i)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    q1, median, q3 = np.percentile(times, [25, 50, 75])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(3):
            run(i)
        torch.cuda.synchronize()
    on_device = chip_smoke.device_events(prof.key_averages())
    busy = sum(e.self_device_time_total for e in on_device) / 1e3 / 3
    print(json.dumps({"tree": args.tree, "model": args.model, "step": args.step,
                      "chain": args.chain, "card": card,
                      "ms_per_call": {"median": median, "q1": q1, "q3": q3, "calls": len(times)},
                      "busy_ms": busy, "busy_share": busy / median,
                      "kernels_per_call": sum(e.count for e in on_device) / 3}))


if __name__ == "__main__":
    main()
