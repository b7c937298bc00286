#!/usr/bin/env python
"""Training CLI of the PyTorch port (port of the repository's train.py).

    python -m smow_net_tpu_torch.cli.train --model smow_net \\
        --data_dir /data/LEVIR-CD-256 --batchsize 16 --epochs 200 --bf16 \\
        --output_dir ./output

The same flags and printed lines as train.py, plus `--device` (default
cuda: the hand-written kernels; `--device cpu` runs their plain versions).
It writes `train.txt`, `val.txt` and `metrics.jsonl` into --output_dir, the
best validation IoU's parameters to `best` (a state_dict) and the
resumable state to `last` (`--resume <dir>/last` goes on at the next
epoch). Validation runs the eval step in the master parameters' dtype,
fp32. The loss window stays on the device and is read only when printed:
the loop adds no host sync per step.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time

import numpy as np
import torch


def parse_option(argv=None):
    p = argparse.ArgumentParser("smow_net_tpu_torch training")
    p.add_argument("--model", type=str, default="smow_net")
    p.add_argument("--batchsize", type=int, default=16)
    p.add_argument("--trainsize", type=int, default=256,
                   help="accepted for train.py's command line; a torch model needs no "
                        "sample batch to build")
    p.add_argument("--data_dir", type=str, default="./LEVIR-CD-256")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--optim", type=str, default="adamw", choices=["adamw", "sgd"])
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_scheduler", type=str, default="cosine", choices=["cosine", "step"])
    p.add_argument("--warmup_epoch", type=int, default=-1)
    p.add_argument("--warmup_multiplier", type=float, default=100.0)
    p.add_argument("--lr_decay_epochs", type=int, nargs="*", default=[])
    p.add_argument("--lr_decay_steps", type=int, default=20)
    p.add_argument("--lr_decay_rate", type=float, default=0.1)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--clip", type=float, default=0.5)
    p.add_argument("--output_dir", type=str, default="./output")
    p.add_argument("--seed", type=int, default=2022)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--pretrained", type=str, default="",
                   help="pretrained backbone state_dict (.pth/.npz): ImageNet resnet18 for "
                        "smow_net, mobilenet_v2 for smow_net_lw")
    p.add_argument("--torch_ckpt", type=str, default="",
                   help="warm-start from a reference-trained PyTorch state_dict (.pth), "
                        "DataParallel 'module.' prefix stripped")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision: bf16 forward/backward, fp32 master params")
    p.add_argument("--fsdp", action="store_true", help="not ported yet (raises)")
    p.add_argument("--remat", action="store_true",
                   help="activation recomputation for the Mamba models (change_mamba, "
                        "rs_mamba): each SS2D runs under torch.utils.checkpoint")
    p.add_argument("--profile", type=str, default="",
                   help="write a torch.profiler trace of training steps 11-15 of the first "
                        "epoch (1 to min(6, steps) on shorter epochs) to this directory")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu")
    return p.parse_args(argv)


def device_of(opt) -> torch.device:
    """--device, refusing cuda when there is no CUDA device."""
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    return device


@dataclasses.dataclass
class Run:
    """What `setup` builds and `fit` runs."""

    device: torch.device
    model: torch.nn.Module
    state: object
    train_step: object
    eval_step: object
    train_loader: object
    val_loader: object
    start_epoch: int
    best_iou: float


def setup(opt) -> Run:
    """Model, data, optimizer and train state; restores --resume."""
    from ..data.dataset import CDDataset, DataLoader
    from ..models import get_model
    from ..train import checkpoint as ckpt
    from ..train.schedule import get_schedule
    from ..train.trainer import (create_train_state, make_eval_step, make_optimizer,
                                 make_train_step)

    if opt.fsdp:
        raise NotImplementedError("--fsdp: sharded training is not ported yet "
                                  "(ROADMAP.md queue 1 item 5, parallel)")
    overrides = {}
    if opt.remat:
        if opt.model not in ("change_mamba", "rs_mamba"):
            raise SystemExit(f"--remat supports change_mamba/rs_mamba, not {opt.model}")
        overrides["use_checkpoint"] = True
    device = device_of(opt)
    os.makedirs(opt.output_dir, exist_ok=True)
    np.random.seed(opt.seed)
    torch.manual_seed(opt.seed)
    model = get_model(opt.model, device=device, **overrides)

    train_ds = CDDataset(opt.data_dir, "train", seed=opt.seed)
    val_ds = CDDataset(opt.data_dir, "val", seed=opt.seed)
    train_loader = DataLoader(train_ds, opt.batchsize, shuffle=True, seed=opt.seed,
                              num_workers=opt.num_workers)
    val_loader = DataLoader(val_ds, opt.batchsize, shuffle=False, seed=opt.seed,
                            num_workers=opt.num_workers)
    schedule = get_schedule(
        opt.lr_scheduler, opt.lr, opt.epochs, len(train_loader),
        warmup_epochs=opt.warmup_epoch, warmup_multiplier=opt.warmup_multiplier,
        lr_decay_epochs=opt.lr_decay_epochs, lr_decay_steps=opt.lr_decay_steps,
        lr_decay_rate=opt.lr_decay_rate,
    )
    optimizer = make_optimizer(schedule, opt.weight_decay, opt.clip, opt.optim,
                               opt.momentum)(model.parameters())
    state = create_train_state(model, optimizer, seed=opt.seed)
    if opt.pretrained:
        from ..train.pretrained import load_pretrained_backbone

        load_pretrained_backbone(opt.model, opt.pretrained, model)
        print(f"loaded pretrained backbone from {opt.pretrained}")
    if opt.torch_ckpt:
        from ..train.ingest import ingest_torch_checkpoint

        ingest_torch_checkpoint(opt.model, opt.torch_ckpt, model)
        print(f"warm-started from torch checkpoint {opt.torch_ckpt}")

    start_epoch, best_iou = 1, -1.0
    if opt.resume:
        extra = ckpt.restore_checkpoint(opt.resume, state)
        start_epoch = int(extra["epoch"]) + 1
        best_iou = float(extra.get("best_iou", -1.0))
        print(f"resumed from {opt.resume} at epoch {start_epoch}")

    compute_dtype = torch.bfloat16 if opt.bf16 else None
    return Run(device=device, model=model, state=state,
               train_step=make_train_step(model, optimizer, compute_dtype),
               eval_step=make_eval_step(model), train_loader=train_loader,
               val_loader=val_loader, start_epoch=start_epoch, best_iou=best_iou)


def _profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _write_trace(prof, device: torch.device, directory: str) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    prof.export_chrome_trace(os.path.join(directory, "trace.json"))
    print(f"profiler trace written to {directory}")


def fit(opt, run: Run) -> None:
    """Train from `run.start_epoch` to --epochs, validating every epoch."""
    from ..data.dataset import prefetch_to_device
    from ..train import checkpoint as ckpt
    from ..train.metrics import cm2score

    state, device = run.state, run.device
    iters_per_epoch = len(run.train_loader)
    # the profiled window: steps 11-15 after warm-up, or from step 1 on short epochs
    first, stop = (11, 16) if iters_per_epoch >= 16 else (1, min(6, iters_per_epoch))
    with open(os.path.join(opt.output_dir, "metrics.jsonl"), "a") as jsonl:
        for epoch in range(run.start_epoch, opt.epochs + 1):
            t0 = time.time()
            state.reset_metrics()
            # windowed loss meter (reference AvgMeter(num=40), utils/func.py:11-31)
            window = collections.deque(maxlen=40)
            prof = None
            batches = prefetch_to_device(iter(run.train_loader), device)
            for i, batch in enumerate(batches, start=1):
                if opt.profile and epoch == run.start_epoch:
                    if i == first:
                        prof = _profiler(device)
                    elif prof is not None and i == stop:
                        _write_trace(prof, device, opt.profile)
                        prof = None
                window.append(run.train_step(state, batch))
                if i % 100 == 0 or i == iters_per_epoch:
                    avg = float(torch.stack(list(window)).double().mean())
                    print(f"Epoch [{epoch:03d}/{opt.epochs:03d}], Step [{i:04d}/"
                          f"{iters_per_epoch:04d}], Loss: {avg:.4f}")
            if prof is not None:          # the epoch ended before the stop step
                _write_trace(prof, device, opt.profile)
            train_scores = cm2score(state.cm)
            train_loss = float(state.loss_sum / state.loss_count.clamp(min=1))
            print(f"Epoch {epoch} train: {train_scores} loss={train_loss:.4f} "
                  f"({time.time() - t0:.1f}s)")
            with open(os.path.join(opt.output_dir, "train.txt"), "a") as f:
                f.write(f"Epoch: {epoch}, IoU: {train_scores['iou']:.4f}\n")

            cm = torch.zeros(2, 2, dtype=torch.float64, device=device)
            vloss = torch.zeros((), dtype=torch.float64, device=device)
            vcount = 0
            for batch in prefetch_to_device(iter(run.val_loader), device):
                c, loss, _ = run.eval_step(batch)
                cm += c
                vloss += loss
                vcount += 1
            val_scores = cm2score(cm)
            print(f"Epoch {epoch} val:   {val_scores} loss={float(vloss) / max(vcount, 1):.4f}")
            with open(os.path.join(opt.output_dir, "val.txt"), "a") as f:
                f.write(f"Epoch: {epoch}, IoU: {val_scores['iou']:.4f}\n")
            jsonl.write(json.dumps({"epoch": epoch, "train": train_scores, "val": val_scores,
                                    "train_loss": train_loss,
                                    "time": time.time() - t0}) + "\n")
            jsonl.flush()

            if val_scores["iou"] > run.best_iou:
                run.best_iou = val_scores["iou"]
                ckpt.save_best_params(os.path.join(opt.output_dir, "best"), run.model)
                print(f"new best IoU {run.best_iou:.4f} -> saved best checkpoint")
            ckpt.save_checkpoint(os.path.join(opt.output_dir, "last"), state, epoch=epoch,
                                 best_iou=run.best_iou)


def main(opt) -> Run:
    run = setup(opt)
    fit(opt, run)
    return run


if __name__ == "__main__":
    main(parse_option())
