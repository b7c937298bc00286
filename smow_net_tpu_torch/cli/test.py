#!/usr/bin/env python
"""Evaluation CLI of the PyTorch port (port of the repository's test.py).

    python -m smow_net_tpu_torch.cli.test --model smow_net \\
        --data_dir /data/LEVIR-CD-256 --checkpoint ./output/best --output_dir ./vis

Loads a `best` checkpoint written by `cli.train` (or a reference-trained
state_dict with --torch_ckpt), runs the eval step over the test split,
writes one TP (white) / TN (black) / FP (red) / FN (green) PNG per image
(reference test.py:142-150) and prints the mean loss and the scores.
`--device` defaults to cuda; `--device cpu` runs the plain ops.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .train import device_of


def parse_option(argv=None):
    p = argparse.ArgumentParser("smow_net_tpu_torch evaluation")
    p.add_argument("--model", type=str, default="smow_net")
    p.add_argument("--data_dir", type=str, default="./LEVIR-CD-256")
    p.add_argument("--checkpoint", type=str, default="",
                   help="the `best` file written by smow_net_tpu_torch.cli.train")
    p.add_argument("--torch_ckpt", type=str, default="",
                   help="reference-trained PyTorch state_dict (.pth); the DataParallel "
                        "'module.' prefix is stripped (reference test.py:97-102)")
    p.add_argument("--trainsize", type=int, default=256,
                   help="accepted for test.py's command line; not needed to build a model")
    p.add_argument("--output_dir", type=str, default="./test_output")
    p.add_argument("--batchsize", type=int, default=1)
    p.add_argument("--save_vis", action="store_true", default=True)
    p.add_argument("--no_save_vis", dest="save_vis", action="store_false")
    p.add_argument("--device", type=str, default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def colorize(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """TP white, TN black, FP red, FN green, in BGR order (test.py's, for
    cv2); `main` reverses the channels to write RGB."""
    h, w = pred.shape
    vis = np.zeros((h, w, 3), np.uint8)
    tp = (pred == 1) & (gt == 1)
    fp = (pred == 1) & (gt == 0)
    fn = (pred == 0) & (gt == 1)
    vis[tp] = (255, 255, 255)
    vis[fp] = (0, 0, 255)
    vis[fn] = (0, 255, 0)
    return vis


def main(opt):
    """Returns the scores and the summed (2, 2) confusion matrix cm[gt, pred]."""
    from ..data import png
    from ..data.dataset import CDDataset, DataLoader, prefetch_to_device
    from ..models import get_model
    from ..train.checkpoint import restore_best_params
    from ..train.metrics import cm2score
    from ..train.trainer import make_eval_step

    device = device_of(opt)
    if not (opt.checkpoint or opt.torch_ckpt):
        raise SystemExit("one of --checkpoint / --torch_ckpt is required")
    os.makedirs(opt.output_dir, exist_ok=True)
    model = get_model(opt.model, device=device)
    if opt.torch_ckpt:
        from ..train.ingest import ingest_torch_checkpoint

        ingest_torch_checkpoint(opt.model, opt.torch_ckpt, model)
    else:
        restore_best_params(opt.checkpoint, model)
    ds = CDDataset(opt.data_dir, "test")
    loader = DataLoader(ds, opt.batchsize, shuffle=False, num_workers=8)
    eval_step = make_eval_step(model)

    cm = torch.zeros(2, 2, dtype=torch.float64, device=device)
    total_loss, count, img_idx = 0.0, 0, 0
    for batch in prefetch_to_device(iter(loader), device):
        c, loss, pred = eval_step(batch)
        cm += c
        total_loss += float(loss)
        count += 1
        if opt.save_vis:
            pred_np = (pred > 0.5).cpu().numpy().astype(np.uint8)
            gt_np = (batch["mask"] > 0.5).cpu().numpy().astype(np.uint8)
            valid = batch["valid"].cpu().numpy()
            for b in range(pred_np.shape[0]):
                if valid[b] < 0.5:
                    continue
                name = ds.names[img_idx] if img_idx < len(ds.names) else f"{img_idx}.png"
                png.write_png(os.path.join(opt.output_dir, name),
                              colorize(pred_np[b], gt_np[b])[..., ::-1])
                img_idx += 1

    print(f"mean loss: {total_loss / max(count, 1):.4f}")
    scores = cm2score(cm)
    for k, v in scores.items():
        print(f"{k}: {v:.4f}")
    return scores, cm.cpu().numpy()


if __name__ == "__main__":
    main(parse_option())
