"""Change-detection metrics from a 2x2 confusion matrix (port of
smow_net_tpu/train/metrics.py; reference utils/metric_tool.py:93-155).

The per-step matrix is computed on the device; the host reads it once for
scoring. Layout cm[gt, pred]: cm[0,0]=TN, cm[0,1]=FP, cm[1,0]=FN, cm[1,1]=TP.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["confusion_matrix", "cm2score", "cm2F1", "ConfuseMatrixMeter"]

_EPS = float(np.finfo(np.float32).eps)


def confusion_matrix(pred: torch.Tensor, gt: torch.Tensor, threshold: float = 0.5,
                     valid=None) -> torch.Tensor:
    """pred: probabilities, gt: {0,1} labels (same shape). Returns (2, 2)
    fp32. `valid`: optional (B,) per-sample weights."""
    p = (pred > threshold).float()
    g = (gt > 0.5).float()
    if valid is None:
        w = torch.ones_like(p)
    else:
        w = valid.reshape(valid.shape[0], *([1] * (pred.dim() - 1))).float().expand_as(p)
    tp = (w * g * p).sum()
    fn = (w * g * (1.0 - p)).sum()
    fp = (w * (1.0 - g) * p).sum()
    tn = (w * (1.0 - g) * (1.0 - p)).sum()
    return torch.stack([torch.stack([tn, fp]), torch.stack([fn, tp])])


def cm2score(cm) -> Dict[str, float]:
    """acc, change-class IoU = tp / (total - tn), F1, precision, recall."""
    if isinstance(cm, torch.Tensor):
        cm = cm.detach().cpu().numpy()
    hist = np.asarray(cm, dtype=np.float64)
    tn, fp = hist[0]
    fn, tp = hist[1]
    total = hist.sum()
    acc = (tp + tn) / (total + _EPS)
    recall = tp / (tp + fn + _EPS)
    precision = tp / (tp + fp + _EPS)
    f1 = 2 * recall * precision / (recall + precision + _EPS)
    iou = tp / (total - tn + _EPS)
    return {"acc": float(acc), "iou": float(iou), "F1": float(f1),
            "precision": float(precision), "recall": float(recall)}


def cm2F1(cm) -> float:
    return cm2score(cm)["F1"]


class ConfuseMatrixMeter:
    """Host-side accumulator of confusion matrices (the reference meter's
    API): `update_cm` adds one and returns its F1, `get_scores` scores the
    sum."""

    def __init__(self, n_class: int = 2):
        if n_class != 2:
            raise ValueError(f"ConfuseMatrixMeter scores 2 classes, not {n_class}")
        self.sum = np.zeros((2, 2), dtype=np.float64)

    def update_cm(self, cm) -> float:
        if isinstance(cm, torch.Tensor):
            cm = cm.detach().cpu().numpy()
        cm = np.asarray(cm, dtype=np.float64)
        self.sum += cm
        return cm2F1(cm)

    def get_scores(self) -> Dict[str, float]:
        return cm2score(self.sum)

    def clear(self) -> None:
        self.sum = np.zeros((2, 2), dtype=np.float64)
