"""Paired change-detection dataset and host loader (port of
smow_net_tpu/data/dataset.py).

Directory layout (reference utils/dataset.py:13-36): `A/`, `B/`, `label/`
and `list/{train,val,test}.txt` with one file name per line. PNGs are read
by `data/png.py` (float32 [0, 1], matplotlib's values); masks are binarized
as `clip(m*255, 0, 1)` (utils/dataset.py:98-99). Train samples go through
the host engine (`runtime/native.py`), drawn from a per-sample generator
seeded with (seed, epoch, index).

The loader decodes and augments on a thread pool (zlib, the engine and
numpy release the GIL) and keeps the next batch's samples in flight while
the caller works on the current one; `prefetch_to_device` copies batches
from pinned memory onto the card ahead of the step.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from os.path import join
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..runtime import native
from . import png
from .transforms import imagenet_normalize, sample_params

__all__ = ["CDDataset", "DataLoader", "prefetch_to_device", "generate_synthetic_dataset"]


def _binarize(mask: np.ndarray) -> np.ndarray:
    if mask.ndim == 3:
        mask = mask[..., 0]
    return np.clip(mask * 255.0, 0.0, 1.0).astype(np.float32)


class CDDataset:
    """Index-addressable paired dataset with reference-matching augmentation."""

    def __init__(self, data_path: str, mode: str, seed: int = 2022, augment: Optional[bool] = None):
        self.mode = mode
        self._a = join(data_path, "A")
        self._b = join(data_path, "B")
        self._label = join(data_path, "label")
        with open(join(data_path, "list", mode + ".txt")) as f:
            self.names = [ln.strip() for ln in f if ln.strip()]
        self.augment = (mode == "train") if augment is None else augment
        self._seed = seed

    def __len__(self) -> int:
        return len(self.names)

    def get(self, idx: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        name = self.names[idx]
        a = png.read_png(join(self._a, name))[..., :3]
        b = png.read_png(join(self._b, name))[..., :3]
        m = _binarize(png.read_png(join(self._label, name)))
        if not self.augment:
            return {"A": imagenet_normalize(a), "B": imagenet_normalize(b), "mask": m}
        p = sample_params(np.random.default_rng((self._seed, epoch, idx)))
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        native.augment_sample(a, b, m, p["flip_d"], p["angle"],
                              p["a"]["cb"], p["a"]["alpha"], p["a"]["beta"], p["a"]["blur"],
                              p["b"]["cb"], p["b"]["alpha"], p["b"]["beta"], p["b"]["blur"],
                              normalize=True)
        return {"A": a, "B": b, "mask": m}


class DataLoader:
    """Shuffling, batching, threaded decode. Yields numpy dict batches with a
    'valid' (B,) mask; with `pad_last` the final short batch is zero-padded
    to full size (metrics weight by 'valid')."""

    def __init__(self, dataset: CDDataset, batch_size: int, shuffle: bool, seed: int = 2022,
                 num_workers: int = 8, drop_last: bool = False, pad_last: bool = True,
                 num_shards: int = 1, shard_id: int = 0):
        """num_shards/shard_id: each of `num_shards` processes reads a
        disjoint strided slice of the (identically seeded) shuffled order,
        truncated to equal length so all run the same number of steps.
        batch_size is the per-process batch size."""
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
        self.epoch = 0

    def _shard_len(self) -> int:
        n = len(self.ds)
        return n // self.num_shards if self.num_shards > 1 else n

    def __len__(self) -> int:
        n = self._shard_len()
        return n // self.bs if self.drop_last else (n + self.bs - 1) // self.bs

    def _assemble(self, futures) -> Dict[str, np.ndarray]:
        items = [f.result() for f in futures]
        valid = np.zeros((self.bs,), np.float32)
        valid[: len(items)] = 1.0
        while self.pad_last and len(items) < self.bs:
            items.append({k: np.zeros_like(v) for k, v in items[0].items()})
        batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        batch["valid"] = valid[: len(items)] if not self.pad_last else valid
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        if self.num_shards > 1:
            order = order[self.shard_id :: self.num_shards][: self._shard_len()]
        epoch = self.epoch
        self.epoch += 1
        starts = [s for s in range(0, len(order), self.bs)
                  if not (self.drop_last and len(order) - s < self.bs)]

        def submit(start):
            return [self.pool.submit(self.ds.get, int(i), epoch)
                    for i in order[start : start + self.bs]]

        pending = submit(starts[0]) if starts else None
        for k in range(len(starts)):
            current = pending
            # the next batch's samples decode while the caller runs this one
            pending = submit(starts[k + 1]) if k + 1 < len(starts) else None
            yield self._assemble(current)


def prefetch_to_device(iterator, device, size: int = 2):
    """Batches of numpy arrays as tensors on `device`, `size` batches ahead:
    on a CUDA device each array is copied into pinned host memory and then
    onto the card without blocking, so the copies overlap the step."""
    device = torch.device(device)
    cuda = device.type == "cuda"

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory().to(device, non_blocking=True) if cuda else t
        return out

    queue = collections.deque()
    for batch in iterator:
        queue.append(put(batch))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def generate_synthetic_dataset(root: str, n_train: int = 8, n_val: int = 4, size: int = 64,
                               seed: int = 0) -> str:
    """Tiny synthetic LEVIR-like dataset (PNG pairs + binary masks) for smoke
    tests and benchmarks; the JAX package's draws, pixels and file names."""
    rng = np.random.default_rng(seed)
    for sub in ("A", "B", "label", "list"):
        os.makedirs(join(root, sub), exist_ok=True)
    splits = {"train": n_train, "val": n_val, "test": n_val}
    counter = 0
    for split, count in splits.items():
        names = []
        for _ in range(count):
            name = f"img_{counter:04d}.png"
            counter += 1
            base = rng.uniform(0.2, 0.8, size=(size, size, 3)).astype(np.float32)
            a = np.clip(base + rng.normal(0, 0.05, base.shape), 0, 1)
            b = a.copy()
            mask = np.zeros((size, size), np.float32)
            # paint a random "changed" rectangle into B
            x0, y0 = rng.integers(0, size // 2, 2)
            w, h = rng.integers(size // 8, size // 2, 2)
            b[y0 : y0 + h, x0 : x0 + w] = rng.uniform(0, 1, 3)
            mask[y0 : y0 + h, x0 : x0 + w] = 1.0
            png.write_png(join(root, "A", name), (a * 255).astype(np.uint8))
            png.write_png(join(root, "B", name), (np.clip(b, 0, 1) * 255).astype(np.uint8))
            png.write_png(join(root, "label", name), (mask * 255).astype(np.uint8))
            names.append(name)
        with open(join(root, "list", split + ".txt"), "w") as f:
            f.write("\n".join(names) + "\n")
    return root
