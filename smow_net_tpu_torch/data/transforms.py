"""Paired augmentations in numpy (port of smow_net_tpu/data/transforms.py,
without cv2): the plain version of the host engine in `runtime/augment.cpp`,
with its arithmetic. The dataset runs the engine; tests hold the two
against each other and against the JAX package's cv2 transforms.

Reference pipeline (albumentations, utils/dataset.py:86-95):
  shared (same params for A, B, mask):  Flip(p=.5, d in {-1,0,1}),
                                        Rotate(limit=5, p=.5, reflect-101,
                                        bilinear for images / nearest for mask)
  per-image "aberration":               RandomBrightnessContrast(±0.2, p=.5,
                                        brightness_by_max), GaussianBlur(k in
                                        {3,5}, p=.5)
on float32 [0, 1] HWC arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = ["aberration", "imagenet_normalize", "sample_params", "apply_params",
           "IMAGENET_MEAN", "IMAGENET_STD"]

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)

# cv2.getGaussianKernel(k, 0) for the small kernels: fixed tables
_GAUSS = {3: np.array([0.25, 0.5, 0.25]),
          5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625])}


def _reflect101(i: np.ndarray, n: int) -> np.ndarray:
    """... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ..."""
    if n == 1:
        return np.zeros_like(i)
    i = np.abs(i) % (2 * n - 2)
    return np.where(i >= n, 2 * n - 2 - i, i)


def _flip(img: np.ndarray, d: int) -> np.ndarray:
    # cv2 flip codes: 0 vertical, 1 horizontal, -1 both
    if d == 0:
        return img[::-1]
    if d == 1:
        return img[:, ::-1]
    return img[::-1, ::-1]


def _rotate(img: np.ndarray, angle: float, nearest: bool) -> np.ndarray:
    """Rotate by `angle` degrees about cv2's center (w/2 - 0.5, h/2 - 0.5):
    dst(x, y) = src(R(-angle) (x, y)), source coordinates in float64,
    bilinear weights in float32, reflect-101 border."""
    h, w = img.shape[:2]
    img = img.astype(np.float32)
    a = float(np.float32(angle)) * np.pi / 180.0     # the engine takes a float angle
    ca, sa = np.cos(a), np.sin(a)
    cx, cy = w / 2.0 - 0.5, h / 2.0 - 0.5
    dy, dx = np.meshgrid(np.arange(h) - cy, np.arange(w) - cx, indexing="ij")
    sx = ca * dx - sa * dy + cx
    sy = sa * dx + ca * dy + cy
    if nearest:
        ix = _reflect101(np.floor(sx + 0.5).astype(np.int64), w)
        iy = _reflect101(np.floor(sy + 0.5).astype(np.int64), h)
        return img[iy, ix]
    x0, y0 = np.floor(sx), np.floor(sy)
    tx, ty = (sx - x0).astype(np.float32), (sy - y0).astype(np.float32)
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    x0r, x1r = _reflect101(x0, w), _reflect101(x0 + 1, w)
    y0r, y1r = _reflect101(y0, h), _reflect101(y0 + 1, h)
    if img.ndim == 3:
        tx, ty = tx[..., None], ty[..., None]
    p00, p01, p10, p11 = img[y0r, x0r], img[y0r, x1r], img[y1r, x0r], img[y1r, x1r]
    top = p00 + tx * (p01 - p00)
    bot = p10 + tx * (p11 - p10)
    return top + ty * (bot - top)


def _blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """Separable Gaussian blur on cv2's fixed tables (sigma 0), reflect-101,
    each pass summed in float64 and rounded to float32."""
    kern, r = _GAUSS[ksize], ksize // 2
    out = img.astype(np.float32)
    for axis in (1, 0):
        n = out.shape[axis]
        idx = _reflect101(np.arange(-r, n + r), n)
        padded = np.take(out, idx, axis=axis).astype(np.float64)
        acc = np.zeros(out.shape, np.float64)
        for t in range(ksize):
            acc += kern[t] * np.take(padded, np.arange(t, t + n), axis=axis)
        out = acc.astype(np.float32)
    return out


def aberration(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Per-image photometric jitter on float [0, 1], drawn from `rng`."""
    if rng.random() < 0.5:
        alpha = 1.0 + float(rng.uniform(-0.2, 0.2))  # contrast
        beta = float(rng.uniform(-0.2, 0.2))         # brightness (by max=1.0)
        img = img * alpha + beta
    if rng.random() < 0.5:
        img = _blur(img, int(rng.choice([3, 5])))
    return np.ascontiguousarray(img)


def imagenet_normalize(img: np.ndarray) -> np.ndarray:
    return ((img.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD).astype(np.float32)


def sample_params(rng: np.random.Generator) -> dict:
    """Draw all augmentation randomness up front, in the JAX package's
    order: the same `rng` gives the same dict."""
    p = {"flip_d": -2, "angle": 0.0}
    if rng.random() < 0.5:
        p["flip_d"] = int(rng.integers(-1, 2))
    if rng.random() < 0.5:
        p["angle"] = float(rng.uniform(-5.0, 5.0))
    for img in ("a", "b"):
        cb = rng.random() < 0.5
        alpha = 1.0 + float(rng.uniform(-0.2, 0.2)) if cb else 1.0
        beta = float(rng.uniform(-0.2, 0.2)) if cb else 0.0
        blur = int(rng.choice([3, 5])) if rng.random() < 0.5 else 0
        p[img] = {"cb": cb, "alpha": alpha, "beta": beta, "blur": blur}
    return p


def apply_params(p: dict, a: np.ndarray, b: np.ndarray, mask: np.ndarray):
    """Apply pre-sampled params: flip, rotate, then each image's
    brightness-contrast and blur (no normalization), as the engine does.
    The engine computes in float32 with the params rounded to float32."""
    if p["flip_d"] != -2:
        a, b, mask = _flip(a, p["flip_d"]), _flip(b, p["flip_d"]), _flip(mask, p["flip_d"])
    if p["angle"] != 0.0:
        a = _rotate(a, p["angle"], nearest=False)
        b = _rotate(b, p["angle"], nearest=False)
        mask = _rotate(mask, p["angle"], nearest=True)
    outs = []
    for img, key in ((a, "a"), (b, "b")):
        q = p[key]
        img = img.astype(np.float32)
        if q["cb"]:
            img = img * np.float32(q["alpha"]) + np.float32(q["beta"])
        if q["blur"]:
            img = _blur(img, q["blur"])
        outs.append(np.ascontiguousarray(img))
    return outs[0], outs[1], np.ascontiguousarray(mask, np.float32)
