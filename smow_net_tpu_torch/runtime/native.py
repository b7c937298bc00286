"""ctypes binding of the host engine in `runtime/augment.cpp` (port of
smow_net_tpu/runtime/native.py): the per-sample augmentation chain and the
PNG row unfilter.

The library is compiled at first use with `g++ -O3 -march=native -fopenmp
-shared -fPIC` into `smow_net_tpu_torch/_build/`, cached by a hash of the
source, the flags and the host CPU (an `-march=native` build does not run
on another CPU), and loaded with ctypes. Nothing is built when this module
is imported. A failed build raises with the compiler's output: there is no
fallback (the JAX package falls back to cv2, which the GPU machine lacks).
ctypes releases the GIL for the call, so a loader's threads run the engine
in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = ["get_lib", "augment_sample", "augment_batch", "png_unfilter"]

SRC = Path(__file__).resolve().parent / "augment.cpp"
BUILD_DIR = SRC.parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_int, _float = ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "augment_sample": [_F, _F, _F, _int, _int, _int, _float,
                       _int, _float, _float, _int, _int, _float, _float, _int, _int],
    "augment_batch": [_F, _F, _F, _int, _int, _int, _I, _F,
                      _I, _F, _F, _I, _I, _F, _F, _I, _int],
    "png_unfilter": [_U8, _U8, _int, _int, _int],
}


def _host_cpu() -> str:
    """The CPU's model and feature flags (what -march=native compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.processor() + platform.machine()


def build() -> Path:
    """Compile augment.cpp into `_build/` (skipped when the hashed file exists)."""
    digest = hashlib.sha256(SRC.read_bytes())
    digest.update(" ".join(FLAGS).encode() + _host_cpu().encode())
    out = BUILD_DIR / f"libaugment_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = Path(work) / "lib.so"
        try:
            proc = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError("building the host engine needs g++ on PATH") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name} ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)    # atomic: a concurrent build never sees half a file
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if it cannot be built."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int if name == "png_unfilter" else None
                _lib = lib
    return _lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def _check(arr: np.ndarray, dtype, shape) -> None:
    if arr.dtype != dtype or not arr.flags.c_contiguous or arr.shape != shape:
        raise ValueError(f"expected a contiguous {np.dtype(dtype)} array of shape {shape}, "
                         f"got {arr.dtype} {arr.shape} (contiguous: {arr.flags.c_contiguous})")


def augment_sample(a: np.ndarray, b: np.ndarray, mask: np.ndarray,
                   flip_d: int, angle: float,
                   a_cb: bool, a_alpha: float, a_beta: float, a_blur: int,
                   b_cb: bool, b_alpha: float, b_beta: float, b_blur: int,
                   normalize: bool = True):
    """In place: a, b (H, W, 3) and mask (H, W), contiguous float32.
    flip_d=-2 disables the flip (else a cv2 flip code), angle=0 the rotation;
    blur in {0, 3, 5}."""
    h, w = mask.shape
    _check(a, np.float32, (h, w, 3))
    _check(b, np.float32, (h, w, 3))
    _check(mask, np.float32, (h, w))
    get_lib().augment_sample(_ptr(a, _F), _ptr(b, _F), _ptr(mask, _F), h, w,
                             int(flip_d), float(angle),
                             int(a_cb), float(a_alpha), float(a_beta), int(a_blur),
                             int(b_cb), float(b_alpha), float(b_beta), int(b_blur),
                             int(normalize))
    return a, b, mask


def augment_batch(a: np.ndarray, b: np.ndarray, mask: np.ndarray, params,
                  normalize: bool = True):
    """`augment_sample` over a batch in place, samples in parallel (OpenMP):
    a, b (N, H, W, 3), mask (N, H, W), and one `transforms.sample_params`
    dict per sample."""
    n, h, w = mask.shape
    if len(params) != n:
        raise ValueError(f"{len(params)} parameter sets for {n} samples")
    _check(a, np.float32, (n, h, w, 3))
    _check(b, np.float32, (n, h, w, 3))
    _check(mask, np.float32, (n, h, w))

    def col(get, dtype):
        return np.ascontiguousarray([get(p) for p in params], dtype)

    ints = {k: col(f, np.int32) for k, f in (
        ("flip", lambda p: p["flip_d"]), ("a_cb", lambda p: p["a"]["cb"]),
        ("a_blur", lambda p: p["a"]["blur"]), ("b_cb", lambda p: p["b"]["cb"]),
        ("b_blur", lambda p: p["b"]["blur"]))}
    floats = {k: col(f, np.float32) for k, f in (
        ("angle", lambda p: p["angle"]), ("a_alpha", lambda p: p["a"]["alpha"]),
        ("a_beta", lambda p: p["a"]["beta"]), ("b_alpha", lambda p: p["b"]["alpha"]),
        ("b_beta", lambda p: p["b"]["beta"]))}
    i, f = (lambda k: _ptr(ints[k], _I)), (lambda k: _ptr(floats[k], _F))
    get_lib().augment_batch(_ptr(a, _F), _ptr(b, _F), _ptr(mask, _F), n, h, w,
                            i("flip"), f("angle"),
                            i("a_cb"), f("a_alpha"), f("a_beta"), i("a_blur"),
                            i("b_cb"), f("b_alpha"), f("b_beta"), i("b_blur"),
                            int(normalize))
    return a, b, mask


def png_unfilter(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The (height, row_bytes) uint8 scanlines of an inflated, non-interlaced
    PNG stream `raw` (each row led by its filter-type byte)."""
    if not 1 <= bpp <= 8:
        raise ValueError(f"bytes per pixel must be 1..8, got {bpp}")
    if len(raw) != height * (row_bytes + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                         f"{height} rows of 1 + {row_bytes}")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((height, row_bytes), np.uint8)
    bad = get_lib().png_unfilter(_ptr(src, _U8), _ptr(out, _U8), height, row_bytes, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1} has filter type {src[(bad - 1) * (row_bytes + 1)]}, "
                         "not one of 0..4")
    return out
