"""Build, load and count the hand-written CUDA kernels in `csrc/`.

At first use every `csrc/*.cu` file is compiled by `nvcc` for Hopper
(`sm_90a`), one compiler process per file, all in parallel, and linked
into ONE shared library with a plain C interface, cached under
`smow_net_tpu_torch/_build/` by a hash of the sources, and loaded with
ctypes. Nothing is built or loaded when a module is imported, so the CPU
tests import every module without a CUDA toolkit.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `call` raises on anything but 0. `launches` counts,
per kernel, the launches made by the op wrappers (ops/warp.py,
ops/xattn.py, ops/scan.py): a run can read it to show it went through the
kernels. The selective scan's sweeps over the flat (B, L, G * Cg) layout
(kernel H) count as `selective_scan_{fwd,ckpt,bwd}_flat`, the general
scan's state recurrence (kernel J, either of its two C entries) as
`scan_states`, the decoder layer's
kernels F and F-bwd as `xattn_layer_{fwd,bwd}` and its attention sublayer's
G and G-bwd as `cross_attn_{fwd,bwd}`.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["launches", "library", "build", "call", "stream_handle"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
GENCODE = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points and their argument types: every pointer and the stream is a
# c_void_p (a bare Python int would be passed as a 32-bit int), sizes are int
_SIGNATURES = {
    "token_scatter_fwd": [_P] * 5 + [_I] * 5 + [_P],
    "token_scatter_fwd_eaw": [_P] * 6 + [_I] * 5 + [_P],
    "token_scatter_bwd": [_P] * 7 + [_I] * 5 + [_P],
    "grid_sample_fwd": [_P] * 3 + [_I] * 9 + [_P],
    "grid_sample_transpose": [_P] * 3 + [_I] * 9 + [_P],
    "grid_sample_t_vjp": [_P] * 5 + [_I] * 9 + [_P],
    "grid_sample_bwd": [_P] * 5 + [_I] * 9 + [_P],
    "xattn_layer_fwd": [_P] * 16 + [_I] * 7 + [ctypes.c_float, _P],
    "xattn_layer_bwd": [_P] * 20 + [_I] * 9 + [ctypes.c_float, _P],
    "xattn_layer_grid": [_I, _I, _I, _P, _P],
    "cross_attn_fwd": [_P] * 10 + [_I] * 6 + [ctypes.c_float, _P],
    "cross_attn_fwd_grid": [_I, _I, _P, _P, _P],
    "cross_attn_bwd": [_P] * 14 + [_I] * 8 + [ctypes.c_float, _P],
    "cross_attn_bwd_grid": [_I, _I, _P, _P, _P],
    "selective_scan_fwd": [_P] * 9 + [_I] * 7 + [_P],
    "selective_scan_ckpt": [_P] * 7 + [_I] * 7 + [_P],
    "selective_scan_carry": [_P] * 8 + [_I] * 7 + [_P],
    "selective_scan_fwd_occupancy": [_I, _I, _I, _P, _P],
    "selective_scan_bwd": [_P] * 15 + [_I] * 7 + [_P],
    "selective_scan_bwd_occupancy": [_I, _I, _P, _P],
    "selective_scan_adjcarry": [_P] * 6 + [_I] * 7 + [_P],
    "scan_states": [_P] * 3 + [_I] * 4 + [_P],
    "scan_states_seg": [_P] * 5 + [_I] * 5 + [_P],
}

launches: collections.Counter = collections.Counter()
build_report = ""        # nvcc/ptxas output of the build this process made
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit on PATH or under $CUDA_HOME")


def build() -> Path:
    """Compile csrc/*.cu into one .so (skipped when the hashed file exists)."""
    global build_report
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        digest.update(p.name.encode() + p.read_bytes())
    out = BUILD_DIR / f"libsmow_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        # one nvcc per source, all started together, then one link
        objs = [Path(work) / (src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, "-gencode", GENCODE, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-I", str(CSRC), "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        outputs = [p.communicate()[0] for p in procs]
        build_report = "".join(outputs)
        failed = [src.name for src, p in zip(sources, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_report}")
        tmp = Path(work) / "lib.so"
        proc = subprocess.run([nvcc, "-gencode", GENCODE, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        build_report += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{build_report}")
        os.replace(tmp, out)    # atomic: a concurrent build never sees half a file
    return out


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.smow_cuda_error_string.argtypes = [ctypes.c_int]
        lib.smow_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def call(name: str, *args, label: str | None = None) -> None:
    """Launch C entry `name`, raise on a CUDA error, count the launch under
    `label` (default: `name`; one entry serving two kernels of the JAX
    package counts each under its own label)."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        msg = lib.smow_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    launches[label or name] += 1
