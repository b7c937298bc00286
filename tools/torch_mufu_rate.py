#!/usr/bin/env python
"""Measure the rate at which one NVIDIA GPU runs `ex2.approx.ftz.f32` (the
multi-function unit's exp2, one per state update of the selective scan's
sweeps), beside the rate the scan kernels' bound assumes (16 per clock per
SM at the card's maximum SM clock, chip_smoke.mufu_per_s).

    python tools/torch_mufu_rate.py

Compiles a probe kernel with nvcc (sm_90a) into smow_net_tpu_torch/_build/,
loads it with ctypes and times it with CUDA events: every thread runs 8
independent chains of x = exp2(x * c), one FMUL and one MUFU.EX2 a link,
over a grid that fills the card (8 blocks of 256 threads an SM). Prints one
JSON line: the card's name and power limit, the exps per second, the
multi-function units' rate at clocks.max.sm, their ratio, and the SM clock
that nvidia-smi reads just after the timed launches.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

SOURCE = r"""
extern "C" __global__ void __launch_bounds__(256) ex2_chains(float* out, int iters, float c) {
  float x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = 0.5f + 1e-3f * (threadIdx.x % 7 + i);
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float y;
      asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x[i] * c));
      x[i] = y;
    }
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += x[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int launch_ex2_chains(float* out, int blocks, int iters, float c, void* stream) {
  ex2_chains<<<blocks, 256, 0, (cudaStream_t)stream>>>(out, iters, c);
  return (int)cudaGetLastError();
}
"""


def main() -> None:
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_mufu_rate: no CUDA device")
    import chip_smoke
    from smow_net_tpu_torch.ops import _kernels

    build = root / "smow_net_tpu_torch" / "_build"
    build.mkdir(parents=True, exist_ok=True)
    src, lib_path = build / "mufu_probe.cu", build / "libmufu_probe.so"
    src.write_text(SOURCE)
    subprocess.run([_kernels._nvcc(), "-gencode", _kernels.GENCODE, "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.launch_ex2_chains.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    out = torch.empty(blocks * 256, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run():
        rc = lib.launch_ex2_chains(out.data_ptr(), blocks, iters, -0.7, stream)
        if rc != 0:
            raise RuntimeError(f"ex2_chains: CUDA error {rc}")

    ms = chip_smoke.cuda_ms(run, iters=20, warmup=3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    rate = blocks * 256 * iters * 8 / (ms * 1e-3)
    peak = chip_smoke.mufu_per_s()
    print(json.dumps({"card": smi, "ms": ms, "exps_per_s": rate, "assumed_per_s": peak,
                      "ratio": rate / peak}))


if __name__ == "__main__":
    main()
