#!/usr/bin/env python3
"""Measure the rate of ``mma.sync.m16n8k8`` in TF32 on one GPU, by warps a
block and independent chains of products a warp.

    python3 tools/mma_tf32_rate.py

Builds a small CUDA program (the flags of ``repro_torch.kernels.build``,
less ``-shared``) into the git-ignored ``build/mma_rate/`` and runs it: 132
blocks (one an SM of an H100) of 4, 8 or 16 warps, each warp issuing 4096
rounds of 1, 2, 4 or 8 products into as many accumulators (a chain each),
timed with CUDA events.  Prints one JSON line a point (TFLOP/s of TF32,
SM cycles a product, and the dependent product's latency a warp sees, the
run's cycles over its rounds), then one with the card's name and power
limit.  B3 (``csrc/ssd_scan_bwd.cu``) keeps its tiles' products
independent for what this shows.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mma_rate"
SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
__global__ void __launch_bounds__(512, 1) rate(float* out, int iters,
                                               int chains) {
  float acc[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u,
                         threadIdx.x * 7u};
  const uint32_t b[2] = {threadIdx.x * 11u, threadIdx.x * 13u};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < chains)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
              "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  const int blocks = 132, iters = 4096;
  float* out;
  cudaMalloc(&out, blocks * 512 * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  int khz;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  for (int warps : {4, 8, 16})
    for (int chains : {1, 2, 4, 8}) {
      rate<<<blocks, warps * 32>>>(out, 16, chains);
      cudaEventRecord(e0);
      rate<<<blocks, warps * 32>>>(out, iters, chains);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      const double per_sm = (double)warps * iters * chains;
      const double cycles = ms * 1e-3 * khz * 1e3;
      printf("%d %d %.6f %.3f %.3f %.1f\n", warps, chains, ms,
             per_sm * blocks * 16 * 8 * 8 * 2 / (ms * 1e-3) / 1e12,
             cycles / per_sm, cycles / iters);
    }
  return cudaGetLastError() != cudaSuccess;
}
"""


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    OUT.mkdir(parents=True, exist_ok=True)
    src, exe = OUT / "mma_rate.cu", OUT / "mma_rate"
    src.write_text(SOURCE)
    flags = [f for f in build.FLAGS if f not in ("-shared", "-Xcompiler",
                                                 "-fPIC")]
    subprocess.run([build._nvcc(), *flags, "-o", str(exe), str(src)],
                   check=True, capture_output=True, text=True)
    run = subprocess.run([str(exe)], check=True, capture_output=True,
                         text=True, timeout=300)
    for line in run.stdout.split("\n"):
        if not line.strip():
            continue
        warps, chains, ms, tflops, per_mma, latency = line.split()
        print(json.dumps(dict(warps_a_sm=int(warps), chains_a_warp=int(chains),
                              ms=float(ms), tf32_tflops=float(tflops),
                              sm_cycles_a_product=float(per_mma),
                              cycles_a_round=float(latency))))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(device=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
