"""What one step between two phases of a GPU program costs, on one CUDA card.

    python3 scripts/sync_cost.py [--blocks-per-sm 1] [--iters 2000]

Builds a small CUDA library with nvcc (into ``build/sync_cost/``) and
measures, with CUDA events around ``--iters`` repetitions:

* an empty kernel: the host's time to submit one ``<<<>>>`` launch (the
  call returning, no synchronise) and the device's time a launch back to
  back;
* a chain of empty kernels sent with programmatic dependent launch
  (``cudaLaunchAttributeProgrammaticStreamSerialization``), each calling
  ``cudaGridDependencySynchronize``: the device's time a launch;
* a grid barrier inside one persistent kernel of SMs x ``--blocks-per-sm``
  blocks of 256 threads (an arrive counter and a generation flag, one
  thread a block arriving and polling): the time a barrier.

These are the two ways to separate the dependent phases of a token-decode
stack. Prints the card's name and power limit first and one JSON object
last. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build" / "sync_cost"

SOURCE = r"""
#include <chrono>
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

__global__ void pdl_kernel() {
  cudaGridDependencySynchronize();
  cudaTriggerProgrammaticLaunchCompletion();
}

struct Bar { unsigned count; unsigned gen; };

__device__ __forceinline__ void grid_sync(Bar* bar, unsigned nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* vgen = &bar->gen;
    const unsigned gen = *vgen;
    __threadfence();
    if (atomicAdd(&bar->count, 1u) == nblocks - 1) {
      bar->count = 0;
      __threadfence();
      atomicExch(&bar->gen, gen + 1);
    } else {
      while (*vgen == gen) {}
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void barrier_kernel(Bar* bar, int iters) {
  for (int i = 0; i < iters; ++i) grid_sync(bar, gridDim.x);
}

static float elapsed(cudaEvent_t a, cudaEvent_t b) {
  float ms = 0.f;
  cudaEventSynchronize(b);
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}

// out: [submit ms a launch, device ms a launch, pdl ms a launch, barrier ms]
extern "C" int sync_cost(int iters, int blocks_per_sm, double* out) {
  cudaStream_t s;
  cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int i = 0; i < 10; ++i) empty_kernel<<<1, 32, 0, s>>>();
  cudaStreamSynchronize(s);
  const auto t0 = std::chrono::steady_clock::now();
  cudaEventRecord(a, s);
  for (int i = 0; i < iters; ++i) empty_kernel<<<1, 32, 0, s>>>();
  cudaEventRecord(b, s);
  const auto t1 = std::chrono::steady_clock::now();
  out[0] = std::chrono::duration<double, std::milli>(t1 - t0).count() / iters;
  out[1] = elapsed(a, b) / iters;

  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms);
  cfg.blockDim = dim3(256);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  for (int i = 0; i < 10; ++i) cudaLaunchKernelEx(&cfg, pdl_kernel);
  cudaEventRecord(a, s);
  for (int i = 0; i < iters; ++i) cudaLaunchKernelEx(&cfg, pdl_kernel);
  cudaEventRecord(b, s);
  out[2] = elapsed(a, b) / iters;

  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, barrier_kernel, 256, 0);
  if (per_sm < blocks_per_sm) return -1;
  Bar* bar;
  cudaMalloc(&bar, sizeof(Bar));
  cudaMemset(bar, 0, sizeof(Bar));
  const int nb = sms * blocks_per_sm;
  barrier_kernel<<<nb, 256, 0, s>>>(bar, 10);
  cudaEventRecord(a, s);
  barrier_kernel<<<nb, 256, 0, s>>>(bar, iters);
  cudaEventRecord(b, s);
  out[3] = elapsed(a, b) / iters;
  const cudaError_t err = cudaGetLastError();
  cudaFree(bar);
  cudaStreamDestroy(s);
  return (int)err;
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks-per-sm", type=int, default=1)
    ap.add_argument("--iters", type=int, default=2000)
    args = ap.parse_args()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        print("sync_cost: nvcc not found", file=sys.stderr)
        return 1
    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD / "sync_cost.cu", BUILD / "libsync_cost.so"
    src.write_text(SOURCE)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)], check=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no card line")
    fn = ctypes.CDLL(str(lib)).sync_cost
    fn.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_double))
    out = (ctypes.c_double * 4)()
    err = fn(args.iters, args.blocks_per_sm, out)
    if err != 0:
        print(f"sync_cost: error {err}", file=sys.stderr)
        return 1
    result = {"iters": args.iters, "blocks_per_sm": args.blocks_per_sm,
              "launch_submit_ms": out[0], "launch_device_ms": out[1],
              "pdl_launch_ms": out[2], "grid_barrier_ms": out[3]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
