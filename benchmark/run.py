#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints the cell's metrics, as one JSON object,
as the last line of standard output, and each number compared with the
plain reference beside its limit as the last lines of standard error.
Exits non-zero, printing no result, without the cards the cell asks for.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "cache")

# Every build and kernel cache at a fixed path inside the checkout; the
# port's nvcc library goes to build/videomamba_tpu_torch/ by itself.
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
os.environ["USE_FLAX"] = "0"
sys.path[0] = ROOT  # the checkout's root, not this directory

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], ROOT, 0.0))
