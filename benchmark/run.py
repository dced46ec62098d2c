#!/usr/bin/env python3
"""Run one cell of the benchmark of `emsanet_tpu_torch` once, from the
root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON object. Build and
kernel caches stay inside the checkout at fixed paths (the program's
kernels under `build/kernels/`).
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, "build", "bench_cache", sub)
sys.path[:0] = [HERE, ROOT]

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
