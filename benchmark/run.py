#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the checks on standard error and one JSON result line last on
standard output; exits 2 without a result where the cell's CUDA devices are
missing, 3 where jax, jaxlib, flax or gslam_tpu was loaded. Every cache the
program's compilers may write is pinned inside the checkout, at fixed paths
under benchmark/_cache/ (the CUDA kernels of gslam_tpu_torch build into
gslam_tpu_torch/_build/, keyed by the hash of their source).
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "benchmark" / "_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
os.environ["OMP_NUM_THREADS"] = "1"
sys.path[0] = str(ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
