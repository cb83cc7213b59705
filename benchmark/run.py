"""Run one cell of the benchmark of ``lifelong_nnunet_tpu_torch`` on the
CUDA devices of this machine:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Prints one JSON line (the last line of
standard output): ``correct``, ``attempted``, ``failed``, the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics (``--trace
1``), the device, and the numbers compared with the plain reference beside
their limits.  Exits non-zero without a result when the cell's devices are
missing.  The kernel caches live under ``build/`` of the checkout.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "nv")
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
