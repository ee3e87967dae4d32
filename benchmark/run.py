"""Runs one cell of the benchmark of mmvae_tpu_torch once, from the root of
a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cells are the workloads of BENCHMARK.json; benchmark/README.md says
what each does. Exits non-zero without a result where there is no CUDA
card.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache of a run inside the checkout, at fixed paths,
# so that only a checkout's first run builds
_CACHE = os.path.join(ROOT, ".bench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from benchmark import harness

    sys.exit(harness.main(t_start=T_START))
