"""Run one cell of the benchmark of nbed_tpu_torch and print its result
line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells, configurations and metrics are
those of BENCHMARK.json at that root; see benchmark/harness/main.py."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# the cores a run keeps to: the program's host side is one Python thread
# between graph replays, and a thread per core for its small host
# operations makes every run wait on the slowest of them, which spreads
# run-to-run times on a shared host (PERF.md, section 2)
CORES = 4

if __name__ == "__main__":
    cores = sorted(os.sched_getaffinity(0))[:CORES]
    os.sched_setaffinity(0, cores)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(len(cores))
    # kernel caches at fixed paths inside the checkout; nothing of JAX
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(HERE), str(ROOT)]
    from harness.main import main

    sys.exit(main(sys.argv[1:], T_START, ROOT))
