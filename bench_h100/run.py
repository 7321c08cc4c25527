"""The benchmark's command: `python3 bench_h100/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>` from the root of a checkout
(`harness.py` says what a run does). Every build and kernel cache lives
at a fixed path inside the checkout."""
import time


def _process_start() -> float:
    """perf_counter's reading at this process's start (from the kernel's
    record of it; the interpreter's own start-up counts as set-up)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = (time.clock_gettime(time.CLOCK_BOOTTIME)
               - ticks / os.sysconf("SC_CLK_TCK"))
        return now - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return now


import os  # noqa: E402

T_START = _process_start()

import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(CACHE, sub)
# one process, few host threads: the host's share of a call is Python and
# launches, and a pool of idle CPU threads only adds contention
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[0] = ROOT          # the checkout's root, not this directory

if __name__ == "__main__":
    from bench_h100.harness import main
    sys.exit(main(sys.argv[1:], T_START))
