"""Runs of the benchmark's command in the tests (`--cpu-tiny`)."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def run_cell(workload, seed=2 ** 31 + 77, trace=0, root=ROOT, extra=(),
             env_extra=None):
    """(returncode, last stdout line as JSON or None, stderr) of one
    `--cpu-tiny` run from `root`."""
    env = dict(os.environ, OMP_NUM_THREADS="2", **(env_extra or {}))
    p = subprocess.run(
        [sys.executable, "bench_h100/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", "0.5", "--trace", str(trace),
         "--cpu-tiny", *extra], cwd=root, env=env, capture_output=True,
        text=True, timeout=600)
    lines = p.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return p.returncode, last, p.stderr
