"""Running benchmark/run.py in a subprocess at the small sizes of tiny.json."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TINY = os.path.join(HERE, "tiny.json")


def rehearse(workload, *extra, seed=11, seconds=2.0, trace=0, root=ROOT, timeout=600):
    """(exit code, the last stdout line as JSON or None, stderr) of one CPU run."""
    cmd = [sys.executable, os.path.join(root, "benchmark", "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace),
           "--device", "cpu", "--tiny", TINY, *extra]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=timeout, env=env)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, line, proc.stderr


def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)
