"""The port's examples (``examples/torch_*.py``), each run as a user runs
it, on the CPU at its reduced config."""
from __future__ import annotations

import os
import subprocess
import sys

import pytest

from _torch_fake_group import ROOT

CASES = {
    "torch_quickstart.py": (["--steps", "3"], "done."),
    "torch_serve_batch.py": ([], "=== kv_cache_dtype=int8 ==="),
    "torch_serve_scheduler.py": ([], "metrics: {'requests': 10"),
    "torch_tune_trial_and_error.py": (["--repeats", "3"], "trials (cap 10)"),
}


@pytest.mark.parametrize("script", sorted(CASES))
def test_example_runs_on_the_cpu(script):
    argv, marker = CASES[script]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    done = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
         *argv], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=600)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-3000:]
    assert marker in done.stdout, done.stdout[-2000:]
    if script == "torch_tune_trial_and_error.py":
        trials = int(done.stdout.split(" trials (cap 10)")[0].split()[-1])
        assert 1 <= trials <= 10
