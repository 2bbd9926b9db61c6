"""The fake process group in a test: ``released`` takes down a fake
group that the block started (building a step for a mesh that no
process holds starts one: ``launch/mesh.fake_mesh``), so no test leaves
a group in its worker; ``run_jobs`` runs jobs that need the group in a
fresh interpreter (``_torch_fake_jobs``) and returns their JSON."""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def released():
    import torch.distributed as dist
    try:
        yield
    finally:
        if dist.is_initialized() and dist.get_backend() == "fake":
            dist.destroy_process_group()


def run_jobs(*names: str, timeout: float = 600) -> dict:
    """``{name: result}`` of ``_torch_fake_jobs.<name>()`` each, run in one
    subprocess that imports neither jax nor the reference."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    done = subprocess.run(
        [sys.executable, "-m", "_torch_fake_jobs", *names],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)
    assert done.returncode == 0, done.stdout[-3000:] + done.stderr[-5000:]
    return json.loads(done.stdout.strip().splitlines()[-1])
