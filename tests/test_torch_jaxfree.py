"""The port runs without jax: in a fresh interpreter in which ``jax``,
``jaxlib`` and the reference package ``repro`` cannot be imported (each
is None in ``sys.modules``), every module under ``src/repro_torch/``,
``chip_smoke``, every script under ``scripts/`` and every
``examples/torch_*.py`` imports."""
from __future__ import annotations

import subprocess
import sys

from _torch_fake_group import ROOT

CODE = r"""
import importlib, importlib.util, pathlib, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root)]
pkg = root / "src" / "repro_torch"
mods = []
for p in sorted(pkg.rglob("*.py")):
    parts = list(p.relative_to(root / "src").with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    mods.append(".".join(parts))
mods.append("chip_smoke")
for m in mods:
    importlib.import_module(m)
files = sorted((root / "scripts").glob("*.py")) + \
    sorted((root / "examples").glob("torch_*.py"))
for p in files:
    spec = importlib.util.spec_from_file_location(f"_jaxfree_{p.stem}", p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print("imported", len(mods), len(files))
"""


def test_port_imports_with_jax_and_the_reference_blocked():
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    done = subprocess.run([sys.executable, "-c", CODE, str(ROOT)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert done.returncode == 0, done.stdout + done.stderr[-4000:]
    n_mods, n_files = map(int, done.stdout.split()[-2:])
    assert n_mods > 60 and n_files >= 11, done.stdout
