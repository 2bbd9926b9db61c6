#!/usr/bin/env python3
"""Count how often the host's first ``torch.exp`` of a process, or the
plain scan, gives another answer, over many fresh processes on the CPU.

    python3 scripts/fresh_exp_probe.py [--processes N] [--parallel K]
                                        [--mode exp|scan]

``--mode exp`` (default): each process's first torch call is
``torch.exp`` of a seeded (1, 64, 64, 2) tensor (the shape of the plain
scan's within-chunk exponent, values in [-30, 30]), in f32 and then, in
another process, in f64; the same call is then repeated.  Each result is
held against exp taken in f64 (f32) or in 50-digit ``mpmath`` (f64).
``--mode scan``: each process runs ``ssm_scan_tiled`` in f32 at
``kernel:ssm_scan:tiny``'s inputs against the f64 recurrence, as
``tests/test_torch_ssm_side.py::test_tiled_f32_matches_f64_recurrence``
does.  ``--parallel`` processes run at a time (the firings come more
often on a loaded host).  Prints one JSON line: the processes, and for
each dtype or for the scan the ones whose error passed the bound, with
their errors and the number of elements hit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_EXP = r"""
import json, sys, torch
dtype = getattr(torch, sys.argv[1])
g = torch.Generator().manual_seed(0)
x = torch.rand(1, 64, 64, 2, generator=g, dtype=torch.float64) * 60 - 30
x = x.to(dtype)
first = torch.exp(x)
again = torch.exp(x)
if dtype == torch.float64:
    import mpmath
    mpmath.mp.dps = 50
    want = torch.tensor([float(mpmath.exp(v)) for v in x.flatten().tolist()],
                        dtype=torch.float64).view(x.shape)
else:
    want = torch.exp(x.double())
rel = lambda y: (y.double() - want).abs() / want
print(json.dumps({"first": float(rel(first).max()),
                  "hit": int((rel(first) > BOUND).sum()),
                  "again": float(rel(again).max())}))
"""

_SCAN = r"""
import json, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(root / "src")]
import torch
from repro_torch.core.kernel_cell import KERNELS
from repro_torch.core.params import default_config
from repro_torch.kernels.ssm_scan import ops, ref
spec = KERNELS["ssm_scan"]
fn, args = spec.build(spec.shapes["tiny"], default_config(),
                      torch.device("cpu"))
Y, h = ref.ssm_scan_tiled(*args, ops.KERNEL_CHUNK)
Y64, h64 = ref.ssm_scan_ref(*(a.double() for a in args), dtype=torch.float64)
print(json.dumps({"err_y": float((Y.double() - Y64).abs().max()),
                  "err_h": float((h.double() - h64).abs().max())}))
"""

# f32's rounding is 6e-8 relative, f64's 1.1e-16: a few of them pass
BOUNDS = {"float32": 1e-6, "float64": 1e-13}
SCAN_BOUND = 2e-5           # the tier-1 test's


def _run(argvs, parallel: int):
    env = {"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"}
    out = []
    for i in range(0, len(argvs), parallel):
        procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=env)
                 for a in argvs[i:i + parallel]]
        for p in procs:
            so, se = p.communicate(timeout=600)
            if p.returncode:
                raise SystemExit(se[-3000:])
            out.append(json.loads(so.strip().splitlines()[-1]))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--processes", type=int, default=200)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--mode", choices=("exp", "scan"), default="exp")
    a = ap.parse_args()
    py = sys.executable
    if a.mode == "scan":
        res = _run([[py, "-c", _SCAN, str(ROOT)]] * a.processes, a.parallel)
        bad = [r for r in res if max(r["err_y"], r["err_h"]) >= SCAN_BOUND]
        print(json.dumps({"mode": "scan", "processes": len(res),
                          "bound": SCAN_BOUND, "failed": len(bad),
                          "worst_err_y": max(r["err_y"] for r in res),
                          "misses": bad}))
        return
    out = {"mode": "exp", "processes_per_dtype": a.processes}
    for dt, bound in BOUNDS.items():
        body = _EXP.replace("BOUND", repr(bound))
        res = _run([[py, "-c", body, dt]] * a.processes, a.parallel)
        bad = [r for r in res if r["first"] > bound or r["again"] > bound]
        out[dt] = {"bound": bound, "fired": len(bad),
                   "worst_first": max(r["first"] for r in res),
                   "worst_again": max(r["again"] for r in res),
                   "firings": bad}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
