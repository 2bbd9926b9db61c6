#!/usr/bin/env python3
"""Count how often the host's first ``torch.exp`` of a process, or the
plain scan, gives another answer, over many fresh processes on the CPU.

    python3 scripts/fresh_exp_probe.py [--processes N] [--parallel K]
                                        [--mode exp|scan|mamba|mlstm]
                                        [--src DIR]

``--mode exp`` (default): each process's first torch call is
``torch.exp`` of a seeded (1, 64, 64, 2) tensor (the shape of the plain
scan's within-chunk exponent, values in [-30, 30]), in f32 and then, in
another process, in f64; the same call is then repeated.  With
``--after-import`` each process imports ``repro_torch.models.layers``
(from ``--src``) first, as every model does: its import of
``repro_torch.kernels`` takes a throwaway exp on every thread.  Each result is
held against exp taken in f64 (f32) or in 50-digit ``mpmath`` (f64).
``--mode scan``: each process runs ``ssm_scan_tiled`` in f32 at
``kernel:ssm_scan:tiny``'s inputs against the f64 recurrence, as
``tests/test_torch_ssm_side.py::test_tiled_f32_matches_f64_recurrence``
does.  ``--mode mamba`` / ``--mode mlstm``: each process runs the port's
eager f32 path whose first large f32 exp is the model's own, twice on
the same seeded inputs, and reports how far the first call's results
lie from the second's (over their largest magnitude; the two agree bit
for bit unless an exp gave another answer): the Mamba2 decode step
(``mamba2.mamba_decode_block``, the reduced zamba2-7b at batch 1024:
its decay ``exp`` spans 8192 elements) and the mLSTM's chunked prefill
(``xlstm.mlstm_block``, the reduced xlstm-1.3b at (2, 64): its
within-chunk ``exp`` spans 16,384).  ``--src`` names the ``src``
directory of the tree to load (default: this checkout's), so another
tree, such as a ``git archive`` of a parent commit, can be probed.
``--parallel`` processes run at a time (the firings come more often on
a loaded host).  Prints one JSON line: the processes, and for each
dtype, for the scan or for the model path the ones whose error passed
the bound, with their errors (and, for exp, the number of elements
hit).
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
if len(sys.argv) > 2:            # --after-import: the port loaded first
    sys.path[:0] = [sys.argv[2]]
    import repro_torch.models.layers
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

_MODEL = r"""
import json, sys
sys.path[:0] = [sys.argv[1]]
import torch
from repro_torch.configs import get_reduced
from repro_torch.core.params import default_config
from repro_torch.models import layers as L, mamba2, xlstm
from repro_torch.runtime.loops import tree_leaves
rt = default_config(compute_dtype="float32", attn_impl="xla")
g = torch.Generator().manual_seed(0)
if sys.argv[2] == "mamba":
    cfg = get_reduced("zamba2-7b")
    p = L.init_params(mamba2.mamba_spec(cfg), g)
    B = 1024
    x = torch.randn(B, 1, cfg.d_model, generator=g)
    shp, _ = mamba2.mamba_cache_shapes(cfg, B, 1)
    state = {k: torch.randn(s.shape[1:], generator=g) for k, s in shp.items()}
    run = lambda: mamba2.mamba_decode_block(p, x, state, cfg, rt, None)
else:
    cfg = get_reduced("xlstm-1.3b")
    p = L.init_params(xlstm.mlstm_spec(cfg), g)
    x = torch.randn(2, 64, cfg.d_model, generator=g)
    run = lambda: xlstm.mlstm_block(p, x, cfg, rt, None, want_state=True)
with torch.no_grad():
    first, again = run(), run()
flat = lambda o: torch.cat([t.reshape(-1).double() for t in tree_leaves(o)])
a, b = flat(first), flat(again)
print(json.dumps({"err": float((a - b).abs().max() / b.abs().max()),
                  "threads": torch.get_num_threads()}))
"""

# f32's rounding is 6e-8 relative, f64's 1.1e-16: a few of them pass
BOUNDS = {"float32": 1e-6, "float64": 1e-13}
# the tier-1 test's bound, and the model paths' (whose two calls agree
# bit for bit when no exp misfires)
SCAN_BOUND = 2e-5


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
    ap.add_argument("--mode", choices=("exp", "scan", "mamba", "mlstm"),
                    default="exp")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory of the tree to probe")
    ap.add_argument("--after-import", action="store_true",
                    help="--mode exp: import the port's models.layers "
                         "before the exp")
    a = ap.parse_args()
    py = sys.executable
    if a.mode in ("mamba", "mlstm"):
        res = _run([[py, "-c", _MODEL, a.src, a.mode]] * a.processes,
                   a.parallel)
        bad = [r for r in res if r["err"] >= SCAN_BOUND]
        print(json.dumps({"mode": a.mode, "src": a.src,
                          "processes": len(res), "bound": SCAN_BOUND,
                          "failed": len(bad),
                          "worst_err": max(r["err"] for r in res),
                          "threads": res[0]["threads"], "misses": bad}))
        return
    if a.mode == "scan":
        res = _run([[py, "-c", _SCAN, str(pathlib.Path(a.src).parent)]]
                   * a.processes, a.parallel)
        bad = [r for r in res if max(r["err_y"], r["err_h"]) >= SCAN_BOUND]
        print(json.dumps({"mode": "scan", "processes": len(res),
                          "bound": SCAN_BOUND, "failed": len(bad),
                          "worst_err_y": max(r["err_y"] for r in res),
                          "misses": bad}))
        return
    out = {"mode": "exp", "processes_per_dtype": a.processes,
           "after_import": a.src if a.after_import else None}
    for dt, bound in BOUNDS.items():
        body = _EXP.replace("BOUND", repr(bound))
        argv = [py, "-c", body, dt] + ([a.src] if a.after_import else [])
        res = _run([argv] * a.processes, a.parallel)
        bad = [r for r in res if r["first"] > bound or r["again"] > bound]
        out[dt] = {"bound": bound, "fired": len(bad),
                   "worst_first": max(r["first"] for r in res),
                   "worst_again": max(r["again"] for r in res),
                   "firings": bad}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
