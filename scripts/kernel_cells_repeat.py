#!/usr/bin/env python3
"""Hunt a rare wrong or changing kernel output at the tuner's kernel-cell
shapes, on one GPU.

    python3 scripts/kernel_cells_repeat.py [--rounds N] [--poisoned N]

Builds the kernels and runs ``chip_smoke.py``'s phase ``kernels`` (so
the card has done the same work as in a smoke run), then its phase
``kernel_cells`` ``--rounds`` times (every kernel cell at every tile the
tuner accepts, against its plain version, each output then repeated and
required equal bit for bit), counting the rounds that fail and the worst
error seen per kernel (every call there follows a fill of the SMs'
shared memory with NaN, ``chip_smoke.poison_shared_memory``).  Then
calls each cell's kernel ``--poisoned`` times, each call right after
freeing device memory filled with NaN and filling the SMs' shared memory
with NaN, so an output that reads memory the kernel did not write shows
as non-finite; each output is also held bit for bit against the cell's
first call.  Prints one JSON line of counts, then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--poisoned", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_cells_repeat: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with contextlib.redirect_stdout(io.StringIO()):
        smi = cs.phase_env()
        cs.phase_build(False)
        records = cs.phase_kernels()

    from repro_torch.core.kernel_cell import KERNELS
    from repro_torch.core.params import default_config
    failures, worst, calls = [], {}, 0
    for r in range(args.rounds):
        try:
            rows = cs.phase_kernel_cells(records, quiet=True)
        except AssertionError as e:
            failures.append({"round": r, "error": str(e)})
            continue
        for row in rows:
            worst[row["kernel"]] = max(worst.get(row["kernel"], 0.0),
                                       row["max_abs_err"])
            calls += 3
    dev, nan, poisoned, changed = torch.device("cuda"), float("nan"), {}, {}
    for name, spec in sorted(KERNELS.items()):
        for shape_name, shape in sorted(spec.shapes.items()):
            fn, fargs = spec.build(shape, default_config(), dev)
            cs.poison_shared_memory()
            first = fn(*fargs)
            first = first if isinstance(first, tuple) else (first,)
            bad = differ = 0
            for _ in range(args.poisoned):
                for size in (1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20,
                             1 << 22):
                    held = [torch.full((size,), nan, device=dev)
                            for _ in range(8)]
                    del held
                cs.poison_shared_memory()
                out = fn(*fargs)
                out = out if isinstance(out, tuple) else (out,)
                bad += any(not bool(torch.isfinite(o.float()).all())
                           for o in out)
                differ += not all(torch.equal(a, b)
                                  for a, b in zip(first, out))
            poisoned[f"{name}:{shape_name}"] = bad
            changed[f"{name}:{shape_name}"] = differ
    print(json.dumps({"rounds": args.rounds, "failed_rounds": failures,
                      "kernel_calls_checked": calls,
                      "worst_err": worst, "poisoned_calls": args.poisoned,
                      "smem_poison": True,
                      "non_finite_after_poison": poisoned,
                      "bits_changed_after_poison": changed}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
