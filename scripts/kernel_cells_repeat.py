#!/usr/bin/env python3
"""Hunt a rare wrong or changing kernel output at the tuner's kernel-cell
shapes, on one GPU.

    python3 scripts/kernel_cells_repeat.py [--rounds N] [--poisoned N]
    python3 scripts/kernel_cells_repeat.py --fresh-minutes M [--rebuild] [--out DIR]

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
power limit.  Every ``ssm_scan`` call is followed by a check that its
sync buffers are back at zero, and a miss (or an output of a tile that
differs from the previous tile's) prints ``chip_smoke.side_report``'s
line: which side moved.

``--fresh-minutes M`` starts fresh processes one after another for
about M minutes instead.  Each runs what ``chip_smoke.py`` runs before
its ``kernel_cells`` phase: the whole ``kernels`` phase (even-numbered
processes) or only its ``ssm_scan`` calls, CUDA-graph timing included
(odd-numbered), then one round of ``kernel_cells``; with ``--rebuild``
each first compiles the kernels itself, into a build directory of its
own (removed at its end), as a smoke run on a fresh checkout does.
The logs of the processes that fail go to ``--out`` (default
``results/kernel_cells_fresh/``); one JSON line counts the processes
and the failures, carries their ``kernel_cells_side`` lines, and gives
each process's f32 plain error beside its host state
(``chip_smoke.host_state``) and whether it compiled the kernels.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def child(mode: str, rebuild: bool) -> int:
    """One fresh process: the ``kernels`` phase (``full``) or its scan
    calls (``scan``), then one round of ``kernel_cells``; with
    ``rebuild``, the kernels compiled in this process first, into a
    build directory of its own that it removes at its end.  Prints one
    JSON line: the result, the f32 plain version's error
    (:func:`f32_plain_err`) and the host's state beside it."""
    from repro_torch.kernels import _build
    if not rebuild:
        return run_child(mode, rebuild)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="fresh-",
                                     dir=_build.BUILD_DIR) as own:
        _build.BUILD_DIR = pathlib.Path(own)
        return run_child(mode, rebuild)


def run_child(mode: str, rebuild: bool) -> int:
    with contextlib.redirect_stdout(io.StringIO()):
        cs.phase_env()
        cs.phase_build(False)
        if mode == "full":
            records = cs.phase_kernels()
        else:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(0)
            cs.kernels_ssm_scan(gen)
            records = [{"name": n, "max_abs_err": 0.0} for n in
                       ("rmsnorm", "flash_attention", "flash_decode",
                        "ssm_scan")]
    result = {"mode": mode, "rebuilt": rebuild}
    try:
        rows = cs.phase_kernel_cells(records, quiet=True)
    except AssertionError as e:
        result.update(ok=False, error=str(e))
    else:
        result.update(ok=True, ssm_scan_tiny_err=max(
            r["max_abs_err"] for r in rows
            if r["kernel"] == "ssm_scan" and r["shape"] == "tiny"))
    result.update(f32_plain_err=f32_plain_err(), state=cs.host_state())
    print(json.dumps(result))
    return 0 if result["ok"] else 1


def f32_plain_err() -> float:
    """How far the scan's plain version in f32 on the CPU lies from the
    same in f64 at the tiny cell's inputs (the yardstick the kernel cell
    now takes): ~1e-6 where the host's f32 einsums are sound."""
    from repro_torch.core.kernel_cell import KERNELS
    from repro_torch.core.params import default_config
    from repro_torch.kernels.ssm_scan import ops, ref
    spec = KERNELS["ssm_scan"]
    _, args = spec.build(spec.shapes["tiny"], default_config(),
                         torch.device("cuda"))
    cpu = [a.cpu() for a in args]
    f32 = ref.ssm_scan_tiled(*cpu, ops.KERNEL_CHUNK)
    f64 = ref.ssm_scan_tiled(*(a.double() for a in cpu), ops.KERNEL_CHUNK,
                             dtype=torch.float64)
    return max(float((a.double() - b).abs().max()) for a, b in zip(f32, f64))


def fresh(minutes: float, rebuild: bool, out_dir: pathlib.Path) -> int:
    """Fresh processes one after another until ``minutes`` have passed."""
    out_dir.mkdir(parents=True, exist_ok=True)
    deadline = time.time() + 60 * minutes
    runs, failures, errs, plain = [], [], {}, {}
    n = 0
    while time.time() < deadline:
        mode = "full" if n % 2 == 0 else "scan"
        t0 = time.time()
        done = subprocess.run(
            [sys.executable, __file__, "--child", mode]
            + (["--rebuild"] if rebuild else []),
            capture_output=True, text=True, cwd=ROOT)
        lines = done.stdout.splitlines()
        result = json.loads(lines[-1]) if lines and \
            lines[-1].startswith("{") else {"ok": False}
        sides = [json.loads(x) for x in lines
                 if x.startswith('{"phase": "kernel_cells_side"')]
        runs.append({"n": n, "mode": mode, "rc": done.returncode,
                     "s": round(time.time() - t0, 1),
                     "err": result.get("ssm_scan_tiny_err"),
                     "f32_plain_err": result.get("f32_plain_err"),
                     "rebuilt": rebuild, "state": result.get("state")})
        if done.returncode or not result.get("ok") or sides:
            failures.append({"n": n, "mode": mode, "result": result,
                             "sides": sides,
                             "stderr": done.stderr[-2000:]})
            (out_dir / f"process-{n}.log").write_text(
                done.stdout + "\n--- stderr\n" + done.stderr)
        if result.get("f32_plain_err") is not None:
            plain[str(result["f32_plain_err"])] = plain.get(
                str(result["f32_plain_err"]), 0) + 1
        if result.get("ssm_scan_tiny_err") is not None:
            errs[str(result["ssm_scan_tiny_err"])] = errs.get(
                str(result["ssm_scan_tiny_err"]), 0) + 1
        n += 1
    print(json.dumps({"processes": n, "rebuild": rebuild,
                      "failed": len(failures),
                      "ssm_scan_tiny_errs": errs,
                      "f32_plain_errs": plain, "failures": failures,
                      "runs": runs}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--poisoned", type=int, default=20)
    ap.add_argument("--fresh-minutes", type=float, default=None,
                    help="start fresh processes for this many minutes")
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "results" / "kernel_cells_fresh",
                    help="with --fresh-minutes: where failed processes' "
                         "logs go")
    ap.add_argument("--rebuild", action="store_true",
                    help="with --fresh-minutes: each process compiles the "
                         "kernels itself")
    ap.add_argument("--child", choices=("full", "scan"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_cells_repeat: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.child:
        return child(args.child, args.rebuild)
    if args.fresh_minutes:
        return fresh(args.fresh_minutes, args.rebuild, args.out)
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
                if name == "ssm_scan":
                    cs.assert_sync_zero(f"{name}:{shape_name}")
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
