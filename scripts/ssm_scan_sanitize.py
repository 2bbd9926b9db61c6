#!/usr/bin/env python3
"""Call the ``ssm_scan`` kernel a few times at two shapes, for a run
under ``compute-sanitizer``, on one GPU.

    python3 scripts/ssm_scan_sanitize.py [--calls N]
    compute-sanitizer --tool memcheck python3 scripts/ssm_scan_sanitize.py

The shapes: the tuner's tiny kernel cell (B 1, S 512, H 2, P = N = 8),
X f32, where the kernel pads P and N up to 64 inside the block and so
depends on the zero-fill of its copies; and (1, 1000, 112, 64, 64), X
bf16, zamba2-7b's heads at a ragged length.  Inputs are drawn on the CPU
from a seed and copied to the card, and the plain version runs on the
CPU, so the only kernels on the card are the scan and the zero-fill of
its sync buffer.  Every call's outputs are held bit for bit against the
first call's and against the plain version at the kernel's chunk (Y at
its dtype's tolerance, h_final at f32's 1e-4).  Prints one JSON line,
then the card's name and power limit; exits 1 if a check failed.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

CASES = (((1, 512, 2, 8, 8), torch.float32, 128),
         ((1, 1000, 112, 64, 64), torch.bfloat16, 256))
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}   # tests/test_kernels.py


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssm_scan_sanitize: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.ssm_scan import ops, ref
    gen = torch.Generator()
    gen.manual_seed(0)
    rows, ok = [], True
    for (B, S, H, P, N), xdtype, chunk in CASES:
        ins = cs.ssm_inputs(gen, B, S, H, P, N, xdtype)
        Yp, hp = ref.ssm_scan_tiled(*ins, ops.KERNEL_CHUNK)
        dev = [t.cuda() for t in ins]
        first, errs, changed = None, [], 0
        for _ in range(args.calls):
            Y, h = (t.cpu() for t in ops.ssm_scan(*dev, chunk=chunk))
            if first is None:
                first = (Y, h)
            changed += not (torch.equal(Y, first[0])
                            and torch.equal(h, first[1]))
            finite = bool(torch.isfinite(Y.float()).all()
                          and torch.isfinite(h).all())
            err_y = cs.max_err(Y, Yp)
            err_h = cs.max_err(h, hp)
            errs.append([err_y, err_h])
            ok &= finite and err_y <= TOL[xdtype] * (1 + float(
                Yp.float().abs().max())) and err_h <= TOL[torch.float32] * (
                1 + float(hp.abs().max()))
        ok &= changed == 0
        rows.append({"shape": [B, S, H, P, N], "x_dtype": str(xdtype),
                     "calls": args.calls, "changed_from_first": changed,
                     "max_abs_err_y_h": errs})
    torch.cuda.synchronize()
    print(json.dumps({"ssm_scan_sanitize": rows, "ok": ok}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
