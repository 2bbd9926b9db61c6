#!/usr/bin/env python3
"""Time another tree's prefill kernels at shapes its own chip_smoke.py
does not time, through the public wrappers, on one GPU.

    python3 scripts/time_prefill_kernels.py --src DIR [--kernels rmsnorm]

Imports ``repro_torch`` from ``DIR`` (say the ``src`` of a ``git
archive`` of the parent commit) and times its ``ssm_scan``,
``flash_attention`` and ``rmsnorm`` with this checkout's
``chip_smoke.py`` timer, inputs and repeat counts, so the figures stand
beside that script's; rmsnorm at every shape of ``chip_smoke.RMSNORM_TIMED``
with ``chip_smoke.rmsnorm_timed`` (device and host call-to-call times).
Uses only the wrappers' public signatures, which every tree of the port
shares.  Beside attention and rmsnorm, the time of one PyTorch call
computing the same function, TF32 switched off.  Prints one JSON object
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

SCAN = ((4, 1024, torch.bfloat16), (4, 1024, torch.float32),
        (1, 1024, torch.bfloat16), (4, 1000, torch.bfloat16),
        (4, 997, torch.bfloat16), (4, 919, torch.bfloat16),
        (4, 746, torch.bfloat16))
ATTENTION = (((4, 1024, 9, 64), torch.float32),
             ((4, 1024, 32, 112), torch.float32),
             ((4, 919, 32, 112), torch.float32),
             ((4, 746, 32, 112), torch.float32),
             ((4, 1024, 9, 64), torch.bfloat16),
             ((4, 1024, 32, 112), torch.bfloat16))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of the tree to time")
    ap.add_argument("--kernels", default="ssm_scan,flash_attention,rmsnorm",
                    help="comma-separated kernels to time (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_prefill_kernels: no CUDA device", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.ssm_scan import ops as ssm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    rows = []
    only = set(args.kernels.split(","))
    for B, S, xdtype in SCAN if "ssm_scan" in only else ():
        ins = cs.ssm_inputs(gen, B, S, 112, 64, 64, xdtype)   # zamba2-7b
        rows.append({"kernel": "ssm_scan", "B": B, "S": S, "H": 112,
                     "P": 64, "N": 64, "chunk": 256, "x_dtype": str(xdtype),
                     "ms": cs.time_ms(lambda: ssm.ssm_scan(*ins, chunk=256),
                                      iters=10)})
        del ins
    for shape, dtype in ATTENTION if "flash_attention" in only else ():
        q, k, v = (cs._randn(gen, shape, dtype) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        rows.append({
            "kernel": "flash_attention", "shape": list(shape),
            "dtype": str(dtype), "tiles": [128, 128],
            "ms": cs.time_ms(lambda: fa.flash_attention(q, k, v), iters=10),
            "library_ms": cs.time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True), iters=10)})
        del q, k, v, qt, kt, vt
    for n, d, dtype in cs.RMSNORM_TIMED if "rmsnorm" in only else ():
        rows.append({"kernel": "rmsnorm",
                     **cs.rmsnorm_timed(gen, rms, n, d, dtype)})
    print(json.dumps({"device": cs.nvidia_smi(), "src": str(src),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
