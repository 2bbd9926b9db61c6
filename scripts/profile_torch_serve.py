#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving path, on one GPU.

    python3 scripts/profile_torch_serve.py [--arch ARCH] [--out DIR]

Serves ``--arch`` (default smollm-135m; zamba2-7b for the hybrid path) at
full width and depth, random weights from a seed, bf16 compute,
hand-written kernels, at batch 4, prompt 1024: times one
prefill and a window of decode steps on the host clock (ending in a
synchronise), then traces the same work with ``torch.profiler`` and
prints, for the prefill and for the decode window, the device-busy share
(sum of kernel time over wall time) and the kernels by total device
time, and for the two attention wrappers, the scan and rmsnorm their
calls beside the device kernels they launched (one each: the prefill
attention kernel, the one-launch decode kernel, the scan's one kernel,
rmsnorm's one kernel) and those kernels' device time.  Needs a CUDA
device; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--out", default=None,
                    help="directory for profile.json (default: print only)")
    ap.add_argument("--kv-dtype", default="bfloat16")
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.params import default_config
    from repro_torch.models.model import build_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    rt = default_config(compute_dtype="bfloat16",
                        kv_cache_dtype=args.kv_dtype, attn_impl="pallas")
    model = build_model(cfg)
    # the f32 master tree is dropped once it has been cast
    params = model.cast_params(model.init(0, device="cuda"), rt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (4, 1024), generator=gen,
                           device="cuda", dtype=torch.int32)

    def prefill():
        return model.prefill_fn(params, {"tokens": tokens}, rt, max_seq=1088)

    def decode(cache, tok, n):
        for _ in range(n):
            logits, cache = model.decode_fn(params, cache, tok, rt)
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        return cache, tok

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.ssm_scan import ops as ssm
    wrappers = {"flash_attention": fa, "flash_decode": fd, "ssm_scan": ssm,
                "rmsnorm": rms}
    # the device kernels each wrapper launches, by symbol
    port_kernels = {"flash_attention": ("flash_tc_kernel",
                                        "flash_f32_kernel"),
                    "flash_decode": ("decode_kernel",),
                    "ssm_scan": ("ssd_kernel",),
                    # rmsnorm_rows and rmsnorm_staged; rmsnorm_kernel in
                    # trees before the width classes
                    "rmsnorm": ("rmsnorm_",)}

    def traced(fn):
        before = {n: m.launches for n, m in wrappers.items()}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, ms = wall(fn)
        rows = [(e.key, e.device_time_total / 1e3, e.count)
                for e in prof.key_averages() if e.device_time_total > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        per_call = {}
        for name, mod in wrappers.items():
            calls = mod.launches - before[name]
            hits = [(t, c) for k, t, c in rows
                    if any(sym in k for sym in port_kernels[name])]
            per_call[name] = {
                "wrapper_calls": calls,
                "device_kernels": sum(c for _, c in hits),
                "device_ms": sum(t for t, _ in hits),
                "device_ms_per_call": (sum(t for t, _ in hits) / calls
                                       if calls else None)}
        return {"wall_ms_traced": ms, "device_busy_ms": busy,
                "device_busy_share": busy / ms if ms else None,
                "attention_kernels": {k: per_call[k] for k in
                                      ("flash_attention", "flash_decode")},
                "ssm_scan_kernels": per_call["ssm_scan"],
                "rmsnorm_kernels": per_call["rmsnorm"],
                "kernels": [{"name": k[:90], "device_ms": t, "calls": c}
                            for k, t, c in rows[:12]]}

    with torch.no_grad():
        prefill()                                   # warm-up
        (logits, cache), prefill_ms = wall(prefill)
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        cache, tok = decode(cache, tok, 2)          # warm-up
        (cache, tok), decode_ms = wall(lambda: decode(cache, tok, args.steps))
        report = {
            "device": smi, "arch": cfg.name, "batch": 4, "prompt": 1024,
            "kv_cache": args.kv_dtype, "attn_impl": "pallas",
            "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms / args.steps,
            "decode_steps_timed": args.steps,
            "prefill_trace": traced(prefill),
            "decode_trace": traced(lambda: decode(cache, tok, args.steps)),
        }
    print(json.dumps(report, indent=1))
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"profile_{cfg.name}_{args.kv_dtype}.json").write_text(
            json.dumps(report, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
