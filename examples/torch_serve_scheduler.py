"""Batched serving through the port's wave scheduler: submit a mixed
queue of variable-length requests, report TTFT and decode throughput.

    PYTHONPATH=src python examples/torch_serve_scheduler.py [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.core.params import default_config
from repro_torch.models.model import build_model, resolve_device
from repro_torch.serving.scheduler import BatchScheduler, Request


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_reduced("glm4-9b")
    rt = default_config(compute_dtype="bfloat16", kv_cache_dtype="int8",
                        attn_impl="pallas")
    params = build_model(cfg).init(0, device=device)
    sched = BatchScheduler(cfg, rt, params, wave_size=4, max_seq=96,
                           device=device)

    rng = np.random.RandomState(0)
    for rid in range(10):
        n = int(rng.randint(8, 48))
        sched.submit(Request(rid=rid,
                             tokens=rng.randint(1, 500, n).astype(np.int32),
                             max_new_tokens=12))
    done = sched.run_until_drained()
    for r in done[:4]:
        print(f"req {r.rid}: prompt {len(r.tokens):2d} tok -> "
              f"{len(r.generated):2d} new, ttft {r.ttft_s*1e3:7.1f} ms")
    print("metrics:", sched.metrics.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
