"""A serving cell: the port's ``BatchScheduler`` under a traffic mix.

Set-up builds the model's weights on the device from the seed (as they
are served: matrices in bf16), hands them to
``repro_torch.serving.scheduler.BatchScheduler`` (waves of the mix's
width, padded to that many lanes and to the mix's longest prompt, as the
tuner's serve evaluator builds it), and serves one wave of the window's
own shapes to warm every kernel.  The window then drives ``submit`` and
``run_wave`` over a backlog (``traffic``): every request is due at the
window's start, waves start until ``--seconds`` have passed, and the
last one to start is served to its end.

For the waves the judge checks (the mix's ``judge``: so many whole waves
drawn from the seed among the window's first few), a wrapper around the
scheduler's ``_prefill`` and ``_decode`` keeps a float32 copy of the
last-position logits each step returns, the logits each served token
is the argmax of.  Afterwards those waves' requests are judged against
the plain reference (``judge``).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import judge, modelflops, traffic, weights


def build(ctx):
    """The scheduler with its weights, warmed on the window's shapes."""
    from repro_torch.serving.scheduler import BatchScheduler, Request
    mix, arch = ctx.mix, ctx.arch
    model = ctx.model
    w = weights.make(model.param_shapes(), ctx.config["init"], ctx.seed,
                     ctx.device, torch.bfloat16)
    pad_to, out_hi = int(mix["pad_to"]), int(mix["output"][1])
    sched = BatchScheduler(ctx.cfg, ctx.rt, w, wave_size=int(mix["wave"]),
                           max_seq=pad_to + out_hi + 2, max_wait_s=0.0,
                           pad_to=pad_to, pad_wave=True, device=ctx.device)
    del w
    rng = np.random.RandomState(traffic.sub_seed(ctx.seed, "warm"))
    for i in range(sched.wave_size):
        sched.submit(Request(rid=-1 - i, tokens=rng.randint(
            1, arch["vocab"], size=pad_to).astype(np.int32),
            max_new_tokens=out_hi, t_submit=0.0))
    sched.run_wave()
    return sched


class _Keep:
    """Keeps the last-position logits that the timed path returns, in
    the waves the judge checks, and nothing in the others."""

    def __init__(self, sched, waves):
        self.waves, self.wave = waves, -1
        self.rows: Dict[int, List[torch.Tensor]] = {}
        for attr in ("_prefill", "_decode"):
            setattr(sched, attr, self._wrap(getattr(sched, attr)))

    def _wrap(self, inner):
        def call(*args, **kw):
            logits, cache = inner(*args, **kw)
            if self.wave in self.waves:
                self.rows.setdefault(self.wave, []).append(
                    logits[:, -1].to(torch.float32, copy=True))
            return logits, cache
        return call


def judged_waves(mix, seed: int) -> List[int]:
    """The waves the judge checks: ``judge.waves`` of the first
    ``judge.among_first``, drawn from the seed."""
    j = mix["judge"]
    rng = np.random.RandomState(traffic.sub_seed(seed, "judge"))
    return sorted(rng.choice(int(j["among_first"]), size=int(j["waves"]),
                             replace=False).tolist())


def window(ctx, sched) -> Dict[str, Any]:
    """Serve the mix for ``ctx.seconds``; returns what happened."""
    from repro_torch.serving.scheduler import Request
    tr = ctx.tracer
    vocab = ctx.arch["vocab"]
    tr.layer(sched, "_prefill", "pb.prefill")
    tr.layer(sched, "_decode", "pb.decode")
    reqs = traffic.requests(ctx.mix, ctx.seed)
    prompts = {r.rid: traffic.prompt_tokens(r, vocab) for r in reqs}
    waves: List[Dict[str, Any]] = []
    keep = _Keep(sched, set(judged_waves(ctx.mix, ctx.seed)))
    ctx.sync()
    tr.start()
    t0 = time.time()
    for r in reqs:
        sched.submit(Request(rid=r.rid, tokens=prompts[r.rid],
                             max_new_tokens=r.max_new, t_submit=t0))
    while sched.queue and time.time() < t0 + ctx.seconds:
        wave_t0 = time.time()
        keep.wave = len(waves)
        with tr.span("pb.wave"):
            done = sched.run_wave()
        waves.append({"t0": wave_t0, "t1": time.time(), "requests": done})
    tr.stop()
    if not sched.queue:
        ctx.note("the backlog drained inside the window")
    return {"t0": t0, "waves": waves, "kept": keep.rows,
            "pad_to": int(ctx.mix["pad_to"])}


def figures(ctx, w: Dict[str, Any]) -> Dict[str, Any]:
    """End-to-end figures and the per-layer readers' inputs: useful
    tokens (real prompt tokens and generated tokens, no padding) of every
    wave over the time from the window's start to the last wave's end."""
    served = [r for wave in w["waves"] for r in wave["requests"]]
    useful = sum(len(r.tokens) + len(r.generated) for r in served)
    span = (w["waves"][-1]["t1"] - w["t0"]) if w["waves"] else 0.0
    terms = ctx.reference.flops_terms(ctx.arch)
    flops = sum(modelflops.served(terms, len(r.tokens), len(r.generated))
                for r in served)
    ctx.note(f"window: {len(w['waves'])} waves in {span:.3f} s")
    return {"served": served, "useful_tokens": useful,
            "model_flops": flops, "span_s": span, "waves": len(w["waves"]),
            "e2e": {"serve_tok_s": useful / span if span > 0 else None},
            "attempted": len(served), "failed": 0}


def check(ctx, w: Dict[str, Any], fig: Dict[str, Any]) -> Dict[str, float]:
    """The numbers to compare, over every request of the judged waves
    that the window finished: each with its prompt, its served tokens
    and the logits that served them."""
    rows, judged = [], sorted(w["kept"])
    for i, steps in sorted(w["kept"].items()):
        for lane, r in enumerate(w["waves"][i]["requests"]):
            n = len(r.generated)
            rows.append((r.tokens, r.generated,
                         torch.stack([s[lane] for s in steps[:n]])))
    w["kept"].clear()
    ctx.judged_rows = rows
    ctx.note(f"judged {len(rows)} requests in waves {judged}, "
             f"{sum(len(g) for _, g, _ in rows)} served tokens")
    return judge.served_gap(ctx, rows, w["pad_to"])
