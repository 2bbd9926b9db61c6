"""The fabric's synthetic surfaces for the port's worker processes.

``benchmarks/fabric_surface.py`` and ``benchmarks/chaos_surface.py``
import the reference's ``TrialResult`` and with it jax; a worker of the
port imports neither.  This module gives the same costs
(:func:`surface_cost`, held against the reference's by
``tests/test_torch_fabric.py``) as the port's ``TrialResult``, and the
two ``--evaluator`` factories the fabric's tests spawn workers with:
:func:`make_evaluator` (``FABRIC_SURFACE_SLEEP_S``,
``FABRIC_SURFACE_LEDGER``) and :func:`make_chaos_evaluator`
(``CHAOS_KILL_DELTA``, ``CHAOS_KILL_DELAY_S``, ``CHAOS_LEDGER``), read
from the environment as the reference's surfaces read them.
"""
from __future__ import annotations

import json
import os
import signal
import time

from repro_torch.core.trial import TrialResult


def surface_cost(wl, rt) -> TrialResult:
    """``benchmarks.fabric_surface.surface_cost``, as the port's result."""
    kind = wl.shp.kind
    c = 100.0 * (1.0 + 0.01 * (len(wl.arch) % 7))
    if rt.compute_dtype == "bfloat16":
        c *= 0.72
    if rt.shard_strategy == "tp":
        c *= 1.15
    if rt.shard_strategy == "fsdp":
        c *= 1.10
    if kind == "train":
        if rt.remat_policy == "none":
            c *= 0.84
        if rt.remat_policy == "full":
            c *= 1.20
        if rt.microbatches == 2:
            c *= 0.93
        if rt.grad_comm_dtype == "bfloat16":
            c *= 0.99
    else:
        if rt.kv_cache_dtype == "int8":
            c *= 0.85
    if rt.attn_block_q == 256:
        c *= 0.92
    return TrialResult(cost_s=round(c, 6))


def _append(ledger, wl, rt) -> None:
    """One ``{"cell", "config"}`` line per evaluation (one write)."""
    line = json.dumps({"cell": wl.key(), "config": rt.as_dict()},
                      sort_keys=True) + "\n"
    fd = os.open(ledger, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, line.encode())
    finally:
        os.close(fd)


def make_evaluator():
    """Zero-arg factory (the ``--evaluator`` contract)."""
    sleep_s = float(os.environ.get("FABRIC_SURFACE_SLEEP_S", "0") or "0")
    ledger = os.environ.get("FABRIC_SURFACE_LEDGER")

    def evaluate(wl, rt) -> TrialResult:
        if ledger:
            _append(ledger, wl, rt)
        if sleep_s > 0:
            time.sleep(sleep_s)
        return surface_cost(wl, rt)
    return evaluate


def make_chaos_evaluator():
    """Zero-arg factory: a config matching every ``knob=value`` pair of
    ``CHAOS_KILL_DELTA`` SIGKILLs its own process after
    ``CHAOS_KILL_DELAY_S`` (default 0.05 s, for the quarantine's intent
    record to land); every evaluation is first appended to
    ``CHAOS_LEDGER``."""
    kill = [tuple(item.strip().split("=", 1))
            for item in os.environ.get("CHAOS_KILL_DELTA", "").split(",")
            if item.strip()]
    delay = float(os.environ.get("CHAOS_KILL_DELAY_S", "0.05") or "0.05")
    ledger = os.environ.get("CHAOS_LEDGER")

    def evaluate(wl, rt) -> TrialResult:
        if ledger:
            _append(ledger, wl, rt)
        if kill and all(str(getattr(rt, k)) == v for k, v in kill):
            time.sleep(delay)
            os.kill(os.getpid(), signal.SIGKILL)
        return surface_cost(wl, rt)
    return evaluate
