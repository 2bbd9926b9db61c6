"""Small helpers the per-layer metric readers share."""
from __future__ import annotations

import math

from portbench import peaks


def host_ms(run, span: str):
    """Mean synchronised host ms of a layer's calls in the window."""
    xs = run.tracer.host_s.get(span)
    return 1e3 * sum(xs) / len(xs) if xs else None


def idle_pct(run):
    """The traced window's share with no device operation, in %."""
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu_pct(run):
    """Model FLOPs of the work completed over the traced window, as a
    share of the chip's bf16 peak, in %."""
    t = run.trace
    if not t or t["window_s"] <= 0 or not run.fig.get("model_flops"):
        return None
    return 100.0 * run.fig["model_flops"] / (t["window_s"] * peaks.MFU_PEAK)


def roofline_pct(run, span: str, count):
    """Summed least time over summed device time of a kernel wrapper's
    calls, in %.  ``count(call) -> (flops, bytes, dtype)`` from the
    call's argument shapes; None where the wrapper was not called or
    its calls and their device times do not pair up."""
    calls = run.tracer.calls.get(span, [])
    secs = (run.trace or {}).get("call_device_s", {}).get(span, [])
    if not calls or len(calls) != len(secs) or sum(secs) <= 0:
        return None
    least = sum(peaks.least_seconds(*count(c)) for c in calls)
    return 100.0 * least / sum(secs)


def nbytes(arg) -> int:
    """Bytes of an argument described by its shape and dtype."""
    size = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1,
            "int32": 4, "int64": 8}[arg["dtype"]]
    return size * math.prod(arg["shape"])
