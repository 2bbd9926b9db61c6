"""Spans and the device trace of a ``--trace 1`` run.

The spans are the benchmark's own: host-clock intervals (``time.time_ns``)
taken around the calls into the program's layers by wrapping them from
here (the scheduler's ``_prefill`` and ``_decode`` on the instance, the
kernel wrappers' functions on their modules) and around the window's own
steps, for the traced window only.  A layer call's host time is taken
with a synchronise after it.  Each kernel wrapper's call keeps the
shapes and dtypes of its tensor arguments, for the roofline readers.

``torch.profiler`` traces the window with CUDA activity alone: the
device operations and the runtime calls that launched them.  CPU
activity (and with it ``record_function`` ranges) is left off, since it
records every op on the host and slowed a host-paced decode step
more than twofold.  The trace's timestamps and ``time.time_ns`` are both
the Unix clock in ns, so the reduction matches them: device operations
inside the window's span, their union (``busy_s``), the device time of
the kernels each wrapped call launched (a device operation belongs to
the call whose span holds the runtime call on the host that shares its
correlation id: ``cudaLaunchKernel``, ``cuLaunchKernelEx``, ...), the
operations by total time, and the idle gaps between device operations
by the innermost host span at the gap's start.
"""
from __future__ import annotations

import bisect
import collections
import functools
import time
from typing import Any, Dict, List, Optional

import torch

WINDOW = "pb.window"
# host spans that say what the host was doing in an idle gap, innermost
# first; a gap in none of them is the window's own
HOST_SPANS = ("pb.prefill", "pb.decode", "pb.wave")


def _describe(a) -> Optional[Dict[str, Any]]:
    if torch.is_tensor(a):
        return {"shape": tuple(a.shape), "dtype": str(a.dtype)
                .replace("torch.", "")}
    return None


class Tracer:
    """Wraps layer calls with spans while ``active``; off, it wraps
    nothing and costs nothing."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = torch.device(device)
        self.active = False
        self.spans: Dict[str, List] = collections.defaultdict(list)
        self.calls: Dict[str, List[Dict]] = collections.defaultdict(list)
        self.host_s: Dict[str, List[float]] = collections.defaultdict(list)
        self._undo: List = []
        self.wrapped = set()
        self.prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------------- wrapping
    def _wrap(self, owner, attr: str, span: str, timed: bool,
              keep_args: bool):
        if not self.enabled:
            return
        inner = getattr(owner, attr)

        @functools.wraps(inner)
        def call(*args, **kw):
            if not self.active:
                return inner(*args, **kw)
            if keep_args:
                self.calls[span].append(
                    {"args": [_describe(a) for a in args],
                     "kw": {k: v for k, v in kw.items()
                            if isinstance(v, (int, float, bool, str))}})
            t0 = time.time_ns()
            out = inner(*args, **kw)
            if timed:
                self._sync()
            t1 = time.time_ns()
            self.spans[span].append((t0, t1))
            if timed:
                self.host_s[span].append((t1 - t0) / 1e9)
            return out

        setattr(owner, attr, call)
        self._undo.append((owner, attr, inner))
        self.wrapped.add(span)

    def layer(self, owner, attr: str, span: str):
        """A layer call: a span and its synchronised host time."""
        self._wrap(owner, attr, span, timed=True, keep_args=False)

    def kernel(self, module, fn: str, span: str):
        """A kernel wrapper's function: a span and its arguments."""
        self._wrap(module, fn, span, timed=False, keep_args=True)

    def span(self, name: str):
        """A plain host span (no synchronise)."""
        return _Span(self, name) if self.enabled and self.active else _NULL

    def restore(self):
        for owner, attr, inner in reversed(self._undo):
            setattr(owner, attr, inner)
        self._undo.clear()

    # ---------------------------------------------------------- profiling
    def warm(self):
        """One short trace in set-up: the profiler's first start pays
        for its own initialisation there, not in the window."""
        if not self.enabled:
            return
        with _profile():
            torch.ones(8, device=self.device).sum().item()

    def start(self):
        if self.enabled:
            self.prof = _profile()
            self.prof.__enter__()
            self.active = True
            self._w0 = time.time_ns()

    def stop(self):
        if self.enabled and self.active:
            self._sync()
            self.spans[WINDOW] = [(self._w0, time.time_ns())]
            self.active = False
            t = time.perf_counter()
            self.prof.__exit__(None, None, None)
            self.stop_s = time.perf_counter() - t
            self.restore()


class _Span:
    def __init__(self, tracer: Tracer, name: str):
        self.tracer, self.name = tracer, name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.tracer.spans[self.name].append((self.t0, time.time_ns()))
        return False


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def _profile():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() \
        else [ProfilerActivity.CPU]
    return profile(activities=acts)


# ------------------------------------------------------------- reduction
def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class _Intervals:
    """Sorted, non-overlapping intervals of one span name."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _ in self.spans]

    def find(self, t) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.spans[i][1]:
            return i
        return -1


def reduce(tracer: Tracer) -> Dict[str, Any]:
    """The traced window's figures: ``window_s``, ``busy_s``, per span
    name the device seconds of each call (``call_device_s``), the device
    operations by time, the idle gaps by host span, and counts that show
    how the kernels were matched."""
    from torch.autograd import DeviceType
    events = tracer.prof.profiler.kineto_results.events()
    spans = tracer.spans
    launch_at = {}
    ops = []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.name().startswith("cu"):
                # a runtime or driver call (cudaLaunchKernel,
                # cuLaunchKernelEx, cudaMemcpyAsync, ...)
                launch_at[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation():
            ops.append((e.start_ns(), e.end_ns(), e.name(),
                        e.correlation_id()))
    (w0, w1), = spans[WINDOW]
    ops = [o for o in ops if o[1] > w0 and o[0] < w1]
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _, _ in ops])
    by_name = collections.Counter()
    for s, e, name, _ in ops:
        by_name[name] += (e - s) / 1e9
    # each wrapped call's device seconds, by the span that launched them
    call_device_s = {}
    matched = collections.Counter()
    for name, ivs in spans.items():
        if name == WINDOW or name in HOST_SPANS:
            continue
        iv = _Intervals(ivs)
        secs = [0.0] * len(iv.spans)
        for s, e, _, corr in ops:
            t = launch_at.get(corr)
            if t is None:
                continue
            i = iv.find(t)
            if i >= 0:
                secs[i] += (e - s) / 1e9
                matched[name] += 1
        call_device_s[name] = secs
    # idle gaps, named by the innermost host span at the gap's start
    hosts = [(n, _Intervals(spans.get(n, []))) for n in HOST_SPANS]
    gaps = collections.Counter()
    edges = [w0] + [t for b in busy for t in b] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        where = next((n for n, iv in hosts if iv.find(g0) >= 0), WINDOW)
        gaps[where] += (g1 - g0) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "call_device_s": call_device_s,
        "device_ops": [[n[:120], s] for n, s in by_name.most_common(10)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
        "ops_in_window": len(ops),
        "launches": len(launch_at),
        "ops_matched": dict(matched),
        "spans": {n: len(v) for n, v in spans.items()},
    }
