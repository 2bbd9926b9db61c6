"""The measured wall-clock tier.

The paper's whole method is trial-and-error over a *small number of
real experimental runs*; this module is where those few real runs live.
After a cell's walk, the campaign's re-rank pass
(``Campaign(measure_top_k=k)``) re-evaluates the top-k surviving
configs of the cell and publishes the measured winner.

This is the PyTorch port's copy of the reference's ``core/measure.py``:

  * :class:`TimingCache` — the disk-backed timing memo, an instance of
    the two-level :class:`~repro_torch.core.trial.CompileCache` under
    the port's own ``results/torch/trials/timings``.  Keys cover the
    *full* config dict: a measured time depends on every knob.
  * :class:`CachedMeasure` — wraps any measured evaluator with the
    timing cache: a cache hit returns the stored cost with
    ``cached=True, compiles=0``; a memoized deterministic crash is
    re-raised with its stored failure class.
  * :func:`select_top_k` / :func:`default_measured_evaluator` — the
    re-rank candidate selection over a cell's trial log, and the
    measured tier's default evaluator: kernel cells time their
    hand-written kernel on the card (core/kernel_cell.py), serve cells
    replay their trace again (serving/evaluator.py), step cells run the
    reduced wall-clock proxy, :class:`ReducedWallClock`.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import pathlib
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.params import TunableConfig
from repro_torch.core.trial import (CACHE_DIR, CompileCache, TrialResult,
                                    Workload)

#: bump when the measured protocol changes (invalidates stored timings)
MEASURE_VERSION = "measure-v1"

TIMING_DIR = CACHE_DIR / "timings"


# ------------------------------------------------------------ the cache
class TimingCache(CompileCache):
    """Disk-backed measured-timing memo, keyed like the compile cache
    (opaque per-cell strings, JSON values, atomic publish) but over the
    full-config measure key."""

    CACHE_KIND = "timing_cache"      # separate hit-rate in metrics.json

    def __init__(self, directory: Optional[pathlib.Path] = None,
                 mem_entries: int = 512, use_disk: bool = True):
        super().__init__(directory or TIMING_DIR, mem_entries, use_disk)


def measure_key(wl: Workload, rt: TunableConfig, repeats: int,
                tag: str = MEASURE_VERSION) -> str:
    """Cache key of one measured evaluation: the cell, the *full*
    config (every knob can move a wall clock), the repeat count and the
    protocol version tag."""
    blob = json.dumps([tag, wl.key(), int(repeats), rt.as_dict()],
                      sort_keys=True, default=str)
    h = hashlib.sha1(blob.encode()).hexdigest()[:16]
    return f"{wl.key()}__measured__{h}"


@functools.lru_cache(maxsize=None)
def _identity(device: str) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return f"cuda/{torch.cuda.get_device_name(dev)}"
    return dev.type


def device_identity(device) -> str:
    """What a measured cost was measured on, for the timing cache's
    keys: ``cpu``, or ``cuda/<the card's name>`` (``cuda`` where no card
    is present)."""
    return _identity(str(device))


class CachedMeasure:
    """Wrap a measured evaluator with the two-level timing cache.

    The wrapped callable keeps the evaluator contract ``(workload,
    config) -> TrialResult``, so it drops into a
    :class:`~repro_torch.core.executor.SweepExecutor` (deadline / retry /
    quarantine) unchanged.  Fresh evaluations pass through with their
    own accounting; cache hits cost nothing (``cached=True``,
    ``compiles=0``); memoized deterministic crashes are replayed with
    their stored failure class.
    """

    def __init__(self, evaluator: Callable, cache: Optional[TimingCache]
                 = None, repeats: Optional[int] = None,
                 tag: str = MEASURE_VERSION, device=None):
        self.evaluator = evaluator
        self.cache = cache if cache is not None else TimingCache()
        self.repeats = repeats if repeats is not None \
            else int(getattr(evaluator, "repeats", 0))
        self.tag = tag
        # the device the wrapped evaluator measures on (its own
        # ``device`` unless given): part of every key
        self.device = device if device is not None \
            else getattr(evaluator, "device", None)

    def _tag(self, tag: str) -> str:
        if self.device is None:
            return tag
        return f"{tag}:{device_identity(self.device)}"

    def _key(self, wl: Workload, rt: TunableConfig) -> str:
        """Cache-key hook: subclasses fold extra identity into the key
        (the serve tier adds the trace's content hash)."""
        return measure_key(wl, rt, self.repeats, self._tag(self.tag))

    def __call__(self, wl: Workload, rt: TunableConfig) -> TrialResult:
        key = self._key(wl, rt)
        fresh: List[TrialResult] = []

        def build() -> Dict:
            from repro_torch.core import telemetry as _telemetry
            with _telemetry.current().span("measure", cell=wl.key()):
                res = self.evaluator(wl, rt)
            fresh.append(res)
            if res.crashed:
                return {"error": res.error, "failure": res.failure,
                        "compile_s": res.compile_s}
            return {"cost_s": res.cost_s, "compile_s": res.compile_s,
                    "compiles": res.compiles}

        entry = self.cache.get_or_build(key, build)
        if fresh:                        # this call ran the evaluator
            return fresh[0]
        if "error" in entry:             # memoized deterministic crash
            return TrialResult(
                cost_s=float("inf"), crashed=True,
                error=entry["error"],
                failure=entry.get("failure", ""), cached=True)
        return TrialResult(cost_s=float(entry["cost_s"]), cached=True,
                           compiles=0, compile_s=0.0)


# ------------------------------------------------- re-rank candidates
def select_top_k(log: List[Any], k: int) -> List[Dict]:
    """The measured tier's candidate list: the k cheapest *distinct,
    surviving* (non-crashed) configs of a cell's trial log, by model
    cost, ties broken by log order.  Each entry is
    ``{"name", "config": TunableConfig, "model_cost_s"}`` —
    ``candidates[0]`` is the model's own ranking choice, which the
    measured winner may overturn."""
    from repro_torch.core.history import config_from_dict
    seen = set()
    entries: List[Dict] = []
    for e in log:
        d = e if isinstance(e, dict) else dataclasses.asdict(e)
        res = d.get("result") or {}
        if res.get("crashed"):
            continue
        ck = json.dumps(d.get("config"), sort_keys=True, default=str)
        if ck in seen:
            continue
        seen.add(ck)
        entries.append(d)
    entries.sort(key=lambda d: d["result"].get("cost_s", float("inf")))
    out = []
    for d in entries[:max(0, int(k))]:
        try:
            cfg = config_from_dict(d["config"])
        except (ValueError, TypeError, KeyError):
            continue                     # older knob space: skip cleanly
        out.append({"name": d.get("name", ""), "config": cfg,
                    "model_cost_s": d["result"].get("cost_s")})
    return out


# --------------------------------------- default measured evaluation
@dataclasses.dataclass
class _ProxyWorkload(Workload):
    """Same cell identity, reduced config + capped shape (the
    calibration-point idea applied to execution: measure the runnable
    proxy, rank by its real wall clock)."""
    seq_cap: int = 128
    batch_cap: int = 8

    @property
    def cfg(self):
        from repro_torch.configs import get_reduced
        return get_reduced(self.arch)

    @property
    def shp(self):
        from repro_torch.configs import get_shape
        base = get_shape(self.shape)
        return type(base)(f"measure_{base.name}",
                          min(base.seq_len, self.seq_cap),
                          min(base.global_batch, self.batch_cap),
                          base.kind)


class ReducedWallClock:
    """Hardened :class:`~repro_torch.core.trial.WallClockEvaluator` over
    each cell's reduced runnable proxy (the arch's reduced config, the
    shape capped at ``seq_cap`` and ``batch_cap``), on ``device``.  Keeps
    the cell's identity for keys/history; only the executed program is
    reduced."""

    def __init__(self, repeats: int = 3, seq_cap: int = 128,
                 batch_cap: int = 8, device="cuda"):
        from repro_torch.core.trial import WallClockEvaluator
        self.repeats = repeats
        self.seq_cap = seq_cap
        self.batch_cap = batch_cap
        self.device = device
        self._ev = WallClockEvaluator(None, repeats, device)

    def __call__(self, wl: Workload, rt: TunableConfig) -> TrialResult:
        proxy = _ProxyWorkload(wl.arch, wl.shape, wl.multi_pod,
                               seq_cap=self.seq_cap,
                               batch_cap=self.batch_cap)
        if proxy.shp.kind == "train" and rt.attn_impl == "pallas":
            # the kernels are forward-only (no backward): executed train
            # steps take attention through the eager path, as the
            # reference's do; the forward-only prefill/decode kinds keep
            # the real kernel
            rt = rt.replace(attn_impl="xla")
        return self._ev(proxy, rt)


def default_measured_evaluator(cache_dir: Optional[pathlib.Path] = None,
                               repeats: int = 3,
                               device="cuda") -> CachedMeasure:
    """The campaign's measured tier when none is injected: dispatch
    kernel cells to the kernel bench, serve cells to a trace replay and
    step cells to the reduced wall-clock proxy, all on ``device``; wrap
    everything in the disk-backed timing cache (``cache_dir`` defaults
    to the port's ``results/torch/trials/timings``)."""
    from repro_torch.core.kernel_cell import (KernelBenchEvaluator,
                                              is_kernel_workload)
    from repro_torch.serving.evaluator import ServeEvaluator
    step = ReducedWallClock(repeats=repeats, device=device)
    kern = KernelBenchEvaluator(repeats=repeats, device=device)
    # serve cells are *already* measured (the trial cost is a trace
    # replay): the re-rank pass replays the same trace, guard off
    serve = ServeEvaluator(device=device)

    def dispatch(wl: Workload, rt: TunableConfig) -> TrialResult:
        if is_kernel_workload(wl):
            return kern(wl, rt)
        if str(getattr(wl, "arch", "")).startswith("serve-"):
            return serve(wl, rt)
        return step(wl, rt)

    return CachedMeasure(dispatch, cache=TimingCache(cache_dir),
                         repeats=repeats, device=device)
