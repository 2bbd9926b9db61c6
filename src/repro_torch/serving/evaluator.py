"""ServeCell / ServeEvaluator — traffic-replay trials as campaign cells.

The paper's claim is that a handful of trial-and-error runs on the
*real workload* beats tuning a model of it; this module makes the real
workload the serving path itself.  A ``serve:<arch>:<trace>`` cell
replays one registered traffic trace (serving/traffic.py) through the
wave scheduler (serving/scheduler.py) under each candidate config and
scores a scalar cost from TTFT / decode throughput / p95 queue delay —
the campaign / strategy / fabric / quarantine / measured-tier machinery
runs unchanged on top.

Structure mirrors core/kernel_cell.py (the new-cell-kind template):

  * :class:`ServeCell` is a :class:`~repro_torch.core.campaign.CellSpec` whose
    ``arch`` is ``serve-<arch>`` and whose shape is the trace name, so
    cell keys stay three ``__``-separated parts and every checkpoint /
    lease / report path behaves identically;
  * the serving knobs (``max_wave_size`` / ``wave_admission``) are
    SPACE entries with ``tunable=False, reach="analytic"`` — only serve
    cells propose deltas on them (:func:`serve_stages`), so DOMAINS,
    sweeps, compile keys and every non-serving strategy decision stay
    byte-identical to the pre-serving code;
  * replay uses a **virtual clock**: requests carry the trace's virtual
    arrival times, the clock advances by each wave's measured wall
    time, and queue delay is virtual-arrival vs virtual-wave-start.
    Served order is the trace's FIFO arrival order on every host
    (the determinism the fabric needs); the *cost* is a measured wall
    quantity and is cached behind the existing TimingCache policy
    (:class:`CachedServe` folds the trace's content key into the cache
    key, so two fabric workers always agree on what a cached cost
    means);
  * with an SLO guard (``--slo-ttft``), candidate replays shadow the
    stream: the guard watches every served request and aborts the trial
    as a **deterministic crash** (serving/canary.py) the moment TTFT or
    queue delay regresses past the threshold vs the incumbent — the
    trace is never finished under a bad config, and the quarantine
    ledger records the abort like any other deterministic failure.

This is the PyTorch port's copy of the reference's
``serving/evaluator.py``: cells, stages, the virtual clock and the cost
formula are the reference's.  A replay runs the port's scheduler on
``device`` (the card unless the caller asks for the CPU), holds the
device's lock (core/trial.hold_device) while it builds, warms up and
times the trial, and synchronises the device around every timed wave so
a wave's wall time holds that wave's device work.  A ``serve:`` cell
replays the arch's reduced config, as in the reference, unless its
trace says otherwise: a :class:`~repro_torch.serving.traffic.TraceSpec`
with ``full_width`` (``poisson_card``) replays the published config at
full width and depth, and one with ``replays`` > 1 is replayed that
many times a trial on one scheduler, the median replay's cost being the
trial's.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.core import telemetry as _telemetry
from repro_torch.core.campaign import CellSpec
from repro_torch.core.measure import CachedMeasure, TimingCache, measure_key
from repro_torch.core.params import TunableConfig, default_config
from repro_torch.core.space import SPACE
from repro_torch.core.tree import Stage
from repro_torch.core.trial import (FAILURE_DETERMINISTIC, TrialError,
                                    TrialResult, Workload,
                                    classify_exception, hold_device)
from repro_torch.models.model import build_model, resolve_device
from repro_torch.serving.traffic import (TRACE_SPECS, Trace, get_trace,
                                         request_tokens)

SERVE_ARCH_PREFIX = "serve-"

#: bump when the replay protocol / cost formula changes (invalidates
#: cached trace costs)
SERVE_MEASURE_VERSION = "serve-v1"

# scalar-cost weights: mean TTFT is what a user feels first, p95 queue
# delay is the tail the SLO protects, mean decode seconds per request
# is the throughput term (tokens / measured decode rate)
W_TTFT, W_P95_QDELAY, W_DECODE = 1.0, 0.5, 1.0


def is_serve_workload(wl: Any) -> bool:
    return str(getattr(wl, "arch", "")).startswith(SERVE_ARCH_PREFIX)


# ---------------------------------------------------------------- cells
@dataclasses.dataclass
class ServeWorkload(Workload):
    """A serve cell's workload: cell identity is (serve-<arch>, trace);
    ``cfg`` is the arch's *reduced* config (the replay actually runs,
    on CPU in CI), or its published config where the trace's spec asks
    for full width, and ``shp`` is derived from the trace geometry."""

    @property
    def base_arch(self) -> str:
        return self.arch[len(SERVE_ARCH_PREFIX):]

    @property
    def cfg(self):
        from repro_torch.configs import get_config, get_reduced
        if getattr(TRACE_SPECS.get(self.shape), "full_width", False):
            return get_config(self.base_arch)
        return get_reduced(self.base_arch)

    @property
    def shp(self) -> ShapeConfig:
        tr = get_trace(self.shape)
        seq = tr.max_prompt_len() + tr.max_new_tokens() + 2
        return ShapeConfig(self.shape, seq, len(tr.requests), "serve")


@dataclasses.dataclass(frozen=True)
class ServeCell(CellSpec):
    """One (arch, trace) serving cell.  ``arch`` is ``serve-<arch>`` so
    cell keys keep the three-part ``arch__shape__mesh`` layout."""

    @property
    def base_arch(self) -> str:
        return self.arch[len(SERVE_ARCH_PREFIX):]

    def workload(self) -> ServeWorkload:
        return ServeWorkload(self.arch, self.shape, self.multi_pod)

    def spec(self) -> str:
        return f"serve:{self.base_arch}:{self.shape}"


def serve_cell(arch: str, trace: str) -> ServeCell:
    from repro_torch.configs import list_archs
    from repro_torch.serving.traffic import trace_names
    if arch not in list_archs():
        raise ValueError(f"unknown arch {arch!r} "
                         f"(known: {', '.join(list_archs())})")
    if trace not in trace_names():
        raise ValueError(f"unknown trace {trace!r} "
                         f"(known: {', '.join(trace_names())})")
    return ServeCell(SERVE_ARCH_PREFIX + arch, trace, False)


def parse_serve_cell(item: str) -> ServeCell:
    """Parse one ``serve:<arch>:<trace>`` cell spec (the string
    :meth:`ServeCell.spec` emits and the fabric round-trips)."""
    parts = item.strip().split(":")
    if len(parts) != 3 or parts[0] != "serve":
        raise ValueError(f"bad serve cell spec {item!r} "
                         "(want serve:<arch>:<trace>)")
    return serve_cell(parts[1], parts[2])


#: the knobs a serve cell's stage tree proposes deltas on — the serving
#: infrastructure knobs plus the step knobs that provably reach the
#: scheduler's prefill/decode path
SERVE_KNOBS = ("max_wave_size", "wave_admission", "kv_cache_dtype",
               "donate_buffers", "compute_dtype")


def serve_signature(arch: str, shape: str, multi_pod: bool = False
                    ) -> Dict:
    """Warm-start similarity features for a serve cell (counterpart of
    :func:`repro_torch.core.history.cell_signature`)."""
    from repro_torch.configs import get_config
    base = arch[len(SERVE_ARCH_PREFIX):]
    try:
        family = get_config(base).family
    except KeyError:
        family = base
    return {
        "arch": arch,
        "shape": shape,
        "kind": "serve",
        "family": family,
        "multi_pod": bool(multi_pod),
        "active_knobs": list(SERVE_KNOBS),
    }


# --------------------------------------------------------------- stages
def serve_stages(spec: Any) -> List[Stage]:
    """The serving stage tree: scheduler knobs first (wave size, then
    admission policy), then the step knobs that reach the decode path —
    6 alternatives + baseline, inside the paper's ≤ 10-trial budget."""
    for name in SERVE_KNOBS:
        assert name in SPACE, name
    return [
        Stage("parallelism", SPACE["max_wave_size"].spark,
              [dict(max_wave_size=2), dict(max_wave_size=8)],
              kinds=("serve",)),
        Stage("locality.wait", SPACE["wave_admission"].spark,
              [dict(wave_admission="full")], kinds=("serve",)),
        Stage("rdd.compress", SPACE["kv_cache_dtype"].spark,
              [dict(kv_cache_dtype="int8")], kinds=("serve",)),
        Stage("preferDirectBufs", SPACE["donate_buffers"].spark,
              [dict(donate_buffers=False)], kinds=("serve",)),
        Stage("serializer", SPACE["compute_dtype"].spark,
              [dict(compute_dtype="bfloat16")], kinds=("serve",)),
    ]


# ------------------------------------------------------------ evaluator
class ServeEvaluator:
    """Replay the cell's trace through :class:`BatchScheduler` under a
    candidate config on ``device``; score W_TTFT·mean-TTFT +
    W_P95_QDELAY·p95-queue-delay + W_DECODE·mean-decode-seconds.
    Hardened like every other evaluator: any fault is a crashed
    TrialResult; an SLO-guard abort is a pre-tagged *deterministic*
    crash (``slo-violation`` in the error), raised mid-trace so a bad
    config never finishes its replay."""

    def __init__(self, slo_ttft: Optional[float] = None,
                 shadow_frac: float = 0.25, device="cuda"):
        self.slo_ttft = slo_ttft
        self.shadow_frac = shadow_frac
        self.device = device
        self.repeats = 1
        # per-process incumbent stats per cell key (the guard's
        # comparison basis: the default config's replay of the trace)
        self._incumbent: Dict[str, Dict[str, float]] = {}

    # ------------------------------------------------------------ replay
    def _sync(self) -> None:
        dev = torch.device(self.device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _build_scheduler(self, wl: ServeWorkload, rt: TunableConfig,
                         trace: Trace):
        from repro_torch.serving.scheduler import BatchScheduler, Request
        cfg = wl.cfg
        max_seq = trace.max_prompt_len() + trace.max_new_tokens() + 2
        # the scheduler places and casts the weights it is given; the
        # f32 master tree lives only as this argument
        sched = BatchScheduler(
            cfg, rt, build_model(cfg).init(0, device=self.device),
            wave_size=int(rt.max_wave_size),
            max_seq=max_seq, max_wait_s=0.0,
            # pad every wave to the trace's max prompt length and the
            # full wave width: ONE prefill + ONE decode geometry per
            # config instead of one per distinct wave shape
            pad_to=trace.max_prompt_len(), pad_wave=True,
            device=self.device)
        # warm-up wave: pay the first launches (the kernels' build
        # included) before the replay clock starts, so TTFT / queue
        # delay measure serving, and the SLO guard compares like with
        # like across candidate and incumbent
        for i in range(sched.wave_size):
            sched.submit(Request(rid=-1 - i,
                                 tokens=np.ones(4, np.int32),
                                 max_new_tokens=2, t_submit=0.0))
        sched.run_wave()
        return sched

    def replay(self, wl: ServeWorkload, rt: TunableConfig,
               guard=None, replays: int = 1) -> Dict[str, Any]:
        """Drive the trace through one scheduler on a virtual clock,
        ``replays`` times.

        Returns the stats dict of the replay whose cost is the median
        (see keys below; ``held_s`` is the time the trial held the
        device, ``replay_costs`` every replay's cost when there are
        several).  ``guard`` (a serving/canary.SLOGuard) observes every
        request the first replay serves and may raise
        :class:`TrialError` to abort it mid-trace; later replays only
        measure.
        """
        trace = get_trace(wl.shape)
        dev = resolve_device(self.device)
        with hold_device(dev), torch.no_grad():
            t0 = time.time()
            sched = None
            try:
                sched = self._build_scheduler(wl, rt, trace)
                runs = [self._replay_inner(sched, rt, trace,
                                           guard if i == 0 else None)
                        for i in range(max(1, int(replays)))]
            finally:
                sched = None
                if dev.type == "cuda":
                    # ten trials must not grow the card's memory
                    torch.cuda.empty_cache()
            held_s = round(time.time() - t0, 3)
        costs = [self.cost_of(r) for r in runs]
        stats = runs[sorted(range(len(runs)),
                            key=costs.__getitem__)[len(runs) // 2]]
        stats["held_s"] = held_s
        if len(runs) > 1:
            stats["replay_costs"] = costs
            tel = _telemetry.current()
            if tel.enabled:
                from repro_torch.core.quarantine import config_key
                tel.emit("serve.replays", cell=wl.key(),
                         config=config_key(rt), costs=costs,
                         held_s=held_s)
        return stats

    def _replay_inner(self, sched, rt: TunableConfig, trace: Trace,
                      guard) -> Dict[str, Any]:
        from repro_torch.serving.scheduler import Request, ServeMetrics
        sched.metrics = ServeMetrics()
        pending = collections.deque(trace.requests)
        admission = str(rt.wave_admission)
        vnow = 0.0
        ttft, qdelay, served = [], [], []
        t_run0 = time.time()
        while pending or sched.queue:
            if not sched.queue and pending:
                # idle: jump the virtual clock to the next arrival
                vnow = max(vnow, pending[0].arrival_s)
            while pending and pending[0].arrival_s <= vnow + 1e-9:
                tr = pending.popleft()
                sched.submit(Request(
                    rid=tr.rid, tokens=request_tokens(tr),
                    max_new_tokens=tr.max_new_tokens,
                    t_submit=tr.arrival_s))
            if (admission == "full" and pending
                    and len(sched.queue) < sched.wave_size):
                # hold the wave until it can be full: advance the
                # virtual clock to the next arrival and re-admit
                vnow = max(vnow, pending[0].arrival_s)
                continue
            v_start = vnow
            # the wave's wall time holds the wave's device work: nothing
            # earlier is still running at t0, all of it is done at the end
            self._sync()
            t0 = time.time()
            wave = sched.run_wave()
            self._sync()
            wall = time.time() - t0
            vnow += wall
            for r in wave:
                # virtual queue delay + real prefill latency = the TTFT
                # a user on the virtual timeline would see
                qd = max(0.0, v_start - r.t_submit)
                tt = qd + max(0.0, (r.t_first_token or t0) - t0)
                qdelay.append(qd)
                ttft.append(tt)
                served.append(r.rid)
                if guard is not None:
                    guard.observe(ttft_s=tt, qdelay_s=qd,
                                  served=len(served),
                                  total=len(trace.requests))
        summary = sched.metrics.summary()
        qsorted = sorted(qdelay)
        n = len(served)
        return {
            "trace": trace.name,
            "trace_key": trace.key(),
            "served": n,
            "served_order": served,
            "mean_ttft_s": (sum(ttft) / n) if n else 0.0,
            "p95_qdelay_s": (qsorted[min(n - 1, int(0.95 * n))]
                             if n else 0.0),
            "decode_tok_per_s": summary["decode_tok_per_s"],
            "decode_tokens": sched.metrics.decode_tokens,
            "wall_s": round(time.time() - t_run0, 3),
        }

    @staticmethod
    def cost_of(stats: Dict[str, Any]) -> float:
        """The scalar trial cost: TTFT + tail queue delay + mean decode
        seconds per request."""
        n = max(1, int(stats.get("served", 0)))
        rate = stats.get("decode_tok_per_s", 0.0)
        decode_s = (stats.get("decode_tokens", 0) / rate / n
                    if rate > 0 else 0.0)
        return (W_TTFT * stats.get("mean_ttft_s", 0.0)
                + W_P95_QDELAY * stats.get("p95_qdelay_s", 0.0)
                + W_DECODE * decode_s)

    # -------------------------------------------------------- incumbent
    def incumbent_stats(self, wl: ServeWorkload) -> Dict[str, float]:
        """The guard's comparison basis: the default config's replay of
        this cell's trace (computed once per process per cell)."""
        key = wl.key()
        if key not in self._incumbent:
            stats = self.replay(wl, default_config(), guard=None,
                                replays=TRACE_SPECS[wl.shape].replays)
            self._incumbent[key] = {
                "mean_ttft_s": stats["mean_ttft_s"],
                "p95_qdelay_s": stats["p95_qdelay_s"],
            }
        return self._incumbent[key]

    # --------------------------------------------------------- protocol
    def __call__(self, wl: Workload, rt: TunableConfig) -> TrialResult:
        t0 = time.time()
        try:
            if not is_serve_workload(wl):
                raise TrialError(f"{wl.key()} is not a serve cell")
            SPACE.validate(rt)
            for name in ("max_wave_size", "wave_admission"):
                SPACE[name].validate(getattr(rt, name))
            guard = None
            if self.slo_ttft is not None:
                from repro_torch.serving.canary import SLOGuard
                guard = SLOGuard(self.slo_ttft, self.incumbent_stats(wl),
                                 shadow_frac=self.shadow_frac)
            stats = self.replay(wl, rt, guard=guard,
                                replays=TRACE_SPECS[wl.shape].replays)
            return TrialResult(cost_s=float(self.cost_of(stats)),
                               compiles=1,
                               compile_s=round(stats["held_s"], 2))
        except Exception as e:
            err = str(e) if isinstance(e, TrialError) \
                else f"{type(e).__name__}: {e}"
            return TrialResult(cost_s=float("inf"), crashed=True,
                               error=err[:500],
                               failure=classify_exception(e),
                               compile_s=round(time.time() - t0, 2))


class CachedServe(CachedMeasure):
    """The serve tier's TimingCache wrapper: same two-level policy as
    every measured evaluation, with the trace's *content* key and the
    SLO setting folded into the cache key — a registry edit or a
    different guard threshold can never alias onto a stale cost, and
    two fabric workers replaying the same spec agree on every key.  The
    device is in the key too, as in every measured evaluation."""

    def _key(self, wl: Workload, rt: TunableConfig) -> str:
        ev = self.evaluator
        slo = getattr(ev, "slo_ttft", None)
        tag = (f"{SERVE_MEASURE_VERSION}:{get_trace(wl.shape).key()}"
               f":slo={slo}")
        return measure_key(wl, rt, self.repeats, self._tag(tag))


def make_serve_evaluator(slo_ttft: Optional[float] = None,
                         cache: Optional[TimingCache] = None,
                         device="cuda") -> CachedServe:
    """The serve branch of the campaign's dispatch evaluator."""
    return CachedServe(ServeEvaluator(slo_ttft=slo_ttft, device=device),
                       cache=cache, repeats=1)
