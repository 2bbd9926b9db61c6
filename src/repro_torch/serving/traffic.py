"""Seeded synthetic serving-traffic traces — generation and replay format.

The serving tuner's first requirement is that every trial of every
candidate config sees *bit-identical* traffic: the trial cost must be a
property of the config, not of the RNG draw, or the campaign's accept
rule compares noise and fabric workers disagree on cached cost keys.
So traffic is split into two layers:

  * a **generator** (:func:`generate`) that expands a small declarative
    :class:`TraceSpec` — arrival pattern (Poisson / bursty Markov-
    modulated / diurnal), mean rate, and a multi-tenant mix of
    prompt-length / max-token distributions — into a concrete list of
    :class:`TraceRequest` s using one ``np.random.RandomState(seed)``;
  * a **replay format** (:class:`Trace`): canonical JSON
    (``sort_keys=True``, fixed float rounding) so the same seed
    serializes to the same bytes on every host, with a sha1
    ``trace_key`` over those bytes that evaluators fold into their
    timing-cache keys.

Prompt token ids are *not* stored in the trace (they would dominate the
file); each request carries a derived per-request ``seed`` and
:func:`request_tokens` regenerates the same tokens at replay time.

Named tiny traces live in the :data:`TRACES` registry — they are the
"shape" axis of ``serve:<arch>:<trace>`` cells (serving/evaluator.py)
and are small enough to replay through a reduced model on CPU in CI.

(The PyTorch port's own copy of the reference's ``serving/traffic.py``:
the same seed gives the same bytes and the same ``trace_key`` in both
packages.)
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.fsutil import atomic_publish

TRACE_VERSION = "trace-v1"

# replayed prompts draw token ids from [1, VOCAB_LO) — small enough for
# every reduced vocab, never 0 (the schedulers' left-pad value)
_TOKEN_LO, _TOKEN_HI = 1, 500


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One traffic class in a multi-tenant mix."""
    name: str
    weight: float                 # relative share of requests
    prompt_len: Tuple[int, int]   # inclusive [lo, hi] prompt tokens
    max_new: Tuple[int, int]      # inclusive [lo, hi] decode budget


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Declarative description a generator expands deterministically."""
    name: str
    pattern: str                  # poisson | bursty | diurnal
    n_requests: int
    mean_rate: float              # mean arrivals per virtual second
    seed: int
    tenants: Tuple[Tenant, ...]
    # bursty: burst-state rate multiplier + mean dwell (requests/state)
    burst_factor: float = 8.0
    burst_dwell: float = 4.0
    # diurnal: sinusoidal rate modulation amplitude + period (virtual s)
    diurnal_amp: float = 0.8
    diurnal_period_s: float = 20.0


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    rid: int
    arrival_s: float              # virtual arrival time (s from start)
    prompt_len: int
    max_new_tokens: int
    tenant: str
    seed: int                     # per-request token-generation seed

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class Trace:
    """A fully-expanded, replayable traffic trace."""

    def __init__(self, meta: Dict, requests: Sequence[TraceRequest]):
        self.meta = dict(meta)
        self.requests: List[TraceRequest] = list(requests)

    # ------------------------------------------------------ serialization
    def to_json(self) -> str:
        """Canonical byte-stable serialization: sorted keys, arrival
        times pre-rounded at generation, newline-terminated."""
        doc = {
            "version": TRACE_VERSION,
            "meta": self.meta,
            "requests": [r.as_dict() for r in self.requests],
        }
        return json.dumps(doc, sort_keys=True,
                          separators=(",", ":")) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        doc = json.loads(text)
        if doc.get("version") != TRACE_VERSION:
            raise ValueError(f"unsupported trace version "
                             f"{doc.get('version')!r}")
        reqs = [TraceRequest(**r) for r in doc["requests"]]
        return cls(doc.get("meta", {}), reqs)

    def save(self, path) -> None:
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        atomic_publish(p, self.to_json(), prefix="trace")

    @classmethod
    def load(cls, path) -> "Trace":
        return cls.from_json(pathlib.Path(path).read_text())

    # ------------------------------------------------------------- identity
    def key(self) -> str:
        """sha1 over the canonical bytes — the identity evaluators fold
        into their timing-cache keys, so two fabric workers replaying
        the same spec agree on every cached trial cost."""
        return hashlib.sha1(self.to_json().encode()).hexdigest()[:16]

    @property
    def name(self) -> str:
        return str(self.meta.get("name", "trace"))

    def span_s(self) -> float:
        return self.requests[-1].arrival_s if self.requests else 0.0

    def max_prompt_len(self) -> int:
        return max((r.prompt_len for r in self.requests), default=0)

    def max_new_tokens(self) -> int:
        return max((r.max_new_tokens for r in self.requests), default=0)


def request_tokens(req: TraceRequest) -> np.ndarray:
    """Regenerate the request's prompt tokens from its stored seed —
    identical on every replaying process."""
    rng = np.random.RandomState(req.seed)
    return rng.randint(_TOKEN_LO, _TOKEN_HI,
                       size=req.prompt_len).astype(np.int32)


# ------------------------------------------------------------- generators
def _interarrivals(spec: TraceSpec, rng: np.random.RandomState
                   ) -> np.ndarray:
    """One inter-arrival gap per request, by pattern."""
    n, rate = spec.n_requests, max(spec.mean_rate, 1e-9)
    if spec.pattern == "poisson":
        return rng.exponential(1.0 / rate, size=n)
    if spec.pattern == "bursty":
        # two-state Markov-modulated Poisson: calm at the mean rate,
        # bursts at burst_factor x, geometric dwell per state
        gaps = np.empty(n)
        burst = False
        for i in range(n):
            r = rate * (spec.burst_factor if burst else 1.0)
            gaps[i] = rng.exponential(1.0 / r)
            if rng.uniform() < 1.0 / max(spec.burst_dwell, 1.0):
                burst = not burst
        return gaps
    if spec.pattern == "diurnal":
        # sinusoidal rate modulation around the mean (a compressed
        # day): the instantaneous rate at the running arrival time
        # scales the next exponential gap
        gaps = np.empty(n)
        t = 0.0
        for i in range(n):
            phase = 2.0 * np.pi * t / max(spec.diurnal_period_s, 1e-9)
            r = rate * max(1e-3, 1.0 + spec.diurnal_amp * np.sin(phase))
            gaps[i] = rng.exponential(1.0 / r)
            t += gaps[i]
        return gaps
    raise ValueError(f"unknown arrival pattern {spec.pattern!r} "
                     "(known: poisson, bursty, diurnal)")


def generate(spec: TraceSpec) -> Trace:
    """Expand a spec into a concrete trace, deterministically."""
    if not spec.tenants:
        raise ValueError(f"trace {spec.name!r}: empty tenant mix")
    rng = np.random.RandomState(spec.seed)
    gaps = _interarrivals(spec, rng)
    arrivals = np.cumsum(gaps)
    weights = np.array([t.weight for t in spec.tenants], dtype=float)
    weights = weights / weights.sum()
    reqs = []
    for rid in range(spec.n_requests):
        ten = spec.tenants[int(rng.choice(len(spec.tenants), p=weights))]
        plen = int(rng.randint(ten.prompt_len[0], ten.prompt_len[1] + 1))
        mnew = int(rng.randint(ten.max_new[0], ten.max_new[1] + 1))
        # per-request token seed derived from (trace seed, rid): stable
        # across processes without storing the tokens themselves
        tok_seed = int(hashlib.sha1(
            f"{spec.seed}:{spec.name}:{rid}".encode()
        ).hexdigest()[:8], 16)
        reqs.append(TraceRequest(
            rid=rid,
            # fixed rounding keeps the JSON byte-stable across platforms
            arrival_s=round(float(arrivals[rid]), 6),
            prompt_len=plen, max_new_tokens=mnew,
            tenant=ten.name, seed=tok_seed))
    meta = {
        "name": spec.name, "pattern": spec.pattern,
        "n_requests": spec.n_requests, "mean_rate": spec.mean_rate,
        "seed": spec.seed,
        "tenants": [dataclasses.asdict(t) for t in spec.tenants],
    }
    return Trace(meta, reqs)


# --------------------------------------------------------------- registry
# Tiny named traces: the "shape" axis of serve:<arch>:<trace> cells.
# Prompt lengths / decode budgets are sized for reduced models on CPU
# (max_seq stays small); virtual spans are a few tens of seconds so
# admission-policy differences show up in queue delay without any
# real-time sleeping.
_CHAT = Tenant("chat", 0.7, (4, 12), (3, 6))
_BATCH = Tenant("batch", 0.3, (12, 24), (2, 4))

TRACE_SPECS: Dict[str, TraceSpec] = {
    "poisson_tiny": TraceSpec(
        name="poisson_tiny", pattern="poisson", n_requests=8,
        mean_rate=0.25, seed=1234, tenants=(_CHAT, _BATCH)),
    "bursty_tiny": TraceSpec(
        name="bursty_tiny", pattern="bursty", n_requests=10,
        mean_rate=0.5, seed=5678, tenants=(_CHAT, _BATCH)),
    "diurnal_tiny": TraceSpec(
        name="diurnal_tiny", pattern="diurnal", n_requests=10,
        mean_rate=0.5, seed=4321, tenants=(_CHAT, _BATCH)),
}

_TRACE_CACHE: Dict[str, Trace] = {}


def trace_names() -> Tuple[str, ...]:
    return tuple(sorted(TRACE_SPECS))


def get_trace(name: str) -> Trace:
    """Expand (once per process) a registered trace by name."""
    if name not in TRACE_SPECS:
        raise ValueError(f"unknown trace {name!r} "
                         f"(known: {', '.join(trace_names())})")
    if name not in _TRACE_CACHE:
        _TRACE_CACHE[name] = generate(TRACE_SPECS[name])
    return _TRACE_CACHE[name]
