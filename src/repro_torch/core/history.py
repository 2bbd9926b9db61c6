"""Trial-history store — every trial ever run, queryable for warm-starts.

The campaign engine made trials cheap and resumable, but every campaign
still started from zero knowledge: a fresh cell's cursor walked the
whole tree as if no similar cell had ever been tuned.  The
:class:`TrialHistory` store makes campaigns *cumulative*:

  * **append-only JSONL** — every evaluated trial (config, cell, cost,
    compile stats) is appended as one JSON line to a shared
    ``history.jsonl`` next to the campaign checkpoints.  Appends are a
    single ``write(2)`` on an ``O_APPEND`` descriptor, so concurrent
    fabric workers (core/fabric.py) interleave whole lines, never
    bytes; readers skip torn or foreign lines instead of failing;
  * **cell signatures** — :func:`cell_signature` describes a cell by
    the features that determine which knobs matter to it: the shape
    kind, the arch family, and the *active knob set* derived from the
    :data:`~repro_torch.core.space.SPACE` registry (a tunable knob is active
    iff flipping it can change the cell's ``compile_key`` projection,
    plus the always-analytic knobs).  :func:`cell_similarity` scores
    two signatures (kind ≫ family ≫ arch/shape, plus Jaccard overlap
    of the active knob sets), so "nearest cell" means "cell whose
    trials exercised the same knobs";
  * **warm-start queries** — :meth:`TrialHistory.warmstart_configs`
    returns the best observed configs of the nearest already-tuned
    cells (never the cell's own records — a resumed cell replays its
    checkpoint instead).  The campaign seeds each cursor with them via
    the ``SearchCursor.warm_start`` hook, cutting trials-to-convergence
    on fresh cells (retrieval-style warm-starting, 2503.03826).

Configs read back from history are validated against the registry
before they are proposed: records from an older knob space (missing
knobs, retired values) are silently skipped, never crash a campaign.

Two learned layers sit on top of the raw store:

  * **featurization** — :func:`featurize` maps a (config, signature)
    pair to a fixed-layout numeric vector (knob one-hots over the
    registry, active-knob indicators, hashed arch/family buckets) that
    the learned proposer (core/proposer.py) fits its ridge cost model
    over.  The layout is a pure function of the knob registry, so the
    same history bytes featurize identically in every process;
  * **fitted similarity** — :meth:`TrialHistory.similarity_weights`
    replaces the hand-set registry weights with weights fit from the
    history itself: cell pairs that evaluated common configs vote on
    how well one cell's cost ordering predicted the other's, and a
    tiny ridge fit over the signature-match features turns those votes
    into weights.  Warm-start retrieval, ``expected_speedup`` and the
    queue's history prioritizer (core/schedule.py) all ride it; with
    too little cross-cell evidence it falls back to the hand-set
    weights, bit-identically.

This is the PyTorch port's own copy of the reference's
``core/history.py``: its output is byte-identical to the reference's.
"""
from __future__ import annotations

import functools
import hashlib
import json
import pathlib
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.fsutil import append_jsonl
from repro_torch.core.params import TunableConfig
from repro_torch.core.space import SPACE

HISTORY_VERSION = 1
HISTORY_FILENAME = "history.jsonl"


def _viable(rec: Dict) -> bool:
    """A record a warm-start may build on: a non-crashed trial with a
    finite cost and a config dict."""
    cost = rec.get("cost_s")
    return (rec.get("cell") is not None and not rec.get("crashed")
            and isinstance(cost, (int, float)) and cost == cost
            and cost != float("inf")
            and isinstance(rec.get("config"), dict))


# ------------------------------------------------------ cell signatures
@functools.lru_cache(maxsize=None)
def active_knobs(kind: str, family: str) -> Tuple[str, ...]:
    """The tunable knobs that can matter to a (kind, family) cell.

    A compile-reach knob is active iff some value flip changes the
    cell's ``compile_key`` projection (i.e. the knob is not
    canonicalized away for this cell class); analytic-reach tunables
    are always active (they enter the roofline terms of every cell).
    """
    base = TunableConfig()
    base_key = base.compile_key(kind, family)
    out = []
    for knob in SPACE:
        if not knob.tunable:
            continue
        if knob.reach == "analytic":
            out.append(knob.name)
            continue
        if any(base.replace(**{knob.name: v}).compile_key(kind, family)
               != base_key for v in knob.domain[1:]):
            out.append(knob.name)
    return tuple(out)


def cell_signature(arch: str, shape: str, multi_pod: bool = False) -> Dict:
    """The features warm-start similarity is computed over."""
    if arch.startswith("kernel-"):
        # kernel cells (core/kernel_cell.py) have no arch config /
        # SHAPES entry; their signature comes from the kernel registry
        # so history prioritization and warm-start never crash on them
        from repro_torch.core.kernel_cell import kernel_signature
        return kernel_signature(arch, shape, multi_pod)
    if arch.startswith("serve-"):
        # serve cells (serving/evaluator.py): trace name is the shape,
        # the serving knob subset is the active-knob list
        from repro_torch.serving.evaluator import serve_signature
        return serve_signature(arch, shape, multi_pod)
    from repro_torch.configs import get_config, get_shape
    kind = get_shape(shape).kind
    family = get_config(arch).family
    return {
        "arch": arch,
        "shape": shape,
        "kind": kind,
        "family": family,
        "multi_pod": bool(multi_pod),
        "active_knobs": list(active_knobs(kind, family)),
    }


# hand-set fallback weights: the shape kind dominates (it selects which
# tree stages and sweep knobs even apply), then the arch family, then
# exact arch/shape matches; the active-knob Jaccard term rewards cells
# whose trials exercised the same knob subset.  Feature order matches
# :func:`similarity_features`.
_W_KIND, _W_FAMILY, _W_ARCH, _W_SHAPE, _W_MESH, _W_KNOBS = \
    4.0, 2.0, 1.0, 1.0, 0.5, 4.0
STATIC_SIMILARITY_WEIGHTS: Tuple[float, ...] = (
    _W_KIND, _W_FAMILY, _W_ARCH, _W_SHAPE, _W_MESH, _W_KNOBS)

#: minimum number of cell pairs with overlapping evaluated configs
#: before the fitted similarity replaces the hand-set weights — below
#: it the fit would memorize noise, so retrieval stays bit-identical
#: to the registry weights.
SIMILARITY_MIN_PAIRS = 8
_SIMILARITY_RIDGE = 1e-2


def similarity_features(a: Dict, b: Dict) -> List[float]:
    """The match features :func:`cell_similarity` weights: kind /
    family / arch / shape / mesh equality plus the active-knob
    Jaccard overlap (all in [0, 1])."""
    ka, kb = set(a["active_knobs"]), set(b["active_knobs"])
    return [
        1.0 if a["kind"] == b["kind"] else 0.0,
        1.0 if a["family"] == b["family"] else 0.0,
        1.0 if a["arch"] == b["arch"] else 0.0,
        1.0 if a["shape"] == b["shape"] else 0.0,
        1.0 if a["multi_pod"] == b["multi_pod"] else 0.0,
        len(ka & kb) / max(1, len(ka | kb)),
    ]


def cell_similarity(a: Dict, b: Dict,
                    weights: Optional[Sequence[float]] = None) -> float:
    """Similarity score of two :func:`cell_signature` dicts (≥ 0).

    ``weights`` (one per :func:`similarity_features` entry) default to
    the hand-set registry weights; :class:`TrialHistory` passes its
    history-fit weights instead."""
    w = STATIC_SIMILARITY_WEIGHTS if weights is None else weights
    return float(sum(wi * fi
                     for wi, fi in zip(w, similarity_features(a, b))))


def fit_similarity_weights(records: Sequence[Dict]
                           ) -> Tuple[float, ...]:
    """Fit the similarity weights from history: which cells actually
    predicted which.

    Every pair of recorded cells that evaluated ≥ 2 common configs
    votes with its *concordance* — the fraction of shared-config pairs
    both cells' costs order the same way (ties count half), i.e. how
    well one cell's ranking transferred to the other.  A ridge fit of
    concordance over the signature-match features yields the weights
    (clamped ≥ 0: a feature match can make cells more transferable,
    never less).  With fewer than :data:`SIMILARITY_MIN_PAIRS` pairs —
    or a degenerate all-zero fit — the hand-set registry weights are
    returned unchanged, so thin histories behave bit-identically to
    the pre-fit retrieval.  Deterministic: same records ⇒ same weights
    (pure numpy on a sorted pair list)."""
    per_cell: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        if not _viable(rec):
            continue
        try:
            sig = cell_signature(rec.get("arch"), rec.get("shape"),
                                 rec.get("multi_pod", False))
        except Exception:
            continue                     # cell from a foreign assignment
        fp = json.dumps(rec["config"], sort_keys=True, default=str)
        ent = per_cell.setdefault(rec["cell"], {"sig": sig, "costs": {}})
        cost = float(rec["cost_s"])
        if fp not in ent["costs"] or cost < ent["costs"][fp]:
            ent["costs"][fp] = cost
    cells = sorted(per_cell)
    xs: List[List[float]] = []
    ys: List[float] = []
    for i, a in enumerate(cells):
        for b in cells[i + 1:]:
            ca, cb = per_cell[a]["costs"], per_cell[b]["costs"]
            shared = sorted(set(ca) & set(cb))
            if len(shared) < 2:
                continue
            agree = total = 0.0
            for p in range(len(shared)):
                for q in range(p + 1, len(shared)):
                    da = ca[shared[p]] - ca[shared[q]]
                    db = cb[shared[p]] - cb[shared[q]]
                    total += 1.0
                    if da == 0.0 or db == 0.0:
                        agree += 0.5
                    elif (da > 0) == (db > 0):
                        agree += 1.0
            xs.append(similarity_features(per_cell[a]["sig"],
                                          per_cell[b]["sig"]))
            ys.append(agree / total)
    if len(xs) < SIMILARITY_MIN_PAIRS:
        return STATIC_SIMILARITY_WEIGHTS
    x = np.asarray(xs, dtype=np.float64)
    y = np.asarray(ys, dtype=np.float64)
    a = x.T @ x + _SIMILARITY_RIDGE * np.eye(x.shape[1])
    w = np.clip(np.linalg.solve(a, x.T @ y), 0.0, None)
    if not np.any(w > 0.0):
        return STATIC_SIMILARITY_WEIGHTS
    return tuple(float(v) for v in w)


def config_from_dict(d: Dict[str, Any]) -> TunableConfig:
    """Rehydrate a config recorded by an (older) knob space: unknown
    fields are dropped, missing fields take today's defaults, and the
    result is validated against the registry (raises ``ValueError`` on
    out-of-domain values)."""
    fields = {f.name for f in TunableConfig.__dataclass_fields__.values()}
    cfg = TunableConfig(**{k: v for k, v in d.items() if k in fields})
    SPACE.validate(cfg)
    return cfg


# -------------------------------------------------------- featurization
#: bumped whenever the feature layout changes — enters the learned
#: proposer's fit digest so checkpointed fits from an older layout are
#: rebuilt, never misread.
FEATURES_VERSION = 1

_SIG_HASH_BUCKETS = 8


def _hash_bucket(s: str) -> int:
    """Stable (process- and machine-independent) hash bucket for a
    categorical signature feature — ``hash()`` is salted per process,
    so it would break the same-bytes ⇒ same-features contract."""
    return int(hashlib.sha1(str(s).encode()).hexdigest(), 16) \
        % _SIG_HASH_BUCKETS


@functools.lru_cache(maxsize=1)
def feature_names() -> Tuple[str, ...]:
    """The fixed feature layout: bias, one indicator per (knob, value)
    of the registry plus one active-knob indicator per knob (registry
    order — load-bearing, like ``compile_key``), then hashed family
    and arch buckets.  A pure function of the knob registry."""
    names = ["bias"]
    for knob in SPACE:
        for v in knob.domain:
            names.append(f"{knob.name}={v}")
        names.append(f"active:{knob.name}")
    names.extend(f"family#{i}" for i in range(_SIG_HASH_BUCKETS))
    names.extend(f"arch#{i}" for i in range(_SIG_HASH_BUCKETS))
    return tuple(names)


def featurize(config: Dict[str, Any], sig: Dict) -> np.ndarray:
    """Map one (config dict, :func:`cell_signature`) pair to the fixed
    feature vector the learned proposer fits over.

    Missing knobs take the registry default (an older-space record
    still featurizes); an out-of-domain value raises ``ValueError`` so
    callers skip the record instead of fitting on garbage."""
    active = set(sig.get("active_knobs") or ())
    x = np.zeros(len(feature_names()), dtype=np.float64)
    x[0] = 1.0
    i = 1
    for knob in SPACE:
        v = config.get(knob.name, knob.default)
        try:
            j = list(knob.domain).index(v)
        except ValueError:
            raise ValueError(
                f"{knob.name}={v!r} not in domain {knob.domain}")
        x[i + j] = 1.0
        i += len(knob.domain)
        x[i] = 1.0 if knob.name in active else 0.0
        i += 1
    x[i + _hash_bucket(sig.get("family", ""))] = 1.0
    i += _SIG_HASH_BUCKETS
    x[i + _hash_bucket(sig.get("arch", ""))] = 1.0
    return x


# --------------------------------------------------------------- store
class TrialHistory:
    """Append-only JSONL store of evaluated trials, shared by every
    process that works a campaign directory.

    One line per trial; appends go through a single ``os.write`` on an
    ``O_APPEND`` descriptor so concurrent workers never interleave
    partial lines.  Readers tolerate torn/corrupt lines (a reader can
    race the tail of a concurrent append) by skipping them.
    """

    def __init__(self, path: pathlib.Path):
        self.path = pathlib.Path(path)
        self._cache: Optional[Tuple[Tuple[int, int], List[Dict]]] = None
        self._speedups: Optional[Tuple[Tuple[int, int], Dict]] = None
        self._expected: Optional[Tuple[Tuple[int, int], Dict]] = None
        self._simw: Optional[Tuple[Tuple[int, int],
                                   Tuple[float, ...]]] = None
        # incremental-reader state: records parsed from consumed bytes,
        # the byte offset just past the last *complete*
        # (newline-terminated) line already parsed, and a fingerprint
        # of the bytes leading up to it so a rewritten file (not an
        # append) forces a full re-parse
        self._consumed: List[Dict] = []
        self._tail = 0
        self._tail_fp = b""

    # ------------------------------------------------------- appending
    def append(self, record: Dict[str, Any]) -> None:
        # one O_APPEND line with torn-tail self-healing; the idiom
        # lives in core/fsutil.append_jsonl (shared with the quarantine
        # ledger, core/quarantine.py)
        append_jsonl(self.path, record)

    def record_trial(self, workload, strategy: str, rt: TunableConfig,
                     name: str, result, delta: Optional[Dict] = None
                     ) -> None:
        """Append one evaluated trial (the TrialRunner emission hook)."""
        self.append({
            "v": HISTORY_VERSION,
            "ts": round(time.time(), 3),
            "cell": workload.key(),
            "arch": workload.arch,
            "shape": workload.shape,
            "multi_pod": bool(workload.multi_pod),
            "strategy": strategy,
            "name": name,
            "delta": delta or {},
            "config": rt.as_dict(),
            "cost_s": result.cost_s,
            "crashed": bool(result.crashed),
            "failure": getattr(result, "failure", ""),
            "retries": int(getattr(result, "retries", 0)),
            "compiles": result.compiles,
            "compile_s": result.compile_s,
            "cached": bool(result.cached),
        })

    def sink(self, strategy: str):
        """A ``TrialRunner.history`` callable bound to a strategy name."""
        def emit(workload, rt, name, result, delta):
            self.record_trial(workload, strategy, rt, name, result, delta)
        return emit

    # --------------------------------------------------------- reading
    _TAIL_FP_BYTES = 64

    def _tail_fingerprint(self, f) -> bytes:
        """sha1 of the last ≤ 64 consumed bytes — a cheap probe that
        the file up to ``self._tail`` is still the bytes we parsed
        (append-only growth), not a same-or-larger rewrite."""
        n = min(self._TAIL_FP_BYTES, self._tail)
        f.seek(self._tail - n)
        return hashlib.sha1(f.read(n)).digest()

    def records(self) -> List[Dict]:
        """Parsed records, oldest first; torn/corrupt lines skipped.

        Incremental: the parse is cached per (size, mtime) of the file
        *and* only the appended tail is re-read when the file grows —
        a long-lived fabric worker polling the board between batches
        pays one small tail read per append, not a full re-parse of an
        ever-growing file.  A shrunk or rewritten file (tail
        fingerprint mismatch) falls back to a full re-parse.  Torn-tail
        healing is preserved: an unterminated final line is parsed but
        never *consumed*, so the next read retries it once the
        concurrent appender (or :func:`~repro_torch.core.fsutil.append_jsonl`
        self-healing) completes it."""
        try:
            st = self.path.stat()
        except OSError:
            self._cache = None
            self._consumed = []
            self._tail = 0
            self._tail_fp = b""
            return []
        sig = (st.st_size, st.st_mtime_ns)
        if self._cache is not None and self._cache[0] == sig:
            return list(self._cache[1])
        start = 0
        try:
            with open(self.path, "rb") as f:
                if (self._tail and st.st_size >= self._tail
                        and self._tail_fingerprint(f) == self._tail_fp):
                    start = self._tail   # append-only growth: tail only
                else:
                    self._consumed = []
                    self._tail = 0
                f.seek(start)
                data = f.read()
        except OSError:
            return []
        idx = consumed = 0
        extra: List[Dict] = []           # parsed from unterminated tail
        while True:
            nl = data.find(b"\n", idx)
            line = data[idx:] if nl < 0 else data[idx:nl]
            line = line.strip()
            if line:
                try:
                    rec = json.loads(line)
                except (ValueError, UnicodeDecodeError):
                    rec = None           # torn/corrupt line: skip
                if isinstance(rec, dict):
                    (extra if nl < 0 else self._consumed).append(rec)
            if nl < 0:
                break                    # unterminated tail: not consumed
            idx = nl + 1
            consumed = idx
        self._tail = start + consumed
        try:
            with open(self.path, "rb") as f:
                self._tail_fp = self._tail_fingerprint(f)
        except OSError:
            self._consumed = []
            self._tail = 0
            self._tail_fp = b""
        out = self._consumed + extra
        self._cache = (sig, out)
        return list(out)

    def cells(self) -> List[str]:
        """Distinct cell keys with at least one recorded trial."""
        return sorted({r["cell"] for r in self.records() if "cell" in r})

    def n_records(self) -> int:
        return sum(1 for _ in self.records())

    # ---------------------------------------------- fitted similarity
    def similarity_weights(self) -> Tuple[float, ...]:
        """The similarity-feature weights retrieval runs on: fit from
        this history (:func:`fit_similarity_weights`) when it holds
        enough cross-cell config overlaps, else the hand-set registry
        weights.  Cached on the same (size, mtime) signature as
        :meth:`records` — one fit per history growth, not per query."""
        recs = self.records()            # refreshes self._cache
        sig = self._cache[0] if self._cache is not None else None
        if sig is not None and self._simw is not None \
                and self._simw[0] == sig:
            return self._simw[1]
        w = fit_similarity_weights(recs)
        if sig is not None:
            self._simw = (sig, w)
        return w

    # ------------------------------------------------- expected speedup
    def cell_speedups(self) -> Dict[str, Dict[str, Any]]:
        """Per recorded cell: the observed baseline cost, best viable
        cost and the implied speedup (baseline / best).

        The baseline is the cheapest viable record named ``baseline``
        (the same deterministic trial every strategy evaluates first);
        a cell whose baseline crashed falls back to its earliest viable
        record, so a "recovered" cell still reports the gain its trials
        actually demonstrated.  Cells with no viable record at all are
        omitted.

        Cached on the same (size, mtime) signature as :meth:`records`:
        a scheduling pass scoring N cells pays one aggregation, not N
        (the online scheduler re-ranks on every queue hand-out).
        """
        recs = self.records()            # refreshes self._cache
        sig = self._cache[0] if self._cache is not None else None
        if sig is not None and self._speedups is not None \
                and self._speedups[0] == sig:
            return dict(self._speedups[1])
        per_cell: Dict[str, List[Dict]] = {}
        for rec in recs:
            if _viable(rec):
                per_cell.setdefault(rec["cell"], []).append(rec)
        out: Dict[str, Dict[str, Any]] = {}
        for cell, recs in per_cell.items():
            base = min((r["cost_s"] for r in recs
                        if r.get("name") == "baseline"),
                       default=None)
            if base is None:
                base = min(recs, key=lambda r: r.get("ts", 0.0))["cost_s"]
            best = min(r["cost_s"] for r in recs)
            first = recs[0]
            out[cell] = {
                "arch": first.get("arch"),
                "shape": first.get("shape"),
                "multi_pod": bool(first.get("multi_pod", False)),
                "baseline_cost": base,
                "best_cost": best,
                "speedup": base / best if best > 0 else float("nan"),
                "trials": len(recs),
            }
        if sig is not None:
            self._speedups = (sig, out)
        return dict(out)

    def expected_speedup(self, arch: str, shape: str,
                         multi_pod: bool = False, *,
                         k_cells: int = 2) -> Optional[float]:
        """Expected-speedup estimate for a cell: the best observed
        speedup among the ``k_cells`` nearest *same-shape-kind* cells
        in the history (best-of-nearest, the same registry-derived
        similarity warm-start retrieval uses).  Unlike
        :meth:`warmstart_configs`, the target cell's own records are
        included — identity similarity dominates, so a cell the history
        has already tuned is scored by its own demonstrated gain.

        Speedups only transfer within a shape kind: the tuning tree's
        stages and the sweepable knobs are kind-keyed, so a train
        cell's demonstrated gain says nothing about a decode cell's
        walk.  ``None`` when no same-kind cell is recorded — the online
        scheduler treats that as *unknown* and schedules the cell
        explore-first.

        Similarity uses the history-fit weights
        (:meth:`similarity_weights`), and the estimate is memoized per
        (cell, k_cells) on the records signature — the online
        scheduler re-ranks the queue at every hand-out, so between
        appends an N-cell re-rank costs N dict hits, not N similarity
        scans."""
        self.records()                   # refreshes self._cache
        sig = self._cache[0] if self._cache is not None else None
        key = (arch, shape, bool(multi_pod), int(k_cells))
        if sig is not None and self._expected is not None \
                and self._expected[0] == sig \
                and key in self._expected[1]:
            return self._expected[1][key]
        weights = self.similarity_weights()
        target_sig = cell_signature(arch, shape, multi_pod)
        scored: List[Tuple[float, str, float]] = []
        for cell, info in self.cell_speedups().items():
            sp = info["speedup"]
            if sp != sp:                 # NaN: nothing demonstrable
                continue
            try:
                csig = cell_signature(info["arch"], info["shape"],
                                      info["multi_pod"])
            except (KeyError, TypeError):
                continue                 # cell from a foreign assignment
            if csig["kind"] != target_sig["kind"]:
                continue                 # gains don't transfer kinds
            scored.append((cell_similarity(target_sig, csig,
                                           weights=weights), cell, sp))
        scored.sort(key=lambda t: (-t[0], t[1]))
        top = scored[:max(0, k_cells)]
        out = max(sp for _, _, sp in top) if top else None
        if sig is not None:
            if self._expected is None or self._expected[0] != sig:
                self._expected = (sig, {})
            self._expected[1][key] = out
        return out

    # ------------------------------------------------------ warm-start
    def warmstart_configs(self, arch: str, shape: str,
                          multi_pod: bool = False, *,
                          k_cells: int = 2, per_cell: int = 1
                          ) -> List[Dict[str, Any]]:
        """Best configs of the ``k_cells`` nearest already-tuned cells
        (the target cell's own records are excluded — resume comes from
        the checkpoint, not from history).  Returns normalized full
        config dicts, registry-validated, deduplicated, ordered by
        descending cell similarity (history-fit weights,
        :meth:`similarity_weights`)."""
        from repro_torch.core.trial import Workload
        target_key = Workload(arch, shape, multi_pod).key()
        target_sig = cell_signature(arch, shape, multi_pod)
        weights = self.similarity_weights()

        # group the viable records per foreign cell
        per_cell_recs: Dict[str, List[Dict]] = {}
        for rec in self.records():
            if not _viable(rec) or rec["cell"] == target_key:
                continue
            per_cell_recs.setdefault(rec["cell"], []).append(rec)

        scored: List[Tuple[float, str]] = []
        for cell, recs in per_cell_recs.items():
            r = recs[0]
            try:
                sig = cell_signature(r.get("arch"), r.get("shape"),
                                     r.get("multi_pod", False))
            except (KeyError, TypeError):
                continue                 # cell from a foreign assignment
            scored.append((cell_similarity(target_sig, sig,
                                           weights=weights), cell))
        # deterministic: similarity desc, then cell key asc
        scored.sort(key=lambda t: (-t[0], t[1]))

        out: List[Dict[str, Any]] = []
        seen = set()
        for _, cell in scored[:max(0, k_cells)]:
            recs = sorted(per_cell_recs[cell],
                          key=lambda r: (r["cost_s"],
                                         r.get("ts", 0.0)))
            taken = 0
            for rec in recs:
                if taken >= per_cell:
                    break
                try:
                    cfg = config_from_dict(rec["config"])
                except (ValueError, TypeError):
                    continue             # older knob space: skip record
                d = cfg.as_dict()
                fp = json.dumps(d, sort_keys=True, default=str)
                if fp in seen:
                    continue
                seen.add(fp)
                out.append(d)
                taken += 1
        return out
