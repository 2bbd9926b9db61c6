"""Campaign fabric — lease-based multi-process (multi-host-ready) cell
distribution.

The campaign engine (core/campaign.py) interleaves many cells inside
one process; the fabric shards those cells *across* processes — and,
because coordination happens entirely through files in one shared
directory, across hosts that mount it.  Nothing about the unit of work
changes: a cell's per-strategy JSON checkpoint is still the resumable
state, the disk :class:`~repro_torch.core.measure.TimingCache` is still
the shared timing memo, and the ``history.jsonl`` trial store
(core/history.py) still accumulates every trial.  The fabric adds only
the *claiming* layer:

  * **leases** — a worker claims a cell by atomically creating
    ``leases/<cell>.lease`` (``O_CREAT | O_EXCL``) in the shared
    directory.  The lease records worker id, pid, host and a heartbeat
    timestamp with a TTL;
  * **heartbeats** — while a worker runs a cell's campaign, a daemon
    thread refreshes the lease (atomic tempfile + ``os.replace``) every
    ``ttl / 3`` seconds;
  * **recovery** — a lease whose heartbeat is older than its TTL is
    *expired*: any worker may steal it.  Stealing is race-free — the
    stealer ``os.rename``\\ s the lease file to a unique tombstone name
    (exactly one concurrent stealer wins the rename), unlinks it, and
    re-creates the lease via ``O_EXCL``.  Because the dead worker
    checkpointed after every absorbed batch, the stealer's campaign
    replays everything already absorbed and re-pays nothing;
  * **liveness caveat** — a worker paused longer than its TTL (not
    dead, just slow) can lose its lease and race the stealer on one
    cell.  Both then run the same deterministic cursor and publish
    whole checkpoints atomically, so the race costs duplicated trial
    evaluation, never a torn or wrong checkpoint.  The owner notices on
    its next heartbeat (:class:`LeaseLost`) and stops claiming credit.

Topologies:

  * ``FabricWorker`` — one process working a shared directory; start
    any number, on any host, at any time (``launch/tune.py --worker``);
  * ``run_coordinator`` — convenience: spawn N local workers over the
    same directory and wait (``launch/tune.py --workers N`` /
    ``--coordinate``).

Since the online scheduler (core/schedule.py), the shared directory is
also the *admission* channel: workers re-scan its ``intake/`` for new
cell submissions on every pass, claim cells in queue-priority order
(``--prioritize history``: highest expected speedup first), and with
``--watch`` idle instead of exiting once the board is drained — a
running fabric is a tuning service new workloads can join at any time.

**Filesystem requirements** — the protocol leans on three POSIX
semantics of the shared directory: atomic ``O_CREAT | O_EXCL`` create
(lease claims and steal locks — needs NFSv4+ if the mount is NFS; v2/v3
O_EXCL is not atomic), atomic same-directory ``rename`` (checkpoints,
compile-cache entries, heartbeats), and single-``write`` ``O_APPEND``
appends (the trial history, the quarantine ledger and the telemetry
event stream ``events.jsonl`` — local filesystems only; NFS may
interleave bytes across hosts, which the torn-tolerant readers survive
by *dropping* the damaged lines — acceptable for the history, where a
lost line only weakens warm-start retrieval, and for ``events.jsonl``,
where telemetry is observability and a dropped event only thins the
timeline/metrics, but NOT for ``quarantine.jsonl``, where a dropped
intent gives a worker-killing config a free extra evaluation — the
events file is accordingly written *non*-durable, no per-line fsync,
since its lines are never correctness signals).  Durability is
a fourth, quarantine-specific need: intent records must survive the
very worker crash they are recording, so the ledger (and the lease
heartbeats + STOP sentinels) is written with ``durable=True``
(``fsync`` before publish + parent-directory fsync,
core/fsutil.py).  Local disks and single-host multi-process use get
all four; for multi-host NFS campaigns the leases and checkpoints are
sound on v4+, and an object-store/rsync-backed history + quarantine
ledger is the roadmap item.

The coordinator passes workers an ``--evaluator module:factory``
dotted-path spec, so benchmarks and tests can swap the measured
:class:`~repro_torch.core.kernel_cell.DispatchEvaluator` for synthetic
surfaces.

This is the PyTorch port's copy of the reference's ``core/fabric.py``:
the lease, checkpoint, intake and STOP layouts and the telemetry event
names are byte-identical to the reference's.  It differs where a worker
meets the device:

  * a worker times its trials on ``device`` (``--device``, forwarded by
    :func:`worker_argv`; default ``cuda``), with its timing caches in
    the shared directory's ``timings/``, so every worker of one
    directory shares them; its own device evaluator walks one trial at
    a time;
  * each trial on a card holds the card's file lock
    (:func:`~repro_torch.core.trial.hold_device`), so the workers that
    share one card take turns on it trial by trial, and no two of their
    ``card`` spans overlap; the lock is the OS's, so a killed worker
    frees the card;
  * workers run ``python -m repro_torch.launch.tune`` with the port's
    ``src/`` root first on their ``PYTHONPATH`` (:func:`spawn_worker`),
    so a checkout that only put it on ``sys.path`` still spawns them;
  * a worker on a card empties PyTorch's allocator cache after each
    cell, since the workers of one card share its memory.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import telemetry as _telemetry
from repro_torch.core.campaign import (CHECKPOINT_VERSION, Campaign, CellSpec)
from repro_torch.core.executor import SweepExecutor
from repro_torch.core.fsutil import atomic_publish
from repro_torch.core.history import HISTORY_FILENAME, TrialHistory
from repro_torch.core.strategy import get_strategy

LEASE_DIR = "leases"
DEFAULT_TTL_S = 30.0
TIMINGS_DIR = "timings"     # the fleet's timing caches, in its directory
# the root of the port's package (``src/``): first on a spawned worker's
# PYTHONPATH
SRC_ROOT = pathlib.Path(__file__).resolve().parents[2]


class LeaseLost(RuntimeError):
    """The lease was stolen (our heartbeat went stale) or vanished."""


# ---------------------------------------------------------------- leases
@dataclasses.dataclass
class LeaseState:
    """The JSON payload of one lease file."""
    cell: str
    worker: str
    pid: int
    host: str
    acquired_at: float
    heartbeat_at: float
    ttl_s: float

    def expired(self, now: Optional[float] = None) -> bool:
        return (now or time.time()) - self.heartbeat_at > self.ttl_s

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


class Lease:
    """A held lease: refresh to keep it, release when the cell is done."""

    def __init__(self, board: "LeaseBoard", state: LeaseState):
        self.board = board
        self.state = state

    @property
    def cell(self) -> str:
        return self.state.cell

    def refresh(self) -> bool:
        """True if the heartbeat was written; False on lock contention
        (retry next beat); raises LeaseLost if no longer ours."""
        return self.board._refresh(self)

    def release(self) -> None:
        self.board._release(self)


class LeaseBoard:
    """Atomic file leases over the cells of one shared directory."""

    def __init__(self, directory: pathlib.Path,
                 worker_id: Optional[str] = None,
                 ttl_s: float = DEFAULT_TTL_S):
        self.dir = pathlib.Path(directory) / LEASE_DIR
        self.worker_id = worker_id or \
            f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:6]}"
        self.ttl_s = ttl_s
        # observability only — the FabricWorker points this at its bus;
        # claim/steal/lost decisions never read it
        self.telemetry = _telemetry.NULL

    def _path(self, cell: str) -> pathlib.Path:
        return self.dir / f"{cell}.lease"

    def read(self, cell: str) -> Optional[LeaseState]:
        """Parse a lease file; None if absent.  A torn/corrupt file is
        reported as an already-expired lease (stealable): lease writes
        are atomic, so torn content means a crashed foreign writer."""
        try:
            d = json.loads(self._path(cell).read_text())
            return LeaseState(**d)
        except FileNotFoundError:
            return None
        except (OSError, ValueError, TypeError):
            return LeaseState(cell=cell, worker="?", pid=0, host="?",
                              acquired_at=0.0, heartbeat_at=0.0,
                              ttl_s=self.ttl_s)

    def _write_new(self, path: pathlib.Path, state: LeaseState) -> bool:
        """O_CREAT|O_EXCL create — the atomic claim; False if held."""
        self.dir.mkdir(parents=True, exist_ok=True)
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL,
                         0o644)
        except FileExistsError:
            return False
        try:
            os.write(fd, json.dumps(state.as_dict()).encode())
        finally:
            os.close(fd)
        return True

    def _lock_path(self, cell: str) -> pathlib.Path:
        return self.dir / f"{cell}.lease.steal"

    def _try_lock(self, cell: str) -> bool:
        """The per-cell arbitration lock (``O_CREAT | O_EXCL``) both
        stealers and the owner's heartbeat serialize on, so neither can
        clobber a lease the other just (re)wrote.  A lock older than
        the TTL is a crashed holder's leftover and is cleared."""
        lock = self._lock_path(cell)
        try:
            os.close(os.open(lock, os.O_WRONLY | os.O_CREAT | os.O_EXCL,
                             0o644))
            return True
        except FileExistsError:
            try:
                if time.time() - lock.stat().st_mtime \
                        > max(5.0, self.ttl_s):
                    os.unlink(lock)      # crashed holder's leftover
            except OSError:
                pass
            return False                 # lost the arbitration: retry
        except FileNotFoundError:
            self.dir.mkdir(parents=True, exist_ok=True)
            return False

    def _unlock(self, cell: str) -> None:
        try:
            os.unlink(self._lock_path(cell))
        except OSError:
            pass

    def _bury_expired(self, cell: str) -> bool:
        """Remove the cell's lease iff it is (still) expired — the lock
        holder re-reads the lease *under the lock* before unlinking, so
        a fresh lease created between a stealer's first read and its
        steal can never be clobbered (that race loses live leases)."""
        path = self._path(cell)
        if not self._try_lock(cell):
            return False
        try:
            held = self.read(cell)
            if held is None:
                return True              # vanished: claimable
            if not held.expired():
                return False             # revived under us: keep it
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass
            return True
        finally:
            self._unlock(cell)

    def try_acquire(self, cell: str) -> Optional[Lease]:
        """Claim a cell; None if a live worker holds it.  Expired
        leases (crashed workers) are stolen."""
        path = self._path(cell)
        stole = False
        for _ in range(4):               # bounded retries under races
            now = time.time()
            state = LeaseState(cell=cell, worker=self.worker_id,
                               pid=os.getpid(),
                               host=socket.gethostname(),
                               acquired_at=now, heartbeat_at=now,
                               ttl_s=self.ttl_s)
            if self._write_new(path, state):
                tel = self.telemetry
                if tel.enabled:
                    tel.emit("lease.steal" if stole else "lease.claim",
                             cell=cell, ttl_s=self.ttl_s)
                return Lease(self, state)
            held = self.read(cell)
            if held is not None and not held.expired():
                return None              # a live worker owns the cell
            if self._bury_expired(cell):  # steal: verified, then retry
                stole = True
        return None

    def _refresh(self, lease: Lease) -> bool:
        """Bump the heartbeat (atomic replace under the per-cell
        arbitration lock, so a stealer's freshly-created lease can
        never be clobbered by a stale owner's write).  Returns False
        when the lock is contended — skip this beat, the heartbeat
        retries next interval.  Raises :class:`LeaseLost` if the lease
        on disk is no longer ours *or already expired* (we cannot know
        whether a stealer is about to take it — stop claiming it)."""
        cell = lease.state.cell
        if not self._try_lock(cell):
            return False
        try:
            held = self.read(cell)
            if held is None or held.worker != self.worker_id \
                    or held.expired():
                tel = self.telemetry
                if tel.enabled:
                    tel.emit("lease.lost", cell=cell,
                             holder=held.worker if held else None)
                raise LeaseLost(
                    f"lease for {cell}: "
                    + ("expired before refresh" if held is not None
                       and held.worker == self.worker_id else
                       f"now held by "
                       f"{held.worker if held else 'nobody'}"))
            lease.state.heartbeat_at = time.time()
            # durable: a heartbeat that evaporates in a host crash reads
            # as a stale lease and triggers a false steal
            atomic_publish(self._path(cell),
                           json.dumps(lease.state.as_dict()),
                           prefix=".hb.", durable=True)
            return True
        finally:
            self._unlock(cell)

    def _release(self, lease: Lease) -> None:
        held = self.read(lease.state.cell)
        if held is not None and held.worker == self.worker_id:
            try:
                os.unlink(self._path(lease.state.cell))
            except FileNotFoundError:
                pass
            tel = self.telemetry
            if tel.enabled:
                tel.emit("lease.release", cell=lease.state.cell)

    def held(self) -> List[LeaseState]:
        """Every lease currently on the board (including expired ones)."""
        if not self.dir.exists():
            return []
        out = []
        for p in sorted(self.dir.glob("*.lease")):
            st = self.read(p.name[:-len(".lease")])
            if st is not None:
                out.append(st)
        return out

    def reap_expired(self) -> List[str]:
        """Bury every expired lease (e.g. leftovers of crashed workers
        on already-done cells); returns the buried cell keys."""
        out = []
        for st in self.held():
            if st.expired() and self._bury_expired(st.cell):
                out.append(st.cell)
        return out

    def clear(self, cells: Sequence[str]) -> None:
        """Unconditionally remove these cells' leases and any steal
        locks (``--fresh`` on a quiescent board)."""
        for cell in cells:
            for suffix in ("", ".steal"):
                try:
                    os.unlink(self._path(cell).with_name(
                        f"{cell}.lease{suffix}"))
                except OSError:
                    pass


class Heartbeat:
    """Context manager: refresh a lease from a daemon thread while the
    worker runs the cell's campaign.  If the lease is lost (stolen
    after a too-long pause), ``lost`` flips and refreshing stops — the
    campaign itself keeps running safely (see module docstring)."""

    def __init__(self, lease: Lease, interval: Optional[float] = None):
        self.lease = lease
        self.interval = interval or max(0.05, lease.state.ttl_s / 3.0)
        self.lost = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.lease.refresh()
            except LeaseLost:
                self.lost = True
                return
            except OSError:
                pass                     # transient fs hiccup: retry

    def __enter__(self) -> "Heartbeat":
        self._thread = threading.Thread(target=self._loop,
                                        name="lease-heartbeat",
                                        daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


# --------------------------------------------------------------- worker
def load_evaluator(spec: Optional[str], device="cuda",
                   cache_dir: Optional[pathlib.Path] = None) -> Callable:
    """Resolve an ``--evaluator module:factory`` dotted-path spec (the
    factory is called with no arguments); default: the kernel-aware
    :class:`~repro_torch.core.kernel_cell.DispatchEvaluator` on
    ``device``, its timing caches in ``cache_dir``."""
    if not spec:
        from repro_torch.core.kernel_cell import DispatchEvaluator
        return DispatchEvaluator(device=device, cache_dir=cache_dir)
    mod, sep, attr = spec.partition(":")
    if not sep or not attr:
        raise ValueError(f"evaluator spec {spec!r}: want module:factory")
    return getattr(importlib.import_module(mod), attr)()


def checkpoint_done(directory: pathlib.Path, cell: str,
                    strategy: str) -> bool:
    """Cheap completion check: the cell's checkpoint says done under
    this strategy.  This is the *weak* form (no signature validation) —
    the worker and coordinator use :meth:`Campaign.cell_done`, which
    additionally validates the threshold/baseline/walk/warm-start
    signature, so a done checkpoint from different parameters is
    re-claimed and re-tuned exactly as the single-process campaign
    would."""
    path = pathlib.Path(directory) / f"{cell}.json"
    try:
        d = json.loads(path.read_text())
    except (OSError, ValueError):
        return False
    return (isinstance(d, dict)
            and d.get("version") == CHECKPOINT_VERSION
            and d.get("strategy") == strategy
            and bool(d.get("done")))


class FabricWorker:
    """One process of the fabric: claim cells via leases, run each
    claimed cell's (checkpointed, resumable) single-cell campaign to
    completion, repeat until every target cell is done.

    Start any number of workers over the same ``directory`` — locally
    via :func:`run_coordinator`, or independently on other hosts
    against a shared mount.  ``evaluator`` defaults to the
    kernel-aware :class:`~repro_torch.core.kernel_cell.DispatchEvaluator`
    on ``device`` (measured steps, kernel benches and serve replays),
    whose timing caches in ``<directory>/timings`` are shared with
    every other worker; that evaluator walks one trial at a time, and
    with ``measure_top_k`` the measured tier's default is built on the
    same device and caches.

    **Online mode** (core/schedule.py) — target cells are not frozen at
    startup: every scheduling pass re-scans the shared directory's
    ``intake/`` and admits new submissions, and the claim order follows
    the cell queue's priority (``prioritize="history"``: highest
    expected speedup first, unknown cells explore-first; ``"arch"``:
    the historical arch-grouped order).  With ``watch=True`` a worker
    that has drained the board *idles and keeps re-scanning* instead of
    exiting, so cells submitted hours later are claimed by the same
    process; the ``intake/STOP`` sentinel (``launch/tune.py --stop``)
    ends the watch once everything admitted is done.

    ``ready_file`` / ``go_file`` implement an optional start barrier
    for benchmarks: the worker touches ``ready_file`` once initialized,
    then blocks until ``go_file`` exists — so measured wall-clock
    covers fabric work, not interpreter/torch cold start.
    """

    def __init__(self, cells: Sequence[CellSpec],
                 directory: pathlib.Path, *,
                 strategy: str = "tree",
                 strategy_options: Optional[Dict[str, Any]] = None,
                 threshold: float = 0.05,
                 evaluator: Optional[Callable] = None,
                 baseline_factory: Optional[Callable] = None,
                 worker_id: Optional[str] = None,
                 ttl_s: float = DEFAULT_TTL_S,
                 poll_s: float = 0.5,
                 warm_start: bool = False,
                 warm_start_cells: int = 2,
                 warm_start_per_cell: int = 1,
                 max_workers: Optional[int] = None,
                 prioritize: Any = "arch",
                 watch: bool = False,
                 started_at: Optional[float] = None,
                 ready_file: Optional[pathlib.Path] = None,
                 go_file: Optional[pathlib.Path] = None,
                 trial_timeout_s: Optional[float] = None,
                 max_retries: int = 0,
                 strike_threshold: Optional[int] = None,
                 measure_top_k: int = 0,
                 measured_evaluator: Optional[Callable] = None,
                 promote: bool = False,
                 trace: bool = False,
                 device="cuda"):
        if not cells and not watch:
            raise ValueError("fabric worker needs at least one cell "
                             "(or watch mode: claim intake submissions)")
        self.cells = list(cells)
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.strategy = get_strategy(strategy)
        self.strategy_options = dict(strategy_options or {})
        self.threshold = threshold
        self.device = torch.device(device)
        timings = self.dir / TIMINGS_DIR
        if evaluator is None:
            # the device's own evaluator times one trial at a time
            evaluator = load_evaluator(None, self.device, timings)
            if max_workers is None:
                max_workers = 1
        if measured_evaluator is None and measure_top_k:
            from repro_torch.core.measure import default_measured_evaluator
            measured_evaluator = default_measured_evaluator(
                cache_dir=timings, device=self.device)
        self.evaluator = evaluator
        self.baseline_factory = baseline_factory
        self.board = LeaseBoard(self.dir, worker_id=worker_id,
                                ttl_s=ttl_s)
        # telemetry (core/telemetry.py): with trace=True this worker
        # appends span events to the shared <dir>/events.jsonl — and
        # installs the bus process-globally so the deep layers
        # (CompileCache, TimingCache, SLOGuard, Quarantine) emit too.
        # Observability only: decisions are bit-identical either way.
        if trace:
            self.telemetry = _telemetry.install(_telemetry.Telemetry(
                self.dir, worker=self.board.worker_id))
        else:
            self.telemetry = _telemetry.current()
        self.board.telemetry = self.telemetry
        self.log = _telemetry.get_logger(self.board.worker_id)
        self.poll_s = poll_s
        self.warm_start = warm_start
        self.warm_start_cells = warm_start_cells
        self.warm_start_per_cell = warm_start_per_cell
        self.max_workers = max_workers
        self.history = TrialHistory(self.dir / HISTORY_FILENAME)
        self.prioritize = prioritize
        self.watch = bool(watch)
        # the reference instant for stale-STOP clearing: callers that
        # pay long imports before constructing the worker (the CLI)
        # pass their process start; a STOP dropped after it is live
        self.started_at = started_at if started_at is not None \
            else time.time()
        self.ready_file = ready_file
        self.go_file = go_file
        self.trial_timeout_s = trial_timeout_s
        self.max_retries = int(max_retries)
        # measured tier: the disk TimingCache inside the default
        # measured evaluator is shared fleet-wide exactly like the
        # compile cache, so a re-claimed cell's re-rank re-pays nothing
        self.measure_top_k = int(measure_top_k)
        self.measured_evaluator = measured_evaluator
        # serving promotion (serving/canary.py): after each completed
        # cell, publish its surviving winner to the shared directory's
        # per-cell live-config board (the board itself enforces the
        # never-regress rule, so concurrent workers stay safe)
        self.promote = bool(promote)
        # one fleet-shared evaluation-intent ledger (core/quarantine.py)
        # over the campaign directory: every worker brackets trials with
        # intent/completion records and skips quarantined configs
        from repro_torch.core.quarantine import Quarantine
        self.quarantine = Quarantine(
            self.dir, worker=self.board.worker_id,
            **({"strike_threshold": strike_threshold}
               if strike_threshold is not None else {}))
        # the completion probe: a Campaign that never runs, only asks
        # cell_done() — full signature validation (threshold, baseline,
        # walk, warm-start seeds), so a done checkpoint from different
        # parameters is re-claimed and re-tuned
        self._probe = Campaign(
            self.cells, strategy=self.strategy.name,
            strategy_options=self.strategy_options,
            threshold=self.threshold, evaluator=self.evaluator,
            baseline_factory=self.baseline_factory,
            checkpoint_dir=self.dir, history=self.history,
            warm_start=self.warm_start,
            warm_start_cells=self.warm_start_cells,
            warm_start_per_cell=self.warm_start_per_cell,
            measure_top_k=self.measure_top_k,  # cell_done gates on it
            quarantine=False,            # probe never evaluates
            intake=True)    # probe only; also admits the no-seed case

    # ------------------------------------------------------------ cells
    def _done(self, spec: CellSpec) -> bool:
        return self._probe.cell_done(spec)

    def _run_cell(self, spec: CellSpec, lease: Lease) -> Dict:
        camp = Campaign(
            [spec], strategy=self.strategy.name,
            strategy_options=self.strategy_options,
            threshold=self.threshold, evaluator=self.evaluator,
            baseline_factory=self.baseline_factory,
            checkpoint_dir=self.dir, history=self.history,
            warm_start=self.warm_start,
            warm_start_cells=self.warm_start_cells,
            warm_start_per_cell=self.warm_start_per_cell,
            max_workers=self.max_workers,
            trial_timeout_s=self.trial_timeout_s,
            max_retries=self.max_retries,
            measure_top_k=self.measure_top_k,
            measured_evaluator=self.measured_evaluator,
            quarantine=self.quarantine,
            telemetry=self.telemetry)
        with Heartbeat(lease) as hb:
            reports = camp.run()
        if self.device.type == "cuda":
            # the workers of one card share its memory
            torch.cuda.empty_cache()
        if self.promote and reports:
            from repro_torch.serving.canary import promote_winners
            promote_winners(self.dir, reports,
                            source=self.board.worker_id)
        stats = dict(camp.last_stats)
        stats["lease_lost"] = hb.lost
        return stats

    # -------------------------------------------------------------- run
    def run(self) -> Dict[str, Any]:
        """Work the board until every admitted cell is done (or, with
        ``watch``, until the STOP sentinel lands); returns per-worker
        stats (cells completed here, trials, waits, admissions).

        Every pass re-scans the intake directory (live admission) and
        claims in cell-queue priority order.  The lease board stays the
        sole claim arbiter — the queue only decides which cell this
        worker *tries* next, so two workers ranking the board
        identically still split it cleanly."""
        from repro_torch.core.schedule import CellQueue, stop_requested_since
        if self.ready_file is not None:
            self.ready_file.parent.mkdir(parents=True, exist_ok=True)
            self.ready_file.touch()
        if self.go_file is not None:
            while not self.go_file.exists():
                time.sleep(0.05)
        t0 = time.time()
        if self.telemetry.enabled:
            self.telemetry.emit("worker.start", watch=self.watch,
                                cells=len(self.cells))
        self.log.info(f"worker up: {len(self.cells)} target cell(s)"
                      f"{', watch' if self.watch else ''}")
        queue = CellQueue(self.cells, prioritizer=self.prioritize,
                          history=self.history, directory=self.dir)
        completed: List[str] = []
        evaluated = replayed = 0
        lease_losses = 0
        waited_s = 0.0
        while True:
            queue.scan_intake()
            for spec in queue.cells():
                if queue.state(spec.key()) != "done" \
                        and self._done(spec):
                    queue.mark_done(spec.key())
            remaining = queue.order()    # pending, priority order
            if not remaining:
                # board drained: exit — unless watching for late
                # submissions and no STOP has landed *for this
                # session* (a sentinel predating this worker targets a
                # previous session and is ignored, never deleted — see
                # core/schedule.request_stop)
                if not self.watch or stop_requested_since(
                        self.dir, self.started_at):
                    break
                time.sleep(self.poll_s)
                waited_s += self.poll_s
                continue
            progress = False
            for spec in remaining:
                lease = self.board.try_acquire(spec.key())
                if lease is None:
                    continue
                try:
                    if self._done(spec):
                        continue         # raced: finished by another worker
                    self.log.info(f"claimed {spec.key()}")
                    stats = self._run_cell(spec, lease)
                    completed.append(spec.key())
                    evaluated += stats.get("evaluated_trials", 0)
                    replayed += stats.get("replayed_trials", 0)
                    lease_losses += bool(stats.get("lease_lost"))
                    if stats.get("lease_lost"):
                        self.log.warn(f"lease lost on {spec.key()} "
                                      "(heartbeat went stale)")
                    self.log.info(
                        f"completed {spec.key()}: "
                        f"{stats.get('evaluated_trials', 0)} evaluated, "
                        f"{stats.get('replayed_trials', 0)} replayed")
                    progress = True
                finally:
                    lease.release()
                queue.mark_done(spec.key())
                if self.telemetry.enabled:
                    # refresh the live metrics snapshot after each cell
                    # (atomic last-writer-wins over the shared events)
                    _telemetry.publish_metrics(self.dir)
                break                    # re-rank: priority may have moved
            if not progress:
                # every remaining cell is leased by a live worker — wait
                # for them (or for their leases to expire) and re-scan
                self.log.debug("board contended/drained: waiting "
                               f"{self.poll_s}s")
                time.sleep(self.poll_s)
                waited_s += self.poll_s
        snap = queue.snapshot()
        if self.telemetry.enabled:
            self.telemetry.emit("worker.stop", cells=len(completed),
                                evaluated=evaluated, replayed=replayed,
                                wall_s=round(time.time() - t0, 2))
            _telemetry.publish_metrics(self.dir)
        self.log.info(f"worker done: {len(completed)} cell(s), "
                      f"{evaluated} trials evaluated")
        return {
            "worker": self.board.worker_id,
            "cells_completed": completed,
            "evaluated_trials": evaluated,
            "replayed_trials": replayed,
            "lease_losses": lease_losses,
            "cells_admitted": snap["admitted"],
            "intake_admitted": snap["from_intake"],
            "prioritize": snap["prioritize"],
            "waited_s": round(waited_s, 2),
            "wall_s": round(time.time() - t0, 2),
        }


# ---------------------------------------------------------- coordinator
def worker_argv(cells: Sequence[CellSpec], directory: pathlib.Path, *,
                strategy: str = "tree",
                evaluator_spec: Optional[str] = None,
                ttl_s: float = DEFAULT_TTL_S,
                threshold: float = 0.05,
                warm_start: bool = False,
                prioritize: str = "arch",
                watch: bool = False,
                worker_id: Optional[str] = None,
                ready_file: Optional[pathlib.Path] = None,
                go_file: Optional[pathlib.Path] = None,
                trial_timeout_s: Optional[float] = None,
                max_retries: int = 0,
                strike_threshold: Optional[int] = None,
                measure_top_k: int = 0,
                measured_evaluator_spec: Optional[str] = None,
                slo_ttft: Optional[float] = None,
                promote: bool = False,
                trace: bool = False,
                extra: Sequence[str] = (),
                device: Optional[str] = None) -> List[str]:
    """The ``launch/tune.py --worker`` command line for one worker (the
    reference's, but for the module name and ``--device``)."""
    argv = [sys.executable, "-m", "repro_torch.launch.tune", "--worker",
            "--dir", str(directory),
            "--strategy", strategy,
            "--threshold", str(threshold),
            "--worker-ttl", str(ttl_s)]
    if cells:
        argv += ["--cells", ",".join(c.spec() for c in cells)]
    if evaluator_spec:
        argv += ["--evaluator", evaluator_spec]
    if warm_start:
        argv += ["--warm-start"]
    if trial_timeout_s is not None:
        argv += ["--trial-timeout", str(trial_timeout_s)]
    if max_retries:
        argv += ["--max-retries", str(max_retries)]
    if strike_threshold is not None:
        argv += ["--strike-threshold", str(strike_threshold)]
    if measure_top_k:
        argv += ["--measure-top-k", str(measure_top_k)]
    if measured_evaluator_spec:
        argv += ["--measured-evaluator", measured_evaluator_spec]
    if slo_ttft is not None:
        argv += ["--slo-ttft", str(slo_ttft)]
    if promote:
        argv += ["--promote"]
    if trace:
        argv += ["--trace"]
    if prioritize != "arch":
        argv += ["--prioritize", prioritize]
    if watch:
        argv += ["--watch"]
    if worker_id:
        argv += ["--worker-id", worker_id]
    if ready_file is not None:
        argv += ["--ready-file", str(ready_file)]
    if go_file is not None:
        argv += ["--go-file", str(go_file)]
    if device is not None:
        argv += ["--device", str(device)]
    argv += list(extra)
    return argv


def spawn_worker(cells: Sequence[CellSpec], directory: pathlib.Path, *,
                 log_path: Optional[pathlib.Path] = None,
                 env: Optional[Dict[str, str]] = None,
                 **kw) -> subprocess.Popen:
    """Spawn one detached local worker process (see :func:`worker_argv`
    for the keyword options), with the port's ``src/`` root first on
    its ``PYTHONPATH``."""
    argv = worker_argv(cells, directory, **kw)
    env = dict(env or os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC_ROOT)] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    if log_path is not None:
        log_path.parent.mkdir(parents=True, exist_ok=True)
        out = open(log_path, "ab")
    else:
        out = subprocess.DEVNULL
    try:
        return subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT,
                                env=env)
    finally:
        if out is not subprocess.DEVNULL:
            out.close()


def run_coordinator(cells: Sequence[CellSpec],
                    directory: pathlib.Path, *,
                    workers: int = 2,
                    strategy: str = "tree",
                    strategy_options: Optional[Dict[str, Any]] = None,
                    evaluator_spec: Optional[str] = None,
                    ttl_s: float = DEFAULT_TTL_S,
                    threshold: float = 0.05,
                    warm_start: bool = False,
                    prioritize: str = "arch",
                    watch: bool = False,
                    trial_timeout_s: Optional[float] = None,
                    max_retries: int = 0,
                    strike_threshold: Optional[int] = None,
                    measure_top_k: int = 0,
                    measured_evaluator_spec: Optional[str] = None,
                    slo_ttft: Optional[float] = None,
                    promote: bool = False,
                    trace: bool = False,
                    extra_args: Sequence[str] = (),
                    log_dir: Optional[pathlib.Path] = None,
                    timeout_s: Optional[float] = None,
                    device: Optional[str] = None) -> Dict[str, Any]:
    """Spawn N local workers over one shared directory, wait for them,
    verify completion and collect the per-cell reports.

    With ``watch=True`` the workers stay alive after draining the board
    and keep claiming intake submissions; the coordinator then blocks
    until someone requests a stop (``launch/tune.py --stop`` /
    :func:`~repro_torch.core.schedule.request_stop`) and the workers drain
    out.  Cells admitted through the intake directory while the fabric
    ran are verified and reported exactly like the seed cells.

    Completion is verified with the same full-signature probe the
    workers use (:meth:`Campaign.cell_done` with ``strategy_options`` /
    ``threshold`` / ``warm_start`` and the default baseline the worker
    CLI tunes with), so a stale-parameter checkpoint counts as
    incomplete rather than being silently published.  Returns
    ``{"reports": {cell: report}, "stats": {...}}``; raises
    ``RuntimeError`` if any cell is incomplete or a lease is left held
    after the workers exit (expired leftovers are reaped first).
    """
    from repro_torch.core.schedule import scan_intake
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = []
    for i in range(workers):
        log = (pathlib.Path(log_dir) / f"worker-{i}.log") \
            if log_dir else None
        procs.append(spawn_worker(
            cells, directory, strategy=strategy,
            evaluator_spec=evaluator_spec, ttl_s=ttl_s,
            threshold=threshold, warm_start=warm_start,
            prioritize=prioritize, watch=watch,
            worker_id=f"w{i}-{uuid.uuid4().hex[:6]}",
            trial_timeout_s=trial_timeout_s, max_retries=max_retries,
            strike_threshold=strike_threshold,
            measure_top_k=measure_top_k,
            measured_evaluator_spec=measured_evaluator_spec,
            slo_ttft=slo_ttft, promote=promote, trace=trace,
            extra=extra_args, log_path=log, device=device))
    rcs = [p.wait(timeout=timeout_s) for p in procs]
    wall = time.time() - t0

    # the worker-side queue admits intake submissions live; fold them
    # into the verification set so an admitted cell is held to the same
    # completion bar as a seed cell
    all_cells = list(cells)
    known = {c.key() for c in all_cells}
    for admitted in scan_intake(directory):
        if admitted.key() not in known:
            known.add(admitted.key())
            all_cells.append(admitted)

    board = LeaseBoard(directory, ttl_s=ttl_s)
    reaped = board.reap_expired()
    leftover = board.held()
    spec = get_strategy(strategy)
    probe = Campaign(all_cells, strategy=strategy,
                     strategy_options=strategy_options,
                     threshold=threshold,
                     evaluator=lambda wl, rt: None,  # probe never runs
                     checkpoint_dir=directory, warm_start=warm_start,
                     measure_top_k=measure_top_k,
                     quarantine=False, intake=True)
    reports: Dict[str, Any] = {}
    incomplete = []
    for cell in all_cells:
        path = directory / f"{cell.key()}.json"
        if not probe.cell_done(cell):
            incomplete.append(cell.key())
            continue
        d = json.loads(path.read_text())
        reports[cell.key()] = spec.load_report(d["report"])
    stats = {
        "workers": workers,
        "strategy": spec.name,
        "cells": len(all_cells),
        "seed_cells": len(cells),
        "intake_cells": len(all_cells) - len(cells),
        "prioritize": prioritize,
        "watch": watch,
        "wall_s": round(wall, 2),
        "cells_per_hour": round(len(all_cells) / max(wall, 1e-9)
                                * 3600.0, 1),
        "worker_rcs": rcs,
        "reaped_leases": reaped,
        "leases_left": [st.cell for st in leftover],
        "incomplete_cells": incomplete,
    }
    if incomplete or leftover or any(rcs):
        raise RuntimeError(f"fabric run incomplete: {stats}")
    return {"reports": reports, "stats": stats}
