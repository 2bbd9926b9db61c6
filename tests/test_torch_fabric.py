"""The port's fabric (core/fabric.py) against the reference's, on the
synthetic surfaces: every case of ``tests/test_fabric.py`` and the
watch-fabric cases of ``tests/test_schedule.py`` run through both
packages (``_torch_surface.PKGS``), and the checkpoints, history rows and
reports the two write are byte-identical.  Then what is the port's own:
the card's file lock across processes (core/trial.hold_device), the
build's per-process objects (kernels/_build.py), the fleet modes of
``launch/tune.py`` as subprocesses on the CPU, and ``--all``/``--status``.
"""
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import pytest

from _torch_surface import PKGS, history_rows

ROOT = pathlib.Path(__file__).resolve().parents[1]
TESTS = pathlib.Path(__file__).resolve().parent
SPECS = ("smollm-135m:train_4k,smollm-135m:prefill_32k,glm4-9b:train_4k,"
         "xlstm-1.3b:decode_32k")
NAMES = sorted(PKGS)


def _cells(p, specs=SPECS):
    return p.campaign.parse_cells(specs)


def _baseline(p):
    return lambda spec: p.params.default_config(shard_strategy="fsdp_tp",
                                                attn_impl="pallas")


def _surface(p):
    """``tests/test_campaign.surface`` (one crash region) as package
    ``p``'s results."""
    def surface(wl, rt):
        if wl.arch == "glm4-9b" and rt.remat_policy == "full":
            return p.trial.TrialResult(cost_s=float("inf"), crashed=True)
        c = 100.0 + 3.0 * len(wl.arch)
        if rt.compute_dtype == "bfloat16":
            c *= 0.7
        if rt.shard_strategy == "tp":
            c *= 0.9
        if rt.shard_strategy == "fsdp":
            c *= 1.1
        if rt.remat_policy == "none":
            c *= 1.2 if wl.arch == "glm4-9b" else 0.85
        if rt.microbatches == 2:
            c *= 0.97
        if rt.kv_cache_dtype == "int8":
            c *= 0.8
        if rt.attn_block_q == 256:
            c *= 0.92
        return p.trial.TrialResult(cost_s=round(c, 6))
    return surface


class Counting:
    """The surface, counting its calls; raises KeyboardInterrupt (a
    simulated kill) after ``fail_after`` of them."""

    def __init__(self, p, fail_after=None):
        self.calls, self.lock = [], threading.Lock()
        self.fail_after, self.fn = fail_after, _surface(p)

    def __call__(self, wl, rt):
        with self.lock:
            self.calls.append((wl.key(), rt.as_dict()))
            if self.fail_after is not None \
                    and len(self.calls) > self.fail_after:
                raise KeyboardInterrupt("simulated kill")
        return self.fn(wl, rt)


def _worker(p, cells, d, evaluator=None, **kw):
    return p.fabric.FabricWorker(cells, d, evaluator=evaluator or
                                 _surface(p), baseline_factory=_baseline(p),
                                 **kw)


def _files(d):
    """Every checkpoint's bytes, and the history rows."""
    out = {f.name: f.read_text() for f in sorted(d.glob("*.json"))}
    if (d / "history.jsonl").exists():
        out["history.jsonl"] = history_rows(d / "history.jsonl")
    return out


# ---------------------------------------------------------------- leases
@pytest.mark.parametrize("pkg", NAMES)
def test_lease_exclusive_until_released(pkg, tmp_path):
    f = PKGS[pkg].fabric
    a = f.LeaseBoard(tmp_path, worker_id="a", ttl_s=30)
    b = f.LeaseBoard(tmp_path, worker_id="b", ttl_s=30)
    lease = a.try_acquire("cell-1")
    assert lease is not None
    assert b.try_acquire("cell-1") is None
    assert b.try_acquire("cell-2") is not None    # other cells are free
    lease.release()
    assert b.try_acquire("cell-1") is not None


@pytest.mark.parametrize("pkg", NAMES)
def test_expired_lease_is_stolen(pkg, tmp_path):
    f = PKGS[pkg].fabric
    a = f.LeaseBoard(tmp_path, worker_id="a", ttl_s=0.1)
    b = f.LeaseBoard(tmp_path, worker_id="b", ttl_s=30)
    assert a.try_acquire("cell-1") is not None
    assert b.try_acquire("cell-1") is None        # still fresh
    time.sleep(0.15)
    stolen = b.try_acquire("cell-1")
    assert stolen is not None and stolen.state.worker == "b"


@pytest.mark.parametrize("pkg", NAMES)
def test_steal_race_single_winner(pkg, tmp_path):
    f = PKGS[pkg].fabric
    dead = f.LeaseBoard(tmp_path, worker_id="dead", ttl_s=0.05)
    assert dead.try_acquire("cell-1") is not None
    time.sleep(0.1)
    boards = [f.LeaseBoard(tmp_path, worker_id=f"w{i}", ttl_s=30)
              for i in range(6)]
    got = [None] * len(boards)

    def claim(i):
        got[i] = boards[i].try_acquire("cell-1")

    ts = [threading.Thread(target=claim, args=(i,))
          for i in range(len(boards))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    winners = [lease for lease in got if lease is not None]
    assert len(winners) == 1
    held = f.LeaseBoard(tmp_path).held()
    assert [st.worker for st in held] == [winners[0].state.worker]


@pytest.mark.parametrize("pkg", NAMES)
def test_heartbeat_keeps_lease_fresh_then_expires(pkg, tmp_path):
    f = PKGS[pkg].fabric
    a = f.LeaseBoard(tmp_path, worker_id="a", ttl_s=0.4)
    b = f.LeaseBoard(tmp_path, worker_id="b", ttl_s=30)
    lease = a.try_acquire("cell-1")
    with f.Heartbeat(lease, interval=0.1):
        time.sleep(0.8)                  # > ttl, but heartbeats refresh
        assert b.try_acquire("cell-1") is None
    time.sleep(0.5)                      # heartbeat stopped: expires
    assert b.try_acquire("cell-1") is not None


@pytest.mark.parametrize("pkg", NAMES)
def test_refresh_after_steal_raises_lease_lost(pkg, tmp_path):
    f = PKGS[pkg].fabric
    a = f.LeaseBoard(tmp_path, worker_id="a", ttl_s=0.05)
    b = f.LeaseBoard(tmp_path, worker_id="b", ttl_s=30)
    lease = a.try_acquire("cell-1")
    time.sleep(0.1)
    assert b.try_acquire("cell-1") is not None
    with pytest.raises(f.LeaseLost):
        lease.refresh()


@pytest.mark.parametrize("pkg", NAMES)
def test_torn_lease_file_is_stealable(pkg, tmp_path):
    f = PKGS[pkg].fabric
    board = f.LeaseBoard(tmp_path, worker_id="w", ttl_s=30)
    (tmp_path / "leases").mkdir()
    (tmp_path / "leases" / "cell-1.lease").write_text("{torn")
    lease = board.try_acquire("cell-1")
    assert lease is not None and lease.state.worker == "w"


@pytest.mark.parametrize("pkg", NAMES)
def test_claim_in_flight_reads_as_torn_and_is_stolen(pkg, tmp_path):
    """The reference's claim creates the lease file (``O_EXCL``) and then
    writes it, so a board that reads it in between sees a torn lease and
    steals it: two workers then walk one cell.  Held as-is in the port
    (ROADMAP.md queue C)."""
    f = PKGS[pkg].fabric
    board = f.LeaseBoard(tmp_path, worker_id="w", ttl_s=30)
    (tmp_path / "leases").mkdir()
    (tmp_path / "leases" / "cell-1.lease").touch()    # created, not written
    lease = board.try_acquire("cell-1")
    assert lease is not None and lease.state.worker == "w"


@pytest.mark.parametrize("pkg", NAMES)
def test_reap_expired(pkg, tmp_path):
    f = PKGS[pkg].fabric
    a = f.LeaseBoard(tmp_path, worker_id="a", ttl_s=0.05)
    b = f.LeaseBoard(tmp_path, worker_id="b", ttl_s=30)
    a.try_acquire("done-cell")
    b.try_acquire("live-cell")
    time.sleep(0.1)
    board = f.LeaseBoard(tmp_path, ttl_s=30)
    assert board.reap_expired() == ["done-cell"]
    assert [st.cell for st in board.held()] == ["live-cell"]


def test_lease_files_identical(tmp_path):
    """A lease's JSON keys and the board's layout are the reference's: a
    lease the port writes reads back on the reference's board."""
    port = PKGS["port"].fabric.LeaseBoard(tmp_path, worker_id="p", ttl_s=7)
    port.try_acquire("cell-1")
    ref = PKGS["ref"].fabric.LeaseBoard(tmp_path, worker_id="r", ttl_s=7)
    assert ref.try_acquire("cell-1") is None
    (held,) = ref.held()
    assert (held.worker, held.ttl_s) == ("p", 7)
    assert [x.name for x in (tmp_path / "leases").iterdir()] \
        == ["cell-1.lease"]


# --------------------------------------------------------------- workers
@pytest.mark.parametrize("pkg", NAMES)
def test_single_worker_matches_single_process_campaign(pkg, tmp_path):
    p = PKGS[pkg]
    cells = _cells(p)
    worker = _worker(p, cells, tmp_path / "fab", ttl_s=30)
    stats = worker.run()
    assert sorted(stats["cells_completed"]) == sorted(c.key() for c in cells)
    assert p.fabric.LeaseBoard(tmp_path / "fab").held() == []
    ref = p.campaign.Campaign(cells, evaluator=_surface(p),
                              baseline_factory=_baseline(p),
                              checkpoint_dir=tmp_path / "ref").run()
    for spec in cells:
        assert p.fabric.checkpoint_done(tmp_path / "fab", spec.key(), "tree")
        d = json.loads((tmp_path / "fab" / f"{spec.key()}.json").read_text())
        rep = worker.strategy.load_report(d["report"])
        assert p.campaign.tuning_fingerprint(rep) \
            == p.campaign.tuning_fingerprint(ref[spec.key()])
    # every evaluated trial landed in the shared history
    assert worker.history.n_records() == sum(r.n_trials for r in ref.values())


def test_single_worker_files_identical(tmp_path):
    """One worker over the board: the two packages' checkpoints, history
    rows, stats and reports are the same bytes."""
    out = {}
    for name, p in PKGS.items():
        worker = _worker(p, _cells(p), tmp_path / name, worker_id="w0",
                         ttl_s=30)
        stats = worker.run()
        for k in ("wall_s", "waited_s", "worker"):
            stats.pop(k)
        reports = {}
        for spec in _cells(p):
            ck = json.loads((tmp_path / name / f"{spec.key()}.json")
                            .read_text())
            reports[spec.key()] = worker.strategy.load_report(ck["report"])
        out[name] = (_files(tmp_path / name), stats,
                     p.report.strategy_markdown(reports))
    assert out["port"] == out["ref"]


def _one_claim_at_a_time(monkeypatch, p):
    lock, claim = threading.Lock(), p.fabric.LeaseBoard.try_acquire

    def try_acquire(self, cell):
        with lock:
            return claim(self, cell)
    monkeypatch.setattr(p.fabric.LeaseBoard, "try_acquire", try_acquire)


@pytest.mark.parametrize("pkg", NAMES)
def test_two_workers_share_the_board_disjointly(pkg, tmp_path):
    p = PKGS[pkg]
    cells, d = _cells(p), tmp_path / "fab"
    counting = Counting(p)
    workers = [_worker(p, cells, d, counting, worker_id=f"w{i}", ttl_s=30,
                       poll_s=0.05) for i in range(2)]
    stats = [None, None]

    def drive(i):
        stats[i] = workers[i].run()

    ts = [threading.Thread(target=drive, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    done = stats[0]["cells_completed"] + stats[1]["cells_completed"]
    assert sorted(done) == sorted(c.key() for c in cells)  # no overlap
    assert p.fabric.LeaseBoard(d).held() == []
    # no trial ran twice: the lease made the cells disjoint
    ref_trials = 0
    for spec in cells:
        runner = p.trial.TrialRunner(spec.workload(), _surface(p))
        ref_trials += p.tree.run_tuning(runner, _baseline(p)(spec),
                                        threshold=0.05).n_trials
    assert len(counting.calls) == ref_trials


def test_two_workers_files_identical(tmp_path, monkeypatch):
    """Two workers in each package: whichever worker tuned a cell, the
    checkpoints and history rows are the reference's bytes.  Their
    claims are taken one at a time, so that the claim race of both
    packages (:func:`test_claim_in_flight_reads_as_torn_and_is_stolen`)
    does not make one package walk a cell twice."""
    out = {}
    for name, p in PKGS.items():
        _one_claim_at_a_time(monkeypatch, p)
        ts = [threading.Thread(target=_worker(
            p, _cells(p), tmp_path / name, worker_id=f"w{i}", ttl_s=30,
            poll_s=0.05).run) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        out[name] = _files(tmp_path / name)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("pkg", NAMES)
def test_worker_releases_lease_on_evaluator_fault(pkg, tmp_path):
    """An exception (not a SIGKILL) unwinds the worker's finally: the
    lease is released immediately — recovery needs no TTL wait."""
    p = PKGS[pkg]
    d = tmp_path / "fab"
    a = _worker(p, _cells(p), d, Counting(p, fail_after=3), worker_id="a",
                ttl_s=30, poll_s=0.05)
    with pytest.raises(KeyboardInterrupt):
        a.run()
    assert p.fabric.LeaseBoard(d).held() == []


def _absorbed(d, cells):
    """The (cell, config) pairs the checkpoints hold, and the cells not
    done."""
    absorbed, unfinished = [], []
    for spec in cells:
        path = d / f"{spec.key()}.json"
        if path.exists():
            ck = json.loads(path.read_text())
            absorbed += [(ck["cell"], e["config"]) for e in ck["log"]]
            if not ck.get("done"):
                unfinished.append(spec.key())
        else:
            unfinished.append(spec.key())
    return absorbed, unfinished


@pytest.mark.parametrize("pkg", NAMES)
def test_crashed_worker_recovered_without_repaying(pkg, tmp_path):
    """Worker A dies mid-cell: its checkpoints hold everything absorbed
    and its lease stays on the board with a stopped heartbeat.  Worker B
    steals the expired lease and completes everything without
    re-evaluating one absorbed trial, with the decisions of an
    uninterrupted campaign."""
    p = PKGS[pkg]
    cells, d = _cells(p), tmp_path / "fab"
    camp = p.campaign.Campaign(cells, evaluator=Counting(p, fail_after=9),
                               baseline_factory=_baseline(p),
                               checkpoint_dir=d, max_workers=2)
    with pytest.raises(KeyboardInterrupt):
        camp.run()                       # A's work until the kill
    absorbed, unfinished = _absorbed(d, cells)
    assert absorbed and unfinished
    # the dead worker's lease survives it, heartbeat frozen
    dead_board = p.fabric.LeaseBoard(d, worker_id="a", ttl_s=0.3)
    assert dead_board.try_acquire(unfinished[0]) is not None
    time.sleep(0.4)                      # let A's lease expire
    resumer = Counting(p)
    b = _worker(p, cells, d, resumer, worker_id="b", ttl_s=30, poll_s=0.05)
    stats = b.run()
    assert sorted(stats["cells_completed"]) == sorted(c.key() for c in cells)
    assert p.fabric.LeaseBoard(d).held() == []
    repaid = {(k, json.dumps(c, sort_keys=True)) for k, c in resumer.calls} \
        & {(k, json.dumps(c, sort_keys=True)) for k, c in absorbed}
    assert repaid == set()
    assert stats["replayed_trials"] == len(absorbed)
    ref = p.campaign.Campaign(cells, evaluator=_surface(p),
                              baseline_factory=_baseline(p),
                              checkpoint_dir=tmp_path / "ref").run()
    for spec in cells:
        ck = json.loads((d / f"{spec.key()}.json").read_text())
        rep = b.strategy.load_report(ck["report"])
        assert rep.__dict__ == ref[spec.key()].__dict__


@pytest.mark.parametrize("pkg", NAMES)
def test_worker_skips_done_cells(pkg, tmp_path):
    p = PKGS[pkg]
    d = tmp_path / "fab"
    _worker(p, _cells(p), d).run()
    counting = Counting(p)
    stats = _worker(p, _cells(p), d, counting).run()
    assert counting.calls == []
    assert stats["cells_completed"] == []


@pytest.mark.parametrize("pkg", NAMES)
def test_worker_retunes_done_checkpoints_with_stale_parameters(pkg,
                                                               tmp_path):
    """A done checkpoint written under a different threshold reads as
    not done: the fabric claims the cell and re-tunes it, as the
    single-process campaign would."""
    p = PKGS[pkg]
    cells, d = _cells(p)[:2], tmp_path / "fab"
    _worker(p, cells, d, threshold=0.05).run()
    counting = Counting(p)
    stats = _worker(p, cells, d, counting, threshold=0.10).run()
    assert counting.calls                # really re-tuned
    assert sorted(stats["cells_completed"]) == sorted(c.key() for c in cells)
    ref = p.campaign.Campaign(cells, threshold=0.10, evaluator=_surface(p),
                              baseline_factory=_baseline(p),
                              checkpoint_dir=tmp_path / "ref").run()
    for spec in cells:
        ck = json.loads((d / f"{spec.key()}.json").read_text())
        assert ck["threshold"] == 0.10
        rep = p.strategy.get_strategy("tree").load_report(ck["report"])
        assert rep.__dict__ == ref[spec.key()].__dict__


@pytest.mark.parametrize("pkg", NAMES)
def test_worker_with_start_barrier(pkg, tmp_path):
    p = PKGS[pkg]
    ready, go = tmp_path / "ready", tmp_path / "go"
    worker = _worker(p, _cells(p)[:1], tmp_path / "fab", ready_file=ready,
                     go_file=go)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("stats",
                                                       worker.run()))
    t.start()
    deadline = time.time() + 5
    while not ready.exists() and time.time() < deadline:
        time.sleep(0.01)
    assert ready.exists()
    assert "stats" not in out            # blocked on the go barrier
    go.touch()
    t.join(timeout=5)
    assert out["stats"]["cells_completed"] == [_cells(p)[0].key()]


# ------------------------------------------------------------- plumbing
@pytest.mark.parametrize("pkg", NAMES)
def test_worker_argv_roundtrip(pkg, tmp_path):
    p = PKGS[pkg]
    cells = _cells(p)
    argv = p.fabric.worker_argv(cells[:2], tmp_path, strategy="random",
                                evaluator_spec="m:make_evaluator",
                                ttl_s=5.0, warm_start=True,
                                extra=["--budget", "3"])
    assert "--worker" in argv and "--warm-start" in argv
    assert argv[argv.index("--cells") + 1] \
        == f"{cells[0].spec()},{cells[1].spec()}"
    assert argv[-2:] == ["--budget", "3"]


def test_worker_argv_is_the_reference_s_but_module_and_device(tmp_path):
    kw = dict(strategy="model", evaluator_spec="m:f", ttl_s=5.0,
              threshold=0.1, warm_start=True, prioritize="history",
              watch=True, worker_id="w1", ready_file=tmp_path / "r",
              go_file=tmp_path / "g", trial_timeout_s=9.0, max_retries=2,
              strike_threshold=4, measure_top_k=2,
              measured_evaluator_spec="m:g", slo_ttft=3.0, promote=True,
              trace=True, extra=["--budget", "3"])
    ref = PKGS["ref"].fabric.worker_argv(_cells(PKGS["ref"]), tmp_path, **kw)
    port = PKGS["port"].fabric.worker_argv(_cells(PKGS["port"]), tmp_path,
                                           device="cuda:1", **kw)
    assert ref[1:3] == ["-m", "repro.launch.tune"]
    assert port[1:3] == ["-m", "repro_torch.launch.tune"]
    i = port.index("--device")
    assert port[i:i + 2] == ["--device", "cuda:1"]
    assert port[3:i] + port[i + 2:] == ref[3:]
    assert PKGS["port"].fabric.worker_argv(_cells(PKGS["port"]), tmp_path,
                                           **kw)[3:] == ref[3:]


@pytest.mark.parametrize("pkg", NAMES)
def test_load_evaluator_spec(pkg, monkeypatch):
    p = PKGS[pkg]
    monkeypatch.syspath_prepend(str(TESTS))
    spec = ("benchmarks.fabric_surface:make_evaluator" if pkg == "ref"
            else "_torch_fabric_surface:make_evaluator")
    ev = p.fabric.load_evaluator(spec)
    res = ev(_cells(p)[0].workload(), _baseline(p)(None))
    assert res.cost_s > 0
    with pytest.raises(ValueError):
        p.fabric.load_evaluator("missing-colon")


def test_port_default_evaluator_is_the_device_dispatch(tmp_path):
    """The port's default is the dispatch stack on the worker's device,
    its timing caches in the shared directory, walked with one worker."""
    from repro_torch.core import kernel_cell
    from repro_torch.core.fabric import FabricWorker, load_evaluator
    assert isinstance(load_evaluator(None, "cpu"),
                      kernel_cell.DispatchEvaluator)
    worker = FabricWorker(_cells(PKGS["port"], "kernel:rmsnorm:tiny"),
                          tmp_path, device="cpu")
    assert isinstance(worker.evaluator, kernel_cell.DispatchEvaluator)
    assert worker.max_workers == 1
    assert worker.evaluator.kernel.cache.dir == tmp_path / "timings"
    stats = worker.run()
    assert stats["cells_completed"] == ["kernel-rmsnorm__tiny__pod"]
    assert list((tmp_path / "timings").glob("*"))


def test_surface_is_the_reference_s():
    """The jax-free surface the port's worker processes load costs what
    ``benchmarks/fabric_surface.surface_cost`` costs."""
    import _torch_fabric_surface as mine
    from repro.core.space import SPACE
    ref, port = PKGS["ref"], PKGS["port"]
    for spec in _cells(ref, SPECS + ",kernel:rmsnorm:tiny"):
        for ks in SPACE:
            knob = ks.name
            for value in ks.domain:
                rt = _baseline(ref)(None).replace(**{knob: value})
                want = ref.surface(spec.workload(), rt)
                got = mine.surface_cost(
                    port.campaign.parse_cells(spec.spec())[0].workload(),
                    _baseline(port)(None).replace(**{knob: value}))
                assert got.as_dict() == want.as_dict()


@pytest.mark.parametrize("pkg", NAMES)
def test_checkpoint_done_checks_strategy(pkg, tmp_path):
    p = PKGS[pkg]
    _worker(p, _cells(p)[:1], tmp_path).run()
    key = _cells(p)[0].key()
    assert p.fabric.checkpoint_done(tmp_path, key, "tree")
    assert not p.fabric.checkpoint_done(tmp_path, key, "random")
    assert not p.fabric.checkpoint_done(tmp_path, "no-such-cell", "tree")


# --------------------------------------------------- poison quarantine
@pytest.mark.parametrize("pkg", NAMES)
def test_worker_reaps_orphaned_intents_and_quarantines(pkg, tmp_path):
    """A dead worker's in-flight evaluation left an orphaned intent; the
    next claimer of that cell strikes it, and at the threshold the
    config is skipped fleet-wide (scored as a crash)."""
    p = PKGS[pkg]
    d = tmp_path / "fab"
    d.mkdir(parents=True)
    cell = _cells(p)[0]
    bf16 = _baseline(p)(None).replace(compute_dtype="bfloat16")
    p.quarantine.Quarantine(d, worker="dead-worker").begin(cell.key(), bf16)
    counting = Counting(p)
    worker = _worker(p, [cell], d, counting, worker_id="b",
                     strike_threshold=1)
    stats = worker.run()
    assert stats["cells_completed"] == [cell.key()]
    evaluated = {json.dumps(c, sort_keys=True) for _, c in counting.calls}
    assert json.dumps(bf16.as_dict(), sort_keys=True) not in evaluated
    assert worker.quarantine.summary()["quarantined"] \
        == [p.quarantine.config_key(bf16)]
    ck = json.loads((d / f"{cell.key()}.json").read_text())
    assert ck["done"] and ck["health"]["degraded"]
    assert ck["health"]["quarantined"] >= 1


def _env(**extra):
    """A worker's environment: the surfaces' directory on PYTHONPATH
    (``spawn_worker`` puts the port's src first)."""
    return dict(os.environ, PYTHONPATH=str(TESTS), **extra)


def test_poison_config_quarantined_across_worker_deaths(tmp_path):
    """With real SIGKILLs, through the port's worker processes: a config
    that kills its worker is evaluated exactly K times fleet-wide.
    Workers 0 and 1 die on it; worker 2 reaps the orphaned intents,
    quarantines it and completes the cell degraded.  The co-scheduled
    control cell's checkpoint is the reference's fault-free campaign's,
    byte for byte."""
    port, ref = PKGS["port"], PKGS["ref"]
    K = 2
    cells = _cells(port, "smollm-135m:train_4k,smollm-135m:prefill_32k")
    d = tmp_path / "fab"
    d.mkdir()
    ledger = tmp_path / "ledger.jsonl"
    env = _env(CHAOS_KILL_DELTA="remat_policy=full",
               CHAOS_LEDGER=str(ledger))

    def worker(i):
        return port.fabric.spawn_worker(
            cells, d, strategy="tree",
            evaluator_spec="_torch_fabric_surface:make_chaos_evaluator",
            ttl_s=1.0, worker_id=f"w{i}", strike_threshold=K,
            log_path=d / "logs" / f"w{i}.log", env=env, device="cpu")

    rcs = [w.wait(timeout=120) for w in [worker(0), worker(1)]]
    assert rcs == [-9, -9]               # both died evaluating the poison
    held = port.fabric.LeaseBoard(d).held()
    assert [st.cell for st in held] == [cells[0].key()]  # lease left held
    assert worker(2).wait(timeout=120) == 0
    assert port.fabric.LeaseBoard(d).held() == []

    records = [json.loads(s) for s in ledger.read_text().splitlines()]
    assert len([r for r in records
                if r["config"]["remat_policy"] == "full"]) == K
    summary = port.quarantine.Quarantine(d, strike_threshold=K).summary()
    assert len(summary["quarantined"]) == 1
    assert summary["strikes"][summary["quarantined"][0]] == K
    ck = json.loads((d / f"{cells[0].key()}.json").read_text())
    assert ck["done"] and ck["health"]["degraded"]
    assert ck["health"]["failures"]["worker-death"] >= 1
    ref_cells = _cells(ref, "smollm-135m:prefill_32k")
    ref.campaign.Campaign(ref_cells, evaluator=ref.surface,
                          baseline_factory=_baseline(ref),
                          checkpoint_dir=tmp_path / "ref").run()
    name = f"{cells[1].key()}.json"
    assert (d / name).read_text() == (tmp_path / "ref" / name).read_text()


# ---------------------------------------------------------- watch fabric
@pytest.mark.parametrize("pkg", NAMES)
def test_watch_worker_claims_late_submission_and_stops(pkg, tmp_path):
    """A watching worker drains its seed cell, idles, claims a cell
    submitted while it runs, and exits on STOP with no lease held."""
    p = PKGS[pkg]
    cells, d = _cells(p), tmp_path / "fab"
    worker = _worker(p, cells[:1], d, watch=True, poll_s=0.02, ttl_s=30)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("stats",
                                                       worker.run()))
    t.start()
    done = p.fabric.checkpoint_done
    deadline = time.time() + 20
    while not done(d, cells[0].key(), "tree") and time.time() < deadline:
        time.sleep(0.01)
    assert done(d, cells[0].key(), "tree")
    time.sleep(0.1)
    assert t.is_alive()                  # watching, not exited
    p.schedule.submit_cells(d, [cells[2]])
    while not done(d, cells[2].key(), "tree") and time.time() < deadline:
        time.sleep(0.01)
    assert done(d, cells[2].key(), "tree")
    p.schedule.request_stop(d)
    t.join(timeout=10)
    assert not t.is_alive()
    stats = out["stats"]
    assert sorted(stats["cells_completed"]) \
        == sorted([cells[0].key(), cells[2].key()])
    assert stats["intake_admitted"] == 1
    assert p.fabric.LeaseBoard(d).held() == []
    runner = p.trial.TrialRunner(cells[2].workload(), _surface(p))
    want = p.tree.run_tuning(runner, _baseline(p)(cells[2]), threshold=0.05)
    ck = json.loads((d / f"{cells[2].key()}.json").read_text())
    assert worker.strategy.load_report(ck["report"]).__dict__ \
        == want.__dict__


@pytest.mark.parametrize("pkg", NAMES)
def test_watch_worker_ignores_stale_stop_sentinel(pkg, tmp_path):
    """A STOP left by a previous session neither stops a new watch
    worker nor is deleted by it; a fresh STOP drains it."""
    p = PKGS[pkg]
    cells, d = _cells(p), tmp_path / "fab"
    stale = p.schedule.request_stop(d)   # stale, from a prior session
    worker = _worker(p, cells[:1], d, watch=True, poll_s=0.02, ttl_s=30)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("stats",
                                                       worker.run()))
    t.start()
    deadline = time.time() + 20
    while not p.fabric.checkpoint_done(d, cells[0].key(), "tree") \
            and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.1)
    assert t.is_alive()                  # still watching — STOP was stale
    assert stale.exists()                # ignored, not deleted
    p.schedule.request_stop(d)
    t.join(timeout=10)
    assert not t.is_alive()
    assert out["stats"]["cells_completed"] == [cells[0].key()]


def _hist_rec(p, arch, shape, name, cost, ts):
    wl = p.trial.Workload(arch, shape)
    return {"v": 1, "ts": ts, "cell": wl.key(), "arch": arch,
            "shape": shape, "multi_pod": False, "strategy": "tree",
            "name": name, "delta": {},
            "config": p.params.default_config().as_dict(),
            "cost_s": cost, "crashed": False, "compiles": 0,
            "compile_s": 0.0, "cached": False}


@pytest.mark.parametrize("pkg", NAMES)
def test_worker_claims_in_history_priority_order(pkg, tmp_path):
    p = PKGS[pkg]
    cells, d = _cells(p), tmp_path / "fab"
    hist = p.history.TrialHistory(d / "history.jsonl")
    for (arch, shape), speedup in ((("xlstm-1.3b", "decode_32k"), 2.0),
                                   (("smollm-135m", "train_4k"), 1.2),
                                   (("glm4-9b", "train_4k"), 1.05),
                                   (("smollm-135m", "prefill_32k"), 1.1)):
        hist.append(_hist_rec(p, arch, shape, "baseline", 100.0, 1.0))
        hist.append(_hist_rec(p, arch, shape, "best", 100.0 / speedup, 2.0))
    counting = Counting(p)
    stats = _worker(p, cells, d, counting, prioritize="history",
                    ttl_s=30).run()
    assert sorted(stats["cells_completed"]) == sorted(c.key() for c in cells)
    first_seen = list(dict.fromkeys(k for k, _ in counting.calls))
    assert first_seen[0] == "xlstm-1.3b__decode_32k__pod"


@pytest.mark.parametrize("pkg", NAMES)
def test_worker_without_cells_needs_watch(pkg, tmp_path):
    with pytest.raises(ValueError, match="at least one cell"):
        PKGS[pkg].fabric.FabricWorker([], tmp_path,
                                      evaluator=_surface(PKGS[pkg]))


def test_queue_status_identical(tmp_path):
    """``schedule.queue_status`` gives the reference's view of one
    board: done, intake, a live lease."""
    out = {}
    for name, p in PKGS.items():
        d = tmp_path / name
        cells = _cells(p)
        _worker(p, cells[:2], d).run()
        p.schedule.submit_cells(d, [cells[2]])
        board = p.fabric.LeaseBoard(d, worker_id="w-live", ttl_s=30)
        assert board.try_acquire(cells[3].key()) is not None
        st = p.schedule.queue_status(d, strategy="tree", cells=cells[:2])
        assert st["depth"] == {"pending": 1, "claimed": 1, "done": 2}
        st.pop("dir")
        for lease in st["leases"]:
            lease.pop("age_s")
            lease.pop("host")
        out[name] = st
    assert out["port"] == out["ref"]


# ------------------------------------------------ the card's file lock
_HOLDER = """
import json, pathlib, sys, time
from repro_torch.core import trial
trial.card_lock_path = lambda device: pathlib.Path(sys.argv[1])
clock = trial.TrialClock()
with trial.trial_clock(clock):
    t0 = time.time()
    with trial.hold_device("cpu"):
        print(json.dumps({"acquired": time.time(), "asked": t0,
                          "waited_s": clock.waited_s()}), flush=True)
        time.sleep(float(sys.argv[2]))
print(json.dumps({"released": time.time()}), flush=True)
"""


def _holder(lock, hold_s):
    return subprocess.Popen(
        [sys.executable, "-c", _HOLDER, str(lock), str(hold_s)],
        stdout=subprocess.PIPE, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))


def test_card_lock_orders_processes_and_stops_the_clock(tmp_path):
    """Two processes on one card: the second waits for the first, and
    its wait is on the trial clock's waited time, not its device time."""
    lock = tmp_path / "card.lock"
    a = _holder(lock, 1.5)
    first = json.loads(a.stdout.readline())
    b = _holder(lock, 0.0)
    second = json.loads(b.stdout.readline())
    released = json.loads(a.stdout.readline())["released"]
    assert a.wait(timeout=60) == 0 and b.wait(timeout=60) == 0
    assert first["waited_s"] < 0.5
    assert second["acquired"] >= released - 0.05
    # the wait counted as waiting: from asking to holding
    assert second["waited_s"] >= 0.8 * (second["acquired"]
                                        - second["asked"]) > 0.3


def test_card_lock_freed_when_its_holder_is_killed(tmp_path):
    lock = tmp_path / "card.lock"
    a = _holder(lock, 600.0)
    json.loads(a.stdout.readline())      # a holds the card
    a.send_signal(signal.SIGKILL)
    a.wait(timeout=60)
    b = _holder(lock, 0.0)
    assert json.loads(b.stdout.readline())["waited_s"] < 5.0
    assert b.wait(timeout=60) == 0


def test_card_lock_path_names_the_card_s_uuid(monkeypatch):
    """One file per card, under the temp directory, named by the card's
    UUID (not its index); the CPU has none."""
    import tempfile
    import types

    import torch

    from repro_torch.core import trial
    assert trial.card_lock_path("cpu") is None
    assert trial.card_lock_path("cuda") is None or \
        torch.cuda.is_available()        # no card, nothing to lock
    uuids = {0: "GPU-aaaa", 1: "GPU-bbbb"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(uuid=uuids[i]))
    path = trial.card_lock_path("cuda")
    assert path.parent == pathlib.Path(tempfile.gettempdir())
    assert "GPU-bbbb" in path.name
    assert trial.card_lock_path("cuda:0").name != path.name


_FLEET_WORKER = """
import pathlib, sys, time
sys.path.insert(0, sys.argv[5])
from repro_torch.core import campaign, fabric, params, trial
import _torch_fabric_surface as surface
if sys.argv[2]:
    trial.card_lock_path = lambda device: pathlib.Path(sys.argv[2])

def ev(wl, rt):
    with trial.hold_device("cpu"):
        time.sleep(0.03)
        return surface.surface_cost(wl, rt)

d = pathlib.Path(sys.argv[1])
fabric.FabricWorker(
    campaign.parse_cells(sys.argv[3]), d, evaluator=ev,
    baseline_factory=lambda spec: params.default_config(
        shard_strategy="fsdp_tp", attn_impl="pallas"),
    worker_id=sys.argv[4], trace=True, device="cpu", poll_s=0.02,
    ready_file=d / (sys.argv[4] + ".ready"), go_file=d / "go").run()
"""


def _overlap(events, kind) -> float:
    """The longest time two ``kind`` spans of different workers overlap."""
    spans = [(e["ts"], e["ts"] + e["dur_s"], e["worker"]) for e in events
             if e["kind"] == kind]
    return max([min(a1, b1) - max(a0, b0) for a0, a1, wa in spans
                for b0, b1, wb in spans if wa < wb] + [0.0])


@pytest.mark.parametrize("locked", [True, False])
def test_workers_on_one_card_take_turns_by_trial(locked, tmp_path):
    """Two worker processes on one card (a fake card's lock file): each
    trial holds the card (one ``card`` span inside its ``trial`` span),
    and no two holds of different workers overlap.  Without the lock
    nothing is held, and their trials overlap."""
    d = tmp_path / "fab"
    d.mkdir()
    specs = "smollm-135m:train_4k,smollm-135m:prefill_32k,glm4-9b:train_4k"
    lock = str(tmp_path / "card.lock") if locked else ""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FLEET_WORKER, str(d), lock, specs, w,
         str(TESTS)], cwd=ROOT, env=dict(os.environ,
                                         PYTHONPATH=str(ROOT / "src")))
        for w in ("a", "b")]
    deadline = time.time() + 60
    while not all((d / f"{w}.ready").exists() for w in "ab") \
            and time.time() < deadline:
        time.sleep(0.02)
    (d / "go").touch()
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    events = PKGS["port"].telemetry.read_events(d)
    trials = {e["span"]: e for e in events if e["kind"] == "trial"}
    cards = [e for e in events if e["kind"] == "card"]
    assert {e["worker"] for e in trials.values()} == {"a", "b"}
    assert all(PKGS["port"].fabric.checkpoint_done(d, c.key(), "tree")
               for c in _cells(PKGS["port"], specs))
    if locked:
        assert sorted(e["parent"] for e in cards) == sorted(trials)
        assert all(trials[e["parent"]]["cell"] == e["cell"]
                   and trials[e["parent"]]["ts"] <= e["ts"] for e in cards)
        assert _overlap(events, "card") == 0.0
    else:
        assert not cards
        assert _overlap(events, "trial") > 0.0


# ----------------------------------------------------- the kernel build
def test_concurrent_builds_use_their_own_objects(tmp_path, monkeypatch):
    """Two builds at once (threads here; processes differ by pid too)
    compile into object files of their own and each land a whole
    library."""
    from repro_torch.kernels import _build
    log = tmp_path / "nvcc.log"
    fake = tmp_path / "nvcc"
    fake.write_text(f"""#!{sys.executable}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({str(log)!r}, "a") as f:
    f.write(out + "\\n")
if "-c" in args:
    time.sleep(0.3)
    data = "obj:" + args[args.index("-c") + 1] + "\\n"
else:
    data = "".join(open(o).read() for o in args if o.endswith(".o"))
open(out, "w").write(data)
""")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    srcs = [tmp_path / f"k{i}.cu" for i in range(3)]
    outs = [tmp_path / "build" / f"lib{i}.so" for i in range(2)]
    errors = []

    def build(out):
        try:
            _build._compile(srcs, out, False)
        except Exception as e:          # noqa: BLE001 (reported below)
            errors.append(e)

    ts = [threading.Thread(target=build, args=(o,)) for o in outs]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors
    objects = [line for line in log.read_text().split() if
               line.endswith(".o")]
    assert len(objects) == len(set(objects)) == 6
    for out in outs:
        assert out.read_text() == "".join(f"obj:{s}\n" for s in srcs)
    assert not list((tmp_path / "build").glob("*.o"))


def test_failed_build_leaves_no_objects(tmp_path, monkeypatch):
    """A compile that fails removes the objects of the sources that did
    compile, and lands no library."""
    from repro_torch.kernels import _build
    fake = tmp_path / "nvcc"
    fake.write_text(f"""#!{sys.executable}
import sys
args = sys.argv[1:]
if args[args.index("-c") + 1].endswith("bad.cu"):
    sys.exit("bad.cu: error")
open(args[args.index("-o") + 1], "w").write("obj")
""")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    srcs = [tmp_path / "good.cu", tmp_path / "bad.cu"]
    with pytest.raises(RuntimeError, match="bad.cu: error"):
        _build._compile(srcs, tmp_path / "build" / "lib.so", False)
    assert list((tmp_path / "build").iterdir()) == []


# ------------------------------------------------------ the fleet's CLI
def _tune(*argv, timeout=180, **env):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", *argv],
        capture_output=True, text=True, cwd=ROOT, timeout=timeout,
        env=dict(_env(**env), PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), str(TESTS)])))


def test_tune_workers_on_the_cpu_end_to_end(tmp_path):
    """``tune --workers 2 --device cpu`` over three cells: both workers
    run, every cell is done with the reference's checkpoint, no lease
    is left, and ``--status --json`` then reports 3 done."""
    d = tmp_path / "fab"
    specs = "smollm-135m:train_4k,smollm-135m:prefill_32k,glm4-9b:train_4k"
    done = _tune("--workers", "2", "--device", "cpu", "--dir", str(d),
                 "--evaluator", "_torch_fabric_surface:make_evaluator",
                 "--cells", specs, "--fresh", "--trace",
                 "--worker-ttl", "5", FABRIC_SURFACE_SLEEP_S="0.02")
    assert done.returncode == 0, done.stderr[-3000:]
    assert "[fabric:tree] 3 cells, 2 workers" in done.stdout
    logs = sorted((d / "worker_logs").glob("*.log"))
    assert len(logs) == 2
    ref = PKGS["ref"]
    ref.campaign.Campaign(_cells(ref, specs), evaluator=ref.surface,
                          baseline_factory=_baseline(ref),
                          checkpoint_dir=tmp_path / "ref").run()
    for spec in _cells(ref, specs):
        name = f"{spec.key()}.json"
        assert (d / name).read_text() == (tmp_path / "ref" / name).read_text()
        assert (d / "reports" / name).exists()
    assert not list((d / "leases").glob("*.lease"))
    status = _tune("--status", "--json", "--dir", str(d), "--cells", specs)
    view = json.loads(status.stdout)
    assert view["queue"]["depth"] == {"pending": 0, "claimed": 0, "done": 3}
    assert view["queue"]["leases"] == []
    workers = {e["worker"] for e in PKGS["port"].telemetry.read_events(d)
               if e["kind"] == "trial"}
    assert len(workers) >= 1


def test_tune_worker_without_a_card_exits_non_zero(tmp_path):
    """No fallback: a worker asked for the card on a host without one
    fails."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    done = _tune("--worker", "--dir", str(tmp_path), "--cells",
                 "kernel:rmsnorm:tiny", timeout=120)
    assert done.returncode != 0
    assert "no CUDA device" in done.stderr


def test_all_status_json_lists_the_reference_s_cells(tmp_path, capsys):
    from repro.core.campaign import enumerate_cells
    from repro_torch.launch import tune
    assert tune.main(["--all", "--status", "--json", "--dir",
                      str(tmp_path)]) == 0
    view = json.loads(capsys.readouterr().out)
    assert [c["cell"] for c in view["queue"]["cells"]] \
        == sorted(c.key() for c in enumerate_cells(meshes=(False,)))
    assert view["queue"]["depth"]["pending"] == len(view["queue"]["cells"])


def test_tune_cli_add_cells_status_stop(tmp_path, monkeypatch, capsys):
    from repro_torch.core import campaign
    from repro_torch.core.schedule import scan_intake, stop_requested
    from repro_torch.launch import tune
    monkeypatch.setattr(campaign, "CAMPAIGN_DIR", tmp_path / "camp")
    assert tune.main(["--add-cells", "smollm-135m:train_4k"]) == 0
    out = capsys.readouterr().out
    assert "submitted smollm-135m__train_4k__pod" in out
    assert [c.key() for c in scan_intake(tmp_path / "camp")] \
        == ["smollm-135m__train_4k__pod"]
    assert tune.main(["--status"]) == 0
    out = capsys.readouterr().out
    assert "queue depth:  1 pending / 0 claimed / 0 done" in out
    assert "(none held)" in out
    assert tune.main(["--stop"]) == 0
    capsys.readouterr()
    assert stop_requested(tmp_path / "camp")
    assert tune.main(["--status"]) == 0
    assert "STOP requested" in capsys.readouterr().out


@pytest.mark.parametrize("argv, message", [
    (["--add-cells", "smollm-135m:train_4k", "--stop"],
     "--add-cells and --stop are separate actions"),
    (["--add-cells", "smollm-135m:train_4k", "--cells", "x:y"],
     "--add-cells is a standalone action; --cells would be ignored"),
    (["--stop", "--trace"], "--stop is a standalone action; --trace"),
    (["--status", "--fresh", "--cells", "smollm-135m:train_4k"],
     "--status is a read-only action; --fresh"),
    (["--json"], "--json is the machine-readable form of --status"),
    (["--cells", "smollm-135m:train_4k", "--watch"],
     "--watch only applies to fabric modes"),
    (["--worker"], "fabric modes need --cells or --all"),
    (["--worker", "--fresh", "--cells", "smollm-135m:train_4k"],
     "--fresh is a coordinator/campaign action"),
    (["--cells", "smollm-135m:train_4k", "--measured-evaluator", "m:f"],
     "--measured-evaluator requires --measure-top-k > 0"),
    (["--workers", "2", "--cells", "smollm-135m:train_4k", "--evaluator",
      "m:f", "--slo-ttft", "2"], "--evaluator replaces the dispatch stack"),
    (["--trace"], "--trace records telemetry into the campaign directory"),
    (["--trace-out", "t.json", "--workers", "2"],
     "--trace-out is a standalone export; --workers")])
def test_tune_cli_fleet_rules(argv, message, capsys):
    """The reference's rules for the fleet flags, and its messages."""
    from repro_torch.launch import tune
    with pytest.raises(SystemExit):
        tune.main(["--device", "cpu"] + argv)
    assert message in capsys.readouterr().err
