"""The port's trial plumbing against the reference's: the failure
taxonomy, the compile cache's memoisation by failure class, the sweep
executor's retries, deadlines and quarantine, and the quarantine ledger.

Each case runs one scenario through both packages with the same
synthetic evaluator and compares what an observer sees: results,
executor counters, evaluator calls and ledger records (without their
wall-clock, pid and attempt-id fields).
"""
import dataclasses
import json
import threading
import time

import pytest

from _torch_surface import PKGS


def _evaluator(p, delay=0.0, raise_on=None, crash_on=None, flaky=0):
    """A deterministic cost surface that counts its calls; ``flaky``
    raises OSError (the transient class) for the first calls per config."""
    calls, failed, lock = [], {}, threading.Lock()

    def ev(wl, rt):
        with lock:
            calls.append(rt.as_dict())
            blob = tuple(sorted(rt.as_dict().items()))
            if failed.get(blob, 0) < flaky:
                failed[blob] = failed.get(blob, 0) + 1
                raise OSError(f"flaky ({failed[blob]}/{flaky})")
        if delay:
            time.sleep(delay)
        for k, v in (raise_on or {}).items():
            if getattr(rt, k) == v:
                raise RuntimeError("boom")
        for k, v in (crash_on or {}).items():
            if getattr(rt, k) == v:
                return p.trial.TrialResult(cost_s=float("inf"), crashed=True)
        cost = 100.0 + 7.0 * rt.microbatches \
            - (30.0 if rt.compute_dtype == "bfloat16" else 0.0)
        return p.trial.TrialResult(cost_s=cost)

    ev.calls = calls
    return ev


def _wl(p):
    return p.trial.Workload("smollm-135m", "train_4k")


def _j(obj):
    return json.dumps(obj, sort_keys=True, default=str)


def _res(r):
    return dataclasses.asdict(r)


def _ledger(q):
    return [{k: v for k, v in r.items()
             if k not in ("ts", "pid", "attempt", "worker")}
            for r in q.records()]


# ------------------------------------------------------------- scenarios
def s_map_order(p, tmp):
    ev = _evaluator(p, delay=0.01)
    base = p.params.default_config()
    cfgs = [base.replace(microbatches=m) for m in (1, 2, 4)] \
        + [base.replace(compute_dtype="bfloat16")]
    with p.executor.SweepExecutor(ev, max_workers=4) as ex:
        out = [_res(r) for r in ex.map(_wl(p), cfgs)]
    assert [r["cost_s"] for r in out] == [107.0, 114.0, 128.0, 77.0]
    return out


def s_dedup(p, tmp):
    ev = _evaluator(p, delay=0.05)
    with p.executor.SweepExecutor(ev, max_workers=4) as ex:
        futs = [ex.submit(_wl(p), p.params.default_config())
                for _ in range(6)]
        out = [_res(f.result()) for f in futs]
        stats = ex.stats()
    assert len(ev.calls) == 1 and stats["deduped"] == 5
    return out, stats


def s_exception_is_crash(p, tmp):
    ev = _evaluator(p, raise_on={"microbatches": 2})
    base = p.params.default_config()
    with p.executor.SweepExecutor(ev, max_workers=2) as ex:
        out = [_res(r) for r in
               ex.map(_wl(p), [base, base.replace(microbatches=2)])]
    assert out[1]["crashed"] and out[1]["error"] == "RuntimeError: boom"
    return out


def s_deadline(p, tmp):
    ev = _evaluator(p, delay=0.4)
    with p.executor.SweepExecutor(ev, max_workers=2,
                                  trial_timeout_s=0.05) as ex:
        res = ex.submit(_wl(p), p.params.default_config()).result()
        stats = ex.stats()
    assert res.failure == p.trial.FAILURE_TIMEOUT
    stats.pop("zombies")            # depends on when the sleeper wakes
    return _res(res), stats


def s_retry_to_success(p, tmp):
    ev = _evaluator(p, flaky=1)
    with p.executor.SweepExecutor(ev, max_workers=2, max_retries=2,
                                  retry_backoff_s=0.001) as ex:
        res = ex.submit(_wl(p), p.params.default_config()).result()
        stats = ex.stats()
    assert not res.crashed and res.retries == 1
    return _res(res), stats, len(ev.calls)


def s_retry_exhausted(p, tmp):
    ev = _evaluator(p, flaky=99)
    with p.executor.SweepExecutor(ev, max_workers=2, max_retries=2,
                                  retry_backoff_s=0.001) as ex:
        res = ex.submit(_wl(p), p.params.default_config()).result()
        stats = ex.stats()
    assert res.failure == p.trial.FAILURE_TRANSIENT and res.retries == 2
    return _res(res), stats, len(ev.calls)


def s_deterministic_not_retried(p, tmp):
    ev = _evaluator(p, raise_on={"microbatches": 2})
    cfg = p.params.default_config().replace(microbatches=2)
    with p.executor.SweepExecutor(ev, max_workers=2, max_retries=3) as ex:
        res = ex.submit(_wl(p), cfg).result()
        stats = ex.stats()
    assert res.failure == p.trial.FAILURE_DETERMINISTIC
    return _res(res), stats, len(ev.calls)


def s_fresh_submit_after_crash(p, tmp):
    ev = _evaluator(p, flaky=1)
    with p.executor.SweepExecutor(ev, max_workers=2) as ex:
        bad = ex.submit(_wl(p), p.params.default_config()).result()
        good = ex.submit(_wl(p), p.params.default_config()).result()
    assert bad.crashed and not good.crashed
    return _res(bad), _res(good)


def s_quarantine_brackets(p, tmp):
    q = p.quarantine.Quarantine(tmp, worker="t0")
    ev = _evaluator(p)
    with p.executor.SweepExecutor(ev, max_workers=2, quarantine=q) as ex:
        ex.submit(_wl(p), p.params.default_config()).result()
    return _ledger(q)


def s_quarantined_skipped(p, tmp):
    """Worker death: a config struck to the threshold is skipped and
    scored as a crash, fleet-wide."""
    q = p.quarantine.Quarantine(tmp, strike_threshold=1)
    cfg = p.params.default_config()
    q.strike("att-1", p.quarantine.config_key(cfg), _wl(p).key())
    ev = _evaluator(p)
    with p.executor.SweepExecutor(ev, max_workers=2, quarantine=q) as ex:
        res = ex.submit(_wl(p), cfg).result()
        other = ex.submit(_wl(p), cfg.replace(microbatches=2)).result()
        stats = ex.stats()
    assert res.failure == p.trial.FAILURE_WORKER_DEATH
    return _res(res), _res(other), stats, ev.calls, _ledger(q)


def s_timeout_strikes(p, tmp):
    q = p.quarantine.Quarantine(tmp, strike_threshold=1)
    ev = _evaluator(p, delay=0.3)
    cfg = p.params.default_config()
    with p.executor.SweepExecutor(ev, max_workers=2, trial_timeout_s=0.05,
                                  quarantine=q) as ex:
        first = ex.submit(_wl(p), cfg).result()
        second = ex.submit(_wl(p), cfg).result()
    assert second.error.startswith("quarantined")
    return _res(first), _res(second), len(ev.calls), _ledger(q)


def s_ledger_rules(p, tmp):
    """Orphan reaping, the completion-reset rule and the threshold."""
    q = p.quarantine.Quarantine(tmp, strike_threshold=2)
    base = p.params.default_config()
    a, b = base, base.replace(microbatches=2)
    q.begin("cell-a", a)                       # orphaned: dies mid-trial
    tok = q.begin("cell-a", b)
    q.complete(tok, crashed=False)
    q.begin("cell-b", b)                       # another cell's orphan
    reaped = q.reap_orphans("cell-a")
    again = q.reap_orphans("cell-a")           # idempotent
    q.begin("cell-a", a)
    reaped += q.reap_orphans()
    ka, kb = (p.quarantine.config_key(c) for c in (a, b))
    return (reaped, again, q.effective_strikes(ka),
            q.effective_strikes(kb), q.is_quarantined(ka),
            sorted(q.quarantined_keys()), q.summary(), _ledger(q))


def s_classify(p, tmp):
    t = p.trial
    errs = [OSError("disk"), TimeoutError("t"), ConnectionError("c"),
            MemoryError(), ValueError("v"), RuntimeError("r"),
            KeyError("k"), NotImplementedError("n"),
            t.TrialError("tagged", failure=t.FAILURE_TRANSIENT),
            t.TrialError("default")]
    out = [t.classify_exception(e) for e in errs]
    assert out[:4] == [t.FAILURE_TRANSIENT] * 4
    return out


def s_cache_memo(p, tmp):
    """Successes persist to disk; deterministic failures stay in memory
    only; transient failures are never remembered."""
    t = p.trial
    cc = t.CompileCache(directory=tmp)
    calls = {"ok": 0, "det": 0, "tr": 0}

    def builder(kind, val):
        def build():
            calls[kind] += 1
            return dict(val)
        return build

    ok = builder("ok", {"cost": 1.0})
    det = builder("det", {"error": "ValueError: bad",
                          "failure": t.FAILURE_DETERMINISTIC})
    tr = builder("tr", {"error": "OSError: hiccup",
                        "failure": t.FAILURE_TRANSIENT})
    for _ in range(2):
        for key, b in (("ok", ok), ("det", det), ("tr", tr)):
            cc.get_or_build(key, b)
    disk = sorted(q.name for q in tmp.glob("*.json"))
    fresh = t.CompileCache(directory=tmp)   # a new process: disk only
    fresh.get_or_build("ok", ok)
    fresh.get_or_build("det", det)
    assert calls == {"ok": 1, "det": 2, "tr": 2}
    return calls, disk, cc.stats(), fresh.stats()


def s_runner_log(p, tmp):
    """TrialRunner's log and history emission, and run_trials' indices
    on the sequential and the executor path."""
    base = p.params.default_config()
    cands = [(base, "a", None), (base.replace(microbatches=2), "b",
                                 {"microbatches": 2})]
    seen = []
    runner = p.trial.TrialRunner(_wl(p), _evaluator(p),
                                 history=lambda *a: seen.append(a[2]))
    runner.run(base, "warmup")
    seq = p.executor.run_trials(runner, cands)
    ev = _evaluator(p)
    par = p.trial.TrialRunner(_wl(p), ev)
    with p.executor.SweepExecutor(ev, max_workers=2) as ex:
        pairs = p.executor.run_trials(par, cands, ex)
    runner.record(base, "replayed", seq[0][1], replayed=True)
    return ([i for i, _ in seq], [i for i, _ in pairs], seen,
            [dataclasses.asdict(e) for e in runner.log],
            [dataclasses.asdict(e) for e in par.log])


@pytest.mark.parametrize("crash", [{}, {"remat_policy": "full"}])
@pytest.mark.parametrize("walk", ["tree", "sensitivity"])
def test_parallel_walk_equals_sequential_in_both(walk, crash):
    """A walk through the executor logs exactly what the sequential walk
    logs, and the port's logs equal the reference's."""
    logs = {}
    for name, p in PKGS.items():
        drive = (p.tree.run_tuning if walk == "tree"
                 else p.sensitivity.run_sensitivity)
        base = p.params.default_config(shard_strategy="fsdp_tp")
        seq_runner = p.trial.TrialRunner(_wl(p), _evaluator(p, crash_on=crash))
        seq = drive(seq_runner, base)
        ev = _evaluator(p, crash_on=crash)
        with p.executor.SweepExecutor(ev, max_workers=4) as ex:
            runner = p.trial.TrialRunner(_wl(p), ev)
            par = drive(runner, base, executor=ex)
        # as JSON: a crashed sensitivity value is nan, unequal to itself
        assert _j(dataclasses.asdict(par)) == _j(dataclasses.asdict(seq))
        assert [dataclasses.asdict(e) for e in runner.log] \
            == [dataclasses.asdict(e) for e in seq_runner.log]
        logs[name] = [dataclasses.asdict(e) for e in runner.log]
    assert logs["ref"] == logs["port"]


SCENARIOS = {f.__name__[2:]: f for f in (
    s_map_order, s_dedup, s_exception_is_crash, s_deadline,
    s_retry_to_success, s_retry_exhausted, s_deterministic_not_retried,
    s_fresh_submit_after_crash, s_quarantine_brackets,
    s_quarantined_skipped, s_timeout_strikes, s_ledger_rules, s_classify,
    s_cache_memo, s_runner_log)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_port_matches_reference(scenario, tmp_path):
    out = {}
    for name, p in PKGS.items():
        (tmp_path / name).mkdir()
        out[name] = SCENARIOS[scenario](p, tmp_path / name)
    assert _j(out["port"]) == _j(out["ref"])


# ------------------------------------ deadlines against the device lock
def _on_device(p, hold_s, ran):
    """An evaluator that holds the CPU's trial lock for ``hold_s``."""
    def ev(wl, rt):
        with p.trial.hold_device("cpu"):
            ran.append(rt.microbatches)
            time.sleep(hold_s)
        return p.trial.TrialResult(cost_s=1.0)
    return ev


def test_deadline_counts_the_time_on_the_device_not_the_wait():
    """Two trials that each hold the device 0.2 s under a 0.3 s deadline:
    the second waits 0.2 s for the lock and still finishes in time."""
    p, ran = PKGS["port"], []
    base = p.params.default_config()
    with p.executor.SweepExecutor(_on_device(p, 0.2, ran), max_workers=2,
                                  trial_timeout_s=0.3) as ex:
        res = ex.map(_wl(p), [base, base.replace(microbatches=2)])
        assert ex.stats()["timeouts"] == 0
    assert not any(r.crashed for r in res) and sorted(ran) == [1, 2]


def test_trial_abandoned_while_waiting_never_reaches_the_device():
    """A wedged holder times out; the trial queued behind it waits at
    most one more deadline, is abandoned, and does not run once the
    lock frees."""
    p, ran = PKGS["port"], []
    base = p.params.default_config()
    with p.executor.SweepExecutor(_on_device(p, 0.6, ran), max_workers=2,
                                  trial_timeout_s=0.1) as ex:
        res = ex.map(_wl(p), [base, base.replace(microbatches=2)])
    time.sleep(0.7)                     # the wedged holder lets go
    assert [r.failure for r in res] == ["timeout", "timeout"]
    assert len(ran) == 1
