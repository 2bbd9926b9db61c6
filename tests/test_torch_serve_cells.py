"""The port's serve cells against the reference's: cell spellings, the
virtual-clock replay and its SLO abort point on a fake-latency
scheduler, which config each trace replays, one real replay on the CPU,
and the per-device trial lock."""
import collections
import threading
import time

import pytest
import torch

import repro.serving.evaluator as ref_eval
import repro.serving.scheduler as ref_sched
import repro.serving.traffic as ref_traffic
import repro_torch.serving.evaluator as port_eval
import repro_torch.serving.scheduler as port_sched
import repro_torch.serving.traffic as port_traffic
from _torch_surface import PKGS
from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro_torch.core import kernel_cell, params

SERVE = {"ref": (ref_eval, ref_sched), "port": (port_eval, port_sched)}


@pytest.mark.parametrize("spec", [
    "serve:smollm-135m:poisson_tiny", "serve:zamba2-7b:bursty_tiny",
    "kernel:flash_attention:ragged", "kernel:ssm_scan:tiny",
    "smollm-135m:train_4k", "glm4-9b:decode_32k:multipod",
    "serve:glm4-9b:diurnal_tiny,kernel:rmsnorm:tiny,xlstm-1.3b:train_4k"])
def test_parse_cells_round_trips_as_in_reference(spec):
    out = {}
    for name, p in PKGS.items():
        cells = p.campaign.parse_cells(spec)
        again = p.campaign.parse_cells(",".join(c.spec() for c in cells))
        assert again == cells
        out[name] = [(type(c).__name__, c.arch, c.shape, c.multi_pod,
                      c.key(), c.spec(), p.history.cell_signature(
                          c.arch, c.shape, c.multi_pod)) for c in cells]
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("bad", ["serve:smollm-135m", "serve:a:b:c",
                                 "serve:nope:poisson_tiny",
                                 "serve:smollm-135m:nope",
                                 "kernel:nope:tiny", "kernel:rmsnorm:huge"])
def test_malformed_cells_rejected_as_in_reference(bad):
    msgs = []
    for p in PKGS.values():
        with pytest.raises(ValueError) as err:
            p.campaign.parse_cells(bad)
        msgs.append(str(err.value))
    # the port's trace registry also holds poisson_card
    assert msgs[1].replace(", poisson_card", "") == msgs[0]


def test_serve_stages_and_signature_equal_reference():
    cells = {n: p.campaign.parse_cells("serve:smollm-135m:poisson_tiny")[0]
             for n, p in PKGS.items()}
    stages = {n: [(s.name, s.spark_name, list(s.alternatives), s.kinds)
                  for s in SERVE[n][0].serve_stages(c)]
              for n, c in cells.items()}
    assert stages["port"] == stages["ref"]
    assert port_eval.SERVE_KNOBS == ref_eval.SERVE_KNOBS


@pytest.mark.parametrize("trace", ref_traffic.trace_names())
def test_reference_traces_keep_key_and_reduced_config(trace):
    assert port_traffic.get_trace(trace).key() \
        == ref_traffic.get_trace(trace).key()
    assert port_traffic.get_trace(trace).to_json() \
        == ref_traffic.get_trace(trace).to_json()
    for arch in ("smollm-135m", "zamba2-7b"):
        wl = port_eval.serve_cell(arch, trace).workload()
        ref_wl = ref_eval.serve_cell(arch, trace).workload()
        assert wl.cfg == port_eval.ServeWorkload(
            wl.arch, wl.shape).cfg
        assert wl.cfg.d_model == ref_get_reduced(arch).d_model
        assert wl.cfg.n_layers == ref_wl.cfg.n_layers
        assert vars(wl.shp) == vars(ref_wl.shp)


def test_card_trace_replays_the_published_config():
    assert set(port_traffic.trace_names()) \
        == set(ref_traffic.trace_names()) | {"poisson_card"}
    assert [n for n, spec in port_traffic.TRACE_SPECS.items()
            if spec.full_width or spec.replays != 1] == ["poisson_card"]
    wl = port_eval.serve_cell("smollm-135m", "poisson_card").workload()
    full = ref_get_config("smollm-135m")
    assert (wl.cfg.d_model, wl.cfg.n_layers, wl.cfg.vocab) \
        == (full.d_model, full.n_layers, full.vocab)
    tr = port_traffic.get_trace("poisson_card")
    assert len(tr.requests) == 24 and tr.meta["seed"] == 2026
    assert tr.meta["full_width"] is True and tr.meta["replays"] == 5
    assert {r.tenant for r in tr.requests} == {"code"}
    assert all(1000 <= r.prompt_len <= 2000 and 8 <= r.max_new_tokens <= 18
               for r in tr.requests)
    assert wl.shp.seq_len == tr.max_prompt_len() + tr.max_new_tokens() + 2
    assert wl.shp.seq_len <= 2048           # smollm-135m's context


# ------------------------------------------------- fake-latency replay
class _Clock:
    def __init__(self):
        self.t = 1000.0

    def time(self):
        return self.t


class _FakeScheduler:
    """Serves waves in a fixed virtual time: a prefill of 0.125 s plus
    1/64 s a prompt, then 1/128 s a decode token (slower in f32 and
    with an int8 cache).  Every step is a binary fraction, so a wave's
    wall time does not depend on where the clock stands."""

    def __init__(self, sched_mod, rt, clock):
        self.queue = collections.deque()
        self.wave_size = int(rt.max_wave_size)
        self.metrics = sched_mod.ServeMetrics()
        self.rt, self.clock = rt, clock

    def submit(self, req):
        self.queue.append(req)

    def run_wave(self):
        wave = [self.queue.popleft()
                for _ in range(min(self.wave_size, len(self.queue)))]
        t0 = self.clock.t
        self.clock.t += 0.125 + 0.015625 * len(wave)
        for r in wave:
            r.t_first_token = self.clock.t
        steps = max(r.max_new_tokens for r in wave) - 1
        slow = (2.0 if self.rt.compute_dtype == "float32" else 1.0) \
            * (1.5 if self.rt.kv_cache_dtype == "int8" else 1.0)
        self.clock.t += 0.0078125 * steps * slow
        self.metrics.decode_tokens += sum(r.max_new_tokens - 1 for r in wave)
        self.metrics.wall_s += self.clock.t - t0
        return wave


def _fake(monkeypatch, name, **kw):
    """The package's ServeEvaluator on the fake scheduler and clock."""
    mod, sched_mod = SERVE[name]
    clock = _Clock()
    monkeypatch.setattr(mod, "time", clock)
    ev = mod.ServeEvaluator(**kw) if name == "ref" \
        else mod.ServeEvaluator(device="cpu", **kw)
    monkeypatch.setattr(
        ev, "_build_scheduler",
        lambda wl, rt, trace: _FakeScheduler(sched_mod, rt, clock))
    return ev


CONFIGS = [{}, {"max_wave_size": 2}, {"max_wave_size": 8},
           {"wave_admission": "full"}, {"kv_cache_dtype": "int8"},
           {"compute_dtype": "bfloat16"}]


@pytest.mark.parametrize("trace", ["poisson_tiny", "bursty_tiny",
                                   "diurnal_tiny", "poisson_card"])
def test_virtual_clock_replay_identical(trace, monkeypatch):
    """Virtual queue delays, TTFTs, served order and cost (the card's
    trace lent to the reference's registry for the comparison; its key
    differs there, since the reference's meta has no full_width or
    replays, and the port replays it five times a trial)."""
    monkeypatch.setitem(ref_traffic.TRACE_SPECS, "poisson_card",
                        port_traffic.TRACE_SPECS["poisson_card"])
    monkeypatch.setattr(ref_traffic, "_TRACE_CACHE", {})
    out = {}
    for name in SERVE:
        ev = _fake(monkeypatch, name)
        wl = SERVE[name][0].ServeWorkload("serve-smollm-135m", trace)
        rows = []
        for delta in CONFIGS:
            rt = PKGS[name].params.default_config(**delta)
            stats = ev.replay(wl, rt)
            stats.pop("wall_s")
            stats.pop("held_s", None)
            if trace == "poisson_card":
                stats.pop("trace_key")
            rows.append((stats, ev.cost_of(stats), vars(ev(wl, rt))))
        out[name] = rows
    for (a, ca, ra), (b, cb, rb) in zip(out["port"], out["ref"]):
        assert a == b and ca == cb
        ra.pop("compile_s"), rb.pop("compile_s")
        assert ra == rb
    assert len({c for _, c, _ in out["ref"]}) > 1


@pytest.mark.parametrize("slo", [1.1, 1.5, 3.0])
def test_slo_abort_point_identical(slo, monkeypatch):
    out = {}
    for name in SERVE:
        ev = _fake(monkeypatch, name, slo_ttft=slo)
        wl = SERVE[name][0].ServeWorkload("serve-smollm-135m",
                                          "bursty_tiny")
        rows = []
        for delta in CONFIGS:
            res = ev(wl, PKGS[name].params.default_config(**delta))
            rows.append((res.cost_s, res.crashed, res.failure, res.error))
        out[name] = rows
    assert out["port"] == out["ref"]
    if slo == 1.1:
        assert any("slo-violation" in r[3] for r in out["ref"])


def test_replays_score_the_median_and_guard_only_the_first(monkeypatch):
    """A trace with replays > 1: one scheduler serves the trace that many
    times, the trial's cost is the median replay's, and the SLO guard
    watches only the first replay."""
    ev = _fake(monkeypatch, "port")
    slow = iter([1.0, 3.0, 2.0])
    built, seen_metrics = [], [None]

    def build(wl, rt, trace):
        sched = _FakeScheduler(port_sched, rt, port_eval.time)
        run_wave = sched.run_wave

        def wave():
            if sched.metrics is not seen_metrics[-1]:
                # a replay's first wave (each replay resets the metrics)
                seen_metrics.append(sched.metrics)
                sched.clock.t += next(slow)
            return run_wave()
        sched.run_wave = wave
        built.append(sched)
        return sched

    monkeypatch.setattr(ev, "_build_scheduler", build)
    seen = []

    class Guard:
        def observe(self, **kw):
            seen.append(kw["served"])

    wl = port_eval.ServeWorkload("serve-smollm-135m", "poisson_tiny")
    stats = ev.replay(wl, params.default_config(), guard=Guard(),
                      replays=3)
    costs = stats["replay_costs"]
    assert len(built) == 1 and len(costs) == 3
    assert costs[0] < costs[2] < costs[1]
    assert ev.cost_of(stats) == costs[2]
    n = len(port_traffic.get_trace("poisson_tiny").requests)
    assert seen == list(range(1, n + 1))


def test_non_serve_workload_is_a_crashed_trial():
    res = port_eval.ServeEvaluator(device="cpu")(
        PKGS["port"].trial.Workload("smollm-135m", "train_4k"),
        params.default_config())
    assert res.crashed and "not a serve cell" in res.error


# ------------------------------------------------------ a real replay
def test_real_replay_on_cpu_has_finite_cost():
    """serve:smollm-135m:poisson_tiny through the port's scheduler and
    model on the CPU (reduced config, the kernels' plain versions)."""
    ev = port_eval.ServeEvaluator(device="cpu")
    wl = port_eval.serve_cell("smollm-135m", "poisson_tiny").workload()
    rt = params.default_config(shard_strategy="fsdp_tp", attn_impl="pallas")
    stats = ev.replay(wl, rt)
    assert stats["served"] == len(port_traffic.get_trace(
        "poisson_tiny").requests)
    assert sorted(stats["served_order"]) == stats["served_order"]
    res = ev(wl, rt.replace(kv_cache_dtype="int8", max_wave_size=2))
    assert not res.crashed, res.error
    assert 0 < res.cost_s < float("inf")
    assert torch.is_grad_enabled()          # no_grad stayed in the trial


def test_no_card_is_a_crashed_trial_not_a_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wl = port_eval.serve_cell("smollm-135m", "poisson_tiny").workload()
    res = port_eval.ServeEvaluator()(wl, params.default_config())
    assert res.crashed and "no CUDA device" in res.error


# -------------------------------------------------------- device lock
def test_concurrent_trials_on_one_device_never_overlap(monkeypatch):
    """Serve replays and kernel timings on one device take turns, and
    each runs with grad mode off in its own thread."""
    spans, lock = [], threading.Lock()

    def record(kind):
        t0 = time.perf_counter()
        grad = torch.is_grad_enabled()
        time.sleep(0.05)
        with lock:
            spans.append((t0, time.perf_counter(), kind, grad))

    ev = port_eval.ServeEvaluator(device="cpu")
    monkeypatch.setattr(ev, "_build_scheduler", lambda *a: None)
    monkeypatch.setattr(ev, "_replay_inner",
                        lambda *a: record("serve") or {
                            "served": 1, "mean_ttft_s": 0.1,
                            "p95_qdelay_s": 0.0, "decode_tok_per_s": 0.0,
                            "decode_tokens": 0})
    kern = kernel_cell.KernelBenchEvaluator(repeats=1, device="cpu")
    spec = kernel_cell.KERNELS["rmsnorm"]
    monkeypatch.setitem(kernel_cell.KERNELS, "rmsnorm", spec.__class__(
        spec.name, spec.knobs, spec.shapes,
        lambda shape, rt, dev: (lambda: record("kernel"), ())))
    serve_wl = port_eval.serve_cell("smollm-135m", "poisson_tiny").workload()
    kern_wl = kernel_cell.kernel_cell("rmsnorm", "tiny").workload()
    rt = params.default_config()
    results = []
    threads = [threading.Thread(target=lambda f=f, w=w: results.append(
        f(w, rt))) for f, w in [(ev, serve_wl), (kern, kern_wl)] * 3]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert len(results) == 6 and not any(r.crashed for r in results)
    spans.sort()
    assert len(spans) == 3 + 3 * 2          # a kernel trial calls twice
    for (_, end, _, _), (start, _, _, _) in zip(spans, spans[1:]):
        assert end <= start
    assert not any(grad for *_, grad in spans)
