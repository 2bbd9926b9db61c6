"""Measured step cells in the port, on the CPU: the counterparts of
tests/test_measure.py:162-217 (the hardened WallClockEvaluator's
accounting, a tile that does not divide) and of the reference's
ReducedWallClock (its proxy, its forced eager attention on train), the
dispatch evaluator taking step cells, single-cell ``tune --device cpu``
and a step-cell campaign on reduced cells, the card-sized shapes (absent
from every enumeration, each reference shape unchanged), the decode
cache a card cell is timed at, and the forward-only kernel wrappers."""
import dataclasses
import json

import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import all_cells as jall_cells
from repro.core.campaign import enumerate_cells as jenumerate_cells
from repro_torch import configs
from repro_torch.configs import CARD_SHAPES, SHAPES, get_reduced, get_shape
from repro_torch.configs.base import FilledDecodeShape, ShapeConfig
from repro_torch.core import campaign, measure, telemetry, trial
from repro_torch.core import kernel_cell as kc
from repro_torch.core.trial import (FAILURE_DETERMINISTIC, FAILURE_TRANSIENT,
                                    TrialError, WallClockEvaluator, Workload)
from repro_torch.launch import tune
from repro_torch.runtime import stepfn

# reduced stand-ins of the card cells: the arch's reduced config at a
# CPU-sized shape of each kind
SMALL = {"train_card": ShapeConfig("train_card", 32, 4, "train"),
         "prefill_card": ShapeConfig("prefill_card", 64, 2, "prefill"),
         "decode_card": FilledDecodeShape("decode_card", 64, 2, "decode"),
         "decode_32k": ShapeConfig("decode_32k", 64, 2, "decode")}


@pytest.fixture
def reduced_cells(monkeypatch, tmp_path):
    """Step cells run the arch's reduced config at SMALL's shapes;
    timings and default reports under the test's directory."""
    monkeypatch.setattr(trial, "get_config", get_reduced)
    monkeypatch.setattr(trial, "get_shape", lambda s: SMALL[s])
    monkeypatch.setattr(measure, "TIMING_DIR", tmp_path / "timings")
    monkeypatch.setattr(tune, "RESULTS_DIR", tmp_path / "tuning")
    # one step a sample: the CPU walks stay short (the window is held
    # in test_wallclock_times_a_short_step_in_windows)
    monkeypatch.setattr(kc, "STEP_MIN_SAMPLE_S", 0.0)
    yield tmp_path
    telemetry.uninstall()


def base():
    return tune._baseline()


# ----------------------------------------- hardened WallClockEvaluator
@dataclasses.dataclass
class StubBundle:
    fn: object
    args: tuple
    kind: str = "train"

    def measure_args(self, device):
        return tuple(torch.zeros(8) for _ in self.args)


def test_wallclock_evaluator_accounting(monkeypatch):
    calls = []

    def stub_build(cfg, shape, rt, mesh):
        def fn(p, o, b):
            calls.append((p.clone(), o.clone()))
            return p + 1.0, o + 1.0, (b * 2.0).sum()
        return StubBundle(fn=fn, args=(None, None, None))

    monkeypatch.setattr(stepfn, "build_step", stub_build)
    ev = WallClockEvaluator(repeats=3, device="cpu")
    res = ev(Workload("smollm-135m", "train_4k", False), base())
    assert not res.crashed and res.cost_s > 0
    assert res.compiles == 1 and res.compile_s >= 0.0
    assert res.peak_bytes is None              # no device peak on the CPU
    # the first call plus three timed ones; the donated state threaded
    assert [float(p[0]) for p, _ in calls] == [0.0, 1.0, 2.0, 3.0]

    def exploding(cfg, shape, rt, mesh):
        raise TrialError("CacheReplay: stored crash",
                         failure=FAILURE_TRANSIENT)

    monkeypatch.setattr(stepfn, "build_step", exploding)
    res = ev(Workload("smollm-135m", "train_4k", False), base())
    assert res.crashed and res.failure == FAILURE_TRANSIENT
    assert res.error == "CacheReplay: stored crash"  # pre-tag kept
    assert res.compiles == 0 and res.compile_s >= 0.0


def test_wallclock_times_a_short_step_in_windows(monkeypatch):
    # a step of 0.01 s on a fake clock, samples of at least 0.025 s: an
    # untimed first call, an untimed call that sets the window (3), then
    # two samples of three calls each, each sample their mean
    clock = [0.0]
    calls = []

    def stub_build(cfg, shape, rt, mesh):
        def fn(p, o, b):
            calls.append(float(p[0]))
            clock[0] += 0.01
            return p + 1.0, o + 1.0, b
        return StubBundle(fn=fn, args=(None, None, None))

    monkeypatch.setattr(stepfn, "build_step", stub_build)
    monkeypatch.setattr(trial.time, "perf_counter", lambda: clock[0])
    res = WallClockEvaluator(repeats=2, device="cpu", min_sample_s=0.025)(
        Workload("smollm-135m", "train_4k", False), base())
    assert not res.crashed, res.error
    assert calls == [float(i) for i in range(8)]
    assert res.cost_s == pytest.approx(0.01)


def test_wallclock_out_of_memory_is_a_deterministic_crash(monkeypatch):
    def oom_build(cfg, shape, rt, mesh):
        def fn(*a):
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to "
                                         "allocate 40.00 GiB")
        return StubBundle(fn=fn, args=(None, None, None))

    monkeypatch.setattr(stepfn, "build_step", oom_build)
    res = WallClockEvaluator(repeats=2, device="cpu")(
        Workload("smollm-135m", "train_4k", False), base())
    assert res.crashed and res.failure == FAILURE_DETERMINISTIC
    assert res.error.startswith("OutOfMemoryError: CUDA out of memory")


def test_wallclock_rejects_nondividing_tile():
    # validation fires before any device or build work: 384 % 256 != 0
    ev = WallClockEvaluator(repeats=1, device="no-such-device")

    class OddSeq(Workload):
        @property
        def shp(self):
            return ShapeConfig("odd", 384, 8, "train")

    res = ev(OddSeq("smollm-135m", "train_4k", False),
             base().replace(attn_block_kv=256))
    assert res.crashed and res.failure == FAILURE_DETERMINISTIC
    assert "divide" in res.error


@pytest.mark.parametrize("shape", sorted(SMALL))
def test_wallclock_times_real_steps_on_reduced_cells(reduced_cells, shape):
    res = WallClockEvaluator(repeats=2, device="cpu")(
        Workload("smollm-135m", shape), base())
    assert not res.crashed, res.error
    assert 0 < res.cost_s < float("inf") and res.compiles == 1


def test_decode_card_args_fill_the_cache_to_its_last_row(reduced_cells):
    wl = Workload("smollm-135m", "decode_card")
    rt = base()
    bundle = stepfn.build_step(wl.cfg, wl.shp, rt)
    params, cache, tokens = bundle.measure_args("cpu")
    assert cache["pos"] == wl.shp.seq_len - 1
    assert all(bool(t.abs().sum() > 0) for t in cache["layers"].values())
    # a reference decode cell keeps the reference's zero-filled cache at
    # position 0
    ref = Workload("smollm-135m", "decode_32k")
    bundle = stepfn.build_step(ref.cfg, ref.shp, rt)
    _, c0, _ = bundle.measure_args("cpu")
    assert c0["pos"] == 0 and all(
        not bool(t.any()) for t in c0["layers"].values())
    assert not get_shape("decode_32k").cache_filled
    assert get_shape("decode_card").cache_filled


def test_one_step_program_per_cell(reduced_cells, monkeypatch):
    """A default ``Campaign``, ``tune_campaign`` and single-cell mode
    time a step cell through one evaluator: one timing key, one program
    (``decode_card`` at its last row, a reference decode cell at
    position 0), so a cost cached by one is the cost of what the other
    would run."""
    seen = []
    real = stepfn.build_step

    def spy(cfg, shape, rt, mesh=None):
        b = real(cfg, shape, rt, mesh)
        fn = b.fn

        def rec(*a):
            seen.append((shape.name, a[1]["pos"]))
            return fn(*a)
        return dataclasses.replace(b, fn=rec)

    monkeypatch.setattr(stepfn, "build_step", spy)
    wl, rt = Workload("smollm-135m", "decode_card"), base()
    camp = campaign.Campaign(campaign.parse_cells("smollm-135m:decode_card"),
                             checkpoint_dir=reduced_cells / "c")
    one = kc.step_evaluator()
    assert camp.evaluator.step._key(wl, rt) == one._key(wl, rt)
    assert vars(camp.evaluator.step.evaluator) == vars(one.evaluator)
    # single-cell mode, then the dispatch stack on the same timing cache:
    # the baseline comes back cached, of the same program
    t = reduced_cells / "t"
    rep = tune.tune_cell("smollm-135m", "decode_card", device="cpu",
                         timing_dir=t, out_dir=reduced_cells / "r")
    assert {p for _, p in seen} == {63}
    disp = kc.DispatchEvaluator(device="cpu", cache_dir=t)
    res = disp(wl, rt)
    assert res.cached and res.cost_s == rep.baseline_cost
    seen.clear()
    assert not disp(Workload("smollm-135m", "decode_32k"), rt).crashed
    assert {p for _, p in seen} == {0}


# ------------------------------------------------- ReducedWallClock
def test_reduced_wallclock_runs_the_proxy_and_forces_eager_train(
        monkeypatch):
    seen = []

    def stub_build(cfg, shape, rt, mesh):
        seen.append((cfg.name, shape, rt.attn_impl))
        return StubBundle(fn=lambda p, o, b: (p, o, b.sum()),
                          args=(None, None, None))

    monkeypatch.setattr(stepfn, "build_step", stub_build)
    ev = measure.ReducedWallClock(repeats=2, device="cpu")
    for shape in ("train_4k", "prefill_32k", "decode_card"):
        res = ev(Workload("smollm-135m", shape), base())
        assert not res.crashed, res.error
    (n0, s0, a0), (n1, s1, a1), (n2, s2, a2) = seen
    assert n0 == n1 == n2 == "smollm-135m-reduced"
    assert (s0.seq_len, s0.global_batch, s0.kind, a0) \
        == (128, 8, "train", "xla")            # forward-only kernels
    assert (s1.seq_len, s1.global_batch, s1.kind, a1) \
        == (128, 8, "prefill", "pallas")
    assert (s2.seq_len, s2.global_batch, s2.kind, a2) \
        == (128, 8, "decode", "pallas")
    assert s0.name == "measure_train_4k"


def test_default_measured_evaluator_times_step_cells(reduced_cells):
    ev = measure.default_measured_evaluator(device="cpu")
    res = ev(Workload("smollm-135m", "train_card"), base())
    assert not res.crashed, res.error
    assert ev(Workload("smollm-135m", "train_card"), base()).cached


# ------------------------------------------------- dispatch and campaigns
def test_dispatch_evaluator_accepts_step_cells(reduced_cells):
    disp = kc.DispatchEvaluator(device="cpu",
                                cache_dir=reduced_cells / "t")
    for cell in ("smollm-135m:train_card", "smollm-135m:decode_card",
                 "zamba2-7b:prefill_card"):
        disp.accepts(campaign.parse_cells(cell)[0])
    # training outside the dense family is not ported: refused up front
    with pytest.raises(NotImplementedError, match="slice 5"):
        disp.accepts(campaign.parse_cells("zamba2-7b:train_card")[0])
    res = disp(Workload("smollm-135m", "prefill_card"), base())
    assert not res.crashed, res.error
    assert any(p.name.startswith("smollm-135m__prefill_card__pod")
               for p in (reduced_cells / "t").glob("*.json"))


def test_step_campaign_walks_reduced_cells(reduced_cells):
    ckpt = reduced_cells / "camp"
    reports, stats = tune.tune_campaign(
        campaign.parse_cells("smollm-135m:prefill_card,"
                             "smollm-135m:train_card"),
        fresh=True, checkpoint_dir=ckpt, device="cpu", trace=True,
        timing_dir=reduced_cells / "t")
    for key, n in (("smollm-135m__prefill_card__pod", 6),
                   ("smollm-135m__train_card__pod", 10)):
        rep = reports[key]
        assert rep.n_trials == n
        assert not any(e["result"]["crashed"] for e in rep.log)
        assert (ckpt / "reports" / f"{key}.json").exists()
    events = telemetry.read_events(ckpt)
    assert len([e for e in events if e["kind"] == "trial"]) \
        == stats["evaluated_trials"]


def test_single_cell_tune_on_a_reduced_cell(reduced_cells, capsys):
    out = reduced_cells / "cell"
    assert tune.main(["--device", "cpu", "--arch", "smollm-135m",
                      "--shape", "decode_card", "--checkpoint-dir",
                      str(out)]) == 0
    printed = capsys.readouterr().out
    assert "speedup: x" in printed
    rep = json.loads((out / "reports" /
                      "smollm-135m__decode_card__pod.json").read_text())
    assert rep["n_trials"] == 6 and rep["log"][0]["name"] == "baseline"
    assert not any(e["result"]["crashed"] for e in rep["log"])
    assert not list((reduced_cells / "tuning").glob("*"))


def test_single_cell_refusals(reduced_cells, monkeypatch):
    with pytest.raises(SystemExit):
        tune.main(["--device", "cpu", "--arch", "smollm-135m"])
    with pytest.raises(SystemExit):
        tune.main(["--device", "cpu", "--arch", "smollm-135m", "--shape",
                   "train_card", "--measure-top-k", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.main(["--arch", "smollm-135m", "--shape", "train_card"])


# ------------------------------------------------- the card shapes
def test_card_shapes_reach_get_shape_and_no_enumeration():
    assert set(CARD_SHAPES) == {"train_card", "prefill_card",
                                "decode_card"}
    for name, shp in CARD_SHAPES.items():
        assert get_shape(name) is shp and name not in SHAPES
    assert (get_shape("train_card").seq_len,
            get_shape("train_card").global_batch) == (2048, 4)
    assert (get_shape("prefill_card").seq_len,
            get_shape("prefill_card").kind) == (32768, "prefill")
    assert (get_shape("decode_card").seq_len,
            get_shape("decode_card").global_batch) == (32768, 8)
    # every reference shape and every enumerated cell is the reference's
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    assert not any(v.cache_filled for v in SHAPES.values())
    assert configs.all_cells() == jall_cells()
    assert [c.key() for c in campaign.enumerate_cells()] \
        == [c.key() for c in jenumerate_cells()]
    with pytest.raises(KeyError):
        get_shape("train_8k")


# ------------------------------------------------- forward-only kernels
@pytest.mark.parametrize("name", ["rmsnorm", "flash_attention",
                                  "flash_decode", "ssm_scan"])
def test_kernel_wrapper_raises_on_tensor_that_requires_grad(name):
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.ssm_scan import ops as ssm
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    calls = {
        "rmsnorm": lambda x: rms.rmsnorm(x, torch.ones(8)),
        "flash_attention": lambda x: fa.flash_attention(x, x, x),
        "flash_decode": lambda x: fd.flash_decode(x, r(1, 16, 2, 8),
                                                  r(1, 16, 2, 8), 4),
        "ssm_scan": lambda x: ssm.ssm_scan(r(1, 8, 2, 8), r(1, 8, 8),
                                           r(1, 8, 8), x, x),
    }
    shapes = {"rmsnorm": (2, 3, 8), "flash_attention": (1, 8, 2, 8),
              "flash_decode": (1, 1, 2, 8), "ssm_scan": (1, 8, 2)}
    x = r(*shapes[name]).requires_grad_()
    with pytest.raises(RuntimeError, match="forward-only"):
        calls[name](x)
    with torch.no_grad():                  # no gradient asked for: runs
        calls[name](x)
