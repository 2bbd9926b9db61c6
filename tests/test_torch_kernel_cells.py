"""The port's kernel cells and dispatch against the reference's: the
registry and its stage, the tile-crash rule, the timing cache's keys and
the re-rank selection, the kernel bench on the CPU (the kernels' plain
versions), the dispatch by cell kind, and the refusal of step cells
whose model path is not ported yet (an unported family)."""
import dataclasses
import json
import math

import pytest

import repro.core.kernel_cell as ref_kc
import repro.core.measure as ref_measure
import repro_torch.core.kernel_cell as kc
import repro_torch.core.measure as measure
from _torch_surface import PKGS, port_surface
from repro_torch.core import campaign, params, trial

CELLS = [(k, s) for k in sorted(kc.KERNELS) for s in sorted(
    kc.KERNELS[k].shapes)]


def test_registry_equals_reference():
    assert sorted(kc.KERNELS) == sorted(ref_kc.KERNELS)
    for name, spec in kc.KERNELS.items():
        ref = ref_kc.KERNELS[name]
        assert spec.knobs == ref.knobs
        assert {k: dataclasses.astuple(v) for k, v in spec.shapes.items()} \
            == {k: dataclasses.astuple(v) for k, v in ref.shapes.items()}
    assert [c.key() for c in kc.kernel_cells()] \
        == [c.key() for c in ref_kc.kernel_cells()]


@pytest.mark.parametrize("cell", CELLS, ids=":".join)
def test_stages_and_signature_equal_reference(cell):
    port, ref = kc.kernel_cell(*cell), ref_kc.kernel_cell(*cell)
    assert [(s.name, s.spark_name, list(s.alternatives), s.kinds)
            for s in kc.kernel_stages(port)] \
        == [(s.name, s.spark_name, list(s.alternatives), s.kinds)
            for s in ref_kc.kernel_stages(ref)]
    assert kc.kernel_signature(port.arch, port.shape) \
        == ref_kc.kernel_signature(ref.arch, ref.shape)
    assert vars(port.workload().shp) == vars(ref.workload().shp)


@pytest.mark.parametrize("tiles", [{"attn_block_q": 256},
                                   {"attn_block_kv": 256},
                                   {"attn_block_q": 256,
                                    "attn_block_kv": 256}])
def test_invalid_tile_crashes_deterministically_as_reference(tiles):
    """flash_attention's ragged shape (S 384): a non-dividing tile is a
    clean deterministic-crash trial with the reference's error."""
    out = []
    for mod, p in ((ref_kc, PKGS["ref"]), (kc, PKGS["port"])):
        wl = mod.kernel_cell("flash_attention", "ragged").workload()
        ev = mod.KernelBenchEvaluator() if mod is ref_kc \
            else mod.KernelBenchEvaluator(device="cpu")
        res = ev(wl, p.params.default_config(**tiles))
        out.append((res.crashed, res.failure, res.error, res.cost_s,
                    res.compiles))
    assert out[0] == out[1]
    assert out[1][:2] == (True, trial.FAILURE_DETERMINISTIC)
    assert "does not divide sequence length 384" in out[1][2]


@pytest.mark.parametrize("cell", CELLS, ids=":".join)
def test_kernel_bench_on_cpu_has_finite_cost(cell):
    ev = kc.KernelBenchEvaluator(repeats=2, device="cpu")
    res = ev(kc.kernel_cell(*cell).workload(), params.default_config())
    assert not res.crashed, res.error
    assert 0 < res.cost_s < math.inf and res.compiles == 1


def test_timing_cache_keys_and_top_k_equal_reference(tmp_path):
    for cell in CELLS:
        for rt in (params.default_config(),
                   params.default_config(attn_block_q=256)):
            ref_rt = PKGS["ref"].params.default_config(**rt.as_dict())
            assert measure.measure_key(kc.kernel_cell(*cell).workload(),
                                       rt, 3) \
                == ref_measure.measure_key(
                    ref_kc.kernel_cell(*cell).workload(), ref_rt, 3)
    base = params.default_config().as_dict()
    log = [{"name": n, "config": {**base, "microbatches": m},
            "result": {"cost_s": c, "crashed": x}}
           for n, m, c, x in [("a", 1, 3.0, False), ("b", 2, 1.0, True),
                              ("c", 4, 2.0, False), ("d", 1, 0.5, False)]]
    port = measure.select_top_k(log, 2)
    ref = ref_measure.select_top_k(log, 2)
    assert [(d["name"], d["config"].as_dict(), d["model_cost_s"])
            for d in port] == [(d["name"], d["config"].as_dict(),
                                d["model_cost_s"]) for d in ref]


def test_cached_kernel_trial_replays_from_disk(tmp_path):
    calls = []

    def bench(wl, rt):
        calls.append(rt.attn_block_kv)
        return trial.TrialResult(cost_s=0.25, compiles=1, compile_s=0.5)

    bench.repeats = 3
    wl = kc.kernel_cell("flash_decode", "tiny").workload()
    first = measure.CachedMeasure(bench, measure.TimingCache(tmp_path))
    second = measure.CachedMeasure(bench, measure.TimingCache(tmp_path))
    assert not first(wl, params.default_config()).cached
    res = second(wl, params.default_config())
    assert res.cached and res.compiles == 0 and res.cost_s == 0.25
    assert calls == [128]
    assert measure.TIMING_DIR.parts[-4:] == ("results", "torch", "trials",
                                            "timings")


def test_timing_cache_keys_name_the_device(tmp_path):
    """A cost measured on the CPU is never a hit for a trial on a card,
    in the kernel tier and in the serve tier."""
    from repro_torch.serving import evaluator as serve_eval
    wl = kc.kernel_cell("rmsnorm", "tiny").workload()
    rt = params.default_config()
    cpu = kc.DispatchEvaluator(device="cpu", cache_dir=tmp_path)
    assert not cpu(wl, rt).cached
    assert cpu(wl, rt).cached                 # the same device: a hit
    calls = []

    def card(wl, rt):
        calls.append(wl.key())
        return trial.TrialResult(cost_s=1e-5, compiles=1)

    card.device, card.repeats = "cuda", 3
    res = measure.CachedMeasure(card, measure.TimingCache(tmp_path))(wl, rt)
    assert calls == [wl.key()] and not res.cached
    assert measure.device_identity("cpu") == "cpu"
    swl = serve_eval.serve_cell("smollm-135m", "poisson_tiny").workload()
    keys = {serve_eval.CachedServe(serve_eval.ServeEvaluator(device=d),
                                   measure.TimingCache(tmp_path),
                                   repeats=1)._key(swl, rt)
            for d in ("cpu", "cuda")}
    assert len(keys) == 2


def test_dispatch_routes_each_kind():
    seen = []

    def stub(kind):
        def ev(wl, rt):
            seen.append((kind, wl.key()))
            return trial.TrialResult(cost_s=1.0)
        return ev

    disp = kc.DispatchEvaluator(step=stub("step"), kernel=stub("kernel"),
                                serve=stub("serve"), device="cpu")
    for spec in campaign.parse_cells(
            "kernel:rmsnorm:tiny,serve:smollm-135m:poisson_tiny,"
            "smollm-135m:train_4k"):
        disp(spec.workload(), params.default_config())
    assert [k for k, _ in seen] == ["kernel", "serve", "step"]


def test_dispatch_stack_leaves_step_campaigns_unchanged(tmp_path):
    """With a step evaluator attached, the dispatch stack's decisions on
    step cells are the bare evaluator's."""
    cells = campaign.parse_cells("smollm-135m:train_4k,glm4-9b:decode_32k")
    bf = lambda spec: params.default_config(shard_strategy="fsdp_tp",
                                            attn_impl="pallas")
    bare = campaign.Campaign(cells, evaluator=port_surface,
                             baseline_factory=bf,
                             checkpoint_dir=tmp_path / "bare").run()
    disp = campaign.Campaign(cells, evaluator=kc.DispatchEvaluator(
        step=port_surface, slo_ttft=3.0, device="cpu"),
        baseline_factory=bf, checkpoint_dir=tmp_path / "disp").run()
    assert [campaign.tuning_fingerprint(r) for r in bare.values()] \
        == [campaign.tuning_fingerprint(r) for r in disp.values()]


# a step cell of the ssm family (xlstm): every family of the reference
# is ported, so its cells run like any other
XLSTM_STEP = "xlstm-1.3b:train_4k"


def test_step_cells_refused_before_any_trial(tmp_path, monkeypatch):
    """Nothing refuses a step cell of a ported family any more: the cell
    runs a measured trial (the reduced config at a CPU-sized train
    shape), and a campaign mixing it with a kernel cell walks both."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    monkeypatch.setattr(trial, "get_config", get_reduced)
    monkeypatch.setattr(trial, "get_shape",
                        lambda s: ShapeConfig(s, 16, 2, "train"))
    monkeypatch.setattr(kc, "STEP_MIN_SAMPLE_S", 0.0)
    step = campaign.parse_cells(XLSTM_STEP)
    res = kc.DispatchEvaluator(device="cpu", cache_dir=tmp_path / "t")(
        step[0].workload(), params.default_config())
    assert not res.crashed, res.error
    assert 0 < res.cost_s < float("inf")
    stub = lambda wl, rt: trial.TrialResult(cost_s=1.0)
    mixed = campaign.parse_cells(f"kernel:rmsnorm:tiny,{XLSTM_STEP}")
    reports = campaign.Campaign(mixed, evaluator=kc.DispatchEvaluator(
        step=stub, kernel=stub, device="cpu"),
        checkpoint_dir=tmp_path).run()
    assert set(reports) == {"kernel-rmsnorm__tiny__pod",
                            "xlstm-1.3b__train_4k__pod"}
    assert (tmp_path / "history.jsonl").exists()


def test_step_cell_through_intake_refused(tmp_path):
    """A step cell submitted while a kernel campaign runs is handed out
    and walked like the cells the campaign started with."""
    from repro_torch.core import schedule

    def kernel(wl, rt):
        schedule.submit_cells(tmp_path, campaign.parse_cells(XLSTM_STEP))
        return trial.TrialResult(cost_s=1.0)

    camp = campaign.Campaign(
        campaign.parse_cells("kernel:rmsnorm:tiny"),
        evaluator=kc.DispatchEvaluator(
            kernel=kernel, step=lambda wl, rt: trial.TrialResult(cost_s=1.0),
            device="cpu"),
        checkpoint_dir=tmp_path, intake=True)
    camp.run()
    rows = [json.loads(x) for x in
            (tmp_path / "history.jsonl").read_text().splitlines()]
    assert {r["cell"] for r in rows} \
        == {"kernel-rmsnorm__tiny__pod", "xlstm-1.3b__train_4k__pod"}


def _step(arch, shape, mesh=None):
    from repro_torch.configs import get_config, get_shape
    from repro_torch.runtime.stepfn import build_step
    return build_step(get_config(arch), get_shape(shape),
                      params.default_config(), mesh)


@pytest.mark.parametrize("build, slice_", [
    (lambda: _step("smollm-135m", "train_4k", {"data": 16, "model": 16}),
     "slice 9"),
    (lambda: trial.RooflineEvaluator(), "slice 8")])
def test_unported_evaluators_raise_naming_their_slice(build, slice_,
                                                      monkeypatch, tmp_path):
    monkeypatch.setattr(measure, "TIMING_DIR", tmp_path)
    with pytest.raises(NotImplementedError, match=slice_):
        build()
