"""The analytic evaluator: the step counter per rank on meshes that no
process holds, and ``RooflineEvaluator``.

The fake process group lives only in subprocesses (``_torch_fake_jobs``,
jax and the reference blocked there); the reference's collectives come
from its own subprocess on 8 host devices.  Both start together, once
for this file.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest

import repro.core.trial as ref_trial
from _torch_fake_group import ROOT, run_jobs
from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import costmodel, params, trial

STRATEGIES = ("dp", "tp", "fsdp", "fsdp_tp")

REF_COLLECTIVES = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json
from repro.configs import get_reduced
from repro.configs.base import ShapeConfig
from repro.core import costmodel
from repro.core.params import default_config
from repro.launch.mesh import make_mesh
from repro.runtime.stepfn import build_step
mesh = make_mesh((4, 2), ("data", "model"))
out = {}
for strategy in ("dp", "tp", "fsdp", "fsdp_tp"):
    rt = default_config(shard_strategy=strategy, unroll_layers=True)
    bundle = build_step(get_reduced("smollm-135m"),
                        ShapeConfig("t", 64, 8, "train"), rt, mesh)
    with mesh:
        compiled = bundle.lower().compile()
    st = costmodel.parse_collectives(compiled.as_text())
    out[strategy] = {"summary": st.summary(), "total": st.total_bytes()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs():
    """The port's fake-group jobs and the reference's collectives, run
    side by side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"))
    ref = subprocess.Popen([sys.executable, "-c", REF_COLLECTIVES],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env, cwd=ROOT)
    try:
        port = run_jobs("per_rank", "extrapolation", "collectives",
                        "evaluator", "xlstm_wide_model_axis")
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-3000:]
    port["reference_collectives"] = json.loads(out.strip().splitlines()[-1])
    return port


def test_flops_are_counted_per_rank(runs):
    """The reference's own check (x @ x, x split on its rows over 4
    devices, ``test_cost_analysis_is_per_partition``) within its band,
    and a Shard x Shard product on (16, 16) at 1/256 of its FLOPs with
    no collective: each rank's local product, never DTensor's global
    op."""
    r = runs["per_rank"]
    assert 0.2 <= r["four_ratio"] <= 0.35, r["four_ratio"]
    assert r["four_collectives"] == ["all-gather"]   # x's rows, for @ x
    assert r["shard_ratio"] == 1 / 256
    assert r["shard_collectives"] == 0
    # arguments made as local blocks: the peak is the blocks and the
    # local product, never a whole operand
    block = 4 * (4096 * 2048 + 2048 * 8192) // 16
    assert r["shard_args"] == block
    assert r["shard_peak"] == block + 4 * (4096 // 16) * (8192 // 16)


@pytest.mark.parametrize("term", ["flops", "coll"])
def test_extrapolation_matches_the_direct_count(term, runs):
    """Counts at 1 and 3 layers extrapolated to 6 equal the direct
    6-layer count within the reference's 1e-2."""
    e = runs["extrapolation"]
    v1, v3, v6 = (e[str(n)][term] for n in (1, 3, 6))
    assert costmodel.extrapolate(v1, v3, 6) == pytest.approx(v6, rel=1e-2)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_collective_bytes_against_the_reference(strategy, runs):
    """Per rank, the reduced smollm train step on (4, 2) against the
    reference's partitioned HLO on 8 host devices (ratios in PERF.md).
    dp: the gradient all-reduce's bytes within 10%; fsdp: the total
    within 0.5–2x; tp and fsdp_tp: the total within 0.5–1.3x, the
    weight gathered over the fsdp axes and never the batch (every
    family: ``test_torch_collectives``)."""
    got = runs["collectives"][strategy]
    want = runs["reference_collectives"][strategy]
    ratio = got["total"] / want["total"]
    if strategy == "dp":
        ar = got["summary"]["all-reduce"]["bytes"]
        assert ar == pytest.approx(
            want["summary"]["all-reduce"]["bytes"], rel=0.1)
        assert set(got["summary"]) == {"all-reduce"}
        assert got["groups"] == [4]                  # the data axis
    elif strategy == "fsdp":
        assert 0.5 <= ratio <= 2.0, ratio
    else:
        assert 0.5 <= ratio <= 1.3, ratio


def test_default_factory_counts_the_production_mesh(runs):
    """The default mesh factory is the production mesh over the fake
    group: two counts (the reference compiles four: its scanned builds
    for the peak are the port's one eager program), then the same trial
    from the cache, and a config that differs in an analytic knob only
    shares the counts."""
    ev = runs["evaluator"]
    first, again, tiles = ev["first"], ev["again"], ev["tiles"]
    assert (first["compiles"], first["cached"]) == (2, False)
    assert (again["compiles"], again["cached"]) == (0, True)
    assert (tiles["compiles"], tiles["cached"]) == (0, True)
    assert again["cost_s"] == first["cost_s"]
    rl = first["roofline"]
    assert first["cost_s"] == rl["total_s"] == max(
        rl["compute_s"], rl["memory_s"], rl["collective_s"])
    assert first["peak_bytes"] == rl["peak_mem_bytes"]
    # 32 sequences of 32k tokens at 256 ranks: eager attention's
    # (S, S) scores do not fit a card
    assert first["crashed"] and not first["fits_hbm"]
    assert first["failure"] == trial.FAILURE_DETERMINISTIC


def test_xlstm_trains_on_a_model_axis_wider_than_its_heads(runs):
    """xlstm-1.3b's 4 heads on the production mesh's 16-wide model axis
    (here the reduced config's 4 on 8): the train step counts, where
    DTensor could not unflatten the mLSTM output's gradient."""
    r = runs["xlstm_wide_model_axis"]
    assert r["heads"] == 4 and r["flops"] > 0


# ------------------------------------------- one card, in this process
@pytest.fixture
def one_card(monkeypatch, tmp_path):
    """A RooflineEvaluator of one card on the reduced configs (the
    workload's config and shape patched, as the step-cell tests do),
    its counts cached under ``tmp_path``."""
    monkeypatch.setattr(trial, "get_config", get_reduced)
    monkeypatch.setattr(trial, "get_shape",
                        lambda s: ShapeConfig(s, 64, 2, s.split("_")[0]))
    return trial.RooflineEvaluator(
        mesh_factory=lambda multi_pod=False: None,
        compile_cache=trial.CompileCache(directory=tmp_path))


@pytest.mark.parametrize("arch, shape", [("smollm-135m", "train_x"),
                                         ("olmoe-1b-7b", "prefill_x"),
                                         ("xlstm-1.3b", "decode_x")])
def test_one_card_counts_twice_then_reads_its_cache(one_card, arch, shape):
    wl = trial.Workload(arch, shape)
    rt = params.default_config()
    first = one_card(wl, rt)
    assert (first.compiles, first.cached, first.crashed) == (2, False, False)
    again = one_card(wl, rt)
    assert (again.compiles, again.cached) == (0, True)
    assert again.as_dict() == dataclasses.replace(
        first, compiles=0, cached=True, compile_s=0.0).as_dict()
    # another compile knob is another program: bf16 is counted anew and
    # its products priced at the bf16 peak
    bf16 = one_card(wl, rt.replace(compute_dtype="bfloat16"))
    assert bf16.compiles == 2
    assert bf16.roofline["compute_s"] < first.roofline["compute_s"]
    assert first.roofline["collective_s"] == 0.0      # one card
    assert first.roofline["memory_s"] == costmodel.analytic_memory_bytes(
        get_reduced(arch), trial.get_shape(shape), rt, 1, 1) \
        / costmodel.HW["hbm_bw"]


def test_kernel_path_prices_the_flash_kernels_products(one_card):
    """``attn_impl="pallas"`` reuses the eager path's counts (the
    calibration counts run eager attention) and swaps the causal
    square's products for the kernel's half, at the kernel's rate: f32
    products as three TF32 ones (``flops_tf32x3``); its memory term is
    ``port_memory_bytes``, which no tile knob moves."""
    wl = trial.Workload("smollm-135m", "prefill_x")
    for dtype, k_rate in (("float32", "flops_tf32x3"),
                          ("bfloat16", "flops_bf16")):
        rt = params.default_config(compute_dtype=dtype)
        eager_path = one_card(wl, rt)
        kernel_path = one_card(wl, rt.replace(attn_impl="pallas"))
        assert (kernel_path.compiles, kernel_path.cached) == (0, True)
        eager, kernel = costmodel.flash_kernel_flops(
            get_reduced("smollm-135m"), trial.get_shape("prefill_x"),
            rt.replace(attn_impl="pallas"), 1, 1)
        rate = costmodel.HW["flops_bf16" if dtype == "bfloat16"
                            else "flops_f32"]
        e, k = eager_path.roofline, kernel_path.roofline
        assert k["flops_per_chip"] == pytest.approx(
            e["flops_per_chip"] - eager + kernel, rel=1e-12)
        assert k["compute_s"] == pytest.approx(
            e["compute_s"] - eager / rate + kernel / costmodel.HW[k_rate],
            rel=1e-12)
        assert 0 < k["compute_s"] < e["compute_s"]
        assert k["memory_s"] == costmodel.port_memory_bytes(
            get_reduced("smollm-135m"), trial.get_shape("prefill_x"),
            rt.replace(attn_impl="pallas"), 1, 1) / costmodel.HW["hbm_bw"]
        for bq in (64, 256):
            other = one_card(wl, rt.replace(attn_impl="pallas",
                                            attn_block_q=bq))
            assert other.roofline == kernel_path.roofline
    # a train step runs the eager attention whatever the config says (the
    # kernels are forward-only): it is priced so, peak and all
    train = trial.Workload("smollm-135m", "train_x")
    rt = params.default_config()
    assert one_card(train, rt.replace(attn_impl="pallas")).roofline == \
        one_card(train, rt).roofline


def test_kernel_path_peak_holds_the_parameters(monkeypatch, tmp_path):
    """The kernel path's peak is the eager path's counted peak without
    its (S, S) scores, probabilities and mask, never less than the
    parameters: smollm-135m at full width, one 4,096-token prompt, where
    the reference's fixed correction (six squares of two layers) is
    more than the whole eager peak."""
    from repro_torch.configs import get_config
    shape = ShapeConfig("prefill_x", 4096, 1, "prefill")
    monkeypatch.setattr(trial, "get_shape", lambda s: shape)
    ev = trial.RooflineEvaluator(
        mesh_factory=lambda multi_pod=False: None,
        compile_cache=trial.CompileCache(directory=tmp_path))
    cfg = get_config("smollm-135m")
    wl = trial.Workload("smollm-135m", "prefill_x")
    rt = params.default_config()
    eager = ev(wl, rt)
    kernel = ev(wl, rt.replace(attn_impl="pallas"))
    params_bytes = cfg.param_count() * 4            # f32 parameters
    square = cfg.n_heads * 4096 ** 2 * 4            # one (B,H,S,S) f32
    assert costmodel.flash_peak_correction_bytes(
        cfg, shape, rt.replace(attn_impl="pallas"), 1, 1) > eager.peak_bytes
    assert params_bytes < kernel.peak_bytes < eager.peak_bytes - 2 * square


def test_over_the_hbm_limit_is_a_deterministic_crash(one_card):
    one_card.hbm_limit = 1.0
    res = one_card(trial.Workload("smollm-135m", "prefill_x"),
                   params.default_config())
    assert res.crashed and not res.fits_hbm and not res.retryable
    assert res.failure == trial.FAILURE_DETERMINISTIC
    assert res.cost_s == res.roofline["total_s"] > 0
    assert res.peak_bytes > 1.0 and res.error == ""


def test_trial_results_are_the_references():
    """The fields of a trial's result and of its roofline are the
    reference's, in the reference's order."""
    assert [f.name for f in dataclasses.fields(trial.TrialResult)] == \
        [f.name for f in dataclasses.fields(ref_trial.TrialResult)]
    import repro.core.costmodel as ref_cm
    kw = dict(compute_s=1.0, memory_s=2.0, collective_s=0.5,
              flops_per_chip=1.0, bytes_per_chip=2.0, collective_bytes=0.0,
              coll_summary={}, peak_mem_bytes=3.0)
    assert list(costmodel.Roofline(**kw).as_dict()) == \
        list(ref_cm.Roofline(**kw).as_dict())
