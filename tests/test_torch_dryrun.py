"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's: every cell of smollm-135m (cut to 2 layers, to keep the
fake-group runs short) on both production meshes, in one subprocess
with jax and the reference blocked: the statuses that the reference's
skip rule gives, and the reference's record keys."""
from __future__ import annotations

import pytest

import repro.configs as ref_configs
from _torch_fake_group import run_jobs
from repro_torch.configs import SHAPES

# the keys of the reference's records (src/repro/launch/dryrun.py)
OK_KEYS = {"arch", "shape", "mesh", "kind", "tunable", "memory_analysis",
           "roofline_raw", "roofline", "model_flops", "useful_flops_ratio",
           "fits_hbm", "sharding_notes", "status", "compile_s"}
SKIP_KEYS = {"arch", "shape", "mesh", "kind", "status", "reason"}


@pytest.fixture(scope="module")
def runs():
    jobs = run_jobs("dryrun", "refuses_a_real_group")
    return dict(jobs["dryrun"], refused=jobs["refuses_a_real_group"])


@pytest.mark.parametrize("shape", list(SHAPES))
def test_run_cell_statuses_and_records_are_the_references(shape, runs):
    cfg = ref_configs.get_config("smollm-135m")
    ok, reason = ref_configs.shape_applicable(cfg,
                                              ref_configs.get_shape(shape))
    recs = [r for r in runs["cells"] if r["shape"] == shape]
    assert [r["mesh"] for r in recs] == ["pod_16x16", "multipod_2x16x16"]
    for rec in recs:
        if not ok:
            assert rec["status"] == "skip" and rec["reason"] == reason
            assert set(rec) == SKIP_KEYS
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        assert set(rec) == OK_KEYS
        assert set(rec["memory_analysis"]) == {"argument_bytes",
                                               "peak_bytes"}
        raw, rl = rec["roofline_raw"], rec["roofline"]
        for r in (raw, rl):
            assert r["total_s"] == max(r["compute_s"], r["memory_s"],
                                       r["collective_s"]) > 0
        # eager execution runs every layer: the full-depth count is what
        # the calibration extrapolates to
        assert rl["flops_per_chip"] == pytest.approx(raw["flops_per_chip"],
                                                     rel=1e-2)
        assert rl["collective_bytes"] == pytest.approx(
            raw["collective_bytes"], rel=1e-2)
        chips = 512 if rec["mesh"].startswith("multipod") else 256
        assert rec["useful_flops_ratio"] == pytest.approx(
            rec["model_flops"] / chips / rl["flops_per_chip"])
        assert rec["fits_hbm"] == (rec["memory_analysis"]["peak_bytes"]
                                   <= 80e9)
        assert rec["tunable"]["shard_strategy"] == "fsdp_tp"


def test_cli_exits_zero_and_writes_its_records(runs):
    assert runs["cli_rc"] == 0
    assert runs["cli_files"] == [
        "smollm-135m__long_500k__multipod_2x16x16.json",
        "smollm-135m__long_500k__pod_16x16.json"]


def test_a_real_group_refuses_a_fake_mesh(runs):
    assert "needs the fake process group" in runs["refused"]
    assert "gloo" in runs["refused"]
