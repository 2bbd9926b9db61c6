"""The harness end to end on the CPU at test size, past its look for a
card: every cell runs and is correct, traced or not; a new mix and a new
metric are picked up as new files; the control and planted faults in the
timed path come out not correct."""
import json
import shutil

import pytest
import torch

from portbench import judge, spec
from portbench.tests import tiny

SERVE = sorted(tiny.CELLS)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_cell_is_correct(root, cell):
    ctx, out = tiny.run(root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in
                                   ctx.bench.end_to_end(cell)}
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_traced_run_reads_its_layers(root, cell):
    ctx, out = tiny.run(root, cell, trace=True)
    assert out["correct"]
    layers = {m["name"] for m in ctx.bench.per_layer(cell)}
    assert set(out["metrics"]) <= layers
    assert bool(out["metrics"]) == bool(layers)
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_traced_run_spans_only_the_kernels_its_metrics_read(root):
    ctx, _ = tiny.run(root, SERVE[0], trace=True)
    read = {getattr(ctx.bench.metric(m["name"]), "KERNEL", None)
            for m in ctx.bench.per_layer(SERVE[0])} - {None}
    assert read == {"flash_attention"}
    assert ctx.tracer.wrapped == {"pb.prefill", "pb.decode",
                                  "pb.k.flash_attention"}


def test_result_line_ends_with_the_checks():
    line = spec.result_line(True, 3, 0, {"m": {"value": 1.0, "unit": "s"}},
                            {"platform": "gpu"},
                            {"gap": {"value": 0.1, "limit": 0.2}},
                            {"device_ops": [], "idle_gaps": []})
    doc = json.loads(line)
    assert list(doc)[-1] == "checks"
    assert list(doc)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]


def test_new_mix_and_metric_are_new_files_only(root, tmp_path):
    new = tmp_path / "checkout"
    shutil.copytree(root, new)
    pb = new / "portbench"
    mix = json.loads((pb / "mixes" / "backlog.json").read_text())
    (pb / "mixes" / "dummy.json").write_text(json.dumps(dict(mix, judge={"waves": 1, "among_first": 2})))
    (pb / "metrics" / "dummy_waves.py").write_text(
        "def read(run):\n    return float(run.fig['waves'])\n")
    (pb / "limits" / "tiny-moe.dummy.json").write_text(
        json.dumps({"limits": tiny.SERVE_LIMITS["tiny-moe"]}))
    doc = json.loads((new / "BENCHMARK.json").read_text())
    doc["workloads"].append({"name": "tiny-moe.dummy", "config": "tiny-moe",
                             "traffic": "dummy", "chips": 1, "why": "t"})
    for m in doc["end_to_end"]:
        if m["name"] == "serve_tok_s":
            m["workloads"].append("tiny-moe.dummy")
    doc["per_layer"].append({"name": "dummy_waves", "unit": "1",
                             "better": "higher", "source": "program_counter",
                             "layer": "scheduler", "moves": "serve_tok_s",
                             "workloads": ["tiny-moe.dummy"]})
    (new / "BENCHMARK.json").write_text(json.dumps(doc))
    _, out = tiny.run(new, "tiny-moe.dummy", trace=True)
    assert out["correct"]
    assert out["metrics"]["dummy_waves"]["value"] >= 1


@pytest.mark.parametrize("cell", SERVE)
def test_serving_control_is_not_correct(root, cell):
    ctx, out = tiny.run(root, cell)
    assert out["correct"], out["checks"]
    low = judge.control_gap(ctx, ctx.judged_rows, int(ctx.mix["pad_to"]))
    assert any(low[k] > c["limit"] for k, c in out["checks"].items()), low


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if torch.is_tensor(tree) else tree


@pytest.mark.parametrize("fault", ["token", "state", "half_batch"])
@pytest.mark.parametrize("cell", SERVE)
def test_serving_fault_is_not_correct(root, monkeypatch, cell, fault):
    from repro_torch.serving.scheduler import BatchScheduler
    prefill, decode = BatchScheduler._prefill, BatchScheduler._decode

    def token(self, params, cache, tok):
        # a token altered where it is produced: another one comes first
        logits, cache = decode(self, params, cache, tok)
        best = logits[:, -1].argmax(-1)
        logits = logits.clone()
        logits[torch.arange(len(best)), -1, (best + 1) % logits.shape[-1]] \
            += 1e4
        return logits, cache

    def state(self, params, cache, tok):
        # a step that returns its state unchanged
        logits, _ = decode(self, params, _clone(cache), tok)
        return logits, cache

    def half_batch(self, params, batch):
        # half of the lanes left out: the other half's results in their
        # place
        logits, cache = prefill(self, params, batch)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:2 * half] = logits[:half]
        return logits, cache

    if fault == "half_batch":
        monkeypatch.setattr(BatchScheduler, "_prefill", half_batch)
    else:
        monkeypatch.setattr(BatchScheduler, "_decode",
                            {"token": token, "state": state}[fault])
    _, out = tiny.run(root, cell)
    assert not out["correct"], out["checks"]
