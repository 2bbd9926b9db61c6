"""The port's tuning CLI, campaign mode, on the CPU: reports and the
campaign summary are written, a re-run resumes from its checkpoints,
telemetry is recorded with ``--trace``, no card means no run unless the
CPU is asked for, and every part not ported yet raises naming its slice."""
import json

import pytest
import torch

from repro_torch.core import measure, telemetry
from repro_torch.launch import tune

CELLS = "serve:smollm-135m:poisson_tiny,kernel:rmsnorm:tiny"
KEYS = ("serve-smollm-135m__poisson_tiny__pod", "kernel-rmsnorm__tiny__pod")


@pytest.fixture
def tmp_results(tmp_path, monkeypatch):
    """Timings and default reports under the test's directory."""
    monkeypatch.setattr(measure, "TIMING_DIR", tmp_path / "timings")
    monkeypatch.setattr(tune, "RESULTS_DIR", tmp_path / "tuning")
    yield tmp_path
    telemetry.uninstall()


def test_campaign_writes_reports_and_summary(tmp_results, capsys):
    ckpt = tmp_results / "camp"
    argv = ["--device", "cpu", "--cells", CELLS, "--fresh",
            "--checkpoint-dir", str(ckpt), "--trace", "--measure-top-k", "2"]
    assert tune.main(argv) == 0
    out = capsys.readouterr().out
    assert "tuning-tree speedup per cell" in out
    for key in KEYS:
        rep = json.loads((ckpt / "reports" / f"{key}.json").read_text())
        assert (ckpt / "reports" / f"{key}.md").exists()
        assert rep["n_trials"] <= 10
        assert not rep["log"][0]["result"]["crashed"]
        assert all(e["result"]["cost_s"] < float("inf")
                   for e in rep["log"] if not e["result"]["crashed"])
        assert rep["measured"]["k"] == 2
    md = (ckpt / "campaign.md").read_text()
    assert "### Telemetry: where the time went" in md
    events = telemetry.read_events(ckpt)
    trials = [e for e in events if e["kind"] == "trial"]
    stats = json.loads((ckpt / "campaign_stats.json").read_text())
    # one span per walk trial and per measured re-rank evaluation
    assert len(trials) == stats["evaluated_trials"] \
        + stats["measured"]["evaluations"]
    assert {t["cell"] for t in trials} == set(KEYS)
    assert not list((tmp_results / "tuning").glob("*"))  # all under ckpt

    # a re-run resumes from the checkpoints: nothing is evaluated again
    telemetry.uninstall()
    assert tune.main(["--device", "cpu", "--cells", CELLS,
                      "--checkpoint-dir", str(ckpt), "--measure-top-k",
                      "2"]) == 0
    assert "0 trials evaluated" in capsys.readouterr().out


def test_trace_out_exports_chrome_trace(tmp_results):
    ckpt = tmp_results / "camp"
    assert tune.main(["--device", "cpu", "--cells", "kernel:rmsnorm:tiny",
                      "--checkpoint-dir", str(ckpt), "--trace"]) == 0
    telemetry.uninstall()
    out = tmp_results / "trace.json"
    assert tune.main(["--checkpoint-dir", str(ckpt),
                      "--trace-out", str(out)]) == 0
    names = {e["name"] for e in json.loads(out.read_text())["traceEvents"]}
    assert "trial kernel-rmsnorm__tiny__pod" in names


def test_default_evaluators_walk_with_one_worker(tmp_results, monkeypatch):
    """The campaign's own evaluators time one trial at a time on their
    device, so it walks with one worker, and keeps its timings where
    ``timing_dir`` says."""
    from repro_torch.core import campaign
    workers, init = [], campaign.Campaign.__init__

    def spy(self, *args, **kw):
        workers.append(kw.get("max_workers"))
        init(self, *args, **kw)

    monkeypatch.setattr(campaign.Campaign, "__init__", spy)
    tune.tune_campaign(campaign.parse_cells("kernel:rmsnorm:tiny"),
                       fresh=True, checkpoint_dir=tmp_results / "camp",
                       device="cpu", timing_dir=tmp_results / "t")
    assert workers == [1]
    assert list((tmp_results / "t").glob("*"))
    assert not (tmp_results / "timings").exists()


def test_no_card_raises_without_device_cpu(tmp_results, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.main(["--cells", "kernel:rmsnorm:tiny", "--checkpoint-dir",
                   str(tmp_results / "camp")])
    assert not (tmp_results / "camp").exists()


def test_single_cell_mode_raises_naming_slice_4(tmp_results):
    """Single-cell mode runs (tests/test_torch_step_cells.py); a cell
    whose model path is not ported raises naming its slice, before any
    trial."""
    with pytest.raises(NotImplementedError, match="slice 5b"):
        tune.main(["--device", "cpu", "--arch", "xlstm-1.3b", "--shape",
                   "train_4k"])
    with pytest.raises(NotImplementedError, match="slice 5b"):
        tune.tune_cell("seamless-m4t-medium", "train_4k", device="cpu")
    assert not (tmp_results / "tuning").exists()


def test_step_cells_raise_naming_slice_4(tmp_results):
    """Step cells run in campaigns (tests/test_torch_step_cells.py); one
    whose model path is not ported raises naming its slice, before any
    trial."""
    ckpt = tmp_results / "camp"
    with pytest.raises(NotImplementedError, match="slice 5b"):
        tune.main(["--device", "cpu", "--cells", "xlstm-1.3b:train_4k",
                   "--checkpoint-dir", str(ckpt)])
    assert not list(ckpt.glob("*.json"))


@pytest.mark.parametrize("flags", [
    ["--all"], ["--workers", "2"], ["--worker"], ["--coordinate"],
    ["--add-cells", "kernel:rmsnorm:tiny"], ["--status"], ["--stop"],
    ["--watch"], ["--evaluator", "x:y"], ["--measured-evaluator", "x:y"],
    ["--dir", "d"], ["--status", "--json"]])
def test_fabric_flags_raise_naming_slice_6(flags):
    with pytest.raises(NotImplementedError, match="slice 6"):
        tune.main(["--device", "cpu", "--cells", "kernel:rmsnorm:tiny"]
                  + flags)


def test_queue_status_raises_naming_slice_6(tmp_path):
    from repro_torch.core import schedule
    with pytest.raises(NotImplementedError, match="slice 6"):
        schedule.queue_status(tmp_path)
