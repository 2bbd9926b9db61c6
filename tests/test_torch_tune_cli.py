"""The port's tuning CLI, campaign mode, on the CPU: reports and the
campaign summary are written, a re-run resumes from its checkpoints,
telemetry is recorded with ``--trace``, and no card means no run unless
the CPU is asked for.  The fleet modes are held in
``tests/test_torch_fabric.py``."""
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


@pytest.fixture
def reduced_steps(tmp_results, monkeypatch):
    """Step cells run the arch's reduced config at a CPU-sized stand-in
    of their shape's kind, one step a sample."""
    from repro_torch.configs import SHAPES, get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import kernel_cell as kc, trial
    monkeypatch.setattr(trial, "get_config", get_reduced)
    monkeypatch.setattr(trial, "get_shape", lambda s: ShapeConfig(
        s, 32, 1 if SHAPES[s].kind == "decode" else 2, SHAPES[s].kind))
    monkeypatch.setattr(kc, "STEP_MIN_SAMPLE_S", 0.0)
    return tmp_results


def test_single_cell_mode_raises_naming_slice_4(reduced_steps):
    """Single-cell mode walks the ssm and encdec families' cells as any
    other's: xlstm-1.3b's own 500k-position decode cell and
    seamless-m4t-medium's decode cell, each on its reduced stand-in."""
    assert tune.main(["--device", "cpu", "--arch", "xlstm-1.3b", "--shape",
                      "long_500k"]) == 0
    rep = tune.tune_cell("seamless-m4t-medium", "decode_32k", device="cpu")
    for key in ("xlstm-1.3b__long_500k__pod",
                "seamless-m4t-medium__decode_32k__pod"):
        saved = json.loads((reduced_steps / "tuning" / f"{key}.json")
                           .read_text())
        assert 1 <= saved["n_trials"] <= 10
        assert not any(e["result"]["crashed"] for e in saved["log"])
    assert rep.n_trials >= 1


def test_step_cells_raise_naming_slice_4(reduced_steps):
    """A campaign walks the ssm and encdec families' step cells as any
    other's."""
    ckpt = reduced_steps / "camp"
    assert tune.main(["--device", "cpu", "--cells",
                      "xlstm-1.3b:decode_32k,seamless-m4t-medium:decode_32k",
                      "--checkpoint-dir", str(ckpt)]) == 0
    for key in ("xlstm-1.3b__decode_32k__pod",
                "seamless-m4t-medium__decode_32k__pod"):
        rep = json.loads((ckpt / "reports" / f"{key}.json").read_text())
        assert 1 <= rep["n_trials"] <= 10
        assert not any(e["result"]["crashed"] for e in rep["log"])
