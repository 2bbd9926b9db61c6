"""The port's fault-tolerance layer: the cases of tests/test_ft.py that
need no mesh, pointed at the port (straggler detection, the preemption
flag, end-to-end restart equivalence through the port's
``launch/train.py --device cpu --reduced``), plus train.py's exit code
42 after a preemption and its refusals."""
import pathlib
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.ft import preemption
from repro_torch.ft.preemption import PreemptionHandler, RESTART_EXIT_CODE
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.launch import train

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARGS = ["--arch", "smollm-135m", "--reduced", "--batch", "4", "--seq", "32",
        "--ckpt-interval", "1", "--log-interval", "1", "--device", "cpu"]


def test_straggler_flags_slow_host():
    hits = []
    det = StragglerDetector(factor=2.0, window=8, min_samples=4,
                            action=lambda h, m, f: hits.append(h))
    for step in range(8):
        for h in ("h0", "h1", "h2", "h3"):
            det.heartbeat(h, step, 1.0 if h != "h2" else 5.0)
    flagged = det.check()
    assert flagged == ["h2"] and hits == ["h2"]


def test_straggler_no_false_positive_on_noise():
    det = StragglerDetector(factor=2.0, window=16, min_samples=4)
    rng = np.random.RandomState(0)
    for step in range(16):
        for h in ("h0", "h1", "h2"):
            det.heartbeat(h, step, 1.0 + rng.rand() * 0.3)
    assert det.check() == []


def test_preemption_handler_flag():
    pre = PreemptionHandler(signals=(signal.SIGUSR1,)).install()
    try:
        assert not pre.requested()
        signal.raise_signal(signal.SIGUSR1)
        assert pre.requested()
    finally:
        pre.uninstall()


def _last_loss(out: str) -> str:
    losses = [line for line in out.splitlines() if "loss" in line]
    return losses[-1].split("loss")[1].split()[0]


def test_preempt_restart_equivalence(tmp_path):
    """Train 8 steps straight vs 4 steps -> 'preempt' -> resume 4 more:
    identical final loss (exact data pipeline restart)."""
    def run(steps, ckdir):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--steps",
             str(steps), "--ckpt-dir", str(ckdir)] + ARGS,
            capture_output=True, text=True, timeout=600,
            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                 "HOME": str(tmp_path)},
            cwd=str(ROOT))
        assert out.returncode == 0, out.stderr[-2000:]
        return out.stdout

    straight = run(8, tmp_path / "a")
    first = run(4, tmp_path / "b")
    resumed = run(8, tmp_path / "b")
    assert "resuming from step 3" in resumed
    assert "resuming" not in first
    assert _last_loss(straight) == _last_loss(resumed)


def test_preemption_exits_42_after_checkpoint_and_resumes(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """A preemption request at step 2 commits a checkpoint of step 2 and
    exits with RESTART_EXIT_CODE; the relaunch resumes at step 3 and ends
    where an uninterrupted run ends."""
    assert train.main(["--steps", "6", "--ckpt-dir", str(tmp_path / "a")]
                      + ARGS) == 0
    straight = _last_loss(capsys.readouterr().out)

    calls = {"n": 0}

    def requested(self):
        calls["n"] += 1
        return calls["n"] == 3               # after step 2
    monkeypatch.setattr(preemption.PreemptionHandler, "requested",
                        requested)
    ck = tmp_path / "b"
    assert train.main(["--steps", "6", "--ckpt-dir", str(ck)] + ARGS
                      + ["--ckpt-interval", "0"]) == RESTART_EXIT_CODE
    assert "preemption requested" in capsys.readouterr().out
    assert sorted(p.name for p in ck.iterdir()) == ["step_00000002"]
    monkeypatch.undo()
    assert train.main(["--steps", "6", "--ckpt-dir", str(ck)] + ARGS) == 0
    out = capsys.readouterr().out
    assert "resuming from step 2" in out
    assert _last_loss(out) == straight


def test_production_mesh_raises_naming_multi_device(tmp_path):
    """--production-mesh builds the 16x16 mesh: a launch without its 256
    ranks is refused, saying so, before anything starts."""
    with pytest.raises(SystemExit, match="256 ranks"):
        train.main(["--production-mesh", "--ckpt-dir", str(tmp_path)]
                   + ARGS)
    assert not (tmp_path / "step_00000000").exists()


def test_no_card_raises_without_device_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--ckpt-dir", str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()
