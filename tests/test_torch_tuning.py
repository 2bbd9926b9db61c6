"""The port's search against the reference's: the Fig.-4 tree, the
Table-2 sensitivity sweep and the random and model strategies, on the
synthetic surfaces, give byte-identical trial logs, tuning fingerprints
and rendered reports in both packages."""
import dataclasses
import json

import numpy as np
import pytest

from _torch_surface import PKGS

CELLS = [("smollm-135m", "train_4k"), ("smollm-135m", "prefill_32k"),
         ("xlstm-1.3b", "decode_32k"), ("glm4-9b", "train_4k")]
KNOB_WEIGHTS = [0.5, 0.7, 0.9, 0.97, 1.0, 1.05, 1.3, 2.0]


def seeded_surface(p, seed):
    """A random weight per non-default knob value, maybe a crash region
    (the reference's tests/test_tuning.py surface)."""
    rng = np.random.RandomState(seed)
    weights = {(k, v): KNOB_WEIGHTS[rng.randint(len(KNOB_WEIGHTS))]
               for k, dom in p.params.DOMAINS.items() for v in dom[1:]}
    crash = {"remat_policy": "full"} if rng.rand() < 0.5 else {}

    def ev(wl, rt):
        if any(getattr(rt, k) == v for k, v in crash.items()):
            return p.trial.TrialResult(cost_s=float("inf"), crashed=True)
        c = 100.0
        for (k, v), w in weights.items():
            if getattr(rt, k) == v:
                c *= w
        return p.trial.TrialResult(cost_s=c)
    return ev


def _surface(p, which):
    return p.surface if which == "fabric" else seeded_surface(p, which)


def _j(obj):
    return json.dumps(obj, sort_keys=True, default=str)


def _both(walk):
    """``walk(package)`` in each package -> (ref, port) reports."""
    return walk(PKGS["ref"]), walk(PKGS["port"])


@pytest.mark.parametrize("threshold", [0.0, 0.05])
@pytest.mark.parametrize("surface", ["fabric", 3, 11])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: ":".join(c))
def test_tree_walk_identical(cell, surface, threshold):
    def walk(p):
        runner = p.trial.TrialRunner(p.trial.Workload(*cell),
                                     _surface(p, surface))
        base = p.params.default_config(shard_strategy="fsdp_tp",
                                       attn_impl="pallas")
        return p.tree.run_tuning(runner, base, threshold=threshold)
    ref, port = _both(walk)
    assert _j(dataclasses.asdict(port)) == _j(dataclasses.asdict(ref))
    assert _j(PKGS["port"].campaign.tuning_fingerprint(port)) \
        == _j(PKGS["ref"].campaign.tuning_fingerprint(ref))
    assert PKGS["port"].report.cell_markdown(port) \
        == PKGS["ref"].report.cell_markdown(ref)


@pytest.mark.parametrize("surface", ["fabric", 5])
@pytest.mark.parametrize("cell", CELLS[:3], ids=lambda c: ":".join(c))
def test_sensitivity_identical(cell, surface):
    def walk(p):
        runner = p.trial.TrialRunner(p.trial.Workload(*cell),
                                     _surface(p, surface))
        return p.sensitivity.run_sensitivity(
            runner, p.params.default_config(shard_strategy="fsdp_tp"))
    ref, port = _both(walk)
    assert _j(dataclasses.asdict(port)) == _j(dataclasses.asdict(ref))
    assert port.table() == ref.table()
    for name in ("cell_markdown", "sensitivity_markdown"):
        arg = port if name == "cell_markdown" else {port.workload: port}
        arg_ref = ref if name == "cell_markdown" else {ref.workload: ref}
        assert getattr(PKGS["port"].report, name)(arg) \
            == getattr(PKGS["ref"].report, name)(arg_ref)


def _seed_history(p, path, cells):
    """A shared history of tree walks over same-kind cells, written by
    ``p`` (the model strategy fits on it)."""
    hist = p.history.TrialHistory(path)
    for arch, shape in cells:
        runner = p.trial.TrialRunner(p.trial.Workload(arch, shape),
                                     p.surface, history=hist.sink("tree"))
        p.tree.run_tuning(runner,
                          p.params.default_config(shard_strategy="tp"))
        runner = p.trial.TrialRunner(p.trial.Workload(arch, shape),
                                     p.surface, history=hist.sink("random"))
        p.strategy.drive(p.strategy.make_cursor(
            "random", runner, p.params.default_config(), options={
                "seed": len(arch)}))
    return hist


@pytest.mark.parametrize("options", [
    ("random", {}), ("random", {"seed": 7, "budget": 6}), ("short", {}),
    ("model", {}), ("model", {"warm": True}),
    ("model", {"warm": True, "top_k": 2, "seed": 3})],
    ids=lambda o: o[0] + "".join(f"-{k}{v}" for k, v in o[1].items()))
def test_strategy_walk_identical(options, tmp_path):
    """Each strategy's walk, and the model strategy both cold (thin
    history: the tree walk) and fitted on a shared history."""
    name, opts = options[0], dict(options[1])
    warm = opts.pop("warm", False)
    cell = ("smollm-135m", "train_4k")
    if name == "model":
        path = tmp_path / "history.jsonl"
        if warm:                  # written once, read by both packages
            _seed_history(PKGS["ref"], path,
                          [("glm4-9b", "train_4k"), ("xlstm-1.3b",
                                                     "train_4k"),
                           ("smollm-135m", "prefill_32k")])
        opts["history"] = str(path)

    def walk(p):
        runner = p.trial.TrialRunner(p.trial.Workload(*cell), p.surface)
        cursor = p.strategy.make_cursor(
            name, runner, p.params.default_config(shard_strategy="fsdp_tp"),
            threshold=0.0 if warm else 0.05, options=opts)
        return p.strategy.drive(cursor)
    ref, port = _both(walk)
    assert _j(dataclasses.asdict(port)) == _j(dataclasses.asdict(ref))
    if name == "model":
        assert (port.proposer is not None) == warm
    assert _j(PKGS["port"].campaign.tuning_fingerprint(port)) \
        == _j(PKGS["ref"].campaign.tuning_fingerprint(ref))
    assert PKGS["port"].report.cell_markdown(port) \
        == PKGS["ref"].report.cell_markdown(ref)


def test_campaign_reports_render_identically(tmp_path):
    """The cross-cell tables over a mixed set of reports: tuned, crashed
    and sensitivity."""
    out = {}
    for name, p in PKGS.items():
        reports = {}
        for cell in CELLS:
            runner = p.trial.TrialRunner(p.trial.Workload(*cell),
                                         seeded_surface(p, 1))
            rep = p.tree.run_tuning(runner, p.params.default_config(
                shard_strategy="fsdp_tp"))
            reports[rep.workload] = rep
        sens = p.sensitivity.run_sensitivity(
            p.trial.TrialRunner(p.trial.Workload(*CELLS[0]), p.surface),
            p.params.default_config())
        out[name] = (p.report.campaign_markdown(reports),
                     p.report.strategy_markdown(reports),
                     p.report.strategy_markdown({sens.workload: sens}))
    assert out["port"] == out["ref"]
