"""A checkout's benchmark at test size: the repository's configuration
and mix cut to a few layers and short prompts, under a root of its own
(``BENCHMARK.json`` and ``portbench/`` with configs, mixes, limits and the
repository's metric readers)."""
from __future__ import annotations

import json
import pathlib
import shutil
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
CELLS = {"tiny-moe.backlog": ("tiny-moe", "backlog")}
# set between the program's and the control's readings at this size, on
# eight seeds and four (whole waves judged): the mean logit error
# 0.008-0.063 against 0.173-0.308 (a routing flip of the small MoE,
# 8 experts and top 2, reads up to 0.70 at one position)
SERVE_LIMITS = {"tiny-moe": {"logit_err_mean": 0.12}}


def _read(rel):
    return json.loads((REPO / rel).read_text())


def make(root) -> pathlib.Path:
    root = pathlib.Path(root)
    pb = root / "portbench"
    for d in ("configs", "mixes", "limits"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "portbench" / "metrics", pb / "metrics",
                    dirs_exist_ok=True)
    o = _read("portbench/configs/olmoe-1b-7b.json")
    o["arch"].update(name="tiny-moe", n_layers=2, d_model=128, n_heads=4,
                     n_kv_heads=4, head_dim=32, d_ff=64, vocab=512,
                     n_experts=8, top_k=2)
    (pb / "configs" / "tiny-moe.json").write_text(json.dumps(o))
    small = {"prompt": [20, 40], "output": [2, 5], "block": 4, "wave": 4,
             "pad_to": 40, "n_requests": 64,
             "judge": {"waves": 3, "among_first": 8}}
    backlog = dict(_read("portbench/mixes/code_backlog.json"), **small)
    (pb / "mixes" / "backlog.json").write_text(json.dumps(backlog))
    for cell, (config, _) in CELLS.items():
        (pb / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": SERVE_LIMITS[config]}))
    real = _read("BENCHMARK.json")
    rename = {w["name"]: sorted(CELLS) for w in real["workloads"]}

    def cells_of(m):
        m = dict(m)
        if "workloads" in m:
            m["workloads"] = sorted({c for w in m["workloads"]
                                     for c in rename[w]})
        return m
    doc = dict(real, configs=[
        {"name": "tiny-moe", "source": "test",
         "file": "portbench/configs/tiny-moe.json", "reduced": [],
         "why": "test size"}],
        workloads=[{"name": c, "config": cf, "traffic": t, "chips": 1,
                    "why": "test size"} for c, (cf, t) in CELLS.items()],
        end_to_end=[cells_of(m) for m in real["end_to_end"]],
        per_layer=[cells_of(m) for m in real["per_layer"]])
    (root / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))
    return root


def run(root, cell, seed=2 ** 31 + 12345, seconds=60.0, trace=False):
    """One run of a cell on the CPU, through the harness's ``execute``.
    The window ends when the test mix's backlog drains, so every judged
    wave is served however slow the host."""
    from portbench import run as harness, spec
    bench = spec.Bench(root)
    ctx = harness.context(bench, cell, seed, seconds, trace, "cpu")
    ctx.t_start = time.time()
    return ctx, harness.execute(ctx)
