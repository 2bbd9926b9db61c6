"""BENCHMARK.json and the files it names keep the benchmark's rules."""
import json
import pathlib

import pytest

from portbench import spec

REPO = pathlib.Path(__file__).resolve().parents[2]
DOC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in DOC["workloads"]]


def test_no_problems():
    assert spec.problems(DOC) == []


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_and_units(key):
    for e in DOC[key]:
        assert spec.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert spec.UNIT.match(e["unit"]), e["unit"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k]


def test_top_level_keys():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= DOC["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w
               for w in DOC["command"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_exist(cell):
    bench = spec.Bench(REPO)
    w = bench.cell(cell)
    assert bench.config(w["config"])["arch"]
    assert (REPO / "portbench" / f"{bench.mix(w['traffic'])['kind']}.py").exists()
    assert bench.limits(cell)
    for m in bench.per_layer(cell):
        assert (REPO / "portbench" / "metrics" / f"{m['name']}.py").exists()
    assert len(bench.end_to_end(cell)) >= 2
    assert bench.per_layer(cell)


@pytest.mark.parametrize("metric", [m["name"] for m in DOC["per_layer"]])
def test_per_layer_cells_report_what_it_moves(metric):
    m = next(x for x in DOC["per_layer"] if x["name"] == metric)
    moved = next(x for x in DOC["end_to_end"] if x["name"] == m["moves"])
    for cell in m["workloads"]:
        assert cell in moved.get("workloads", [cell])


def test_problems_catches_a_broken_file():
    bad = json.loads(json.dumps(DOC))
    bad["per_layer"][0]["workloads"] = [CELLS[0]] * 2 + ["no-such-cell"]
    bad["end_to_end"][0]["unit"] = "tokens per second"
    bad["workloads"][0]["name"] = "a cell"
    assert len(spec.problems(bad)) >= 3


# a published key and the port's ``ArchConfig`` field that runs it
WIDTHS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
          "num_attention_heads": "n_heads", "num_key_value_heads":
          "n_kv_heads", "num_experts": "n_experts", "num_experts_per_tok":
          "top_k", "vocab_size": "vocab"}


@pytest.mark.parametrize("entry", DOC["configs"], ids=lambda c: c["name"])
def test_config_runs_at_its_published_widths(entry):
    doc = json.loads((REPO / entry["file"]).read_text())
    arch = doc["arch"]
    assert doc["reduced"] == entry["reduced"]
    assert not set(entry["reduced"]) & set(WIDTHS)
    for key, field in WIDTHS.items():
        if key in doc:
            assert arch[field] == doc[key], key
    assert arch["head_dim"] * arch["n_heads"] == doc["hidden_size"]
    if "num_hidden_layers" not in entry["reduced"]:
        assert arch["n_layers"] == doc["num_hidden_layers"]
