"""A cell's whole run through the command, on the card (skips here)."""
import json

import pytest

from portbench import run


@pytest.mark.card
def test_a_cell_runs_on_the_card(card, capsys):
    assert run.main(["--workload", "olmoe-1b-7b.code_backlog", "--seed",
                     "2147483659", "--seconds", "5", "--trace", "0"]) == 0
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert doc["correct"] and doc["device"]["platform"] == "gpu"
    assert set(doc["metrics"]) == {"serve_tok_s", "setup_s"}
