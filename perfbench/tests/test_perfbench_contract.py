"""``BENCHMARK.json`` and the files it names: every cell's configuration,
mix and cell file exist, every metric has a reader, each configuration's
``reduced`` is its file's, and the names keep to the benchmark's rules."""
import json
import re
from pathlib import Path

import pytest

from perfbench.harness import spec

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_loads_by_name(w):
    cell = spec.load_cell(w["name"])
    assert cell.chips == w["chips"] == 1
    assert cell.params["rate_per_s"] > 0
    assert cell.params["limits"]["served_logit_gap"] > 0
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert NAME.match(m["name"])


def test_configs_state_their_cuts():
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert cfg["published"][key] != cfg[key]
            assert not key.endswith(("_size", "_dim", "_rank", "_heads"))


def test_names_and_bounds_keep_to_the_rules():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert 1 <= BENCH["run_seconds"] <= 51
