"""BENCHMARK.json against the contract's shape, and discovery by name."""
import json
import re

import pytest

from perfbench.lib import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 << 10


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [
        c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_is_found_and_reports_what_it_must(name):
    cell = spec.load_cell(name)
    assert cell.chips in spec.CHIPS
    # a cell of one chip runs in run.py's process, one over ranks per rank
    assert callable(getattr(spec.driver(cell.traffic),
                            "run" if cell.chips == 1 else "body"))
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]))


def test_the_benchmark_keeps_the_rule_on_cards():
    assert spec.chips_problems(BENCH) == []


def _cells(*chips):
    return {"workloads": [{"name": f"c{i}", "chips": c}
                          for i, c in enumerate(chips)]}


@pytest.mark.parametrize("chips,ok", [
    ((4,), True),  # one cell may always take four
    ((1, 4), True),
    ((1, 1, 1, 4), True),
    ((1, 1, 4, 4), False),  # 2 of 4 cells: over a quarter
    ((1,) * 6 + (4, 4), True),  # 2 of 8
    ((1,) * 5 + (4, 4, 4), False),
    ((2,), False), ((3,), False), ((8,), False), ((1, 2), False),
])
def test_cells_ask_for_one_or_four_cards_four_in_at_most_a_quarter(
        chips, ok):
    assert (spec.chips_problems(_cells(*chips)) == []) is ok


def test_every_file_is_named_by_an_entry():
    configs = {c["file"] for c in BENCH["configs"]}
    assert configs == {f"perfbench/configs/{p.name}" for p in
                       (spec.BENCH / "configs").glob("*.json")}
    traffic = {w["traffic"] for w in BENCH["workloads"]}
    assert traffic <= {p.stem for p in (spec.BENCH / "traffic").glob(
        "*.json")}
    metrics = {m["name"] for m in BENCH["per_layer"]}
    assert metrics == {p.name[:-3] for p in (spec.BENCH / "metrics").glob(
        "*.py")}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_each_cut_is_listed_and_explained(config):
    cfg = json.loads((spec.ROOT / config["file"]).read_text())
    assert config["reduced"]
    assert set(config["reduced"]) == set(cfg["reduced"]) == set(cfg["cuts"])
    assert cfg["records"] < cfg["source_records"]
    assert cfg["record_bytes"] == 100 == 4 * (2 + cfg["payload_words"])


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError, match="no workload"):
        spec.load_cell("nope")
