"""Find a cell and everything it names, by name.

`BENCHMARK.json` at the checkout's root lists the cells. A cell names a
configuration (`perfbench/configs/<config>.json`) and a traffic mix
(`perfbench/traffic/<traffic>.json`); the mix names the driver that
runs it (`perfbench/drivers/<driver>.py`, a module with `run(cell,
...)`). Each per-layer metric is a reader in `perfbench/metrics/<name>.py`
with `read(ctx) -> float | None`. A later cell, mix or metric is a new
file and a new entry: nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
#: The cards a cell may ask for: one, or the four of one host.
CHIPS = (1, 4)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple[dict, ...]  # the end-to-end metrics this cell reports
    per_layer: tuple[dict, ...]  # the per-layer metrics this cell reports


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json (or of `benchmark`), with its
    configuration, traffic mix and metrics."""
    bench = benchmark if benchmark is not None else _json(
        ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(_json(ROOT / configs[w["config"]]["file"]),
                  name=w["config"])
    traffic = dict(_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                   name=w["traffic"])
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, name))
    names = {m["name"] for m in e2e}
    per = tuple(m for m in bench["per_layer"]
                if m["moves"] in names and _reports(m, name))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per)


def chips_problems(bench: dict) -> list[str]:
    """What in `bench` breaks the rule on cards: each cell asks for 1 or
    4, and at most max(1, cells // 4) cells ask for 4."""
    cells = bench["workloads"]
    out = [f"{w['name']} asks for {w['chips']} cards (1 or 4)"
           for w in cells if w["chips"] not in CHIPS]
    four = [w["name"] for w in cells if w["chips"] == 4]
    if len(four) > max(1, len(cells) // 4):
        out.append(f"{len(four)} of {len(cells)} cells ask for 4 cards: "
                   f"at most {max(1, len(cells) // 4)} may")
    return out


def driver(traffic: dict):
    """The driver module that runs this traffic mix."""
    return importlib.import_module(f"perfbench.drivers.{traffic['driver']}")


def metric_reader(name: str):
    """The `read(ctx)` of perfbench/metrics/<name>.py (names may hold
    dots, so the file is loaded by path)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peaks() -> dict:
    return _json(BENCH / "lib" / "peaks.json")
