"""The rank runner (perfbench/lib/ranks.py) through run.main: a cell of 4
chips run here as 4 gloo ranks on the CPU, with the test body of
ranks_body.py (the port's 10-byte-key sort over the mesh, W = 16, a few
thousand records a rank), and the faults a run over ranks can have."""
import ast
import dataclasses
import json
import re
import subprocess
import sys
import time

import pytest
import ranks_body

from perfbench import run
from perfbench.lib import ranks, spec
from perfbench.lib.outcome import Check

CELL = "indy10x4.test"
RECORDS_A_RANK = 4096
BENCH = {
    "configs": [{"name": "indy10", "file": "perfbench/configs/indy10.json"}],
    "workloads": [{"name": CELL, "config": "indy10",
                   "traffic": "resident_key10", "chips": 4}],
    "end_to_end": [
        {"name": "resident_sort_records_per_s", "unit": "records/s"},
        {"name": "setup_s", "unit": "s"}],
    "per_layer": [
        {"name": m, "unit": u, "moves": "resident_sort_records_per_s"}
        for m, u in (("exchange_slot_fill", "%"),
                     ("map_sort_ms_per_sort", "ms"),
                     ("device_idle_share.resident", "%"))],
}


def shrink(timeout_s):
    def adjust(cell):
        traffic = {"driver": "ranks_body", "payload_mode": "through",
                   "warmup_calls": 1, "trace_calls": 2,
                   "collective_timeout_s": timeout_s}
        config = dict(cell.config, workers=16,
                      records=cell.chips * RECORDS_A_RANK)
        return dataclasses.replace(cell, traffic=traffic, config=config)
    return adjust


@pytest.fixture
def mesh_run(monkeypatch, capsys):
    """run.main on the 4-rank cell; returns (exit code, line, stderr,
    notes, seconds)."""
    monkeypatch.setattr(spec, "driver", lambda traffic: ranks_body)

    def go(*, trace=0, wrap=None, timeout_s=60.0, seed=2**33 + 29):
        t = time.monotonic()
        rc, line = run.main(
            ["--workload", CELL, "--seed", str(seed), "--seconds", "0.5",
             "--trace", str(trace)], device="cpu", adjust=shrink(timeout_s),
            wrap=wrap, guard_modules=False, benchmark=BENCH)
        took = time.monotonic() - t
        err = capsys.readouterr().err
        notes = {}
        for ln in err.splitlines():
            if ln.startswith("note "):
                _, key, value = ln.split(" ", 2)
                try:
                    notes[key] = ast.literal_eval(value)
                except (ValueError, SyntaxError):
                    notes[key] = value
        return rc, line, err, notes, took
    return go


def test_four_ranks_run_one_window_and_add_their_checks(mesh_run):
    rc, line, _, notes, _ = mesh_run()
    assert rc == 0 and line["correct"] is True, line
    calls = notes["calls"]
    assert notes["calls_by_rank"] == [calls] * 4 and calls >= 1
    assert line["attempted"] == calls and line["failed"] == 0
    assert notes["records_by_rank"] == [RECORDS_A_RANK] * 4
    rate = line["metrics"]["resident_sort_records_per_s"]["value"]
    assert rate == pytest.approx(calls * 4 * RECORDS_A_RANK
                                 / notes["window_s"], rel=1e-12)
    assert line["metrics"]["setup_s"]["value"] == notes["setup_s"]
    for name, c in line["check"].items():
        assert c["value"] == sum(r[name] for r in notes["checks_by_rank"])
    dev = line["device"]
    assert dev["count"] == 4
    assert len(dev["memory_peak_bytes_by_card"]) == 4
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_by_card"])


def test_a_traced_run_reads_rank_0_and_averages_the_busy_time(mesh_run):
    rc, line, _, notes, _ = mesh_run(trace=1)
    assert rc == 0 and line["correct"] is True, line
    # W = 16, 1,024 records a worker: a mean block of 64, C = 128
    assert line["metrics"]["exchange_slot_fill"] == {"value": 50.0,
                                                     "unit": "%"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert len(notes["busy_share_by_rank"]) == 4
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_one_row_altered_on_rank_3_is_not_correct(mesh_run):
    rc, line, _, notes, _ = mesh_run(wrap=ranks_body.alters_a_row_on_rank3)
    assert rc == 0 and line["correct"] is False
    bad = [r["mismatched_records"] for r in notes["checks_by_rank"]]
    assert bad[:3] == [0, 0, 0] and bad[3] > 0
    assert line["check"]["mismatched_records"]["value"] == bad[3]
    assert line["failed"] == 1


def test_a_rank_that_raises_fails_the_run(mesh_run):
    rc, line, err, _, took = mesh_run(wrap=ranks_body.raises_on_rank1)
    assert rc == 1 and line is None
    assert "rank 1 failed" in err
    assert "planted: rank 1 fails at its second call" in err
    assert took < 60


def test_a_rank_that_never_enters_a_collective_fails_within_the_timeout(
        mesh_run):
    rc, line, err, _, took = mesh_run(wrap=ranks_body.hangs_on_rank2,
                                      timeout_s=8.0)
    assert rc == 1 and line is None
    quiet = re.search(r"still running when stopped: ranks (\[.*\])", err)
    assert 2 in ast.literal_eval(quiet.group(1))
    assert took < 8.0 + 40  # the timeout, the ranks' start and tear-down


def test_a_forbidden_module_on_rank_2_gives_no_result(mesh_run):
    rc, line, err, _, _ = mesh_run(wrap=ranks_body.loads_flax_on_rank2)
    assert rc == 2 and line is None, err[-4000:]
    assert "rank 2: flax" in err


def test_the_control_runs_over_the_ranks_and_is_not_correct(monkeypatch):
    from perfbench import controls

    monkeypatch.setattr(spec, "driver", lambda traffic: ranks_body)
    cell = shrink(60.0)(spec.load_cell(CELL, BENCH))
    out = controls.run_control(cell, 2**31 + 7, device="cpu")
    assert not out.correct
    assert out.checks[0].name == "mismatched_records"
    assert out.checks[0].value > 0 and out.device["count"] == 4


def _report(rank, *, calls=3, peak=0, bad=0):
    return ranks.Report(
        rank=rank, calls=calls, kept_call=1, records=10,
        checks=[Check("mismatched_records", bad, 0), Check("overflow", 0, 0)],
        memory_peak_bytes=peak, reserved_peak_bytes=peak, setup_s=1.0 + rank,
        window_s=2.0)


def _extra():
    import types

    return types.SimpleNamespace(metric="resident_sort_records_per_s",
                                 readings=None, trace=None, host_spans=[],
                                 notes={})


def test_the_fullest_card_sets_the_peak_and_checks_add_by_name():
    out = ranks.combine([_report(0, peak=5), _report(1, peak=9, bad=2),
                         _report(2, peak=7), _report(3, peak=1, bad=1)],
                        _extra())
    assert out.memory_peak_bytes == 9
    assert out.device == {"count": 4,
                          "memory_peak_bytes_by_card": [5, 9, 7, 1]}
    assert [(c.name, c.value, c.limit) for c in out.checks] == [
        ("mismatched_records", 3, 0), ("overflow", 0, 0)]
    assert not out.correct and out.failed == 1 and out.attempted == 3
    assert out.end_to_end == {"resident_sort_records_per_s": 3 * 40 / 2.0,
                              "setup_s": 1.0}


def test_ranks_that_made_different_calls_are_refused():
    with pytest.raises(ranks.RankFailed, match="different calls"):
        ranks.combine([_report(0), _report(1, calls=4)], _extra())


NCCL = """
import dataclasses, json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src",
                sys.argv[1] + "/perfbench/tests"]
import torch
import ranks_body
import test_perfbench_ranks as t
from perfbench.lib import ranks, spec
g = torch.cuda.device_count()
cell = spec.load_cell(t.CELL, t.BENCH)
cell = dataclasses.replace(
    cell, chips=g, config=dict(cell.config, workers=8 * g, records=g << 24),
    traffic={"payload_mode": "through", "warmup_calls": 2, "trace_calls": 2})
for trace in (False, True):
    out = ranks.run(cell, ranks_body.body, seed=2147483659, seconds=2.0,
                    trace=trace, t0=time.perf_counter())
    print(json.dumps({"ranks": g, "trace": trace, "correct": out.correct,
                      "device": out.device, "notes": out.notes,
                      "check": {c.name: c.value for c in out.checks}}),
          flush=True)
"""


@pytest.mark.card
def test_the_body_sorts_over_nccl_on_every_card(card):
    """At 2^24 records a rank on as many ranks as the machine has cards
    (one card: a one-rank NCCL world)."""
    out = subprocess.run([sys.executable, "-c", NCCL, str(spec.ROOT)],
                         cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    for ln in out.stdout.strip().splitlines()[-2:]:
        res = json.loads(ln)
        assert res["correct"] is True, res["check"]
        assert res["device"]["count"] == res["ranks"]
