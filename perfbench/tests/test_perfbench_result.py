"""The result line's schema and the check lines on stderr."""
import json

import pytest


@pytest.mark.parametrize("workload,trace", [("indy.resident", 0),
                                            ("indy.resident", 1)])
def test_last_lines(workload, trace, small_run, capsys):
    line = small_run(workload, trace=trace)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert last == json.loads(json.dumps(line))
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "check"
    assert last["correct"] is True and last["failed"] == 0
    for v in last["metrics"].values():
        assert set(v) == {"value", "unit"}
    dev = last["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert "setup_s" in last["metrics"]
    tail = err.strip().splitlines()[-len(last["check"]):]
    assert [t.split()[1] for t in tail] == list(last["check"])
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def _run(cwd):
    import subprocess
    import sys

    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "indy.resident",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    import torch

    from perfbench.lib.spec import ROOT

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "cuda" in out.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    import shutil

    from perfbench.lib.spec import ROOT

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr
