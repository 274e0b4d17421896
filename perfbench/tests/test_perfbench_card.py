"""On the card: a short run of each cell is correct, and the control at
the cell's own size is not. Run there with

    python3 -m pytest -q -m card perfbench/tests/test_perfbench_card.py
"""
import json
import subprocess
import sys

import pytest

from perfbench.lib import spec

CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def needs_cards(workload):
    import torch

    cell = spec.load_cell(workload)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"{workload} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} here")
    return cell


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct(workload, card):
    needs_cards(workload)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", "2147483989", "--seconds", "2", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_at_full_size_is_not_correct(workload, card):
    from perfbench import controls

    out = controls.run_control(needs_cards(workload), 2147483999)
    assert not out.correct
    assert out.checks[0].value > 0
