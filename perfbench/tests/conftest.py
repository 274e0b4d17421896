"""Shared pieces of the benchmark's CPU tests.

The cells run here at tiny sizes on the CPU (the port's plain versions
stand in for its kernels): `shrink(cell)` returns the cell with small
traffic and objects. Tests that need a card carry the `card` marker and
take the `card` fixture, which skips where there is none.
"""
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {
    "resident": ({"warmup_calls": 1, "trace_calls": 2},
                 {"records": 1 << 12}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


def shrink(cell):
    traffic, config = SMALL[cell.traffic["driver"]]
    return dataclasses.replace(cell, traffic=dict(cell.traffic, **traffic),
                               config=dict(cell.config, **config))


def run_small(workload, *, seed=3000000019, trace=0, wrap=None):
    """One tiny CPU run through run.main; returns the result line."""
    from perfbench import run

    # Other test files of this process may have loaded the JAX package;
    # test_perfbench_guard runs the module guard in a fresh process.
    rc, line = run.main(["--workload", workload, "--seed", str(seed),
                         "--seconds", "0.2", "--trace", str(trace)],
                        device="cpu", adjust=shrink, wrap=wrap,
                        guard_modules=False)
    assert rc == 0
    return line


@pytest.fixture
def small_run():
    """run_small, for the tests."""
    return run_small


@pytest.fixture
def small_cell():
    """A function of a workload's name: its cell, shrunk."""
    from perfbench.lib import spec

    return lambda name: shrink(spec.load_cell(name))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
