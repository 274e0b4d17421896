"""What a driver hands back, and the result line made from it."""
from __future__ import annotations

import dataclasses
import json
import sys
import types


@dataclasses.dataclass
class Check:
    """One number compared with the reference, beside its limit; a run
    is correct when every value is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict[str, float]  # metric name -> value
    readings: types.SimpleNamespace  # what the per-layer readers read
    checks: list[Check]
    memory_peak_bytes: int
    trace: object | None = None  # lib/devtrace.DeviceTrace of the traced part
    host_spans: list = dataclasses.field(default_factory=list)
    notes: dict = dataclasses.field(default_factory=dict)  # for stderr
    # entries of the result's "device" that a run over ranks sets itself
    # (lib/ranks.py: count, peaks by card, busy time over the cards)
    device: dict = dataclasses.field(default_factory=dict)
    # modules of the JAX package that other ranks found loaded
    forbidden: list = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def result_line(out: Outcome, metrics: dict, device: dict,
                breakdown: dict | None) -> dict:
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["check"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in out.checks}
    return line


def emit(line: dict, checks: list[Check]) -> None:
    """The checks as the last lines of stderr, the result as the last
    line of stdout."""
    sys.stdout.flush()
    for c in checks:
        print(f"check {c.name} {c.value} limit {c.limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
