"""The control of the `resident_skew10` cells: the plain reference put in
the program's place with the configuration's ordering guarantee broken,
run through the cell's whole harness. It has to come out not correct.

The broken guarantee is the key's width: records are sorted by the
leading 4 key bytes alone, ties broken by id, the order a sort that
compares 4 of the 10 key bytes gives. The order is cut into W equal
segments, each full (its own splitters, as a sampling sort has), so
that the output stays the size of the input: `controls_key10`'s cut at
the equal ranges of the key word would give worker 0 nine tenths of
the skewed records and pad every worker to that.

    python3 perfbench/controls_skew10.py --workload NAME --seeds N [N ...]

runs the cell's driver with its entry replaced by the control, on each
seed at the cell's own size (one call in the window), and prints one
JSON line a seed with the numbers compared beside their limits.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench.lib import spec  # noqa: E402
from perfbench.reference import gen  # noqa: E402
from perfbench.reference import sort as ref  # noqa: E402


def resident_sort(keys, ids, payload, *, num_workers: int, **_):
    """In place of distributed_sort_payload(..., key_bytes=10,
    sample_fraction=f): the same outputs (keys, ids, payload rows of W
    segments; valid counts; overflow), the records in (key word, id)
    order, N / W a segment."""
    n, w = keys.shape[0], num_workers
    sk, si = ref.lex_order(keys, ids)
    rows = payload.index_select(0, si)  # ids are rows
    valid = torch.full((w,), n // w, dtype=torch.int32)
    return gen.to_u32(sk), gen.to_u32(si), rows, valid, torch.tensor(False)


def run_control(cell, seed: int, *, device="cuda"):
    """One run of `cell` with its entry replaced by the control; returns
    the Outcome of the cell's traffic kind (`drivers/<kind>.run`)."""
    return spec.driver(cell.traffic).run(
        cell, seed=seed, seconds=0.0, trace=False, t0=time.perf_counter(),
        device=device, wrap=lambda _entry: resident_sort)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        out = run_control(cell, seed)
        print(json.dumps({
            "control": cell.name, "seed": seed, "correct": out.correct,
            "check": {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
