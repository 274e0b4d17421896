"""The controls: the plain reference put in the program's place, with
one guarantee of the configuration broken, run through a cell's whole
harness. Each has to come out not correct.

The broken guarantee is the ordering: records are sorted by the top
`KEY_BITS` bits of their 4-byte key (ties by id), the step below the
configuration's 32-bit key, as a sort at a lower key precision would.
Everything else (partitioning by the configuration's boundaries, the
payload that follows each record, the output format) is kept.

    python3 perfbench/controls.py --workload NAME --seeds N [N ...]

runs the cell's driver with its entry replaced by the control, on each
seed at the cell's own size (one call in the window), and prints
one JSON line a seed with the numbers compared beside their limits.
Each driver names its cells' control, `CONTROL` (module.function): this
module's `resident_sort` for the `resident` driver, `controls_key10`'s
and `controls_skew10`'s for theirs. A cell over ranks runs its control
through lib/ranks.py, on every rank in the program's place.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench.lib import ranks, spec  # noqa: E402
from perfbench.reference import gen  # noqa: E402
from perfbench.reference import sort as ref  # noqa: E402

KEY_BITS = 16


def _split(keys, ids, bounds: np.ndarray, parts: int):
    """The control's order of (keys, ids) and, per range of `bounds`,
    the positions of its records in that order: (sk, si, [idx...])."""
    sk, si = ref.lex_order(keys, ids, key_bits=KEY_BITS)
    b = torch.as_tensor(bounds, dtype=torch.int64, device=sk.device)
    part = torch.searchsorted(b, sk, right=True)
    order = torch.sort(part, stable=True).indices
    counts = torch.bincount(part, minlength=parts).tolist()
    cuts = np.cumsum([0] + counts)
    return sk, si, [order[cuts[j]:cuts[j + 1]] for j in range(parts)]


def resident_sort(keys, ids, payload, *, num_workers: int, **_):
    """In place of core/exoshuffle.distributed_sort_payload: the same
    outputs (keys, ids, payload rows a worker, padded to one length;
    valid counts; overflow)."""
    w = num_workers
    sk, si, idx = _split(keys, ids, ref.equal_bounds(w), w)
    width = max(max(len(i) for i in idx), 1)
    dev = keys.device
    mk = torch.full((w, width), -1, dtype=torch.int32, device=dev)
    mv = torch.full((w, width), -1, dtype=torch.int32, device=dev)
    pout = torch.zeros((w, width, payload.shape[-1]), dtype=torch.int32,
                       device=dev)
    for d, i in enumerate(idx):
        m = len(i)
        mk[d, :m] = gen.to_u32(sk[i])
        mv[d, :m] = gen.to_u32(si[i])
        pout[d, :m] = payload.index_select(0, si[i])  # ids are row numbers
    valid = torch.tensor([len(i) for i in idx], dtype=torch.int32)
    return (mk.reshape(-1), mv.reshape(-1), pout.reshape(-1, pout.shape[-1]),
            valid, torch.tensor(False))


def _in_place_of(control, _entry):
    return control


def run_control(cell, seed: int, *, device="cuda"):
    """One run of `cell` with its entry replaced by the control that its
    driver names; returns the run's Outcome."""
    drv = spec.driver(cell.traffic)
    module, _, name = drv.CONTROL.rpartition(".")
    control = getattr(importlib.import_module(module), name)
    kw = dict(seed=seed, seconds=0.0, trace=False, t0=time.perf_counter(),
              device=device, wrap=functools.partial(_in_place_of, control))
    if cell.chips == 1:
        return drv.run(cell, **kw)
    return ranks.run(cell, drv.body, **kw)


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
