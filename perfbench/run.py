"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout that holds `src/repro_torch`. The cell, its
configuration, traffic mix and metrics are found by name (lib/spec.py).
`--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics, read by `perfbench/metrics/<name>.py` from a run that
adds a profiled part. Either way the output of the timed path is
compared with the plain reference (perfbench/reference/), each number
beside its limit on the last lines of stderr and under "check", last in
the result. The result is the last line of stdout.

A cell whose `chips` is more than 1 runs over that many ranks, one
process a card (lib/ranks.py), through its driver's `body`; a cell of
one chip runs in this process through its driver's `run`.

Exits with 2, printing no result, where there is no card or fewer than
the cell asks for, where the port is not in the checkout, or where a
module of the JAX reference package was loaded on any rank; with 1,
printing no result, where a rank failed (its traceback on stderr).
"""
import time

T0 = time.perf_counter()  # set-up is timed from the start of the process

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import guard, outcome, ranks, spec  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None, *, device="cuda", adjust=None, wrap=None,
         guard_modules=True, benchmark=None):
    """Run the cell; returns (exit code, result line or None). `device`,
    `adjust` (a function of the Cell returning the Cell to run), `wrap`
    (handed to the driver), `guard_modules` (rank 0's look; spawned ranks
    always look) and `benchmark` (a dict in place of BENCHMARK.json) exist
    for the CPU tests, which skip the look for a card and run inside a
    test process that may hold other tests' modules."""
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        return fail("src/repro_torch is not in this checkout"), None
    cell = spec.load_cell(args.workload, benchmark)
    if adjust is not None:
        cell = adjust(cell)
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            return fail("torch.cuda.is_available() is False"), None
        if torch.cuda.device_count() < cell.chips:
            return fail(f"{cell.name} needs {cell.chips} cards, "
                        f"{torch.cuda.device_count()} found"), None
    drv = spec.driver(cell.traffic)
    kw = dict(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              t0=T0, device=device, wrap=wrap)
    if cell.chips == 1:
        out = drv.run(cell, **kw)
    else:
        try:
            out = ranks.run(cell, drv.body, **kw)
        except ranks.RankFailed as e:
            print(f"perfbench: {e}", file=sys.stderr, flush=True)
            return 1, None
    bad = (guard.loaded_forbidden() if guard_modules else []) + out.forbidden
    if bad:
        return fail(f"modules of the JAX reference package loaded: {bad}"), \
            None
    for key, value in out.notes.items():
        print(f"note {key} {value}", file=sys.stderr)
    print(f"note host_cpus {os.cpu_count()} usable "
          f"{len(os.sched_getaffinity(0))}", file=sys.stderr)

    if args.trace:
        metrics, ctx = {}, out.readings
        ctx.peaks = spec.peaks().get(
            torch.cuda.get_device_name() if device == "cuda" else "", {})
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.end_to_end[m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name() if device == "cuda"
           else "cpu",
           "count": cell.chips if device == "cuda" else 0,
           "memory_peak_bytes": out.memory_peak_bytes}
    breakdown = None
    if out.trace is not None:
        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.window_s
        breakdown = {"device_ops": out.trace.top_ops(10),
                     "idle_gaps": out.trace.idle_gaps(out.host_spans, 10)}
    dev.update(out.device)
    line = outcome.result_line(out, metrics, dev, breakdown)
    outcome.emit(line, out.checks)
    return 0, line


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:])[0])
