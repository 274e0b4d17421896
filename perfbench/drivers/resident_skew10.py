"""Traffic kind `resident_skew10`: the `resident` protocol on CloudSort's
Daytona input, records with the whole 10-byte key under the skew of
reference/skew10.py.

Set-up makes the configuration's `records` on the card from the seed
and calls `core/exoshuffle.distributed_sort_payload(..., key_bytes=10,
sample_fraction=f)`, f the configuration's `sample_fraction`, with its
other defaults, `warmup_calls` times. The window then calls it back to
back, each call ending in a synchronise, until `seconds` have passed;
the rate is all records sorted over the window's whole wall time. One
call's output, drawn uniformly from the window's calls by the seed, is
held and compared with the plain reference's whole order (the ten key
bytes, then the id), its workers' valid prefixes concatenated; the
inputs are checked unchanged. A traced run profiles `trace_calls` more
calls with every kernel launch recorded, after giving the program fresh
counters and device counts, so that the count readers read the traced
calls alone.

A program whose sort takes no `sample_fraction` cannot sample its
splitters; `run` refuses it before it makes any data.
"""
from __future__ import annotations

import inspect
import random
import time
import types

import torch

from perfbench.drivers.resident import entry
from perfbench.lib import devtrace, hooks
from perfbench.lib.outcome import Check, Outcome, sync
from perfbench.reference import skew10

KEY_BYTES = 10
CONTROL = "perfbench.controls_skew10.resident_sort"  # controls.run_control's


def run(cell, *, seed: int, seconds: float, trace: bool, t0: float,
        device="cuda", wrap=None) -> Outcome:
    """`wrap`, for tests and the control, replaces the entry by
    wrap(entry)."""
    sort = entry()
    if "sample_fraction" not in inspect.signature(sort).parameters:
        raise TypeError("distributed_sort_payload takes no sample_fraction: "
                        "this program cannot sample its splitters")
    if wrap is not None:
        sort = wrap(sort)
    cfg, tr = cell.config, cell.traffic
    n, w = int(cfg["records"]), int(cfg["workers"])
    keys, ids, payload = skew10.records_t(0, n, seed, device)
    kw = dict(num_workers=w, mode=tr["payload_mode"], device=device,
              key_bytes=KEY_BYTES,
              sample_fraction=float(cfg["sample_fraction"]))

    def call():
        out = sort(keys, ids, payload, **kw)
        sync(device)
        return out

    kept = None
    for _ in range(int(tr["warmup_calls"])):
        kept = call()  # one output held through the next call, as below
    setup_s = time.perf_counter() - t0

    rng = random.Random(seed)
    calls, kept_at = 0, -1
    start = time.perf_counter()
    while True:
        out = call()
        calls += 1
        if rng.random() * calls < 1.0:
            kept, kept_at = out, calls - 1
        out = None
        now = time.perf_counter()
        if now - start >= seconds:
            break
    window_s = now - start
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    reserved = torch.cuda.max_memory_reserved() if cuda else 0

    readings = types.SimpleNamespace(
        records_per_call=n, workers=w, trace=None, launches=[],
        trace_calls=0)
    dtrace = None
    if trace:
        tc = int(tr["trace_calls"])

        def traced():
            for _ in range(tc):
                with torch.profiler.record_function("perfbench.call"):
                    sort(keys, ids, payload, **kw)
                sync(device)

        fresh_counts()
        with hooks.launches() as log:
            _, dtrace = devtrace.capture(traced)
        readings.trace, readings.launches = dtrace, log
        readings.trace_calls = tc

    t_check = time.perf_counter()
    checks = check(kept, keys, ids, payload, n=n, w=w, seed=seed)
    kept = None
    return Outcome(
        attempted=calls, failed=int(checks[0].value > 0),
        end_to_end={"resident_sort_records_per_s": calls * n / window_s,
                    "setup_s": setup_s},
        readings=readings, checks=checks, memory_peak_bytes=peak,
        trace=dtrace,
        host_spans=[] if dtrace is None else dtrace.ranges,
        notes={"calls": calls, "kept_call": kept_at, "records": n,
               "window_s": window_s, "setup_s": setup_s,
               "reserved_peak_bytes": reserved,
               "check_s": time.perf_counter() - t_check})


def fresh_counts():
    """Replace the program's counters (repro_torch.obs.device.counters)
    and device counts (its device_counts) with empty ones."""
    from repro_torch.obs import device as obs

    obs.counters = type(obs.counters)()
    obs.device_counts = type(obs.device_counts)()


def check(out, keys, ids, payload, *, n: int, w: int, seed: int,
          chunk: int = 1 << 21) -> list[Check]:
    """The held output against the reference's whole order, and the
    inputs against the seed's records."""
    dev = keys.device
    changed = 0
    for a in range(0, n, chunk):
        b = min(a + chunk, n)
        k, i, p = skew10.records_t(a, b - a, seed, dev)
        changed += int(((keys[a:b] != k) | (ids[a:b] != i)
                        | (payload[a:b] != p).any(dim=-1)).sum())
    sk, si = skew10.lex_order(n, seed, dev)
    mk, mv, pout, valid, overflow = out
    pw = pout.shape[-1]
    segs = [(mk.view(w, -1)[d], mv.view(w, -1)[d],
             pout.view(w, -1, pw)[d], int(valid[d])) for d in range(w)]
    bad = skew10.compare_whole(segs, sk, si, seed)
    return [Check("mismatched_records", bad, 0),
            Check("input_changed_records", changed, 0),
            Check("overflow", int(bool(overflow)), 0)]
