"""Two checkouts of the port, timed in turns on one CUDA card.

    python3 src/repro_torch/examples/compare_checkouts.py A B \
        [--rounds N] [--log-dir DIR]

A and B are checkout roots (for example an older commit unpacked with
`git archive` into a git-ignored directory, and this one). The turns run
A, B, B, A, N times over, each in a process of its own whose
`repro_torch` is that checkout's. A turn builds the checkout's kernels
and times, with chip_smoke.py's timer (device ms a call over 20
back-to-back cold-L2 calls): its map sort and its partition at the main
path's shape (8, 2^20) x 7 bounds; its merge tournament at the first
round's (32, 2^18) and stage 2's (8, 2^21); its reduce window merge
(`kway_merge_indexed`) at (4, 2^12) and (4, 2^14), with the host µs of
one call; and the host µs of one whole `merge_fragments_device` window
at (4, 2^12) with the full run's payload. Then it runs chip_smoke.py's
full sort (4 waves of 2^24 100-byte records, valsort included) and
prints one JSON line. The last line holds each checkout's mean over its
turns. The timer and the full plan come from this checkout's
chip_smoke.py, so both checkouts are held to the same yardstick.
"""
import argparse
import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
METRICS = ("sort_ms", "partition_ms", "merge_ms_2^18", "merge_ms_2^21",
           "window_ms_2^12", "window_ms_2^14", "window_host_us_2^12",
           "window_host_us_2^14", "merge_fragments_host_us", "sort_s",
           "map_s", "reduce_s", "map_device_sort_s",
           "reduce_device_merge_s", "records_per_s")


def turn(tree: str, log_dir: str, tag: str) -> dict:
    """One turn on checkout `tree`, in this process."""
    sys.path[:0] = [os.path.join(tree, "src"), ROOT]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.keyspace import KeySpace
    from repro_torch.examples import cloudsort_oocore
    from repro_torch.kernels import _build, ops, u32
    from repro_torch.kernels.bitonic_sort import bitonic_sort_blocks
    from repro_torch.kernels.kway_merge import (kway_merge_indexed,
                                                merge_fragments_device)
    from repro_torch.kernels.merge_sorted import merge_sorted_pairs
    from repro_torch.kernels.range_partition import partition_offsets_blocks

    _build.function("bitonic_sort")  # builds every kernel of the checkout
    plan = cs.full_plan()
    w, dev = cs.NUM_WORKERS, torch.device("cuda")
    b = plan.records_per_wave // w // plan.num_rounds
    rng = np.random.default_rng(cs.SEED)

    def rand(shape):
        return u32.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64)
                              .astype(np.uint32), dev)

    def sorted_rows(shape):
        return u32.unpack(torch.sort(u32.pack(rand(shape), rand(shape)),
                                     dim=-1)[0])

    k, v = rand((w, b)), rand((w, b))
    wb = KeySpace(num_reducers=w * plan.reducers_per_worker,
                  num_workers=w).worker_boundaries(dev)

    def ms(fn, inputs):
        host = cs.host_us(fn, inputs)
        return cs.device_ms(fn, cs.rotation(inputs), cs.TIMED_CALLS,
                            host * 1e-6), host

    row = {"tree": tree, "turn": tag,
           "sort_ms": ms(bitonic_sort_blocks, (k, v))[0]}
    sk = bitonic_sort_blocks(k, v)[0]
    row["partition_ms"] = ms(partition_offsets_blocks, (sk, wb))[0]
    del k, v, sk
    for n, lb in ((32, 18), (8, 21)):
        row[f"merge_ms_2^{lb}"] = ms(merge_sorted_pairs,
                                     (*sorted_rows((n, 1 << lb)),
                                      *sorted_rows((n, 1 << lb))))[0]
        torch.cuda.empty_cache()
    kw = ops.next_pow2(cs.WAVES)
    for lb in (12, 14):
        idx = torch.arange(kw << lb, dtype=torch.int32,
                           device=dev).reshape(kw, 1 << lb)
        row[f"window_ms_2^{lb}"], row[f"window_host_us_2^{lb}"] = ms(
            kway_merge_indexed, (*sorted_rows((kw, 1 << lb)), idx))
    frags = cs.fragments(rng, [rng.integers(0, 2**32, 1 << 12,
                                            dtype=np.uint64).astype(np.uint32)
                               for _ in range(kw)], plan.payload_words)
    row["merge_fragments_host_us"] = cs.host_us(
        lambda: merge_fragments_device(frags, plan.payload_words,
                                       device=dev), ())
    torch.cuda.empty_cache()

    store = os.path.join(ROOT, "build", "compare", "store")
    shutil.rmtree(store, ignore_errors=True)
    records = cs.WAVES * plan.records_per_wave
    with open(os.path.join(log_dir, f"turn-{tag}.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        out = cloudsort_oocore.main(
            ["--records", str(records), "--waves", str(cs.WAVES),
             "--no-faults", "--device", "cuda", "--store", store], plan=plan)
    shutil.rmtree(store, ignore_errors=True)
    if not out["valsort_ok"]:
        raise AssertionError(f"{tree}: valsort failed")
    row.update({m: out[m] for m in METRICS if m in out})
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs=2, help="checkout roots A and B")
    ap.add_argument("--rounds", type=int, default=1,
                    help="how many times to run the turns A, B, B, A")
    ap.add_argument("--log-dir", default=os.path.join(ROOT, "build",
                                                      "compare"))
    ap.add_argument("--turn", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    os.makedirs(args.log_dir, exist_ok=True)
    if args.turn is not None:  # a child: one turn on trees[0]
        print(json.dumps(turn(trees[0], args.log_dir, args.turn)), flush=True)
        return
    rows = []
    order = (trees[0], trees[1], trees[1], trees[0]) * args.rounds
    for i, tree in enumerate(order):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, tree,
             "--log-dir", args.log_dir, "--turn", f"{i}"],
            capture_output=True, text=True)
        if res.returncode:
            sys.exit(f"turn {i} on {tree} failed:\n{res.stderr[-4000:]}")
        rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({t: {m: statistics.mean(r[m] for r in rows
                                             if r["tree"] == t)
                          for m in METRICS}
                      for t in trees}))


if __name__ == "__main__":
    main()
