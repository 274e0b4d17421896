"""Two checkouts of the port, timed in turns on one CUDA card.

    python3 src/repro_torch/examples/compare_checkouts.py A B \
        [--rounds N] [--log-dir DIR]

A and B are checkout roots (for example an older commit unpacked with
`git archive` into a git-ignored directory, and this one). The turns run
A, B, B, A, N times over, each in a process of its own whose
`repro_torch` is that checkout's. A turn builds the checkout's kernels,
times its map sort and its partition at the main path's shape (8, 2^20)
x 7 bounds and its indexed merge at one reduce window's shape (2, 16384)
with chip_smoke.py's timer (device ms a call over 20 back-to-back
cold-L2 calls; host µs of one wrapper call for the indexed merge, which
the reduce calls ~10^4 times a run), then runs chip_smoke.py's full sort
(4 waves of 2^24 100-byte records, valsort included) and prints one JSON
line. The last line holds each checkout's mean over its turns. The
timer and the full plan come from this checkout's chip_smoke.py, so both
checkouts are held to the same yardstick.
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
METRICS = ("sort_ms", "partition_ms", "merge_idx_ms", "merge_idx_host_us",
           "sort_s", "map_s", "reduce_s", "map_device_sort_s",
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
    from repro_torch.kernels.kway_merge import merge_sorted_pairs_indexed
    from repro_torch.kernels.range_partition import partition_offsets_blocks

    _build.function("bitonic_sort")  # builds every kernel of the checkout
    plan = cs.full_plan()
    w, dev = cs.NUM_WORKERS, torch.device("cuda")
    b = plan.records_per_wave // w // plan.num_rounds
    rng = np.random.default_rng(cs.SEED)

    def rand(shape):
        return u32.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64)
                              .astype(np.uint32), dev)

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
    n = ops.next_pow2(cs.WAVES) // 2
    L = ops.next_pow2(plan.merge_chunk_bytes // plan.record_bytes)
    a, c = (u32.unpack(torch.sort(u32.pack(rand((n, L)), rand((n, L))),
                                  dim=-1)[0]) for _ in range(2))
    ai = torch.arange(n * L, dtype=torch.int32, device=dev).reshape(n, L)
    row["merge_idx_ms"], row["merge_idx_host_us"] = ms(
        merge_sorted_pairs_indexed, (a[0], a[1], ai, c[0], c[1], ai + n * L))
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
