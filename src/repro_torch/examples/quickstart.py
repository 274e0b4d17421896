"""Quickstart: the exoshuffle distributed sort in ~30 lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda|cpu]

The twin of examples/quickstart.py: sorts 32k gensort records over 8
workers (the reference's 8-device mesh, here a batch axis) with the
paper's two-stage pipeline in 4 rounds — the sort, partition and merge
kernels on the card, their plain versions on the CPU — and validates the
result with the valsort gate. `main(argv)` returns the run's numbers.
"""
import argparse
import time

from repro_torch.core.streaming import streaming_sort
from repro_torch.data import gensort, valsort

NUM_WORKERS = 8
NUM_ROUNDS = 4


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the sort runs")
    args = ap.parse_args(argv)

    n = NUM_WORKERS * 4096
    t0 = time.perf_counter()
    keys, ids = gensort.gen_keys(0, n, args.device)
    input_checksum = gensort.checksum(keys, ids)

    sorted_keys, sorted_ids, counts, overflow = streaming_sort(
        keys, ids, num_workers=NUM_WORKERS, num_rounds=NUM_ROUNDS,
        impl="kernel", device=args.device)
    if overflow:
        raise RuntimeError("fixed-capacity block overflow")

    segs_k, segs_i, _ = valsort.slice_segments(sorted_keys, sorted_ids, counts)
    report = valsort.validate(segs_k, segs_i, input_checksum,
                              device=args.device)
    secs = time.perf_counter() - t0
    print(f"sorted {report.total_records} records on {NUM_WORKERS} workers "
          f"({args.device})")
    print(f"valsort: within={report.sorted_within} "
          f"across={report.sorted_across} checksum={report.checksum_match}")
    if not report.ok:
        raise RuntimeError(f"valsort failed: {report}")
    return {"records": report.total_records, "workers": NUM_WORKERS,
            "rounds": NUM_ROUNDS, "seconds": secs, "valsort_ok": report.ok,
            "sorted_keys": sorted_keys, "sorted_ids": sorted_ids,
            "counts": counts}


if __name__ == "__main__":
    main()
