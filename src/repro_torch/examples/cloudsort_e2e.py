"""CloudSort end to end in memory (the paper's benchmark, §3): generate ->
sort whole records -> validate -> cost report, on one GPU.

    PYTHONPATH=src python -m repro_torch.examples.cloudsort_e2e \
        [--records 131072] [--payload-mode through|late] [--device cuda|cpu]

The twin of examples/cloudsort_e2e.py, through the port: gensort input
with its checksum, the exoshuffle sort with whole-record payload
movement (core/exoshuffle.distributed_sort_payload: W = 8 workers as a
batch axis, the sort, partition and merge kernels on the card, their
plain versions on the CPU), each worker's R1 reducer partitions, the
valsort ordering + checksum gates, and two cost lines: the Table-2 cost
model of the paper's cluster, and in place of the reference's modeled
accelerator pod, a modeled H100 fleet (core/cost_model.gpu_cloudsort_tco)
priced at this run's measured records/s a card.

`main(argv)` returns the run's numbers.
"""
import argparse
import time

import torch

from repro_torch.configs.cloudsort import SMOKE
from repro_torch.core.cost_model import (GpuCostParams, cloudsort_tco,
                                         gpu_cloudsort_tco)
from repro_torch.core.exoshuffle import (PAYLOAD_MODES, ShuffleConfig,
                                         distributed_sort_payload,
                                         reduce_partitions)
from repro_torch.data import gensort, valsort

#: Mesh workers of the reference example (its 8 host devices), here the
#: batch axis of the sort.
NUM_WORKERS = 8
PAYLOAD_WORDS = 8  # 32-byte payload at smoke scale, as in the reference


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", type=int, default=SMOKE.total_records)
    ap.add_argument("--payload-mode", default="through", choices=PAYLOAD_MODES)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the sort runs")
    args = ap.parse_args(argv)

    w = NUM_WORKERS
    cfg = ShuffleConfig(num_workers=w,
                        reducers_per_worker=SMOKE.reducers_per_worker,
                        impl="kernel")

    # --- generate input (paper §3.2, gensort) ---
    t0 = time.time()
    keys, ids = gensort.gen_keys(0, args.records, args.device)
    payload = gensort.gen_payload(ids, PAYLOAD_WORDS)
    in_ck = gensort.checksum(keys, ids, payload)
    print(f"[gen] {args.records} records in {time.time()-t0:.2f}s "
          f"checksum={in_ck}")

    # --- sort (map + shuffle + merge, payload rows by the mode) ---
    t0 = time.time()
    sk, si, sp, counts, ovf = distributed_sort_payload(
        keys, ids, payload, num_workers=w, mode=args.payload_mode, cfg=cfg,
        device=args.device)
    if sk.is_cuda:
        torch.cuda.synchronize(sk.device)
    sort_s = time.time() - t0
    assert not ovf, "fixed-capacity block overflow"
    print(f"[sort] {args.records} records in {sort_s:.2f}s "
          f"({args.records/sort_s:,.0f} rec/s, payload={args.payload_mode})")

    # --- reducer output partitions (paper §2.4: R1 per worker) ---
    seg = sk.shape[0] // w
    for wid in range(w):
        reduce_partitions(sk[wid * seg:(wid + 1) * seg], cfg, wid)
    print(f"[reduce] {w * cfg.reducers_per_worker} output partitions "
          f"(R1={cfg.reducers_per_worker}/worker)")

    # --- validate (paper §3.2, valsort) ---
    ks, iss, ps = valsort.slice_segments(sk, si, counts, sp)
    rep = valsort.validate(ks, iss, in_ck, ps, device=args.device)
    print(f"[valsort] within={rep.sorted_within} across={rep.sorted_across} "
          f"checksum={rep.checksum_match} records={rep.total_records}")
    assert rep.ok

    # --- cost model (paper §3.3.2, Table 2) ---
    paper = cloudsort_tco()
    print(f"[cost] paper 100TB TCO  = ${paper.total:.4f} (Table 2: $96.6728)")
    # the in-memory sort is the map and the reduce in one call: each leg
    # gets twice the measured rate, so that their times add up to it
    rate = args.records / sort_s
    fleet = GpuCostParams(map_records_per_s=2 * rate,
                          reduce_records_per_s=2 * rate)
    gpu = gpu_cloudsort_tco(p=fleet, payload_mode=args.payload_mode)
    print(f"[cost] {fleet.num_gpus} x H100 100TB TCO (modeled, "
          f"{args.payload_mode}, at this run's {rate:,.0f} rec/s on "
          f"{args.device}) = ${gpu.total:.2f}")
    return {"records": args.records, "payload_mode": args.payload_mode,
            "sort_s": sort_s, "records_per_s": rate,
            "valsort_ok": rep.ok, "checksum": rep.output_checksum,
            "gpu_tco": gpu.total}


if __name__ == "__main__":
    main()
