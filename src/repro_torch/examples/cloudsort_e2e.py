"""CloudSort end to end in memory (the paper's benchmark, §3): generate ->
sort whole records -> validate -> cost report, on one GPU.

    PYTHONPATH=src python -m repro_torch.examples.cloudsort_e2e \
        [--records 131072] [--payload-mode through|late]
        [--device cuda|cuda:i|cpu] [--ranks G] [--backend nccl|gloo]

The twin of examples/cloudsort_e2e.py, through the port: gensort input
with its checksum, the exoshuffle sort with whole-record payload
movement (core/exoshuffle.distributed_sort_payload: W = 8 workers as a
batch axis, the sort, partition and merge kernels on the card, their
plain versions on the CPU), each worker's R1 reducer partitions, the
valsort ordering + checksum gates, and two cost lines: the Table-2 cost
model of the paper's cluster, and in place of the reference's modeled
accelerator pod, a modeled H100 fleet (core/cost_model.gpu_cloudsort_tco)
priced at this run's measured records/s a card.

With --ranks G (or under torchrun) the sort runs on G ranks of one
torch.distributed group (launch/mesh.py), each generating and sorting
the shard of its W/G workers; rank 0 gathers the outputs for valsort.
`main(argv)` returns the run's numbers (rank 0's), among them `digest`,
a sha256 of the whole output (keys, ids, payload rows and counts, in
worker order): equal digests mean bit-identical outputs. With --ranks G
they also hold `rank_kernels`, each spawned rank's kernel launches and
the shapes launched at (the four sort kernels' and the slot gather's).
"""
import argparse
import hashlib
import time

import numpy as np
import torch

from repro_torch.configs.cloudsort import SMOKE
from repro_torch.core.cost_model import (GpuCostParams, cloudsort_tco,
                                         gpu_cloudsort_tco)
from repro_torch.core.exoshuffle import (PAYLOAD_MODES, ShuffleConfig,
                                         distributed_sort_payload,
                                         reduce_partitions)
from repro_torch.data import gensort, valsort
from repro_torch.kernels import u32
from repro_torch.launch.mesh import (init_rank_mesh, spawn_ranks,
                                     under_torchrun)

#: Mesh workers of the reference example (its 8 host devices), here the
#: batch axis of the sort.
NUM_WORKERS = 8
PAYLOAD_WORDS = 8  # 32-byte payload at smoke scale, as in the reference


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", type=int, default=SMOKE.total_records)
    ap.add_argument("--payload-mode", default="through", choices=PAYLOAD_MODES)
    ap.add_argument("--device", default="cuda",
                    help="where the sort runs: cuda (a rank's own card), "
                         "cuda:i or cpu")
    ap.add_argument("--ranks", type=int, default=1,
                    help="torch.distributed ranks that split the W workers "
                         "(spawned here unless run under torchrun)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="collective backend of the ranks (default: nccl "
                         "on cuda, gloo on cpu)")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    if under_torchrun():
        with init_rank_mesh(NUM_WORKERS, backend=args.backend,
                            device=args.device) as mesh:
            return run(args, mesh)
    if args.ranks == 1:
        return run(args, None)
    ranks = spawn_ranks(_rank_main, args.ranks, args)
    return dict(ranks[0]["out"], rank_kernels=[r["kernels"] for r in ranks])


def _rank_main(rank: int, world: int, store_path: str, args) -> dict:
    """One spawned rank: join the group, run, report this process's
    kernel launches and the shapes launched at."""
    from repro_torch.kernels.slot_gather import gather_slot_rows
    from repro_torch.shuffle.worker_main import kernel_launches, kernel_shapes

    with init_rank_mesh(NUM_WORKERS, backend=args.backend, device=args.device,
                        rank=rank, world=world,
                        store_path=store_path) as mesh:
        out = run(args, mesh)
    return {"out": out, "kernels": {
        "rank": rank,
        "launches": dict(kernel_launches(),
                         gather_slot_rows=gather_slot_rows.launches),
        "shapes": dict(kernel_shapes(),
                       gather_slot_rows=sorted(gather_slot_rows.shapes))}}


def digest(*arrays) -> str:
    """sha256 over the arrays' bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def run(args, mesh) -> dict:
    """The run, on one process or as one rank of `mesh` (rank 0 prints,
    validates and returns the numbers; the others return {})."""
    w = NUM_WORKERS
    lead = mesh is None or mesh.rank == 0
    device = args.device if mesh is None else mesh.device
    say = print if lead else (lambda *a, **k: None)
    cfg = ShuffleConfig(num_workers=w,
                        reducers_per_worker=SMOKE.reducers_per_worker,
                        impl="kernel")

    # --- generate input (paper §3.2, gensort): the held workers' shard ---
    t0 = time.time()
    lo, hi = (0, args.records) if mesh is None else mesh.share(args.records)
    keys, ids = gensort.gen_keys(lo, hi - lo, device)
    payload = gensort.gen_payload(ids, PAYLOAD_WORDS)
    in_ck = gensort.checksum(keys, ids, payload)
    if mesh is not None:
        in_ck = _combine(mesh.all_gather_object(in_ck))
    say(f"[gen] {args.records} records in {time.time()-t0:.2f}s "
        f"checksum={in_ck}")

    # --- sort (map + shuffle + merge, payload rows by the mode) ---
    if mesh is not None:
        mesh.barrier()
    t0 = time.time()
    sk, si, sp, counts, ovf = distributed_sort_payload(
        keys, ids, payload, num_workers=w, mode=args.payload_mode, cfg=cfg,
        device=device, mesh=mesh)
    if sk.is_cuda:
        torch.cuda.synchronize(sk.device)
    if mesh is not None:
        mesh.barrier()
    sort_s = time.time() - t0
    assert not ovf, "fixed-capacity block overflow"
    say(f"[sort] {args.records} records in {sort_s:.2f}s "
        f"({args.records/sort_s:,.0f} rec/s, payload={args.payload_mode})"
        + ("" if mesh is None else f" on {mesh.world} {mesh.backend} ranks"))

    # --- reducer output partitions (paper §2.4: R1 per worker) ---
    held = w if mesh is None else mesh.workers_per_rank
    first = 0 if mesh is None else mesh.worker_lo
    seg = sk.shape[0] // held
    for i in range(held):
        reduce_partitions(sk[i * seg:(i + 1) * seg], cfg, first + i)
    say(f"[reduce] {w * cfg.reducers_per_worker} output partitions "
        f"(R1={cfg.reducers_per_worker}/worker)")

    # --- validate (paper §3.2, valsort): the whole output, on rank 0 ---
    out = [u32.to_numpy(sk), u32.to_numpy(si), u32.to_numpy(sp),
           counts.cpu().numpy()]
    if mesh is not None:
        parts = mesh.all_gather_object(out)
        if not lead:
            return {}
        out = [np.concatenate(a) for a in zip(*parts)]
    sk, si, sp, counts = (torch.from_numpy(a) for a in out)
    ks, iss, ps = valsort.slice_segments(sk, si, counts, sp)
    rep = valsort.validate(ks, iss, in_ck, ps, device=device)
    print(f"[valsort] within={rep.sorted_within} across={rep.sorted_across} "
          f"checksum={rep.checksum_match} records={rep.total_records}")
    assert rep.ok
    out_digest = digest(*out)

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
          f"{device}) = ${gpu.total:.2f}")
    return {"records": args.records, "payload_mode": args.payload_mode,
            "sort_s": sort_s, "records_per_s": rate,
            "valsort_ok": rep.ok, "checksum": rep.output_checksum,
            "gpu_tco": gpu.total, "digest": out_digest,
            "ranks": 1 if mesh is None else mesh.world}


def _combine(checksums) -> tuple[int, int]:
    total = (0, 0)
    for ck in checksums:
        total = gensort.combine_checksums(total, ck)
    return total


if __name__ == "__main__":
    main()
