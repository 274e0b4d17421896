"""CloudSort out-of-core (paper §2.3–§2.5) on one GPU, or on G ranks: the
dataset lives in an object store, the cards hold one map wave.

    PYTHONPATH=src python -m repro_torch.examples.cloudsort_oocore \
        [--records 131072] [--device cuda|cuda:i|cpu]
        [--reduce-merge-impl numpy|device] [--ranks G] [--backend nccl|gloo]

    # one rank per card, joined by torchrun
    PYTHONPATH=src torchrun --nproc-per-node G \
        -m repro_torch.examples.cloudsort_oocore [...]

The twin of examples/cloudsort_oocore.py, through the port: gensort
writes input partitions into a TIERED store (io/tiered.py: a durable
tier behind latency + bandwidth + 503-throttling + retry middleware, and
a fast local spill tier); the sort job streams them through map waves
whose sort runs on the card (W = 8 workers as a batch axis), spills each
worker's run to the spill tier, and the reduce scheduler runs parallel
streaming merges under a global memory budget into multipart outputs;
valsort streams the output back for the ordering + checksum gates, and
the Table-2 TCO is priced from the durable tier's measured requests.

--no-faults gives a clean store; --workers N runs the same job through
the multi-worker cluster executor, --kill-worker I:K kills worker I
after K tasks. `main(argv, plan=...)` lets a caller supply its own
ExternalSortPlan and returns the run's numbers.

--ranks G (G divides W = 8) runs the sort as G processes of one
torch.distributed group (launch/mesh.py), each holding W/G workers on
its own card, the all_to_alls as collectives: NCCL on cards, gloo on the
CPU (`--ranks G --backend gloo --device cpu`); `--backend gloo --device
cuda:0` puts G ranks on one card. Without torchrun the G processes are
spawned here. Rank 0 writes the input before a barrier and runs valsort
after the reduce; the report is every rank's, merged. The numbers
returned are rank 0's, with each rank's kernel launches and all_to_all
log under "ranks" when this process spawned them. `main(argv,
mesh=...)` runs as one rank of a group the caller already joined.
"""
import argparse
import contextlib
import dataclasses
import os
import tempfile
import time

from repro_torch.configs.cloudsort import ooc_smoke_plan, smoke_fault_profile
from repro_torch.core.cost_model import (cloudsort_tco, measured_cloudsort_tco,
                                         measured_tiered_cloudsort_tco)
from repro_torch.data import gensort, valsort
from repro_torch.io.middleware import RetryPolicy
from repro_torch.io.tiered import tiered_cloudsort_store
from repro_torch.launch.mesh import (init_rank_mesh, spawn_ranks,
                                     under_torchrun)
from repro_torch.obs import Tracer, render_report, write_chrome_trace
from repro_torch.shuffle.sort import sort_shuffle_job

#: Mesh workers of the reference example (its 8 host devices), here the
#: batch axis of the device sort.
NUM_WORKERS = 8


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", type=int, default=1 << 17)
    ap.add_argument("--store", default=None,
                    help="store root dir (default: fresh tempdir)")
    ap.add_argument("--waves", type=int, default=None,
                    help="map waves (default: from the smoke plan)")
    ap.add_argument("--no-faults", action="store_true",
                    help="clean durable tier: no latency/throttle injection")
    ap.add_argument("--latency-ms", type=float, default=None,
                    help="override injected per-request latency")
    ap.add_argument("--get-rate", type=float, default=None,
                    help="override durable-tier GET tokens/s")
    ap.add_argument("--workers", type=int, default=0,
                    help="emulated cluster workers (0 = single-host driver)")
    ap.add_argument("--kill-worker", default=None, metavar="I:K",
                    help="with --workers: worker I dies after K tasks")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run "
                         "(load in chrome://tracing or ui.perfetto.dev)")
    ap.add_argument("--device", default="cuda",
                    help="where the sort and the device merge run: cuda "
                         "(a rank's own card), cuda:i or cpu")
    ap.add_argument("--reduce-merge-impl", choices=("numpy", "device"),
                    default=None,
                    help="emit-window merge (default: the plan's)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="torch.distributed ranks that split the W workers "
                         "(spawned here unless run under torchrun)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="collective backend of the ranks (default: nccl "
                         "on cuda, gloo on cpu)")
    return ap


def main(argv=None, *, plan=None, mesh=None) -> dict:
    args = _parser().parse_args(argv)
    if mesh is not None:
        return run(args, plan, mesh)
    if under_torchrun():
        mesh = init_rank_mesh(NUM_WORKERS, backend=args.backend,
                              device=args.device)
        with mesh:
            if args.ranks not in (1, mesh.world):
                raise ValueError(f"--ranks {args.ranks} under torchrun's "
                                 f"world of {mesh.world}")
            if mesh.world > 1 and not args.store:
                raise ValueError("--store: the ranks must share one store "
                                 "root")
            return run(args, plan, mesh)
    if args.ranks == 1:
        return run(args, plan, None)
    # All ranks share one store root: fix it before they start.
    args.store = args.store or tempfile.mkdtemp(prefix="cloudsort-store-")
    ranks = spawn_ranks(_rank_main, args.ranks, args, plan)
    return dict(ranks[0]["out"], ranks=[r["rank"] for r in ranks])


def _rank_main(rank: int, world: int, store_path: str, args, plan) -> dict:
    """One spawned rank: join the group, run, report this process's
    kernel launches (and their shapes) and its all_to_all log."""
    from repro_torch.shuffle.worker_main import kernel_launches, kernel_shapes

    mesh = init_rank_mesh(NUM_WORKERS, backend=args.backend,
                          device=args.device, rank=rank, world=world,
                          store_path=store_path)
    with mesh:
        out = run(args, plan, mesh)
    return {"out": out, "rank": {
        "rank": rank, "launches": kernel_launches(),
        "shapes": kernel_shapes(), "exchanges": out["exchanges"]}}


def run(args, plan, mesh) -> dict:
    """The run, on one process or as one rank of `mesh`."""
    if mesh is not None and args.workers:
        raise ValueError("--workers (the cluster executor) and --ranks do "
                         "not combine: each rank runs the inline driver")
    if mesh is None or mesh.rank == 0:
        return _run(args, plan, mesh)
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):
        return _run(args, plan, mesh)


def _run(args, plan, mesh) -> dict:
    lead = mesh is None or mesh.rank == 0
    w = NUM_WORKERS
    if plan is None:
        plan = dataclasses.replace(ooc_smoke_plan(), impl="kernel")
    if args.reduce_merge_impl:
        plan = dataclasses.replace(plan,
                                   reduce_merge_impl=args.reduce_merge_impl)
    if args.waves:
        assert args.records % args.waves == 0, (
            f"--records {args.records} must be divisible by --waves {args.waves}")
        plan = dataclasses.replace(plan, records_per_wave=args.records // args.waves)
    # Scale the global reduce budget with the dataset so the demo
    # invariant (budget < one output partition) holds at any --records,
    # floored at one record per run per active reducer.
    num_reducers = w * plan.reducers_per_worker
    partition_bytes = args.records // num_reducers * plan.record_bytes
    n_waves = max(args.records // plan.records_per_wave, 1)
    budget = max(min(plan.reduce_memory_budget_bytes, partition_bytes // 2),
                 plan.parallel_reducers * n_waves * plan.record_bytes)
    plan = dataclasses.replace(plan, reduce_memory_budget_bytes=budget)

    faults = None if args.no_faults else smoke_fault_profile()
    if faults is not None:
        if args.latency_ms is not None:
            faults = dataclasses.replace(faults, latency_s=args.latency_ms / 1e3)
        if args.get_rate is not None:
            faults = dataclasses.replace(faults, get_rate=args.get_rate)

    root = args.store or tempfile.mkdtemp(prefix="cloudsort-store-")
    tracer = Tracer(job="cloudsort")
    store = tiered_cloudsort_store(
        root, spill_prefixes=(plan.spill_prefix,), faults=faults,
        retry=RetryPolicy(max_attempts=10, base_delay_s=0.01, max_delay_s=0.5),
        tracer=tracer,
    )
    data_bytes = args.records * plan.record_bytes
    mode = "clean" if faults is None else (
        f"faults: latency={faults.latency_s*1e3:.1f}ms "
        f"bw={faults.bandwidth_bps/1e6:.0f}MB/s "
        f"throttle={faults.get_rate:.0f}G/{faults.put_rate:.0f}P req/s")
    print(f"[store] tiered (durable + ssd spill) at {root} — {mode}")
    device = args.device if mesh is None else mesh.device
    print(f"[device] {device}; W={w} workers; impl={plan.impl}; "
          f"reduce merge={plan.reduce_merge_impl}")
    if mesh is not None:
        print(f"[ranks] {mesh.world} x {w // mesh.world} workers, "
              f"{mesh.backend}")
        mesh.record_exchanges()

    # --- generate into the store (paper §3.2, gensort -> S3) ---
    t0 = time.time()
    in_ck = None
    if lead:
        store.create_bucket("cloudsort")
        in_ck, nparts = gensort.write_to_store(
            store, "cloudsort", plan.input_prefix, args.records,
            plan.input_records_per_partition, plan.payload_words,
            device=device,
        )
    if mesh is not None:
        mesh.barrier()
        store.create_bucket("cloudsort")
    gen_s = time.time() - t0
    if lead:
        print(f"[gen] {args.records} records -> {nparts} partitions "
              f"({data_bytes/1e6:.1f} MB) in {gen_s:.2f}s checksum={in_ck}")

    # --- out-of-core sort: store -> map waves -> spill -> reduce -> store ---
    cplan = None
    if args.workers > 0:
        from repro_torch.configs.cloudsort import cluster_smoke_plan

        # Widen the budget to the cluster-wide merge concurrency.
        plan, cplan = cluster_smoke_plan(args.workers, base=plan,
                                         runs=n_waves)
        if args.kill_worker:
            idx, _, k = args.kill_worker.partition(":")
            cplan = dataclasses.replace(
                cplan, fail_after_tasks={int(idx): int(k or 1)})
    job = sort_shuffle_job(store, "cloudsort", num_workers=w, plan=plan,
                           tracer=tracer, device=device, mesh=mesh)
    if cplan is not None:
        crep = job.run(cluster=cplan)
        rep = crep.report
        print(f"[cluster] {crep.num_cluster_workers} workers, "
              f"{crep.map_tasks} map + {crep.reduce_tasks} reduce tasks; "
              f"confirmed per worker: {crep.per_worker_tasks}")
        if crep.failed_workers or crep.reexecuted_tasks:
            print(f"[cluster] failed workers: {crep.failed_workers} — "
                  f"{crep.reexecuted_map_tasks} map / "
                  f"{crep.reexecuted_reduce_tasks} reduce tasks "
                  "re-executed on survivors")
    else:
        rep = job.run(workers=0)
    sort_s = rep.map_seconds + rep.reduce_seconds
    print(f"[sort] {rep.total_records} records in {sort_s:.2f}s "
          f"({rep.total_records/sort_s:,.0f} rec/s) — {rep.num_waves} waves, "
          f"working set {rep.working_set_records} records "
          f"({rep.oversubscription:.1f}x out-of-core)")
    print(f"[spill] {rep.spill_objects} run objects -> ssd tier; "
          f"[reduce] {rep.output_objects} output partitions, "
          f"{rep.runs_per_reducer}-way streaming merges x "
          f"{rep.parallel_reducers} concurrent, part fan-out "
          f"{plan.part_upload_fanout}")
    assert rep.oversubscription >= 4.0, "demo must be genuinely out-of-core"

    # --- bounded-memory reduce: measured peak vs the global budget ------
    bound = rep.reduce_memory_bound_bytes
    partition_bytes = rep.total_records // rep.num_reducers * plan.record_bytes
    print(f"[reduce-mem] peak merge buffer {rep.reduce_peak_merge_bytes/1e3:.1f} KB "
          f"across {rep.parallel_reducers} concurrent merges <= "
          f"budget {bound/1e3:.1f} KB (per-run chunk "
          f"{rep.reduce_chunk_bytes/1e3:.1f} KB; one partition would be "
          f"{partition_bytes/1e3:.1f} KB)")
    assert rep.reduce_peak_merge_bytes <= bound, (
        rep.reduce_peak_merge_bytes, bound)
    assert bound < partition_bytes, "bound must beat materializing a partition"
    if rep.reduce_chunk_bytes_max > rep.reduce_chunk_bytes:
        print(f"[reduce-mem] adaptive governor: per-run chunk grew "
              f"{rep.reduce_chunk_bytes/1e3:.1f} KB -> "
              f"{rep.reduce_chunk_bytes_max/1e3:.1f} KB as reducers "
              "retired (budget re-apportioned to the tail)")

    for line in render_report(rep):
        print(line)
    exchanges = None
    if mesh is not None:
        exchanges = mesh.exchange_log()
        sent = sum(x["bytes"] for x in exchanges)
        print(f"[ranks] {len(exchanges)} all_to_alls on this rank, "
              f"{sent/1e6:.1f} MB handed to them, "
              f"{sum(x['ms'] for x in exchanges):.1f} ms "
              f"({exchanges[0]['clock'] if exchanges else '-'} clock)")
    if not lead:
        return {"exchanges": exchanges}

    # --- validate from the store (paper §3.2, valsort over S3 output) ---
    t0 = time.time()
    val = valsort.validate_from_store(
        store, "cloudsort", plan.output_prefix, in_ck,
        chunk_records=max(plan.output_part_records, 1 << 13),
        device=device)
    val_s = time.time() - t0
    print(f"[valsort] within={val.sorted_within} across={val.sorted_across} "
          f"checksum={val.checksum_match} records={val.total_records} "
          f"in {val_s:.2f}s")
    assert val.ok and val.total_records == args.records

    # --- cost (paper §3.3.2): measured requests, not Table-1 constants ---
    paper = cloudsort_tco()
    if rep.tier_stats is not None:
        measured = measured_tiered_cloudsort_tco(
            rep.tier_stats, job_hours=rep.job_hours,
            reduce_hours=rep.reduce_hours, data_bytes=data_bytes)
        billed = rep.tier_stats["durable"]
    else:
        measured = measured_cloudsort_tco(
            rep.stats, job_hours=rep.job_hours, reduce_hours=rep.reduce_hours,
            data_bytes=data_bytes)
        billed = rep.stats
    print(f"[cost] paper 100TB TCO = ${paper.total:.4f} (Table 2: $96.6728)")
    print(f"[cost] this run (billed durable tier: {billed.get_requests} GETs / "
          f"{billed.put_requests} PUTs incl. retries, "
          f"{data_bytes/1e12:.6f} TB; ssd spill free):")
    for name, val_ in measured.rows():
        print(f"         {name:<24s} ${val_:.6f}")

    if args.trace_out:
        tr = write_chrome_trace(args.trace_out, tracer)
        print(f"[trace] {len(tr['traceEvents'])} events -> {args.trace_out} "
              "(open in chrome://tracing or ui.perfetto.dev)")

    ps = rep.phase_seconds
    return {
        "records": rep.total_records,
        "record_bytes": plan.record_bytes,
        "waves": rep.num_waves,
        "gen_s": gen_s,
        "sort_s": sort_s,
        "records_per_s": rep.total_records / sort_s,
        "map_s": rep.map_seconds,
        "reduce_s": rep.reduce_seconds,
        "map_device_sort_s": ps.get("map.device_sort", 0.0),
        "reduce_device_merge_s": ps.get("reduce.device_merge", 0.0),
        "valsort_s": val_s,
        "valsort_ok": val.ok,
        "store": root,
        "ranks": 1 if mesh is None else mesh.world,
        "backend": None if mesh is None else mesh.backend,
        "exchanges": exchanges,
    }


if __name__ == "__main__":
    main()
