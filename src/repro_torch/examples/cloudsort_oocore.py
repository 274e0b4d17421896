"""CloudSort out-of-core (paper §2.3–§2.5) on one GPU: the dataset lives
in an object store, the card holds one map wave.

    PYTHONPATH=src python -m repro_torch.examples.cloudsort_oocore \
        [--records 131072] [--device cuda|cpu] [--reduce-merge-impl numpy|device]

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
"""
import argparse
import dataclasses
import tempfile
import time

from repro_torch.configs.cloudsort import ooc_smoke_plan, smoke_fault_profile
from repro_torch.core.cost_model import (cloudsort_tco, measured_cloudsort_tco,
                                         measured_tiered_cloudsort_tco)
from repro_torch.data import gensort, valsort
from repro_torch.io.middleware import RetryPolicy
from repro_torch.io.tiered import tiered_cloudsort_store
from repro_torch.obs import Tracer, render_report, write_chrome_trace
from repro_torch.shuffle.sort import sort_shuffle_job

#: Mesh workers of the reference example (its 8 host devices), here the
#: batch axis of the device sort.
NUM_WORKERS = 8


def main(argv=None, *, plan=None) -> dict:
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
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the sort and the device merge run")
    ap.add_argument("--reduce-merge-impl", choices=("numpy", "device"),
                    default=None,
                    help="emit-window merge (default: the plan's)")
    args = ap.parse_args(argv)

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
    store.create_bucket("cloudsort")
    data_bytes = args.records * plan.record_bytes
    mode = "clean" if faults is None else (
        f"faults: latency={faults.latency_s*1e3:.1f}ms "
        f"bw={faults.bandwidth_bps/1e6:.0f}MB/s "
        f"throttle={faults.get_rate:.0f}G/{faults.put_rate:.0f}P req/s")
    print(f"[store] tiered (durable + ssd spill) at {root} — {mode}")
    print(f"[device] {args.device}; W={w} workers; impl={plan.impl}; "
          f"reduce merge={plan.reduce_merge_impl}")

    # --- generate into the store (paper §3.2, gensort -> S3) ---
    t0 = time.time()
    in_ck, nparts = gensort.write_to_store(
        store, "cloudsort", plan.input_prefix, args.records,
        plan.input_records_per_partition, plan.payload_words,
        device=args.device,
    )
    gen_s = time.time() - t0
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
                           tracer=tracer, device=args.device)
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

    # --- validate from the store (paper §3.2, valsort over S3 output) ---
    t0 = time.time()
    val = valsort.validate_from_store(
        store, "cloudsort", plan.output_prefix, in_ck,
        chunk_records=max(plan.output_part_records, 1 << 13),
        device=args.device)
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
    }


if __name__ == "__main__":
    main()
