"""Bring-your-own-workload: streaming group-by aggregation on the shuffle
library (the Exoshuffle generality claim, runnable).

  PYTHONPATH=src python examples/groupby_shuffle.py [--records 131072]

Word-count in object-store clothing: skewed keyed records (group key,
value) live on a TIERED store whose durable tier injects S3 behaviour —
latency, bandwidth, 503 throttling, retries — while spills route to a
fast local-SSD tier. The job hash-partitions keys (uniform routing under
skew), pre-aggregates map-side with a combiner (repeated keys collapse
before they are spilled and shuffled), streams each output partition's
runs through the library's budget-governed cursors, and multipart-
uploads aggregated (key, count, sum) records — the record-count header
is only known at the end, so it uploads as out-of-order part 0.

None of that machinery is group-by code: staging, scheduling, the
AdaptiveBudgetGovernor, span timelines, and fault recovery are the same
library calls CloudSort uses (examples/cloudsort_oocore.py). The
operators fit in ~150 lines (src/repro/shuffle/groupby.py).

Pass --workers N for the multi-worker executor, --kill-worker I:K to
inject a worker death and watch re-execution, --no-combine to measure
what the combiner saves, --no-faults for a clean store.
"""
import argparse
import dataclasses
import tempfile
import time


def main():
    from repro_torch.configs.cloudsort import smoke_fault_profile
    from repro_torch.configs.groupby import SMOKE, groupby_smoke_plan
    from repro_torch.io.middleware import RetryPolicy
    from repro_torch.io.tiered import tiered_cloudsort_store
    from repro_torch.obs import Tracer, render_report, write_chrome_trace
    from repro_torch.shuffle.executor import ClusterPlan
    from repro_torch.shuffle.groupby import (groupby_job,
                                       validate_groupby_from_store,
                                       write_groupby_input)

    ap = argparse.ArgumentParser()
    ap.add_argument("--records", type=int, default=SMOKE.records)
    ap.add_argument("--groups", type=int, default=SMOKE.num_groups)
    ap.add_argument("--skew", type=float, default=SMOKE.skew)
    ap.add_argument("--partitions", type=int, default=SMOKE.num_partitions)
    ap.add_argument("--store", default=None,
                    help="store root dir (default: fresh tempdir)")
    ap.add_argument("--no-faults", action="store_true")
    ap.add_argument("--no-combine", action="store_true",
                    help="disable the map-side combiner")
    ap.add_argument("--workers", type=int, default=0,
                    help="emulated cluster workers (0 = single-host)")
    ap.add_argument("--kill-worker", default=None, metavar="I:K",
                    help="with --workers: worker I dies after K tasks")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the run "
                         "(load in chrome://tracing or ui.perfetto.dev)")
    args = ap.parse_args()

    plan = groupby_smoke_plan()
    faults = None if args.no_faults else smoke_fault_profile()
    root = args.store or tempfile.mkdtemp(prefix="groupby-store-")
    tracer = Tracer(job="groupby")
    store = tiered_cloudsort_store(
        root, spill_prefixes=(plan.spill_prefix,), faults=faults,
        retry=RetryPolicy(max_attempts=10, base_delay_s=0.01,
                          max_delay_s=0.5),
        tracer=tracer,
    )
    store.create_bucket("agg")
    mode = "clean" if faults is None else (
        f"faults: latency={faults.latency_s*1e3:.1f}ms "
        f"throttle={faults.get_rate:.0f}G/{faults.put_rate:.0f}P req/s")
    print(f"[store] tiered (durable + ssd spill) at {root} — {mode}")

    t0 = time.time()
    expected_counts, expected_sums = write_groupby_input(
        store, "agg", plan.input_prefix, args.records,
        SMOKE.records_per_partition, num_groups=args.groups,
        skew=args.skew, value_range=SMOKE.value_range)
    print(f"[gen] {args.records} records over {args.groups} groups "
          f"(skew {args.skew}) in {time.time()-t0:.2f}s; hottest group "
          f"holds {int(expected_counts.max())} records "
          f"({100.0 * int(expected_counts.max()) / args.records:.1f}%)")

    job = groupby_job(store, "agg", plan=plan,
                      num_partitions=args.partitions,
                      combine=not args.no_combine, tracer=tracer)
    if args.workers > 0:
        cplan = ClusterPlan(num_workers=args.workers)
        if args.kill_worker:
            idx, _, k = args.kill_worker.partition(":")
            cplan = dataclasses.replace(
                cplan, fail_after_tasks={int(idx): int(k or 1)})
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
        rep = job.run()

    secs = rep.map_seconds + rep.reduce_seconds
    print(f"[agg] {rep.total_records} records -> {rep.num_partitions} "
          f"partitions in {secs:.2f}s ({rep.total_records/secs:,.0f} rec/s); "
          f"{rep.num_map_tasks} map tasks, combiner "
          f"{'off' if args.no_combine else 'on'}")
    print(f"[reduce-mem] peak merge buffer "
          f"{rep.reduce_peak_merge_bytes/1e3:.1f} KB across "
          f"{rep.parallel_reducers} concurrent merges <= budget "
          f"{rep.reduce_memory_bound_bytes/1e3:.1f} KB")
    assert rep.reduce_peak_merge_bytes <= rep.reduce_memory_bound_bytes

    for line in render_report(rep):
        print(line)

    val = validate_groupby_from_store(
        store, "agg", plan.output_prefix, job.partitioner,
        expected_counts, expected_sums)
    print(f"[validate] groups={val.total_groups} "
          f"counts={val.counts_match} sums={val.sums_match} "
          f"sorted={val.keys_sorted_unique} routing={val.routing_ok}")
    assert val.ok, val

    spill = (rep.tier_stats or {}).get("ssd")
    if spill is not None:
        print(f"[combine] shuffled {spill.bytes_written/1e6:.2f} MB of "
              f"spill for {rep.total_records * plan.record_bytes/1e6:.2f} MB "
              "of input (re-run with --no-combine to compare)")

    if args.trace_out:
        tr = write_chrome_trace(args.trace_out, tracer)
        print(f"[trace] {len(tr['traceEvents'])} events -> {args.trace_out} "
              "(open in chrome://tracing or ui.perfetto.dev)")


if __name__ == "__main__":
    main()
