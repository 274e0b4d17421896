"""The paper's own benchmark configuration (Exoshuffle-CloudSort §2.1).

Scaled variants for CPU validation (`smoke`), pod-scale dry-run
(`pod256`/`pod512`), and the paper-parameter record (`paper` — 100 TB,
kept for the cost model; never materialized on this container).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CloudSortConfig:
    total_records: int
    num_workers: int  # W
    reducers_per_worker: int  # R1
    num_rounds: int  # merge-controller rounds (streaming)
    payload_words: int = 23  # 92 B payload + 8 B header = 100 B records
    capacity_factor: float = 1.5
    impl: str = "pallas"

    @property
    def records_per_worker(self) -> int:
        return self.total_records // self.num_workers


# Paper parameters (§2.1): 100 TB = 10^12 records of 100 B; M=50k maps of
# 2 GB; W=40 workers; R=25k reducers (R1=625). Records here are 100 B too.
PAPER = CloudSortConfig(
    total_records=10**12,
    num_workers=64,  # nearest pow2 of the paper's 40 (merge tournament)
    reducers_per_worker=625,
    num_rounds=1250,  # M / W map tasks per worker, batched 10 per round
)

SMOKE = CloudSortConfig(
    total_records=1 << 17,
    num_workers=8,
    reducers_per_worker=4,
    num_rounds=4,
    impl="ref",
)

POD256 = CloudSortConfig(
    total_records=1 << 24,
    num_workers=256,
    reducers_per_worker=64,
    num_rounds=8,
    impl="ref",
)

POD512 = CloudSortConfig(
    total_records=1 << 25,
    num_workers=512,
    reducers_per_worker=64,
    num_rounds=8,
    impl="ref",
)


def ooc_smoke_plan():
    """Out-of-core smoke schedule (examples/cloudsort_oocore.py, tests).

    A 2^14-record wave working set against a >=4x larger store-resident
    dataset: 8 map waves at the default 2^17 records, each wave split into
    2 streaming rounds, 2 input partitions per wave, 64 KiB download
    chunks, 16 KiB reduce merge-chunk cap. The reduce scheduler runs 4
    streaming merges concurrently under a 128 KiB global memory budget —
    strictly below one output partition (~196 KiB at the default record
    size), the bound the example asserts — with per-partition part
    uploads fanned out 2-wide (out-of-order part-indexed multipart).
    R1=2 keeps output partitions wide enough that each run slice still
    takes several chunked fetches at smoke scale.
    Lazily imported so configs stay importable without jax.
    """
    from repro_torch.core.external_sort import ExternalSortPlan

    return ExternalSortPlan(
        records_per_wave=1 << 14,
        num_rounds=2,
        reducers_per_worker=2,
        payload_words=4,
        impl="ref",
        input_records_per_partition=1 << 13,
        output_part_records=1 << 13,
        store_chunk_bytes=64 << 10,
        merge_chunk_bytes=16 << 10,
        parallel_reducers=4,
        reduce_memory_budget_bytes=128 << 10,
        part_upload_fanout=2,
    )


def cluster_smoke_plan(num_workers: int = 4, *, base=None, runs: int = 16):
    """(ExternalSortPlan, ClusterPlan) for cluster smoke runs.

    Takes an out-of-core plan (`base`, default ooc_smoke_plan()) and
    widens its reduce budget to the cluster-wide merge concurrency:
    num_workers x parallel_reducers scheduler slots all draw on one
    global budget, and the adaptive governor's feasibility floor is one
    record per spilled run per slot (`runs` = the job's wave count —
    callers that know their dataset pass the real value). Returns the
    widened plan plus a ClusterPlan partitioning it across `num_workers`
    emulated workers. Used by examples/cloudsort_oocore.py --workers;
    benchmarks/bench_cluster_scaling.py builds its own latency-injected
    variant. Lazily imported so configs stay importable without jax.
    """
    import dataclasses as _dc

    from repro_torch.shuffle.executor import ClusterPlan

    plan = base if base is not None else ooc_smoke_plan()
    slots = num_workers * plan.parallel_reducers
    budget = max(plan.reduce_memory_budget_bytes,
                 slots * max(runs, 1) * plan.record_bytes)
    plan = _dc.replace(plan, reduce_memory_budget_bytes=budget)
    return plan, ClusterPlan(num_workers=num_workers)


def smoke_fault_profile():
    """Fault injection scaled for CPU smoke runs (io/middleware.FaultProfile).

    Proportions mirror S3 — per-request latency, per-connection bandwidth,
    and GET/PUT token buckets tight enough that a smoke-scale run provokes
    real 503 SlowDowns and retries — but absolute values are shrunk ~100x
    so the injected stall adds seconds, not hours, to a laptop run.
    """
    from repro_torch.io.middleware import FaultProfile

    return FaultProfile(
        latency_s=0.0015,
        jitter_s=0.0005,
        bandwidth_bps=400e6,
        get_rate=60.0,
        put_rate=40.0,
        burst=12.0,
    )


def s3_fault_profile():
    """Realistic S3 parameters (the paper's us-west-2 regime): ~25 ms
    first-byte latency, ~90 MB/s per connection, 5500 GET/s and 3500
    PUT/s per prefix before 503 Slow Down. Use for full-scale dry runs
    and the fault benchmark's non-smoke mode, not for CPU smoke tests.
    """
    from repro_torch.io.middleware import FaultProfile

    return FaultProfile(
        latency_s=0.025,
        jitter_s=0.010,
        bandwidth_bps=90e6,
        get_rate=5500.0,
        put_rate=3500.0,
        burst=512.0,
    )
