"""Multi-worker cluster executor: the paper's 40-worker job, emulated.

Port of src/repro/core/cluster.py, the deprecated shim: `num_workers`
(the sort's W, a batch axis) and `device` take the place of the
reference's mesh and axis names; the warnings are the same.

Exoshuffle's headline CloudSort run is a 40-worker cluster whose
straggler/failure tolerance comes from the application re-scheduling its
own map/reduce tasks (paper §2.4, §2.6 — the freedom shuffle-as-a-library
buys). Since the library refactor the machinery lives in
src/repro_torch/shuffle/ and is workload-agnostic:

  * the Worker protocol, ThreadWorker, FaultyWorker, the stealing
    TaskPool, and the durable-confirmation phase driver are
    shuffle/executor.py (re-exported here under their old names);
  * the CloudSort task bodies are shuffle/sort.SortMapOp /
    MergeReduceOp, wrapping core/external_sort.WaveSorter and the
    streaming k-way merge;
  * single-host vs. cluster execution is one
    `ShuffleJob.run(workers=N)` call (shuffle/job.py).

`ClusterExecutor` / `cluster_external_sort` below are thin deprecated
shims over that call — byte- and etag-identical to the library call at
any worker count and under any non-total failure, which
tests/test_torch_fleet.py asserts. See shuffle/executor.py's docstrings for
the semantics (tasks, scheduling, failure recovery, re-execution); they
are unchanged.
"""
from __future__ import annotations

import warnings
from typing import Sequence

from repro_torch.core import external_sort as xs
from repro_torch.io.backends import StoreBackend
from repro_torch.shuffle.api import ClusterShuffleReport
from repro_torch.shuffle.executor import (ClusterFailure, ClusterPlan,
                                    FaultyWorker, TaskPool, ThreadWorker,
                                    Worker, WorkerFailure, build_workers)

# Backwards-compatible aliases (the classes moved to the shuffle library).
_TaskPool = TaskPool

#: A cluster run's report (renamed when the library was carved out; the
#: legacy `.sort` accessor still reads the inner report).
ClusterSortReport = ClusterShuffleReport


class ClusterExecutor:
    """DEPRECATED shim: partition one external sort across N emulated
    workers with failure recovery; output is byte-identical to the
    single-host driver. Build the job through the library instead —

        from repro_torch.shuffle.sort import sort_shuffle_job
        sort_shuffle_job(store, bucket, num_workers=W, plan=plan,
                         device=device).run(cluster=cluster)

    The constructor keeps its historical signature: `cluster` (a
    shuffle/executor.ClusterPlan) sizes the default ThreadWorker fleet
    and injects FaultyWorker deaths; `workers` supplies a hand-built
    fleet instead.
    """

    def __init__(self, store: StoreBackend, bucket: str, *,
                 num_workers: int, plan: xs.ExternalSortPlan,
                 device="cuda",
                 cluster: ClusterPlan = ClusterPlan(),
                 workers: Sequence[Worker] | None = None,
                 tracer=None):
        warnings.warn(
            "ClusterExecutor is a deprecated shim; use "
            "repro_torch.shuffle.sort.sort_shuffle_job(...).run(workers=N) or "
            ".run(cluster=ClusterPlan(...))",
            DeprecationWarning, stacklevel=2)
        self.store = store
        self.bucket = bucket
        self.num_workers = num_workers
        self.device = device
        self.plan = plan
        self.cluster = cluster
        self.workers = (list(workers) if workers is not None
                        else build_workers(store, cluster))
        self.tracer = tracer

    def sort(self) -> ClusterSortReport:
        from repro_torch.shuffle.sort import sort_shuffle_job

        job = sort_shuffle_job(self.store, self.bucket,
                               num_workers=self.num_workers, plan=self.plan,
                               tracer=self.tracer, device=self.device)
        return job.run(worker_list=self.workers)


def cluster_external_sort(
    store: StoreBackend,
    bucket: str,
    *,
    num_workers: int,
    plan: xs.ExternalSortPlan,
    device="cuda",
    cluster: ClusterPlan = ClusterPlan(),
    workers: Sequence[Worker] | None = None,
    tracer=None,
) -> ClusterSortReport:
    """DEPRECATED shim: build a ClusterExecutor and run the sort. Use
    `repro_torch.shuffle.sort.sort_shuffle_job(...).run(cluster=...)`."""
    warnings.warn(
        "cluster_external_sort() is a deprecated shim; use "
        "repro_torch.shuffle.sort.sort_shuffle_job(...).run(workers=N) or "
        ".run(cluster=ClusterPlan(...))",
        DeprecationWarning, stacklevel=2)
    return ClusterExecutor(
        store, bucket, num_workers=num_workers, plan=plan, device=device,
        cluster=cluster, workers=workers, tracer=tracer,
    ).sort()


__all__ = [
    "ClusterExecutor",
    "ClusterFailure",
    "ClusterPlan",
    "ClusterSortReport",
    "FaultyWorker",
    "ThreadWorker",
    "Worker",
    "WorkerFailure",
    "cluster_external_sort",
]
