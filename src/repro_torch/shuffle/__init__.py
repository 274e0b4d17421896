"""Shuffle-as-a-library: the generic dataflow API carved out of the
sort-specific drivers (Exoshuffle's thesis, applied to this repo).

The paper argues shuffle belongs in an application-level library, not a
monolithic engine — the application brings its operators, the library
brings staging, scheduling, memory governance, and fault recovery. This
package is that library:

  api.py        — operator protocols (MapOp / CombineOp / ReduceOp /
                  Partitioner / PartitionReducer), the generic
                  ShufflePlan, unified plan validation (`require`), and
                  the ShuffleReport / ClusterShuffleReport contracts.
  partition.py  — pluggable partitioners: RangePartitioner (equal or
                  sampled key ranges) and HashPartitioner (uniform
                  routing for skewed key sets).
  runtime.py    — the engine room: span timeline, job control, the
                  AdaptiveBudgetGovernor, streaming run cursors, the
                  generic ReduceScheduler, and the staged map loop.
  executor.py   — multi-worker execution: the Worker protocol,
                  ThreadWorker / FaultyWorker, task stealing, and the
                  phase driver with durable-confirmation re-execution.
  job.py        — the front end: ShuffleJob / ShuffleSession owning
                  plan validation, staging, the budget governor, span
                  timelines, and single-host vs. cluster execution
                  behind one `job.run(workers=N)` call.
  sort.py       — CloudSort as one instantiation: SortMapOp /
                  MergeReduceOp wrapping core/external_sort's
                  WaveSorter and streaming-merge bodies.
  groupby.py    — a second workload, proving generality: streaming
                  group-by aggregation (word-count-style keyed reduce
                  with a map-side combiner) on the same store stack.

Workload modules import lazily where they need jax, so group-by (pure
numpy) never pays for the device toolchain.
"""
from repro_torch.shuffle.api import (ClusterShuffleReport, CombineOp, MapOp,
                               Partitioner, PartitionReducer, ReduceOp,
                               ShufflePlan, ShuffleReport, require,
                               validate_dataflow_plan)
from repro_torch.shuffle.executor import (ClusterFailure, ClusterPlan, FaultyWorker,
                                    ThreadWorker, Worker, WorkerFailure)
from repro_torch.shuffle.job import ShuffleJob, ShuffleSession
from repro_torch.shuffle.partition import HashPartitioner, RangePartitioner

__all__ = [
    "ClusterFailure",
    "ClusterPlan",
    "ClusterShuffleReport",
    "CombineOp",
    "FaultyWorker",
    "HashPartitioner",
    "MapOp",
    "Partitioner",
    "PartitionReducer",
    "RangePartitioner",
    "ReduceOp",
    "ShuffleJob",
    "ShufflePlan",
    "ShuffleReport",
    "ShuffleSession",
    "ThreadWorker",
    "Worker",
    "WorkerFailure",
    "require",
    "validate_dataflow_plan",
]
