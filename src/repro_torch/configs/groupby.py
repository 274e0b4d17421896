"""Smoke configuration for the group-by shuffle workload.

The group-by is the library's generality proof (shuffle/groupby.py): a
word-count-shaped keyed aggregation — skewed group keys, hash routing,
map-side combiner — running on the same tiered/faulty store stack as
CloudSort. These knobs size it for CPU smoke runs (tests, the example,
benchmarks/bench_groupby.py); scale `records`/`num_groups` up for real
measurements.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GroupByConfig:
    """Dataset shape: how many records, how many distinct groups, and
    how skewed the group-frequency distribution is (skew > 1
    concentrates mass on low group ids — the word-frequency shape)."""

    records: int = 1 << 17
    records_per_partition: int = 1 << 13
    num_groups: int = 4096
    skew: float = 2.0
    value_range: int = 8
    num_partitions: int = 16  # R: output partitions (hash ranges)


SMOKE = GroupByConfig()


def groupby_smoke_plan():
    """The ShufflePlan for smoke-scale group-by runs: one value word per
    record, chunked streaming small enough that every partition pays
    several fetch cycles, 4 concurrent merges under a global budget.
    Lazily imported so configs stay importable without the library."""
    from repro_torch.shuffle.api import ShufflePlan

    return ShufflePlan(
        payload_words=1,
        store_chunk_bytes=32 << 10,
        merge_chunk_bytes=4 << 10,
        output_part_records=1 << 10,
        parallel_reducers=4,
        reduce_memory_budget_bytes=256 << 10,
        part_upload_fanout=2,
    )
