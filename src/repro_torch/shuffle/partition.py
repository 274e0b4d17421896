"""Pluggable partitioners: range and hash routing over uint32 keys.

The sort needs order-preserving ranges (output partition j holds keys
below partition j+1's — CloudSort's contract); a group-by only needs
*stable, balanced* routing, and its key distribution is usually skewed
(word frequencies), so it hashes first. Both are the same construction —
`num_partitions - 1` internal boundaries over a routed uint32 domain —
differing only in the routing function, which is what makes the
partitioner contract small enough to test property-style
(tests/test_shuffle.py: exhaustive, non-overlapping coverage for every
implementation).

RangePartitioner's equal split reproduces core/keyspace.KeySpace's
reducer boundaries bit-for-bit (floor((j * 2^32) / P)) — the device-side
shuffle kernels and the host-side library route identically, which the
test suite asserts so the two can never drift.
"""
from __future__ import annotations

import numpy as np

from repro_torch.shuffle.api import Partitioner, require

KEY_BITS = 32
KEY_SPACE = 1 << KEY_BITS


def equal_boundaries(parts: int) -> np.ndarray:
    """(parts-1,) uint32 internal boundaries of an equal split of
    [0, 2^32) — floor((j * 2^32) / parts), the core/keyspace construction
    (host-side, no jax)."""
    js = np.arange(1, parts, dtype=np.uint64)
    return ((js * np.uint64(KEY_SPACE)) // np.uint64(parts)).astype(np.uint32)


def quantile_boundaries(sample: np.ndarray, parts: int) -> np.ndarray:
    """(parts-1,) uint32 internal boundaries from a routed-key sample —
    the host-side twin of core/keyspace.sampled_boundaries, bit-for-bit
    (sort, then take srt[(j * n) // parts]). A one-value sample is legal
    (all boundaries collapse); an empty sample is not.
    """
    srt = np.sort(np.asarray(sample, dtype=np.uint32).reshape(-1))
    n = srt.shape[0]
    require(n >= 1, "sample", n,
            "need at least one sampled key to estimate splitters")
    require(parts >= 1, "parts", parts, "must be >= 1")
    idx = (np.arange(1, parts, dtype=np.int64) * n) // parts
    return srt[idx]


def _splitmix32(x: np.ndarray) -> np.ndarray:
    """The gensort avalanche hash (data/gensort.splitmix32), host-side."""
    x = np.asarray(x, dtype=np.uint32)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


class RangePartitioner(Partitioner):
    """Order-preserving key ranges: equal split by default, or explicit
    boundaries (e.g. core/keyspace.sampled_boundaries quantiles for the
    Daytona-style skew fallback)."""

    def __init__(self, num_partitions: int,
                 boundaries: np.ndarray | None = None):
        require(num_partitions >= 1, "num_partitions", num_partitions,
                "must be >= 1")
        self.num_partitions = int(num_partitions)
        if boundaries is None:
            bounds = equal_boundaries(self.num_partitions)
        else:
            bounds = np.asarray(boundaries, dtype=np.uint32).reshape(-1)
            require(bounds.shape[0] == self.num_partitions - 1,
                    "boundaries", bounds.shape[0],
                    f"must supply num_partitions-1 = "
                    f"{self.num_partitions - 1} internal boundaries")
            require(bool(np.all(bounds[1:] >= bounds[:-1])),
                    "boundaries", bounds.tolist(),
                    "must be ascending (non-overlapping ranges)")
        self._bounds = bounds

    def boundaries(self) -> np.ndarray:
        return self._bounds


class HashPartitioner(Partitioner):
    """Uniform routing for skewed key sets: route through splitmix32,
    then equal ranges over the hashed domain. Not order-preserving in
    the raw key domain — use for keyed aggregation, not for sorting."""

    def __init__(self, num_partitions: int):
        require(num_partitions >= 1, "num_partitions", num_partitions,
                "must be >= 1")
        self.num_partitions = int(num_partitions)
        self._bounds = equal_boundaries(self.num_partitions)

    def boundaries(self) -> np.ndarray:
        return self._bounds

    def route(self, keys: np.ndarray) -> np.ndarray:
        return _splitmix32(keys)


__all__ = ["HashPartitioner", "RangePartitioner", "equal_boundaries",
           "quantile_boundaries"]
