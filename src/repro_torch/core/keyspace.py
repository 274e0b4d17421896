"""Range partitioner over the uint32 key space (paper §2.2).

Port of src/repro/core/keyspace.py. The key space [0, 2^32) splits into
R equal reducer ranges, grouped R1 = R/W per worker:

  - R reducer ranges: range j covers [j * 2^32/R, (j+1) * 2^32/R).
  - W worker ranges: worker w owns reducer ranges [w*R1, (w+1)*R1).

Boundaries are *internal* (R-1 / W-1 values): the count below the last
(2^32) boundary is always n, so it is implicit. `sampled_boundaries` is
the Daytona-style fallback for skewed data. Boundary vectors are u32
tensors (int32 bit storage, see kernels/u32.py) on the `device` asked
for; routing runs on the keys' device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import u32

KEY_BITS = 32
KEY_SPACE = 1 << KEY_BITS


@dataclasses.dataclass(frozen=True)
class KeySpace:
    """The paper's (R, W) range partition of the sort key space.

    `boundaries`, when given, replaces the equal split with R-1 explicit
    ascending uint32 reducer boundaries (the sampled quantiles from
    `sampled_boundaries`): worker boundaries become every R1-th reducer
    boundary and key routing falls back from the power-of-two shift form
    to a searchsorted over the same values.
    """

    num_reducers: int  # R
    num_workers: int  # W
    boundaries: tuple[int, ...] | None = None  # R-1 explicit reducer bounds

    def __post_init__(self):
        assert self.num_reducers % self.num_workers == 0, (
            "R must be a multiple of W (paper: R1 = R/W reducer ranges per worker)"
        )
        if self.boundaries is not None:
            b = self.boundaries
            if len(b) != self.num_reducers - 1:
                raise ValueError(
                    f"boundaries={len(b)} values: must supply "
                    f"num_reducers-1 = {self.num_reducers - 1} internal "
                    "boundaries")
            if any(b[i + 1] < b[i] for i in range(len(b) - 1)):
                raise ValueError(
                    f"boundaries={b!r}: must be ascending "
                    "(non-overlapping ranges)")

    @property
    def reducers_per_worker(self) -> int:  # R1
        return self.num_reducers // self.num_workers

    def reducer_boundaries(self, device="cuda") -> torch.Tensor:
        """(R-1,) u32 internal boundaries of the reducer ranges."""
        if self.boundaries is not None:
            return u32.from_numpy(np.asarray(self.boundaries, np.uint32),
                                  device)
        return _equal_boundaries(self.num_reducers, device)

    def worker_boundaries(self, device="cuda") -> torch.Tensor:
        """(W-1,) u32 internal boundaries of the worker ranges."""
        if self.boundaries is not None:
            # Worker w's upper boundary is reducer boundary (w+1)*R1 - 1:
            # every R1-th entry of the full reducer boundary vector.
            full = np.asarray(self.boundaries, np.uint32)
            r1 = self.reducers_per_worker
            return u32.from_numpy(full[r1 - 1::r1], device)
        return _equal_boundaries(self.num_workers, device)

    def local_reducer_boundaries(self, device="cuda") -> torch.Tensor:
        """(W, R1-1) u32: per-worker internal boundaries of its R1 ranges."""
        full = u32.to_numpy(self.reducer_boundaries("cpu")).reshape(-1)
        r1 = self.reducers_per_worker
        out = np.stack([full[w * r1:(w + 1) * r1 - 1]
                        for w in range(self.num_workers)])
        return u32.from_numpy(out, device)

    def worker_of_key(self, keys: torch.Tensor) -> torch.Tensor:
        """Destination worker id (int32) for each u32 key — the paper's
        routing function: the exact shift form for power-of-two W with
        equal boundaries, else a searchsorted side="right" over the
        worker boundaries (consistent with `partition_sorted` slicing)."""
        return self._route(keys, self.num_workers, self.worker_boundaries)

    def reducer_of_key(self, keys: torch.Tensor) -> torch.Tensor:
        return self._route(keys, self.num_reducers, self.reducer_boundaries)

    def _route(self, keys, parts: int, bounds) -> torch.Tensor:
        if parts == 1:
            return torch.zeros(keys.shape, dtype=torch.int32,
                               device=keys.device)
        k = u32.widen(keys)
        if self.boundaries is None and parts & (parts - 1) == 0:
            shift = KEY_BITS - (parts.bit_length() - 1)
            return (k >> shift).to(torch.int32)
        b = u32.widen(bounds(keys.device))
        return torch.searchsorted(b, k, right=True).to(torch.int32)


def _equal_boundaries(parts: int, device="cuda") -> torch.Tensor:
    """(parts-1,) u32 internal boundaries of an equal split of [0, 2^32)."""
    js = np.arange(1, parts, dtype=np.uint64)
    bounds = (js * np.uint64(KEY_SPACE)) // np.uint64(parts)
    return u32.from_numpy(bounds.astype(np.uint32), device)


def sampled_boundaries(sample_keys: torch.Tensor, parts: int) -> torch.Tensor:
    """Daytona-style splitter estimation: quantiles of a u32 key sample.

    Returns (parts-1,) u32 internal boundaries on the sample's device. A
    one-key sample is legal (all boundaries collapse to that key); an
    empty sample is not.
    """
    srt, _ = torch.sort(u32.widen(sample_keys.reshape(-1)))
    n = srt.shape[0]
    if n == 0:
        raise ValueError(
            f"sample_keys={n} keys: need at least one sampled key to "
            "estimate splitters")
    if parts < 1:
        raise ValueError(f"parts={parts}: must be >= 1")
    idx = (torch.arange(1, parts, device=srt.device) * n) // parts
    return u32.narrow(srt[idx])
