"""Training data pipeline with exoshuffle epoch shuffling.

Twin of src/repro/data/pipeline.py. The corpus is a deterministic
synthetic token stream (like gensort for text): token t of document i is
derivable from (i, t) alone, so any worker can materialize any slice
without I/O — the stand-in for a sharded tokenized corpus.

Epoch shuffling is the paper's sort applied to data loading: assign every
sample the key splitmix32(epoch_seed ^ sample_id) and (distributed-)sort
— a uniform random key makes CloudSort's range partition a perfect
shuffle. `device_epoch_shuffle` runs the port's `distributed_sort` (the
sort, partition and merge kernels on a card); the host iterator below
uses the same construction with numpy for the training loop, exactly as
the reference does.

Sequence packing: `length_sorted_batches` sorts variable-length documents
by length (same sort machinery) so batches pad minimally.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.gensort import splitmix32
from repro_torch.kernels import u32


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    num_samples: int = 1 << 20


def _np_splitmix32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x = (x ^ (x >> 16)) * np.uint32(0x85EBCA6B)
    x = (x ^ (x >> 13)) * np.uint32(0xC2B2AE35)
    return x ^ (x >> 16)


def _epoch_seed(epoch: int) -> int:
    return 0x9E3779B9 * (epoch + 1) & 0xFFFFFFFF


def shuffled_indices(epoch: int, n: int) -> np.ndarray:
    """The exoshuffle epoch permutation (host mirror of the device sort):
    sort sample ids by splitmix32(epoch_seed ^ id)."""
    ids = np.arange(n, dtype=np.uint32)
    keys = _np_splitmix32(ids ^ np.uint32(_epoch_seed(epoch)))
    return np.argsort(keys, kind="stable")


def sample_tokens(sample_ids: np.ndarray, seq_len: int, vocab: int) -> np.ndarray:
    """(n, seq_len+1) int32 tokens, deterministic in sample id."""
    base = sample_ids.astype(np.uint32)[:, None] * np.uint32(seq_len + 1)
    t = np.arange(seq_len + 1, dtype=np.uint32)[None, :]
    return (_np_splitmix32(base + t) % np.uint32(vocab)).astype(np.int32)


class TokenPipeline:
    """Deterministic, restartable batch source.

    State is just (epoch, step) — restart after failure resumes the exact
    stream. Batches are int32 tensors on `device` (default the card;
    raises without one, never falls back to the CPU).
    """

    def __init__(self, cfg: DataConfig, *, device="cuda"):
        self.cfg = cfg
        self.device = u32.resolve_device(device)
        self.steps_per_epoch = cfg.num_samples // cfg.global_batch
        self._epoch = -1
        self._perm = None

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        epoch = step // self.steps_per_epoch
        if epoch != self._epoch:
            self._perm = shuffled_indices(epoch, cfg.num_samples)
            self._epoch = epoch
        pos = (step % self.steps_per_epoch) * cfg.global_batch
        ids = self._perm[pos : pos + cfg.global_batch]
        toks = torch.from_numpy(sample_tokens(ids, cfg.seq_len, cfg.vocab))
        return {
            "tokens": toks[:, :-1].to(self.device),
            "labels": toks[:, 1:].to(self.device),
        }


def length_sorted_batches(lengths: np.ndarray, batch: int) -> np.ndarray:
    """Sequence packing: batch ids grouped by sorted length (the same sort,
    keyed by document length). Returns (n//batch, batch) sample ids."""
    order = np.argsort(lengths.astype(np.uint32), kind="stable")
    n = (len(order) // batch) * batch
    return order[:n].reshape(-1, batch)


def device_epoch_shuffle(sample_ids, epoch: int, *, num_workers: int,
                         impl: str = "kernel", device="cuda"):
    """Epoch shuffle through the port's distributed sort over W batched
    workers (the reference's mesh of W devices).

    sample_ids: (N,) uint32 (numpy or a u32 tensor), N divisible by W.
    Returns the permuted ids as an (N,) numpy uint32 array — the valid
    prefix of each worker segment, concatenated in worker order. Raises
    on a block overflow, as the reference does.
    """
    from repro_torch.core.exoshuffle import distributed_sort
    from repro_torch.data import valsort

    dev = u32.resolve_device(device)
    ids = u32.as_tensor(sample_ids, dev)
    keys = u32.narrow(splitmix32(u32.widen(ids) ^ _epoch_seed(epoch)))
    sk, si, counts, overflow = distributed_sort(
        keys, ids, num_workers=num_workers, impl=impl, device=dev)
    if overflow:
        raise RuntimeError("epoch shuffle block overflow — raise capacity_factor")
    _, out, _ = valsort.slice_segments(sk, si, counts)
    return np.concatenate(out).astype(np.uint32)
