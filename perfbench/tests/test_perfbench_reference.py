"""The frozen generators and the plain reference, against the port run
at tiny sizes on the CPU with its torch oracles (impl="ref")."""
import functools

import numpy as np
import pytest
import torch

from perfbench.reference import gen
from perfbench.reference import sort as ref


@pytest.mark.parametrize("shape", gen.KEY_SHAPES)
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_torch_and_numpy_generators_agree(shape, seed):
    ids = np.arange(5000, 9096, dtype=np.uint32)
    k, i, p = gen.records_t(5000, 4096, seed, shape, "cpu", chunk=1000)
    assert np.array_equal(k.numpy().view(np.uint32),
                          gen.keys_np(ids, seed, shape))
    assert np.array_equal(i.numpy().view(np.uint32), ids)
    assert np.array_equal(p.numpy().view(np.uint32), gen.payload_np(ids, seed))
    hk, hi = gen.headers_t(5000, 4096, seed, shape, "cpu")
    assert torch.equal(hk, k) and torch.equal(hi, i)


def test_seeds_change_the_records_and_repeat():
    a = gen.records_t(0, 1024, 11, "uniform", "cpu")
    b = gen.records_t(0, 1024, 11, "uniform", "cpu")
    c = gen.records_t(0, 1024, 12, "uniform", "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[2], c[2])


def test_uniform_keys_repeat_like_random_keys():
    ids = np.arange(1 << 20, dtype=np.uint32)
    uni = gen.keys_np(ids, 99, "uniform")
    assert 0 < ids.size - np.unique(uni).size < 1000  # ~2^40 / 2^33 = 128
    counts = np.bincount(uni >> np.uint32(28), minlength=16)
    assert counts.min() > 0.9 * counts.mean()
    with pytest.raises(ValueError, match="key shape"):
        gen.keys_np(ids[:4], 99, "zipf")


def test_reference_order_is_the_lexicographic_unsigned_order():
    keys = torch.tensor([5, -1, 5, 0, -2], dtype=torch.int32)  # -1 = 2^32-1
    ids = torch.tensor([9, 1, 2, 3, -1], dtype=torch.int32)
    sk, si = ref.lex_order(keys, ids)
    assert sk.tolist() == [0, 5, 5, 2**32 - 2, 2**32 - 1]
    assert si.tolist() == [3, 2, 9, 2**32 - 1, 1]
    tk, _ = ref.lex_order(keys, ids, key_bits=1)  # top bit only: ties by id
    assert tk.tolist() == [5, 0, 5, 2**32 - 1, 2**32 - 2]


def test_equal_bounds_are_the_port_keyspace():
    from repro_torch.core.keyspace import KeySpace

    for parts in (2, 8, 32):
        ks = KeySpace(num_reducers=parts, num_workers=1)
        port = ks.reducer_boundaries("cpu").numpy().view(np.uint32)
        assert np.array_equal(ref.equal_bounds(parts), port.astype(np.int64))


@pytest.mark.parametrize("workload", ["indy.resident"])
def test_port_oracles_pass_the_check(workload, small_cell):
    from perfbench.lib import spec

    cell = small_cell(workload)
    out = spec.driver(cell.traffic).run(
        cell, seed=2**31 + 77, seconds=0.1, trace=False, t0=0.0,
        device="cpu", wrap=lambda sort: functools.partial(sort, impl="ref"))
    assert out.correct, out.checks
    assert out.checks[0].name == "mismatched_records"


def test_compare_counts_wrong_missing_and_extra_records():
    k, i = gen.headers_t(0, 64, 3, "uniform", "cpu")
    sk, si = ref.lex_order(k, i)
    starts = np.array([0, 30, 64])
    pay = gen.payload_t(si, 3)
    good = [(sk[:30], si[:30], pay[:30], 30), (sk[30:], si[30:], pay[30:], 34)]
    assert ref.compare_segments(good, sk, si, starts, 3) == 0
    flipped = pay.clone()
    flipped[40, 5] ^= 1
    bad = [good[0], (sk[30:], si[30:], flipped[30:], 34)]
    assert ref.compare_segments(bad, sk, si, starts, 3) == 1
    short = [good[0], (sk[30:], si[30:], pay[30:], 30)]
    assert ref.compare_segments(short, sk, si, starts, 3) == 4
    assert ref.compare_segments([good[0], None], sk, si, starts, 3) == 34

