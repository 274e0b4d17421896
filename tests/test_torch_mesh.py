"""The rank mesh (launch/mesh.py, core/collectives.py) and the sort's rank
path, on the CPU: G gloo processes, spawned by launch/mesh.spawn_ranks
with a FileStore under the test's tmp directory, W = 8 workers split
W/G a rank.

What must hold:

  (a) all_to_all_tiled and any_across for G in {1, 2, 4} equal the
      transpose and any(); worker_ids are the rank's global ids;
  (b) distributed_sort, streaming_sort and distributed_sort_payload
      ("through" and "late") for G in {2, 4}, gathered across ranks, are
      bit-identical to the mesh=None port and to the JAX reference's
      8-device shard_map run (tests/helpers.run_with_devices; the late
      mode's pad rows are unspecified there, so only its valid rows);
  (c) an input that overflows one rank's block only makes every rank
      report overflow, as the reference's pmax does;
  (d) the out-of-core sort at G in {2, 4}, with both reduce merges and
      on input whose ids are not contiguous, writes spill and output
      objects identical (etag, size, metadata) to the one-process run,
      valsort clean, with the store bytes read summed over ranks equal;
      the example drivers over ranks give the one-process outputs;
  (e) a rank that dies after joining makes the other raise within the
      group's timeout;
  (f) init_rank_mesh raises for nccl without a card, for nccl on the
      CPU, and for two NCCL ranks on one card, before joining a group.

Rank bodies live in tests/mesh_ranks.py, which imports no jax.
"""
import json
import multiprocessing
import os

import numpy as np
import pytest
import torch

import mesh_ranks
from helpers import run_with_devices
from repro_torch.core import exoshuffle as texo
from repro_torch.core.collectives import (all_to_all_tiled, any_across,
                                          worker_ids)
from repro_torch.core.external_sort import ExternalSortPlan
from repro_torch.core.streaming import streaming_sort
from repro_torch.data import gensort, valsort
from repro_torch.io import records as rec
from repro_torch.io.object_store import ObjectStore
from repro_torch.launch import mesh as tmesh
from repro_torch.shuffle.sort import sort_shuffle_job

torch.set_num_threads(2)

W = 8
N = 1 << 13
PW = 5


# ---------------------------------------------------------------------------
# (a) the collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 4])
def test_collectives_match_transpose_and_any(world):
    rng = np.random.default_rng(world)
    blocks = rng.integers(-2**31, 2**31, (W, W, 16)).astype(np.int32)
    rows = rng.integers(-2**31, 2**31, (W, W, 4, 3)).astype(np.int32)
    got = tmesh.spawn_ranks(mesh_ranks.collectives, world, blocks, rows)
    tb = all_to_all_tiled(torch.from_numpy(blocks)).numpy()
    tr = all_to_all_tiled(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(tb, blocks.transpose(1, 0, 2))
    np.testing.assert_array_equal(
        np.concatenate([g["blocks"] for g in got]), tb)
    np.testing.assert_array_equal(
        np.concatenate([g["rows"] for g in got]), tr)
    np.testing.assert_array_equal(np.concatenate([g["ids"] for g in got]),
                                  np.arange(W))
    for g in got:
        assert (g["none"], g["last"], g["all"]) == (False, True, True)
        assert [x["what"] for x in g["log"]] == ["blocks", "rows"]
        assert g["log"][0]["bytes"] == blocks.nbytes // world
        assert all(x["clock"] == "host" and x["ms"] >= 0 for x in g["log"])
    assert not any_across(torch.zeros(4, dtype=torch.bool))
    assert any_across(torch.tensor([False, True]))
    assert worker_ids(None, W, "cpu").tolist() == list(range(W))


# ---------------------------------------------------------------------------
# (b), (c) the in-memory sorts
# ---------------------------------------------------------------------------

# name: (kind, ShuffleConfig fields beside W and impl)
CASES = {
    "dist": ("dist", dict(reducers_per_worker=2)),
    "stream": ("stream", dict(reducers_per_worker=2, num_rounds=2)),
    "through": ("through", dict(reducers_per_worker=2)),
    "late": ("late", dict(reducers_per_worker=2)),
    "overflow": ("dist", dict(reducers_per_worker=2)),
}


def _inputs(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    keys = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    if name == "overflow":
        # worker 0 (on rank 0 at any G) sends all its records to itself
        keys[:N // W] >>= 3
    vals = (np.arange(N, dtype=np.uint32) if CASES[name][0] in
            ("through", "late") else rng.permutation(N).astype(np.uint32))
    payload = rng.integers(0, 2**32, (N, PW), dtype=np.uint64).astype(
        np.uint32)
    return {"keys": keys, "vals": vals, "payload": payload}


def _port(name, inp):
    kind, fields = CASES[name]
    cfg = texo.ShuffleConfig(num_workers=W, impl="kernel", **fields)
    if kind == "dist":
        res = texo.distributed_sort(inp["keys"], inp["vals"], num_workers=W,
                                    cfg=cfg, device="cpu")
    elif kind == "stream":
        res = streaming_sort(inp["keys"], inp["vals"], num_workers=W,
                             num_rounds=cfg.num_rounds, cfg=cfg,
                             device="cpu")
    else:
        res = texo.distributed_sort_payload(
            inp["keys"], inp["vals"], inp["payload"], num_workers=W,
            mode=kind, cfg=cfg, device="cpu")
    return tuple(t.numpy() if isinstance(t, torch.Tensor) else t
                 for t in res)


_JAX = """
import json
import numpy as np
import jax
from repro.core.compat import make_mesh
from repro.core.exoshuffle import (ShuffleConfig, distributed_sort,
                                   distributed_sort_payload)
from repro.core.streaming import streaming_sort

mesh = make_mesh((8,), ("w",))
d = np.load({inp!r})
out = {{}}
for name, (kind, fields) in json.loads({cases!r}).items():
    cfg = ShuffleConfig(num_workers=8, impl="ref", **fields)
    k, v, p = d[name + "_keys"], d[name + "_vals"], d[name + "_payload"]
    if kind == "dist":
        fn = jax.jit(lambda k, v: distributed_sort(
            k, v, mesh=mesh, axis_names="w", cfg=cfg))
        res = fn(k, v)
    elif kind == "stream":
        fn = jax.jit(lambda k, v: streaming_sort(
            k, v, mesh=mesh, axis_names="w", num_rounds=cfg.num_rounds,
            cfg=cfg))
        res = fn(k, v)
    else:
        fn = jax.jit(lambda k, v, p: distributed_sort_payload(
            k, v, p, mesh=mesh, axis_names="w", mode=kind, cfg=cfg))
        res = fn(k, v, p)
    for i, a in enumerate(res):
        out[f"{{name}}_{{i}}"] = np.asarray(a)
np.savez({outp!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_sorts(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_mesh")
    inp, outp = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
    np.savez(inp, **{f"{name}_{k}": a for name in CASES
                     for k, a in _inputs(name).items()})
    run_with_devices(_JAX.format(inp=inp, outp=outp,
                                 cases=json.dumps(CASES)), timeout=600)
    got = np.load(outp)
    return {name: tuple(got[f"{name}_{i}"] for i in range(
        5 if CASES[name][0] in ("through", "late") else 4))
        for name in CASES}


@pytest.fixture(scope="module", params=[2, 4], ids=lambda g: f"G{g}")
def rank_sorts(request):
    cases = {name: (CASES[name][0], _inputs(name),
                    dict(CASES[name][1], num_workers=W, impl="kernel"))
             for name in CASES}
    return request.param, tmesh.spawn_ranks(mesh_ranks.sorts, request.param,
                                            cases)


def _gathered(ranks, name):
    """The ranks' outputs of case `name` in rank order, as the one-process
    layout; every rank's overflow flag separately."""
    per = [r[name] for r in ranks]
    arrays = tuple(np.concatenate([p[i] for p in per])
                   for i in range(len(per[0]) - 1))
    return arrays, [p[-1] for p in per]


@pytest.mark.parametrize("name", ["dist", "stream", "through", "late"])
def test_rank_sorts_match_port_and_jax_mesh(name, rank_sorts, jax_sorts):
    world, ranks = rank_sorts
    arrays, flags = _gathered(ranks, name)
    want = _port(name, _inputs(name))
    assert flags == [want[-1]] * world == [False] * world
    for got, ref in zip(arrays, want[:-1]):
        np.testing.assert_array_equal(got, ref)
    jax = jax_sorts[name]
    assert bool(jax[-1]) is False
    u = [a.view(np.uint32) if a.dtype == np.int32 else a for a in arrays]
    counts = u[-1]
    np.testing.assert_array_equal(counts, jax[-2])
    np.testing.assert_array_equal(u[0], jax[0])
    np.testing.assert_array_equal(u[1], jax[1])
    if name == "through":
        np.testing.assert_array_equal(u[2], jax[2])
    elif name == "late":  # pad rows are unspecified in the reference
        seg = u[2].shape[0] // W
        for w in range(W):
            rows = slice(w * seg, w * seg + int(counts[w]))
            np.testing.assert_array_equal(u[2][rows], jax[2][rows])


def test_overflow_on_one_rank_reaches_every_rank(rank_sorts, jax_sorts):
    world, ranks = rank_sorts
    _, flags = _gathered(ranks, "overflow")
    assert flags == [True] * world
    assert _port("overflow", _inputs("overflow"))[-1] is True
    assert bool(jax_sorts["overflow"][-1]) is True


# ---------------------------------------------------------------------------
# (d) the out-of-core sort over ranks
# ---------------------------------------------------------------------------

OOC_RECORDS = 1 << 14
PLAN = dict(records_per_wave=1 << 13, num_rounds=2, reducers_per_worker=2,
            payload_words=4, impl="kernel", input_records_per_partition=1 << 12,
            output_part_records=1 << 10, store_chunk_bytes=16 << 10,
            merge_chunk_bytes=8 << 10, parallel_reducers=2)
# tag: (input prefix, reduce merge)
OOC_JOBS = {"numpy": ("in/", "numpy"), "device": ("in/", "device"),
            "perm": ("perm/", "numpy")}


def _plan(prefix, tag):
    inp, rmi = OOC_JOBS[tag]
    return ExternalSortPlan(input_prefix=inp, spill_prefix=f"{prefix}-{tag}/s/",
                            output_prefix=f"{prefix}-{tag}/o/",
                            reduce_merge_impl=rmi, **PLAN)


def _objects(store, prefix, bucket="b"):
    """(key under prefix, etag, size, parts, metadata) of each object."""
    return [(m.key[len(prefix):], m.etag, m.size, m.parts, m.metadata)
            for m in store.list_objects(bucket, prefix)]


@pytest.fixture(scope="module")
def ooc_one_process(tmp_path_factory):
    """The input (gensort's, and one with permuted ids) and the
    one-process run of every job."""
    root = str(tmp_path_factory.mktemp("ooc"))
    store = ObjectStore(root)
    store.create_bucket("b")
    checks = {"in/": gensort.write_to_store(
        store, "b", "in/", OOC_RECORDS, PLAN["input_records_per_partition"],
        PLAN["payload_words"], device="cpu")[0]}
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**32, OOC_RECORDS, dtype=np.uint64).astype(
        np.uint32)
    ids = rng.permutation(OOC_RECORDS).astype(np.uint32) * 7 + 11
    payload = rng.integers(0, 2**32, (OOC_RECORDS, PLAN["payload_words"]),
                           dtype=np.uint64).astype(np.uint32)
    part = PLAN["input_records_per_partition"]
    for p, lo in enumerate(range(0, OOC_RECORDS, part)):
        sl = slice(lo, lo + part)
        store.put("b", f"perm/part-{p:05d}",
                  rec.encode_records(keys[sl], ids[sl], payload[sl]))
    checks["perm/"] = gensort.checksum(torch.from_numpy(keys.view(np.int32)),
                                       torch.from_numpy(ids.view(np.int32)),
                                       torch.from_numpy(payload.view(
                                           np.int32)))
    reads = {}
    for tag in OOC_JOBS:
        rep = sort_shuffle_job(store, "b", num_workers=W,
                               plan=_plan("one", tag), device="cpu").run()
        reads[tag] = rep.stats.bytes_read
    return root, checks, reads


@pytest.fixture(scope="module", params=[2, 4], ids=lambda g: f"G{g}")
def ooc_ranks(request, ooc_one_process):
    world = request.param
    root = ooc_one_process[0]
    jobs = [(tag, _plan(f"g{world}", tag)) for tag in OOC_JOBS]
    got = tmesh.spawn_ranks(mesh_ranks.oocore, world, root, jobs)
    return world, got


@pytest.mark.parametrize("tag", list(OOC_JOBS))
def test_oocore_ranks_identical_to_one_process(tag, ooc_ranks,
                                               ooc_one_process):
    world, ranks = ooc_ranks
    root, checks, reads = ooc_one_process
    store = ObjectStore(root)
    for kind in ("s", "o"):
        one = _objects(store, f"one-{tag}/{kind}/")
        got = _objects(store, f"g{world}-{tag}/{kind}/")
        assert len(one) == 2 * W  # 2 waves x W spills; W x R1 outputs
        assert got == one, (tag, kind)
    rep = ranks[0][tag]
    assert all(r[tag] == rep for r in ranks)
    assert rep["bytes_read"] == reads[tag]
    assert (rep["spill_objects"], rep["output_objects"], rep["num_workers"],
            rep["num_reducers"]) == (2 * W, 2 * W, W, 2 * W)
    val = valsort.validate_from_store(
        store, "b", f"g{world}-{tag}/o/", checks[OOC_JOBS[tag][0]],
        chunk_records=1 << 10, device="cpu")
    assert val.ok and val.total_records == OOC_RECORDS


def test_oocore_example_over_ranks(tmp_path):
    from repro_torch.examples import cloudsort_oocore

    argv = ["--records", str(1 << 15), "--waves", "4", "--device", "cpu",
            "--no-faults", "--reduce-merge-impl", "device"]
    one = cloudsort_oocore.main(argv + ["--store", str(tmp_path / "one")])
    two = cloudsort_oocore.main(argv + ["--store", str(tmp_path / "two"),
                                        "--ranks", "2", "--backend", "gloo"])
    assert one["valsort_ok"] and two["valsort_ok"]
    assert (one["ranks"], two["ranks"][1]["rank"]) == (1, 1)
    for r in two["ranks"]:  # 4 waves x (2 rounds x 3 + 2 payload exchanges)
        assert [x["what"] for x in r["exchanges"]] == 4 * (
            2 * ["keys", "vals", "counts"] + ["requests", "rows"])
    for tier, prefix in (("durable", "output/"), ("ssd", "spill/")):
        lay = [_objects(ObjectStore(str(tmp_path / run / tier)), prefix,
                        "cloudsort") for run in ("one", "two")]
        assert lay[0] and lay[0] == lay[1]


@pytest.mark.parametrize("mode", ["through", "late"])
def test_e2e_example_over_ranks(mode):
    from repro_torch.examples import cloudsort_e2e

    argv = ["--records", str(1 << 13), "--device", "cpu",
            "--payload-mode", mode]
    one = cloudsort_e2e.main(argv)
    two = cloudsort_e2e.main(argv + ["--ranks", "2"])
    assert one["valsort_ok"] and two["valsort_ok"]
    assert (one["ranks"], two["ranks"]) == (1, 2)
    assert two["digest"] == one["digest"]
    assert two["checksum"] == one["checksum"]


# ---------------------------------------------------------------------------
# (e) a dead rank, (f) refusals
# ---------------------------------------------------------------------------


def test_dead_rank_makes_the_other_raise(tmp_path):
    timeout_s = 5.0
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=mesh_ranks.dead_rank,
                         args=(r, 2, str(tmp_path / "rdzv"), str(tmp_path),
                               timeout_s)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(60)
        assert [p.exitcode for p in procs] == [0, 3]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    seconds, err = (tmp_path / "rank0.txt").read_text().splitlines()
    assert err != "None", "the all_to_all with a dead peer returned"
    assert float(seconds) < timeout_s + 10


def test_init_rank_mesh_refuses_nccl_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("nccl", None):
        with pytest.raises(RuntimeError, match="is_available"):
            tmesh.init_rank_mesh(W, backend=backend, device="cuda", rank=0,
                                 world=1, store_path=str(tmp_path / "s"))
    with pytest.raises(ValueError, match="gloo"):
        tmesh.init_rank_mesh(W, backend="nccl", device="cpu", rank=0,
                             world=1, store_path=str(tmp_path / "s"))


def test_init_rank_mesh_refuses_two_nccl_ranks_on_one_card(tmp_path,
                                                           monkeypatch):
    def joined(*a, **k):
        raise AssertionError("init_process_group reached")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.distributed, "init_process_group", joined)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    for rank, device in ((0, "cuda"), (1, "cuda"), (1, "cuda:0")):
        with pytest.raises(ValueError, match="share a card"):
            tmesh.init_rank_mesh(W, backend="nccl", device=device, rank=rank,
                                 world=2, store_path=str(tmp_path / "s"))
    with pytest.raises(ValueError, match="divide evenly"):
        tmesh.init_rank_mesh(W, backend="gloo", device="cpu", rank=0,
                             world=3, store_path=str(tmp_path / "s"))


def test_init_rank_mesh_reads_torchrun_env(tmp_path, monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tmesh.under_torchrun()
    mesh = tmesh.init_rank_mesh(W, device="cpu",
                                store_path=str(tmp_path / "s"))
    try:
        assert (mesh.rank, mesh.world, mesh.backend, mesh.device.type,
                mesh.workers_per_rank, mesh.worker_lo) == (
                    0, 1, "gloo", "cpu", W, 0)
        assert mesh.share(16) == (0, 16)
        assert tmesh.flat_axes_of(mesh) == ("workers",)
        mesh.barrier()
    finally:
        mesh.close()
    assert not torch.distributed.is_initialized()


def test_kernel_build_compiles_once_for_concurrent_builders(tmp_path,
                                                            monkeypatch):
    """Ranks start together and all need the kernels: the build's file
    lock lets one compile each source (here a stand-in nvcc that counts
    its calls and takes a while) and the others find the libraries."""
    import threading

    from repro_torch.kernels import _build

    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text('#!/bin/sh\nout=""\nwhile [ $# -gt 0 ]; do\n'
                    '  [ "$1" = "-o" ] && out="$2"\n  shift\ndone\n'
                    'echo x >> "$COUNT_FILE"\nsleep 0.3\necho lib > "$out"\n')
    nvcc.chmod(0o755)
    count = tmp_path / "count"
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv("COUNT_FILE", str(count))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(_build, "build_info", {})
    outs, errors = [], []

    def builder():
        try:
            outs.append(_build.build())
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=builder) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(outs)) == 1 and len(outs) == 4
    assert len(count.read_text().split()) == len(_build.SOURCES)
    assert all((outs[0] / f"lib{n}.so").exists() for n in _build.SOURCES)
