"""The port's out-of-core CloudSort end to end against the JAX package:
gensort objects, spill runs with their reducer offsets, and output
partitions byte- and etag-identical, and a clean valsort.

The JAX sort_shuffle_job runs once, on an 8-device host mesh in a
module-scoped subprocess, at the sizes of tests/test_device_merge.py
(N = 2^15 records, waves of 2^13, W = 8, payload_words = 2). The port
runs in-process on the CPU (device="cpu": the kernels' plain versions)
under every schedule the reference pins: both reduce merges, 1 and 4
parallel reducers, 0 and 4 cluster workers, and a worker kill.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helpers import run_with_devices
from repro.core.external_sort import ExternalSortPlan as JaxPlan
from repro.data import gensort as jgensort
from repro.io.object_store import ObjectStore as JaxObjectStore
from repro_torch.core.external_sort import ExternalSortPlan, plan_from_reference
from repro_torch.data import gensort, valsort
from repro_torch.io.object_store import ObjectStore
from repro_torch.kernels import u32
from repro_torch.shuffle.executor import ClusterPlan
from repro_torch.shuffle.sort import sort_shuffle_job

torch.set_num_threads(2)

N = 1 << 15
PLAN = dict(
    records_per_wave=1 << 13,
    num_rounds=2,
    reducers_per_worker=2,
    payload_words=2,
    input_records_per_partition=1 << 12,
    output_part_records=1 << 11,
    store_chunk_bytes=16 << 10,
    parallel_reducers=2,
    reduce_memory_budget_bytes=64 << 10,
)


def _layout(store, prefix, with_meta=False):
    return [[m.key, m.etag, m.size, m.parts]
            + ([m.metadata] if with_meta else [])
            for m in store.list_objects("sort", prefix)]


# ---------------------------------------------------------------------------
# gensort: the same records, bytes and etags as the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skew", [None, "zipf", "dup"])
def test_gensort_objects_identical(skew, tmp_path):
    stores = {}
    for name, mod, cls, kw in (("jax", jgensort, JaxObjectStore, {}),
                               ("torch", gensort, ObjectStore,
                                {"device": "cpu"})):
        store = cls(str(tmp_path / name))
        store.create_bucket("sort")
        ck, parts = mod.write_to_store(store, "sort", "input/", 3 << 10,
                                       1 << 10, 5, start_id=2**32 - 1500,
                                       skew=skew, skew_seed=3, **kw)
        stores[name] = (tuple(int(c) for c in ck), parts,
                        _layout(store, "input/", with_meta=True))
    assert stores["torch"] == stores["jax"]


def test_gensort_functions_match_jax():
    ids = np.concatenate([np.arange(0, 300), 2**32 - np.arange(1, 300)]
                         ).astype(np.uint32)
    tid = u32.from_numpy(ids, "cpu")
    np.testing.assert_array_equal(
        u32.to_numpy(u32.narrow(gensort.splitmix32(tid))),
        jgensort.splitmix32(jnp.asarray(ids)))
    tk, ti = gensort.gen_keys(2**32 - 100, 200, "cpu")
    jk, ji = jgensort.gen_keys(2**32 - 100, 200)
    np.testing.assert_array_equal(u32.to_numpy(tk), jk)
    np.testing.assert_array_equal(u32.to_numpy(ti), ji)
    tp = gensort.gen_payload(tid, 23)
    jp = jgensort.gen_payload(jnp.asarray(ids), 23)
    np.testing.assert_array_equal(u32.to_numpy(tp), jp)
    for payload in (None, tp):
        jc = jgensort.checksum(jnp.asarray(ids), jnp.asarray(ids),
                               None if payload is None else jp)
        assert gensort.checksum(tid, tid, payload) == (int(jc[0]), int(jc[1]))
    assert gensort.combine_checksums((2**32 - 1, 5), (3, 6)) == \
        jgensort.combine_checksums((2**32 - 1, 5), (3, 6))
    np.testing.assert_array_equal(gensort.skewed_keys(ids, "clustered", 4),
                                  jgensort.skewed_keys(ids, "clustered", 4))


# ---------------------------------------------------------------------------
# end to end: the JAX job once, the port under every schedule
# ---------------------------------------------------------------------------

_JAX_JOB = """
import json
from repro.core.compat import make_mesh
from repro.core.external_sort import ExternalSortPlan
from repro.data import gensort
from repro.io.object_store import ObjectStore
from repro.shuffle.sort import sort_shuffle_job

plan = ExternalSortPlan(impl="ref", **json.loads({plan!r}))
store = ObjectStore({root!r})
store.create_bucket("sort")
in_ck, _ = gensort.write_to_store(store, "sort", plan.input_prefix, {n},
                                  plan.input_records_per_partition,
                                  plan.payload_words)
sort_shuffle_job(store, "sort", mesh=make_mesh((8,), ("w",)),
                 axis_names="w", plan=plan).run(workers=0)

def layout(prefix, meta=False):
    return [[m.key, m.etag, m.size, m.parts] + ([m.metadata] if meta else [])
            for m in store.list_objects("sort", prefix)]

with open({out!r}, "w") as f:
    json.dump({{"checksum": list(in_ck),
               "input": layout(plan.input_prefix, True),
               "spill": layout(plan.spill_prefix, True),
               "output": layout(plan.output_prefix)}}, f)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_job(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_job")
    out = os.path.join(d, "layout.json")
    run_with_devices(_JAX_JOB.format(plan=json.dumps(PLAN),
                                     root=str(d / "store"), n=N, out=out),
                     timeout=600)
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def port_store(tmp_path_factory):
    store = ObjectStore(str(tmp_path_factory.mktemp("port_store")))
    store.create_bucket("sort")
    plan = ExternalSortPlan(**PLAN)
    in_ck, _ = gensort.write_to_store(
        store, "sort", plan.input_prefix, N,
        plan.input_records_per_partition, plan.payload_words, device="cpu")
    return store, in_ck


SCHEDULES = {
    "numpy-P1": ("numpy", 1, {"workers": 0}),
    "numpy-P4": ("numpy", 4, {"workers": 0}),
    "device-P1": ("device", 1, {"workers": 0}),
    "device-P4": ("device", 4, {"workers": 0}),
    "numpy-W4": ("numpy", 2, {"workers": 4}),
    "device-W4": ("device", 2, {"workers": 4}),
    "device-kill": ("device", 2, {"cluster": ClusterPlan(
        num_workers=4, fail_after_tasks={1: 2})}),
}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_sort_job_identical_to_jax(schedule, jax_job, port_store):
    store, in_ck = port_store
    rmi, par, run_kw = SCHEDULES[schedule]
    plan = ExternalSortPlan(**dict(PLAN, parallel_reducers=par,
                                   reduce_merge_impl=rmi))
    assert list(in_ck) == jax_job["checksum"]
    assert _layout(store, plan.input_prefix, True) == jax_job["input"]
    rep = sort_shuffle_job(store, "sort", num_workers=8, plan=plan,
                           device="cpu").run(**run_kw)
    assert _layout(store, plan.spill_prefix, True) == jax_job["spill"]
    assert _layout(store, plan.output_prefix) == jax_job["output"]
    if "cluster" in run_kw:
        assert rep.failed_workers == ["w1"] and rep.reexecuted_tasks >= 1
    ps = (rep.report if hasattr(rep, "report") else rep).phase_seconds
    assert ps.get("map.device_sort", 0) > 0
    if rmi == "device":
        assert ps.get("reduce.device_merge", 0) > 0
    val = valsort.validate_from_store(store, "sort", plan.output_prefix,
                                      in_ck, device="cpu")
    assert val.ok and val.total_records == N, val


def test_sort_job_on_missing_cuda_raises(port_store):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda would not raise")
    store, _ = port_store
    with pytest.raises(RuntimeError, match="cuda"):
        sort_shuffle_job(store, "sort", num_workers=8,
                         plan=ExternalSortPlan(**PLAN), device="cuda")


def test_plan_from_reference_maps_impl():
    for jimpl, timpl in (("pallas", "kernel"), ("ref", "ref")):
        ref_plan = JaxPlan(impl=jimpl, **PLAN)
        plan = plan_from_reference(dataclasses.asdict(ref_plan))
        assert plan.impl == timpl
        assert {k: v for k, v in dataclasses.asdict(plan).items()
                if k != "impl"} == {k: v for k, v in
                                    dataclasses.asdict(ref_plan).items()
                                    if k != "impl"}
    with pytest.raises(ValueError, match="impl"):
        ExternalSortPlan(impl="pallas", **PLAN).validate()


def test_example_runs_on_cpu(tmp_path, capsys):
    from repro_torch.examples import cloudsort_oocore

    out = cloudsort_oocore.main(
        ["--records", str(1 << 16), "--device", "cpu", "--no-faults",
         "--reduce-merge-impl", "device", "--store", str(tmp_path)])
    assert out["valsort_ok"] and out["records"] == 1 << 16
    assert "[valsort] within=True across=True checksum=True" in \
        capsys.readouterr().out
