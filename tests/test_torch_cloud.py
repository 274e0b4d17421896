"""The port's cloud layer against the JAX package: FakeS3Backend and the
gated remote backends (copies), and the serverless FunctionWorker.

FakeS3Backend's knob, part-size and slowdown semantics are held to the
reference's own unit tests (tests/test_cloud.py), run against the
port's classes. One JSON invocation event drives both packages'
`invoke` (the port's through `event_from_reference`) over one
filesystem store, in-process. The JAX InvocationDriver runs each fleet
schedule once — clean, an invocation budget exhausted at a pop, a store
view severed mid-invocation — in a module-scoped subprocess on an
8-device host mesh; the port's fleet runs the same schedules on the CPU
and must write the same output layout (keys, CRC etags, sizes, part
counts) as that run and as the port's own single-host sort.
"""
import dataclasses
import json
import os

import pytest
import torch

import test_cloud as ref_cloud
from helpers import REPO, run_with_devices
from repro_torch import cloud
from repro_torch.cloud import remote
from repro_torch.core.external_sort import ExternalSortPlan
from repro_torch.data import gensort, valsort
from repro_torch.io import backends, middleware
from repro_torch.io.middleware import MetricsMiddleware
from repro_torch.shuffle.sort import sort_shuffle_job

torch.set_num_threads(2)

N = 1 << 15  # 4 map tasks; 16 output partitions
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
# schedule: InvocationDriver keyword arguments (4 functions each)
FLEETS = {
    "clean": {},
    "kill_at_pop": {"die_after_invocations": {0: 3}},
    "kill_mid_invocation": {"fail_after_requests": {1: 40}},
}

_JAX = """
import json
from repro.cloud import FakeS3Backend, InvocationDriver
from repro.core.external_sort import ExternalSortPlan
from repro.data import gensort
from repro.io.middleware import MetricsMiddleware

plan = ExternalSortPlan(impl="ref", **json.loads({plan!r}))
store = MetricsMiddleware(FakeS3Backend(chunk_size=16 << 10))
store.create_bucket("sort")
gensort.write_to_store(store, "sort", plan.input_prefix, {n},
                       plan.input_records_per_partition, plan.payload_words)
out = {{}}
for tag, kw in json.loads({fleets!r}).items():
    kw = {{k: {{int(i): v for i, v in d.items()}} for k, d in kw.items()}}
    drv = InvocationDriver(store, "sort", plan=plan, workers=4,
                           mesh_devices=8, axis="w", **kw)
    crep = drv.run()
    out[tag] = [[m.key, m.etag, m.size, m.parts]
                for m in store.list_objects("sort", plan.output_prefix)]
    out[tag + "_failed"] = crep.failed_workers
    out[tag + "_committed"] = sum(r.committed for r in drv.invocations())
with open({outp!r}, "w") as f:
    json.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_cloud")
    outp = os.path.join(d, "out.json")
    run_with_devices(_JAX.format(plan=json.dumps(PLAN), n=N,
                                 fleets=json.dumps(FLEETS), outp=outp),
                     timeout=600)
    with open(outp) as f:
        return json.load(f)


def _layout(store, prefix):
    return [[m.key, m.etag, m.size, m.parts]
            for m in store.list_objects("sort", prefix)]


class _Port:
    """A FakeS3 store with the input, and the port's single-host output."""

    def __init__(self):
        self.plan = ExternalSortPlan(**PLAN)
        self.store = MetricsMiddleware(
            cloud.FakeS3Backend(chunk_size=16 << 10))
        self.store.create_bucket("sort")
        self.in_ck, _ = gensort.write_to_store(
            self.store, "sort", self.plan.input_prefix, N,
            self.plan.input_records_per_partition, self.plan.payload_words,
            device="cpu")
        sort_shuffle_job(self.store, "sort", num_workers=8, plan=self.plan,
                         device="cpu").run(workers=0)
        self.single = self.layout()

    def layout(self):
        return _layout(self.store, self.plan.output_prefix)


@pytest.fixture(scope="module")
def port():
    return _Port()


# ---------------------------------------------------------------------------
# FakeS3Backend and the gates: the reference's unit tests on the copies
# ---------------------------------------------------------------------------

REF_UNITS = ["test_missing_dependency_gate_names_the_extra",
             "test_s3_backend_gates_on_boto3",
             "test_fake_s3_validates_knobs",
             "test_fake_s3_min_part_bytes_entity_too_small",
             "test_fake_s3_slowdown_is_deterministic_under_retry",
             "test_fake_s3_slowdown_without_retry_surfaces"]


@pytest.mark.parametrize("name", REF_UNITS)
def test_reference_unit_case_on_port(name, monkeypatch):
    for attr, value in (
            ("FakeS3Backend", cloud.FakeS3Backend),
            ("S3Backend", cloud.S3Backend), ("GCSBackend", cloud.GCSBackend),
            ("_require_dep", remote._require_dep),
            ("ObjectNotFound", backends.ObjectNotFound),
            ("SlowDown", backends.SlowDown),
            ("StoreStats", backends.StoreStats),
            ("MetricsMiddleware", middleware.MetricsMiddleware),
            ("RetryMiddleware", middleware.RetryMiddleware),
            ("RetryPolicy", middleware.RetryPolicy)):
        monkeypatch.setattr(ref_cloud, attr, value)
    getattr(ref_cloud, name)()


def test_copied_modules_are_the_reference_renamed():
    for rel in ("cloud/fake_s3.py", "cloud/remote.py"):
        with open(os.path.join(REPO, "src", "repro", rel)) as f:
            want = f.read().replace("repro.", "repro_torch.")
        with open(os.path.join(REPO, "src", "repro_torch", rel)) as f:
            assert f.read() == want, rel


# ---------------------------------------------------------------------------
# the handler: one JSON event, both packages
# ---------------------------------------------------------------------------


def _tiny_plan_fields():
    return dict(PLAN, records_per_wave=1 << 12,
                input_records_per_partition=1 << 11,
                output_part_records=1 << 10, parallel_reducers=1)


def test_invoke_from_one_reference_event(tmp_path):
    # One store on disk, one JSON event per task (the reference's wire
    # format, a 1-device mesh): the JAX handler runs every task, then the
    # port's runs the same events through event_from_reference. Spill
    # runs (with their reducer offsets) and outputs must be identical.
    from repro.cloud import invoke as jax_invoke
    from repro.core.external_sort import ExternalSortPlan as JaxPlan
    from repro.data import gensort as jgensort
    from repro.io.object_store import ObjectStore as JaxObjectStore

    plan = JaxPlan(impl="ref", **_tiny_plan_fields())
    root = str(tmp_path / "store")
    store = JaxObjectStore(root)
    store.create_bucket("sort")
    n = 1 << 12
    in_ck, _ = jgensort.write_to_store(
        store, "sort", plan.input_prefix, n,
        plan.input_records_per_partition, plan.payload_words)

    def event(phase, task):
        return json.loads(json.dumps({
            "version": 1, "worker": "hand", "phase": phase, "task": task,
            "bucket": "sort", "plan": dataclasses.asdict(plan),
            "mesh_devices": 1, "axis": "w", "boundaries": None,
            "store": {"kind": "fs", "root": root},
            "memory_limit_bytes": 1 << 20}))

    events = [event("map", 0)] + [event("reduce", r) for r in range(2)]
    runs = {}
    for who in ("jax", "torch"):
        for prefix in (plan.spill_prefix, plan.output_prefix):
            for m in store.list_objects("sort", prefix):
                store.delete("sort", m.key)
        for ev in events:
            if who == "jax":
                res = jax_invoke(ev)
            else:
                port_ev = cloud.event_from_reference(ev, device="cpu")
                assert port_ev["num_workers"] == 1
                assert port_ev["plan"]["impl"] == "ref"
                assert "mesh_devices" not in port_ev and "axis" not in port_ev
                res = cloud.invoke(port_ev)
            assert res["committed"] and res["stats"]["get_requests"] > 0
        runs[who] = [[m.key, m.etag, m.size, m.parts, m.metadata]
                     for prefix in (plan.spill_prefix, plan.output_prefix)
                     for m in store.list_objects("sort", prefix)]
    assert runs["torch"] == runs["jax"]
    val = valsort.validate_from_store(store, "sort", plan.output_prefix,
                                      in_ck, device="cpu")
    assert val.ok and val.total_records == n


def test_invoke_validates_its_event():
    plan = ExternalSortPlan(**dict(_tiny_plan_fields(),
                                   reduce_memory_budget_bytes=0))
    store = cloud.FakeS3Backend()
    store.create_bucket("sort")
    ev = {"version": 1, "worker": "w", "phase": "map", "task": 0,
          "bucket": "sort", "plan": dataclasses.asdict(plan),
          "num_workers": 1, "device": "cpu", "boundaries": None,
          "store": {"kind": "endpoint",
                    "token": cloud.register_endpoint(store)}}
    with pytest.raises(ValueError, match="memory_limit_bytes"):
        cloud.invoke(json.loads(json.dumps(ev)))
    ev["memory_limit_bytes"] = 1 << 20
    ev["store"] = {"kind": "endpoint", "token": "ep-never-registered"}
    with pytest.raises(ValueError, match="endpoint"):
        cloud.invoke(json.loads(json.dumps(ev)))
    ev["store"] = {"kind": "martian"}
    with pytest.raises(ValueError, match="store"):
        cloud.invoke(json.loads(json.dumps(ev)))


def test_function_worker_validates_knobs():
    store = cloud.FakeS3Backend()
    plan = ExternalSortPlan(**PLAN)
    with pytest.raises(ValueError, match="cold_start_s"):
        cloud.FunctionWorker("f", store=store, bucket="b", plan=plan,
                             cold_start_s=-1.0)
    with pytest.raises(ValueError, match="memory_limit_bytes"):
        cloud.FunctionWorker("f", store=store, bucket="b", plan=plan,
                             memory_limit_bytes=0)
    with pytest.raises(ValueError, match="workers"):
        cloud.InvocationDriver(store, "b", plan=plan, workers=0)


# ---------------------------------------------------------------------------
# the serverless fleet: each schedule against the JAX run of it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", list(FLEETS))
def test_function_worker_fleet_matches_jax(tag, port, jax_ref):
    drv = cloud.InvocationDriver(port.store, "sort", plan=port.plan,
                                 workers=4, num_workers=8, device="cpu",
                                 cold_start_s=0.001, **FLEETS[tag])
    crep = drv.run()
    assert port.layout() == jax_ref[tag] == port.single
    val = valsort.validate_from_store(port.store, "sort",
                                      port.plan.output_prefix, port.in_ck,
                                      device="cpu")
    assert val.ok and val.total_records == N, val
    assert crep.failed_workers == jax_ref[tag + "_failed"]
    inv = drv.invocations()
    committed = sum(r.committed for r in inv)
    assert committed == 4 + 16 == jax_ref[tag + "_committed"]
    assert all(r.peak_bytes <= port.plan.reduce_memory_budget_bytes
               for r in inv if r.phase == "reduce")
    if tag == "clean":
        assert not crep.failed_workers
        assert len({r.worker for r in inv}) == 4
        assert sum(r.cold_start_s > 0 for r in inv) == 4
        tco = drv.tco(data_bytes=N * port.plan.record_bytes)
        assert tco.compute > 0 and tco.total > tco.compute
    elif tag == "kill_at_pop":
        assert "fn0" in crep.failed_workers
    else:
        assert "fn1" in crep.failed_workers
        assert crep.reexecuted_map_tasks + crep.reexecuted_reduce_tasks >= 1


def test_function_worker_sorts_through_slowdown_regime(port, jax_ref):
    throttled = cloud.FakeS3Backend(chunk_size=16 << 10, slowdown_every=40)
    flaky = middleware.RetryMiddleware(
        MetricsMiddleware(throttled),
        middleware.RetryPolicy(max_attempts=8, base_delay_s=0.001,
                               max_delay_s=0.01, jitter=0.0),
        sleep=lambda _: None)
    flaky.create_bucket("sort")
    in_ck, _ = gensort.write_to_store(
        flaky, "sort", port.plan.input_prefix, N,
        port.plan.input_records_per_partition, port.plan.payload_words,
        device="cpu")
    crep = cloud.InvocationDriver(flaky, "sort", plan=port.plan, workers=4,
                                  num_workers=8, device="cpu").run()
    assert not crep.failed_workers and throttled.throttled > 0
    assert _layout(flaky, port.plan.output_prefix) == jax_ref["clean"]
    assert in_ck == port.in_ck
