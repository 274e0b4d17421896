"""The port's fault-tolerant fleet against the JAX package: the elastic
driver (a copy), process workers, the recursive skew pass and the
deprecated core/cluster shim.

The JAX package runs each schedule once, in one module-scoped subprocess
on an 8-device host mesh (tests/helpers.run_with_devices): the
single-host sort, its process fleet clean and with a worker killed, and
the recursive sort of zipf keys. The port runs in-process on the CPU
(device="cpu"), process workers in child interpreters of their own.
Every output layout — keys, CRC etags, sizes, part counts — must equal
the JAX run of the same schedule, and the port's own single-host
output, which tests/test_torch_cloudsort.py holds equal to the JAX
package's.

FleetPlan and ClaimPool are held to the reference's own unit tests
(tests/test_elastic.py), run against the port's classes.
"""
import dataclasses
import difflib
import json
import os
import threading
import time
import warnings

import pytest
import torch

import test_elastic as ref_elastic
from helpers import REPO, run_with_devices
from repro_torch.core.external_sort import ExternalSortPlan
from repro_torch.data import gensort, valsort
from repro_torch.io.object_store import ObjectStore
from repro_torch.shuffle import elastic, executor
from repro_torch.shuffle.elastic import FleetPlan
from repro_torch.shuffle.executor import (ClusterFailure, ClusterPlan,
                                          FaultyWorker, ThreadWorker)
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
# The recursive schedule: zipf keys, sampled boundaries, and a budget
# below one partition, so every partition takes further rounds.
REC = dict(PLAN, reduce_memory_budget_bytes=24 << 10, capacity_factor=4.0,
           sample_fraction=1 / 16, max_rounds=3, input_prefix="rec-input/",
           spill_prefix="rec-spill/", output_prefix="rec-output/")
KILL = {"die_after_tasks": 4}  # p0 dies at its 5th task pop

_JAX = """
import json
import tempfile
from repro.core.compat import make_mesh
from repro.core.external_sort import ExternalSortPlan
from repro.data import gensort
from repro.io.object_store import ObjectStore
from repro.shuffle.elastic import FleetPlan
from repro.shuffle.procworker import ProcessWorker
from repro.shuffle.recursive import recursive_sort
from repro.shuffle.sort import sort_shuffle_job

mesh = make_mesh((8,), ("w",))
plan = ExternalSortPlan(impl="ref", **json.loads({plan!r}))
rplan = ExternalSortPlan(impl="ref", **json.loads({rec!r}))
store = ObjectStore(tempfile.mkdtemp(prefix="torch-fleet-ref-"))
store.create_bucket("sort")
gensort.write_to_store(store, "sort", plan.input_prefix, {n},
                       plan.input_records_per_partition, plan.payload_words)
gensort.write_to_store(store, "sort", rplan.input_prefix, {n},
                       rplan.input_records_per_partition,
                       rplan.payload_words, skew="zipf", skew_seed=3)

def layout(prefix):
    return [[m.key, m.etag, m.size, m.parts]
            for m in store.list_objects("sort", prefix)]

def job():
    return sort_shuffle_job(store, "sort", mesh=mesh, axis_names="w",
                            plan=plan)

out = {{}}
job().run(workers=0)
out["single"] = layout(plan.output_prefix)
for tag, kw in (("process_clean", {{}}), ("process_kill", {kill})):
    crew = [ProcessWorker("p0", store=store, bucket="sort", plan=plan, **kw),
            ProcessWorker("p1", store=store, bucket="sort", plan=plan)]
    try:
        crep = job().run(worker_list=crew, fleet=FleetPlan())
    finally:
        for wk in crew:
            wk.close()
    out[tag] = layout(plan.output_prefix)
    out[tag + "_failed"] = crep.failed_workers
rep = recursive_sort(store, "sort", mesh=mesh, axis_names="w", plan=rplan)
out["recursive"] = layout(rplan.output_prefix)
out["recursive_rounds"] = [[d, p] for d, p, _ in rep.rounds]
out["recursive_recursed"] = rep.recursed
with open({outp!r}, "w") as f:
    json.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_fleet")
    outp = os.path.join(d, "out.json")
    run_with_devices(_JAX.format(plan=json.dumps(PLAN), rec=json.dumps(REC),
                                 n=N, kill=KILL, outp=outp), timeout=600)
    with open(outp) as f:
        return json.load(f)


class _Port:
    """The port's store with both inputs, and its single-host output."""

    def __init__(self, root):
        self.plan = ExternalSortPlan(**PLAN)
        self.rplan = ExternalSortPlan(**REC)
        self.store = ObjectStore(root)
        self.store.create_bucket("sort")
        self.in_ck, _ = gensort.write_to_store(
            self.store, "sort", self.plan.input_prefix, N,
            self.plan.input_records_per_partition, self.plan.payload_words,
            device="cpu")
        self.rec_ck, _ = gensort.write_to_store(
            self.store, "sort", self.rplan.input_prefix, N,
            self.rplan.input_records_per_partition, self.rplan.payload_words,
            skew="zipf", skew_seed=3, device="cpu")
        self.job().run(workers=0)
        self.single = self.layout()

    def job(self, plan=None):
        return sort_shuffle_job(self.store, "sort", num_workers=8,
                                plan=plan or self.plan, device="cpu")

    def layout(self, prefix=None):
        return [[m.key, m.etag, m.size, m.parts] for m in
                self.store.list_objects("sort",
                                        prefix or self.plan.output_prefix)]

    def check(self, want, prefix=None, ck=None):
        plan_prefix = prefix or self.plan.output_prefix
        assert self.layout(plan_prefix) == want
        val = valsort.validate_from_store(self.store, "sort", plan_prefix,
                                          ck or self.in_ck, device="cpu")
        assert val.ok and val.total_records == N, val


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return _Port(str(tmp_path_factory.mktemp("port_fleet")))


def test_single_host_output_matches_jax(port, jax_ref):
    assert port.single == jax_ref["single"]
    assert len(port.single) == 16


# ---------------------------------------------------------------------------
# FleetPlan and ClaimPool: the reference's unit tests on the port's copy
# ---------------------------------------------------------------------------

REF_UNITS = sorted(n for n in dir(ref_elastic)
                   if n.startswith(("test_fleet_plan", "test_claim_pool")))


@pytest.mark.parametrize("name", REF_UNITS)
def test_reference_unit_case_on_port(name, monkeypatch):
    monkeypatch.setattr(ref_elastic, "ClaimPool", elastic.ClaimPool)
    monkeypatch.setattr(ref_elastic, "FleetPlan", elastic.FleetPlan)
    monkeypatch.setattr(ref_elastic, "WorkerFailure", executor.WorkerFailure)
    getattr(ref_elastic, name)()


def _renamed_reference_and_port(rel):
    with open(os.path.join(REPO, "src", "repro", rel)) as f:
        want = f.read().replace("repro.", "repro_torch.")
    with open(os.path.join(REPO, "src", "repro_torch", rel)) as f:
        return want, f.read()


def test_copied_modules_are_the_reference_renamed():
    for rel in ("shuffle/elastic.py", "shuffle/executor.py"):
        want, got = _renamed_reference_and_port(rel)
        assert got == want, rel
    # shuffle/job.py is the renamed reference plus the port's rank path
    # (a job on a launch/mesh.RankMesh), and shuffle/runtime.py the
    # renamed reference less PhaseTimeline.span (which nothing in the
    # port calls), and nothing else: their diffs against the renamed
    # reference are pinned, line for line.
    for rel, pinned in (("shuffle/job.py", "shuffle_job_rank_path.diff"),
                        ("shuffle/runtime.py",
                         "shuffle_runtime_no_span.diff")):
        want, got = _renamed_reference_and_port(rel)
        diff = difflib.unified_diff(want.splitlines(True),
                                    got.splitlines(True), "reference",
                                    "port", n=0)
        with open(os.path.join(REPO, "tests", pinned)) as f:
            assert "".join(diff) == f.read(), rel


# ---------------------------------------------------------------------------
# the elastic thread fleet
# ---------------------------------------------------------------------------


def test_job_run_with_fleet_plan(port, jax_ref):
    # ShuffleJob.run(worker_list=..., fleet=FleetPlan()) reaches the
    # elastic driver through the lazy import of shuffle/elastic.
    crew = [ThreadWorker(f"w{i}", port.store) for i in range(3)]
    crep = port.job().run(worker_list=crew, fleet=FleetPlan())
    port.check(jax_ref["single"])
    assert not crep.failed_workers and crep.recovery_rounds == 0
    assert crep.heartbeat_misses == 0 and crep.spill_lost_map_tasks == 0
    assert sum(crep.per_worker_tasks.values()) == 4 + 16


def test_elastic_membership_admit_and_retire(port, jax_ref):
    session = port.job().prepare(schedulers=2)
    crew = [ThreadWorker(f"w{i}", port.store) for i in range(2)]
    late = ThreadWorker("late", port.store)

    def membership():
        while getattr(session, "driver", None) is None:
            time.sleep(0.005)
        session.driver.retire("w1")
        session.driver.admit(late)

    t = threading.Thread(target=membership, daemon=True)
    t.start()
    crep = session.run_elastic(crew, FleetPlan())
    t.join()
    port.check(jax_ref["single"])
    assert crep.workers_admitted == 1 and crep.workers_retired == 1
    assert crep.per_worker_tasks.get("late", 0) >= 1, crep.per_worker_tasks


def test_elastic_spill_loss_reexecutes_map_lineage(port, jax_ref):
    crew = [FaultyWorker(ThreadWorker("w0", port.store), fail_after_tasks=6),
            ThreadWorker("w1", port.store)]
    crep = port.job().run(worker_list=crew, fleet=FleetPlan())
    port.check(jax_ref["single"])
    assert crep.failed_workers == ["w0"]
    assert crep.spill_lost_map_tasks >= 1, crep
    assert crep.reexecuted_map_tasks >= crep.spill_lost_map_tasks


def test_elastic_speculation_beats_straggler(port, jax_ref):
    from repro_torch.io.middleware import (FaultProfile,
                                           LatencyBandwidthMiddleware)

    slow = LatencyBandwidthMiddleware(port.store,
                                      FaultProfile(latency_s=0.25))
    crew = [ThreadWorker("w0", port.store), ThreadWorker("w1", port.store),
            ThreadWorker("slow", slow)]
    fleet = FleetPlan(speculation=True, speculation_min_samples=3,
                      speculation_quantile=0.5, speculation_factor=2.0,
                      speculation_min_s=0.1)
    crep = port.job().run(worker_list=crew, fleet=fleet)
    port.check(jax_ref["single"])
    assert not crep.failed_workers
    assert crep.speculated_tasks >= 1 and crep.speculation_wins >= 1, crep


def test_elastic_last_survivor_death_fails_cleanly(port, jax_ref):
    crew = [FaultyWorker(ThreadWorker("w0", port.store), fail_after_tasks=2),
            FaultyWorker(ThreadWorker("w1", port.store), fail_after_tasks=8)]
    with pytest.raises(ClusterFailure, match="workers dead"):
        port.job().run(worker_list=crew, fleet=FleetPlan())
    want = {k: rest for k, *rest in jax_ref["single"]}
    got = port.layout()
    assert len(got) < 16
    for k, *rest in got:
        assert want[k] == rest, k
    stray = [f for _, _, fs in os.walk(port.store.root) for f in fs
             if ".mp" in f]
    assert not stray, stray


# ---------------------------------------------------------------------------
# process workers: children of their own, clean and with a kill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", ["process_clean", "process_kill"])
def test_process_fleet_matches_jax_process_fleet(tag, port, jax_ref):
    from repro_torch.shuffle.procworker import ProcessWorker

    kw = KILL if tag == "process_kill" else {}
    crew = [ProcessWorker("p0", store=port.store, bucket="sort",
                          plan=port.plan, device="cpu", **kw),
            ProcessWorker("p1", store=port.store, bucket="sort",
                          plan=port.plan, device="cpu")]
    try:
        crep = port.job().run(worker_list=crew, fleet=FleetPlan())
    finally:
        for wk in crew:
            wk.close()
    port.check(jax_ref[tag])
    assert jax_ref[tag] == port.single
    assert crep.failed_workers == jax_ref[tag + "_failed"]
    if tag == "process_kill":
        assert crep.failed_workers == ["p0"]
        assert crep.spill_lost_map_tasks >= 1 and crep.recovery_rounds >= 1
        assert crep.reexecuted_map_tasks >= 1
    else:
        assert sum(crep.per_worker_tasks.values()) == 4 + 16
        for name in ("p0", "p1"):
            assert crep.per_worker_stats[name].get_requests > 0
    # plain versions on the CPU: the children launched no kernel
    assert crew[1].launches and not any(crew[1].launches.values())
    assert crew[1].shapes.keys() == crew[1].launches.keys()
    assert not any(crew[1].shapes.values())


def test_process_worker_needs_a_filesystem_store():
    from repro_torch.shuffle import procworker

    with pytest.raises(ValueError, match="filesystem root"):
        procworker.store_spec_for(object())


def test_process_worker_without_a_card_raises_at_once(port):
    # The child's sort raises for device="cuda" on a machine without a
    # card; the parent raises as soon as the child exits, not at the
    # ready timeout, and never falls back to the CPU.
    from repro_torch.shuffle.procworker import ProcessWorker

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: cuda would not raise")
    t0 = time.monotonic()
    with pytest.raises(executor.WorkerFailure, match="exited before ready"):
        ProcessWorker("p0", store=port.store, bucket="sort", plan=port.plan,
                      device="cuda", ready_timeout_s=120.0)
    assert time.monotonic() - t0 < 60


# ---------------------------------------------------------------------------
# the recursive skew pass
# ---------------------------------------------------------------------------


def test_recursive_sort_zipf_matches_jax(port, jax_ref):
    from repro_torch.shuffle.recursive import recurse_prefix, recursive_sort

    rep = recursive_sort(port.store, "sort", num_workers=8, plan=port.rplan,
                         device="cpu")
    assert [[d, p] for d, p, _ in rep.rounds] == jax_ref["recursive_rounds"]
    assert rep.recursed == jax_ref["recursive_recursed"]
    assert rep.num_rounds == 3 and rep.sample is not None
    port.check(jax_ref["recursive"], port.rplan.output_prefix, port.rec_ck)
    assert not port.store.list_objects("sort", recurse_prefix(port.rplan))
    # A mid-round worker kill in every round's fleet changes no byte. It
    # writes under fresh prefixes (the rerun into the same prefixes is
    # the next test).
    kplan = dataclasses.replace(port.rplan, spill_prefix="rec-kill-spill/",
                                output_prefix="rec-kill-output/")
    crep = recursive_sort(port.store, "sort", num_workers=8, plan=kplan,
                          device="cpu",
                          cluster=ClusterPlan(num_workers=4,
                                              fail_after_tasks={1: 2}))
    assert any(getattr(r, "failed_workers", []) for _, _, r in crep.rounds)
    def relative(rows, prefix):
        return [[k[len(prefix):], *rest] for k, *rest in rows]

    assert (relative(port.layout(kplan.output_prefix), kplan.output_prefix)
            == relative(jax_ref["recursive"], port.rplan.output_prefix))
    val = valsort.validate_from_store(port.store, "sort", kplan.output_prefix,
                                      port.rec_ck, device="cpu")
    assert val.ok and val.total_records == N, val


def test_recursive_sort_rerun_into_same_prefixes(port, jax_ref):
    # A restaged partition's children leave the directory
    # <output>/part-X/sub-Y/ on the filesystem; the next run writes
    # part-X/sub-Y as an object again (ROADMAP §3, fault 3).
    from repro_torch.shuffle.recursive import recursive_sort

    for _ in range(2):
        rep = recursive_sort(port.store, "sort", num_workers=8,
                             plan=port.rplan, device="cpu")
        assert rep.restaged
        port.check(jax_ref["recursive"], port.rplan.output_prefix,
                   port.rec_ck)


# ---------------------------------------------------------------------------
# the deprecated core/cluster shim
# ---------------------------------------------------------------------------


def test_cluster_shim_warns_and_writes_the_same_bytes(port, jax_ref):
    from repro_torch.core.cluster import ClusterExecutor, cluster_external_sort

    plan = port.plan
    with pytest.warns(DeprecationWarning, match="ClusterExecutor"):
        ex = ClusterExecutor(port.store, "sort", num_workers=8, plan=plan,
                             device="cpu", cluster=ClusterPlan(num_workers=2))
    rep = ex.sort()
    port.check(jax_ref["single"])
    assert rep.num_cluster_workers == 2 and rep.report.total_records == N
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rep = cluster_external_sort(
            port.store, "sort", num_workers=8, plan=plan, device="cpu",
            cluster=ClusterPlan(num_workers=4, fail_after_tasks={1: 2}))
    msgs = [str(w.message) for w in caught
            if issubclass(w.category, DeprecationWarning)]
    assert any("cluster_external_sort" in m for m in msgs), msgs
    assert rep.failed_workers == ["w1"]
    port.check(jax_ref["single"])
    assert rep.report.total_records == N
