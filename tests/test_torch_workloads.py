"""The port's other users of the shuffle against the JAX package: the
group-by workload (copies), the quickstart twin, and the data pipeline's
epoch shuffle and token batches.

The JAX mesh runs (the quickstart's streaming_sort over 8 workers and
device_epoch_shuffle on a (2, 4) mesh) run once, jit-compiled, in one
module-scoped subprocess (tests/helpers.run_with_devices); the port runs
in-process on the CPU with the workers as its batch axis. Integers must
be bit-identical and store objects etag-identical.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from helpers import REPO, run_with_devices
from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe

torch.set_num_threads(2)

EPOCH_N = 1 << 15
EPOCHS = (3, 4)

_JAX = """
import jax, jax.numpy as jnp, numpy as np
from repro.core.compat import make_mesh
from repro.core.streaming import streaming_sort
from repro.data import gensort
from repro.data.pipeline import device_epoch_shuffle

out = {{}}
mesh = make_mesh((8,), ("w",))
keys, ids = gensort.gen_keys(0, 8 * 4096)
sk, si, counts, ovf = jax.jit(lambda k, i: streaming_sort(
    k, i, mesh=mesh, axis_names="w", num_rounds=4, impl="ref"))(keys, ids)
out["qs_keys"], out["qs_ids"] = np.asarray(sk), np.asarray(si)
out["qs_counts"], out["qs_overflow"] = np.asarray(counts), np.asarray(ovf)

mesh = make_mesh((2, 4), ("data", "model"))
for epoch in {epochs}:
    out[f"epoch{{epoch}}"] = device_epoch_shuffle(
        jnp.arange({n}, dtype=jnp.uint32), epoch=epoch, mesh=mesh,
        axis_names=("data", "model"))
np.savez({outp!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    outp = str(tmp_path_factory.mktemp("jax_workloads") / "out.npz")
    run_with_devices(_JAX.format(epochs=EPOCHS, n=EPOCH_N, outp=outp))
    with np.load(outp) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# the group-by workload: copies of the reference
# ---------------------------------------------------------------------------

COPIES = ["shuffle/groupby.py", "configs/groupby.py"]


@pytest.mark.parametrize("rel", COPIES + ["examples/groupby_shuffle.py"])
def test_copied_modules_are_the_reference_renamed(rel):
    ref = (os.path.join(REPO, rel) if rel.startswith("examples/")
           else os.path.join(REPO, "src", "repro", rel))
    with open(ref) as f:
        want = f.read().replace("repro.", "repro_torch.")
    with open(os.path.join(REPO, "src", "repro_torch", rel)) as f:
        assert f.read() == want, rel


def _groupby_run(pkg, schedule):
    """One group-by job of `pkg` ("repro" or "repro_torch") on a memory
    store: (output layout, validation)."""
    import importlib

    api = importlib.import_module(f"{pkg}.shuffle.api")
    backends = importlib.import_module(f"{pkg}.io.backends")
    executor = importlib.import_module(f"{pkg}.shuffle.executor")
    gb = importlib.import_module(f"{pkg}.shuffle.groupby")

    plan = api.ShufflePlan(payload_words=1, store_chunk_bytes=8 << 10,
                           merge_chunk_bytes=2 << 10,
                           output_part_records=1 << 9, parallel_reducers=3,
                           reduce_memory_budget_bytes=64 << 10)
    store = backends.MemoryBackend()
    store.create_bucket("agg")
    counts, sums = gb.write_groupby_input(
        store, "agg", plan.input_prefix, 1 << 13, 1 << 11, num_groups=700,
        skew=2.5)
    job = gb.groupby_job(store, "agg", plan=plan, num_partitions=8,
                         combine=schedule != "no_combine")
    if schedule == "cluster_kill":
        crep = job.run(cluster=executor.ClusterPlan(num_workers=4,
                                                    fail_after_tasks={1: 2}))
        assert crep.failed_workers == ["w1"]
    else:
        job.run()
    val = gb.validate_groupby_from_store(store, "agg", plan.output_prefix,
                                         job.partitioner, counts, sums)
    layout = [(m.key, m.etag, m.size, m.parts)
              for m in store.list_objects("agg", plan.output_prefix)]
    return layout, val


@pytest.mark.parametrize("schedule", ["combine", "no_combine", "cluster_kill"])
def test_groupby_job_matches_jax(schedule):
    want, jval = _groupby_run("repro", schedule)
    got, tval = _groupby_run("repro_torch", schedule)
    assert got == want and len(got) == 8
    assert tval.ok and jval.ok and tval.total_groups == jval.total_groups


def test_groupby_example_runs(monkeypatch, tmp_path, capsys):
    from repro_torch.examples import groupby_shuffle

    monkeypatch.setattr(sys, "argv", [
        "groupby_shuffle", "--records", str(1 << 13), "--groups", "300",
        "--partitions", "4", "--no-faults", "--store", str(tmp_path)])
    groupby_shuffle.main()
    out = capsys.readouterr().out
    assert "[validate] groups=300 counts=True sums=True" in out


# ---------------------------------------------------------------------------
# the quickstart twin
# ---------------------------------------------------------------------------


def test_quickstart_matches_jax_streaming_sort(jax_ref):
    from repro_torch.examples import quickstart
    from repro_torch.kernels import u32

    out = quickstart.main(["--device", "cpu"])
    assert out["valsort_ok"] and out["records"] == 8 * 4096
    assert np.array_equal(u32.to_numpy(out["sorted_keys"]), jax_ref["qs_keys"])
    assert np.array_equal(u32.to_numpy(out["sorted_ids"]), jax_ref["qs_ids"])
    assert np.array_equal(out["counts"].numpy(), jax_ref["qs_counts"])
    assert not jax_ref["qs_overflow"]


# ---------------------------------------------------------------------------
# data/pipeline: the epoch shuffle and the token batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("epoch", EPOCHS)
def test_device_epoch_shuffle_matches_jax_mesh(jax_ref, epoch):
    ids = np.arange(EPOCH_N, dtype=np.uint32)
    perm = tpipe.device_epoch_shuffle(ids, epoch, num_workers=8,
                                      device="cpu")
    assert perm.dtype == np.uint32
    assert np.array_equal(perm, jax_ref[f"epoch{epoch}"])
    assert np.array_equal(np.sort(perm), ids)  # a true permutation


def test_device_epoch_shuffle_raises_on_overflow():
    # every id equal: one key, so one worker receives every record
    with pytest.raises(RuntimeError, match="overflow"):
        tpipe.device_epoch_shuffle(np.zeros(1 << 10, np.uint32), 0,
                                   num_workers=8, device="cpu")


def test_entry_points_need_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    cfg = tpipe.DataConfig(vocab=64, seq_len=8, global_batch=4)
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.TokenPipeline(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.device_epoch_shuffle(np.arange(64, dtype=np.uint32), 0,
                                   num_workers=8)
    from repro_torch.examples import quickstart, serve_decode
    for example in (quickstart, serve_decode):
        with pytest.raises(RuntimeError, match="cuda"):
            example.main([])


@pytest.mark.parametrize("fn,args", [
    ("shuffled_indices", (2, 5000)),
    ("sample_tokens", (np.arange(37, dtype=np.uint32) * 977, 24, 1000)),
    ("length_sorted_batches",
     (np.random.default_rng(0).integers(1, 512, 1000), 16)),
    ("_np_splitmix32", (np.arange(1 << 12, dtype=np.uint32) * 65537,)),
])
def test_host_pipeline_functions_equal_reference(fn, args):
    assert np.array_equal(getattr(tpipe, fn)(*args), getattr(jpipe, fn)(*args))


def test_token_pipeline_batch_at_matches_reference():
    fields = dict(vocab=1000, seq_len=16, global_batch=8, num_samples=64)
    ref = jpipe.TokenPipeline(jpipe.DataConfig(**fields))
    port = tpipe.TokenPipeline(tpipe.DataConfig(**fields), device="cpu")
    assert dataclasses.asdict(port.cfg) == dataclasses.asdict(ref.cfg)
    for step in (0, 1, 7, 8, 9, 23, 5):  # crosses epochs, and restarts
        want, got = ref.batch_at(step), port.batch_at(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            assert got[key].device.type == "cpu"
            assert np.array_equal(got[key].numpy(), np.asarray(want[key]))
