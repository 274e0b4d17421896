#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one Hopper card.

    python3 chip_smoke.py [--log-dir DIR]

Run from the repo root on a machine with one H100. It

  1. prints the environment (torch, CUDA, the card's name and power
     limit from nvidia-smi) and a probe of which torch dtype round-trips
     uint32 bits on the card;
  2. builds the four CUDA kernels from src/repro_torch/kernels/csrc/;
  3. holds each kernel bit-identical to its plain torch version at the
     main path's shapes and on small adversarial cases, and times the
     kernel, the plain version and one PyTorch library call that
     computes the same function (the yardstick, never used by the port);
  4. runs the port's out-of-core CloudSort at 2^20 records on the card and
     on the CPU, with both reduce merges: the output etags must agree;
  5. runs the full sort — 100-byte records, 4 waves of 2^24 records
     (W = 8, 2 rounds, R1 = 4, reduce_merge_impl="device") through
     repro_torch.examples.cloudsort_oocore.main — with valsort, counting
     every kernel's launches on that run alone;
  6. prints nvidia-smi's own name/power-limit line, the `kernels` JSON
     line and, last, the `ok` line.

Every other stdout line is one JSON object. Any failure exits non-zero
without the `ok` line; so does a machine without a CUDA card, or a
directory without the port beside this script.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
WORK_DIR = os.path.join(HERE, "build", "chip_smoke")  # stores; git-ignored

NON_TENSOR_OPS = 67e12  # H100 SXM non-tensor peak (the guide's float32 rate)
SEED = 20231
NUM_WORKERS = 8  # W of the example (the reference's 8-device mesh)
WAVES = 4  # map waves of the full run: 4x out of core
FULL_WAVE_RECORDS = 1 << 24  # 1.68 GB of 100-byte records: the paper's block
IDENTITY_RECORDS = 1 << 20
DEVICE = "cuda"


def emit(**obj):
    print(json.dumps(obj), flush=True)


def mem_rate(name: str) -> float:
    """Device-memory bytes/s of the card (H100 SXM 3.35 TB/s; PCIe 2.0)."""
    return 2.0e12 if "PCIe" in name else 3.35e12


def cuda_ms(fn, reps: int) -> float:
    """Median ms of fn() over `reps` runs, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def probe_u32():
    """Which torch dtype and view round-trip uint32 bits on the card."""
    bits = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    out = {}
    t = torch.from_numpy(bits.view(np.int32)).cuda()
    out["int32_storage_roundtrip"] = bool(
        np.array_equal(t.cpu().numpy().view(np.uint32), bits))
    for op, fn in {
        "uint32_from_numpy": lambda: torch.from_numpy(bits).cuda(),
        "uint32_view_of_int32": lambda: t.view(torch.uint32),
        "uint32_lt": lambda: t.view(torch.uint32) < t.view(torch.uint32),
        "uint32_cat": lambda: torch.cat([t.view(torch.uint32)] * 2),
        "uint32_sort": lambda: torch.sort(t.view(torch.uint32)),
        "uint32_to_int64": lambda: t.view(torch.uint32).to(torch.int64),
    }.items():
        try:
            r = fn()
            torch.cuda.synchronize()
            if op == "uint32_to_int64":
                out[op] = bool(np.array_equal(r.cpu().numpy(),
                                              bits.astype(np.int64)))
            else:
                out[op] = True
        except Exception as e:  # a probe: an unsupported op is the answer
            out[op] = f"unsupported: {type(e).__name__}"
    return out


def check_equal(name, got, want):
    """Bit-identity of kernel vs plain outputs; returns max |diff| over
    the outputs' unsigned 32-bit values."""
    err = 0
    for g, w in zip(got, want):
        g, w = g.cpu(), w.cpu()
        if g.shape != w.shape:
            raise AssertionError(f"{name}: shapes {tuple(g.shape)} vs "
                                 f"{tuple(w.shape)}")
        if g.numel():
            d = (g.to(torch.int64) & 0xFFFFFFFF) - (w.to(torch.int64)
                                                    & 0xFFFFFFFF)
            err = max(err, int(d.abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: kernel and plain disagree "
                                 f"(shape {tuple(g.shape)}, max |diff| {err})")
    return err


def phase_kernels(plan):
    """Each kernel at the main path's shapes against its plain version on
    the card (bit-identical), plus small adversarial cases; times."""
    from repro_torch.kernels import ops, ref, u32
    from repro_torch.kernels.bitonic_sort import (bitonic_sort_blocks,
                                                  bitonic_sort_blocks_plain)
    from repro_torch.kernels.kway_merge import (
        merge_sorted_pairs_indexed, merge_sorted_pairs_indexed_plain)
    from repro_torch.kernels.merge_sorted import (merge_sorted_pairs,
                                                  merge_sorted_pairs_plain)
    from repro_torch.kernels.range_partition import (
        partition_offsets_blocks, partition_offsets_blocks_plain)

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED)

    def rand(shape, hi=2**32):
        return u32.from_numpy(rng.integers(0, hi, shape, dtype=np.uint64)
                              .astype(np.uint32), dev)

    def sorted_rows(shape):
        packed, _ = torch.sort(u32.pack(rand(shape), rand(shape)), dim=-1)
        return u32.unpack(packed)

    # ---- small adversarial cases: kernel (card) vs plain (CPU) vs ref ----
    def adversarial(case, shape):
        n = int(np.prod(shape))
        if case == "duplicates":
            k = rng.integers(0, 7, n).astype(np.uint32)
        elif case == "sorted":
            k = np.sort(rng.integers(0, 2**32, n, dtype=np.uint64)
                        .astype(np.uint32))
        elif case == "reverse":
            k = np.sort(rng.integers(0, 2**32, n, dtype=np.uint64)
                        .astype(np.uint32))[::-1].copy()
        elif case == "pads":  # records equal to the lex-max pad
            k = np.full(n, 0xFFFFFFFF, np.uint32)
        else:  # minmax: only the u32 extremes (keys >= 2^31 included)
            k = np.where(rng.integers(0, 2, n) == 0, 0,
                         0xFFFFFFFF).astype(np.uint32)
        return k.reshape(shape)

    cases = ("duplicates", "sorted", "reverse", "minmax", "pads", "random")

    def draw(case, shape):
        if case == "random":
            return (rng.integers(0, 2**32, shape, dtype=np.uint64)
                    .astype(np.uint32))
        return adversarial(case, shape)

    def cpu_sorted(case, shape):
        k = u32.from_numpy(draw(case, shape), "cpu")
        v = u32.from_numpy(rng.integers(0, 3, shape).astype(np.uint32), "cpu")
        return ops.sort_kv(k, v)

    n_checks = 0
    for case in cases:
        for shape in ((1, 1), (3, 2), (4, 256), (2, 4096), (2, 8192),
                      (1, 1 << 16)):
            kc = u32.from_numpy(draw(case, shape), "cpu")
            vc = u32.from_numpy(rng.integers(0, 3, shape).astype(np.uint32),
                                "cpu")
            got = bitonic_sort_blocks(kc.to(dev), vc.to(dev))
            check_equal("sort", got, bitonic_sort_blocks_plain(kc, vc))
            check_equal("sort-ref", got, ref.sort_kv_ref(kc, vc))
            for bounds in ([0, 0, 5, 5, 0xFFFFFFFF], [3], list(range(100))):
                bt = u32.from_numpy(np.array(bounds, np.uint32), "cpu")
                for keys in (got[0].cpu(), kc):  # sorted rows, unsorted rows
                    got_p = partition_offsets_blocks(keys.to(dev), bt.to(dev))
                    check_equal("partition", (got_p,),
                                (partition_offsets_blocks_plain(keys, bt),))
                    n_checks += 1
            n_checks += 2
        for shape in ((1, 1), (5, 4), (3, 256), (2, 4096), (1, 1 << 15)):
            a, b = cpu_sorted(case, shape), cpu_sorted(case, shape)
            got_m = merge_sorted_pairs(*(t.to(dev) for t in a + b))
            check_equal("merge", got_m, merge_sorted_pairs_plain(*a, *b))
            ai = torch.arange(a[0].numel(), dtype=torch.int32).reshape(shape)
            trip = (a[0], a[1], ai, b[0], b[1], ai + a[0].numel())
            got_i = merge_sorted_pairs_indexed(*(t.to(dev) for t in trip))
            check_equal("merge-idx", got_i,
                        merge_sorted_pairs_indexed_plain(*trip))
            n_checks += 2
    for n in (1, 2, 100, 1000, 5000, 70000):  # non-pow2 sort_kv through ops
        k, v = rand((n,)), rand((n,), 4)
        check_equal("sort_kv", ops.sort_kv(k, v),
                    ops.sort_kv(k.cpu(), v.cpu()))
        n_checks += 1
    emit(phase="kernels.adversarial", checks=n_checks, ok=True)

    # ---- main-path shapes: correctness + times ----
    from repro_torch.core.exoshuffle import ShuffleConfig

    w, r1 = NUM_WORKERS, plan.reducers_per_worker
    per_round = plan.records_per_wave // w // plan.num_rounds
    cap = ShuffleConfig(num_workers=w, capacity_factor=plan.capacity_factor
                        ).block_capacity(per_round)
    rate = mem_rate(torch.cuda.get_device_name(0))
    emit(phase="kernels.bound", mem_bytes_per_s=rate,
         ops_per_s=NON_TENSOR_OPS)
    rows = []

    def record(name, source, replaces, shape, got, plain_fn, kern_fn, lib_fn,
               nbytes, nops, listed=True):
        err = check_equal(name, got, plain_fn())
        ms = cuda_ms(kern_fn, 10)
        plain_ms = cuda_ms(plain_fn, 3)
        lib_ms = cuda_ms(lib_fn, 10) if lib_fn else None
        bound_bytes, bound_ops = nbytes / rate * 1e3, nops / NON_TENSOR_OPS * 1e3
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   shape=shape, launches=0, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=max(bound_bytes, bound_ops),
                   bound_by="bytes" if bound_bytes >= bound_ops
                   else "operations", library_ms=lib_ms)
        emit(phase="kernel", **row)
        if listed:
            rows.append(row)
        torch.cuda.empty_cache()

    csrc = "src/repro_torch/kernels/csrc/"
    # sort (W, per_round): the map sort of every round
    nb, b = w, per_round
    k, v = rand((nb, b)), rand((nb, b))
    got = bitonic_sort_blocks(k, v)
    packed = u32.pack(k, v)
    record("bitonic_sort_blocks", csrc + "bitonic_sort.cu",
           "src/repro/kernels/bitonic_sort.py:97", [nb, b], got,
           lambda: bitonic_sort_blocks_plain(k, v),
           lambda: bitonic_sort_blocks(k, v),
           lambda: torch.sort(packed, dim=-1),
           16 * nb * b, nb * b * max(b.bit_length() - 1, 1))
    # partition (W, per_round) x W-1 worker boundaries
    from repro_torch.core.keyspace import KeySpace

    sk = got[0].contiguous()
    wb = KeySpace(num_reducers=w * r1, num_workers=w).worker_boundaries(dev)
    sk64 = u32.widen(sk)
    wb64 = u32.widen(wb).reshape(1, -1).expand(nb, -1).contiguous()
    record("partition_offsets_blocks", csrc + "range_partition.cu",
           "src/repro/kernels/range_partition.py:76", [nb, b, wb.numel()],
           (partition_offsets_blocks(sk, wb),),
           lambda: (partition_offsets_blocks_plain(sk, wb),),
           lambda: partition_offsets_blocks(sk, wb),
           lambda: torch.searchsorted(sk64, wb64),
           4 * nb * b + 4 * wb.numel() + 4 * nb * wb.numel(),
           nb * b * wb.numel())
    del k, v, got, packed, sk, sk64
    # merge: first tournament round (W*W/2, C) — the listed row — and the
    # stage-2 merge (W*rounds/2, W*C): the two ends of the path's shapes
    for i, (n, L) in enumerate(((w * w // 2, cap),
                                (w * plan.num_rounds // 2, w * cap))):
        a, bb = sorted_rows((n, L)), sorted_rows((n, L))
        cat = torch.cat([u32.pack(*a), u32.pack(*bb)], dim=-1)
        record("merge_sorted_pairs", csrc + "merge_sorted.cu",
               "src/repro/kernels/merge_sorted.py:53", [n, L],
               merge_sorted_pairs(*a, *bb),
               lambda: merge_sorted_pairs_plain(*a, *bb),
               lambda: merge_sorted_pairs(*a, *bb),
               lambda: torch.sort(cat, dim=-1), 32 * n * L, 2 * n * L,
               listed=i == 0)
        del a, bb, cat
    # indexed merge: one reduce emit window's first tournament round
    # (a window holds at most one merge_chunk_bytes chunk of each of the
    # WAVES runs of a partition: K = next_pow2(WAVES) rows of L records)
    n = ops.next_pow2(WAVES) // 2
    L = ops.next_pow2(plan.merge_chunk_bytes // plan.record_bytes)
    a, bb = sorted_rows((n, L)), sorted_rows((n, L))
    ai = torch.arange(n * L, dtype=torch.int32, device=dev).reshape(n, L)
    bi = ai + n * L
    cat = torch.cat([u32.pack(*a), u32.pack(*bb)], dim=-1)
    record("merge_sorted_pairs_indexed", csrc + "kway_merge.cu",
           "src/repro/kernels/kway_merge.py:126", [n, L],
           merge_sorted_pairs_indexed(a[0], a[1], ai, bb[0], bb[1], bi),
           lambda: merge_sorted_pairs_indexed_plain(a[0], a[1], ai,
                                                    bb[0], bb[1], bi),
           lambda: merge_sorted_pairs_indexed(a[0], a[1], ai,
                                              bb[0], bb[1], bi),
           lambda: torch.sort(cat, dim=-1, stable=True), 48 * n * L, 2 * n * L)
    return rows


def layout(root, prefix="output/"):
    from repro_torch.io.backends import FilesystemBackend

    fs = FilesystemBackend(os.path.join(root, "durable"))
    return [(m.key, m.etag, m.size, m.parts)
            for m in fs.list_objects("cloudsort", prefix)]


def run_example(argv, plan, log):
    from repro_torch.examples import cloudsort_oocore

    with contextlib.redirect_stdout(log):
        return cloudsort_oocore.main(argv, plan=plan)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-dir", default=WORK_DIR,
                    help="where the runs' verbose output goes")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False — "
                 "this script needs a CUDA card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        sys.exit(f"chip_smoke: no port at {SRC}/repro_torch — run from "
                 "the repo root")
    sys.path.insert(0, SRC)
    os.makedirs(args.log_dir, exist_ok=True)
    os.makedirs(WORK_DIR, exist_ok=True)
    with open(os.path.join(args.log_dir, "chip_smoke.log"), "w") as log:
        run(log)


def run(log):
    """The six phases; verbose output of the example runs goes to `log`."""
    t_start = time.perf_counter()

    # ---- 1. environment ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=name,
         capability=list(torch.cuda.get_device_capability(0)),
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         u32_probe=probe_u32())

    # ---- 2. build ----
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.function("bitonic_sort")
    for src, text in _build.build_info.get("ptxas", {}).items():
        print(f"--- ptxas {src} ---\n{text}", file=log)
    emit(phase="build", seconds=time.perf_counter() - t0,
         dir=_build.build_info["dir"],
         ptxas=[ln.strip() for txt in _build.build_info.get(
             "ptxas", {}).values() for ln in txt.splitlines()
             if "registers" in ln])

    from repro_torch.core.external_sort import ExternalSortPlan
    from repro_torch.kernels.bitonic_sort import bitonic_sort_blocks
    from repro_torch.kernels.kway_merge import merge_sorted_pairs_indexed
    from repro_torch.kernels.merge_sorted import merge_sorted_pairs
    from repro_torch.kernels.range_partition import partition_offsets_blocks

    wrappers = {"bitonic_sort_blocks": bitonic_sort_blocks,
                "partition_offsets_blocks": partition_offsets_blocks,
                "merge_sorted_pairs": merge_sorted_pairs,
                "merge_sorted_pairs_indexed": merge_sorted_pairs_indexed}
    full = ExternalSortPlan(
        records_per_wave=FULL_WAVE_RECORDS, num_rounds=2, reducers_per_worker=4,
        payload_words=23, impl="kernel",
        input_records_per_partition=FULL_WAVE_RECORDS // 4,
        output_part_records=1 << 16, store_chunk_bytes=8 << 20,
        merge_chunk_bytes=1 << 20, parallel_reducers=4,
        reduce_memory_budget_bytes=32 << 20, reduce_merge_impl="device")

    # ---- 3. kernels against their plain versions ----
    rows = phase_kernels(full)

    # ---- 4. identity: card vs CPU at 2^20 records, both reduce merges ----
    small = dataclasses.replace(full,
                                records_per_wave=IDENTITY_RECORDS // WAVES,
                                input_records_per_partition=(
                                    IDENTITY_RECORDS // 16),
                                output_part_records=1 << 13,
                                store_chunk_bytes=1 << 20,
                                merge_chunk_bytes=256 << 10,
                                parallel_reducers=2,
                                reduce_memory_budget_bytes=2 << 20)
    layouts = {}
    for device in (DEVICE, "cpu"):
        for rmi in ("numpy", "device"):
            store = os.path.join(WORK_DIR, f"store-{device}-{rmi}")
            shutil.rmtree(store, ignore_errors=True)
            t0 = time.perf_counter()
            out = run_example(
                ["--records", str(IDENTITY_RECORDS), "--waves", str(WAVES),
                 "--no-faults",
                 "--device", device, "--reduce-merge-impl", rmi,
                 "--store", store], small, log)
            assert out["valsort_ok"], (device, rmi)
            layouts[(device, rmi)] = layout(store)
            shutil.rmtree(store, ignore_errors=True)
            emit(phase="identity.run", device=device, reduce_merge_impl=rmi,
                 seconds=time.perf_counter() - t0,
                 outputs=len(layouts[(device, rmi)]))
    want = layouts[(DEVICE, "device")]
    for key, got in layouts.items():
        if got != want:
            raise AssertionError(f"identity: {key} output etags differ from "
                                 "the card's device-merge run")
    emit(phase="identity", records=IDENTITY_RECORDS, outputs=len(want),
         etags_identical=True)

    # ---- 5. the full run: the main path, launches counted alone ----
    store = os.path.join(WORK_DIR, "store-full")
    shutil.rmtree(store, ignore_errors=True)
    records = WAVES * full.records_per_wave
    emit(phase="full.plan", records=records, waves=WAVES,
         record_bytes=full.record_bytes,
         wave_bytes=full.records_per_wave * full.record_bytes,
         merge_chunk_bytes=full.merge_chunk_bytes,
         reduce_memory_budget_bytes=full.reduce_memory_budget_bytes,
         store_chunk_bytes=full.store_chunk_bytes,
         output_part_records=full.output_part_records)
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    out = run_example(
        ["--records", str(records), "--waves", str(WAVES), "--no-faults",
         "--device", DEVICE, "--store", store], full, log)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in wrappers.items()}
    shutil.rmtree(store, ignore_errors=True)
    emit(phase="full", **{k: v for k, v in out.items() if k != "store"},
         launches=launches, device=name)
    if not out["valsort_ok"]:
        raise AssertionError("full run: valsort failed")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"full run: kernel {n} was never launched")

    # ---- 6. the kernels line, then the ok line ----
    for row in rows:
        row["launches"] = launches[row["name"]]
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
