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
     computes the same function (the yardstick, never used by the port):
     device ms amortized over a run of back-to-back calls that rotate
     over copies of the inputs larger than the L2 together (so each
     call finds its inputs cold), kernel and library in turns, and the
     host µs of one wrapper call on its own; beside them an empty
     kernel's launch (the launch floor) and one whole reduce window
     through merge_fragments_device (host µs); and, unlisted, the sort at
     the payload path's (8, 2^21);
  4. runs the port's out-of-core CloudSort at 2^20 records on the card and
     on the CPU, with both reduce merges: the output etags must agree;
  5. runs the full sort — 100-byte records, 4 waves of 2^24 records
     (W = 8, 2 rounds, R1 = 4, reduce_merge_impl="device") through
     repro_torch.examples.cloudsort_oocore.main — with valsort, counting
     every kernel's launches on that run alone and the reduce windows
     merged on the card (one indexed-merge launch each); then splits one
     window of the run's mean size into its host steps;
  6. the whole-record payload modes (core/exoshuffle.
     distributed_sort_payload, W = 8, 23 payload words): `payload.identity`
     holds both modes on the card against the CPU's plain versions at
     2^20 records; `payload.split` splits one call of each mode at 2^24
     records by kernel (torch.profiler), beside the map sort's device ms
     on the phase's own rows; `payload.full` runs 5 calls of each at
     2^24 records (1.68 GB, one round, blocks of 2^19): the median and
     range of their seconds, peak device memory and valsort of the last
     output; then the e2e example's twin at its defaults;
  7. `fleet`: the out-of-core sort of 2^24 records in 4 waves with the
     device merge, by a thread fleet and by 4 ProcessWorkers on the card
     (each child its own CUDA context) under the elastic driver, clean
     and with one child killed: output etags identical, valsort clean;
  8. `recursive`: the skew pass (sampled boundaries, recursive rounds) on
     2^20 zipf-keyed records, on the card and on the CPU: etags identical;
  9. `cloud`: a FunctionWorker fleet over FakeS3Backend on the card at
     2^20 records with invocation kills: etags identical to a thread
     fleet's;
 10. `quickstart`: the quickstart twin on the card (32k records, 8
     workers, 4 rounds), valsort clean; `groupby`: the group-by example
     (host numpy on a faulty tiered store), its validation clean;
 11. `epoch.identity`: device_epoch_shuffle of 2^20 ids over 8 workers on
     the card and the CPU, bit-identical; `epoch.full`: 2^24 ids, epochs
     3 and 4 on the card, true permutations that differ;
 12. `moe.identity`: the MoE sort dispatch at qwen2-moe-a2.7b's expert
     widths (E = 64, K = 4, d = 2048, d_ff = 1408, T = 512) in float32
     with TF32 off, at ep_size 1 and 4 on the card and the CPU, against
     the onehot baseline on the card;
 13. `serve.identity`: qwen2-moe-a2.7b at full width, 2 layers, float32,
     card against CPU (prefill logits, greedy tokens); `serve.full`: the
     same model at full width and depth in bfloat16 on the card, 4
     requests of 128-token prompts, 32 greedy tokens each, through
     repro_torch.serve.engine.generate: parameter count, peak memory,
     prefill ms, decode ms a step, tokens/s;
 14. prints nvidia-smi's own name/power-limit line, the `kernels` JSON
     line (each kernel's launches on the full run, and per phase) and,
     last, the `ok` line.

Each of the phases 5-13 zeroes every kernel's launch count just before
its runs and reads it just after (a process fleet's children report
theirs at each phase end), and fails if a kernel of its path never
launched, or, where the path runs none of the four kernels (the
group-by, the MoE dispatch and serving), if one did. Then (`<phase>.hold`) it holds each kernel bit-identical to
its plain version on the card at every shape the phase launched it at
(the wrappers record their launch shapes; children report theirs too),
on fresh random inputs.

Every other stdout line is one JSON object. Any failure exits non-zero
without the `ok` line; so does a machine without a CUDA card, or a
directory without the port beside this script.
"""
import argparse
import contextlib
import dataclasses
import io
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
L2_BYTES = 50 << 20  # H100 L2
TIMED_CALLS = 20  # back-to-back calls between one pair of events
SLEEP_CYCLES_PER_S = 2e9  # torch.cuda._sleep cycles a second (~the SM clock)
SEED = 20231
NUM_WORKERS = 8  # W of the example (the reference's 8-device mesh)
WAVES = 4  # map waves of the full run: 4x out of core
FULL_WAVE_RECORDS = 1 << 24  # 1.68 GB of 100-byte records: the paper's block
IDENTITY_RECORDS = 1 << 20
PAYLOAD_WORDS = 23  # 100-byte records
PAYLOAD_TIMED_CALLS = 5  # back-to-back payload calls of each mode
FLEET_WORKERS = 4
FLEET_KILL_AFTER = 3  # the killed child dies at its 4th task pop
EPOCH_FULL_IDS = 1 << 24  # sample ids of the full epoch shuffle
EPOCHS = (3, 4)
MOE_SHAPE = dict(experts=64, top_k=4, d=2048, d_ff=1408, tokens=512)
MOE_CAPACITY_FACTOR = 4.0  # room for every routed pair: the paths compare
MOE_TOL = 1e-4  # max |diff| of the dispatches (tests/test_exoshuffle.py's)
SERVE_ARCH = "qwen2-moe-a2.7b"
SERVE_IDENTITY_LAYERS = 2
SERVE_REQUESTS = 4
SERVE_IDENTITY_PROMPT, SERVE_IDENTITY_NEW = 32, 8
SERVE_FULL_PROMPT, SERVE_FULL_NEW = 128, 32
SERVE_TOL = 1e-4  # max |diff| of float32 prefill logits, card vs CPU
DEVICE = "cuda"
BUCKET = "cloudsort"


def emit(**obj):
    print(json.dumps(obj), flush=True)


def mem_rate(name: str) -> float:
    """Device-memory bytes/s of the card (H100 SXM 3.35 TB/s; PCIe 2.0)."""
    return 2.0e12 if "PCIe" in name else 3.35e12


def rotation(inputs):
    """`inputs` and enough clones of it that together they hold at least
    3x the L2: a run that cycles through them finds each copy cold."""
    size = sum(t.numel() * t.element_size() for t in inputs)
    n = max(2, -(-3 * L2_BYTES // max(size, 1)))
    return [inputs] + [tuple(t.clone() for t in inputs)
                       for _ in range(n - 1)]


def host_us(fn, inputs, reps=20) -> float:
    """Median host µs of one fn(*inputs) call: the wrapper's Python work
    and the enqueue, not the device's time."""
    fn(*inputs)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*inputs)
        times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def device_ms(fn, copies, calls, host_s) -> float:
    """Device ms of one call, amortized over `calls` back-to-back calls
    between one pair of CUDA events, rotating over `copies` (after a
    warm-up over them). A sleep kernel ahead of the first event holds the
    card until the host has enqueued the calls (~host_s each), so the
    window holds device time, not the host's."""
    for c in copies:
        fn(*c)
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_S * (1.5 * calls * host_s + 1e-3)))
    s.record()
    for i in range(calls):
        fn(*copies[i % len(copies)])
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / calls


def fragments(rng, keys, pw):
    """A reduce window as merge_fragments takes it: for each uint32 key
    array, [(keys, ids, payload, k64)] sorted on (key, id), with random
    ids in 0..3 and pw random payload words a record."""
    out = []
    for k in keys:
        i = rng.integers(0, 4, k.size).astype(np.uint32)
        k64 = k.astype(np.uint64) << np.uint64(32) | i
        o = np.argsort(k64, kind="stable")
        p = rng.integers(0, 2**32, (k.size, pw), dtype=np.uint64).astype(
            np.uint32)
        out.append((k[o], i[o], p[o], k64[o]))
    return out


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


def kernel_split(fn, *args):
    """[kernel name, device µs] of each kernel one fn(*args) call
    launches, in launch order, from a torch.profiler trace of the call
    (warm: its inputs were just used)."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)

    def short(name):  # "void (anonymous namespace)::k<4>(...)" -> "k<4>"
        name = name.replace("(anonymous namespace)::", "").split("(")[0]
        return name.replace("void ", "").strip()

    return [[short(e.name), e.time_range.elapsed_us()] for e in evs]


#: Name prefixes of this port's kernels in a profiler trace.
OUR_KERNELS = ("bitonic_tile", "bitonic_global", "partition_count",
               "merge_tiles", "kway_rank_scatter")


def device_split(fn, *args):
    """Device µs of one fn(*args) call from kernel_split, grouped by
    kernel name (template arguments dropped): the total, this port's
    kernels' share, and the eight largest groups."""
    per = {}
    for name, us in kernel_split(fn, *args):
        base = name.split("<")[0].split("::")[-1]
        per[base] = per.get(base, 0.0) + us
    return {"device_us": sum(per.values()),
            "our_kernels_us": sum(us for n, us in per.items()
                                  if n.startswith(OUR_KERNELS)),
            "top_us": sorted(per.items(), key=lambda kv: -kv[1])[:8]}


def host_split(fn, *args):
    """The host side of one fn(*args) call from a torch.profiler trace of
    CPU and CUDA activity: its ops by self CPU µs (the ten largest, with
    their counts; the profiler's own cost inflates them, so read them as
    shares) and the count of each CUDA runtime call (kernel launches,
    copies, synchronisations)."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    avg = prof.key_averages()
    rows = sorted(([e.key, e.count, e.self_cpu_time_total] for e in avg),
                  key=lambda r: -r[2])
    return {"host_self_us": sum(r[2] for r in rows),
            "top_self_cpu_us": rows[:10],
            "cuda_runtime_calls": {e.key: e.count for e in avg
                                   if e.key.startswith("cuda")}}


def ptxas_summary(logs):
    """'<kernel>: <line>' for each register-count and spill line of the
    `nvcc -Xptxas -v` logs (one log per source)."""
    out, fn = [], None
    for text in logs.values():
        for ln in text.splitlines():
            ln = ln.strip()
            if "Function properties for" in ln:
                fn = ln.rsplit(" ", 1)[-1]
            elif fn and ("spill" in ln or "registers" in ln):
                out.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
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
    from repro_torch.kernels import _build, kway_merge
    from repro_torch.kernels.bitonic_sort import (bitonic_sort_blocks,
                                                  bitonic_sort_blocks_plain,
                                                  sort_plan)
    from repro_torch.kernels.kway_merge import (
        kway_merge_indexed, kway_merge_indexed_plain,
        merge_sorted_pairs_indexed, merge_sorted_pairs_indexed_plain)
    from repro_torch.kernels.merge_sorted import (merge_sorted_pairs,
                                                  merge_sorted_pairs_plain)
    from repro_torch.kernels.range_partition import (
        partition_offsets_blocks, partition_offsets_blocks_plain)
    from repro_torch.shuffle.runtime import merge_fragments

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

    def misaligned(t):
        """A contiguous copy of t whose data starts 4 bytes past a 16-byte
        boundary: the partition's 4-byte-load path."""
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    def window(case, k, L, fill):
        """A (K, L) window of triples on the CPU as merge_fragments_device
        pads it: round(fill * K) runs of real records (at least one),
        ordinals counting across them, then pads."""
        live = max(1, round(fill * k))
        total = live * L
        keys = np.full((k, L), 0xFFFFFFFF, np.uint32)
        vals = keys.copy()
        idx = np.full((k, L), total, np.int32)
        for r in range(live):
            kk = draw(case, (L,))
            vv = rng.integers(0, 3, L).astype(np.uint32)
            order = np.lexsort((vv, kk))
            keys[r], vals[r] = kk[order], vv[order]
            idx[r] = np.arange(r * L, (r + 1) * L)
        return (u32.from_numpy(keys, "cpu"), u32.from_numpy(vals, "cpu"),
                torch.from_numpy(idx))

    bound_sets = ([], [3], [1, 2**31], [0, 0, 5, 5, 0xFFFFFFFF],
                  sorted(rng.integers(0, 2**32, 12).tolist()),
                  list(range(100)))  # R = 0, 1, 2, 5, 12, 100
    n_checks = 0
    for case in cases:
        # sort: below, at and above the warp span (512) and the tile (2^13),
        # and rows whose windows take 1..5 fused global substages
        for shape in ((1, 1), (3, 2), (4, 256), (2, 512), (2, 4096),
                      (2, 8192), (1, 1 << 14), (2, 1 << 15), (1, 1 << 17),
                      (1, 1 << 19)):
            kc = u32.from_numpy(draw(case, shape), "cpu")
            vc = u32.from_numpy(rng.integers(0, 3, shape).astype(np.uint32),
                                "cpu")
            kd, vd = kc.to(dev), vc.to(dev)
            got = bitonic_sort_blocks(kd, vd)
            check_equal("sort", got, bitonic_sort_blocks_plain(kd, vd))
            check_equal("sort-ref", got, ref.sort_kv_ref(kc, vc))
            n_checks += 2
            for bounds in bound_sets[1::2]:
                bt = u32.from_numpy(np.array(bounds, np.uint32), dev)
                for keys in (got[0], kd):  # sorted rows, unsorted rows
                    check_equal("partition",
                                (partition_offsets_blocks(keys, bt),),
                                (partition_offsets_blocks_plain(keys, bt),))
                    n_checks += 1
        # partition: ragged rows (B % 4 != 0), B = 0, many short rows, the
        # main path's row length; aligned and misaligned starts
        for shape in ((3, 1001), (2, 6), (1000, 3), (5, 0), (2, 1 << 20)):
            kd = u32.from_numpy(draw(case, shape), dev)
            for keys in (kd, misaligned(kd)):
                for bounds in bound_sets:
                    bt = u32.from_numpy(np.array(bounds, np.uint32), dev)
                    check_equal("partition",
                                (partition_offsets_blocks(keys, bt),),
                                (partition_offsets_blocks_plain(keys, bt),))
                    n_checks += 1
        # merge: rows below one tile (2L < 2048 outputs), at it and above;
        # aligned rows (16-byte path) and misaligned ones (4-byte path)
        for shape in ((1, 1), (5, 2), (5, 4), (3, 256), (2, 1024), (2, 4096),
                      (1, 1 << 15)):
            a, b = cpu_sorted(case, shape), cpu_sorted(case, shape)
            got_m = merge_sorted_pairs(*(t.to(dev) for t in a + b))
            check_equal("merge", got_m, merge_sorted_pairs_plain(*a, *b))
            got_m = merge_sorted_pairs(*(misaligned(t.to(dev)) for t in a + b))
            check_equal("merge-misaligned", got_m,
                        merge_sorted_pairs_plain(*a, *b))
            n_checks += 2
            ai = torch.arange(a[0].numel(), dtype=torch.int32).reshape(shape)
            trip = (a[0], a[1], ai, b[0], b[1], ai + a[0].numel())
            got_i = merge_sorted_pairs_indexed(*(t.to(dev) for t in trip))
            check_equal("merge-idx", got_i,
                        merge_sorted_pairs_indexed_plain(*trip))
            n_checks += 1
        # the K-way window, one launch, against the plain tournament:
        # windows padded as merge_fragments_device pads them (ordinals,
        # then lex-max pads with ordinal = total; whole runs of pads too)
        for k in (2, 4, 8):
            for L in (1, 64, 4096):
                for fill in (1.0, 0.6):
                    keys, vals, idx = window(case, k, L, fill)
                    got_w = kway_merge_indexed(keys.to(dev), vals.to(dev),
                                               idx.to(dev))
                    check_equal("kway-window", got_w,
                                kway_merge_indexed_plain(keys, vals, idx))
                    n_checks += 1
        # whole windows through merge_fragments_device, against the numpy
        # merge the host reduce runs: empty and one-record fragments,
        # duplicates, keys equal to the pad
        for sizes in ((97, 1, 256, 33, 0, 128), (5, 9), (3000, 0, 2000, 7)):
            frags = fragments(rng, [draw(case, (n,)) for n in sizes], 3)
            want = merge_fragments(frags, 3)
            got = kway_merge.merge_fragments_device(frags, 3, device=dev)
            for g, w in zip(got, want):
                if not np.array_equal(g, w):
                    raise AssertionError(f"merge_fragments_device {case} "
                                         f"{sizes}: differs from numpy")
            n_checks += 1
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

    def record(name, source, replaces, shape, inputs, kern, plain, lib,
               lib_inputs, nbytes, nops, listed=True, **extra):
        """kern, plain and lib are functions of *inputs (lib of
        *lib_inputs). Times: kernel and library in turns (K, L, L, K),
        each turn amortized over TIMED_CALLS cold-L2 calls."""
        err = check_equal(name, kern(*inputs), plain(*inputs))
        copies, lib_copies = rotation(inputs), rotation(lib_inputs)
        k_host, l_host = host_us(kern, inputs), host_us(lib, lib_inputs)
        p_host = host_us(plain, inputs, reps=1)
        turns = {"kernel": [], "library": []}
        for who in ("kernel", "library", "library", "kernel"):
            fn, cs, hs = ((kern, copies, k_host) if who == "kernel"
                          else (lib, lib_copies, l_host))
            turns[who].append(device_ms(fn, cs, TIMED_CALLS, hs * 1e-6))
        plain_ms = device_ms(plain, copies, 2, p_host * 1e-6)
        bound_bytes, bound_ops = nbytes / rate * 1e3, nops / NON_TENSOR_OPS * 1e3
        row = dict(name=name, route="cuda", source=source, replaces=replaces,
                   shape=shape, launches=0, max_abs_err=err,
                   ms=statistics.mean(turns["kernel"]), plain_ms=plain_ms,
                   bound_ms=max(bound_bytes, bound_ops),
                   bound_by="bytes" if bound_bytes >= bound_ops
                   else "operations",
                   library_ms=statistics.mean(turns["library"]),
                   l2="cold", host_us=k_host, **extra)
        emit(phase="kernel", turns_ms=turns, copies=len(copies),
             calls=TIMED_CALLS, **row)
        if listed:
            rows.append(row)
        del copies, lib_copies
        torch.cuda.empty_cache()

    csrc = "src/repro_torch/kernels/csrc/"
    # sort (W, per_round): the map sort of every round
    nb, b = w, per_round
    k, v = rand((nb, b)), rand((nb, b))
    record("bitonic_sort_blocks", csrc + "bitonic_sort.cu",
           "src/repro/kernels/bitonic_sort.py:97", [nb, b], (k, v),
           bitonic_sort_blocks, bitonic_sort_blocks_plain,
           lambda p: torch.sort(p, dim=-1), (u32.pack(k, v),),
           16 * nb * b, nb * b * max(b.bit_length() - 1, 1),
           passes=len(sort_plan(b)))
    split = kernel_split(bitonic_sort_blocks, k, v)
    emit(phase="kernel.split", name="bitonic_sort_blocks", plan=sort_plan(b),
         kernels=split, device_us=sum(t for _, t in split))
    # the payload path's sort (one round of one paper block over W
    # workers), unlisted: its time beside the listed row's
    b2 = FULL_WAVE_RECORDS // w
    k2, v2 = rand((nb, b2)), rand((nb, b2))
    record("bitonic_sort_blocks", csrc + "bitonic_sort.cu",
           "src/repro/kernels/bitonic_sort.py:97", [nb, b2], (k2, v2),
           bitonic_sort_blocks, bitonic_sort_blocks_plain,
           lambda p: torch.sort(p, dim=-1), (u32.pack(k2, v2),),
           16 * nb * b2, nb * b2 * (b2.bit_length() - 1),
           listed=False, passes=len(sort_plan(b2)))
    del k2, v2
    # partition (W, per_round) x W-1 worker boundaries, on sorted rows
    from repro_torch.core.keyspace import KeySpace

    sk = bitonic_sort_blocks(k, v)[0]
    del k, v
    wb = KeySpace(num_reducers=w * r1, num_workers=w).worker_boundaries(dev)
    wb64 = u32.widen(wb).reshape(1, -1).expand(nb, -1).contiguous()
    record("partition_offsets_blocks", csrc + "range_partition.cu",
           "src/repro/kernels/range_partition.py:76", [nb, b, wb.numel()],
           (sk, wb), lambda *a: (partition_offsets_blocks(*a),),
           lambda *a: (partition_offsets_blocks_plain(*a),),
           torch.searchsorted, (u32.widen(sk), wb64),
           4 * nb * b + 4 * wb.numel() + 4 * nb * wb.numel(),
           nb * b * wb.numel(), passes=1)
    del sk
    # merge: first tournament round (W*W/2, C) — the listed row — and the
    # stage-2 merge (W*rounds/2, W*C): the two ends of the path's shapes
    for i, (n, L) in enumerate(((w * w // 2, cap),
                                (w * plan.num_rounds // 2, w * cap))):
        a, bb = sorted_rows((n, L)), sorted_rows((n, L))
        record("merge_sorted_pairs", csrc + "merge_sorted.cu",
               "src/repro/kernels/merge_sorted.py:53", [n, L], (*a, *bb),
               merge_sorted_pairs, merge_sorted_pairs_plain,
               lambda c: torch.sort(c, dim=-1),
               (torch.cat([u32.pack(*a), u32.pack(*bb)], dim=-1),),
               32 * n * L, 2 * n * L, listed=i == 0)
        del a, bb
    # the launch floor: an empty kernel, launched through the same ctypes
    # path, timed like the kernels (back-to-back calls between events)
    noop = _build.function("noop")

    def empty():
        noop(torch.cuda.current_stream().cuda_stream)

    floor_host = host_us(empty, ())
    floor_ms = statistics.mean(device_ms(empty, [()], TIMED_CALLS,
                                         floor_host * 1e-6) for _ in range(2))
    emit(phase="kernel.launch_floor", ms=floor_ms, host_us=floor_host)
    # indexed merge: one reduce emit window, K = next_pow2(WAVES) runs of L
    # records, all K in one launch. The full run's windows hold ~10^4
    # records (L ~ 2^12); 2^14 is the most a 1 MiB merge chunk allows.
    k = ops.next_pow2(WAVES)
    for i, L in enumerate((1 << 12, 1 << 14)):
        a = sorted_rows((k, L))
        ai = torch.arange(k * L, dtype=torch.int32, device=dev).reshape(k, L)
        inputs = (a[0], a[1], ai)
        warm = device_ms(kway_merge_indexed, [inputs], TIMED_CALLS,
                         host_us(kway_merge_indexed, inputs) * 1e-6)
        record("merge_sorted_pairs_indexed", csrc + "kway_merge.cu",
               "src/repro/kernels/kway_merge.py:126", [k, L], inputs,
               kway_merge_indexed, kway_merge_indexed_plain,
               lambda c: torch.sort(c, dim=-1, stable=True),
               (u32.pack(*a).reshape(1, -1),), 24 * k * L,
               k * L * (k.bit_length() - 1), listed=i == 0, warm_ms=warm,
               launch_floor_ms=floor_ms)
        del a, ai, inputs
    # one whole merge_fragments_device call at (4, 2^12): k fragments of
    # L records and the full run's payload rows, host µs including the
    # copies, the launch, the synchronise and the payload gather
    L = 1 << 12
    frags = fragments(rng, [draw("random", (L,)) for _ in range(k)],
                      plan.payload_words)
    call = lambda: kway_merge.merge_fragments_device(  # noqa: E731
        frags, plan.payload_words, device=dev)
    emit(phase="kernel.window", shape=[k, L],
         payload_words=plan.payload_words, host_us=host_us(call, ()))
    return rows


def phase_window_split(plan, mean_records):
    """Host µs of each step of one reduce window at the full run's mean
    size (WAVES fragments, the plan's payload): merge_fragments_device's
    own split (pad, H2D, kernel, D2H, payload gather; the card
    synchronised after each step), then encode_body. Medians of 20."""
    from repro_torch.io import records as rec
    from repro_torch.kernels.kway_merge import merge_fragments_device

    rng = np.random.default_rng(SEED)
    n, pw = max(1, round(mean_records / WAVES)), plan.payload_words
    frags = fragments(rng, [rng.integers(0, 2**32, n, dtype=np.uint64)
                            .astype(np.uint32) for _ in range(WAVES)], pw)
    steps, whole = {}, []
    for _ in range(20):
        split = {}
        mk, mi, mp = merge_fragments_device(frags, pw, device=DEVICE,
                                            split=split)
        t0 = time.perf_counter()
        rec.encode_body(mk, mi, mp)
        split["encode_body"] = (time.perf_counter() - t0) * 1e6
        for step, us in split.items():
            steps.setdefault(step, []).append(us)
        t0 = time.perf_counter()
        merge_fragments_device(frags, pw, device=DEVICE)
        whole.append((time.perf_counter() - t0) * 1e6)
    emit(phase="window.split", fragments=WAVES, records=WAVES * n,
         payload_words=pw,
         host_us={k: statistics.median(v) for k, v in steps.items()},
         call_host_us=statistics.median(whole))


def full_plan():
    """The full run's plan: waves of FULL_WAVE_RECORDS 100-byte records."""
    from repro_torch.core.external_sort import ExternalSortPlan

    return ExternalSortPlan(
        records_per_wave=FULL_WAVE_RECORDS, num_rounds=2, reducers_per_worker=4,
        payload_words=23, impl="kernel",
        input_records_per_partition=FULL_WAVE_RECORDS // 4,
        output_part_records=1 << 16, store_chunk_bytes=8 << 20,
        merge_chunk_bytes=1 << 20, parallel_reducers=4,
        reduce_memory_budget_bytes=32 << 20, reduce_merge_impl="device")


def layout(root, prefix="output/"):
    from repro_torch.io.backends import FilesystemBackend

    return store_layout(FilesystemBackend(os.path.join(root, "durable")),
                        prefix)


def store_layout(store, prefix="output/"):
    return [(m.key, m.etag, m.size, m.parts)
            for m in store.list_objects(BUCKET, prefix)]


def zero_launches(wrappers):
    """Every wrapper's launch count to 0 and its set of shapes emptied."""
    for fn in wrappers.values():
        fn.launches = 0
        fn.shapes = set()
    torch.cuda.synchronize()


def read_launches(wrappers, extra=()):
    """Each wrapper's launch count, plus the counts in `extra` (dicts
    reported by other processes)."""
    torch.cuda.synchronize()
    out = {n: fn.launches for n, fn in wrappers.items()}
    for counts in extra:
        for n, c in counts.items():
            out[n] += c
    return out


def require_launched(phase, launches, names):
    for n in names:
        if launches[n] <= 0:
            raise AssertionError(f"{phase}: kernel {n} was never launched")


def hold_shapes(phase, wrappers, extra=()):
    """Each kernel bit-identical to its plain version on the card at every
    shape the phase launched it at: the wrappers' `shapes`, and those in
    `extra` (dicts of shapes reported by other processes), on fresh
    random inputs, rows sorted where the kernel takes sorted rows. Run
    after the phase's launches are read: these launches are not counted.
    """
    from repro_torch.kernels import u32
    from repro_torch.kernels.bitonic_sort import bitonic_sort_blocks_plain
    from repro_torch.kernels.kway_merge import (
        kway_merge_indexed, kway_merge_indexed_plain,
        merge_sorted_pairs_indexed_plain)
    from repro_torch.kernels.merge_sorted import merge_sorted_pairs_plain
    from repro_torch.kernels.range_partition import (
        partition_offsets_blocks_plain)

    shapes = {n: set(fn.shapes) for n, fn in wrappers.items()}
    for more in extra:
        for n, got in more.items():
            shapes[n] |= {tuple(sh) for sh in got}
    rng = np.random.default_rng(SEED)
    dev = torch.device(DEVICE)

    def rand(shape):
        return u32.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64)
                              .astype(np.uint32), dev)

    def sorted_rows(shape):
        packed, _ = torch.sort(u32.pack(rand(shape), rand(shape)), dim=-1)
        return u32.unpack(packed)

    def label(name, shape):
        return f"{phase}: {name} at {list(shape)}"

    for shape in sorted(shapes["bitonic_sort_blocks"]):
        k, v = rand(shape), rand(shape)
        check_equal(label("sort", shape),
                    wrappers["bitonic_sort_blocks"](k, v),
                    bitonic_sort_blocks_plain(k, v))
    for nb, b, r in sorted(shapes["partition_offsets_blocks"]):
        keys = sorted_rows((nb, b))[0]
        bounds = u32.from_numpy(np.sort(rng.integers(
            0, 2**32, r, dtype=np.uint64)).astype(np.uint32), dev)
        check_equal(label("partition", (nb, b, r)),
                    (wrappers["partition_offsets_blocks"](keys, bounds),),
                    (partition_offsets_blocks_plain(keys, bounds),))
    for shape in sorted(shapes["merge_sorted_pairs"]):
        a, b = sorted_rows(shape), sorted_rows(shape)
        check_equal(label("merge", shape),
                    wrappers["merge_sorted_pairs"](*a, *b),
                    merge_sorted_pairs_plain(*a, *b))
    for n, k, L in sorted(shapes["merge_sorted_pairs_indexed"]):
        # rows sorted on (key, val) with ordinals rising along each row
        # are sorted on (key, val, idx)
        keys, vals = sorted_rows((n * k, L))
        idx = torch.arange(n * k * L, dtype=torch.int32,
                           device=dev).reshape(n * k, L)
        if n == 1:  # one window of K runs (kway_merge_indexed)
            got = kway_merge_indexed(keys, vals, idx)
            want = kway_merge_indexed_plain(keys, vals, idx)
        elif k == 2:  # n pairs (merge_sorted_pairs_indexed)
            trip = tuple(t[i::2].contiguous() for i in (0, 1)
                         for t in (keys, vals, idx))
            got = wrappers["merge_sorted_pairs_indexed"](*trip)
            want = merge_sorted_pairs_indexed_plain(*trip)
        else:
            raise AssertionError(f"{phase}: no wrapper launches the indexed "
                                 f"merge at n={n}, K={k}")
        check_equal(label("indexed merge", (n, k, L)), got, want)
    torch.cuda.empty_cache()
    held = {n: [list(sh) for sh in sorted(s)] for n, s in shapes.items()}
    emit(phase=f"{phase}.hold", shapes=held,
         checks=sum(len(s) for s in held.values()), identical=True)


def phase_payload_identity():
    """Both payload modes at IDENTITY_RECORDS on the card and on
    the CPU (plain versions): keys, ids, valid counts and the overflow
    flag bit-identical; payload rows whole in the through mode, each
    worker's valid prefix in the late mode (the reference leaves pad
    rows unspecified there; whether they agree too is reported)."""
    from repro_torch.core.exoshuffle import (ShuffleConfig,
                                             distributed_sort_payload)
    from repro_torch.data import gensort
    from repro_torch.kernels import u32

    n, w = IDENTITY_RECORDS, NUM_WORKERS
    keys, ids = gensort.gen_keys(0, n, "cpu")
    payload = gensort.gen_payload(ids, PAYLOAD_WORDS)
    keys, ids, payload = (u32.to_numpy(t) for t in (keys, ids, payload))
    cfg = ShuffleConfig(num_workers=w, reducers_per_worker=4)
    for mode in ("through", "late"):
        outs, secs = {}, {}
        for device in (DEVICE, "cpu"):
            t0 = time.perf_counter()
            sk, si, sp, vc, ovf = distributed_sort_payload(
                keys, ids, payload, num_workers=w, mode=mode, cfg=cfg,
                device=device)
            outs[device] = (u32.to_numpy(sk), u32.to_numpy(si),
                            u32.to_numpy(sp), vc.cpu().numpy(), ovf)
            secs[device] = time.perf_counter() - t0
        card, cpu = outs[DEVICE], outs["cpu"]
        for i, what in enumerate(("keys", "ids")):
            if not np.array_equal(card[i], cpu[i]):
                raise AssertionError(f"payload.identity {mode}: {what} "
                                     "differ between card and CPU")
        if not np.array_equal(card[3], cpu[3]) or card[4] != cpu[4]:
            raise AssertionError(f"payload.identity {mode}: valid counts "
                                 "or overflow differ")
        if card[4] or int(card[3].sum()) != n:
            raise AssertionError(f"payload.identity {mode}: overflow")
        seg = card[2].shape[0] // w
        for d in range(w):
            lo, hi = d * seg, d * seg + int(card[3][d])
            if not np.array_equal(card[2][lo:hi], cpu[2][lo:hi]):
                raise AssertionError(f"payload.identity {mode}: worker {d}'s "
                                     "payload rows differ")
        whole = bool(np.array_equal(card[2], cpu[2]))
        if mode == "through" and not whole:
            raise AssertionError("payload.identity through: pad rows differ")
        emit(phase="payload.identity", mode=mode, records=n, workers=w,
             payload_words=PAYLOAD_WORDS, rows=int(card[2].shape[0]),
             overflow=bool(card[4]), card_s=secs[DEVICE], cpu_s=secs["cpu"],
             identical=True, pad_rows_identical=whole)


def phase_payload_full(wrappers, log):
    """Both payload modes at FULL_WAVE_RECORDS on the card (W = 8, one
    round): PAYLOAD_TIMED_CALLS back-to-back calls of each, the last one's
    output through valsort (keys, ids and payload); then the e2e
    example's twin at its defaults; the launch counts of this phase, and
    each kernel held to its plain version at the shapes it launched at."""
    from repro_torch.core.exoshuffle import (ShuffleConfig,
                                             distributed_sort_payload)
    from repro_torch.data import gensort, valsort
    from repro_torch.examples import cloudsort_e2e

    n, w = FULL_WAVE_RECORDS, NUM_WORKERS
    keys, ids = gensort.gen_keys(0, n, DEVICE)
    payload = gensort.gen_payload(ids, PAYLOAD_WORDS)
    in_ck = gensort.checksum(keys, ids, payload)
    cfg = ShuffleConfig(num_workers=w, reducers_per_worker=4)
    rounds = w.bit_length() - 1  # merge tournament rounds
    sort = wrappers["bitonic_sort_blocks"]
    rows = (keys.reshape(w, n // w), ids.reshape(w, n // w))
    sort_copies = rotation(rows)
    # the map sort on this phase's own rows, cold, as the kernel rows time
    sort_ms = device_ms(sort, sort_copies, TIMED_CALLS,
                        host_us(sort, rows) * 1e-6)
    del sort_copies
    for mode in ("through", "late"):  # where one call's device time goes
        emit(phase="payload.split", mode=mode, records=n,
             sort_shape=list(rows[0].shape), sort_ms=sort_ms,
             **device_split(
                 lambda mode=mode: distributed_sort_payload(
                     keys, ids, payload, num_workers=w, mode=mode, cfg=cfg,
                     device=DEVICE)))
        torch.cuda.empty_cache()
    zero_launches(wrappers)
    expect = {n_: 0 for n_ in wrappers}
    for mode in ("through", "late"):
        before = read_launches(wrappers)
        torch.cuda.reset_peak_memory_stats()
        secs, out = [], None
        for _ in range(PAYLOAD_TIMED_CALLS):
            out = None  # the previous call's outputs go before the next
            t0 = time.perf_counter()
            out = distributed_sort_payload(
                keys, ids, payload, num_workers=w, mode=mode, cfg=cfg,
                device=DEVICE)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        after = read_launches(wrappers)
        sk, si, sp, vc, ovf = out
        out = None
        if ovf:
            raise AssertionError(f"payload.full {mode}: block overflow")
        t0 = time.perf_counter()
        ks, iss, ps = valsort.slice_segments(sk, si, vc, sp)
        val = valsort.validate(ks, iss, in_ck, ps, device=DEVICE)
        val_s = time.perf_counter() - t0
        med = statistics.median(secs)
        emit(phase="payload.full", mode=mode, records=n, workers=w,
             payload_words=PAYLOAD_WORDS,
             record_bytes=4 * (2 + PAYLOAD_WORDS),
             block_capacity=cfg.block_capacity(n // w), calls=len(secs),
             seconds=med, seconds_min=min(secs), seconds_max=max(secs),
             seconds_each=secs, records_per_s=n / med,
             max_memory_allocated=peak,
             launches={k: after[k] - before[k] for k in after},
             valsort_ok=val.ok, records_checked=val.total_records,
             checksum=list(val.output_checksum), valsort_s=val_s)
        if not val.ok or val.total_records != n:
            raise AssertionError(f"payload.full {mode}: valsort failed")
        calls = PAYLOAD_TIMED_CALLS
        for k in ("bitonic_sort_blocks", "partition_offsets_blocks"):
            expect[k] += calls
        expect["partition_offsets_blocks"] += calls * (mode == "late")
        expect["merge_sorted_pairs"] += calls * rounds
        del sk, si, sp, ks, iss, ps
        torch.cuda.empty_cache()
    del keys, ids, payload, rows
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        out = cloudsort_e2e.main(["--device", DEVICE])
    emit(phase="payload.e2e", seconds=time.perf_counter() - t0,
         **{k: v for k, v in out.items() if k != "checksum"})
    if not out["valsort_ok"]:
        raise AssertionError("payload.e2e: valsort failed")
    expect["bitonic_sort_blocks"] += 1
    expect["partition_offsets_blocks"] += 1 + w  # + each worker's R1 split
    expect["merge_sorted_pairs"] += rounds
    launches = read_launches(wrappers)
    if launches != expect:
        raise AssertionError(f"payload: launches {launches}, expected "
                             f"{expect} (one sort and one worker split a "
                             "call, one producer split a late fetch, "
                             f"{rounds} merge rounds, the example's "
                             "reducer splits)")
    hold_shapes("payload", wrappers)
    return launches


def small_plan(full, **kw):
    """A plan of IDENTITY_RECORDS in WAVES waves, as the identity phase's."""
    return dataclasses.replace(full, **{
        "records_per_wave": IDENTITY_RECORDS // WAVES,
        "input_records_per_partition": IDENTITY_RECORDS // 16,
        "output_part_records": 1 << 13, "store_chunk_bytes": 1 << 20,
        "merge_chunk_bytes": 256 << 10, "parallel_reducers": 2,
        "reduce_memory_budget_bytes": 2 << 20, **kw})


def phase_fleet(full, wrappers):
    """FULL_WAVE_RECORDS in 4 waves with the device merge, three ways under
    the elastic driver: 4 ThreadWorkers; 4 ProcessWorkers on the card,
    clean; the same with one child killed. Output etags identical,
    valsort clean, and the killed run recovered (a failed worker and a
    recovery round)."""
    from repro_torch.data import gensort, valsort
    from repro_torch.io.object_store import ObjectStore
    from repro_torch.shuffle.elastic import FleetPlan
    from repro_torch.shuffle.executor import ThreadWorker
    from repro_torch.shuffle.procworker import ProcessWorker
    from repro_torch.shuffle.sort import sort_shuffle_job

    plan = dataclasses.replace(
        full, records_per_wave=FULL_WAVE_RECORDS // WAVES,
        input_records_per_partition=FULL_WAVE_RECORDS // 16)
    root = os.path.join(WORK_DIR, "store-fleet")
    shutil.rmtree(root, ignore_errors=True)
    store = ObjectStore(root)
    store.create_bucket(BUCKET)
    t0 = time.perf_counter()
    in_ck, _ = gensort.write_to_store(
        store, BUCKET, plan.input_prefix, FULL_WAVE_RECORDS,
        plan.input_records_per_partition, plan.payload_words, device=DEVICE)
    emit(phase="fleet.plan", records=FULL_WAVE_RECORDS, waves=WAVES,
         workers=FLEET_WORKERS, record_bytes=plan.record_bytes,
         reduce_merge_impl=plan.reduce_merge_impl,
         kill_after_tasks=FLEET_KILL_AFTER,
         gen_s=time.perf_counter() - t0)
    zero_launches(wrappers)
    child_launches, child_shapes, layouts = [], [], {}
    for tag in ("thread", "process", "process_kill"):
        t0 = time.perf_counter()
        if tag == "thread":
            crew = [ThreadWorker(f"w{i}", store) for i in range(FLEET_WORKERS)]
        else:
            crew = []
            try:
                for i in range(FLEET_WORKERS):
                    kill = FLEET_KILL_AFTER if (tag == "process_kill"
                                                and i == 0) else None
                    crew.append(ProcessWorker(
                        f"p{i}", store=store, bucket=BUCKET, plan=plan,
                        num_workers=NUM_WORKERS, device=DEVICE,
                        die_after_tasks=kill))
            except BaseException:
                for wk in crew:
                    wk.close()
                raise
        spawn_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            crep = sort_shuffle_job(store, BUCKET, num_workers=NUM_WORKERS,
                                    plan=plan, device=DEVICE).run(
                worker_list=crew, fleet=FleetPlan())
        finally:
            for wk in crew:
                if isinstance(wk, ProcessWorker):
                    wk.close()
        secs = time.perf_counter() - t0
        children = [wk.launches for wk in crew
                    if isinstance(wk, ProcessWorker)]
        child_launches += children
        child_shapes += [wk.shapes for wk in crew
                         if isinstance(wk, ProcessWorker)]
        layouts[tag] = store_layout(store, plan.output_prefix)
        t0 = time.perf_counter()
        val = valsort.validate_from_store(
            store, BUCKET, plan.output_prefix, in_ck,
            chunk_records=plan.output_part_records, device=DEVICE)
        emit(phase="fleet.run", fleet=tag, workers=len(crew),
             spawn_s=spawn_s, seconds=secs,
             records_per_s=FULL_WAVE_RECORDS / secs,
             map_s=crep.report.map_seconds,
             reduce_s=crep.report.reduce_seconds,
             failed_workers=crep.failed_workers,
             recovery_rounds=crep.recovery_rounds,
             spill_lost_map_tasks=crep.spill_lost_map_tasks,
             reexecuted_map_tasks=crep.reexecuted_map_tasks,
             reexecuted_reduce_tasks=crep.reexecuted_reduce_tasks,
             per_worker_tasks=crep.per_worker_tasks,
             child_launches=children, outputs=len(layouts[tag]),
             valsort_ok=val.ok, valsort_s=time.perf_counter() - t0)
        if not val.ok or val.total_records != FULL_WAVE_RECORDS:
            raise AssertionError(f"fleet {tag}: valsort failed")
        if tag == "process_kill":
            if crep.failed_workers != ["p0"] or crep.recovery_rounds < 1:
                raise AssertionError(
                    f"fleet {tag}: expected p0 dead and a recovery round, "
                    f"got {crep.failed_workers}, {crep.recovery_rounds}")
        elif crep.failed_workers:
            raise AssertionError(f"fleet {tag}: {crep.failed_workers} died")
    launches = read_launches(wrappers, child_launches)
    for tag, got in layouts.items():
        if got != layouts["thread"]:
            raise AssertionError(f"fleet: the {tag} fleet's output etags "
                                 "differ from the thread fleet's")
    shutil.rmtree(root, ignore_errors=True)
    emit(phase="fleet", records=FULL_WAVE_RECORDS,
         outputs=len(layouts["thread"]),
         etags_identical=True, launches=launches)
    require_launched("fleet", launches, wrappers)
    hold_shapes("fleet", wrappers, child_shapes)
    return launches


def partition_imbalance(keys, bounds):
    """max/mean of the records in each range of `bounds` (uint32)."""
    counts = np.bincount(np.searchsorted(np.asarray(bounds, np.uint32), keys,
                                         side="right"),
                         minlength=len(bounds) + 1)
    return float(counts.max() / counts.mean())


def phase_recursive(full, wrappers):
    """recursive_sort of IDENTITY_RECORDS zipf-keyed records (sampled
    boundaries, a reduce budget below the hot partitions) on the card
    and on the CPU: output etags identical, valsort clean."""
    from repro_torch.core.keyspace import KeySpace
    from repro_torch.data import gensort, valsort
    from repro_torch.io.object_store import ObjectStore
    from repro_torch.kernels import u32
    from repro_torch.shuffle.recursive import recursive_sort

    plan = small_plan(full, capacity_factor=2.0, sample_fraction=1 / 16,
                      max_rounds=3, reduce_memory_budget_bytes=3_400_000)
    layouts = {}
    for device in (DEVICE, "cpu"):
        root = os.path.join(WORK_DIR, f"store-recursive-{device}")
        shutil.rmtree(root, ignore_errors=True)
        store = ObjectStore(root)
        store.create_bucket(BUCKET)
        in_ck, _ = gensort.write_to_store(
            store, BUCKET, plan.input_prefix, IDENTITY_RECORDS,
            plan.input_records_per_partition, plan.payload_words,
            skew="zipf", skew_seed=SEED, device=device)
        if device == DEVICE:
            zero_launches(wrappers)
        t0 = time.perf_counter()
        rep = recursive_sort(store, BUCKET, num_workers=NUM_WORKERS,
                             plan=plan, device=device)
        secs = time.perf_counter() - t0
        if device == DEVICE:
            launches = read_launches(wrappers)
        layouts[device] = store_layout(store, plan.output_prefix)
        val = valsort.validate_from_store(store, BUCKET, plan.output_prefix,
                                          in_ck, device=device)
        shutil.rmtree(root, ignore_errors=True)
        if not val.ok or val.total_records != IDENTITY_RECORDS:
            raise AssertionError(f"recursive {device}: valsort failed")
        emit(phase="recursive.run", device=device, seconds=secs,
             rounds=len(rep.rounds), depth=rep.num_rounds,
             recursed=len(rep.recursed), restaged=len(rep.restaged),
             outputs=rep.output_objects, valsort_ok=val.ok)
    if layouts[DEVICE] != layouts["cpu"]:
        raise AssertionError("recursive: card and CPU output etags differ")
    parts = NUM_WORKERS * plan.reducers_per_worker
    keys = gensort.skewed_keys(
        np.arange(IDENTITY_RECORDS, dtype=np.uint32), "zipf", SEED)
    equal = u32.to_numpy(KeySpace(num_reducers=parts,
                                  num_workers=NUM_WORKERS)
                         .reducer_boundaries("cpu"))
    emit(phase="recursive", records=IDENTITY_RECORDS, partitions=parts,
         imbalance_equal=partition_imbalance(keys, equal),
         imbalance_sampled=partition_imbalance(keys, rep.sample.boundaries),
         etags_identical=True, launches=launches)
    require_launched("recursive", launches, ("bitonic_sort_blocks",
                                             "partition_offsets_blocks",
                                             "merge_sorted_pairs"))
    hold_shapes("recursive", wrappers)
    return launches


def phase_cloud(full, wrappers):
    """An InvocationDriver of 4 FunctionWorkers over FakeS3Backend on the
    card at IDENTITY_RECORDS, one dying at a pop and one severed
    mid-invocation: output etags identical to a thread fleet's."""
    from repro_torch.cloud import FakeS3Backend, InvocationDriver
    from repro_torch.data import gensort, valsort
    from repro_torch.io.middleware import MetricsMiddleware
    from repro_torch.shuffle.sort import sort_shuffle_job

    plan = small_plan(full)
    store = MetricsMiddleware(FakeS3Backend(chunk_size=1 << 20))
    store.create_bucket(BUCKET)
    in_ck, _ = gensort.write_to_store(
        store, BUCKET, plan.input_prefix, IDENTITY_RECORDS,
        plan.input_records_per_partition, plan.payload_words, device=DEVICE)
    sort_shuffle_job(store, BUCKET, num_workers=NUM_WORKERS, plan=plan,
                     device=DEVICE).run(workers=FLEET_WORKERS)
    want = store_layout(store, plan.output_prefix)
    zero_launches(wrappers)
    t0 = time.perf_counter()
    drv = InvocationDriver(store, BUCKET, plan=plan, workers=FLEET_WORKERS,
                           num_workers=NUM_WORKERS, device=DEVICE,
                           die_after_invocations={0: 3},
                           fail_after_requests={1: 40})
    crep = drv.run()
    secs = time.perf_counter() - t0
    launches = read_launches(wrappers)
    inv = drv.invocations()
    val = valsort.validate_from_store(store, BUCKET, plan.output_prefix,
                                      in_ck, device=DEVICE)
    emit(phase="cloud", records=IDENTITY_RECORDS, functions=FLEET_WORKERS,
         seconds=secs, failed_workers=crep.failed_workers,
         invocations=len(inv), committed=sum(r.committed for r in inv),
         reexecuted_map_tasks=crep.reexecuted_map_tasks,
         reexecuted_reduce_tasks=crep.reexecuted_reduce_tasks,
         valsort_ok=val.ok, launches=launches)
    if store_layout(store, plan.output_prefix) != want:
        raise AssertionError("cloud: output etags differ from the thread "
                             "fleet's")
    if not val.ok or sorted(crep.failed_workers) != ["fn0", "fn1"]:
        raise AssertionError(f"cloud: valsort {val.ok}, failed workers "
                             f"{crep.failed_workers}")
    require_launched("cloud", launches, wrappers)
    hold_shapes("cloud", wrappers)
    return launches


def phase_quickstart(wrappers, log):
    """The quickstart twin on the card (8 workers, 4 rounds): valsort
    clean; the sort, partition and merge kernels launched and held."""
    from repro_torch.examples import quickstart

    zero_launches(wrappers)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        out = quickstart.main(["--device", DEVICE])
    secs = time.perf_counter() - t0
    launches = read_launches(wrappers)
    emit(phase="quickstart", records=out["records"], workers=out["workers"],
         rounds=out["rounds"], seconds=secs, valsort_ok=out["valsort_ok"],
         launches=launches)
    if not out["valsort_ok"]:
        raise AssertionError("quickstart: valsort failed")
    require_launched("quickstart", launches, ("bitonic_sort_blocks",
                                              "partition_offsets_blocks",
                                              "merge_sorted_pairs"))
    hold_shapes("quickstart", wrappers)
    return launches


def phase_groupby(wrappers, log):
    """The group-by example (a copy of the reference's: host numpy on a
    tiered store with injected S3 faults) at its defaults: its own
    validation passes, on the torch-only install; no kernel runs."""
    from repro_torch.examples import groupby_shuffle

    root = os.path.join(WORK_DIR, "store-groupby")
    shutil.rmtree(root, ignore_errors=True)
    zero_launches(wrappers)
    argv, sys.argv = sys.argv, ["groupby_shuffle", "--store", root]
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            groupby_shuffle.main()
    finally:
        sys.argv = argv
    secs = time.perf_counter() - t0
    launches = read_launches(wrappers)
    log.write(buf.getvalue())
    shutil.rmtree(root, ignore_errors=True)
    val = [ln for ln in buf.getvalue().splitlines()
           if ln.startswith("[validate]")]
    ok = bool(val) and all(f"{k}=True" in val[0] for k in
                           ("counts", "sums", "sorted", "routing"))
    emit(phase="groupby", seconds=secs, validation=val[0] if val else None,
         ok=ok, launches=launches)
    if not ok:
        raise AssertionError(f"groupby: validation failed: {val}")
    require_none_launched("groupby", launches)
    return launches


def require_none_launched(phase, launches):
    if any(launches.values()):
        raise AssertionError(f"{phase}: expected no kernel launch, got "
                             f"{launches}")


def phase_epoch_identity():
    """device_epoch_shuffle of IDENTITY_RECORDS ids over W workers on the
    card and on the CPU (plain versions): bit-identical permutations."""
    from repro_torch.data.pipeline import device_epoch_shuffle

    ids = np.arange(IDENTITY_RECORDS, dtype=np.uint32)
    perms, secs = {}, {}
    for device in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        perms[device] = device_epoch_shuffle(
            ids, EPOCHS[0], num_workers=NUM_WORKERS, device=device)
        secs[device] = time.perf_counter() - t0
    identical = bool(np.array_equal(perms[DEVICE], perms["cpu"]))
    emit(phase="epoch.identity", ids=IDENTITY_RECORDS, workers=NUM_WORKERS,
         epoch=EPOCHS[0], card_s=secs[DEVICE], cpu_s=secs["cpu"],
         identical=identical)
    if not identical:
        raise AssertionError("epoch.identity: card and CPU permutations "
                             "differ")


def phase_epoch_full(wrappers):
    """EPOCH_FULL_IDS sample ids shuffled on the card for two epochs:
    each a true permutation, the two different; one distributed sort a
    call (one sort, one worker split, log2(W) merge rounds)."""
    from repro_torch.data.pipeline import device_epoch_shuffle
    from repro_torch.kernels import u32

    n = EPOCH_FULL_IDS
    ids = u32.narrow(torch.arange(n, dtype=torch.int64, device=DEVICE))
    zero_launches(wrappers)
    perms, secs = {}, {}
    for epoch in EPOCHS:
        t0 = time.perf_counter()
        perms[epoch] = device_epoch_shuffle(ids, epoch,
                                            num_workers=NUM_WORKERS,
                                            device=DEVICE)
        secs[epoch] = time.perf_counter() - t0
    launches = read_launches(wrappers)
    first, second = (perms[e] for e in EPOCHS)
    permutation = bool(len(first) == n and np.array_equal(
        np.sort(first), np.arange(n, dtype=np.uint32)))
    differ = bool(not np.array_equal(first, second))
    rounds = NUM_WORKERS.bit_length() - 1
    expect = {"bitonic_sort_blocks": len(EPOCHS),
              "partition_offsets_blocks": len(EPOCHS),
              "merge_sorted_pairs": len(EPOCHS) * rounds,
              "merge_sorted_pairs_indexed": 0}
    emit(phase="epoch.full", ids=n, workers=NUM_WORKERS, epochs=list(EPOCHS),
         seconds={str(e): secs[e] for e in EPOCHS},
         samples_per_s={str(e): n / secs[e] for e in EPOCHS},
         permutation=permutation, epochs_differ=differ, launches=launches)
    if not (permutation and differ):
        raise AssertionError(f"epoch.full: permutation {permutation}, "
                             f"epochs differ {differ}")
    if launches != expect:
        raise AssertionError(f"epoch.full: launches {launches}, expected "
                             f"{expect}")
    hold_shapes("epoch", wrappers)
    return launches


@contextlib.contextmanager
def full_float32():
    """Float32 matmuls and convolutions in full precision (TF32 off), so
    the card's float32 results compare with the CPU's."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def phase_moe_identity(wrappers):
    """The MoE dispatch at qwen2-moe's expert widths in float32: the sort
    pipeline at ep_size 1 and 4 (the EP shards as a batch axis) on the
    card and on the CPU, and the onehot baseline on the card with room
    for every pair, all within MOE_TOL of the onehot result. No kernel
    runs: the dispatch sorts with torch.sort, as the reference with XLA's."""
    from repro_torch.core import moe_dispatch as md
    from repro_torch.models import layers
    from repro_torch.models.moe import expert_fn

    e, k, d = MOE_SHAPE["experts"], MOE_SHAPE["top_k"], MOE_SHAPE["d"]
    f, t = MOE_SHAPE["d_ff"], MOE_SHAPE["tokens"]
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.normal(size=(t, d)).astype(np.float32))
    logits = torch.from_numpy(rng.normal(size=(t, e)).astype(np.float32))
    gen = torch.Generator().manual_seed(SEED)
    experts = {"w_gate": layers.uniform_init((e, d, f), gen, d**-0.5),
               "w_up": layers.uniform_init((e, d, f), gen, d**-0.5),
               "w_down": layers.uniform_init((e, f, d), gen, f**-0.5)}
    cfg = md.MoeDispatchConfig(e, k, MOE_CAPACITY_FACTOR)
    zero_launches(wrappers)
    outs, ms = {}, {}
    with full_float32():
        for device in (DEVICE, "cpu"):
            dev = torch.device(device)
            xd = x.to(dev)
            prm = {n: w.to(dev) for n, w in experts.items()}
            w, ids = md.route_topk(logits.to(dev), k)
            if device == "cpu":
                # the dispatch compares only if nothing was dropped
                counts = torch.bincount(ids.reshape(-1), minlength=e)
                ecap = md._round_up(t * k / e * MOE_CAPACITY_FACTOR, 8)
                if int(counts.max()) > ecap:
                    raise AssertionError(f"moe.identity: an expert holds "
                                         f"{int(counts.max())} > {ecap} pairs")
            for ep in (1, 4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[(device, f"sort_ep{ep}")] = md.sort_dispatch(
                    xd, w, ids, prm, cfg=cfg, expert_fn=expert_fn,
                    ep_size=ep).cpu()
                ms[f"{device}.sort_ep{ep}"] = (time.perf_counter() - t0) * 1e3
            outs[(device, "ids")] = ids.cpu()
            if device == DEVICE:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[(device, "onehot")] = md.onehot_dispatch_combine(
                    xd, w, ids, num_experts=e, capacity=t * k,
                    expert_fn=lambda xin: expert_fn(prm, xin)).cpu()
                ms[f"{device}.onehot"] = (time.perf_counter() - t0) * 1e3
            del xd, prm, w, ids
            torch.cuda.empty_cache()
    launches = read_launches(wrappers)
    if not torch.equal(outs[(DEVICE, "ids")], outs[("cpu", "ids")]):
        raise AssertionError("moe.identity: card and CPU routed differently")
    want = outs[(DEVICE, "onehot")]
    errs = {f"{dev}.{name}": float((got - want).abs().max())
            for (dev, name), got in outs.items()
            if name.startswith("sort")}
    emit(phase="moe.identity", **MOE_SHAPE,
         capacity_factor=MOE_CAPACITY_FACTOR, tol=MOE_TOL,
         max_abs_diff_vs_onehot=errs, out_abs_max=float(want.abs().max()),
         ms=ms, launches=launches)
    if max(errs.values()) > MOE_TOL:
        raise AssertionError(f"moe.identity: {errs} exceed {MOE_TOL}")
    require_none_launched("moe", launches)
    return launches


def serve_config(**over):
    from repro_torch.configs import get

    return dataclasses.replace(get(SERVE_ARCH), **over)


def prompts(cfg, length, seed=SEED):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (SERVE_REQUESTS, length))


def phase_serve_identity(wrappers):
    """qwen2-moe-a2.7b at full width and SERVE_IDENTITY_LAYERS layers in
    float32 (TF32 off), the same weights on the card and the CPU: prefill
    logits within SERVE_TOL, and the same greedy tokens."""
    from repro_torch.models import api as mapi
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import ServeConfig, generate

    cfg = serve_config(n_layers=SERVE_IDENTITY_LAYERS, dtype="float32")
    model = mapi.build(cfg)
    tokens = prompts(cfg, SERVE_IDENTITY_PROMPT)
    zero_launches(wrappers)
    out = {}
    with full_float32():
        params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED))
        for device in (DEVICE, "cpu"):
            if device == "cpu":
                state = {n: p.cpu() for n, p in params.state_dict().items()}
                del params
                torch.cuda.empty_cache()
                params = Transformer(cfg, None)
                params.load_state_dict(state, strict=True, assign=True)
                del state
            batch = {"tokens": torch.from_numpy(tokens).to(device)}
            t0 = time.perf_counter()
            logits, _ = model.prefill(params, batch)
            gen, _ = generate(model, params, batch,
                              ServeConfig(max_new_tokens=SERVE_IDENTITY_NEW))
            out[device] = (logits.cpu(), gen.cpu(),
                           time.perf_counter() - t0)
        del params
    launches = read_launches(wrappers)
    err = float((out[DEVICE][0] - out["cpu"][0]).abs().max())
    same = bool(torch.equal(out[DEVICE][1], out["cpu"][1]))
    finite = bool(torch.isfinite(out[DEVICE][0]).all())
    emit(phase="serve.identity", arch=SERVE_ARCH, layers=cfg.n_layers,
         dtype=cfg.dtype, requests=SERVE_REQUESTS,
         prompt=SERVE_IDENTITY_PROMPT, new_tokens=SERVE_IDENTITY_NEW,
         prefill_logits_max_abs_diff=err, tol=SERVE_TOL,
         logits_abs_max=float(out["cpu"][0].abs().max()),
         tokens_identical=same, card_s=out[DEVICE][2], cpu_s=out["cpu"][2],
         launches=launches)
    if not finite or err > SERVE_TOL or not same:
        raise AssertionError(f"serve.identity: finite {finite}, prefill "
                             f"logits differ by {err} (tol {SERVE_TOL}), "
                             f"tokens identical {same}")
    require_none_launched("serve.identity", launches)


def phase_serve_full(wrappers):
    """qwen2-moe-a2.7b at full width and depth in bfloat16 on the card:
    the parameter count against the config's arithmetic, peak memory,
    prefill ms, decode ms a step and tokens/s of SERVE_REQUESTS greedy
    requests through serve/engine.generate."""
    from repro_torch.models import api as mapi
    from repro_torch.models import transformer
    from repro_torch.serve.engine import ServeConfig, generate

    cfg = serve_config()
    model = mapi.build(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches(wrappers)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    count = sum(p.numel() for p in params.parameters())
    want = transformer.expected_param_count(cfg)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    batch = {"tokens": torch.from_numpy(
        prompts(cfg, SERVE_FULL_PROMPT)).to(DEVICE)}
    logits, _ = model.prefill(params, batch)
    finite = bool(torch.isfinite(logits).all())
    del logits
    stats = {}
    gen, steps = generate(model, params, batch,
                          ServeConfig(max_new_tokens=SERVE_FULL_NEW),
                          stats=stats)
    gen = gen.cpu()
    peak = torch.cuda.max_memory_allocated()
    # one decode step again, traced: its device time by kernel against
    # its wall time (how much of a step the card is busy)
    logits, cache = model.prefill(params, batch,
                                  max_len=SERVE_FULL_PROMPT + 1)
    token = torch.argmax(logits[:, -1], dim=-1)[:, None]
    del logits

    def step():
        model.decode_step(params, cache, token, SERVE_FULL_PROMPT)

    split = device_split(step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    emit(phase="serve.split", step_ms=step_ms,
         device_busy_share=split["device_us"] / 1e3 / step_ms, **split,
         **host_split(step))
    del cache
    launches = read_launches(wrappers)
    wall = stats["prefill_s"] + sum(stats["decode_s"])
    in_range = bool(((gen >= 0) & (gen < cfg.padded_vocab)).all())
    emit(phase="serve.full", arch=SERVE_ARCH, layers=cfg.n_layers,
         dtype=cfg.dtype, requests=SERVE_REQUESTS, prompt=SERVE_FULL_PROMPT,
         new_tokens=steps, params=count, params_expected=want,
         param_bytes=param_bytes, max_memory_allocated=peak, init_s=init_s,
         prefill_ms=stats["prefill_s"] * 1e3,
         decode_ms_median=statistics.median(stats["decode_s"]) * 1e3,
         decode_ms_min=min(stats["decode_s"]) * 1e3,
         decode_ms_max=max(stats["decode_s"]) * 1e3,
         tokens_per_s=SERVE_REQUESTS * steps / wall,
         decode_tokens_per_s=SERVE_REQUESTS * steps / sum(stats["decode_s"]),
         prefill_logits_finite=finite, tokens_in_range=in_range,
         sample_tokens=gen[0, :8].tolist(), launches=launches)
    del params
    torch.cuda.empty_cache()
    if count != want:
        raise AssertionError(f"serve.full: {count} parameters, the config "
                             f"gives {want}")
    if peak <= param_bytes:
        raise AssertionError(f"serve.full: peak memory {peak} B below the "
                             f"parameters' {param_bytes} B")
    if not (finite and in_range and gen.shape == (SERVE_REQUESTS,
                                                  SERVE_FULL_NEW)):
        raise AssertionError(f"serve.full: finite {finite}, tokens in "
                             f"range {in_range}, shape {tuple(gen.shape)}")
    require_none_launched("serve.full", launches)
    return launches


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
    """The phases; verbose output of the example runs goes to `log`."""
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
         ptxas=ptxas_summary(_build.build_info.get("ptxas", {})))

    from repro_torch.kernels.bitonic_sort import bitonic_sort_blocks
    from repro_torch.kernels.kway_merge import merge_sorted_pairs_indexed
    from repro_torch.kernels.merge_sorted import merge_sorted_pairs
    from repro_torch.kernels.range_partition import partition_offsets_blocks

    wrappers = {"bitonic_sort_blocks": bitonic_sort_blocks,
                "partition_offsets_blocks": partition_offsets_blocks,
                "merge_sorted_pairs": merge_sorted_pairs,
                "merge_sorted_pairs_indexed": merge_sorted_pairs_indexed}
    full = full_plan()

    # ---- 3. kernels against their plain versions ----
    rows = phase_kernels(full)

    # ---- 4. identity: card vs CPU at 2^20 records, both reduce merges ----
    small = small_plan(full)
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
    from repro_torch.kernels import kway_merge

    kway_merge.merge_fragments_device.windows = 0
    kway_merge.merge_fragments_device.records = 0
    zero_launches(wrappers)
    out = run_example(
        ["--records", str(records), "--waves", str(WAVES), "--no-faults",
         "--device", DEVICE, "--store", store], full, log)
    launches = read_launches(wrappers)
    windows = kway_merge.merge_fragments_device.windows
    window_records = kway_merge.merge_fragments_device.records
    shutil.rmtree(store, ignore_errors=True)
    emit(phase="full", **{k: v for k, v in out.items() if k != "store"},
         launches=launches, device_merged_windows=windows,
         window_mean_records=window_records / max(windows, 1), device=name)
    if not out["valsort_ok"]:
        raise AssertionError("full run: valsort failed")
    require_launched("full run", launches, wrappers)
    if launches["merge_sorted_pairs_indexed"] != windows:
        raise AssertionError(
            f"full run: {launches['merge_sorted_pairs_indexed']} indexed "
            f"merge launches for {windows} windows of >= 2 fragments")
    hold_shapes("full", wrappers)
    phase_window_split(full, window_records / windows)
    by_phase = {"full": launches}

    # ---- 6. the payload modes ----
    phase_payload_identity()
    by_phase["payload"] = phase_payload_full(wrappers, log)

    # ---- 7.-9. the fleets: processes, the skew pass, functions ----
    by_phase["fleet"] = phase_fleet(full, wrappers)
    by_phase["recursive"] = phase_recursive(full, wrappers)
    by_phase["cloud"] = phase_cloud(full, wrappers)

    # ---- 10.-12. the other users of the shuffle ----
    by_phase["quickstart"] = phase_quickstart(wrappers, log)
    by_phase["groupby"] = phase_groupby(wrappers, log)
    phase_epoch_identity()
    by_phase["epoch"] = phase_epoch_full(wrappers)
    by_phase["moe"] = phase_moe_identity(wrappers)

    # ---- 13. serving qwen2-moe-a2.7b ----
    phase_serve_identity(wrappers)
    by_phase["serve"] = phase_serve_full(wrappers)

    # ---- 14. the kernels line, then the ok line ----
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["launches_by_phase"] = {p: c[row["name"]]
                                    for p, c in by_phase.items()}
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
