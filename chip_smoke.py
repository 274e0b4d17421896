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
     through merge_fragments_device (host µs);
  4. runs the port's out-of-core CloudSort at 2^20 records on the card and
     on the CPU, with both reduce merges: the output etags must agree;
  5. runs the full sort — 100-byte records, 4 waves of 2^24 records
     (W = 8, 2 rounds, R1 = 4, reduce_merge_impl="device") through
     repro_torch.examples.cloudsort_oocore.main — with valsort, counting
     every kernel's launches on that run alone and the reduce windows
     merged on the card (one indexed-merge launch each); then splits one
     window of the run's mean size into its host steps;
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
L2_BYTES = 50 << 20  # H100 L2
TIMED_CALLS = 20  # back-to-back calls between one pair of events
SLEEP_CYCLES_PER_S = 2e9  # torch.cuda._sleep cycles a second (~the SM clock)
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
    from repro_torch.kernels import kway_merge

    for fn in wrappers.values():
        fn.launches = 0
    kway_merge.merge_fragments_device.windows = 0
    kway_merge.merge_fragments_device.records = 0
    torch.cuda.synchronize()
    out = run_example(
        ["--records", str(records), "--waves", str(WAVES), "--no-faults",
         "--device", DEVICE, "--store", store], full, log)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in wrappers.items()}
    windows = kway_merge.merge_fragments_device.windows
    window_records = kway_merge.merge_fragments_device.records
    shutil.rmtree(store, ignore_errors=True)
    emit(phase="full", **{k: v for k, v in out.items() if k != "store"},
         launches=launches, device_merged_windows=windows,
         window_mean_records=window_records / max(windows, 1), device=name)
    if not out["valsort_ok"]:
        raise AssertionError("full run: valsort failed")
    for n, c in launches.items():
        if c <= 0:
            raise AssertionError(f"full run: kernel {n} was never launched")
    if launches["merge_sorted_pairs_indexed"] != windows:
        raise AssertionError(
            f"full run: {launches['merge_sorted_pairs_indexed']} indexed "
            f"merge launches for {windows} windows of >= 2 fragments")
    phase_window_split(full, window_records / windows)

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
