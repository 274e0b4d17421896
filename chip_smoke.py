#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one Hopper card.

    python3 chip_smoke.py [--log-dir DIR]

Run from the repo root on a machine with one H100. It

  1. prints the environment (torch, CUDA, the card's name and power
     limit from nvidia-smi) and a probe of which torch dtype round-trips
     uint32 bits on the card;
  2. builds the CUDA kernels from src/repro_torch/kernels/csrc/ (the
     four sort kernels and the through mode's slot gather);
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
     the payload path's (8, 2^21); the slot gather
     (kernels/slot_gather.py) is held at SLOT_GATHER_HOLDS and timed at
     the resident cells' shape, with its plain version (the aten
     composition it replaced) as the yardstick;
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
     2^20 records, and `payload.key10.identity` the whole 10-byte key
     (key_bytes=10) the same way (each requires the slot gather to
     have launched), with its kernels held and the
     key-tail stage run alone under the sync debug mode
     (`payload.key10.nosync`); `payload.split` splits one call of each
     mode at 2^24 records by kernel (torch.profiler), beside the map
     sort's device ms on the phase's own rows; `payload.full` runs 5
     calls of each at 2^24 records (1.68 GB, one round, blocks of
     2^19): the median and
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
 10. the rank mesh (launch/mesh.py): `mesh.nccl1`, the out-of-core sort
     on a RankMesh of one NCCL rank (W = 8, R1 = 4, device merge, 2^24
     records in 4 waves), and `mesh.gloo`, 4 gloo rank processes on the
     one card (the same plan at 2^22 records), each output
     etag-identical to the mesh=None run and valsort clean; with
     `mesh.gloo.payload`, distributed_sort_payload over the 4 ranks in
     both modes at 2^20 records, bit-identical to one process. Each
     prints its ranks, backend, map and reduce seconds and (`.exchange`)
     each rank's all_to_all bytes and ms per round (gloo's go through
     host memory and are labelled so); `mesh.hold` holds every kernel at
     every shape a rank launched;
 11. `quickstart`: the quickstart twin on the card (32k records, 8
     workers, 4 rounds), valsort clean; `groupby`: the group-by example
     (host numpy on a faulty tiered store), its validation clean;
 12. `epoch.identity`: device_epoch_shuffle of 2^20 ids over 8 workers on
     the card and the CPU, bit-identical; `epoch.full`: 2^24 ids, epochs
     3 and 4 on the card, true permutations that differ;
 13. `moe.identity`: the MoE sort dispatch at qwen2-moe-a2.7b's expert
     widths (E = 64, K = 4, d = 2048, d_ff = 1408, T = 512) in float32
     with TF32 off, at ep_size 1 and 4 on the card and the CPU, against
     the onehot baseline on the card;
 14. `serve.identity`: qwen2-moe-a2.7b at full width, 2 layers, float32,
     card against CPU (prefill logits, greedy tokens); `serve.full`: the
     same model at full width and depth in bfloat16 on the card, 4
     requests of 128-token prompts, 32 greedy tokens each, through
     repro_torch.serve.engine.generate: parameter count, peak memory,
     prefill ms, decode ms a step, tokens/s;
 15. training: `train.identity`, one step of qwen2-moe-a2.7b at full
     width, 1 layer, float32, card against CPU (loss, parameters after
     the step, no pad expert routed); `train.full`, the same model 4
     layers deep in bfloat16 over float32 masters with remat and 4
     microbatches, 8 AdamW steps on one batch (losses, step ms, tokens/s,
     peak memory, a profiler split of one step); `train.launch`, the
     training driver for tinyllama-1.1b at full width and depth, straight
     and restarted from a checkpoint (the losses agree); the MoE training
     example (`train.moe_example`) and the serving driver
     (`serve.launch`);
 16. expert parallelism over gloo rank processes on the one card
     (launch/mesh.RankMesh with axes data x model, every rank on cuda:0):
     `moe.ranks.identity`, the sort dispatch at moe.identity's widths
     over 4 ranks as data 1 x model 4 and data 2 x model 2, each rank
     holding E/ep experts, routing bit-identical to the batch-axis form
     on the card and outputs and input gradients within MOE_TOL;
     `serve.ranks.identity`, qwen2-moe-a2.7b at full width, 2 layers,
     float32, over 4 ranks against the one-process batch-axis form
     (prefill logits, 8 greedy tokens); `serve.ranks`, the same model at
     full width and depth in bfloat16 over 4 ranks (the prefill's sort
     dispatch over the ranks, each decode step's dispatch summed over
     them): tokens identical on every rank, per-rank peak memory,
     prefill and decode ms, the all_to_all, all_gather and psum ms a
     layer, and how many tokens equal serve.full's; `train.ranks`, one
     layer at full width in float32 over 4 ranks (2 if the dry run's
     summed rank peaks exceed TRAIN_RANKS_BUDGET), one step at a peak
     learning rate of 1e-4 (no warmup) held against the one-process step (loss,
     global gradient norm, parameters), replicated parameters
     bit-identical on every rank, then 4 timed steps; `train.moe_example.ranks`, the MoE
     training example over the reference's data 2 x model 4 mesh (8
     ranks), 6 steps, losses against the one-process example's;
 17. tensor parallelism over gloo rank processes on the one card
     (Megatron's: a rank holds 1/tp of every projection, FFN and the
     tied vocabulary; launch/sharding.split_dims), mistral-nemo-12b at
     its published widths: `tp.identity`, 2 layers in float32 over
     data 1 x model 4 and data 2 x model 2 against one process on the
     card (prefill logits within 1e-5, 8 greedy tokens, one train step:
     loss, each rank's gradient norm, parameters, replicas identical);
     `serve.tp`, all 40 layers in bfloat16 over data 1 x model 4, 4
     requests of 128-token prompts, 32 greedy tokens: tokens identical
     on every rank, parameter bytes a rank against one bfloat16
     process's, prefill and decode ms, tokens/s, peaks, each
     collective's calls, bytes and ms; `train.tp`, 1 layer of float32
     masters over data 2 x model 2 with sequence parallelism, batch 4 x
     128, one step held as tp.identity's and 4 timed, its peak against
     the dry run's. serve.ranks and train.ranks (qwen2-moe-a2.7b) run
     tensor-parallel attention, shared experts and vocabulary beside
     their expert parallelism;
 18. the other five families, each at its published widths:
     `<family>.identity` (card against CPU in float32 from the same
     weights, cut in depth: prefill logits, 8 greedy tokens, one train
     step) and `<family>.serve` (full depth in bfloat16, 4 requests of
     128-token prompts, 32 greedy tokens, through serve.engine.generate)
     for vlm (llava-next-34b, behind 576 patch embeddings), mla
     (minicpm3-4b), ssm (xlstm-125m), hybrid (hymba-1.5b, 1,100-token
     prompts that wrap its 1,024-position ring) and encdec (whisper-base,
     with frames), each with `<family>.split`, a profiler split of one
     decode step; then `hybrid.train`, hymba-1.5b at its published
     widths, 8 of 32 layers deep, 4 AdamW steps of bfloat16 over
     float32 masters with remat, and
     `hybrid.train.split`, one more step traced;
 19. the dry run against the card: after each phase that reads
     `max_memory_allocated` (serve.full, train.full, each
     `<family>.serve`, hybrid.train), `dryrun.hold` runs the same window
     (`serve_window`, `train_window`) again on "meta" tensors through
     launch/dryrun.peak_bytes and holds the predicted peak, plus the
     bytes already live at the phase's reset, within DRYRUN_TOL of the
     measured one; `cost.flops`, the FLOPs of one train.full step, one
     hybrid.train step and the serve.full prefill counted on meta by
     launch/op_cost over their measured times (TFLOP/s and the share of
     the dense bf16 peak); `cost.tco`, core/cost_model.gpu_cloudsort_tco
     at the full run's map and reduce rates; `phase.seconds`, each
     phase's wall seconds. None of this launches a kernel;
 20. prints nvidia-smi's own name/power-limit line, the `kernels` JSON
     line (each kernel's launches on the full run, and per phase) and,
     last, the `ok` line.

Each of the phases 5-18 zeroes every kernel's launch count just before
its runs and reads it just after (a process fleet's children and the
rank processes report theirs), and fails if a kernel of its path never
launched, or, where the path runs none of the four kernels (the
group-by, the MoE dispatch, serving and training in one process or over
ranks, the families), if one did. Then (`<phase>.hold`) it holds each
kernel bit-identical to its plain version on the card at every shape
the phase launched it at (the wrappers record their launch shapes;
children report theirs too), on fresh random inputs.

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
MESH_NCCL_RECORDS = 1 << 24  # mesh.nccl1: 4 waves of 2^22 records
MESH_GLOO_RANKS = 4
MESH_GLOO_RECORDS = 1 << 22  # mesh.gloo: 4 waves of 2^20 records
MESH_WAVES = 4  # the example asserts >= 4x out of core
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
TRAIN_ARCH = "qwen2-moe-a2.7b"
TRAIN_IDENTITY_LAYERS = 1  # the CPU side's 14.7 GB of state fits the host
TRAIN_IDENTITY_BATCH = (2, 64)  # sequences x tokens
TRAIN_FULL_LAYERS = 4  # 43.7 GB of float32 state; all 24 would take 237 GB
TRAIN_FULL_BATCH = (8, 256)
TRAIN_FULL_STEPS = 8  # one batch repeated
TRAIN_LOSS_TOL = 1e-4  # |loss| card vs CPU (tests/test_models.py's bound)
TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL = 2e-4, 2e-5  # parameters after a step
LAUNCH_ARCH = "tinyllama-1.1b"  # launch/train.py's own example arch
LAUNCH_ARGS = ["--batch", "8", "--seq", "128"]  # launch/train.py defaults
LAUNCH_STEPS, LAUNCH_CKPT_STEP = 4, 2
LAUNCH_RESTART_RTOL = 1e-5  # restarted run's step losses vs the straight run
LAUNCH_EXTRA = []  # more driver flags (a CPU rehearsal passes --reduced)
MOE_EXAMPLE_ARGS = ["--steps", "100"]  # the example's batch 16 x seq 128
SERVE_LAUNCH = dict(arch="tinyllama-1.1b", batch=4, prompt_len=32, max_new=16)
# slice 7's families: the arch of each, and its identity phase (float32,
# card against CPU): depth (None: the config's), requests x prompt
# tokens to serve, train batch (sequences x text tokens)
FAMILY_ARCHS = {"vlm": "llava-next-34b", "mla": "minicpm3-4b",
                "ssm": "xlstm-125m", "hybrid": "hymba-1.5b",
                "encdec": "whisper-base"}
FAMILY_IDENTITY = {
    # 1 layer with the full 576-patch prefix: 1.02 B parameters, 16.3 GB
    # of train state on each side
    "vlm": dict(layers=1, requests=2, prompt=16, train=(1, 32)),
    "mla": dict(layers=2, requests=4, prompt=32, train=(2, 64)),
    "ssm": dict(layers=None, requests=4, prompt=32, train=(2, 64)),
    # layer 0 global, layer 1 SWA; 1,100 text tokens wrap the 1,024 ring
    "hybrid": dict(layers=2, requests=2, prompt=1100, train=(1, 1100)),
    "encdec": dict(layers=None, requests=4, prompt=32, train=(2, 64)),
}
FAMILY_SERVE_PROMPT = {"hybrid": 1100}  # else SERVE_FULL_PROMPT
HYBRID_TRAIN_BATCH = (4, 1280)
# 8 of 32 layers (layer 0 global, 1-7 windowed) and 4 steps: the step and
# its meta dry run are host-bound, and all 32 layers took 180 s of a
# run whose limit the tensor-parallel phases left no room for
HYBRID_TRAIN_LAYERS = 8
HYBRID_TRAIN_STEPS = 4  # one batch repeated
DRYRUN_TOL = 0.10  # |predicted / measured - 1| of a phase's peak memory
# expert parallelism over gloo ranks on the one card (slice 10)
EP_RANKS = 4  # rank processes of the 4-rank phases
MOE_RANK_LAYOUTS = ({"data": 1, "model": 4}, {"data": 2, "model": 2})
TRAIN_RANKS_BUDGET = 70e9  # the dry run's summed rank peaks must fit it
TRAIN_RANKS_MORE_STEPS = 4  # timed steps after the held one
TRAIN_GRAD_NORM_RTOL = 1e-5  # a rank's global gradient norm vs one process
MOE_EXAMPLE_RANKS_STEPS = 6
# tensor parallelism over gloo ranks on the one card
TP_ARCH = "mistral-nemo-12b"
TP_IDENTITY_LAYERS = 2
TP_LAYOUTS = ({"data": 1, "model": 4}, {"data": 2, "model": 2})
TP_TOL = 1e-5  # max |diff| of float32 prefill logits and loss, TP vs one
TP_SERVE_MESH = {"data": 1, "model": 4}
TP_TRAIN_LAYERS = 1
TP_TRAIN_MESH = {"data": 2, "model": 2}
TP_TRAIN_BATCH = (4, 128)
BF16_DENSE_PEAK = 989e12  # H100 SXM data sheet: dense bf16 tensor FLOP/s
DEVICE = "cuda"
BUCKET = "cloudsort"
SMI = ""  # nvidia-smi's name and power limit, set by run()


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
               "merge_tiles", "kway_rank_scatter", "gather_slot_rows")


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


def emit_split(phase, fn, **extra):
    """One fn() call's wall ms, its device µs by kernel and the card's
    busy share of the wall time (device_split), and its host side
    (host_split), as the `phase` line."""
    split = device_split(fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    emit(phase=phase, step_ms=ms, device_busy_share=split["device_us"] / 1e3
         / ms, **split, **host_split(fn), **extra)


def generator(device):
    """The phases' seeded generator on `device`; on "meta" none (the
    weights are drawn as shapes only)."""
    if device == "meta":
        return None
    return torch.Generator(device=device).manual_seed(SEED)


def serve_window(model, batch, device, stats=None):
    """What a serve phase runs between resetting and reading the card's
    peak memory: the weights drawn on `device`, the prompts moved there,
    one prefill (the finiteness of its logits; None on "meta"), then
    SERVE_FULL_NEW greedy tokens through serve/engine.generate. With
    `stats`, the init's seconds and generate's. Returns (params, batch,
    finite, tokens, steps)."""
    from repro_torch.serve.engine import ServeConfig, generate

    t0 = time.perf_counter()
    params = model.init(generator(device))
    if stats is not None:
        torch.cuda.synchronize()
        stats["init_s"] = time.perf_counter() - t0
    batch = {k: v.to(device) for k, v in batch.items()}
    logits, _ = model.prefill(params, batch)
    finite = None if device == "meta" else bool(torch.isfinite(logits).all())
    del logits
    gen, steps = generate(model, params, batch,
                          ServeConfig(max_new_tokens=SERVE_FULL_NEW),
                          stats=stats)
    return params, batch, finite, gen, steps


def train_window(model, tcfg, batch, device, steps, step_s=None,
                 losses=None):
    """What a training phase runs between resetting and reading the
    card's peak memory: the training state drawn on `device` (float32
    masters, zero moments), then `steps` AdamW steps on `batch`, each
    step's seconds and loss appended to `step_s` and `losses` on a card.
    Returns (state, step)."""
    from repro_torch.train.train_step import init_train_state, make_train_step

    state = init_train_state(model, generator(device), tcfg)
    step = make_train_step(model, tcfg)
    for _ in range(steps):
        if device == "meta":
            state, _ = step(state, batch)
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    return state, step


def to_meta(batch):
    return {k: torch.empty_like(v, device="meta") for k, v in batch.items()}


def dryrun_hold(phase, measured, baseline, window):
    """`dryrun.hold`: the dry run's peak of `window()`, the phase's
    measured window run on "meta" (launch/dryrun.peak_bytes), plus
    `baseline`, the bytes live on the card that the window does not
    create, against the measured max_memory_allocated. Fails if they
    differ by more than DRYRUN_TOL."""
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    window_bytes = dryrun.peak_bytes(window)
    predicted = baseline + window_bytes
    ratio = predicted / measured
    emit(phase="dryrun.hold", of=phase, predicted_bytes=predicted,
         measured_bytes=measured, ratio=ratio, baseline_bytes=baseline,
         window_predicted_bytes=window_bytes,
         window_measured_bytes=measured - baseline,
         window_ratio=window_bytes / max(measured - baseline, 1),
         tol=DRYRUN_TOL, meta_seconds=time.perf_counter() - t0, card=SMI)
    if not abs(ratio - 1) <= DRYRUN_TOL:
        raise AssertionError(f"dryrun.hold {phase}: predicted {predicted} "
                             f"B, measured {measured} B (ratio {ratio})")


def meta_flops(fn, *args):
    """launch/op_cost's FLOPs of fn(*args) on "meta" tensors."""
    from repro_torch.launch import op_cost

    return op_cost.analyze(fn, *args)["flops"]


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
        if g.device == w.device and g.shape == w.shape and torch.equal(g, w):
            continue  # equal where they lie: no copy to the host
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


#: (Wl, W_src, C, n, pw, fill, from_input) of the slot gather's holds in
#: phase_kernels: m = W_src * C not a multiple of 32, every slot a pad, no
#: pad, pw 1 and 8, the received rows of a mesh, and leading blocks full
#: (the first pad of arrival order past block 0) with both row maps.
SLOT_GATHER_HOLDS = ((3, 5, 37, 50, 23, "half", True),
                     (2, 4, 16, 16, 23, "pads", True),
                     (2, 4, 16, 16, 23, "full", True),
                     (4, 8, 100, 90, 1, "half", True),
                     (4, 8, 100, 90, 8, "half", True),
                     (8, 8, 3001, 2048, 23, "half", True),
                     (3, 5, 37, 0, 23, "half", False),
                     (4, 8, 100, 0, 8, "full", False),
                     (2, 4, 16, 0, 23, "pads", False),
                     (4, 8, 100, 90, 23, "first_full", True),
                     (3, 5, 37, 0, 23, "first_full", False))


def slot_gather_case(wl, w_src, cap, n, pw, fill, from_input, gen):
    """Inputs of kernels/slot_gather.gather_slot_rows on the card:
    (recv_ids, rows, merged_slots, rcounts). Block p of each worker holds
    rcounts[d, p] records (fill "half": a quarter to three quarters of C,
    "pads": none, "full": C, "first_full": blocks 0 .. k_d - 1 full, k_d
    from 1 to W_src - 1 and worker 0's W_src - 1, the rest as "half", so
    that the first pad of arrival order lies in block k_d); their ids are producer p's rows (p*n + j),
    but one in ten is drawn from the whole u32 range (ids outside the
    layout) and each block's last real id is the pad id's value; the
    merged slots are the real slots in a random order, then the pads.
    Rows are the producers' input (w_src, n, pw) where from_input, else
    one received row a slot."""
    from repro_torch.kernels import u32

    dev = torch.device(DEVICE)
    m = w_src * cap
    if fill in ("half", "first_full"):
        rc = torch.randint(cap // 4, 3 * cap // 4 + 1, (wl, w_src),
                           generator=gen, device=dev)
        if fill == "first_full":
            k = torch.randint(1, w_src, (wl, 1), generator=gen, device=dev)
            k[0] = w_src - 1
            rc = torch.where(torch.arange(w_src, device=dev) < k, cap, rc)
    else:
        rc = torch.full((wl, w_src), cap if fill == "full" else 0,
                        device=dev)
    shape = (wl, w_src, cap)
    j = torch.arange(cap, device=dev)
    p = torch.arange(w_src, device=dev)[:, None]
    ids = p * max(n, 1) + torch.randint(0, max(n, 1), shape, generator=gen,
                                        device=dev)
    ids = torch.where(torch.rand(shape, generator=gen, device=dev) < 0.1,
                      torch.randint(0, 1 << 32, shape, generator=gen,
                                    device=dev), ids)
    ids = torch.where(j == rc[..., None] - 1, 0xFFFFFFFF, ids)
    valid = (j < rc[..., None]).reshape(wl, m)
    recv = u32.narrow(torch.where(valid, ids.reshape(wl, m), 0xFFFFFFFF))
    order = torch.where(valid, torch.rand((wl, m), generator=gen,
                                          device=dev), 2.0).argsort(-1)
    slots = torch.where(valid.gather(-1, order), order, 0xFFFFFFFF)
    rows = torch.randint(-(1 << 31), 1 << 31,
                         (w_src, n, pw) if from_input else (wl * m, pw),
                         generator=gen, dtype=torch.int32, device=dev)
    return recv, rows, u32.narrow(slots), rc.to(torch.int32)


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
    # the slot gather: held at SLOT_GATHER_HOLDS, then timed at the
    # resident cells' shape (8 workers of 2^24 slots, half of them pads,
    # from 2^26 input rows of 23 words) beside the plain version, which is
    # the aten composition the kernel replaced (the library column too)
    from repro_torch.kernels.slot_gather import (gather_slot_rows,
                                                 gather_slot_rows_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for case in SLOT_GATHER_HOLDS:
        args, fi = slot_gather_case(*case, gen), case[-1]
        check_equal(f"slot_gather {case}",
                    gather_slot_rows(*args, from_input=fi),
                    gather_slot_rows_plain(*args, from_input=fi))
    emit(phase="kernels.slot_gather", checks=len(SLOT_GATHER_HOLDS),
         cases=SLOT_GATHER_HOLDS, ok=True)
    wl = w_src = w
    cap, n_rows, pw = 1 << 21, 1 << 23, PAYLOAD_WORDS
    args = slot_gather_case(wl, w_src, cap, n_rows, pw, "half", True, gen)
    s_slots, r_rows = wl * w_src * cap, w_src * n_rows
    record("gather_slot_rows", csrc + "slot_gather.cu",
           "none (the reference joins the payload in XLA)",
           [s_slots, r_rows, pw], args,
           lambda *a: gather_slot_rows(*a, from_input=True),
           lambda *a: gather_slot_rows_plain(*a, from_input=True),
           lambda *a: gather_slot_rows_plain(*a, from_input=True), args,
           s_slots * (4 * pw + 8) + r_rows * 4 * pw, s_slots,
           pad_slots=int((args[2] == -1).sum()))
    del args
    torch.cuda.empty_cache()
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


def hold_shapes(phase, wrappers, extra=(), mesh_workers=NUM_WORKERS):
    """Each kernel bit-identical to its plain version on the card at every
    shape the phase launched it at: the wrappers' `shapes`, and those in
    `extra` (dicts of shapes reported by other processes), on fresh
    random inputs, rows sorted where the kernel takes sorted rows. Run
    after the phase's launches are read: these launches are not counted.
    mesh_workers: the workers a rank holds where the slot gather ran on a
    mesh (its logged R is 0).
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
    if "gather_slot_rows" in wrappers:
        from repro_torch.kernels.slot_gather import gather_slot_rows_plain

        # W = NUM_WORKERS producers; S = Wl * W * C slots from R = W * n
        # input rows, Wl = W without a mesh, on a mesh R = 0 and Wl =
        # mesh_workers
        w = NUM_WORKERS
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for s_slots, r_rows, pw in sorted(shapes["gather_slot_rows"]):
            fi = r_rows > 0
            wl = w if fi else mesh_workers
            args = slot_gather_case(wl, w, s_slots // (wl * w), r_rows // w,
                                    pw, "half", fi, gen)
            check_equal(label("slot gather", (s_slots, r_rows, pw)),
                        wrappers["gather_slot_rows"](*args, from_input=fi),
                        gather_slot_rows_plain(*args, from_input=fi))
            del args
    torch.cuda.empty_cache()
    held = {n: [list(sh) for sh in sorted(s)] for n, s in shapes.items()}
    emit(phase=f"{phase}.hold", shapes=held,
         checks=sum(len(s) for s in held.values()), identical=True)


def phase_payload_identity(wrappers):
    """Both payload modes at IDENTITY_RECORDS on the card and on
    the CPU (plain versions): keys, ids, valid counts and the overflow
    flag bit-identical; payload rows whole in the through mode, each
    worker's valid prefix in the late mode (the reference leaves pad
    rows unspecified there; whether they agree too is reported). The
    through mode's slot gather must have launched; every kernel is held
    at the shapes it launched at. Returns the launches."""
    from repro_torch.core.exoshuffle import (ShuffleConfig,
                                             distributed_sort_payload)
    from repro_torch.data import gensort
    from repro_torch.kernels import u32

    n, w = IDENTITY_RECORDS, NUM_WORKERS
    keys, ids = gensort.gen_keys(0, n, "cpu")
    payload = gensort.gen_payload(ids, PAYLOAD_WORDS)
    keys, ids, payload = (u32.to_numpy(t) for t in (keys, ids, payload))
    cfg = ShuffleConfig(num_workers=w, reducers_per_worker=4)
    zero_launches(wrappers)
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
    launches = read_launches(wrappers)
    emit(phase="payload.identity.kernels", launches=launches)
    require_launched("payload.identity", launches, ("gather_slot_rows",))
    hold_shapes("payload.identity", wrappers)
    return launches


def phase_payload_key10_identity(wrappers):
    """`payload.key10.identity`: the whole 10-byte key
    (distributed_sort_payload(..., key_bytes=10), core/keytail.py) on the
    card against the CPU's plain path at IDENTITY_RECORDS, both payload
    modes: keys, ids, valid counts and the overflow flag bit-identical,
    payload rows whole in the through mode (pad rows included), each
    valid prefix in the late mode. One record in 1,024 repeats its
    neighbour's key word and one in 2,048 its whole 10-byte key, so
    about 2,300 records lie in runs of equal key words (about 1,150
    pairs; the stage holds 4,096 at this size) and the id breaks some
    ties.
    The phase names the kernels the wide path launches and holds each
    bit-identical to its plain version at every shape it launched at;
    the key-tail stage launches none of its own. Then the stage alone on
    the card under torch.cuda.set_sync_debug_mode("error"): it makes the
    host wait for nothing (`payload.key10.nosync`)."""
    from repro_torch.core import keytail
    from repro_torch.core.exoshuffle import distributed_sort_payload
    from repro_torch.data import gensort
    from repro_torch.kernels import u32

    n, w = IDENTITY_RECORDS, NUM_WORKERS
    keys, ids = gensort.gen_keys(0, n, "cpu")
    payload = gensort.gen_payload(ids, PAYLOAD_WORDS)
    keys, ids, payload = (u32.to_numpy(t) for t in (keys, ids, payload))
    keys[1::1024] = keys[0::1024]
    payload[1::2048, :keytail.TAIL_WORDS] = \
        payload[0::2048, :keytail.TAIL_WORDS]
    zero_launches(wrappers)
    for mode in ("through", "late"):
        outs = {}
        for device in (DEVICE, "cpu"):
            sk, si, sp, vc, ovf = distributed_sort_payload(
                keys, ids, payload, num_workers=w, mode=mode,
                device=device, key_bytes=10)
            outs[device] = (u32.to_numpy(sk), u32.to_numpy(si),
                            u32.to_numpy(sp), vc.cpu().numpy(), ovf)
        card, cpu = outs[DEVICE], outs["cpu"]
        for i, what in enumerate(("keys", "ids")):
            if not np.array_equal(card[i], cpu[i]):
                raise AssertionError(f"payload.key10.identity {mode}: {what} "
                                     "differ between card and CPU")
        if not np.array_equal(card[3], cpu[3]) or card[4] != cpu[4]:
            raise AssertionError(f"payload.key10.identity {mode}: valid "
                                 "counts or overflow differ")
        if card[4] or int(card[3].sum()) != n:
            raise AssertionError(f"payload.key10.identity {mode}: overflow")
        seg = card[2].shape[0] // w
        for d in range(w):
            lo, hi = d * seg, d * seg + int(card[3][d])
            if not np.array_equal(card[2][lo:hi], cpu[2][lo:hi]):
                raise AssertionError(f"payload.key10.identity {mode}: worker "
                                     f"{d}'s payload rows differ")
        whole = bool(np.array_equal(card[2], cpu[2]))
        if mode == "through" and not whole:
            raise AssertionError("payload.key10.identity through: pad rows "
                                 "differ")
        tied = 0
        for d in range(w):
            seg_keys = card[0][d * seg:d * seg + int(card[3][d])]
            _, counts = np.unique(seg_keys, return_counts=True)
            tied += int(counts[counts > 1].sum())
        emit(phase="payload.key10.identity", mode=mode, records=n, workers=w,
             key_bytes=10, tied_records=tied, rows=int(card[2].shape[0]),
             overflow=bool(card[4]), identical=True,
             pad_rows_identical=whole)
    launches = read_launches(wrappers)
    emit(phase="payload.key10.kernels", launches=launches,
         launched=sorted(k for k, c in launches.items() if c),
         new_kernels=[])
    require_launched("payload.key10.identity", launches,
                     ("bitonic_sort_blocks", "partition_offsets_blocks",
                      "merge_sorted_pairs", "gather_slot_rows"))
    hold_shapes("payload.key10", wrappers)
    # the stage alone: no host wait inside it
    dev = torch.device(DEVICE)
    sk, si, sp, vc, _ = distributed_sort_payload(
        keys, ids, payload, num_workers=w, device=DEVICE)
    mk, mv = sk.reshape(w, -1), si.reshape(w, -1).clone()
    rows = sp.reshape(w, mk.shape[-1], -1).clone()
    cap = keytail.pair_capacity(n // w, w, w, mk.shape[-1], 1.5)
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        tied, over = keytail.order_key_tails(mk, mv, rows, vc, cap)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    emit(phase="payload.key10.nosync", capacity=cap, tied=int(tied),
         overflow=bool(over), synchronised=False)
    return launches


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
        expect["gather_slot_rows"] += calls * (mode == "through")
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
    expect["gather_slot_rows"] += 1
    launches = read_launches(wrappers)
    if launches != expect:
        raise AssertionError(f"payload: launches {launches}, expected "
                             f"{expect} (one sort and one worker split a "
                             "call, one producer split a late fetch, "
                             f"{rounds} merge rounds, the example's "
                             "reducer splits, one slot gather a through "
                             "call)")
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


def mesh_plan(full, records):
    """The full plan (W = 8, R1 = 4, device merge) at `records` in
    MESH_WAVES waves, input objects of half a wave: at G = 4 each object
    straddles two ranks, so the ranks read them by ranged GETs."""
    wave = records // MESH_WAVES
    return dataclasses.replace(full, records_per_wave=wave,
                               input_records_per_partition=wave // 2)


def emit_exchanges(phase, ranks, backend, per_rank, plan):
    """Each rank's all_to_all log, per round of the map (keys, vals and
    counts) and per wave (the payload fetch's requests and rows): bytes
    handed to all_to_all_single by the rank (its own share included) and
    ms between CUDA events on the rank's stream around the collective,
    each round's (the first round's includes NCCL's setup of the
    exchange) and their median."""
    rounds = MESH_WAVES * plan.num_rounds
    rows = []
    for log in per_rank:
        shuffle = [x for x in log if x["what"] in ("keys", "vals", "counts")]
        fetch = [x for x in log if x["what"] in ("requests", "rows")]
        round_ms = [sum(x["ms"] for x in shuffle[3 * i:3 * i + 3])
                    for i in range(rounds)]
        wave_ms = [sum(x["ms"] for x in fetch[2 * i:2 * i + 2])
                   for i in range(MESH_WAVES)]
        rows.append({
            "calls": len(log),
            "bytes_per_round": sum(x["bytes"] for x in shuffle) / rounds,
            "a2a_ms_per_round": round_ms,
            "a2a_ms_median": statistics.median(round_ms),
            "fetch_bytes_per_wave": sum(x["bytes"] for x in fetch)
            / MESH_WAVES,
            "fetch_ms_per_wave": wave_ms,
            "fetch_ms_median": statistics.median(wave_ms),
            "clock": sorted({x["clock"] for x in log})})
    emit(phase=f"{phase}.exchange", ranks=ranks, backend=backend,
         off_rank_share=(ranks - 1) / ranks, per_rank=rows,
         what=("one card; gloo stages every all_to_all through host memory: "
               "not an NVLink time" if backend == "gloo" else
               "NCCL, world of 1: the all_to_all is a copy on the card, no "
               "link is crossed"), card=SMI)


@contextlib.contextmanager
def stdout_to(log):
    """This process's stdout, and that of the processes it starts, into
    `log` (at the file descriptor, which spawned ranks inherit)."""
    sys.stdout.flush()
    log.flush()
    saved = os.dup(1)
    os.dup2(log.fileno(), 1)
    try:
        with contextlib.redirect_stdout(log):
            yield
    finally:
        sys.stdout.flush()
        log.flush()
        os.dup2(saved, 1)
        os.close(saved)


def phase_mesh_nccl1(full, wrappers, log):
    """The out-of-core path on a RankMesh of one NCCL rank (W = 8, R1 = 4,
    device merge, MESH_NCCL_RECORDS in 4 waves): every all_to_all and the
    overflow reduce go through NCCL. Output etags identical to the
    mesh=None run of the same plan, valsort clean. Returns the launches
    and the shapes launched at."""
    from repro_torch.launch.mesh import init_rank_mesh

    plan = mesh_plan(full, MESH_NCCL_RECORDS)
    argv = ["--records", str(MESH_NCCL_RECORDS), "--waves", str(MESH_WAVES),
            "--no-faults", "--device", DEVICE]
    stores = {tag: os.path.join(WORK_DIR, f"store-mesh-{tag}")
              for tag in ("nccl1", "one")}
    rdzv = os.path.join(WORK_DIR, "mesh-nccl1-rendezvous")
    for path in (*stores.values(), rdzv):
        shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    mesh = init_rank_mesh(NUM_WORKERS, backend="nccl", device=DEVICE,
                          rank=0, world=1, store_path=rdzv)
    with mesh:
        zero_launches(wrappers)
        out = run_example(argv + ["--store", stores["nccl1"]], plan, log, mesh)
        launches = read_launches(wrappers)
    shapes = {n: sorted(fn.shapes) for n, fn in wrappers.items()}
    secs = time.perf_counter() - t0
    emit(phase="mesh.nccl1", ranks=1, backend="nccl",
         records=MESH_NCCL_RECORDS, waves=MESH_WAVES, seconds=secs,
         map_s=out["map_s"], reduce_s=out["reduce_s"],
         records_per_s=out["records_per_s"], valsort_ok=out["valsort_ok"],
         launches=launches, card=SMI)
    emit_exchanges("mesh.nccl1", 1, "nccl", [out["exchanges"]], plan)
    if not out["valsort_ok"]:
        raise AssertionError("mesh.nccl1: valsort failed")
    require_launched("mesh.nccl1", launches, wrappers)
    one = run_example(argv + ["--store", stores["one"]], plan, log)
    got = {tag: layout(path) for tag, path in stores.items()}
    for path in stores.values():
        shutil.rmtree(path, ignore_errors=True)
    if not one["valsort_ok"] or got["nccl1"] != got["one"]:
        raise AssertionError("mesh.nccl1: output etags differ from the "
                             "mesh=None run's")
    emit(phase="mesh.nccl1.identity", outputs=len(got["one"]),
         etags_identical=True, one_process_map_s=one["map_s"],
         one_process_reduce_s=one["reduce_s"])
    return launches, shapes


def phase_mesh_gloo(full, wrappers, log, nccl1_shapes):
    """MESH_GLOO_RANKS gloo rank processes on the one card (each its own
    CUDA context, all on cuda:0), through cloudsort_oocore's --ranks, at
    MESH_GLOO_RECORDS in 4 waves: output etags identical to the mesh=None
    run's, valsort clean; the ranks' launches summed and every shape a
    rank launched at (here and in mesh.nccl1) held bit-identical
    (`mesh.hold`). Then the in-memory distributed_sort_payload over the
    same ranks in both payload modes, bit-identical (sha256 of the whole
    output) to the one-process run's, the through mode's slot gather
    launched on every rank and every shape a rank launched at held
    (`mesh.payload.hold`). Returns the launches of both parts."""
    from repro_torch.examples import cloudsort_e2e
    from repro_torch.kernels.slot_gather import gather_slot_rows

    g = MESH_GLOO_RANKS
    plan = mesh_plan(full, MESH_GLOO_RECORDS)
    argv = ["--records", str(MESH_GLOO_RECORDS), "--waves", str(MESH_WAVES),
            "--no-faults", "--device", f"{DEVICE}:0"]
    stores = {tag: os.path.join(WORK_DIR, f"store-mesh-{tag}")
              for tag in ("gloo", "one")}
    for path in stores.values():
        shutil.rmtree(path, ignore_errors=True)
    zero_launches(wrappers)
    t0 = time.perf_counter()
    out = run_example(argv + ["--store", stores["gloo"], "--ranks", str(g),
                             "--backend", "gloo"], plan, log)
    secs = time.perf_counter() - t0
    ranks = out["ranks"]
    launches = read_launches(wrappers, [r["launches"] for r in ranks])
    emit(phase="mesh.gloo", ranks=g, backend="gloo",
         records=MESH_GLOO_RECORDS, waves=MESH_WAVES, seconds=secs,
         map_s=out["map_s"], reduce_s=out["reduce_s"],
         records_per_s=out["records_per_s"], valsort_ok=out["valsort_ok"],
         launches=launches, rank_launches=[r["launches"] for r in ranks],
         card=SMI)
    emit_exchanges("mesh.gloo", g, "gloo", [r["exchanges"] for r in ranks],
                   plan)
    if not out["valsort_ok"]:
        raise AssertionError("mesh.gloo: valsort failed")
    require_launched("mesh.gloo", launches, wrappers)
    for r in ranks:
        require_launched(f"mesh.gloo rank {r['rank']}", r["launches"],
                         wrappers)
    hold_shapes("mesh", wrappers,
                [nccl1_shapes] + [r["shapes"] for r in ranks])
    one = run_example(argv + ["--store", stores["one"]], plan, log)
    got = {tag: layout(path) for tag, path in stores.items()}
    for path in stores.values():
        shutil.rmtree(path, ignore_errors=True)
    if not one["valsort_ok"] or got["gloo"] != got["one"]:
        raise AssertionError("mesh.gloo: output etags differ from the "
                             "mesh=None run's")
    payload_wrappers = dict(wrappers, gather_slot_rows=gather_slot_rows)
    zero_launches(payload_wrappers)
    digests, rank_kernels = {}, []
    for mode in ("through", "late"):
        e2e = ["--records", str(IDENTITY_RECORDS), "--payload-mode", mode,
               "--device", f"{DEVICE}:0"]
        with stdout_to(log):
            t0 = time.perf_counter()
            ranked = cloudsort_e2e.main(e2e + ["--ranks", str(g), "--backend",
                                               "gloo"])
            ranked_s = time.perf_counter() - t0
            alone = cloudsort_e2e.main(e2e)
        digests[mode] = ranked["digest"]
        if not (ranked["valsort_ok"] and alone["valsort_ok"]
                and ranked["digest"] == alone["digest"]):
            raise AssertionError(f"mesh.gloo: distributed_sort_payload "
                                 f"({mode}) over {g} ranks differs from the "
                                 "one-process run")
        gathers = [k["launches"]["gather_slot_rows"]
                   for k in ranked["rank_kernels"]]
        if mode == "through" and min(gathers) < 1:
            raise AssertionError(f"mesh.gloo.payload: slot gather launches "
                                 f"by rank {gathers}: some rank never "
                                 "launched it")
        rank_kernels += ranked["rank_kernels"]
        emit(phase="mesh.gloo.payload", mode=mode, records=IDENTITY_RECORDS,
             ranks=g, seconds=ranked_s, sort_s=ranked["sort_s"],
             one_process_sort_s=alone["sort_s"], bit_identical=True,
             rank_gather_launches=gathers)
    payload_launches = {n: sum(k["launches"][n] for k in rank_kernels)
                        for n in payload_wrappers}
    hold_shapes("mesh.payload", payload_wrappers,
                [k["shapes"] for k in rank_kernels], NUM_WORKERS // g)
    emit(phase="mesh.gloo.identity", outputs=len(got["one"]),
         etags_identical=True, one_process_map_s=one["map_s"],
         one_process_reduce_s=one["reduce_s"], payload_digests=digests,
         payload_launches=payload_launches)
    return launches, payload_launches


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


def phase_serve_full(wrappers, costs):
    """qwen2-moe-a2.7b at full width and depth in bfloat16 on the card:
    the parameter count against the config's arithmetic, peak memory,
    prefill ms, decode ms a step and tokens/s of SERVE_REQUESTS greedy
    requests through serve/engine.generate."""
    from repro_torch.models import api as mapi
    from repro_torch.models import transformer

    cfg = serve_config()
    model = mapi.build(cfg)
    prompt = {"tokens": torch.from_numpy(prompts(cfg, SERVE_FULL_PROMPT))}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    zero_launches(wrappers)
    stats = {}
    params, batch, finite, gen, steps = serve_window(model, prompt, DEVICE,
                                                     stats)
    gen = gen.cpu()
    peak = torch.cuda.max_memory_allocated()
    init_s = stats["init_s"]
    count = sum(p.numel() for p in params.parameters())
    want = transformer.expected_param_count(cfg)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    # one decode step again, traced: its device time by kernel against
    # its wall time (how much of a step the card is busy)
    logits, cache = model.prefill(params, batch,
                                  max_len=SERVE_FULL_PROMPT + 1)
    token = torch.argmax(logits[:, -1], dim=-1)[:, None]
    del logits

    def step():
        model.decode_step(params, cache, token, SERVE_FULL_PROMPT)

    emit_split("serve.split", step)
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
    dryrun_hold("serve.full", peak, baseline,
                lambda: serve_window(model, prompt, "meta"))
    costs["serve.full.prefill"] = dict(
        flops=meta_flops(model.prefill, model.abstract_params(),
                         to_meta(prompt)),
        seconds=stats["prefill_s"])
    return launches, gen


def train_config(**over):
    from repro_torch.configs import get

    return dataclasses.replace(get(TRAIN_ARCH), **over)


def train_batch(cfg, shape, device):
    """Batch 0 of the training pipeline (TokenPipeline) for `cfg`."""
    from repro_torch.data.pipeline import DataConfig, TokenPipeline

    b, s = shape
    return TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=s,
                                    global_batch=b, num_samples=b * 64),
                         device=device).batch_at(0)


@contextlib.contextmanager
def routed_experts(seen):
    """Record the largest expert id the MoE router picks in each call."""
    from repro_torch.core import moe_dispatch as md

    orig = md.route_topk

    def spy(logits, top_k):
        weights, ids = orig(logits, top_k)
        seen.append(int(ids.max()))
        return weights, ids

    md.route_topk = spy
    try:
        yield
    finally:
        md.route_topk = orig


def phase_train_identity(wrappers):
    """One training step of qwen2-moe-a2.7b at its published widths,
    TRAIN_IDENTITY_LAYERS deep, float32 with TF32 off and the sort
    dispatch, from the same weights and batch on the card and the CPU:
    the loss within TRAIN_LOSS_TOL, the parameters after the step within
    rtol TRAIN_PARAM_RTOL / atol TRAIN_PARAM_ATOL, and no expert id at or
    above the config's 60 routed (the 4 pad experts are masked)."""
    from repro_torch.models import api as mapi
    from repro_torch.models.transformer import Transformer
    from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                              train_state_of)

    cfg = train_config(n_layers=TRAIN_IDENTITY_LAYERS, dtype="float32",
                       remat=False, dispatch_impl="sort")
    model = mapi.build(cfg)
    tcfg = TrainConfig()
    batch = train_batch(cfg, TRAIN_IDENTITY_BATCH, "cpu")
    zero_launches(wrappers)
    states, metrics, secs, seen = {}, {}, {}, []
    with full_float32(), routed_experts(seen):
        # the same weights on both sides: drawn on the CPU, copied over
        cpu_params = model.init(torch.Generator().manual_seed(SEED),
                                trainable=True)
        card_params = Transformer(cfg, None, trainable=True)
        card_params.load_state_dict(
            {n: p.detach().to(DEVICE) for n, p in
             cpu_params.state_dict().items()}, strict=True, assign=True)
        for device, params in ((DEVICE, card_params), ("cpu", cpu_params)):
            state = train_state_of(params, tcfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            states[device], m = make_train_step(model, tcfg)(
                state, {k: v.to(device) for k, v in batch.items()})
            metrics[device] = {k: float(v) for k, v in m.items()}
            secs[device] = time.perf_counter() - t0
    launches = read_launches(wrappers)
    param_diff, excess, mu_rel, mu_excess = state_diffs(states)
    n_params = sum(p.numel() for p in cpu_params.parameters())
    del states, card_params, cpu_params
    torch.cuda.empty_cache()
    diffs = {k: abs(metrics[DEVICE][k] - metrics["cpu"][k])
             for k in ("loss", "grad_norm")}
    emit(phase="train.identity", arch=TRAIN_ARCH, layers=cfg.n_layers,
         params=n_params, dtype=cfg.dtype, batch=list(TRAIN_IDENTITY_BATCH),
         dispatch=cfg.dispatch_impl, metrics=metrics,
         loss_max_abs_diff=diffs["loss"], loss_tol=TRAIN_LOSS_TOL,
         grad_norm_max_abs_diff=diffs["grad_norm"],
         params_max_abs_diff=param_diff,
         params_tol=[TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL],
         params_worst_excess=excess, grads_max_rel_diff=mu_rel,
         grads_worst_excess=mu_excess, max_routed_expert=max(seen),
         n_experts=cfg.n_experts, n_experts_padded=cfg.n_experts_padded,
         card_step_s=secs[DEVICE], cpu_step_s=secs["cpu"],
         launches=launches)
    if diffs["loss"] > TRAIN_LOSS_TOL or excess > 0 or mu_excess > 0 \
            or not np.isfinite(metrics[DEVICE]["loss"]):
        raise AssertionError(f"train.identity: loss differs by "
                             f"{diffs['loss']}, parameters exceed their "
                             f"bound by {excess}, gradients by {mu_excess}")
    if max(seen) >= cfg.n_experts:
        raise AssertionError(f"train.identity: routed to expert "
                             f"{max(seen)} of {cfg.n_experts}")
    require_none_launched("train.identity", launches)
    return launches


def state_diffs(states):
    """The card's training state after a step against the CPU's: the
    largest parameter difference and its excess over rtol
    TRAIN_PARAM_RTOL / atol TRAIN_PARAM_ATOL (> 0: outside), the first
    moments' (0.1 x the clipped gradients) largest difference relative to
    each leaf's largest and its excess over rtol 1e-3 / atol 1e-4 of the
    leaf's largest (tests/test_torch_models.py's bounds)."""
    cpu_named = dict(states["cpu"]["params"].named_parameters())
    param_diff, excess = 0.0, -1.0
    mu_rel, mu_excess = 0.0, -1.0
    for name, p in states[DEVICE]["params"].named_parameters():
        got, want = p.detach().cpu(), cpu_named[name].detach()
        # a NaN anywhere counts as an infinite difference
        diff = (got - want).abs().nan_to_num(nan=float("inf"))
        param_diff = max(param_diff, float(diff.max()))
        excess = max(excess, float((diff - TRAIN_PARAM_ATOL
                                    - TRAIN_PARAM_RTOL * want.abs()).max()))
        got = states[DEVICE]["opt"]["mu"][name].cpu()
        want = states["cpu"]["opt"]["mu"][name]
        top = float(want.abs().max())
        diff = (got - want).abs().nan_to_num(nan=float("inf"))
        mu_rel = max(mu_rel, float(diff.max()) / max(top, 1e-30))
        mu_excess = max(mu_excess, float(
            (diff - 1e-4 * top - 1e-3 * want.abs()).max()))
    return param_diff, excess, mu_rel, mu_excess


def phase_train_full(wrappers, costs):
    """qwen2-moe-a2.7b at its published widths, TRAIN_FULL_LAYERS deep,
    bfloat16 compute over float32 masters, remat on, the sort dispatch
    (ep_size 1, capacity factor 1.25), the config's 4 microbatches:
    TRAIN_FULL_STEPS AdamW steps on one repeated batch; each step's loss
    (finite, the last below the first), step ms, tokens/s, peak memory,
    and a torch.profiler split of one more step."""
    from repro_torch.launch import dryrun
    from repro_torch.models import api as mapi
    from repro_torch.models import transformer
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)

    cfg = train_config(n_layers=TRAIN_FULL_LAYERS, dispatch_impl="sort")
    model = mapi.build(cfg)
    tcfg = TrainConfig(opt=OptConfig(warmup_steps=2,
                                     total_steps=TRAIN_FULL_STEPS),
                       microbatches=cfg.train_microbatches)
    batch = train_batch(cfg, TRAIN_FULL_BATCH, DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated() - dryrun.live_bytes(batch)
    zero_launches(wrappers)
    losses, step_s = [], []
    state, step = train_window(model, tcfg, batch, DEVICE, TRAIN_FULL_STEPS,
                               step_s, losses)
    peak = torch.cuda.max_memory_allocated()
    params = state["params"]
    count = sum(p.numel() for p in params.parameters())
    want = transformer.expected_param_count(cfg)
    state_bytes = 16 * count  # float32 masters, grads, mu, nu
    launches = read_launches(wrappers)

    def one_step():
        step(state, batch)

    emit_split("train.split", one_step)
    del state, params, step
    torch.cuda.empty_cache()
    steady = step_s[1:]
    tokens = TRAIN_FULL_BATCH[0] * TRAIN_FULL_BATCH[1]
    emit(phase="train.full", arch=TRAIN_ARCH, layers=cfg.n_layers,
         dtype=cfg.dtype, remat=cfg.remat, dispatch=cfg.dispatch_impl,
         capacity_factor=cfg.moe_capacity_factor,
         microbatches=tcfg.microbatches, batch=list(TRAIN_FULL_BATCH),
         params=count, params_expected=want, state_bytes=state_bytes,
         max_memory_allocated=peak, losses=losses,
         step_ms_median=statistics.median(steady) * 1e3,
         step_ms_min=min(steady) * 1e3, step_ms_max=max(steady) * 1e3,
         first_step_ms=step_s[0] * 1e3,
         tokens_per_s=tokens / statistics.median(steady),
         launches=launches)
    if count != want:
        raise AssertionError(f"train.full: {count} parameters, the config "
                             f"gives {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train.full: losses {losses}")
    if peak <= state_bytes:
        raise AssertionError(f"train.full: peak memory {peak} B below the "
                             f"state's {state_bytes} B")
    require_none_launched("train.full", launches)
    dryrun_hold("train.full", peak, baseline, lambda: train_window(
        model, tcfg, to_meta(batch), "meta", TRAIN_FULL_STEPS))
    meta_state = init_train_state(model, None, tcfg)
    costs["train.full.step"] = dict(
        flops=meta_flops(make_train_step(model, tcfg), meta_state,
                         to_meta(batch)),
        seconds=statistics.median(steady))
    return launches


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def phase_train_launch(wrappers, log):
    """The training driver (repro_torch.launch.train.main) for
    tinyllama-1.1b at full width and depth: run A straight to step
    LAUNCH_STEPS, run B to step LAUNCH_CKPT_STEP writing its checkpoint,
    run C restarting from B's checkpoint to LAUNCH_STEPS; C's step losses
    equal A's within LAUNCH_RESTART_RTOL. The checkpoints are deleted."""
    from repro_torch.launch import train as tlaunch

    ck = os.path.join(WORK_DIR, "ckpt-launch")
    shutil.rmtree(ck, ignore_errors=True)
    base = ["--arch", LAUNCH_ARCH, *LAUNCH_ARGS, *LAUNCH_EXTRA,
            "--log-every", "1", "--device", DEVICE]
    zero_launches(wrappers)
    runs, secs = {}, {}
    for name, extra in (("A", ["--steps", str(LAUNCH_STEPS)]),
                        ("B", ["--steps", str(LAUNCH_CKPT_STEP),
                               "--ckpt-dir", ck]),
                        ("C", ["--steps", str(LAUNCH_STEPS),
                               "--ckpt-dir", ck])):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            runs[name] = tlaunch.main(base + extra)
        secs[name] = time.perf_counter() - t0
        if name == "B":
            ckpt_bytes = dir_bytes(os.path.join(
                ck, f"step_{LAUNCH_CKPT_STEP:08d}"))
        torch.cuda.empty_cache()
    launches = read_launches(wrappers)
    shutil.rmtree(ck, ignore_errors=True)
    a, b, c = runs["A"], runs["B"], runs["C"]
    rel = {s: abs(c["losses"][s] - a["losses"][s]) / abs(a["losses"][s])
           for s in range(LAUNCH_CKPT_STEP, LAUNCH_STEPS)}
    emit(phase="train.launch", arch=LAUNCH_ARCH, args=LAUNCH_ARGS,
         losses={k: r["losses"] for k, r in runs.items()},
         restart_step=c["start"], restart_rel_diff=rel,
         restart_rtol=LAUNCH_RESTART_RTOL,
         restart_identical=all(v == 0 for v in rel.values()),
         ckpt_bytes=ckpt_bytes, save_s=b["save_s"], load_s=c["load_s"],
         final_save_s=c["save_s"], run_s=secs,
         tokens_per_s=a["tokens_per_s"], launches=launches)
    if c["start"] != LAUNCH_CKPT_STEP or max(rel.values()) > \
            LAUNCH_RESTART_RTOL:
        raise AssertionError(f"train.launch: restart at {c['start']}, "
                             f"relative loss differences {rel}")
    if not all(np.isfinite(list(a["losses"].values()))):
        raise AssertionError(f"train.launch: losses {a['losses']}")
    require_none_launched("train.launch", launches)
    return launches


def phase_train_moe_example(wrappers, log):
    """The port's examples/train_moe.py (dp 2 x ep 4 as a batch axis) on
    the card: losses at steps 0, 25, 50, 75 and the last, tokens/s."""
    from repro_torch.examples import train_moe

    ck = os.path.join(WORK_DIR, "ckpt-moe")
    shutil.rmtree(ck, ignore_errors=True)
    zero_launches(wrappers)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        out = train_moe.main(MOE_EXAMPLE_ARGS + ["--device", DEVICE,
                                                 "--ckpt-dir", ck])
    wall = time.perf_counter() - t0
    launches = read_launches(wrappers)
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()
    losses = out["losses"]
    picks = sorted({s for s in (0, 25, 50, 75) if s < len(losses)}
                   | {len(losses) - 1})
    emit(phase="train.moe_example", steps=len(losses), params=out["params"],
         losses={s: losses[s] for s in picks},
         tokens_per_s=out["tokens_per_s"], seconds=wall, launches=launches)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train.moe_example: losses {losses}")
    require_none_launched("train.moe_example", launches)
    return launches


def phase_serve_launch(wrappers, log):
    """The serving driver (repro_torch.launch.serve.main) for
    tinyllama-1.1b at full width and depth: 4 x 32-token prompts, 16 new
    tokens; tokens/s."""
    from repro_torch.configs import get
    from repro_torch.launch import serve as tserve

    argv = [a for k, v in SERVE_LAUNCH.items()
            for a in (f"--{k.replace('_', '-')}", str(v))]
    zero_launches(wrappers)
    with contextlib.redirect_stdout(log):
        out = tserve.main(argv + LAUNCH_EXTRA + ["--device", DEVICE])
    launches = read_launches(wrappers)
    toks = out["tokens"].cpu()
    in_range = bool(((toks >= 0) & (toks < get(
        SERVE_LAUNCH["arch"]).padded_vocab)).all())
    torch.cuda.empty_cache()
    emit(phase="serve.launch", **SERVE_LAUNCH,
         tokens_shape=list(toks.shape), seconds=out["seconds"],
         tokens_per_s=out["tokens_per_s"], tokens_in_range=in_range,
         sample_tokens=toks[0, :8].tolist(), launches=launches)
    want = (SERVE_LAUNCH["batch"], SERVE_LAUNCH["max_new"])
    if not in_range or tuple(toks.shape) != want:
        raise AssertionError(f"serve.launch: tokens in range {in_range}, "
                             f"shape {tuple(toks.shape)}")
    require_none_launched("serve.launch", launches)
    return launches


# ---------------------------------------------------------------------------
# expert parallelism over gloo ranks on the one card (slice 10)
# ---------------------------------------------------------------------------


#: The settings the rank processes take from the parent (a spawned rank
#: imports this script afresh, so a rehearsal's overrides reach it only
#: through these).
RANK_SETTINGS = ("DEVICE", "SEED", "MOE_SHAPE", "MOE_CAPACITY_FACTOR",
                 "SERVE_REQUESTS", "SERVE_IDENTITY_PROMPT",
                 "SERVE_IDENTITY_NEW", "SERVE_FULL_PROMPT", "SERVE_FULL_NEW",
                 "TRAIN_IDENTITY_BATCH", "TRAIN_PARAM_RTOL",
                 "TRAIN_PARAM_ATOL", "TRAIN_RANKS_MORE_STEPS", "TP_LAYOUTS",
                 "TP_SERVE_MESH", "TP_TRAIN_MESH", "TP_TRAIN_BATCH")


def train_ranks_tcfg():
    """train.ranks' training config: no warmup, so Adam's first step moves
    every parameter with a gradient by about the peak lr, five times
    TRAIN_PARAM_ATOL: a zero or wrongly signed update from the ranks'
    backward falls outside the parameters' bound, and a wrongly scaled
    gradient outside the norm's. The lr is 1e-4, not the default 3e-4:
    Adam divides by |g| + eps, so elements whose gradient is near eps
    turn the ranks' rounding into update differences that grow with the
    lr, and at 3e-4 they came within a tenth of the bound."""
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import TrainConfig

    return TrainConfig(opt=OptConfig(peak_lr=1e-4, warmup_steps=1))


def rank_settings():
    return {k: globals()[k] for k in RANK_SETTINGS}


def rank_device():
    """The card of every rank of the EP phases: the one card, named
    (gloo ranks share it), or the CPU in a rehearsal."""
    return "cpu" if DEVICE == "cpu" else f"{DEVICE}:0"


def ep_rank_mesh(rank, world, store, axes):
    from repro_torch.launch.mesh import init_rank_mesh

    return init_rank_mesh(world, backend="gloo", device=rank_device(),
                          rank=rank, world=world, store_path=store,
                          axes=axes)


def own_launches():
    """This process's launch count of each of the four kernels."""
    from repro_torch.kernels.bitonic_sort import bitonic_sort_blocks
    from repro_torch.kernels.kway_merge import merge_sorted_pairs_indexed
    from repro_torch.kernels.merge_sorted import merge_sorted_pairs
    from repro_torch.kernels.range_partition import partition_offsets_blocks

    return {fn.__name__: fn.launches for fn in (
        bitonic_sort_blocks, partition_offsets_blocks, merge_sorted_pairs,
        merge_sorted_pairs_indexed)}


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def moe_case(device):
    """moe.identity's inputs at MOE_SHAPE on `device`: tokens, router
    logits and a probe drawn with numpy from SEED, the expert bank from a
    generator seeded SEED on the device (every rank draws the same)."""
    from repro_torch.models import layers

    e, d = MOE_SHAPE["experts"], MOE_SHAPE["d"]
    f, t = MOE_SHAPE["d_ff"], MOE_SHAPE["tokens"]
    rng = np.random.default_rng(SEED)
    arrays = {"x": rng.normal(size=(t, d)), "logits": rng.normal(size=(t, e)),
              "probe": rng.normal(size=(t, d))}
    case = {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in arrays.items()}
    gen = torch.Generator(device=device).manual_seed(SEED)
    for name, shape, scale in (("w_gate", (e, d, f), d**-0.5),
                               ("w_up", (e, d, f), d**-0.5),
                               ("w_down", (e, f, d), f**-0.5)):
        case[name] = layers.uniform_init(shape, gen, scale).to(device)
    return case


def moe_grads(fn, case, rows, experts, **kw):
    """fn's output on case's rows, routed by route_topk, and the
    gradients of sum(out * probe) for the tokens and the router logits;
    the routing record of the sort."""
    from repro_torch.core import moe_dispatch as md
    from repro_torch.models.moe import expert_fn

    x = case["x"][rows].clone().requires_grad_()
    logits = case["logits"][rows].clone().requires_grad_()
    prm = {n: p.detach().clone().requires_grad_() for n, p in experts.items()}
    w, ids = md.route_topk(logits, MOE_SHAPE["top_k"])
    routing = {}
    out = fn(x, w, ids, prm, cfg=md.MoeDispatchConfig(
        MOE_SHAPE["experts"], MOE_SHAPE["top_k"], MOE_CAPACITY_FACTOR),
        expert_fn=expert_fn, routing=routing, **kw)
    (out * case["probe"][rows]).sum().backward()
    return {"out": out.detach().cpu(), "x": x.grad.cpu(),
            "logits": logits.grad.cpu(), "ids": ids.cpu(),
            "routing": {k: v if isinstance(v, int) else v.cpu()
                        for k, v in routing.items()}}


def moe_rank_dispatch(mesh):
    """moe.ranks.identity on one rank: its rows of the (g, j) layout, its
    E/ep experts, the sort dispatch over the ranks (TF32 off)."""
    from repro_torch.core import moe_dispatch as md

    dp, ep = mesh.size_of("data"), mesh.size_of("model")
    i = mesh.index_of("data") * ep + mesh.index_of("model")
    case = moe_case(mesh.device)
    t = MOE_SHAPE["tokens"] // (dp * ep)
    el = MOE_SHAPE["experts"] // ep
    j = mesh.index_of("model")
    experts = {n: case[n][j * el:(j + 1) * el] for n in
               ("w_gate", "w_up", "w_down")}
    sync(mesh.device)
    t0 = time.perf_counter()
    got = moe_grads(md.sort_dispatch_ranks, case, slice(i * t, (i + 1) * t),
                    experts, mesh=mesh)
    got["seconds"] = time.perf_counter() - t0
    return got


def serve_tokens(model, params, tokens, new, device, stats=None,
                 mesh=None):
    """Prefill logits and `new` greedy tokens of a batch of prompts; on a
    rank of `mesh`, the collectives of generate (its own prefill and the
    decode steps) in the mesh's exchange log. On a tensor-parallel rank
    the logits are gathered over the vocab."""
    from repro_torch.core.collectives import all_gather_seq
    from repro_torch.serve.engine import ServeConfig, generate

    batch = {"tokens": torch.from_numpy(tokens).to(device)}
    logits, _ = model.prefill(params, batch)
    if getattr(params, "tp", None) is not None:
        logits = all_gather_seq(logits, params.tp, "model", dim=-1)
    if mesh is not None:
        mesh.record_exchanges()
    gen, steps = generate(model, params, batch,
                          ServeConfig(max_new_tokens=new), stats=stats)
    return logits.float().cpu(), gen.cpu()


def exchange_kinds(log):
    """A rank's exchange log by kind (`what`): calls, bytes a call, ms a
    call (median, min, max) and in all, and the clock."""
    out = {}
    for what in sorted({x["what"] for x in log}):
        calls = [x for x in log if x["what"] == what]
        ms = [x["ms"] for x in calls]
        out[what] = {"calls": len(calls),
                     "bytes_a_call": sum(x["bytes"] for x in calls)
                     / len(calls),
                     "ms_median": statistics.median(ms), "ms_min": min(ms),
                     "ms_max": max(ms), "ms_total": sum(ms),
                     "clock": sorted({x["clock"] for x in calls})}
    return out


def exchange_summary(log, layers):
    """A rank's exchange log of one generate of an MoE model on data 1 x
    model tp: the prefill's all_to_alls (3 a layer: expert ids, tokens,
    outputs) ms a layer (median, min, max) and bytes, then every kind of
    collective (exchange_kinds): the tensor-parallel psums of the
    embedding and of each block's attention, each block's one MoE psum
    (routed and shared experts' partial sums together), the greedy
    pick's gather."""
    calls = [x for x in log if x["what"] in ("moe.ids", "moe.x", "moe.y")]
    ms = [sum(x["ms"] for x in calls[i:i + 3])
          for i in range(0, len(calls), 3)]
    if len(calls) != 3 * layers:
        raise AssertionError(f"serve.ranks: {len(calls)} all_to_alls in "
                             f"the prefill of {layers} layers")
    return {"a2a": {"calls": len(calls),
                    "ms_a_layer_median": statistics.median(ms),
                    "ms_a_layer_min": min(ms), "ms_a_layer_max": max(ms),
                    "bytes_a_layer": sum(x["bytes"] for x in calls)
                    / layers},
            "kinds": exchange_kinds(log)}


def ep4_body(rank, world, store, settings, identity_cfg, full_cfg):
    """The 4-rank phases on one rank, in one spawn: moe.ranks.identity on
    each layout of MOE_RANK_LAYOUTS, then on data 1 x model 4
    serve.ranks.identity (`identity_cfg`: 2 layers, float32) and
    serve.ranks (`full_cfg`: full depth, bfloat16). Every rank checks
    that the ranks' tokens agree (an all_gather of them)."""
    from repro_torch.models import api as mapi

    globals().update(settings)
    dev = torch.device(rank_device())
    out = {"launches": {}}
    with full_float32():
        for n, axes in enumerate(MOE_RANK_LAYOUTS):
            with ep_rank_mesh(rank, world, f"{store}.moe{n}", axes) as mesh:
                out[f"moe{n}"] = moe_rank_dispatch(mesh)
    out["launches"]["moe"] = own_launches()
    axes = {"data": 1, "model": world}
    with ep_rank_mesh(rank, world, f"{store}.serve", axes) as mesh:
        cfg = identity_cfg
        model = mapi.build(cfg, mesh=mesh)
        before = own_launches()
        with full_float32():
            params = model.init(torch.Generator(device=dev).manual_seed(SEED))
            t0 = time.perf_counter()
            logits, gen = serve_tokens(
                model, params, prompts(cfg, SERVE_IDENTITY_PROMPT),
                SERVE_IDENTITY_NEW, dev)
            out["serve.identity"] = {"logits": logits, "tokens": gen,
                                     "seconds": time.perf_counter() - t0}
        del params
        out["launches"]["serve.identity"] = {
            k: v - before[k] for k, v in own_launches().items()}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        before = own_launches()
        cfg = full_cfg
        model = mapi.build(cfg, mesh=mesh)
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(SEED))
        sync(dev)
        init_s = time.perf_counter() - t0
        stats = {}
        logits, gen = serve_tokens(model, params,
                                   prompts(cfg, SERVE_FULL_PROMPT),
                                   SERVE_FULL_NEW, dev, stats, mesh)
        log = mesh.exchange_log()
        mesh.exchanges = None
        every = mesh.all_gather_object(gen)
        if any(not torch.equal(g, gen) for g in every):
            raise AssertionError(f"serve.ranks: rank {rank}'s tokens differ "
                                 "from another rank's")
        count = sum(p.numel() for p in params.parameters())
        out["serve.ranks"] = {
            "tokens": gen, "finite": bool(torch.isfinite(logits).all()),
            "init_s": init_s, "prefill_s": stats["prefill_s"],
            "decode_s": stats["decode_s"], "local_params": count,
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in params.parameters()),
            "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None),
            "exchanges": exchange_summary(log, cfg.n_layers)}
        out["launches"]["serve.ranks"] = {
            k: v - before[k] for k, v in own_launches().items()}
        del params
    return out


def phase_ep_ranks(wrappers, log, serve_full_tokens):
    """moe.ranks.identity, serve.ranks.identity and serve.ranks: the
    one-process oracles on the card first (the batch-axis forms), then
    EP_RANKS gloo rank processes on the card (ep4_body), then the holds.
    Returns the phases' launches (the parent's plus the ranks')."""
    from repro_torch.core import moe_dispatch as md
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import api as mapi

    zero_launches(wrappers)
    identity_cfg = serve_config(n_layers=SERVE_IDENTITY_LAYERS,
                                dtype="float32")
    # ---- the oracles: the batch-axis forms in this process ----
    want = {}
    with full_float32():
        case = moe_case(DEVICE)
        experts = {n: case[n] for n in ("w_gate", "w_up", "w_down")}
        for n, axes in enumerate(MOE_RANK_LAYOUTS):
            want[f"moe{n}"] = moe_grads(md.sort_dispatch, case, slice(None),
                                        experts, ep_size=axes["model"],
                                        dp=axes["data"])
        del case, experts
        cfg = identity_cfg
        model = mapi.build(cfg, ep_size=EP_RANKS, dp=1)
        params = model.init(generator(DEVICE))
        want["serve.identity"] = serve_tokens(
            model, params, prompts(cfg, SERVE_IDENTITY_PROMPT),
            SERVE_IDENTITY_NEW, DEVICE)
        del params
    torch.cuda.empty_cache()
    # ---- the ranks ----
    t0 = time.perf_counter()
    with stdout_to(log):
        ranks = spawn_ranks(ep4_body, EP_RANKS, rank_settings(),
                            identity_cfg, serve_config())
    spawn_s = time.perf_counter() - t0
    # the oracles' launches (this process's) count with the first phase
    by_phase = {"moe.ranks.identity": read_launches(
        wrappers, [r["launches"]["moe"] for r in ranks])}
    for phase, key in (("serve.ranks.identity", "serve.identity"),
                       ("serve.ranks", "serve.ranks")):
        by_phase[phase] = {n: sum(r["launches"][key][n] for r in ranks)
                           for n in wrappers}
    # ---- moe.ranks.identity ----
    for n, axes in enumerate(MOE_RANK_LAYOUTS):
        dp, ep = axes["data"], axes["model"]
        ref = want[f"moe{n}"]
        got = [r[f"moe{n}"] for r in ranks]  # rank g*ep + j: shard g*ep + j
        ids_same = torch.equal(torch.cat([g["ids"] for g in got]), ref["ids"])
        routing_same = all(
            g["routing"]["cap"] == ref["routing"]["cap"]
            and g["routing"]["ecap"] == ref["routing"]["ecap"]
            and all(torch.equal(g["routing"][k][0], ref["routing"][k][i])
                    for k in ("send_e", "recv_e", "keep", "rank"))
            for i, g in enumerate(got))
        errs = {k: float((torch.cat([g[k] for g in got]) - ref[k]).abs()
                         .nan_to_num(nan=float("inf")).max())
                for k in ("out", "x", "logits")}
        emit(phase="moe.ranks.identity", ranks=EP_RANKS, mesh=axes,
             backend="gloo", **MOE_SHAPE,
             capacity_factor=MOE_CAPACITY_FACTOR, tol=MOE_TOL,
             ids_identical=ids_same, routing_identical=routing_same,
             max_abs_diff_vs_batch_axis=errs,
             out_abs_max=float(ref["out"].abs().max()),
             rank_seconds=[g["seconds"] for g in got],
             launches=by_phase["moe.ranks.identity"], card=SMI)
        if not (ids_same and routing_same) or max(errs.values()) > MOE_TOL:
            raise AssertionError(f"moe.ranks.identity {axes}: ids "
                                 f"{ids_same}, routing {routing_same}, "
                                 f"max |diff| {errs} (tol {MOE_TOL})")
    require_none_launched("moe.ranks.identity",
                          by_phase["moe.ranks.identity"])
    # ---- serve.ranks.identity ----
    logits, gen = want["serve.identity"]
    errs = [float((r["serve.identity"]["logits"] - logits).abs()
                  .nan_to_num(nan=float("inf")).max()) for r in ranks]
    same = all(torch.equal(r["serve.identity"]["tokens"], gen)
               for r in ranks)
    emit(phase="serve.ranks.identity", arch=SERVE_ARCH,
         layers=SERVE_IDENTITY_LAYERS, dtype="float32", ranks=EP_RANKS,
         mesh={"data": 1, "model": EP_RANKS}, requests=SERVE_REQUESTS,
         prompt=SERVE_IDENTITY_PROMPT, new_tokens=SERVE_IDENTITY_NEW,
         prefill_logits_max_abs_diff=errs, tol=SERVE_TOL,
         tokens_identical=same, rank_seconds=[
             r["serve.identity"]["seconds"] for r in ranks],
         launches=by_phase["serve.ranks.identity"], card=SMI)
    if max(errs) > SERVE_TOL or not same:
        raise AssertionError(f"serve.ranks.identity: prefill logits differ "
                             f"by {errs} (tol {SERVE_TOL}), tokens "
                             f"identical {same}")
    require_none_launched("serve.ranks.identity",
                          by_phase["serve.ranks.identity"])
    # ---- serve.ranks ----
    runs = [r["serve.ranks"] for r in ranks]
    gen = runs[0]["tokens"]
    identical = all(torch.equal(r["tokens"], gen) for r in runs)
    finite = all(r["finite"] for r in runs)
    cfg = serve_config()
    equal_full = int((gen == serve_full_tokens).sum())
    rows = []
    for r in runs:
        dec = r["decode_s"]
        wall = r["prefill_s"] + sum(dec)
        rows.append({
            "max_memory_allocated": r["max_memory_allocated"],
            "param_bytes": r["param_bytes"], "init_s": r["init_s"],
            "prefill_ms": r["prefill_s"] * 1e3,
            "decode_ms_median": statistics.median(dec) * 1e3,
            "decode_ms_min": min(dec) * 1e3, "decode_ms_max": max(dec) * 1e3,
            "tokens_per_s": SERVE_REQUESTS * len(dec) / wall,
            "exchanges": r["exchanges"]})
    emit(phase="serve.ranks", arch=SERVE_ARCH, layers=cfg.n_layers,
         dtype=cfg.dtype, ranks=EP_RANKS, backend="gloo",
         mesh={"data": 1, "model": EP_RANKS}, requests=SERVE_REQUESTS,
         prompt=SERVE_FULL_PROMPT, new_tokens=SERVE_FULL_NEW,
         tokens_identical_on_every_rank=identical, logits_finite=finite,
         tokens_equal_to_serve_full=equal_full,
         tokens=int(serve_full_tokens.numel()), per_rank=rows,
         spawn_s=spawn_s, sample_tokens=gen[0, :8].tolist(),
         clock=("device: CUDA events on each rank's stream around the gloo "
                "collective, which stages through host memory"),
         launches=by_phase["serve.ranks"], card=SMI)
    if not (identical and finite and tuple(gen.shape) == (
            SERVE_REQUESTS, SERVE_FULL_NEW)):
        raise AssertionError(f"serve.ranks: tokens identical on every rank "
                             f"{identical}, finite {finite}, shape "
                             f"{tuple(gen.shape)}")
    require_none_launched("serve.ranks", by_phase["serve.ranks"])
    return by_phase


def train_ranks_window(model, mesh, tcfg, batch, device):
    """What one rank of train.ranks holds at its peak: the training state
    drawn on `device` and one step on `batch`."""
    from repro_torch.train.train_step import init_train_state, make_train_step

    state = init_train_state(model, generator(device), tcfg)
    return make_train_step(model, tcfg, mesh=mesh)(state, batch)


def train_ranks_layout(cfg):
    """train.ranks' mesh: data 1 x model 4 if the dry run's peaks of the
    four ranks (one rank's step on "meta", launch/dryrun.peak_bytes; the
    ranks' shapes are the same) sum under TRAIN_RANKS_BUDGET, else data 1
    x model 2. Returns (model size, {size: predicted rank peak})."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import layout_mesh
    from repro_torch.models import api as mapi

    batch = to_meta(train_batch(cfg, TRAIN_IDENTITY_BATCH, "cpu"))
    peaks = {}
    for ep in (4, 2):
        mesh = layout_mesh({"data": 1, "model": ep}, 0)
        peaks[ep] = dryrun.peak_bytes(
            train_ranks_window, mapi.build(cfg, mesh=mesh), mesh,
            train_ranks_tcfg(), batch, "meta")
        if ep * peaks[ep] < TRAIN_RANKS_BUDGET:
            return ep, peaks
    raise AssertionError(f"train.ranks: no layout fits {TRAIN_RANKS_BUDGET} "
                         f"B: predicted rank peaks {peaks}")


def hold_params(params, ref_path, mesh, dev):
    """A rank model's parameters against the one-process model's (saved
    at `ref_path`), each rank's slice of a split tensor
    (launch/sharding.rank_split) against the same slice: (max |diff|,
    the worst element's excess over TRAIN_PARAM_ATOL + TRAIN_PARAM_RTOL
    |want|, whether the replicas are bit-identical: every replicated
    parameter on every rank, every slice on the ranks holding it (one
    per data row), by sha256 gathered over the ranks)."""
    import hashlib

    from repro_torch.launch.sharding import rank_split

    ref = torch.load(ref_path, mmap=True, map_location="cpu")
    split = rank_split(params)
    j = mesh.index_of("model")
    diff, excess, digests = 0.0, -1.0, {}
    for name, p in params.named_parameters():
        want = ref[name]
        if name in split:
            k = p.shape[split[name]]
            want = want.narrow(split[name], j * k, k)
        want = want.to(dev)
        d = (p.detach() - want).abs().nan_to_num(nan=float("inf"))
        diff = max(diff, float(d.max()))
        excess = max(excess, float((d - TRAIN_PARAM_ATOL
                                    - TRAIN_PARAM_RTOL * want.abs()).max()))
        digests[name] = hashlib.sha256(
            p.detach().cpu().numpy().tobytes()).hexdigest()
    del ref, want
    every = mesh.all_gather_object((j, digests))
    replicas = all(d[n] == digests[n] for i, d in every for n in digests
                   if n not in split or i == j)
    return diff, excess, replicas


def train_ranks_body(rank, world, store, settings, cfg, ref_path):
    """train.ranks on one rank: the state drawn as the one-process run
    drew it (each rank keeps its experts), one step held against the
    one-process step's parameters (read from `ref_path`), the replicated
    parameters' digests compared across ranks, then TRAIN_RANKS_MORE_STEPS
    timed steps. The peak memory of the first window (state and step,
    what the dry run predicts) and of the timed steps, apart: the hold's
    copies of the reference are in neither."""
    from repro_torch.models import api as mapi
    from repro_torch.train.train_step import init_train_state, make_train_step

    globals().update(settings)
    dev = torch.device(rank_device())
    with ep_rank_mesh(rank, world, store, {"data": 1, "model": world}) \
            as mesh, full_float32():
        model = mapi.build(cfg, mesh=mesh)
        tcfg = train_ranks_tcfg()
        batch = train_batch(cfg, TRAIN_IDENTITY_BATCH, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        state = init_train_state(model, generator(dev), tcfg)
        step = make_train_step(model, tcfg, mesh=mesh)
        sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync(dev)
        first_s = time.perf_counter() - t0
        cuda = dev.type == "cuda"
        # the window the dry run predicts: the state drawn, one step
        window_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        metrics = {k: float(v) for k, v in m.items()}
        diff, excess, replicas_identical = hold_params(
            state["params"], ref_path, mesh, dev)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        step_s = []
        for _ in range(TRAIN_RANKS_MORE_STEPS):
            sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync(dev)
            step_s.append(time.perf_counter() - t0)
        return {"metrics": metrics, "params_max_abs_diff": diff,
                "params_worst_excess": excess,
                "replicas_identical": replicas_identical,
                "first_step_s": first_s, "step_s": step_s,
                "losses": [metrics["loss"], float(m["loss"])],
                "local_params": sum(p.numel() for p in
                                    state["params"].parameters()),
                "window_max_memory_allocated": window_peak,
                "steps_max_memory_allocated": (
                    torch.cuda.max_memory_allocated(dev) if cuda else None),
                "launches": own_launches()}


def phase_train_ranks(wrappers, log):
    """train.ranks: qwen2-moe-a2.7b at full width, TRAIN_IDENTITY_LAYERS
    deep, float32 masters, the sort dispatch, over gloo ranks on the card
    (data 1 x model 4, or 2 if the dry run says 4 would not fit): one step
    at the peak lr held against the one-process batch-axis step (loss
    within TRAIN_LOSS_TOL, the global gradient norm within
    TRAIN_GRAD_NORM_RTOL, parameters within train.identity's bounds), the
    replicated parameters bit-identical on every rank, then
    TRAIN_RANKS_MORE_STEPS timed steps."""
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import api as mapi
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = train_config(n_layers=TRAIN_IDENTITY_LAYERS, dtype="float32",
                       remat=False, dispatch_impl="sort")
    t0 = time.perf_counter()
    ep, peaks = train_ranks_layout(cfg)
    dry_s = time.perf_counter() - t0
    model = mapi.build(cfg, ep_size=ep, dp=1)
    tcfg = train_ranks_tcfg()
    zero_launches(wrappers)
    ref_path = os.path.join(WORK_DIR, "train-ranks-ref.pt")
    with full_float32():
        state = init_train_state(model, generator(DEVICE), tcfg)
        state, m = make_train_step(model, tcfg)(
            state, train_batch(cfg, TRAIN_IDENTITY_BATCH, DEVICE))
        ref_metrics = {k: float(v) for k, v in m.items()}
        torch.save({n: p.detach().cpu() for n, p in
                    state["params"].named_parameters()}, ref_path)
    n_params = sum(p.numel() for p in state["params"].parameters())
    del state
    torch.cuda.empty_cache()
    try:
        with stdout_to(log):
            ranks = spawn_ranks(train_ranks_body, ep, rank_settings(), cfg,
                                ref_path)
    finally:
        os.remove(ref_path)
    launches = read_launches(wrappers, [r["launches"] for r in ranks])
    loss_diff = max(abs(r["metrics"]["loss"] - ref_metrics["loss"])
                    for r in ranks)
    gn_rel = max(abs(r["metrics"]["grad_norm"] - ref_metrics["grad_norm"])
                 for r in ranks) / abs(ref_metrics["grad_norm"])
    excess = max(r["params_worst_excess"] for r in ranks)
    replicas = all(r["replicas_identical"] for r in ranks)
    emit(phase="train.ranks", arch=TRAIN_ARCH, layers=cfg.n_layers,
         params=n_params, dtype=cfg.dtype, batch=list(TRAIN_IDENTITY_BATCH),
         ranks=ep, backend="gloo", mesh={"data": 1, "model": ep},
         predicted_rank_peak_bytes=peaks, budget_bytes=TRAIN_RANKS_BUDGET,
         dryrun_s=dry_s, metrics=[r["metrics"] for r in ranks],
         one_process_metrics=ref_metrics, loss_max_abs_diff=loss_diff,
         loss_tol=TRAIN_LOSS_TOL, grad_norm_rel_diff=gn_rel,
         grad_norm_rtol=TRAIN_GRAD_NORM_RTOL,
         params_max_abs_diff=max(r["params_max_abs_diff"] for r in ranks),
         params_tol=[TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL],
         params_worst_excess=excess, replicas_identical=replicas,
         first_step_ms=[r["first_step_s"] * 1e3 for r in ranks],
         step_ms_median=[statistics.median(r["step_s"]) * 1e3
                         for r in ranks],
         step_ms_min=[min(r["step_s"]) * 1e3 for r in ranks],
         step_ms_max=[max(r["step_s"]) * 1e3 for r in ranks],
         losses=[r["losses"] for r in ranks],
         local_params=[r["local_params"] for r in ranks],
         window_max_memory_allocated=[r["window_max_memory_allocated"]
                                      for r in ranks],
         window_predicted_over_measured=[
             peaks[ep] / r["window_max_memory_allocated"] for r in ranks
             if r["window_max_memory_allocated"]],
         steps_max_memory_allocated=[r["steps_max_memory_allocated"]
                                     for r in ranks],
         launches=launches, card=SMI)
    if not (loss_diff <= TRAIN_LOSS_TOL and gn_rel <= TRAIN_GRAD_NORM_RTOL
            and excess <= 0 and replicas):
        raise AssertionError(f"train.ranks: loss differs by {loss_diff}, "
                             f"the gradient norm by {gn_rel} (relative), "
                             f"parameters exceed their bound by {excess}, "
                             f"replicas identical {replicas}")
    if not all(np.isfinite(r["losses"]).all() for r in ranks):
        raise AssertionError(f"train.ranks: losses "
                             f"{[r['losses'] for r in ranks]}")
    require_none_launched("train.ranks", launches)
    return launches


def phase_train_moe_example_ranks(wrappers, log):
    """The MoE training example over the reference's own mesh, data 2 x
    model 4 = 8 gloo ranks on the card, MOE_EXAMPLE_RANKS_STEPS steps,
    each step's loss within TRAIN_LOSS_TOL of the one-process example's
    (the mesh as a batch axis) on the same card."""
    from repro_torch.examples import train_moe

    ck = os.path.join(WORK_DIR, "ckpt-moe-ranks")
    shutil.rmtree(ck, ignore_errors=True)
    argv = ["--steps", str(MOE_EXAMPLE_RANKS_STEPS), "--ckpt-dir", ck]
    zero_launches(wrappers)
    t0 = time.perf_counter()
    with stdout_to(log):
        one = train_moe.main(argv + ["--device", DEVICE])
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranked = train_moe.main(argv + ["--device", rank_device(),
                                        "--ranks", "8", "--backend", "gloo"])
    ranked_s = time.perf_counter() - t0
    launches = read_launches(wrappers)
    shutil.rmtree(ck, ignore_errors=True)
    diffs = [abs(a - b) for a, b in zip(ranked["losses"], one["losses"])]
    emit(phase="train.moe_example.ranks", steps=len(ranked["losses"]),
         ranks=ranked["ranks"], mesh=ranked["mesh"], backend="gloo",
         params=ranked["params"], losses=ranked["losses"],
         one_process_losses=one["losses"], loss_max_abs_diff=max(diffs),
         loss_tol=TRAIN_LOSS_TOL, tokens_per_s=ranked["tokens_per_s"],
         one_process_tokens_per_s=one["tokens_per_s"], seconds=ranked_s,
         one_process_seconds=one_s, launches=launches, card=SMI)
    if len(diffs) != MOE_EXAMPLE_RANKS_STEPS or max(diffs) > TRAIN_LOSS_TOL \
            or not all(np.isfinite(ranked["losses"])):
        raise AssertionError(f"train.moe_example.ranks: losses differ by "
                             f"up to {max(diffs)} (tol {TRAIN_LOSS_TOL})")
    require_none_launched("train.moe_example.ranks", launches)
    return launches


def tp_config(**over):
    """TP_ARCH at its published widths, with `over`."""
    from repro_torch.configs import get

    return dataclasses.replace(get(TP_ARCH), **over)


def rows_of(array, mesh):
    """This rank's data row of a global batch array (local_batch's)."""
    from repro_torch.launch.sharding import local_batch

    return local_batch({"x": torch.from_numpy(array)}, mesh)["x"].numpy()


def tp4_body(rank, world, store, settings, identity_cfg, serve_cfg,
             train_cfg, refs):
    """The tensor-parallel phases on one rank, in one spawn:
    tp.identity on each layout of TP_LAYOUTS (`identity_cfg`, float32:
    prefill logits gathered over the vocab, greedy tokens, one train
    step held against the one-process step's parameters at
    refs["identity"]), serve.tp on TP_SERVE_MESH (`serve_cfg`, full
    depth, bfloat16: tokens, timings, the exchange log) and train.tp on
    TP_TRAIN_MESH (`train_cfg`: a held step against refs["train"], then
    timed steps). Every rank draws every weight from the seeded
    generator and keeps its slice."""
    from repro_torch.models import api as mapi
    from repro_torch.train.train_step import init_train_state, make_train_step

    globals().update(settings)
    dev = torch.device(rank_device())
    cuda = dev.type == "cuda"
    tcfg = train_ranks_tcfg()
    out = {"launches": {}, "seconds": {}}

    def launched(before):
        return {k: v - before[k] for k, v in own_launches().items()}

    start = [time.perf_counter()]

    def lap(phase):  # the phase's launches and wall seconds on this rank
        out["launches"][phase] = launched(before)
        out["seconds"][phase] = time.perf_counter() - start[0]
        start[0] = time.perf_counter()

    def peak():
        return torch.cuda.max_memory_allocated(dev) if cuda else None

    def fresh():
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    # ---- tp.identity ----
    before = own_launches()
    cfg = identity_cfg
    for n, axes in enumerate(TP_LAYOUTS):
        with ep_rank_mesh(rank, world, f"{store}.id{n}", axes) as mesh, \
                full_float32():
            model = mapi.build(cfg, mesh=mesh)
            params = model.init(generator(dev))
            logits, gen = serve_tokens(
                model, params, rows_of(prompts(cfg, SERVE_IDENTITY_PROMPT),
                                       mesh), SERVE_IDENTITY_NEW, dev)
            del params
            fresh()
            state = init_train_state(model, generator(dev), tcfg)
            state, m = make_train_step(model, tcfg, mesh=mesh)(
                state, train_batch(cfg, TRAIN_IDENTITY_BATCH, dev))
            diff, excess, replicas = hold_params(state["params"],
                                                 refs["identity"], mesh, dev)
            out[f"identity{n}"] = {
                "logits": logits, "tokens": gen,
                "metrics": {k: float(v) for k, v in m.items()},
                "params_max_abs_diff": diff, "params_worst_excess": excess,
                "replicas_identical": replicas}
            del state
            fresh()
    lap("tp.identity")
    # ---- serve.tp ----
    before = own_launches()
    cfg = serve_cfg
    with ep_rank_mesh(rank, world, f"{store}.serve", TP_SERVE_MESH) as mesh:
        fresh()
        model = mapi.build(cfg, mesh=mesh)
        t0 = time.perf_counter()
        params = model.init(generator(dev))
        sync(dev)
        init_s = time.perf_counter() - t0
        stats = {}
        logits, gen = serve_tokens(model, params,
                                   prompts(cfg, SERVE_FULL_PROMPT),
                                   SERVE_FULL_NEW, dev, stats, mesh)
        log = mesh.exchange_log()
        mesh.exchanges = None
        every = mesh.all_gather_object(gen)
        out["serve.tp"] = {
            "tokens": gen, "identical": all(torch.equal(g, gen)
                                            for g in every),
            "finite": bool(torch.isfinite(logits).all()), "init_s": init_s,
            "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
            "local_params": sum(p.numel() for p in params.parameters()),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in params.parameters()),
            "max_memory_allocated": peak(), "collectives": len(log),
            "exchanges": exchange_kinds(log)}
        del params
    lap("serve.tp")
    # ---- train.tp ----
    before = own_launches()
    cfg = train_cfg
    with ep_rank_mesh(rank, world, f"{store}.train", TP_TRAIN_MESH) as mesh, \
            full_float32():
        model = mapi.build(cfg, mesh=mesh)
        batch = train_batch(cfg, TP_TRAIN_BATCH, dev)
        fresh()
        state = init_train_state(model, generator(dev), tcfg)
        step = make_train_step(model, tcfg, mesh=mesh)
        sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync(dev)
        first_s = time.perf_counter() - t0
        window_peak = peak()  # the window the dry run predicts
        metrics = {k: float(v) for k, v in m.items()}
        diff, excess, replicas = hold_params(state["params"], refs["train"],
                                             mesh, dev)
        fresh()
        step_s, losses = [], [metrics["loss"]]
        for i in range(TRAIN_RANKS_MORE_STEPS):
            if i == TRAIN_RANKS_MORE_STEPS - 1:
                mesh.record_exchanges()  # the last step's collectives
            sync(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync(dev)
            step_s.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        log = mesh.exchange_log()
        mesh.exchanges = None
        out["train.tp"] = {
            "metrics": metrics, "params_max_abs_diff": diff,
            "params_worst_excess": excess, "replicas_identical": replicas,
            "first_step_s": first_s, "step_s": step_s, "losses": losses,
            "sp": state["params"].seq_parallel(TP_TRAIN_BATCH[1]),
            "local_params": sum(p.numel() for p in
                                state["params"].parameters()),
            "window_max_memory_allocated": window_peak,
            "steps_max_memory_allocated": peak(),
            "step_exchanges": exchange_kinds(log)}
        del state
    lap("train.tp")
    return out


def tp_oracles(identity_cfg, serve_cfg, train_cfg):
    """The one-process runs on the card that the TP ranks are held
    against, each freed before the next: tp.identity's float32 prefill
    logits, greedy tokens and one train step (its parameters saved for
    the ranks); serve.tp's bfloat16 tokens, timings and parameter bytes;
    train.tp's one step (parameters saved). Returns (results, the saved
    parameters' paths)."""
    from repro_torch.models import api as mapi
    from repro_torch.train.train_step import init_train_state, make_train_step

    tcfg = train_ranks_tcfg()
    want, refs = {}, {}
    for key, cfg, batch in (
            ("identity", identity_cfg, TRAIN_IDENTITY_BATCH),
            ("train", train_cfg, TP_TRAIN_BATCH)):
        with full_float32():
            model = mapi.build(cfg)
            if key == "identity":
                params = model.init(generator(DEVICE))
                want["identity.serve"] = serve_tokens(
                    model, params, prompts(cfg, SERVE_IDENTITY_PROMPT),
                    SERVE_IDENTITY_NEW, DEVICE)
                del params
            state = init_train_state(model, generator(DEVICE), tcfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = make_train_step(model, tcfg)(
                state, train_batch(cfg, batch, DEVICE))
            torch.cuda.synchronize()
            want[key] = {"metrics": {k: float(v) for k, v in m.items()},
                         "step_s": time.perf_counter() - t0,
                         "params": sum(p.numel() for p in
                                       state["params"].parameters())}
            refs[key] = os.path.join(WORK_DIR, f"tp-{key}-ref.pt")
            torch.save({n: p.detach().cpu() for n, p in
                        state["params"].named_parameters()}, refs[key])
        del state
        torch.cuda.empty_cache()
    model = mapi.build(serve_cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(generator(DEVICE))
    stats = {}
    _, gen = serve_tokens(model, params, prompts(serve_cfg,
                                                 SERVE_FULL_PROMPT),
                          SERVE_FULL_NEW, DEVICE, stats)
    want["serve"] = {
        "tokens": gen, "prefill_s": stats["prefill_s"],
        "decode_s": stats["decode_s"],
        "params": sum(p.numel() for p in params.parameters()),
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in params.parameters()),
        "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del params
    torch.cuda.empty_cache()
    return want, refs


def tp_train_peak(cfg):
    """train.tp's predicted peak of one rank of TP_TRAIN_MESH: its state
    drawn and one step, on "meta" (launch/dryrun.peak_bytes; the ranks'
    shapes are the same). Fails if the ranks' sum exceeds
    TRAIN_RANKS_BUDGET."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import layout_mesh
    from repro_torch.models import api as mapi

    mesh = layout_mesh(TP_TRAIN_MESH, 0)
    batch = to_meta(train_batch(cfg, TP_TRAIN_BATCH, "cpu"))
    peak = dryrun.peak_bytes(train_ranks_window, mapi.build(cfg, mesh=mesh),
                             mesh, train_ranks_tcfg(), batch, "meta")
    if mesh.world * peak > TRAIN_RANKS_BUDGET:
        raise AssertionError(f"train.tp: {mesh.world} ranks of {peak} B "
                             f"exceed {TRAIN_RANKS_BUDGET} B")
    return peak


def phase_tp(wrappers, log):
    """tp.identity, serve.tp and train.tp: tensor parallelism (TP_ARCH,
    `attn_sharding="heads"`) over EP_RANKS gloo ranks on the card. The
    one-process oracles run first on the card (tp_oracles), then the
    ranks (tp4_body), then the holds:

      tp.identity  TP_IDENTITY_LAYERS deep, float32, on each layout of
                   TP_LAYOUTS: prefill logits within TP_TOL, greedy
                   tokens identical, one train step's loss within
                   TP_TOL, each rank's gradient norm within
                   TRAIN_GRAD_NORM_RTOL, parameters within
                   train.identity's bounds, replicas identical;
      serve.tp     full depth, bfloat16, on TP_SERVE_MESH: tokens
                   identical on every rank (and how many equal the one
                   process's), parameter bytes a rank against the one
                   process's, prefill and decode ms, tokens/s, peaks,
                   each collective's calls, bytes and ms;
      train.tp     TP_TRAIN_LAYERS deep, float32 masters, on
                   TP_TRAIN_MESH with sequence parallelism: one step held
                   as tp.identity's, then TRAIN_RANKS_MORE_STEPS timed;
                   the window's peak against the dry run's.

    Returns the phases' launches (the parent's with the first)."""
    from repro_torch.launch.mesh import spawn_ranks

    identity_cfg = tp_config(n_layers=TP_IDENTITY_LAYERS, dtype="float32",
                             remat=False)
    serve_cfg = tp_config()
    train_cfg = tp_config(n_layers=TP_TRAIN_LAYERS, dtype="float32",
                          remat=False)
    t0 = time.perf_counter()
    predicted = tp_train_peak(train_cfg)
    dry_s = time.perf_counter() - t0
    zero_launches(wrappers)
    t0 = time.perf_counter()
    want, refs = tp_oracles(identity_cfg, serve_cfg, train_cfg)
    oracle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        with stdout_to(log):
            ranks = spawn_ranks(tp4_body, EP_RANKS, rank_settings(),
                                identity_cfg, serve_cfg, train_cfg, refs)
    finally:
        for path in refs.values():
            os.remove(path)
    spawn_s = time.perf_counter() - t0
    by_phase = {"tp.identity": read_launches(
        wrappers, [r["launches"]["tp.identity"] for r in ranks])}
    for phase in ("serve.tp", "train.tp"):
        by_phase[phase] = {n: sum(r["launches"][phase][n] for r in ranks)
                           for n in wrappers}
    # ---- tp.identity ----
    logits, gen = want["identity.serve"]
    ref = want["identity"]["metrics"]
    failed = []
    for n, axes in enumerate(TP_LAYOUTS):
        got = [r[f"identity{n}"] for r in ranks]
        m = axes["model"]
        rows = [got[g * m] for g in range(axes["data"])]
        errs = [float((torch.cat([r["logits"] for r in rows]) - logits)
                      .abs().nan_to_num(nan=float("inf")).max())]
        same = torch.equal(torch.cat([r["tokens"] for r in rows]), gen) \
            and all(torch.equal(r["tokens"], got[i - i % m]["tokens"])
                    for i, r in enumerate(got))
        loss_diff = max(abs(r["metrics"]["loss"] - ref["loss"]) for r in got)
        gn_rel = max(abs(r["metrics"]["grad_norm"] - ref["grad_norm"])
                     for r in got) / abs(ref["grad_norm"])
        excess = max(r["params_worst_excess"] for r in got)
        replicas = all(r["replicas_identical"] for r in got)
        emit(phase="tp.identity", arch=TP_ARCH, layers=TP_IDENTITY_LAYERS,
             dtype="float32", ranks=EP_RANKS, backend="gloo", mesh=axes,
             requests=SERVE_REQUESTS, prompt=SERVE_IDENTITY_PROMPT,
             new_tokens=SERVE_IDENTITY_NEW, prefill_logits_max_abs_diff=errs,
             tol=TP_TOL, tokens_identical=same,
             train_batch=list(TRAIN_IDENTITY_BATCH),
             loss_max_abs_diff=loss_diff, grad_norm_rel_diff=gn_rel,
             grad_norm_rtol=TRAIN_GRAD_NORM_RTOL,
             params_max_abs_diff=max(r["params_max_abs_diff"] for r in got),
             params_tol=[TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL],
             params_worst_excess=excess, replicas_identical=replicas,
             one_process_metrics=ref, metrics=[r["metrics"] for r in got],
             rank_seconds=[r["seconds"]["tp.identity"] for r in ranks],
             launches=by_phase["tp.identity"], card=SMI)
        if not (max(errs) <= TP_TOL and same and loss_diff <= TP_TOL
                and gn_rel <= TRAIN_GRAD_NORM_RTOL and excess <= 0
                and replicas):
            failed.append(axes)
    if failed:
        raise AssertionError(f"tp.identity: layouts {failed} outside their "
                             "bounds (the tp.identity lines)")
    require_none_launched("tp.identity", by_phase["tp.identity"])
    # ---- serve.tp ----
    one = want["serve"]
    runs = [r["serve.tp"] for r in ranks]
    gen = runs[0]["tokens"]
    identical = all(r["identical"] and torch.equal(r["tokens"], gen)
                    for r in runs)
    finite = all(r["finite"] for r in runs)
    cfg = serve_cfg
    per_step = 2 * cfg.n_layers + 2  # embed, 2 a block, the pick
    rows = []
    for r in runs:
        dec = r["decode_s"]
        rows.append({
            "max_memory_allocated": r["max_memory_allocated"],
            "param_bytes": r["param_bytes"], "local_params": r["local_params"],
            "init_s": r["init_s"], "prefill_ms": r["prefill_s"] * 1e3,
            "decode_ms_median": statistics.median(dec) * 1e3,
            "decode_ms_min": min(dec) * 1e3, "decode_ms_max": max(dec) * 1e3,
            "tokens_per_s": SERVE_REQUESTS * len(dec)
            / (r["prefill_s"] + sum(dec)),
            "collectives": r["collectives"], "exchanges": r["exchanges"]})
    one_dec = one["decode_s"]
    emit(phase="serve.tp", arch=TP_ARCH, layers=cfg.n_layers,
         dtype=cfg.dtype, ranks=EP_RANKS, backend="gloo", mesh=TP_SERVE_MESH,
         requests=SERVE_REQUESTS, prompt=SERVE_FULL_PROMPT,
         new_tokens=SERVE_FULL_NEW, tokens_identical_on_every_rank=identical,
         logits_finite=finite,
         tokens_equal_to_one_process=int((gen == one["tokens"]).sum()),
         tokens=int(gen.numel()), per_rank=rows,
         one_process={"params": one["params"],
                      "param_bytes": one["param_bytes"],
                      "max_memory_allocated": one["max_memory_allocated"],
                      "prefill_ms": one["prefill_s"] * 1e3,
                      "decode_ms_median": statistics.median(one_dec) * 1e3,
                      "decode_ms_min": min(one_dec) * 1e3,
                      "decode_ms_max": max(one_dec) * 1e3,
                      "tokens_per_s": SERVE_REQUESTS * len(one_dec)
                      / (one["prefill_s"] + sum(one_dec))},
         collectives_a_decode_step=per_step, spawn_s=spawn_s,
         oracles_s=oracle_s,
         rank_seconds=[r["seconds"]["serve.tp"] for r in ranks],
         sample_tokens=gen[0, :8].tolist(),
         clock=("device: CUDA events on each rank's stream around the gloo "
                "collective, which stages through host memory"),
         launches=by_phase["serve.tp"], card=SMI)
    calls = per_step * (SERVE_FULL_NEW + 1)  # the prefill's step, 32 more
    if not (identical and finite and tuple(gen.shape) == (
            SERVE_REQUESTS, SERVE_FULL_NEW)
            and all(r["collectives"] == calls for r in runs)):
        raise AssertionError(f"serve.tp: tokens identical on every rank "
                             f"{identical}, finite {finite}, shape "
                             f"{tuple(gen.shape)}, collectives "
                             f"{[r['collectives'] for r in runs]} (want "
                             f"{calls})")
    require_none_launched("serve.tp", by_phase["serve.tp"])
    # ---- train.tp ----
    ref = want["train"]["metrics"]
    runs = [r["train.tp"] for r in ranks]
    loss_diff = max(abs(r["metrics"]["loss"] - ref["loss"]) for r in runs)
    gn_rel = max(abs(r["metrics"]["grad_norm"] - ref["grad_norm"])
                 for r in runs) / abs(ref["grad_norm"])
    excess = max(r["params_worst_excess"] for r in runs)
    replicas = all(r["replicas_identical"] for r in runs)
    sp = all(r["sp"] for r in runs)
    emit(phase="train.tp", arch=TP_ARCH, layers=TP_TRAIN_LAYERS,
         params=want["train"]["params"], dtype="float32",
         batch=list(TP_TRAIN_BATCH), ranks=EP_RANKS, backend="gloo",
         mesh=TP_TRAIN_MESH, sequence_parallel=sp,
         predicted_rank_peak_bytes=predicted, budget_bytes=TRAIN_RANKS_BUDGET,
         dryrun_s=dry_s, one_process_metrics=ref,
         one_process_step_ms=want["train"]["step_s"] * 1e3,
         metrics=[r["metrics"] for r in runs], loss_max_abs_diff=loss_diff,
         loss_tol=TP_TOL, grad_norm_rel_diff=gn_rel,
         grad_norm_rtol=TRAIN_GRAD_NORM_RTOL,
         params_max_abs_diff=max(r["params_max_abs_diff"] for r in runs),
         params_tol=[TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL],
         params_worst_excess=excess, replicas_identical=replicas,
         first_step_ms=[r["first_step_s"] * 1e3 for r in runs],
         step_ms_median=[statistics.median(r["step_s"]) * 1e3 for r in runs],
         step_ms_min=[min(r["step_s"]) * 1e3 for r in runs],
         step_ms_max=[max(r["step_s"]) * 1e3 for r in runs],
         tokens_per_s=[TP_TRAIN_BATCH[0] * TP_TRAIN_BATCH[1]
                       / statistics.median(r["step_s"]) for r in runs],
         losses=[r["losses"] for r in runs],
         local_params=[r["local_params"] for r in runs],
         window_max_memory_allocated=[r["window_max_memory_allocated"]
                                      for r in runs],
         window_predicted_over_measured=[
             predicted / r["window_max_memory_allocated"] for r in runs
             if r["window_max_memory_allocated"]],
         steps_max_memory_allocated=[r["steps_max_memory_allocated"]
                                     for r in runs],
         step_exchanges=runs[0]["step_exchanges"],
         rank_seconds=[r["seconds"]["train.tp"] for r in ranks],
         launches=by_phase["train.tp"], card=SMI)
    if not (sp and loss_diff <= TP_TOL and gn_rel <= TRAIN_GRAD_NORM_RTOL
            and excess <= 0 and replicas and all(
                np.isfinite(r["losses"]).all() for r in runs)):
        raise AssertionError(f"train.tp: sequence parallel {sp}, loss "
                             f"differs by {loss_diff}, the gradient norm by "
                             f"{gn_rel} (relative), parameters exceed their "
                             f"bound by {excess}, replicas identical "
                             f"{replicas}")
    require_none_launched("train.tp", by_phase["train.tp"])
    return by_phase


def family_config(family, **over):
    """The family's arch at its published widths, with `over`."""
    from repro_torch.configs import get

    return dataclasses.replace(get(FAMILY_ARCHS[family]), **over)


def family_inputs(cfg, requests, length, seed, labels=False):
    """`requests` prompts of `length` text tokens drawn with numpy, the
    frontend stubs' inputs from a CPU generator, and with `labels` the
    labels (a vlm's span its prefix and the text), on the CPU."""
    from repro_torch.models import api as mapi

    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (requests, length)))}
    if labels:
        prefix = cfg.vlm_prefix if cfg.family == "vlm" else 0
        batch["labels"] = torch.from_numpy(rng.integers(
            0, cfg.vocab, (requests, prefix + length)))
    batch.update(mapi.stub_inputs(cfg, requests, length,
                                  torch.Generator().manual_seed(seed)))
    return batch


def phase_family_identity(family, wrappers):
    """One family at its published widths, cut to FAMILY_IDENTITY's
    depth, float32 with TF32 off, from the same weights (drawn on the
    CPU, copied to the card) on the card and the CPU: prefill logits
    within SERVE_TOL, SERVE_IDENTITY_NEW greedy tokens identical, and one
    training step: loss within TRAIN_LOSS_TOL, grad norm within rtol
    1e-4, parameters and first moments within state_diffs' bounds."""
    from repro_torch.models import api as mapi
    from repro_torch.serve.engine import ServeConfig, generate
    from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                              train_state_of)

    spec = FAMILY_IDENTITY[family]
    over = dict(dtype="float32", remat=False)
    if spec["layers"] is not None:
        over["n_layers"] = spec["layers"]
    cfg = family_config(family, **over)
    model = mapi.build(cfg)
    tcfg = TrainConfig()
    serve = family_inputs(cfg, spec["requests"], spec["prompt"], SEED)
    train = family_inputs(cfg, *spec["train"], SEED + 1, labels=True)
    zero_launches(wrappers)
    out, states = {}, {}
    with full_float32():
        cpu_params = model.init(torch.Generator().manual_seed(SEED),
                                trainable=True)
        card_params = mapi.model_class(cfg)(cfg, None, trainable=True)
        card_params.load_state_dict(
            {n: p.detach().to(DEVICE) for n, p in
             cpu_params.state_dict().items()}, strict=True, assign=True)
        for device, params in ((DEVICE, card_params), ("cpu", cpu_params)):
            batch = {k: v.to(device) for k, v in serve.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = model.prefill(params, batch)
            gen, _ = generate(model, params, batch,
                              ServeConfig(max_new_tokens=SERVE_IDENTITY_NEW))
            gen = gen.cpu()
            serve_s = time.perf_counter() - t0
            state = train_state_of(params, tcfg)
            t0 = time.perf_counter()
            states[device], m = make_train_step(model, tcfg)(
                state, {k: v.to(device) for k, v in train.items()})
            out[device] = dict(logits=logits.cpu(), tokens=gen,
                               metrics={k: float(v) for k, v in m.items()},
                               serve_s=serve_s,
                               train_s=time.perf_counter() - t0)
            del logits, batch, state
    launches = read_launches(wrappers)
    param_diff, excess, mu_rel, mu_excess = state_diffs(states)
    n_params = sum(p.numel() for p in cpu_params.parameters())
    del states, card_params, cpu_params
    torch.cuda.empty_cache()
    card, cpu = out[DEVICE], out["cpu"]
    err = float((card["logits"] - cpu["logits"]).abs().max())
    same = bool(torch.equal(card["tokens"], cpu["tokens"]))
    finite = bool(torch.isfinite(card["logits"]).all())
    diffs = {k: abs(card["metrics"][k] - cpu["metrics"][k])
             for k in ("loss", "grad_norm")}
    gn_rel = diffs["grad_norm"] / abs(cpu["metrics"]["grad_norm"])
    emit(phase=f"{family}.identity", arch=cfg.name, layers=cfg.n_layers,
         enc_layers=cfg.enc_layers or None, params=n_params, dtype=cfg.dtype,
         requests=spec["requests"], prompt=spec["prompt"],
         prefix=cfg.vlm_prefix or None, new_tokens=SERVE_IDENTITY_NEW,
         train_batch=list(spec["train"]),
         prefill_logits_max_abs_diff=err, tol=SERVE_TOL,
         logits_abs_max=float(cpu["logits"].abs().max()),
         tokens_identical=same, metrics={"card": card["metrics"],
                                         "cpu": cpu["metrics"]},
         loss_max_abs_diff=diffs["loss"], loss_tol=TRAIN_LOSS_TOL,
         grad_norm_rel_diff=gn_rel, params_max_abs_diff=param_diff,
         params_tol=[TRAIN_PARAM_RTOL, TRAIN_PARAM_ATOL],
         params_worst_excess=excess, grads_max_rel_diff=mu_rel,
         grads_worst_excess=mu_excess,
         seconds={"card_serve": card["serve_s"], "cpu_serve": cpu["serve_s"],
                  "card_step": card["train_s"], "cpu_step": cpu["train_s"]},
         launches=launches, card=SMI)
    if not (finite and err <= SERVE_TOL and same):
        raise AssertionError(f"{family}.identity: finite {finite}, prefill "
                             f"logits differ by {err} (tol {SERVE_TOL}), "
                             f"tokens identical {same}")
    # written so that a NaN anywhere fails
    if not (diffs["loss"] <= TRAIN_LOSS_TOL and gn_rel <= 1e-4
            and excess <= 0 and mu_excess <= 0
            and np.isfinite(card["metrics"]["grad_norm"])):
        raise AssertionError(f"{family}.identity: loss differs by "
                             f"{diffs['loss']}, grad norm by {gn_rel} "
                             f"(relative), parameters exceed their bound by "
                             f"{excess}, gradients by {mu_excess}")
    require_none_launched(f"{family}.identity", launches)
    return launches


def phase_family_serve(family, wrappers):
    """One family at its published widths and depth in bfloat16 on the
    card (llava-next-34b's 67.9 GB of weights fit once the earlier
    phases have freed their memory): SERVE_REQUESTS greedy
    requests of SERVE_FULL_PROMPT text tokens (hymba: 1,100, wrapping its
    ring in the prefill and again in the decode; llava: behind its 576
    patch embeddings; whisper: with its frames), SERVE_FULL_NEW new
    tokens each, through serve/engine.generate: parameters, peak memory,
    prefill ms, decode ms a step, tokens/s; then `<family>.split`, one
    decode step traced."""
    from repro_torch.models import api as mapi
    from repro_torch.models import transformer

    cfg = family_config(family)
    prompt = FAMILY_SERVE_PROMPT.get(family, SERVE_FULL_PROMPT)
    model = mapi.build(cfg)
    inputs = family_inputs(cfg, SERVE_REQUESTS, prompt, SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    zero_launches(wrappers)
    stats = {}
    params, batch, finite, gen, steps = serve_window(model, inputs, DEVICE,
                                                     stats)
    gen = gen.cpu()
    peak = torch.cuda.max_memory_allocated()
    init_s = stats["init_s"]
    count = sum(p.numel() for p in params.parameters())
    want = transformer.expected_param_count(cfg) \
        if cfg.family in transformer.FAMILIES else None
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    # one decode step again, traced: its device time by kernel against
    # its wall time, its launches and syncs
    logits, cache = model.prefill(params, batch, max_len=prompt + 1)
    token = torch.argmax(logits[:, -1], dim=-1)[:, None]
    pos = prompt + (cfg.vlm_prefix if cfg.family == "vlm" else 0)
    del logits
    emit_split(f"{family}.split", lambda: model.decode_step(
        params, cache, token, pos), card=SMI)
    launches = read_launches(wrappers)
    del params, batch, cache
    torch.cuda.empty_cache()
    wall = stats["prefill_s"] + sum(stats["decode_s"])
    in_range = bool(((gen >= 0) & (gen < cfg.padded_vocab)).all())
    emit(phase=f"{family}.serve", arch=cfg.name, layers=cfg.n_layers,
         enc_layers=cfg.enc_layers or None,
         dtype=cfg.dtype, requests=SERVE_REQUESTS, prompt=prompt,
         prefix=cfg.vlm_prefix or None, new_tokens=steps, params=count,
         params_expected=want, param_bytes=param_bytes,
         max_memory_allocated=peak, init_s=init_s,
         prefill_ms=stats["prefill_s"] * 1e3,
         decode_ms_median=statistics.median(stats["decode_s"]) * 1e3,
         decode_ms_min=min(stats["decode_s"]) * 1e3,
         decode_ms_max=max(stats["decode_s"]) * 1e3,
         tokens_per_s=SERVE_REQUESTS * steps / wall,
         decode_tokens_per_s=SERVE_REQUESTS * steps / sum(stats["decode_s"]),
         prefill_logits_finite=finite, tokens_in_range=in_range,
         sample_tokens=gen[0, :8].tolist(), launches=launches, card=SMI)
    if want is not None and count != want:
        raise AssertionError(f"{family}.serve: {count} parameters, the "
                             f"config gives {want}")
    if peak <= param_bytes:
        raise AssertionError(f"{family}.serve: peak memory {peak} B below "
                             f"the parameters' {param_bytes} B")
    if not (finite and in_range and gen.shape == (SERVE_REQUESTS,
                                                  SERVE_FULL_NEW)):
        raise AssertionError(f"{family}.serve: finite {finite}, tokens in "
                             f"range {in_range}, shape {tuple(gen.shape)}")
    require_none_launched(f"{family}.serve", launches)
    dryrun_hold(f"{family}.serve", peak, baseline,
                lambda: serve_window(model, inputs, "meta"))
    return launches


def phase_hybrid_train(wrappers, costs):
    """hymba-1.5b at its published widths, HYBRID_TRAIN_LAYERS deep,
    bfloat16 compute over float32 masters, remat on: HYBRID_TRAIN_STEPS
    AdamW steps on one
    repeated batch of HYBRID_TRAIN_BATCH from the training pipeline; each
    step's loss (finite, the last below the first), step ms, tokens/s,
    peak memory; then `hybrid.train.split`, one more step traced."""
    from repro_torch.launch import dryrun
    from repro_torch.models import api as mapi
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (TrainConfig, init_train_state,
                                              make_train_step)

    cfg = family_config("hybrid", n_layers=HYBRID_TRAIN_LAYERS)
    model = mapi.build(cfg)
    tcfg = TrainConfig(opt=OptConfig(warmup_steps=2,
                                     total_steps=HYBRID_TRAIN_STEPS),
                       microbatches=cfg.train_microbatches)
    batch = train_batch(cfg, HYBRID_TRAIN_BATCH, DEVICE)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated() - dryrun.live_bytes(batch)
    zero_launches(wrappers)
    losses, step_s = [], []
    state, step = train_window(model, tcfg, batch, DEVICE,
                               HYBRID_TRAIN_STEPS, step_s, losses)
    peak = torch.cuda.max_memory_allocated()
    count = sum(p.numel() for p in state["params"].parameters())
    state_bytes = 16 * count  # float32 masters, grads, mu, nu
    emit_split("hybrid.train.split", lambda: step(state, batch), card=SMI)
    launches = read_launches(wrappers)
    del state, step
    torch.cuda.empty_cache()
    steady = step_s[1:]
    tokens = HYBRID_TRAIN_BATCH[0] * HYBRID_TRAIN_BATCH[1]
    emit(phase="hybrid.train", arch=cfg.name, layers=cfg.n_layers,
         dtype=cfg.dtype, remat=cfg.remat, microbatches=tcfg.microbatches,
         batch=list(HYBRID_TRAIN_BATCH), params=count,
         state_bytes=state_bytes, max_memory_allocated=peak, losses=losses,
         step_ms_median=statistics.median(steady) * 1e3,
         step_ms_min=min(steady) * 1e3, step_ms_max=max(steady) * 1e3,
         first_step_ms=step_s[0] * 1e3,
         tokens_per_s=tokens / statistics.median(steady),
         launches=launches, card=SMI)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"hybrid.train: losses {losses}")
    if peak <= state_bytes:
        raise AssertionError(f"hybrid.train: peak memory {peak} B below "
                             f"the state's {state_bytes} B")
    require_none_launched("hybrid.train", launches)
    dryrun_hold("hybrid.train", peak, baseline, lambda: train_window(
        model, tcfg, to_meta(batch), "meta", HYBRID_TRAIN_STEPS))
    costs["hybrid.train.step"] = dict(
        flops=meta_flops(make_train_step(model, tcfg),
                         init_train_state(model, None, tcfg), to_meta(batch)),
        seconds=statistics.median(steady))
    return launches


def phase_cost_tco(full_out):
    """`cost.tco`: core/cost_model.gpu_cloudsort_tco of the paper's 100 TB
    priced from the full run's measured map and reduce records/s a card
    (and the GPU time model's other terms)."""
    from repro_torch.core import cost_model

    records = full_out["records"]
    params = cost_model.GpuCostParams(
        map_records_per_s=records / full_out["map_s"],
        reduce_records_per_s=records / full_out["reduce_s"])
    t = cost_model.gpu_sort_time_model(100e12, params)
    tco = cost_model.gpu_cloudsort_tco(100e12, params)
    emit(phase="cost.tco", data_bytes=100e12, num_gpus=params.num_gpus,
         gpu_hourly=params.gpu_hourly,
         map_records_per_s=params.map_records_per_s,
         reduce_records_per_s=params.reduce_records_per_s, time_model=t,
         breakdown=dict(tco.rows()),
         paper_total=cost_model.cloudsort_tco().total, card=SMI)


def emit_cost_flops(costs):
    """`cost.flops`: launch/op_cost's FLOPs of a step counted on "meta",
    over the step's measured seconds: achieved TFLOP/s and their share
    of the card's dense bf16 peak (BF16_DENSE_PEAK, the H100 SXM data
    sheet's)."""
    rows = {}
    for name, c in costs.items():
        rate = c["flops"] / c["seconds"]
        rows[name] = dict(flops=c["flops"], seconds=c["seconds"],
                          tflops_per_s=rate / 1e12,
                          share_of_bf16_dense_peak=rate / BF16_DENSE_PEAK)
    emit(phase="cost.flops", peak_flops_per_s=BF16_DENSE_PEAK, steps=rows,
         card=SMI)


def run_example(argv, plan, log, mesh=None):
    from repro_torch.examples import cloudsort_oocore

    with stdout_to(log):
        return cloudsort_oocore.main(argv, plan=plan, mesh=mesh)


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
    global SMI
    SMI = smi
    name = torch.cuda.get_device_name(0)
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], device=name,
         capability=list(torch.cuda.get_device_capability(0)),
         device_count=torch.cuda.device_count(), nvidia_smi=smi,
         total_memory=torch.cuda.get_device_properties(0).total_memory,
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
    seconds = {"env+build": time.perf_counter() - t_start}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t0

    # ---- 3. kernels against their plain versions ----
    rows = timed("kernels", phase_kernels, full)

    # ---- 4. identity: card vs CPU at 2^20 records, both reduce merges ----
    t_phase = time.perf_counter()
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
    seconds["identity"] = time.perf_counter() - t_phase

    # ---- 5. the full run: the main path, launches counted alone ----
    t_phase = time.perf_counter()
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
    seconds["full"] = time.perf_counter() - t_phase
    phase_cost_tco(out)

    # ---- 6. the payload modes (their through mode adds the slot gather) ----
    from repro_torch.kernels.slot_gather import gather_slot_rows

    payload_wrappers = dict(wrappers, gather_slot_rows=gather_slot_rows)
    by_phase["payload.identity"] = timed(
        "payload.identity", phase_payload_identity, payload_wrappers)
    by_phase["payload.key10"] = timed("payload.key10.identity",
                                      phase_payload_key10_identity,
                                      payload_wrappers)
    by_phase["payload"] = timed("payload", phase_payload_full,
                                payload_wrappers, log)

    # ---- 7.-9. the fleets: processes, the skew pass, functions ----
    by_phase["fleet"] = timed("fleet", phase_fleet, full, wrappers)
    by_phase["recursive"] = timed("recursive", phase_recursive, full,
                                  wrappers)
    by_phase["cloud"] = timed("cloud", phase_cloud, full, wrappers)

    # ---- 10. the rank mesh: one NCCL rank, gloo ranks on the one card ----
    by_phase["mesh.nccl1"], nccl1_shapes = timed(
        "mesh.nccl1", phase_mesh_nccl1, full, wrappers, log)
    by_phase["mesh.gloo"], by_phase["mesh.gloo.payload"] = timed(
        "mesh.gloo", phase_mesh_gloo, full, wrappers, log, nccl1_shapes)

    # ---- 11.-13. the other users of the shuffle ----
    by_phase["quickstart"] = timed("quickstart", phase_quickstart, wrappers,
                                   log)
    by_phase["groupby"] = timed("groupby", phase_groupby, wrappers, log)
    timed("epoch.identity", phase_epoch_identity)
    by_phase["epoch"] = timed("epoch", phase_epoch_full, wrappers)
    by_phase["moe"] = timed("moe", phase_moe_identity, wrappers)

    # ---- 14. serving qwen2-moe-a2.7b ----
    costs = {}
    timed("serve.identity", phase_serve_identity, wrappers)
    by_phase["serve"], serve_full_tokens = timed(
        "serve.full", phase_serve_full, wrappers, costs)

    # ---- 15. training qwen2-moe-a2.7b and tinyllama-1.1b, the drivers ----
    by_phase["train.identity"] = timed("train.identity",
                                       phase_train_identity, wrappers)
    by_phase["train.full"] = timed("train.full", phase_train_full, wrappers,
                                   costs)
    by_phase["train.launch"] = timed("train.launch", phase_train_launch,
                                     wrappers, log)
    by_phase["train.moe_example"] = timed(
        "train.moe_example", phase_train_moe_example, wrappers, log)
    by_phase["serve.launch"] = timed("serve.launch", phase_serve_launch,
                                     wrappers, log)

    # ---- 16. expert parallelism: gloo ranks on the one card ----
    by_phase.update(timed("ep.ranks", phase_ep_ranks, wrappers, log,
                          serve_full_tokens))
    by_phase["train.ranks"] = timed("train.ranks", phase_train_ranks,
                                    wrappers, log)
    by_phase["train.moe_example.ranks"] = timed(
        "train.moe_example.ranks", phase_train_moe_example_ranks, wrappers,
        log)

    # ---- 17. tensor parallelism: gloo ranks on the one card ----
    by_phase.update(timed("tp", phase_tp, wrappers, log))

    # ---- 18. the other families: vlm, mla, ssm, hybrid, encdec ----
    for family in FAMILY_ARCHS:
        by_phase[f"{family}.identity"] = timed(
            f"{family}.identity", phase_family_identity, family, wrappers)
        by_phase[f"{family}.serve"] = timed(
            f"{family}.serve", phase_family_serve, family, wrappers)
    by_phase["hybrid.train"] = timed("hybrid.train", phase_hybrid_train,
                                     wrappers, costs)
    emit_cost_flops(costs)

    # ---- 20. the kernels line, then the ok line ----
    for row in rows:  # None: the phase does not count that kernel
        row["launches"] = launches.get(row["name"])
        row["launches_by_phase"] = {p: c.get(row["name"])
                                    for p, c in by_phase.items()}
    emit(phase="phase.seconds", seconds=seconds, card=SMI)
    emit(phase="done", seconds=time.perf_counter() - t_start)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
