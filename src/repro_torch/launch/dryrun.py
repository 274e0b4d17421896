"""One-card dry run: run every (arch x shape) cell once on "meta" tensors.

Twin of src/repro/launch/dryrun.py. The reference lowers and compiles
each cell on its production mesh and reads XLA's memory analysis; on one
card the counterpart is to run the cell's step once on "meta" tensors
(shapes and dtypes, no storage, nothing on a card) and to track the bytes
its tensors hold while it runs. For each cell this script

  1. builds the arch at its published widths and depth (`overrides`
     patch ArchConfig fields) and the cell's step: the train step of
     train/train_step.py (AdamW state, cfg.train_microbatches, remat as
     configured) on the abstract training state, or prefill, or one
     decode_step against the cell's cache;
  2. runs it under `peak_bytes`' live-storage tracker and op_cost's
     counter (launch/op_cost.py): the peak of live bytes, the bytes live
     at entry (weights, optimizer state, cache, inputs), FLOPs and bytes
     accessed;
  3. records whether the peak fits the card (CAPACITY_BYTES) and the
     largest power-of-two batch up to the cell's own that fits: the
     reference's batches are pod-wide (train_4k is 256 x 4096 tokens),
     so most cells do not fit one card at their own batch.

`peak_bytes` counts what the card's caching allocator counts in
`torch.cuda.max_memory_allocated`: each storage an op creates, rounded
up to the allocator's 512-byte granule, from its creation until it is
freed. It does not see what a kernel allocates for itself (a library's
workspace, a sort's scratch), which is transient and small beside a
model's weights and activations.

Results stream to a JSONL file, one record a cell.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k [--all] [--out results/dryrun.jsonl] [--tag baseline]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
import weakref
from concurrent.futures import ProcessPoolExecutor

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get
from repro_torch.launch import op_cost
from repro_torch.models import api as mapi
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (TrainConfig, abstract_train_state,
                                          make_train_step)

#: One NVIDIA H100 80GB HBM3 (power limit 700.00 W, as nvidia-smi
#: prints it): torch.cuda.get_device_properties(0).total_memory, as
#: chip_smoke.py's env line prints it on that card.
CAPACITY_BYTES = 85_017_493_504
#: The CUDA caching allocator rounds every allocation up to this.
GRANULE = 512


def _round(n: int) -> int:
    return -(-n // GRANULE) * GRANULE


def _storages(tree, out: dict) -> dict:
    """Every tensor storage reachable from `tree` (nested dicts, lists,
    tuples, modules: their parameters, buffers and gradients), by id."""
    if isinstance(tree, nn.Module):
        tree = (list(tree.parameters()), list(tree.buffers()))
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for item in tree:
            _storages(item, out)
    elif isinstance(tree, torch.Tensor):
        st = tree.untyped_storage()
        out[id(st)] = st
        if tree.grad is not None:
            _storages(tree.grad, out)
    return out


class LiveBytes(TorchDispatchMode):
    """Tracks the bytes of live tensor storages while it is active: those
    reachable from `roots` at entry, and each storage an op creates (an
    output whose storage is none of the op's inputs'), until the storage
    is freed. `peak` is the most that was live at once. Given an
    op_cost.OpCounter, it also counts each op's work (one dispatch for
    both); ops on "meta" tensors run through op_cost.MetaMemo."""

    def __init__(self, roots=(), counter: op_cost.OpCounter | None = None):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.counter = counter
        self._memo = op_cost.MetaMemo()
        self._sizes: dict[int, int] = {}
        self._finalizers = []
        for st in _storages(roots, {}).values():
            self._track(st)
        self.entry = self.live

    def _track(self, st) -> None:
        key = id(st)
        if key in self._sizes:
            return
        n = _round(st.nbytes())
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        self._finalizers.append(weakref.finalize(st, self._free, key))

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out, key, fresh = self._memo.run(func, args, kwargs)
        if self.counter is not None:
            self.counter.count(func, args, kwargs, out, key)
        outs = op_cost.flat_tensors(out)
        if fresh:  # made by the memo: each on a new storage
            for t in outs:
                self._track(t.untyped_storage())
        elif outs:
            inputs = {id(t.untyped_storage()) for t in
                      op_cost.flat_tensors(args) + op_cost.flat_tensors(kwargs)}
            for t in outs:
                st = t.untyped_storage()
                if id(st) not in inputs:
                    self._track(st)
        return out

    def __exit__(self, *exc):
        for f in self._finalizers:
            f.detach()
        return super().__exit__(*exc)


def live_bytes(*trees) -> int:
    """The bytes of the distinct storages reachable from `trees`, each
    rounded up to the allocator's granule."""
    return sum(_round(st.nbytes()) for st in _storages(trees, {}).values())


def peak_bytes(fn, *args, **kwargs) -> int:
    """Runs fn(*args, **kwargs) once and returns the most bytes its
    tensors held at once, the bytes live at entry (those reachable from
    the arguments) included."""
    with LiveBytes((args, kwargs)) as lb:
        fn(*args, **kwargs)
    return lb.peak


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------


def _cell_step(model, cfg, shape_name: str, batch: int):
    """(fn, args) of one cell at `batch`, everything on "meta"."""
    kind = mapi.SHAPES[shape_name]["kind"]
    specs = model.input_specs(shape_name, batch=batch)
    if kind == "train":
        tcfg = TrainConfig(opt=OptConfig(), microbatches=cfg.train_microbatches)
        state = abstract_train_state(model, tcfg)
        return make_train_step(model, tcfg), (state, specs)
    params = model.abstract_params()
    if kind == "prefill":
        return model.prefill, (params, specs)
    return model.decode_step, (params, specs["cache"], specs["token"],
                               specs["pos"])


def measure(model, cfg, shape_name: str, batch: int) -> dict:
    """One cell's step at `batch` on "meta": arg_bytes (live at entry),
    peak_bytes, flops, bytes_accessed."""
    fn, args = _cell_step(model, cfg, shape_name, batch)
    counter = op_cost.OpCounter()
    with LiveBytes(args, counter) as lb:
        fn(*args)
    return {"arg_bytes": lb.entry, "peak_bytes": lb.peak,
            "flops": counter.flops, "bytes_accessed": counter.bytes}


def _batches_below(cfg, shape_name: str) -> list[int]:
    """The powers of two below the cell's batch that its step takes (a
    train step splits its batch into cfg.train_microbatches), largest
    first."""
    spec = mapi.SHAPES[shape_name]
    least = cfg.train_microbatches if spec["kind"] == "train" else 1
    out, b = [], spec["batch"] // 2
    while b >= max(least, 1):
        out.append(b)
        b //= 2
    return out


def max_batch(model, cfg, shape_name: str, capacity: int,
              at_cell: dict) -> int:
    """The largest power-of-two batch below the cell's that fits
    `capacity`, or 0; `at_cell` is the cell's own measure (its batch does
    not fit). The peak beyond the inputs grows about linearly with the
    batch, so the search starts at the largest batch that this estimate
    fits and measures its way up or down from there (two measures where
    the estimate is right). A batch whose inputs alone overflow is not
    run."""
    cell = mapi.SHAPES[shape_name]["batch"]
    cands = _batches_below(cfg, shape_name)  # descending
    if not cands:
        return 0
    inputs = {b: live_bytes(_cell_step(model, cfg, shape_name, b)[1])
              for b in cands}
    grows = (at_cell["peak_bytes"] - at_cell["arg_bytes"]) / cell
    i = next((i for i, b in enumerate(cands)
              if inputs[b] + grows * b <= capacity), len(cands) - 1)
    known = {cell: False}

    def fits(b):
        if b not in known:
            known[b] = inputs[b] <= capacity and measure(
                model, cfg, shape_name, b)["peak_bytes"] <= capacity
        return known[b]

    if fits(cands[i]):
        while i > 0 and fits(cands[i - 1]):
            i -= 1
        return cands[i]
    for b in cands[i + 1:]:
        if fits(b):
            return b
    return 0


#: the cells of `--all` run in this many processes at once
SWEEP_WORKERS = 4


def run_cell(arch_id: str, shape_name: str, *, overrides: dict | None = None,
             out_path: str | None = None, tag: str = "baseline",
             capacity_bytes: int = CAPACITY_BYTES) -> dict:
    t0 = time.time()
    batch = mapi.SHAPES[shape_name]["batch"]
    record = {"arch": arch_id, "shape": shape_name, "mesh": "1 card",
              "tag": tag, "ok": False, "batch": batch,
              "seq": mapi.SHAPES[shape_name]["seq"],
              "capacity_bytes": capacity_bytes}
    try:
        cfg = get(arch_id)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        model = mapi.build(cfg)
        record.update(measure(model, cfg, shape_name, batch))
        fits = record["peak_bytes"] <= capacity_bytes
        record.update(
            ok=True, fits=fits,
            max_batch=batch if fits else max_batch(
                model, cfg, shape_name, capacity_bytes, record))
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
    record["wall_s"] = round(time.time() - t0, 1)
    if out_path:
        with open(out_path, "a") as f:
            f.write(json.dumps(record) + "\n")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch x shape) cell")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--tag", default="baseline")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    if args.all:
        cells = [(aid, shp) for aid in ARCH_IDS
                 for shp in mapi.applicable_shapes(get(aid))]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    def report(rec):
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '?')[:80]})"
        print(f"[{rec['mesh']}] {rec['arch']} x {rec['shape']}: {status}  "
              f"wall={rec['wall_s']}s peak="
              f"{rec.get('peak_bytes', 0) / 1e9:.2f}GB fits="
              f"{rec.get('fits')} max_batch={rec.get('max_batch')} "
              f"flops={rec.get('flops', 0):.4g}", flush=True)
        return rec

    if len(cells) == 1:
        return [report(run_cell(*cells[0], tag=args.tag))]
    # a cell is one process's work for seconds to minutes (a 32k prefill
    # dispatches ~0.3 M ops a layer): run them side by side, the prefills
    # first (the longest), and report them in order
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(SWEEP_WORKERS, mp_context=ctx) as pool:
        futures = {cell: pool.submit(run_cell, *cell, tag=args.tag)
                   for cell in sorted(cells,
                                      key=lambda c: c[1] != "prefill_32k")}
        return [report(futures[cell].result()) for cell in cells]


if __name__ == "__main__":
    main()
