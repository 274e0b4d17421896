"""Checkpointing with manifests and checksums — the fault-tolerance layer.

Twin of src/repro/train/checkpoint.py, in the reference's on-disk format,
so that a checkpoint written by either package loads in the other:

  <dir>/step_<N>/
      manifest.json   — {"step", "leaves": {name: {shape, dtype, crc32}}}
      <name>.npy      — one file per leaf (full arrays)
  <dir>/LATEST        — the newest step, replaced last

Writes are atomic (tmp dir + rename, then the LATEST marker), so a crash
mid-save never corrupts the restore point. A leaf's name is its path in
the reference's pytree, joined with "__" (dict keys, list indices). The
port's state holds a model (an nn.Module) and moments keyed by its
parameter names; those map onto the reference's tree: a parameter name's
dots are path steps, and the layers' parameters `<stack>.<i>.<key>` of a
stack the reference scans (the model's `.stacked`: `blocks`, or
whisper's `enc_blocks` and `dec_blocks`) are one leaf `<stack>__<key>`
stacked (L, ...) (the inverse of `naming.reference_state`); xlstm's
layers, a list in the reference, stay one leaf `blocks__<i>__<key>`
each. `load` checks each
leaf's crc32 and puts it on the device it is asked for: a checkpoint
written on one device restores onto another (launch/reshard.py).

On the ranks of a launch/mesh.RankMesh (`mesh=`), the layout stays the
same: `save` gathers the tensors a rank model holds a slice of (the
expert banks and their moments, launch/sharding.rank_split) over the
"model" axis, rank 0 writes, and every rank waits for it; `load` reads
the whole leaf and each rank keeps its slice. So a checkpoint written
by ranks loads in one process, and in the reference, and back.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.collectives import gather_rows
from repro_torch.kernels import u32
from repro_torch.launch.sharding import rank_split
from repro_torch.models.naming import STACKED, layer_groups


def _named(node) -> dict | None:
    """A module's tensors, or a mapping keyed by parameter names (dotted),
    as one flat dict; None for any other node."""
    if isinstance(node, nn.Module):
        return dict(node.state_dict(keep_vars=True))
    if isinstance(node, Mapping) and any("." in str(k) for k in node):
        return dict(node)
    return None


def _first_model(node):
    """The first model (nn.Module) in a state tree, or None: the moments
    beside it are named after its parameters."""
    if isinstance(node, nn.Module):
        return node
    children = node.values() if isinstance(node, Mapping) else \
        node if isinstance(node, (list, tuple)) else ()
    for child in children:
        found = _first_model(child)
        if found is not None:
            return found
    return None


def _stacking(node):
    """The stacked prefixes of the first model in a state tree."""
    return getattr(_first_model(node), "stacked", STACKED)


def _rank_split(node) -> dict:
    """launch/sharding.rank_split of the first model in a state tree."""
    model = _first_model(node)
    return {} if model is None else rank_split(model)


def _groups(named: dict, path: tuple, stacked):
    """(leaf name, stacked?, state names) of a flat dict of tensors."""
    for key, names in layer_groups(named, stacked).items():
        yield ("__".join(path + tuple(key.split("."))), names[0] != key,
               names)


def _leaves(node, stacked, path=()):
    """(leaf name, stacked?, [tensors], [state names]) of every leaf of a
    state tree (state names None outside a module or a mapping keyed by
    parameter names)."""
    named = _named(node)
    if named is not None:
        for name, is_stack, names in _groups(named, path, stacked):
            yield name, is_stack, [named[n] for n in names], names
    elif isinstance(node, Mapping):
        for k, v in node.items():
            yield from _leaves(v, stacked, path + (str(k),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _leaves(v, stacked, path + (str(i),))
    else:
        yield "__".join(path), False, [node], [None]


def _all_leaves(state):
    return _leaves(state, _stacking(state))


def leaf_names(state) -> list[str]:
    """The checkpoint leaf names of a state tree, in save order."""
    return [name for name, _, _, _ in _all_leaves(state)]


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(state, ckpt_dir: str, step: int, *, mesh=None):
    """Write `state` as step `step` under ckpt_dir; returns its directory.
    On the ranks of `mesh` every rank calls it: the split tensors are
    gathered over "model" and rank 0 writes."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if mesh is not None:
        split = _rank_split(state)
        # only the first data row's ranks gather: rank 0 is one of them
        lead = mesh.index_of(mesh.data_axes) == 0 if mesh.data_axes \
            else True
        gathered = []
        if lead:
            for name, is_stack, tensors, names in _all_leaves(state):
                tensors = [gather_rows(t.detach().movedim(split[n], 0),
                                       mesh, "model", what="checkpoint")
                           .movedim(0, split[n]) if n in split else t
                           for t, n in zip(tensors, names)]
                gathered.append((name, is_stack, tensors))
        if mesh.rank == 0:
            _write(gathered, ckpt_dir, step, final)
        mesh.barrier()
        return final
    return _write(((name, is_stack, tensors) for name, is_stack, tensors, _
                   in _all_leaves(state)), ckpt_dir, step, final)


def _write(leaves, ckpt_dir: str, step: int, final: str):
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": {}}
    for name, is_stack, tensors in leaves:
        arrs = [_to_numpy(t) for t in tensors]
        arr = np.stack(arrs) if is_stack else arrs[0]
        del arrs
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"][name] = {
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "crc32": zlib.crc32(arr.tobytes()),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    with open(os.path.join(ckpt_dir, "LATEST.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "LATEST.tmp"),
               os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str):
    marker = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return int(f.read().strip())


def load(target, ckpt_dir: str, step: int | None = None, *, device="cuda",
         verify: bool = True, mesh=None):
    """Restore into the structure of `target` (shapes only, e.g. on
    "meta", is enough): every leaf is read, its crc32 checked against the
    manifest, and put on `device` in the target's dtype. A module in the
    target is filled in place (its parameters keep their requires_grad).
    On a rank of `mesh` (the target built on it), a split tensor keeps
    the rank's slice. Returns (state, step)."""
    dev = u32.resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)

    def read(name):
        if name not in manifest["leaves"]:
            raise KeyError(f"{name}: not in the step-{step} manifest")
        arr = np.load(os.path.join(d, name + ".npy"))
        if verify and zlib.crc32(arr.tobytes()) != \
                manifest["leaves"][name]["crc32"]:
            raise ValueError(f"checksum mismatch for {name}")
        return arr

    def put(arr, like, name):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} in the "
                             f"checkpoint, {tuple(like.shape)} in the target")
        dtype = like.dtype if isinstance(like, torch.Tensor) else None
        return torch.from_numpy(np.asarray(arr, order="C")).to(
            device=dev, dtype=dtype)

    stacked = _stacking(target)
    split = _rank_split(target) if mesh is not None else {}

    def mine(arr, like, n):
        """The rank's slice of a split tensor (its part along the dim)."""
        if n not in split:
            return arr
        dim, k = split[n], like.shape[split[n]]
        lo = mesh.index_of("model") * k
        return np.take(arr, np.arange(lo, lo + k), axis=dim)

    def fill_named(named, path):
        out = {}
        for name, is_stack, names in _groups(named, path, stacked):
            arr = read(name)
            parts = list(arr) if is_stack else [arr]
            if len(parts) != len(names):
                raise ValueError(f"{name}: {len(parts)} layers in the "
                                 f"checkpoint, {len(names)} in the target")
            for n, a in zip(names, parts):
                out[n] = put(mine(a, named[n], n), named[n], name)
        return out

    def fill(node, path):
        named = _named(node)
        if isinstance(node, nn.Module):
            node.load_state_dict(fill_named(named, path), strict=True,
                                 assign=True)
            return node
        if named is not None:
            return fill_named(named, path)
        if isinstance(node, Mapping):
            return {k: fill(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v, path + (str(i),))
                              for i, v in enumerate(node))
        name = "__".join(path)
        return put(read(name), torch.as_tensor(node) if not isinstance(
            node, torch.Tensor) else node, name)

    return fill(target, ()), step
