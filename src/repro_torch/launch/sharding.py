"""Per-architecture partition rules (DP / TP / FSDP / EP / SP), as plain rules.

Twin of src/repro/launch/sharding.py. Parameters are matched by their
path in the reference's parameter tree (joined with '/'; the port's
state dict names map onto it through models/naming: a stack of layers
is one (L, ...) leaf):
  - attention projections, FFN and expert weights: TP over 'model';
    under `param_sharding == "fsdp"` the non-TP matmul dim is additionally
    sharded over the data axes (FSDP).
  - expert stacks: expert axis over 'model' (EP).
  - embeddings: vocab over 'model'.
  - norms/gates/biases: replicated.
  - unknown leaves: generic fallback — last dim over 'model' when divisible,
    else replicated.

Activations: batch over the data axes; logits vocab over 'model'; decode
caches shard KV heads over 'model' and batch over data; batch-1 long-context
caches shard the *sequence* dim over data (SP).

A spec here is a tuple with one entry per dimension: None (replicated),
an axis name, or a tuple of axis names; it is what the reference's
PartitionSpec holds. A mesh is a RankMesh, any object with the
reference's `shape` and `axis_names`, or a dict {axis name: size}: the
rules read only the axes' names and sizes, so they need no devices.

The rank path (launch/mesh.RankMesh) applies two of these answers: the
expert banks are split over "model" on their expert axis (models/moe.py:
a rank holds E/ep experts, `rank_split` names them), and the batch over
the data axes (`local_batch`). Every other parameter stays replicated
over the ranks, and qwen2-moe's `param_sharding="fsdp"` split of the
experts' d over "data" is not applied. These deviations from the rules
are in layout only, never in numerics: a replicated parameter computes
what its shards would.
"""
from __future__ import annotations

import math
from collections.abc import Mapping
from typing import Any

from repro_torch.models.config import ArchConfig
from repro_torch.models.naming import STACKED, layer_groups


def _axes(mesh) -> dict:
    """{axis name: size} of a mesh, a mesh stand-in or a dict."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    if hasattr(mesh, "axes"):  # launch/mesh.RankMesh
        return dict(mesh.axes)
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _divisible(dim: int, axes: dict, names) -> bool:
    if isinstance(names, str):
        names = (names,)
    return dim % math.prod(axes[a] for a in names) == 0


def _maybe(dim, axes, names):
    """names if the dim divides evenly, else None."""
    return names if _divisible(dim, axes, names) else None


def _data_axes(axes: dict) -> tuple[str, ...]:
    return tuple(a for a in axes if a != "model")


def _padded(entries, nd: int) -> tuple:
    entries = tuple(entries)
    return entries + (None,) * (nd - len(entries))


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def reference_shapes(params) -> dict[str, tuple]:
    """{reference path: shape} of a model's parameters (an nn.Module, or a
    mapping of port state names to tensors or shapes): a stacked leaf
    has its layers as a leading axis, as the reference's scan does."""
    if hasattr(params, "named_parameters"):
        stacked = getattr(params, "stacked", STACKED)
        named = {n: _shape(p) for n, p in params.named_parameters()}
    else:
        stacked = STACKED
        named = {n: _shape(p) for n, p in params.items()}
    out = {}
    for key, names in layer_groups(named, stacked).items():
        shape = named[names[0]]
        out[key.replace(".", "/")] = ((len(names),) + shape
                                      if names[0] != key else shape)
    return out


def _flat(tree, prefix: str = "") -> dict:
    """{'/'-joined path: leaf} of nested mappings and lists."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


def param_pspecs(cfg: ArchConfig, params, mesh) -> dict[str, tuple]:
    """{reference path: spec} of every parameter (`params`: the model at
    full size, e.g. build(cfg).abstract_params(), or a mapping of port
    names to shapes)."""
    axes = _axes(mesh)
    dp = _data_axes(axes)
    tp = "model"
    fsdp = cfg.param_sharding == "fsdp"

    def rule(name: str, shape: tuple):
        nd = len(shape)

        def spec(*entries):
            return _padded(entries, nd)

        if "embed/table" in name:
            # vocab over model even when uneven (the reference's GSPMD pads
            # the last shard)
            return spec(tp, None)
        if name.endswith("meta"):
            return spec(None, None)
        # stacked blocks carry a leading L dim; python-list blocks do not
        off = 1 if (name.startswith("blocks") and shape and
                    shape[0] == cfg.n_layers and nd >= 2) else 0
        if name.startswith(("enc_blocks", "dec_blocks")):
            off = 1

        def d(i):  # dim index after the optional layer axis
            return shape[off + i]

        rank = nd - off
        pre = [None] * off
        if any(s in name for s in ("/wq", "/wk", "/wv", "/w_gate", "/w_up",
                                   "/w_z", "/w_in", "/w_bc", "/w_dq", "/w_uq",
                                   "/w_uk", "/w_uv", "/w1", "/w_gates")):
            if rank == 2:
                return spec(*pre, _maybe(d(0), axes, dp) if fsdp else None,
                            _maybe(d(1), axes, tp))
            if rank == 3 and ("experts" in name or "/w_gate" in name
                              or "/w_up" in name):
                # (E, d, fe): EP over model, fsdp over d
                return spec(*pre, _maybe(d(0), axes, tp),
                            _maybe(d(1), axes, dp) if fsdp else None, None)
        if any(s in name for s in ("/wo", "/w_down", "/w_out", "/w2")):
            if rank == 2:
                return spec(*pre, _maybe(d(0), axes, tp),
                            _maybe(d(1), axes, dp) if fsdp else None)
            if rank == 3:  # (E, fe, d) expert down-proj
                return spec(*pre, _maybe(d(0), axes, tp), None,
                            _maybe(shape[off + 2], axes, dp) if fsdp
                            else None)
        if "/w_dkv" in name and rank == 2:
            return spec(*pre, _maybe(d(0), axes, dp) if fsdp else None, None)
        if "router" in name:
            return spec()
        # fallback: replicate small leaves; shard last dim over model if big
        if nd >= 1 and shape[-1] >= 4096 and _divisible(shape[-1], axes, tp):
            return spec(*([None] * (nd - 1) + [tp]))
        return spec()

    return {name: rule(name, shape)
            for name, shape in reference_shapes(params).items()}


def batch_pspecs(cfg: ArchConfig, batch_specs, mesh) -> dict[str, tuple]:
    """{path: spec} of the inputs (a mapping of tensors): the batch dim
    over all data axes where it divides, else replicated."""
    axes = _axes(mesh)
    dp = _data_axes(axes)
    out = {}
    for name, leaf in _flat(batch_specs).items():
        shape = _shape(leaf)
        if shape and _divisible(shape[0], axes, dp):
            out[name] = _padded((dp,), len(shape))
        else:
            out[name] = _padded((), len(shape))
    return out


def cache_pspecs(cfg: ArchConfig, cache, mesh, *, batch: int
                 ) -> dict[str, tuple]:
    """{path: spec} of a decode cache.

    batch >= dp: batch over data axes, KV heads over model.
    batch < dp (long_500k): sequence dim over data (SP), heads over model.
    """
    axes = _axes(mesh)
    dp = _data_axes(axes)
    seq_parallel = batch < math.prod(axes[a] for a in dp)

    def rule(name: str, shape: tuple):
        nd = len(shape)
        # transformer stacked cache: (L, B, S, KV, dh) / mla (L, B, S, r);
        # per-layer caches (B, S, KV, dh) / states (B, H, ...)
        off = 1 if (shape and shape[0] == cfg.n_layers and nd >= 3) else 0
        body = list(shape[off:])
        entries: list[Any] = [None] * len(body)
        if len(body) >= 2 and name.split("/")[-1] in ("k", "v", "xk", "xv",
                                                      "c", "kr"):
            seq_axes: list = []
            if not seq_parallel and _divisible(body[0], axes, dp):
                entries[0] = dp
            elif seq_parallel and _divisible(body[1], axes, dp):
                seq_axes.extend(dp)
            if len(body) >= 3 and _divisible(body[2], axes, "model"):
                entries[2] = "model"
            elif _divisible(body[1], axes, tuple(seq_axes) + ("model",)):
                # KV heads don't divide the TP degree: shard the cache
                # sequence over 'model' instead (flash-decoding)
                seq_axes.append("model")
            if seq_axes:
                entries[1] = tuple(seq_axes)
        else:
            # recurrent states (B, H, ...): H over model if divisible
            if not seq_parallel and body and _divisible(body[0], axes, dp):
                entries[0] = dp
            if len(body) >= 2 and _divisible(body[1], axes, "model"):
                entries[1] = "model"
        return tuple([None] * off + entries)

    return {name: rule(name, _shape(leaf))
            for name, leaf in _flat(cache).items()}


def logits_pspec(cfg: ArchConfig, mesh) -> tuple:
    """Logits (B, S, vocab): batch over the data axes, vocab over
    'model'."""
    return (_data_axes(_axes(mesh)), None, "model")


# ---------------------------------------------------------------------------
# what the rank path applies
# ---------------------------------------------------------------------------


def rank_split(params) -> dict[str, int]:
    """{state name: dim} of the parameters that a rank model (built with
    `mesh=`) holds a slice of: each MoE expert bank, split over "model" on
    its expert axis (dim 0 of the per-layer tensor). Every other
    parameter is replicated."""
    out = {}
    for prefix, module in params.named_modules():
        split = getattr(module, "rank_split", None)
        if split:
            for name, dim in split.items():
                out[f"{prefix}.{name}" if prefix else name] = dim
    return out


def local_batch(batch, mesh):
    """This rank's rows of a global batch (a mapping of tensors): the
    batch dim split over the data axes as batch_pspecs says, rows
    [i * B/n, (i + 1) * B/n) at data index i of n; a leaf whose batch
    does not divide stays whole (replicated), as in the rules."""
    dp = mesh.data_axes
    n = mesh.size_of(dp) if dp else 1
    if n == 1:
        return dict(batch)
    i = mesh.index_of(dp)
    out = {}
    for name, leaf in batch.items():
        b = leaf.shape[0] if leaf.dim() else 0
        out[name] = leaf[i * b // n:(i + 1) * b // n] if b and b % n == 0 \
            else leaf
    return out


__all__ = ["batch_pspecs", "cache_pspecs", "local_batch", "logits_pspec",
           "param_pspecs", "rank_split", "reference_shapes"]
