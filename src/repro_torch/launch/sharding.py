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

The rank path (launch/mesh.RankMesh) executes the rules' "model" entries
and their batch answer (`local_batch`: the batch over the data axes).
`split_dims` reads, from `param_pspecs` on the one-process shapes, the
dim of each tensor that a spec puts over "model", mapped to the port's
state names through models/naming; a model built on a rank keeps its
1/tp slice of each along that dim (`rank_split` names them), and
params_from_reference, checkpoint.save/load and the optimizer's norm
read the same answer. Which tensors that is:

  - the transformer family's `attn_sharding="heads"` configs: every
    projection, FFN and shared-expert weight, the tied embedding's vocab
    and (MoE) the expert banks' expert axis (TP and EP);
  - any other MoE config: its expert banks (EP); every other config:
    nothing, it is replicated on a rank.

Not executed, and recorded in ROADMAP.md §1: the data-axis entries
(FSDP, `param_sharding="fsdp"`: every split tensor stays whole along
its other dim), the norm scales that the fallback rule puts over
"model" by their size alone (a d-vector each: a rank keeps it whole, as
gathering it at every use would cost a collective a norm), the
sequence-parallel caches of batch < dp, and the KV-heads-below-tp case
(`cache_pspecs`' sequence over "model"), which raises. These are
deviations in layout only, never in numerics: a replicated tensor
computes what its shards would.
"""
from __future__ import annotations

import functools
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


def _has(entry, axis: str) -> bool:
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def _model_dims(cfg: ArchConfig, shapes, mesh, stacked=STACKED
                ) -> dict[str, int]:
    """{port state name: dim} of every tensor whose spec puts "model" on
    one of its dims (`shapes`: {port name: one-process shape}; `stacked`:
    the prefixes the reference stacks, a model's `.stacked`); a stacked
    leaf's layer axis is not counted, so the dim is the per-layer
    tensor's. The data-axis entries are dropped."""
    specs = param_pspecs(cfg, shapes, mesh)
    out = {}
    for key, names in layer_groups(shapes, stacked).items():
        spec = specs[key.replace(".", "/")]
        if names[0] != key:  # stacked: the spec's first entry is the layers'
            spec = spec[1:]
        dims = [i for i, e in enumerate(spec) if _has(e, "model")]
        for name in names:
            if dims:
                out[name] = dims[0]
    return out


def is_tensor_parallel(cfg: ArchConfig) -> bool:
    """The configs whose attention, FFN and vocab the rank path splits:
    the dense and MoE families' `attn_sharding="heads"` configs."""
    return cfg.family in ("dense", "moe") and cfg.attn_sharding == "heads"


def _executed(cfg: ArchConfig, name: str) -> bool:
    """Whether the rank path executes the rules' "model" entry of `name`
    (see the module docstring): an MoE's expert banks, and under tensor
    parallelism everything but the norm scales."""
    *_, parent, key = name.split(".")
    if cfg.is_moe and parent == "ffn" and key in ("w_gate", "w_up",
                                                  "w_down"):
        return True
    return is_tensor_parallel(cfg) and key != "scale"


@functools.lru_cache(maxsize=None)
def _split_dims(cfg: ArchConfig, axes: tuple) -> dict[str, int]:
    from repro_torch.models.api import new_model  # models import this module

    axes = dict(axes)
    if axes.get("model", 1) == 1 or not (is_tensor_parallel(cfg)
                                         or cfg.is_moe):
        return {}
    model = new_model(cfg, None)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return {name: dim for name, dim in
            _model_dims(cfg, shapes, axes, model.stacked).items()
            if _executed(cfg, name)}


def split_dims(cfg: ArchConfig, mesh) -> dict[str, int]:
    """{state name: dim} of the tensors a model of `cfg` built on a rank
    of `mesh` holds 1/tp of (tp = the "model" axis's size), along that
    dim: `param_pspecs`' "model" entries on the one-process shapes,
    those the rank path executes (module docstring). Empty without a
    "model" axis of size > 1."""
    return dict(_split_dims(cfg, tuple(_axes(mesh).items())))


def split_of(cfg: ArchConfig, mesh, prefix: str) -> dict[str, int]:
    """split_dims of the tensors under `prefix` (e.g. "blocks.0.ffn."),
    named relative to it: what one layer's module splits."""
    if mesh is None:
        return {}
    return {n[len(prefix):]: d for n, d in split_dims(cfg, mesh).items()
            if n.startswith(prefix)}


def rank_split(params) -> dict[str, int]:
    """{state name: dim} of the parameters that a rank model (built with
    `mesh=`) holds its slice of: the model's `placement`, which is
    split_dims of its config and mesh. Every other parameter is
    replicated. Empty for a one-process model."""
    return dict(getattr(params, "placement", None) or {})


def local_shape(shape, spec, mesh) -> tuple:
    """A rank's part of a tensor of `shape` placed by `spec` (a spec of
    this module: cache_pspecs' for a decode cache, logits_pspec's for
    the logits): each dim divided by the product of its axes' sizes."""
    axes = _axes(mesh)
    out = []
    for dim, entry in zip(shape, _padded(spec, len(shape))):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n = math.prod(axes[a] for a in names)
        if dim % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {names}")
        out.append(dim // n)
    return tuple(out)


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


__all__ = ["batch_pspecs", "cache_pspecs", "is_tensor_parallel",
           "local_batch", "local_shape", "logits_pspec", "param_pspecs",
           "rank_split", "reference_shapes", "split_dims", "split_of"]
