"""Common neural layers: plain functions on tensors.

Twin of src/repro/models/layers.py. A layer takes its parameters as a
mapping of tensors (a module's `nn.ParameterDict`) and its input; init
functions take an explicit `torch.Generator` and allocate on that
generator's device (given None, they allocate shapes only, on "meta").

Numerics as in the reference: a layer casts its weights to the
activation's dtype at use; RMSNorm and RoPE compute in float32 and cast
back; the tied readout is float32. A training model keeps float32
"master" parameters, as the reference does, and the cast at use carries
the gradient back to them in float32; a serving model holds them in the
config's dtype (the cast at use then changes nothing).

Tensor parallelism (Megatron's, over the "model" axis of a
launch/mesh.RankMesh; `mesh=` on the layers below, None for one
process): `qkv_project` and `swiglu`'s gate and up are column-parallel
(a rank holds its heads' or its d_ff slice's columns), `out_project`
and `swiglu`'s w_down row-parallel (its rows; the rank's product is a
partial sum, summed over the ranks), `embed` and `unembed` are
vocab-parallel (a rank holds its rows of the table). With `sp=False`
the activations around them are replicated over "model": psum_grad
enters a column-parallel product and psum leaves a row-parallel one.
With `sp=True` they are split over the sequence (Megatron-SP):
all_gather_seq enters and reduce_scatter_seq leaves. The reference's
`constrain_*` helpers annotate those layouts for GSPMD; their twins
here return the layout (a spec of launch/sharding) that a rank's block
holds under the reference's own conditions, and the blocks decide on
it.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.collectives import (all_gather_seq, psum, psum_grad,
                                          reduce_scatter_seq)


def _batch_entry(b: int, mesh):
    """The data axes if a batch of b divides over them, else None."""
    dp = mesh.data_axes
    return dp if dp and b % mesh.size_of(dp) == 0 else None


def _model_entry(dim: int, mesh):
    return "model" if "model" in mesh.axes and \
        dim % mesh.size_of("model") == 0 else None


def constrain_acts(shape, mesh, *, seq_axis: int = 1):
    """The layout of block-boundary activations (B, S, d) of the global
    `shape` (twin of the reference's constrain_acts): the batch over the
    data axes when it divides, the sequence over "model" when S % tp ==
    0 (sequence parallelism), as a spec tuple; None without a mesh."""
    if mesh is None:
        return None
    entries = [None] * len(shape)
    entries[0] = _batch_entry(shape[0], mesh)
    entries[seq_axis] = _model_entry(shape[seq_axis], mesh)
    return tuple(entries)


def constrain_heads(shape, mesh):
    """The head-parallel layout of attention tensors (B, S, H, dh): the
    batch over the data axes, the heads over "model" when they divide,
    the sequence whole (twin of the reference's constrain_heads)."""
    if mesh is None:
        return None
    entries = [None] * len(shape)
    entries[0] = _batch_entry(shape[0], mesh)
    entries[2] = _model_entry(shape[2], mesh)
    return tuple(entries)


def constrain_seq(shape, mesh, *, seq_axis: int = 1):
    """The `attn_sharding="qfull"` layout of (B, S, H, dh): the batch over
    the data axes, the sequence over "model", heads whole (twin of the
    reference's constrain_seq). The rank path runs those configs
    replicated (launch/sharding)."""
    return constrain_acts(shape, mesh, seq_axis=seq_axis)


def _cut(t: torch.Tensor, dim: int, mesh, name: str) -> torch.Tensor:
    """This rank's contiguous 1/tp of t along `dim` (index i of tp:
    [i * D/tp, (i + 1) * D/tp)), as a tensor of its own."""
    n = mesh.size_of("model")
    if t.shape[dim] % n:
        raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does not "
                         f"split over {n} ranks of 'model'")
    k = t.shape[dim] // n
    return t.narrow(dim, mesh.index_of("model") * k, k).clone()


def constrain_tree(tree: Mapping, specs: Mapping, mesh) -> dict:
    """Each tensor of `tree` cut to this rank's part under its spec in
    `specs` ({name: spec}, a tensor without a spec whole): the twin of
    the reference's constrain_tree, which pins a layer's parameters to
    their specs. Only "model" entries are cut (the data axes' FSDP is
    not executed)."""
    if mesh is None:
        return dict(tree)
    out = {}
    for name, t in tree.items():
        dims = [i for i, e in enumerate(specs.get(name) or ())
                if e == "model" or (isinstance(e, tuple) and "model" in e)]
        out[name] = _cut(t, dims[0], mesh, name) if dims else t
    return out


def placed(tensors: Mapping, split: Mapping, prefix: str, mesh) -> dict:
    """`tensors` ({key: tensor}, drawn whole) with each one that `split`
    ({prefix + key: dim}, launch/sharding.split_of) names cut to this
    rank's part along its dim."""
    return {k: _cut(t, split[prefix + k], mesh, k) if prefix + k in split
            else t for k, t in tensors.items()}


def enter_parallel(x, mesh, sp: bool):
    """The input of a column-parallel product: x itself (psum_grad) when
    the activations are replicated, the whole sequence gathered when
    they are sequence-split (all_gather_seq); x unchanged without a
    mesh."""
    if mesh is None:
        return x
    if sp:
        return all_gather_seq(x, mesh, "model", what="tp.gather")
    return psum_grad(x, mesh, "model", what="tp.psum")


def leave_parallel(x, mesh, sp: bool):
    """The output of a row-parallel product (a partial sum): summed over
    "model" (psum), or reduce-scattered to the rank's sequence slice
    under sp; x unchanged without a mesh."""
    if mesh is None:
        return x
    if sp:
        return reduce_scatter_seq(x, mesh, "model", what="tp.scatter")
    return psum(x, mesh, "model", what="tp.psum")


class Params(nn.Module):
    """A nested mapping of tensors held as a module: a parameter at each
    leaf, a sub-module for each inner mapping, so that the state dict
    names are the mapping's paths joined with dots (the reference's
    pytree paths). `p[key]` reads a leaf or an inner mapping."""

    def __init__(self, tree: Mapping, requires_grad: bool = False):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(key, Params(value, requires_grad))
            else:
                self.register_parameter(key, nn.Parameter(
                    value, requires_grad=requires_grad))

    def __getitem__(self, key: str):
        return getattr(self, key)


def _device(generator: torch.Generator | None):
    """The generator's device; without one, "meta" (shapes only, for
    weights that are loaded afterwards)."""
    return generator.device if generator is not None else "meta"


def _empty(shape, generator: torch.Generator | None, dtype):
    return torch.empty(shape, dtype=dtype, device=_device(generator))


def uniform_init(shape, generator: torch.Generator, scale=None,
                 dtype=torch.float32):
    fan_in = shape[0] if len(shape) > 1 else 1
    scale = scale if scale is not None else fan_in**-0.5
    return _empty(shape, generator, dtype).uniform_(-scale, scale,
                                                    generator=generator)


def rmsnorm_init(dim, generator: torch.Generator, dtype=torch.float32):
    return {"scale": torch.ones((dim,), dtype=dtype,
                                device=_device(generator))}


def rmsnorm(params, x, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor):
    """positions (...,) int -> (cos, sin) of shape (..., head_dim//2)."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=positions.device), exponent)
    angles = positions.float()[..., None] * freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (..., seq, heads, head_dim); cos/sin (..., seq, head_dim//2)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def embedding_init(vocab: int, dim: int, generator: torch.Generator,
                   dtype=torch.float32):
    return {"table": _empty((vocab, dim), generator, dtype).normal_(
        0.0, 0.02, generator=generator)}


def embed(params, tokens, dtype, *, mesh=None, sp: bool = False):
    """The table's rows of `tokens`. Vocab-parallel on a rank of `mesh`
    (the table holds rows [i * V/tp, (i + 1) * V/tp) at index i): ids
    outside the rank's rows look up zeros and the ranks' lookups are
    summed (psum; reduce_scatter_seq to the rank's sequence slice under
    sp): each row comes from exactly one rank, so the sum is exact."""
    table = params["table"].to(dtype)
    if mesh is None:
        return table[tokens]
    rows = table.shape[0]
    local = tokens - mesh.index_of("model") * rows
    inside = (local >= 0) & (local < rows)
    out = torch.where(inside[..., None], table[local.clamp(0, rows - 1)],
                      torch.zeros((), dtype=dtype, device=table.device))
    return leave_parallel(out, mesh, sp)


def unembed(params, x, *, mesh=None, sp: bool = False):
    """Tied-transpose readout -> (..., vocab) in float32; on a rank of
    `mesh`, the rank's vocab slice (launch/sharding.logits_pspec), from
    the whole sequence under sp."""
    x = enter_parallel(x, mesh, sp)
    return x.float() @ params["table"].float().T


def swiglu_init(d_model: int, d_ff: int, generator: torch.Generator,
                dtype=torch.float32):
    return {
        "w_gate": uniform_init((d_model, d_ff), generator, dtype=dtype),
        "w_up": uniform_init((d_model, d_ff), generator, dtype=dtype),
        "w_down": uniform_init((d_ff, d_model), generator, dtype=dtype),
    }


def swiglu(params, x, *, mesh=None, sp: bool = False, reduce: bool = True):
    """SwiGLU FFN. On a rank of `mesh`: w_gate and w_up column-parallel,
    w_down row-parallel; `reduce=False` returns the rank's partial sum
    (the caller sums it with others in one psum)."""
    dt = x.dtype
    x = enter_parallel(x, mesh, sp)
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    out = (F.silu(g) * u) @ params["w_down"].to(dt)
    return leave_parallel(out, mesh, sp) if reduce else out


def gqa_proj_init(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
                  generator: torch.Generator, dtype=torch.float32):
    return {
        "wq": uniform_init((d_model, n_heads * head_dim), generator,
                           dtype=dtype),
        "wk": uniform_init((d_model, n_kv_heads * head_dim), generator,
                           dtype=dtype),
        "wv": uniform_init((d_model, n_kv_heads * head_dim), generator,
                           dtype=dtype),
        "wo": uniform_init((n_heads * head_dim, d_model), generator,
                           dtype=dtype),
    }


def qkv_project(params, x, n_heads, n_kv_heads, head_dim, *, mesh=None,
                sp: bool = False):
    """(q, k, v) of (B, S, heads, head_dim). On a rank of `mesh` the
    projections are column-parallel: n_heads and n_kv_heads are the
    rank's (its contiguous query heads and the KV heads they use), and
    under sp the sequence is gathered first."""
    dt = x.dtype
    x = enter_parallel(x, mesh, sp)
    b, s, _ = x.shape
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    return (
        q.reshape(b, s, n_heads, head_dim),
        k.reshape(b, s, n_kv_heads, head_dim),
        v.reshape(b, s, n_kv_heads, head_dim),
    )


def out_project(params, attn_out, *, mesh=None, sp: bool = False):
    """The output projection; row-parallel on a rank of `mesh` (its
    heads' rows), the partial sums summed over "model" (or
    reduce-scattered over the sequence under sp)."""
    dt = attn_out.dtype
    b, s, h, dh = attn_out.shape
    out = attn_out.reshape(b, s, h * dh) @ params["wo"].to(dt)
    return leave_parallel(out, mesh, sp)
