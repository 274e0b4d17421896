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
config's dtype (the cast at use then changes nothing). The reference's
`constrain_*` helpers only annotate a mesh sharding and have no twin.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.nn.functional as F
from torch import nn


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


def embed(params, tokens, dtype):
    return params["table"].to(dtype)[tokens]


def unembed(params, x):
    """Tied-transpose readout -> (..., vocab) in float32."""
    return x.float() @ params["table"].float().T


def swiglu_init(d_model: int, d_ff: int, generator: torch.Generator,
                dtype=torch.float32):
    return {
        "w_gate": uniform_init((d_model, d_ff), generator, dtype=dtype),
        "w_up": uniform_init((d_model, d_ff), generator, dtype=dtype),
        "w_down": uniform_init((d_ff, d_model), generator, dtype=dtype),
    }


def swiglu(params, x):
    dt = x.dtype
    g = x @ params["w_gate"].to(dt)
    u = x @ params["w_up"].to(dt)
    return (F.silu(g) * u) @ params["w_down"].to(dt)


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


def qkv_project(params, x, n_heads, n_kv_heads, head_dim):
    dt = x.dtype
    b, s, _ = x.shape
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    return (
        q.reshape(b, s, n_heads, head_dim),
        k.reshape(b, s, n_kv_heads, head_dim),
        v.reshape(b, s, n_kv_heads, head_dim),
    )


def out_project(params, attn_out):
    dt = attn_out.dtype
    b, s, h, dh = attn_out.shape
    return attn_out.reshape(b, s, h * dh) @ params["wo"].to(dt)
