"""The collectives of the sort across ranks.

Counterparts of the jax.lax collectives that the reference calls under
shard_map (src/repro/core/exoshuffle.py, payload.py, streaming.py):

  all_to_all(tiled=True) -> all_to_all_tiled: one all_to_all_single
  pmax(flag) > 0         -> any_across: one all_reduce(MAX) of an int32
  axis_index             -> worker_ids: the rank's global worker ids

With `mesh=None` (one process holds all W workers as its batch axis)
each is what the port did before it had ranks: a transpose, `any()` and
`arange`. With a launch/mesh.RankMesh, every rank must call the same
collectives in the same order — the callers keep their branches uniform
by deciding them on values that are already the same on every rank
(any_across's result, the plan, the shapes).

u32 data travels as its int32 bit storage (kernels/u32.py): NCCL and
gloo move it without widening.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist


def all_to_all_tiled(x: torch.Tensor, mesh=None, *,
                     what: str = "") -> torch.Tensor:
    """The tiled all_to_all: x (W/G_src, W_dst, ...) blocks, row i = the
    blocks local worker i sends to each of the W workers -> (W/G_dst,
    W_src, ...), row j = the blocks local worker j received from each of
    the W workers. `what` labels the call in the mesh's exchange log.

    One all_to_all_single carries it: the blocks are viewed as
    (W/G_src, G, W/G_dst, ...), permuted to (G, W/G_src, W/G_dst, ...)
    so that rank d's share is one contiguous slice, exchanged, and the
    received (G_src, W/G_src, W/G_dst, ...) read as (W_src, W/G_dst, ...)
    and transposed to (W/G_dst, W_src, ...).
    """
    if mesh is None:
        return x.transpose(0, 1).contiguous()
    wl, g = x.shape[0], mesh.world
    if wl != mesh.workers_per_rank or x.shape[1] != g * wl:
        raise ValueError(f"all_to_all_tiled: blocks of shape "
                         f"{tuple(x.shape)} on {mesh}")
    rest = tuple(x.shape[2:])
    send = x.reshape(wl, g, wl, *rest).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    log = mesh.exchanges
    if log is None:
        dist.all_to_all_single(recv, send, group=mesh.group)
    elif send.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_to_all_single(recv, send, group=mesh.group)
        end.record()
        log.append((what, send.numel() * send.element_size(), start, end))
    else:
        t0 = time.perf_counter()
        dist.all_to_all_single(recv, send, group=mesh.group)
        log.append((what, send.numel() * send.element_size(), t0,
                    time.perf_counter()))
    return recv.reshape(g * wl, wl, *rest).transpose(0, 1).contiguous()


def any_across(flag, mesh=None) -> bool:
    """True if `flag` (a bool tensor of any shape, or a bool) is set
    anywhere on any rank: the reference's pmax(flag) > 0. On a mesh the
    reduce runs before the flag becomes a Python bool, so every rank
    returns the same value and takes the same branch after it."""
    if mesh is None:
        return bool(torch.as_tensor(flag).any())
    f = torch.as_tensor(flag, device=mesh.device).any().to(torch.int32)
    f = f.reshape(1)
    dist.all_reduce(f, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(f.item())


def worker_ids(mesh, num_workers: int, device) -> torch.Tensor:
    """int64 global ids of the workers this process holds: arange(W)
    without a mesh, the rank's [r*W/G, (r+1)*W/G) on one (axis_index)."""
    if mesh is None:
        return torch.arange(num_workers, dtype=torch.int64, device=device)
    lo = mesh.worker_lo
    return torch.arange(lo, lo + mesh.workers_per_rank, dtype=torch.int64,
                        device=device)


__all__ = ["all_to_all_tiled", "any_across", "worker_ids"]
