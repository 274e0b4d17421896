"""The collectives of the sort, of the MoE dispatch and of tensor
parallelism across ranks.

Counterparts of the jax.lax collectives that the reference calls under
shard_map (src/repro/core/exoshuffle.py, payload.py, streaming.py,
moe_dispatch.py), and of the ones GSPMD inserts for its
tensor-parallel placements (src/repro/launch/sharding.py):

  all_to_all(tiled=True) -> all_to_all_tiled: one all_to_all_single,
                            over every rank or along one mesh axis
  pmax(flag) > 0         -> any_across: one all_reduce(MAX) of an int32
  all_gather(x, tiled)   -> gather_across: one all_gather over every
                            rank, the parts in rank order (the sort's
                            key samples, so every rank splits alike)
  pmax(x, axis)          -> pmax: one all_reduce(MAX) of a float, no
                            gradient (the vocab-parallel loss's shift)
  axis_index             -> worker_ids: the rank's global worker ids
                            (RankMesh.index_of for a named axis)
  psum(x, axis)          -> psum: one all_reduce(SUM) along an axis
  all_gather / reduce-scatter of the sequence (Megatron-SP)
                         -> all_gather_seq / reduce_scatter_seq
  argmax of vocab-sharded logits
                         -> sharded_argmax: one all_gather of each
                            rank's (max, global index)

Gradients follow Megatron's conventions. A region is either replicated
over the model axis (every rank holds the whole tensor and, backward,
the whole and identical gradient: the loss counts once) or split (each
rank holds its part and its part's gradient):

  psum           partial -> replicated: backward passes the gradient
                 through;
  psum_grad      replicated -> partial work (a column-parallel product):
                 identity forward, backward sums the ranks' parts;
  split_rows     replicated -> this rank's rows: backward all-gathers
                 the slices' gradients;
  gather_rows    rows -> replicated: backward keeps this rank's slice of
                 the (whole, identical) gradient, unsummed;
  all_gather_seq sequence slices -> the whole sequence, into partial
                 work (column-parallel products): backward
                 reduce-scatters, summing the ranks' partial gradients;
  reduce_scatter_seq
                 partial sums -> this rank's sequence slice of the sum:
                 backward all-gathers the slices' gradients;
  all_to_all_tiled
                 its backward is the same exchange (an equal-split
                 all_to_all is its own inverse).

So the two gathers differ in what follows them: after all_gather_seq
each rank's gradient is a partial sum and the reduce-scatter is right;
after gather_rows the work is replicated, and a reduce-scatter there
would multiply the gradient by the axis size.

With `mesh=None` (one process holds all W workers as its batch axis)
each is what the port did before it had ranks: a transpose, `any()` and
`arange`. With a launch/mesh.RankMesh, every rank must call the same
collectives in the same order — the callers keep their branches uniform
by deciding them on values that are already the same on every rank
(any_across's result, the plan, the shapes).

u32 data travels as its int32 bit storage (kernels/u32.py): NCCL and
gloo move it without widening. On "meta" tensors (a dry run of one
rank, launch/mesh.layout_mesh) a collective returns its result's shape
and moves nothing. Each collective on a mesh is logged by
`record_exchanges`.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist


def _logged(mesh, what: str, nbytes: int, on_card: bool, run) -> None:
    """run() the collective, in the mesh's exchange log when it keeps
    one: CUDA events around it on a card, the wall clock on the CPU."""
    log = mesh.exchanges
    if log is None:
        run()
    elif on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        log.append((what, nbytes, start, end))
    else:
        t0 = time.perf_counter()
        run()
        log.append((what, nbytes, t0, time.perf_counter()))


def _exchange(send: torch.Tensor, mesh, group, what: str) -> torch.Tensor:
    """all_to_all_single of equal blocks along dim 0 over `group`."""
    if send.is_meta:
        return torch.empty_like(send)
    recv = torch.empty_like(send)
    _logged(mesh, what, send.numel() * send.element_size(), send.is_cuda,
            lambda: dist.all_to_all_single(recv, send, group=group))
    return recv


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, send, mesh, group, what):
        ctx.args = (mesh, group, what)
        return _exchange(send, mesh, group, what)

    @staticmethod
    def backward(ctx, grad):
        mesh, group, what = ctx.args
        return (_exchange(grad.contiguous(), mesh, group, what + ".grad"),
                None, None, None)


def all_to_all_tiled(x: torch.Tensor, mesh=None, *, what: str = "",
                     axis: str | None = None) -> torch.Tensor:
    """The tiled all_to_all: x (W/G_src, W_dst, ...) blocks, row i = the
    blocks local worker i sends to each of the W workers -> (W/G_dst,
    W_src, ...), row j = the blocks local worker j received from each of
    the W workers. `what` labels the call in the mesh's exchange log.

    With `axis` (a named axis of the mesh, e.g. the MoE's "model"), the
    exchange runs within this rank's subgroup along it, G = its size, and
    x is (n, G * n, ...) for any n (the MoE sends (1, ep, cap, ...)).
    Gradients flow through it (its backward is the same exchange).

    One all_to_all_single carries it: the blocks are viewed as
    (W/G_src, G, W/G_dst, ...), permuted to (G, W/G_src, W/G_dst, ...)
    so that rank d's share is one contiguous slice, exchanged, and the
    received (G_src, W/G_src, W/G_dst, ...) read as (W_src, W/G_dst, ...)
    and transposed to (W/G_dst, W_src, ...).
    """
    if mesh is None:
        return x.transpose(0, 1).contiguous()
    wl = x.shape[0]
    if axis is None:
        g, group = mesh.world, mesh.group
    else:  # a layout-only mesh (a dry run's, on "meta") has no groups
        g = mesh.size_of(axis)
        group = None if x.is_meta else mesh.group_of(axis)
    if (axis is None and wl != mesh.workers_per_rank) or \
            x.shape[1] != g * wl:
        raise ValueError(f"all_to_all_tiled: blocks of shape "
                         f"{tuple(x.shape)} on {mesh}")
    rest = tuple(x.shape[2:])
    send = x.reshape(wl, g, wl, *rest).transpose(0, 1).contiguous()
    if send.requires_grad and torch.is_grad_enabled():
        recv = _Exchange.apply(send, mesh, group, what)
    else:
        recv = _exchange(send, mesh, group, what)
    return recv.reshape(g * wl, wl, *rest).transpose(0, 1).contiguous()


def _all_reduce_sum(x: torch.Tensor, mesh, axis, what: str) -> torch.Tensor:
    out = x.clone()
    if not out.is_meta:
        _logged(mesh, what, out.numel() * out.element_size(), out.is_cuda,
                lambda: dist.all_reduce(out, group=mesh.group_of(axis)))
    return out


def _all_gather_rows(x: torch.Tensor, mesh, axis, what: str) -> torch.Tensor:
    """The slices of every rank along `axis` (of every rank where axis
    is None), concatenated on dim 0 in index order."""
    n = mesh.world if axis is None else mesh.size_of(axis)
    x = x.contiguous()
    if x.is_meta:
        return x.repeat((n,) + (1,) * (x.dim() - 1))
    group = mesh.group if axis is None else mesh.group_of(axis)
    parts = [torch.empty_like(x) for _ in range(n)]
    _logged(mesh, what, x.numel() * x.element_size(), x.is_cuda,
            lambda: dist.all_gather(parts, x, group=group))
    return torch.cat(parts)


def _my_rows(x: torch.Tensor, mesh, axis) -> torch.Tensor:
    n = mesh.size_of(axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks "
                         f"along {axis!r}")
    t = x.shape[0] // n
    i = mesh.index_of(axis)
    return x[i * t:(i + 1) * t]


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, what):
        return _all_reduce_sum(x, mesh, axis, what)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None, None


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, what):
        ctx.args = (mesh, axis, what)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, what = ctx.args
        return (_all_reduce_sum(grad, mesh, axis, what + ".grad"), None, None,
                None)


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, what):
        ctx.args = (mesh, axis, what)
        return _my_rows(x, mesh, axis).clone()

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, what = ctx.args
        return (_all_gather_rows(grad, mesh, axis, what + ".grad"), None,
                None, None)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, what):
        ctx.args = (mesh, axis)
        return _all_gather_rows(x, mesh, axis, what)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis = ctx.args
        return _my_rows(grad, mesh, axis), None, None, None


def _apply(fn, plain, x, mesh, axis, what):
    if x.requires_grad and torch.is_grad_enabled():
        return fn.apply(x, mesh, axis, what)
    return plain(x)


def psum(x: torch.Tensor, mesh, axis: str, *,
         what: str = "psum") -> torch.Tensor:
    """The sum of x over the ranks along `axis` (all_reduce(SUM)); every
    rank gets the same bytes. Backward: the gradient, unchanged."""
    if mesh.size_of(axis) == 1:
        return x
    return _apply(_Psum, lambda t: _all_reduce_sum(t, mesh, axis, what), x,
                  mesh, axis, what)


def psum_grad(x: torch.Tensor, mesh, axis: str, *,
              what: str = "psum") -> torch.Tensor:
    """x itself; backward, the gradient summed over the ranks along
    `axis`: the entry of a replicated tensor into work that each rank
    does for its own part (psum's partner)."""
    if mesh.size_of(axis) == 1 or not (x.requires_grad
                                       and torch.is_grad_enabled()):
        return x
    return _PsumGrad.apply(x, mesh, axis, what)


def split_rows(x: torch.Tensor, mesh, axis: str, *,
               what: str = "gather") -> torch.Tensor:
    """This rank's 1/n of the rows of x, replicated along `axis` (n
    ranks): rows [i * T/n, (i + 1) * T/n) at index i. Backward: the
    slices' gradients all-gathered."""
    if mesh.size_of(axis) == 1:
        return x
    return _apply(_SplitRows, lambda t: _my_rows(t, mesh, axis), x, mesh,
                  axis, what)


def gather_rows(x: torch.Tensor, mesh, axis: str, *,
                what: str = "gather") -> torch.Tensor:
    """Every rank's rows along `axis`, concatenated in index order (the
    inverse of split_rows). Backward: this rank's slice of the
    gradient."""
    if mesh.size_of(axis) == 1:
        return x
    return _apply(_GatherRows, lambda t: _all_gather_rows(t, mesh, axis,
                                                          what),
                  x, mesh, axis, what)


def _moved(fn, x, dim):
    """fn applied along `dim` of x (fn works on dim 0)."""
    return fn(x.movedim(dim, 0)).movedim(0, dim)


def _reduce_scatter_rows(x: torch.Tensor, mesh, axis, what: str
                         ) -> torch.Tensor:
    """Dim 0 of x in n equal blocks (n ranks along `axis`): this rank's
    block of the sum over the ranks, added in index order. One
    all_to_all_single carries the blocks (gloo and NCCL both move it,
    on the CPU and on a card)."""
    n = mesh.size_of(axis)
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split over {n} ranks "
                         f"along {axis!r}")
    x = x.contiguous()
    t = x.shape[0] // n
    if x.is_meta:
        return torch.empty((t,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device="meta")
    recv = torch.empty_like(x)
    _logged(mesh, what, x.numel() * x.element_size(), x.is_cuda,
            lambda: dist.all_to_all_single(recv, x,
                                           group=mesh.group_of(axis)))
    parts = recv.reshape((n, t) + tuple(x.shape[1:]))
    out = parts[0].clone()
    for i in range(1, n):
        out += parts[i]
    return out


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, what, dim):
        ctx.args = (mesh, axis, what, dim)
        return _moved(lambda t: _all_gather_rows(t, mesh, axis, what), x,
                      dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, what, dim = ctx.args
        return (_moved(lambda t: _reduce_scatter_rows(t, mesh, axis,
                                                      what + ".grad"),
                       grad, dim), None, None, None, None)


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, what, dim):
        ctx.args = (mesh, axis, what, dim)
        return _moved(lambda t: _reduce_scatter_rows(t, mesh, axis, what),
                      x, dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, axis, what, dim = ctx.args
        return (_moved(lambda t: _all_gather_rows(t, mesh, axis,
                                                  what + ".grad"),
                       grad, dim), None, None, None, None)


def all_gather_seq(x: torch.Tensor, mesh, axis: str = "model", *,
                   dim: int = 1, what: str = "seq.gather") -> torch.Tensor:
    """Every rank's slice of `dim` along `axis`, concatenated in index
    order (Megatron-SP's all-gather before a column-parallel product).
    Backward: the gradient reduce-scattered along `dim`, each rank's
    slice of the sum of the ranks' partial gradients."""
    if mesh.size_of(axis) == 1:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherSeq.apply(x, mesh, axis, what, dim)
    return _moved(lambda t: _all_gather_rows(t, mesh, axis, what), x, dim)


def reduce_scatter_seq(x: torch.Tensor, mesh, axis: str = "model", *,
                       dim: int = 1, what: str = "seq.scatter"
                       ) -> torch.Tensor:
    """This rank's slice of `dim` (index i of n: [i * S/n, (i + 1) * S/n))
    of x summed over the ranks along `axis` (Megatron-SP's reduce-scatter
    after a row-parallel product). Backward: the slices' gradients
    all-gathered."""
    if mesh.size_of(axis) == 1:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _ScatterSeq.apply(x, mesh, axis, what, dim)
    return _moved(lambda t: _reduce_scatter_rows(t, mesh, axis, what), x,
                  dim)


def pmax(x: torch.Tensor, mesh, axis: str, *,
         what: str = "pmax") -> torch.Tensor:
    """The elementwise max of x over the ranks along `axis`
    (all_reduce(MAX)); every rank gets the same bytes. No gradient (the
    vocab-parallel loss's shift, whose gradient cancels)."""
    out = x.detach().clone()
    if mesh.size_of(axis) > 1 and not out.is_meta:
        _logged(mesh, what, out.numel() * out.element_size(), out.is_cuda,
                lambda: dist.all_reduce(out, op=dist.ReduceOp.MAX,
                                        group=mesh.group_of(axis)))
    return out


def sharded_argmax(x: torch.Tensor, mesh, axis: str = "model", *,
                   what: str = "argmax") -> torch.Tensor:
    """torch.argmax(dim=-1) of the tensor whose last dim is split over the
    ranks along `axis` in index order (rank i holds [i * V/n, (i + 1) *
    V/n)): int64 global indices, the same on every rank. Each rank's
    (max, global index of its first max) is all-gathered as float64
    (exact for float32 values and indices below 2^53); the largest value
    wins, and a tie goes to the lowest index — the first rank holding
    it — as torch.argmax takes the first maximal value."""
    v, i = x.max(dim=-1)
    gi = i + mesh.index_of(axis) * x.shape[-1]
    if mesh.size_of(axis) == 1:
        return gi
    pair = torch.stack([v.double(), gi.double()], dim=-1)
    parts = _all_gather_rows(pair.unsqueeze(0), mesh, axis, what)
    vals = parts[..., 0]
    best = vals.max(dim=0, keepdim=True).values
    win = (vals == best).to(torch.int8).argmax(dim=0, keepdim=True)
    return parts[..., 1].gather(0, win)[0].long()


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


def gather_across(x: torch.Tensor, mesh=None, *,
                  what: str = "gather") -> torch.Tensor:
    """Every rank's x (the same shape on each), concatenated on dim 0 in
    rank order: x itself without a mesh."""
    return x if mesh is None else _all_gather_rows(x, mesh, None, what)


def worker_ids(mesh, num_workers: int, device) -> torch.Tensor:
    """int64 global ids of the workers this process holds: arange(W)
    without a mesh, the rank's [r*W/G, (r+1)*W/G) on one (axis_index)."""
    if mesh is None:
        return torch.arange(num_workers, dtype=torch.int64, device=device)
    lo = mesh.worker_lo
    return torch.arange(lo, lo + mesh.workers_per_rank, dtype=torch.int64,
                        device=device)


__all__ = ["all_gather_seq", "all_to_all_tiled", "any_across",
           "gather_across", "gather_rows", "pmax", "psum", "psum_grad",
           "reduce_scatter_seq", "sharded_argmax", "split_rows",
           "worker_ids"]
