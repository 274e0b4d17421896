"""Rank-side bodies of tests/test_torch_moe_ranks.py.

Each function runs in a process that launch/mesh.spawn_ranks started
(the "spawn" method: a fresh interpreter that imports this module, and
never jax), joins a gloo group on the CPU with named axes ("data",
"model") through the FileStore path it is given, does its part and
returns numpy results to the parent. A body that runs on several mesh
layouts leaves the group and joins a new one (a fresh FileStore path)
for each.
"""
from __future__ import annotations

import os
import time

import torch

EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _mesh(rank, world, store_path, axes, timeout_s=60.0):
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    return make_test_mesh(world, store_path=store_path, rank=rank,
                          world=world, timeout_s=timeout_s, axes=axes)


def _np(t):
    return t.detach().numpy().copy()


def _layouts(rank, world, store_path, layouts):
    """(layout, mesh) for each {"data": D, "model": M} in turn."""
    for n, axes in enumerate(layouts):
        with _mesh(rank, world, f"{store_path}.{n}", axes) as mesh:
            yield (axes["data"], axes["model"]), mesh


# ---------------------------------------------------------------------------
# the grouped collectives and their gradients
# ---------------------------------------------------------------------------


def collectives(mesh, inp):
    """Each collective on this rank's inputs, its output and the gradient
    of sum(output * probe) (probes differ by rank), as numpy."""
    from repro_torch.core import collectives as col

    r = mesh.rank
    out = {"coords": (mesh.index_of("data"), mesh.index_of("model")),
           "sizes": (mesh.size_of("data"), mesh.size_of("model"),
                     mesh.size_of(("data",))),
           "group_sizes": (mesh.group_of("data").size(),
                           mesh.group_of("model").size())}
    mesh.record_exchanges()
    for axis in ("model", "data"):
        x = torch.from_numpy(inp["blocks"][r]).requires_grad_()
        y = col.all_to_all_tiled(x, mesh, what=f"a2a.{axis}", axis=axis)
        (y * torch.from_numpy(inp["probe_blocks"][r])).sum().backward()
        out[f"a2a.{axis}"] = (_np(y), _np(x.grad))
    x = torch.from_numpy(inp["rows"][r]).requires_grad_()
    y = col.psum(x, mesh, "model")
    (y * torch.from_numpy(inp["probe_rows"][r])).sum().backward()
    out["psum"] = (_np(y), _np(x.grad))
    # a replicated (T, d) of the data row, used in part by each rank:
    # split, scaled by (index + 1), gathered; and psum_grad, scaled.
    g = mesh.index_of("data")
    x = torch.from_numpy(inp["row_x"][g]).requires_grad_()
    scale = float(mesh.index_of("model") + 1)
    y = col.gather_rows(col.split_rows(x, mesh, "model") * scale, mesh,
                        "model")
    (y * torch.from_numpy(inp["row_probe"][g])).sum().backward()
    out["split_gather"] = (_np(y), _np(x.grad))
    x = torch.from_numpy(inp["row_x"][g]).requires_grad_()
    y = col.psum_grad(x, mesh, "model") * scale
    (y * torch.from_numpy(inp["row_probe"][g])).sum().backward()
    out["psum_grad"] = (_np(y), _np(x.grad))
    out["log"] = [(e["what"], e["bytes"], e["clock"])
                  for e in mesh.exchange_log()]
    return out


# ---------------------------------------------------------------------------
# the dispatch over ranks, and the MoE block
# ---------------------------------------------------------------------------


def dispatch(mesh, case, inp):
    """The rank's share of one dispatch case: the sort dispatch over the
    ranks (its rows of the (g, j) layout) or the decode dispatch (its
    data row, replicated over "model"), with the gradients of
    sum(out * probe) for the tokens, the router logits and its experts,
    and the sort's routing record."""
    from repro_torch.core import moe_dispatch as md
    from repro_torch.models.moe import expert_fn

    kind, e, k, cf = case
    dp, ep = mesh.size_of("data"), mesh.size_of("model")
    g, j = mesh.index_of("data"), mesh.index_of("model")
    n = inp["x"].shape[0]
    if kind == "sort":
        t = n // (dp * ep)
        rows = slice((g * ep + j) * t, (g * ep + j + 1) * t)
    else:
        rows = slice(g * n // dp, (g + 1) * n // dp)
    el = e // ep
    x = torch.from_numpy(inp["x"][rows]).requires_grad_()
    logits = torch.from_numpy(inp["logits"][rows]).requires_grad_()
    prm = {n_: torch.from_numpy(inp[n_][j * el:(j + 1) * el])
           .requires_grad_() for n_ in EXPERT_KEYS}
    w, ids = md.route_topk(logits, k)
    dcfg = md.MoeDispatchConfig(e, k, cf)
    routing = {}
    if kind == "sort":
        out = md.sort_dispatch_ranks(x, w, ids, prm, cfg=dcfg,
                                     expert_fn=expert_fn, mesh=mesh,
                                     routing=routing)
    else:
        out = md.ep_replicated_ranks(x, w, ids, prm, cfg=dcfg,
                                     expert_fn=expert_fn, mesh=mesh)
    (out * torch.from_numpy(inp["probe"][rows])).sum().backward()
    return {"out": _np(out), "x": _np(x.grad), "logits": _np(logits.grad),
            "ids": _np(ids),
            "experts": {n_: _np(p.grad) for n_, p in prm.items()},
            "routing": {key: (v if isinstance(v, int) else _np(v))
                        for key, v in routing.items()}}


def ffn(mesh, cfg, state, x, probe):
    """models/moe.MoeFFN on the rank: built on the mesh (its experts
    only), loaded with the rank's slice of `state`, run on its data row
    of x; the output and the gradients of sum(out * probe)."""
    from repro_torch.models import layers
    from repro_torch.models.moe import MoeFFN

    dp = mesh.size_of("data")
    g = mesh.index_of("data")
    block = MoeFFN(cfg, None, dtype=torch.float32, requires_grad=True,
                   mesh=mesh)
    # the rank's experts, and its slice of the shared experts' width
    mine = layers.placed({n: torch.from_numpy(a) for n, a in state.items()},
                         block.placement, "", mesh)
    block.load_state_dict(mine, strict=True, assign=True)
    block.requires_grad_(True)
    b = x.shape[0] // dp
    xl = torch.from_numpy(x[g * b:(g + 1) * b]).requires_grad_()
    out = block(xl)
    (out * torch.from_numpy(probe[g * b:(g + 1) * b])).sum().backward()
    return {"out": _np(out), "x": _np(xl.grad),
            "grads": {n: _np(p.grad) for n, p in block.named_parameters()},
            "placement": dict(block.placement)}


def moe_cases(rank, world, store_path, layouts, dispatch_cases, ffn_cases):
    """Every dispatch and MoE block case on each mesh layout in turn:
    {layout: {"dispatch": {name: ...}, "ffn": {name: ...}}}."""
    out = {}
    for layout, mesh in _layouts(rank, world, store_path, layouts):
        out[layout] = {
            "dispatch": {name: dispatch(mesh, case, inp)
                         for name, (case, inp) in dispatch_cases.items()},
            "ffn": {name: ffn(mesh, cfg, state, x, probe)
                    for name, (cfg, state, x, probe) in ffn_cases.items()}}
    return out


def four(rank, world, store_path, coll_inp, layouts, dispatch_cases,
         ffn_cases, train_args):
    """The 4-rank work of the test module in one spawn: the collectives
    on data 2 x model 2, the MoE cases on each layout, then two train
    steps and a checkpoint on data 2 x model 2."""
    with _mesh(rank, world, store_path + ".c", {"data": 2, "model": 2}) \
            as mesh:
        coll = collectives(mesh, coll_inp)
    moe = moe_cases(rank, world, store_path, layouts, dispatch_cases,
                    ffn_cases)
    with _mesh(rank, world, store_path + ".t", {"data": 2, "model": 2}) \
            as mesh:
        train = train_steps(mesh, *train_args)
    return {"collectives": coll, "moe": moe, "train": train}


# ---------------------------------------------------------------------------
# training over the ranks, and a rank checkpoint
# ---------------------------------------------------------------------------


def train_steps(mesh, cfg, tree, batches, ckpt_dir):
    """The reduced model on the rank from the reference's weights
    (params_from_reference(..., mesh=)), a train step on each global
    batch, then a checkpoint written by the ranks and read back. Returns
    the weights as loaded, each step's metrics, the weights after the
    steps and whether the reloaded state equals the saved one."""
    from repro_torch.launch.sharding import rank_split
    from repro_torch.models import api as mapi
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (TrainConfig,
                                              abstract_train_state,
                                              make_train_step,
                                              train_state_of)

    model = mapi.build(cfg, mesh=mesh)
    params = model.params_from_reference(tree, device="cpu", trainable=True)
    loaded = {n: _np(p) for n, p in params.named_parameters()}
    tcfg = TrainConfig(opt=OptConfig(warmup_steps=1, total_steps=4))
    state = train_state_of(params, tcfg)
    step = make_train_step(model, tcfg, mesh=mesh)
    metrics = []
    for batch in batches:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    after = {n: _np(p) for n, p in state["params"].named_parameters()}
    ckpt.save(state, ckpt_dir, len(batches), mesh=mesh)
    back, at = ckpt.load(abstract_train_state(model, tcfg), ckpt_dir,
                         device="cpu", mesh=mesh)
    same = at == len(batches) and all(
        torch.equal(p, dict(back["params"].named_parameters())[n])
        and torch.equal(state["opt"][m][n], back["opt"][m][n])
        for n, p in state["params"].named_parameters() for m in ("mu", "nu"))
    return {"loaded": loaded, "metrics": metrics, "after": after,
            "reloaded_equal": bool(same), "split": rank_split(params)}


# ---------------------------------------------------------------------------
# a rank that dies mid-dispatch
# ---------------------------------------------------------------------------


def dead_in_dispatch(rank, world, store_path, result_dir, timeout_s, inp):
    """Rank 1 dies inside the sort dispatch, after its first exchange;
    rank 0 writes what its dispatch did (the exception and how long it
    took) to `result_dir`. Run in plain spawned processes, not
    spawn_ranks: that would stop rank 0 as soon as rank 1 exits."""
    from repro_torch.core import moe_dispatch as md
    from repro_torch.models.moe import expert_fn

    mesh = _mesh(rank, world, store_path, {"data": 1, "model": 2},
                 timeout_s=timeout_s)
    if rank == 1:
        exchange = md.all_to_all_tiled
        calls = []

        def dying(*args, **kwargs):
            calls.append(1)
            if len(calls) > 1:
                os._exit(3)
            return exchange(*args, **kwargs)

        md.all_to_all_tiled = dying
    t = inp["x"].shape[0] // 2
    rows = slice(rank * t, (rank + 1) * t)
    w, ids = md.route_topk(torch.from_numpy(inp["logits"][rows]), 2)
    prm = {n: torch.from_numpy(inp[n][rank * 8:(rank + 1) * 8])
           for n in EXPERT_KEYS}
    t0 = time.perf_counter()
    try:
        md.sort_dispatch_ranks(torch.from_numpy(inp["x"][rows]), w, ids, prm,
                               cfg=md.MoeDispatchConfig(16, 2),
                               expert_fn=expert_fn, mesh=mesh)
        err = None
    except Exception as e:  # the point: the exchange must raise
        err = f"{type(e).__name__}: {e}"
    with open(os.path.join(result_dir, f"rank{rank}.txt"), "w") as f:
        f.write(f"{time.perf_counter() - t0}\n{err}\n")
    os._exit(0)  # the group cannot be left cleanly with a dead peer
