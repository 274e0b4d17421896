"""Rank-side bodies of tests/test_torch_tp.py and test_torch_tp_train.py.

Each function runs in a process that launch/mesh.spawn_ranks started
(the "spawn" method: a fresh interpreter that imports this module, and
never jax), joins a gloo group on the CPU with named axes ("data",
"model") through the FileStore path it is given, does its part and
returns numpy results to the parent. A body that runs on several mesh
layouts leaves the group and joins a new one (a fresh FileStore path)
for each.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from moe_ranks import _mesh, _np


def _layouts(rank, world, store_path, layouts):
    """(layout, mesh) for each {"data": D, "model": M} in turn."""
    for n, axes in enumerate(layouts):
        with _mesh(rank, world, f"{store_path}.{n}", axes) as mesh:
            yield (axes["data"], axes["model"]), mesh


def _rows(x, mesh):
    """This rank's data row of a global batch array (as local_batch)."""
    from repro_torch.launch.sharding import local_batch

    return local_batch({"x": torch.from_numpy(x)}, mesh)["x"]


def _vocab(logits, mesh):
    """The whole vocab of a rank's logits slice, gathered over "model"."""
    from repro_torch.core.collectives import all_gather_seq

    return _np(all_gather_seq(logits, mesh, "model", dim=-1))


def _digest(model, split):
    """sha256 of every replicated parameter: equal on every rank."""
    return {n: hashlib.sha256(p.detach().numpy().tobytes()).hexdigest()
            for n, p in model.named_parameters() if n not in split}


# ---------------------------------------------------------------------------
# serving: prefill, decode and greedy tokens on a TP rank
# ---------------------------------------------------------------------------


def serve(mesh, cfg, tree, prompts, feed, new):
    """The model on the rank from the reference's weights: the prefill's
    last logits, the logits of decode steps fed `feed` (B, n) tokens,
    and `new` greedy tokens of generate, each for the rank's data row,
    the logits gathered over the vocab; whether the replicated
    parameters and the tokens are the same on every rank."""
    from repro_torch.launch.sharding import rank_split
    from repro_torch.models import api as mapi
    from repro_torch.serve.engine import ServeConfig, generate

    model = mapi.build(cfg, mesh=mesh)
    params = model.params_from_reference(tree, device="cpu")
    split = rank_split(params)
    batch = {"tokens": _rows(prompts, mesh)}
    fed = _rows(feed, mesh)
    s = prompts.shape[1]
    logits, cache = model.prefill(params, batch, max_len=s + fed.shape[1])
    out = {"prefill": _vocab(logits, mesh), "decode": []}
    for t in range(fed.shape[1]):
        lg, cache = model.decode_step(params, cache, fed[:, t:t + 1], s + t)
        out["decode"].append(_vocab(lg, mesh))
    out["cache_shape"] = tuple(cache["k"].shape)
    gen, _ = generate(model, params, batch, ServeConfig(max_new_tokens=new))
    out["tokens"] = _np(gen)
    drawn, _ = generate(model, params, batch,
                        ServeConfig(max_new_tokens=new, temperature=1.0),
                        generator=torch.Generator().manual_seed(5))
    out["sampled"] = _np(drawn)
    every = mesh.all_gather_object((_digest(params, split), out["tokens"]))
    out["replicas_identical"] = all(
        d == every[0][0] for d, _ in every)
    out["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in params.parameters())
    out["split"] = split
    return out


def serve_cases(rank, world, store_path, layouts, cases):
    """Every serving case on each layout: {layout: {name: serve(...)}}."""
    return {layout: {name: serve(mesh, *case) for name, case in
                     cases[layout].items()}
            for layout, mesh in _layouts(rank, world, store_path, layouts)}


# ---------------------------------------------------------------------------
# the vocab-parallel loss and the sharded pick
# ---------------------------------------------------------------------------


def loss_and_pick(mesh, inp):
    """The rank's vocab slice of `inp`'s logits through the vocab-parallel
    ce_loss (value and the slice's gradient) and through sharded_argmax
    (planted ties)."""
    from repro_torch.core.collectives import sharded_argmax
    from repro_torch.models.api import ce_loss

    n, j = mesh.size_of("model"), mesh.index_of("model")
    v = inp["logits"].shape[-1] // n
    lg = torch.from_numpy(inp["logits"][..., j * v:(j + 1) * v].copy())
    lg.requires_grad_()
    loss = ce_loss(lg, torch.from_numpy(inp["labels"]), mesh=mesh)
    loss.backward()
    tied = torch.from_numpy(inp["tied"][..., j * v:(j + 1) * v].copy())
    return {"loss": float(loss), "grad": _np(lg.grad),
            "pick": _np(sharded_argmax(tied, mesh, "model"))}


# ---------------------------------------------------------------------------
# training: one step with sequence parallelism, and a TP checkpoint
# ---------------------------------------------------------------------------


def train(mesh, cfg, tree, batch, ckpt_dir):
    """The reduced model on the rank from the reference's weights: the
    loss and the gradients of the global batch (the train step's own
    reductions), then one train step (metrics, parameters), a checkpoint
    written by the ranks, and the replicated parameters' digests."""
    from repro_torch.launch.sharding import local_batch, rank_split
    from repro_torch.models import api as mapi
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (TrainConfig, _data_mean,
                                              _model_sum, make_train_step,
                                              train_state_of)

    model = mapi.build(cfg, mesh=mesh)
    params = model.params_from_reference(tree, device="cpu", trainable=True)
    split = rank_split(params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = model.loss(params, local_batch(tb, mesh))
    loss.backward()
    named = dict(params.named_parameters())
    grads = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
             for n, p in named.items()}
    with torch.no_grad():
        _model_sum([grads[n] for n in params.sp_partial(
            batch["tokens"].shape[1])], mesh)
        loss = loss.detach()
        _data_mean([loss, *grads.values()], mesh)
    for p in named.values():
        p.grad = None
    tcfg = TrainConfig(opt=OptConfig(peak_lr=1e-4, warmup_steps=1,
                                     total_steps=4))
    state = train_state_of(params, tcfg)
    state, m = make_train_step(model, tcfg, mesh=mesh)(state, tb)
    ckpt.save(state, ckpt_dir, 1, mesh=mesh)
    every = mesh.all_gather_object(_digest(state["params"], split))
    return {"loss": float(loss), "grads": {n: _np(g) for n, g in
                                           grads.items()},
            "metrics": {k: float(v) for k, v in m.items()},
            "after": {n: _np(p) for n, p in
                      state["params"].named_parameters()},
            "split": split, "sp": params.seq_parallel(
                batch["tokens"].shape[1]),
            "replicas_identical": all(e == every[0] for e in every)}


# ---------------------------------------------------------------------------
# the MoE block under TP and EP: routing
# ---------------------------------------------------------------------------


def moe_block(mesh, cfg, state, x, probe):
    """models/moe.MoeFFN on the rank (its experts and its slice of the
    shared experts' width), loaded with the rank's slice of the
    one-process `state`, on its data row of x: the output, the
    gradients of sum(out * probe) and the sort dispatch's routing
    record."""
    from repro_torch.launch.sharding import local_batch
    from repro_torch.models import layers
    from repro_torch.models.moe import MoeFFN

    block = MoeFFN(cfg, None, dtype=torch.float32, requires_grad=True,
                   mesh=mesh)
    mine = layers.placed({n: torch.from_numpy(a) for n, a in state.items()},
                         block.placement, "", mesh)
    block.load_state_dict(mine, strict=True, assign=True)
    block.requires_grad_(True)
    xl = local_batch({"x": torch.from_numpy(x)}, mesh)["x"].requires_grad_()
    pl = local_batch({"x": torch.from_numpy(probe)}, mesh)["x"]
    routing = {}
    out = block(xl, routing=routing)
    (out * pl).sum().backward()
    return {"out": _np(out), "x": _np(xl.grad),
            "grads": {n: _np(p.grad) for n, p in block.named_parameters()},
            "placement": dict(block.placement),
            "routing": {k: (v if isinstance(v, int) else _np(v))
                        for k, v in routing.items()}}


def four(rank, world, store_path, moe_layouts, moe_args, loss_layouts,
         loss_inp, train_args):
    """The 4-rank work of test_torch_tp_train in one spawn: the MoE block
    on each of `moe_layouts`, the loss and the pick on each of
    `loss_layouts`, then one train step and a checkpoint on data 2 x
    model 2."""
    out = {"moe": {}, "loss": {}}
    for layout, mesh in _layouts(rank, world, store_path + ".m",
                                 moe_layouts):
        out["moe"][layout] = moe_block(mesh, *moe_args)
    for layout, mesh in _layouts(rank, world, store_path + ".l",
                                 loss_layouts):
        out["loss"][layout] = loss_and_pick(mesh, loss_inp)
    out["train"] = {}
    for name, args in train_args.items():
        with _mesh(rank, world, f"{store_path}.t{name}",
                   {"data": 2, "model": 2}) as mesh:
            out["train"][name] = train(mesh, *args)
    return out
