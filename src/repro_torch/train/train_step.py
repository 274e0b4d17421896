"""Training step: loss -> grad -> (optional EF-int8 compression) -> AdamW.

Twin of src/repro/train/train_step.py. Microbatching (gradient
accumulation) runs the microbatches one after another, as the
reference's `lax.scan` does: their gradients accumulate in the float32
`.grad` of the master parameters and the sum and the loss are scaled by
1/microbatches. Remat is configured per arch inside the model. Mixed
precision: float32 master parameters, compute in the config's dtype
(cast in the model), float32 grads.

The state is {"params": the model (the family's nn.Module holding
float32 masters with gradients), "opt": {"mu", "nu": name -> tensor,
"step": int32 tensor}} and, with `pod_grad_compress`, "ef_residual". One
card is one pod, so the step has no pod axis to average over: the int8
exchange itself is `grad_compress.compressed_pod_mean`.

With `mesh=` (a launch/mesh.RankMesh with axes ("data", "model"), the
model built on it), each rank takes its data row of the global batch
(launch/sharding.local_batch). After the backward pass, the gradients
that sequence parallelism leaves partial on a TP rank (the norm
scales': each rank's norms saw its tokens only; the model's
`sp_partial`) are summed over "model" (one all_reduce of them all);
then the gradients and the loss are averaged over the data axes (one
all_reduce each; a split tensor's among the ranks holding the same
slice), and the clip's global norm sums the split tensors' squares over
"model" (train/optimizer.global_norm with launch/sharding.rank_split).
A "pod" axis is the pod-group gradient compression's, not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.collectives import psum
from repro_torch.launch.sharding import local_batch, rank_split
from repro_torch.train import grad_compress as gc
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    microbatches: int = 1  # grad-accumulation steps per train step
    pod_grad_compress: bool = False  # int8 error-feedback compression


def train_state_of(params, tcfg: TrainConfig):
    """The training state around a trainable model: zero moments, step 0."""
    named = dict(params.named_parameters())
    state = {"params": params, "opt": init_opt_state(named)}
    if tcfg.pod_grad_compress:
        state["ef_residual"] = gc.init_residual(named)
    return state


def init_train_state(model, generator: torch.Generator, tcfg: TrainConfig):
    """Float32 master parameters drawn from `generator` (on its device),
    zero moments and step 0."""
    return train_state_of(model.init(generator, trainable=True), tcfg)


def abstract_train_state(model, tcfg: TrainConfig):
    """The training state's structure with shapes only (on "meta"): the
    target that checkpoint.load fills."""
    return train_state_of(model.init(None, trainable=True), tcfg)


def _data_mean(tensors, mesh):
    """Each tensor averaged in place over the ranks of the data axes."""
    dp = mesh.data_axes
    n = mesh.size_of(dp)
    if n == 1:
        return
    for t in tensors:
        t.copy_(psum(t, mesh, dp, what="grad_mean")).div_(n)


def _model_sum(tensors, mesh):
    """The tensors summed in place over "model", in one all_reduce of
    their concatenation."""
    if not tensors or mesh.size_of("model") == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = psum(flat, mesh, "model", what="grad_sp")
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def make_train_step(model, tcfg: TrainConfig, mesh=None):
    """Returns train_step(state, batch) -> (state, metrics); the state's
    parameters and moments are updated in place. batch: {"tokens",
    "labels"} (B, S) on the parameters' device; B divisible by
    microbatches (on a mesh: the global batch, every rank the same; each
    keeps its data row)."""
    if mesh is not None and "pod" in mesh.axes:
        raise NotImplementedError(
            "make_train_step: a 'pod' axis is the pod-group gradient "
            "compression's (ROADMAP.md §1 item 3), not ported yet")
    if mesh is not None and tcfg.pod_grad_compress:
        raise NotImplementedError("make_train_step: pod_grad_compress over "
                                  "ranks (ROADMAP.md §1 item 3)")

    def grads_of(params, batch):
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        m = max(tcfg.microbatches, 1)
        if m == 1:
            loss = model.loss(params, batch)
            loss.backward()
            loss = loss.detach()
        else:
            def split(x, i):
                b = x.shape[0]
                return x.reshape((m, b // m) + x.shape[1:])[i]

            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(named.values())).device)
            for i in range(m):
                mb = {k: split(v, i) for k, v in batch.items()}
                l = model.loss(params, mb)
                l.backward()  # adds this microbatch's grads to .grad
                loss = loss + l.detach()
            inv = 1.0 / m
            loss = loss * inv
            for p in named.values():
                if p.grad is not None:
                    p.grad.mul_(inv)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}
        return loss, grads

    def train_step(state, batch):
        params = state["params"]
        if mesh is not None:
            batch = local_batch(batch, mesh)
        loss, grads = grads_of(params, batch)
        split = ()
        if mesh is not None:
            partial = getattr(params, "sp_partial", lambda seq: [])(
                batch["tokens"].shape[1])
            with torch.no_grad():
                _model_sum([grads[n] for n in partial], mesh)
                _data_mean([loss, *grads.values()], mesh)
            split = rank_split(params)
        new_state = dict(state)
        if tcfg.pod_grad_compress and "ef_residual" in state:
            grads, residual = gc.ef_compress_grads(
                grads, state["ef_residual"], params.stacked)
            new_state["ef_residual"] = residual
        _, opt, info = adamw_update(dict(params.named_parameters()), grads,
                                    state["opt"], tcfg.opt, mesh=mesh,
                                    split=split)
        for p in params.parameters():
            p.grad = None
        new_state["opt"] = opt
        return new_state, {"loss": loss, **info}

    return train_step
