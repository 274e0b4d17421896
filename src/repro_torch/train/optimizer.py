"""AdamW + cosine schedule + global-norm clipping, as plain tensor code.

Twin of src/repro/train/optimizer.py with the same order of operations:
the learning rate comes from the schedule at the incremented step, the
global grad norm is taken (and reported) before clipping, the weight
decay is added to the Adam direction and the sum is scaled by the
scheduled lr. (`torch.optim.AdamW` places the decay differently.)

Parameters, gradients and the moments are mappings name -> tensor (a
model's `named_parameters()`); the moments and every update are float32.
`adamw_update` updates the parameters and moments in place, one tensor
at a time, so a step needs no second copy of the training state, and
keeps the step counter, the lr and the norm on the parameters' device:
nothing waits for the card.

On a rank of a launch/mesh.RankMesh, the global norm counts each
replicated gradient once and sums the split ones' (the expert banks,
`split`) squares over the "model" axis, so every rank clips by the norm
of the whole model's gradient.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.collectives import psum


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def lr_at(step, cfg: OptConfig):
    """The lr at `step` (an int or an integer tensor) as a float32 tensor:
    linear warmup, then a cosine decay to min_lr_frac of the peak."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.peak_lr * warm * frac


def init_opt_state(params):
    """Zero float32 moments for every parameter and a step counter (int32,
    on the parameters' device)."""
    params = dict(params)
    dev = next(iter(params.values())).device if params else "cpu"
    return {"mu": {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for n, p in params.items()},
            "nu": {n: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads, *, mesh=None, split=()):
    """sqrt of the sum of every gradient's squares, in float32. On a rank
    of `mesh`, the gradients named in `split` are this rank's slices of
    tensors split over "model": their squares are summed over the axis
    (one all_reduce), and the replicated ones counted once."""
    total = 0
    for name, g in grads.items():
        if name not in split:
            total = total + torch.sum(torch.square(g.float()))
    if split:
        part = 0
        for name in split:
            part = part + torch.sum(torch.square(grads[name].float()))
        total = total + psum(torch.as_tensor(part).reshape(1), mesh,
                             "model", what="grad_norm")[0]
    return torch.sqrt(total)


def _clip_scale(gn, max_norm):
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(grads, max_norm):
    """Returns (grads scaled to a global norm of at most max_norm, the
    norm before clipping)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return {n: g * scale for n, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig, *, mesh=None,
                 split=()):
    """One AdamW step. Updates `params`' tensors and state["mu"]/["nu"] in
    place; returns (params, new state, {"lr", "grad_norm"}), where
    grad_norm is the norm before clipping (over the ranks of `mesh`, with
    the `split` gradients summed over "model": see global_norm)."""
    step = state["step"] + 1
    lr = lr_at(step, cfg).to(step.device)
    gnorm = global_norm(grads, mesh=mesh, split=split)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for name, p in params.items():
        g = (grads[name] * scale).float()
        mu, nu = state["mu"][name], state["nu"][name]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_(((1 - b2) * g).mul_(g))
        del g
        direction = (mu / bc1).div_((nu / bc2).sqrt_().add_(cfg.eps))
        pf = p.float()
        direction.add_(cfg.weight_decay * pf).mul_(lr)
        p.copy_(pf - direction)
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, {
        "lr": lr, "grad_norm": gnorm}
