"""Unified model API: build(cfg) -> ModelApi with train and serve entry
points, and "meta" tensor input specs for every assigned benchmark shape.

Twin of src/repro/models/api.py for every family: dense, mla, moe and vlm
(models/transformer.py), ssm (models/xlstm.py), hybrid (models/hymba.py)
and encdec (models/whisper.py); an unknown family raises ValueError.

Shape cells (the reference's; its batches are pod-wide, so
launch/dryrun.py also searches the largest batch that fits one card):
  train_4k    : seq 4096,   global_batch 256  -> train step
  prefill_32k : seq 32768,  global_batch 32   -> prefill
  decode_32k  : seq 32768,  global_batch 128  -> decode_step w/ 32k cache
  long_500k   : seq 524288, global_batch 1    -> decode_step (ssm/hybrid only)
`input_specs`, `abstract_params` and `abstract_cache` give the cells'
inputs, weights and caches as tensors on "meta" (shapes and dtypes, no
storage), the twin of the reference's ShapeDtypeStructs.

Family conventions, as the reference's: a `vlm` batch carries
"patch_embeds" (B, vlm_prefix, d) before its text, and its logits and
labels span vlm_prefix + S positions; an `encdec` batch carries "frames"
(B, enc_len_for(cfg, S), d). `stub_inputs` draws both frontends.

`params` is the family's nn.Module holding the weights: `init(generator,
trainable=...)` draws them on the generator's device, as float32 masters
with gradients for training or in the config's dtype for serving;
`params_from_reference(tree, device=...)` carries the JAX package's
parameter pytree (numpy arrays; models/naming.py maps the names) across,
so that both packages compute from the same weights. `build(cfg,
mesh=)` is the reference's `build(cfg, mesh=, dp_axes=)`: on a rank of a
launch/mesh.RankMesh with axes ("data", "model") the model holds the
rank's E/ep experts and its MoE dispatch runs over the ranks
(models/moe.py); the entry points take the rank's data row of the
batch (launch/sharding.local_batch), and `params_from_reference(...,
mesh=)` keeps the rank's slice. `build(cfg, ep_size=, dp=)` runs the
dp x ep_size mesh shards as a batch axis in one process instead (the
rank path's oracle).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.kernels import u32
from repro_torch.launch.sharding import rank_split
from repro_torch.models import hymba, naming, transformer, whisper, xlstm
from repro_torch.models.config import ArchConfig

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


@dataclasses.dataclass
class ModelApi:
    cfg: ArchConfig
    init: Callable[..., Any]  # (generator, trainable=False) -> params
    forward: Callable[..., Any]  # (params, batch) -> logits
    loss: Callable[..., Any]  # (params, batch) -> scalar
    prefill: Callable[..., Any]  # (params, batch, max_len) -> (logits, cache)
    decode_step: Callable[..., Any]  # (params, cache, token, pos) -> (logits, cache)
    init_cache: Callable[..., Any]  # (batch, max_len, device=) -> cache
    params_from_reference: Callable[..., Any]  # (tree, device=, trainable=) -> params
    mesh: Any = None  # the rank's launch/mesh.RankMesh, or None

    def abstract_params(self):
        """The serving weights (the config's dtype) on "meta"."""
        return self.init(None)

    def abstract_cache(self, batch: int, max_len: int):
        return self.init_cache(batch, max_len, device="meta")

    def input_specs(self, shape_name: str, *, batch: int | None = None):
        """"meta" stand-ins for one benchmark cell's inputs (no storage),
        at the cell's batch or at `batch`. Train and prefill: int32
        tokens (and labels), a vlm's float32 patch embeddings (its labels
        span the prefix and the text), an encdec's float32 frames. Decode:
        the cache of the cell's length, one int32 token a sequence, and
        `pos`, a Python int (the decode steps take it with int())."""
        cfg = self.cfg
        spec = SHAPES[shape_name]
        b = spec["batch"] if batch is None else batch
        s = spec["seq"]
        i32 = torch.int32

        def sd(shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="meta")

        if spec["kind"] == "decode":
            return {"cache": self.abstract_cache(b, s),
                    "token": sd((b, 1), i32), "pos": s - 1}
        train = spec["kind"] == "train"
        if cfg.family == "vlm":
            specs = {"patch_embeds": sd((b, cfg.vlm_prefix, cfg.d_model)),
                     "tokens": sd((b, s - cfg.vlm_prefix), i32)}
        elif cfg.family == "encdec":
            specs = {"frames": sd((b, whisper.enc_len_for(cfg, s),
                                   cfg.d_model)),
                     "tokens": sd((b, s), i32)}
        else:
            specs = {"tokens": sd((b, s), i32)}
        if train:
            specs["labels"] = sd((b, s), i32)
        return specs


def ce_loss(logits, labels):
    """Mean next-token cross-entropy: the twin of the reference's
    `_ce_loss`, which scores logits[:, :-1] against labels[:, 1:]. The
    reference's pipeline already shifts its labels by one, so the two
    together train position i on token i+2 (ROADMAP.md §3 fault 5); the
    port keeps these semantics to stay comparable."""
    lg = logits[:, :-1].float()
    tgt = labels[:, 1:].long()
    m = lg.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(lg - m).sum(dim=-1))
    tgt_logit = lg.gather(-1, tgt[..., None])[..., 0]
    return (lse - tgt_logit).mean()


def model_class(cfg: ArchConfig):
    """The nn.Module class of the config's family."""
    if cfg.family in transformer.FAMILIES:
        return transformer.Transformer
    classes = {"ssm": xlstm.XLSTM, "hybrid": hymba.Hymba,
               "encdec": whisper.Whisper}
    if cfg.family not in classes:
        raise ValueError(f"unknown family {cfg.family}")
    return classes[cfg.family]


def stub_inputs(cfg: ArchConfig, batch: int, seq: int,
                generator: torch.Generator) -> dict:
    """The frontend stubs' inputs for `batch` sequences of `seq` text
    tokens, standard normal from `generator` on its device: "patch_embeds"
    for a vlm, "frames" for an encdec; nothing for the other families."""
    if cfg.family == "vlm":
        shape = (batch, cfg.vlm_prefix, cfg.d_model)
        name = "patch_embeds"
    elif cfg.family == "encdec":
        shape = (batch, whisper.enc_len_for(cfg, seq), cfg.d_model)
        name = "frames"
    else:
        return {}
    return {name: torch.randn(shape, generator=generator,
                              device=generator.device)}


def new_model(cfg: ArchConfig, generator, *, trainable: bool = False,
              mesh=None):
    """The family's module; on a rank of `mesh` (transformer families:
    the MoE banks hold the rank's experts; the others have nothing to
    place and are the one-process module)."""
    cls = model_class(cfg)
    if mesh is not None and cls is transformer.Transformer:
        return cls(cfg, generator, trainable=trainable, mesh=mesh)
    return cls(cfg, generator, trainable=trainable)


def params_from_reference(cfg: ArchConfig, tree, *, device="cuda",
                          trainable: bool = False, mesh=None):
    """The port's model holding the reference's weights: `tree` is the
    JAX parameter pytree as nested dicts (and xlstm's list) of numpy
    arrays (e.g. `jax.tree.map(np.asarray, params)`). Serving casts them
    to the config's dtype; `trainable` keeps them as float32 masters
    with gradients. On a rank of `mesh`, the model keeps its slice of
    each split tensor (launch/sharding.rank_split)."""
    dev = u32.resolve_device(device)
    dt = transformer.param_dtype(cfg, trainable)
    model = new_model(cfg, None, trainable=trainable, mesh=mesh)
    local = dict(model.named_parameters())
    split = rank_split(model)
    state = {}
    for name, arr in naming.reference_state(cfg, tree).items():
        if name in split:
            dim, n = split[name], local[name].shape[split[name]]
            lo = mesh.index_of("model") * n
            arr = np.take(arr, np.arange(lo, lo + n), axis=dim)
        state[name] = torch.from_numpy(np.array(arr)).to(device=dev,
                                                         dtype=dt)
    model.load_state_dict(state, strict=True, assign=True)
    return model.requires_grad_(trainable)


def build(cfg: ArchConfig, *, ep_size: int = 1, dp: int = 1,
          mesh=None) -> ModelApi:
    cls = model_class(cfg)
    fam = cfg.family
    if mesh is not None and ep_size * dp > 1:
        raise ValueError("build: a rank mesh (mesh=) or the mesh as a batch "
                         "axis (ep_size=, dp=), not both")
    if mesh is not None and "pod" in mesh.axes:
        raise NotImplementedError(
            "build: a 'pod' axis is the pod-group gradient compression's "
            "(ROADMAP.md §1 item 3), not ported yet")
    batch_mesh = dict(ep_size=ep_size, dp=dp)

    def init(generator: torch.Generator, *, trainable: bool = False):
        return new_model(cfg, generator, trainable=trainable, mesh=mesh)

    if cls is transformer.Transformer:
        def forward(params, batch):
            return params.forward(batch["tokens"], batch.get("patch_embeds"),
                                  **batch_mesh)

        def prefill(params, batch, max_len=None):
            # max_len counts text positions; the VLM patch prefix lives in
            # the same cache, so reserve room for it too (the reference's)
            if fam == "vlm" and max_len is not None:
                max_len = max_len + cfg.vlm_prefix
            return params.prefill(batch["tokens"], max_len,
                                  batch.get("patch_embeds"), **batch_mesh)

        def decode_step(params, cache, token, pos):
            return params.decode_step(cache, token, pos, **batch_mesh)

        def new_cache(batch, max_len, dev):
            return transformer.init_cache(cfg, batch, max_len, dev)
    elif fam == "encdec":
        def forward(params, batch):
            return params.forward(batch["tokens"], batch["frames"])

        def prefill(params, batch, max_len=None):
            return params.prefill(batch["tokens"], batch["frames"], max_len)

        def decode_step(params, cache, token, pos):
            return params.decode_step(cache, token, pos)

        def new_cache(batch, max_len, dev):
            # the decode cells' encoder context: seq // 4 frames
            return whisper.init_cache(cfg, batch, max_len,
                                      whisper.enc_len_for(cfg, max_len), dev)
    else:  # ssm, hybrid
        module = xlstm if fam == "ssm" else hymba

        def forward(params, batch):
            return params.forward(batch["tokens"])

        def prefill(params, batch, max_len=None):
            return params.prefill(batch["tokens"], max_len)

        def decode_step(params, cache, token, pos):
            return params.decode_step(cache, token, pos)

        def new_cache(batch, max_len, dev):
            return module.init_cache(cfg, batch, max_len, dev)

    def loss(params, batch):
        return ce_loss(forward(params, batch), batch["labels"])

    def init_cache(batch: int, max_len: int, *, device="cuda"):
        dev = torch.device("meta") if str(device) == "meta" \
            else u32.resolve_device(device)
        return new_cache(batch, max_len, dev)

    def from_reference(tree, *, device="cuda", trainable: bool = False):
        return params_from_reference(cfg, tree, device=device,
                                     trainable=trainable, mesh=mesh)

    return ModelApi(cfg=cfg, mesh=mesh, init=init, forward=forward,
                    loss=loss,
                    prefill=prefill, decode_step=decode_step,
                    init_cache=init_cache,
                    params_from_reference=from_reference)


def applicable_shapes(cfg: ArchConfig):
    """The shape cells this arch runs (long_500k: ssm and hybrid only)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        names.append("long_500k")
    return names
