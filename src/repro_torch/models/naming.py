"""Parameter names across the two packages.

The reference keeps a model's parameters as a pytree: nested dicts of
arrays, each stack of layers scanned as one leaf with a leading layer
axis (`blocks`, or whisper's `enc_blocks` and `dec_blocks`), except
xlstm's `blocks`, a Python list of heterogeneous dicts. The port holds
one module per layer, so its state dict names carry the layer index:
`blocks.<i>.<key>`. `reference_state` maps the reference's tree onto
those names; `layer_groups` is its inverse (checkpoints and gradient
compression group by it: one reference leaf, one file and one scale).
"""
from __future__ import annotations

import re

from repro_torch.models.config import ArchConfig

#: The prefixes whose layers the reference stacks, in any family.
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def stacked_layers(cfg: ArchConfig) -> dict[str, int]:
    """The family's stacked prefixes and their depths (xlstm's list of
    layers is not stacked: each layer's leaves are leaves of their own)."""
    if cfg.family == "ssm":
        return {}
    if cfg.family == "encdec":
        return {"enc_blocks": cfg.enc_layers, "dec_blocks": cfg.n_layers}
    return {"blocks": cfg.n_layers}


def flatten(tree, prefix: str = "") -> dict:
    """A pytree of dicts and lists as {dotted path: leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    flat = {}
    for k, v in items:
        flat.update(flatten(v, f"{prefix}{k}."))
    return flat


def reference_state(cfg: ArchConfig, tree) -> dict:
    """The reference's parameter pytree as the port's state dict names:
    a stacked leaf <prefix>.<key> with leading axis L becomes
    <prefix>.<i>.<key> for i < L; every other leaf keeps its path."""
    stacked = stacked_layers(cfg)
    state = {}
    for name, arr in flatten(tree).items():
        head, _, rest = name.partition(".")
        if head not in stacked:
            state[name] = arr
            continue
        if arr.shape[0] != stacked[head]:
            raise ValueError(f"{name}: leading axis {arr.shape[0]}, "
                             f"expected {stacked[head]} layers")
        for i in range(stacked[head]):
            state[f"{head}.{i}.{rest}"] = arr[i]
    return state


def layer_groups(names, stacked=STACKED) -> dict[str, list[str]]:
    """The inverse naming of `reference_state`: each reference leaf name
    (dotted, stacked leaves without the layer index) -> the state dict
    names it stacks, in layer order (one name for any other leaf).
    `stacked`: the prefixes the model stacks (a model's `.stacked`)."""
    block = re.compile(r"^(%s)\.(\d+)\.(.+)$" % "|".join(
        map(re.escape, stacked))) if stacked else None
    groups: dict[str, dict[int, str]] = {}
    for name in names:
        m = block.match(name) if block else None
        key, layer = (f"{m.group(1)}.{m.group(3)}", int(m.group(2))) if m \
            else (name, 0)
        if layer in groups.setdefault(key, {}):
            raise ValueError(f"{name}: two names for leaf {key}")
        groups[key][layer] = name
    out = {}
    for key, by_layer in groups.items():
        if sorted(by_layer) != list(range(len(by_layer))):
            raise ValueError(f"{key}: layers {sorted(by_layer)} are not "
                             f"0..{len(by_layer) - 1}")
        out[key] = [by_layer[i] for i in range(len(by_layer))]
    return out
