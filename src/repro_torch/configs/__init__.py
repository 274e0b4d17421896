"""Architecture registry: one module per assigned arch + the paper's own
CloudSort config. `get(name)` returns the ArchConfig; `REGISTRY` lists all.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "llava_next_34b",
    "granite_3_8b",
    "mistral_nemo_12b",
    "minicpm3_4b",
    "tinyllama_1_1b",
    "qwen2_moe_a2_7b",
    "moonshot_v1_16b_a3b",
    "xlstm_125m",
    "whisper_base",
    "hymba_1_5b",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def get(name: str):
    mod_name = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs():
    return {i: get(i) for i in ARCH_IDS}
