"""Config registry: every assigned architecture + the paper's own kernel
(the port's copy of `repro.configs`; only the dense family runs so far).

``get_config(name)`` returns the full published config;
``get_smoke_config(name)`` returns a reduced same-family config for CPU tests.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ArchConfig

ARCH_IDS: List[str] = [
    "nemotron_4_340b",
    "qwen2_5_14b",
    "qwen3_32b",
    "nemotron_4_15b",
    "qwen2_vl_72b",
    "whisper_large_v3",
    "arctic_480b",
    "llama4_maverick_400b_a17b",
    "falcon_mamba_7b",
    "recurrentgemma_9b",
]

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}


def canonical(name: str) -> str:
    name = name.replace("-", "_").replace(".", "_")
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    return name


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.CONFIG


def get_smoke_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.SMOKE


def all_configs() -> Dict[str, ArchConfig]:
    return {i: get_config(i) for i in ARCH_IDS}
