"""Assigned-architecture registry: ``get(name)`` / ``smoke(name)``.

Each ``<id>.py`` exports ``CONFIG`` (the exact assigned configuration) and
``smoke()`` (a reduced same-family copy for CPU smoke tests: small widths,
few layers/experts, tiny vocab — structure preserved).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ArchConfig

ARCH_IDS: List[str] = [
    "qwen1_5_32b",
    "qwen2_7b",
    "gemma2_27b",
    "glm4_9b",
    "internvl2_76b",
    "mamba2_130m",
    "llama4_scout_17b_a16e",
    "mixtral_8x22b",
    "zamba2_2_7b",
    "musicgen_large",
]

#: public ids (dashes) -> module names
ALIASES: Dict[str, str] = {
    "qwen1.5-32b": "qwen1_5_32b",
    "qwen2-7b": "qwen2_7b",
    "gemma2-27b": "gemma2_27b",
    "glm4-9b": "glm4_9b",
    "internvl2-76b": "internvl2_76b",
    "mamba2-130m": "mamba2_130m",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "mixtral-8x22b": "mixtral_8x22b",
    "zamba2-2.7b": "zamba2_2_7b",
    "musicgen-large": "musicgen_large",
}


def _module(name: str):
    mod = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def smoke(name: str) -> ArchConfig:
    return _module(name).smoke()


def all_configs() -> Dict[str, ArchConfig]:
    return {aid: get(aid) for aid in ARCH_IDS}
