"""Config registry: ``get_config(arch_id)``, every id of
``repro/configs/registry.py``: the mixer family, ``mamba2-130m`` (ssm),
the dense, VLM and moe transformers, the hybrid ``jamba-1.5-large-398b``
and the enc-dec ``whisper-small`` (audio).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig

ARCH_IDS: List[str] = [
    "dbrx-132b",
    "jamba-1.5-large-398b",
    "internlm2-1.8b",
    "pixtral-12b",
    "gemma3-27b",
    "phi3.5-moe-42b-a6.6b",
    "whisper-small",
    "stablelm-3b",
    "mamba2-130m",
    "h2o-danube-1.8b",
    "weathermixer-1b",
]

MIXER_IDS: List[str] = ["weathermixer-1b"]


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    module = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module("repro_torch.configs." + module).CONFIG

