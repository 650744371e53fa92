"""Config registry: ``get_config(arch_id)``.

The port runs the mixer family, ``mamba2-130m`` (the ssm family's forward
and generation), the dense, VLM and moe transformers and the hybrid
``jamba-1.5-large-398b`` (forward and serving) so far.  The id of the
audio family (``whisper-small``) is listed, as in
``repro/configs/registry.py``, and raises until its slice of the port
lands.
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

# the ported ids, by the module that holds each config
_MODULE_FOR = {a: a.replace("-", "_").replace(".", "_")
               for a in ("weathermixer-1b", "mamba2-130m", "internlm2-1.8b",
                         "h2o-danube-1.8b", "stablelm-3b", "gemma3-27b",
                         "pixtral-12b", "dbrx-132b", "phi3.5-moe-42b-a6.6b",
                         "jamba-1.5-large-398b")}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in _MODULE_FOR:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet: the port has "
            f"{list(_MODULE_FOR)} (ROADMAP.md, queue 1 item 14: model zoo)")
    return importlib.import_module(
        "repro_torch.configs." + _MODULE_FOR[arch_id]).CONFIG

