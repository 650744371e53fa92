"""Config registry: ``get_config(arch_id)``.

The port runs the mixer family and ``mamba2-130m`` (the ssm family's
forward and generation) so far.  The ids of the other families are listed,
as in ``repro/configs/registry.py``, and raise until their slice of the port
lands.
"""
from __future__ import annotations

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
SSM_IDS: List[str] = ["mamba2-130m"]


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in MIXER_IDS + SSM_IDS:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet: the port has "
            f"{MIXER_IDS + SSM_IDS} "
            "(ROADMAP.md, queue 1 item 14: model zoo)")
    if arch_id == "mamba2-130m":
        from repro_torch.configs import mamba2_130m
        return mamba2_130m.CONFIG
    from repro_torch.configs import weathermixer_1b
    return weathermixer_1b.CONFIG

