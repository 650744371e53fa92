"""Config -> JigsawConfig (the port's copy of
``repro/launch/shapes.py::jigsaw_for``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core import precision
from repro_torch.core.api import JigsawConfig


def jigsaw_for(cfg: ModelConfig) -> JigsawConfig:
    pol = precision.policy_of(cfg)
    # legacy (no named policy): compute_dtype stays unset, so linears see
    # the params' and activations' own dtypes, as in the reference
    cd = None if pol.name == "legacy" else pol.compute_dtype
    return JigsawConfig(scheme=cfg.scheme, kernel=cfg.kernel,
                        accum_dtype=pol.accum_dtype, compute_dtype=cd)
