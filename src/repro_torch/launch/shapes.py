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
    # impl and the FSDP hybrid apply to scheme="1d" only (the reference
    # passes both always: its impl warns when another scheme ignores it,
    # and its 2-D linears never read fsdp)
    one_d = cfg.scheme == "1d"
    return JigsawConfig(scheme=cfg.scheme,
                        impl=cfg.impl if one_d else "rs",
                        fsdp=one_d and cfg.shard_params_over_data,
                        kernel=cfg.kernel, accum_dtype=pol.accum_dtype,
                        compute_dtype=cd)
