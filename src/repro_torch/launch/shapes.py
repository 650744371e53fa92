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
    # impl applies to scheme="1d" only (the reference passes it always and
    # warns when another scheme ignores it)
    one_d = cfg.scheme == "1d"
    if one_d and cfg.shard_params_over_data:
        raise NotImplementedError(
            "shard_params_over_data (the FSDP-hybrid weight layout) needs "
            "the data axis (ROADMAP.md, queue 1 item 8)")
    return JigsawConfig(scheme=cfg.scheme,
                        impl=cfg.impl if one_d else "rs",
                        kernel=cfg.kernel, accum_dtype=pol.accum_dtype,
                        compute_dtype=cd)
