"""Architecture registry: family -> model module dispatch (the mixer family
so far; the others arrive with ROADMAP.md queue 1 item 14)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import JigsawConfig
from repro_torch.models import weathermixer

_FAMILY_MODULE = {"mixer": weathermixer}


def module_for(cfg: ModelConfig):
    if cfg.family not in _FAMILY_MODULE:
        raise NotImplementedError(
            f"{cfg.arch_id} (family {cfg.family!r}) is not ported yet "
            "(ROADMAP.md, queue 1 item 14: model zoo)")
    return _FAMILY_MODULE[cfg.family]


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    return module_for(cfg).init(cfg, seed=seed, device=device)


def apply(params, batch, cfg: ModelConfig, jcfg: JigsawConfig, *,
          rollout: int = 1):
    """The training forward: (prediction, aux)."""
    return module_for(cfg).apply(params, batch, cfg, jcfg, rollout=rollout)


def forecast_step(params, fields, cfg: ModelConfig, jcfg: JigsawConfig):
    """One autoregressive field-rollout step (serving hot path)."""
    return module_for(cfg).forecast_step(params, fields, cfg, jcfg)
