"""Architecture registry: family -> model module dispatch (every family of
``repro/models/registry.py``: mixer, ssm, dense, vlm, moe, hybrid and the
enc-dec audio family)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import JigsawConfig
from repro_torch.models import (encdec, hybrid, mamba, transformer,
                                weathermixer)

_FAMILY_MODULE = {"mixer": weathermixer, "ssm": mamba, "dense": transformer,
                  "vlm": transformer, "moe": transformer, "hybrid": hybrid,
                  "audio": encdec}


def module_for(cfg: ModelConfig):
    return _FAMILY_MODULE[cfg.family]


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    return module_for(cfg).init(cfg, seed=seed, device=device)


def apply(params, batch, cfg: ModelConfig, jcfg: JigsawConfig, **kw):
    """The training forward: (prediction, aux); the mixer family takes
    ``rollout``."""
    return module_for(cfg).apply(params, batch, cfg, jcfg, **kw)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    mod = module_for(cfg)
    if not hasattr(mod, "init_cache"):
        raise ValueError(f"{cfg.arch_id} ({cfg.family}) has no decode path")
    return mod.init_cache(cfg, batch_size, max_len, dtype, device=device)


def decode_step(params, cache, tokens, cfg: ModelConfig, jcfg: JigsawConfig):
    return module_for(cfg).decode_step(params, cache, tokens, cfg, jcfg)


def start_cache(params, cache, extra_batch: dict, cfg: ModelConfig,
                jcfg: JigsawConfig):
    """Load a prompt's extra inputs into a fresh decode cache, in place
    (the enc-dec family's encoder states of ``extra_batch["frames"]``);
    a family that takes none leaves the cache as it is.  Returns it."""
    mod = module_for(cfg)
    if hasattr(mod, "start_cache"):
        mod.start_cache(params, cache, extra_batch, cfg, jcfg)
    return cache


def has_fused_prefill(cfg: ModelConfig) -> bool:
    """Whether the family has a fused prefill (``prefill_cache``); one that
    has may still raise NotImplementedError for a layout it does not
    take."""
    return hasattr(module_for(cfg), "prefill_cache")


def prefill_cache(params, batch, cfg: ModelConfig, jcfg: JigsawConfig,
                  max_len: int, dtype=torch.bfloat16):
    """Fused prefill: one teacher-forced forward that also fills the cache.
    Families without one raise NotImplementedError, and ``serve/step.py``
    then prefills token by token (the ssm, hybrid and audio families have
    none, as in the reference; the transformer's raises for local:global
    stacks)."""
    if not has_fused_prefill(cfg):
        raise NotImplementedError(
            f"{cfg.arch_id} ({cfg.family}) has no fused prefill")
    return module_for(cfg).prefill_cache(params, batch, cfg, jcfg, max_len,
                                         dtype=dtype)


def forecast_step(params, fields, cfg: ModelConfig, jcfg: JigsawConfig,
                  **kw):
    """One autoregressive field-rollout step (serving hot path)."""
    return module_for(cfg).forecast_step(params, fields, cfg, jcfg, **kw)
