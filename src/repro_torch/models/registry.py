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


def param_rule(cfg: ModelConfig, scheme: str):
    """The leaf rule ``(path, ndim) -> Spec`` of the family's parameters
    under a sharded ``scheme``: WeatherMixer's own, or the language
    models' one 1-D rule (``transformer.param_spec_1d``, every family's
    tree)."""
    mod = weathermixer if cfg.family == "mixer" else transformer
    return mod.PARAM_SPECS[scheme]


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    return module_for(cfg).init(cfg, seed=seed, device=device)


def check_lm_mesh(cfg: ModelConfig, model: int, fsdp: bool = False,
                  scheme: str = "1d") -> None:
    """What the port cannot lay out of a language model raises:
    NotImplementedError, naming ROADMAP.md's queue 1 item 19, for the FSDP
    hybrid's cut over more than one data rank (``fsdp``: the caller passes
    it only then) and for a 2-D model mesh (``scheme``); ValueError where
    ``model`` does not divide a dim it cuts (the reference pads such dims
    through GSPMD; the port's blocks are exact): the heads, the widths,
    the experts (expert parallelism), the Mamba-2 heads, inner width and
    conv channels (``in_xbc`` and ``conv_w`` are cut in blocks of
    channels), its groups where there is more than one (each rank runs
    whole groups), and the padded vocabulary.  Every language-model
    family runs on a 1-D model mesh."""
    if cfg.family == "mixer":
        return
    if fsdp:
        raise NotImplementedError(
            f"{cfg.arch_id} ({cfg.family!r}) FSDP-cut over data: the "
            "language models' FSDP hybrid is not ported (ROADMAP.md, queue "
            "1 item 19); use a data or 1-D model mesh without it")
    if model <= 1:
        return
    if scheme == "2d":
        raise NotImplementedError(
            f"{cfg.arch_id} ({cfg.family!r}) on a 2-D model mesh of "
            f"{model} ranks: a language model trains on a 1-D model mesh "
            "(ROADMAP.md, queue 1 item 19); use --scheme 1d")
    dims = {"n_heads": cfg.n_heads, "d_model": cfg.d_model,
            "d_ff": cfg.d_ff, "vocab_padded": cfg.vocab_padded}
    if cfg.n_experts:
        dims["n_experts"] = cfg.n_experts
    if cfg.family in ("ssm", "hybrid"):
        dims.update(ssm_heads=cfg.ssm_heads, d_inner=cfg.ssm_d_inner,
                    conv_dim=cfg.ssm_d_inner
                    + 2 * cfg.ssm_groups * cfg.ssm_state)
        if cfg.ssm_groups > 1:
            dims["ssm_groups"] = cfg.ssm_groups
    bad = {k: v for k, v in dims.items() if v % model}
    if bad:
        raise ValueError(f"{cfg.arch_id} on a model mesh of {model} ranks: "
                         f"{bad} not divisible by {model}")


def apply(params, batch, cfg: ModelConfig, jcfg: JigsawConfig, **kw):
    """The training forward: (prediction, aux); the mixer family takes
    ``rollout``.  Under ``scheme="1d"`` every family runs on the rank's
    blocks; a language model's layout is checked on the config's mesh
    (``check_lm_mesh``)."""
    if jcfg.scheme == "1d":
        check_lm_mesh(cfg, jcfg.mesh_1d.p)
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
