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


# the language-model families that run on a 1-D model mesh
# (``jcfg.scheme="1d"``: the transformer's rank blocks)
LM_MESH_FAMILIES = ("dense", "vlm")


def check_lm_mesh(cfg: ModelConfig, model: int, fsdp: bool = False,
                  scheme: str = "1d") -> None:
    """What the port cannot lay out of a language model raises:
    NotImplementedError, naming ROADMAP.md's queue 1 item 19, for the moe,
    ssm, hybrid and audio families on a model mesh (``model`` ranks > 1),
    for the dense and VLM families on a 2-D one (``scheme``), and for the
    FSDP hybrid's cut of any language model over data (``fsdp``); ValueError
    where ``model`` does not divide ``n_heads``, ``d_model``, ``d_ff`` or
    ``vocab_padded`` (the reference pads such dims through GSPMD; the
    port's blocks are exact)."""
    if cfg.family == "mixer":
        return
    if fsdp:
        raise NotImplementedError(
            f"{cfg.arch_id} ({cfg.family!r}) FSDP-cut over data: the "
            "language models' FSDP hybrid is not ported (ROADMAP.md, queue "
            "1 item 19); use a data or 1-D model mesh without it")
    if model <= 1:
        return
    if cfg.family not in LM_MESH_FAMILIES or scheme == "2d":
        raise NotImplementedError(
            f"{cfg.arch_id} ({cfg.family!r}) on a {scheme} model mesh of "
            f"{model} ranks: only the dense and VLM families train on a "
            "1-D model mesh (ROADMAP.md, queue 1 item 19); use a data-only "
            "mesh")
    dims = {"n_heads": cfg.n_heads, "d_model": cfg.d_model,
            "d_ff": cfg.d_ff, "vocab_padded": cfg.vocab_padded}
    bad = {k: v for k, v in dims.items() if v % model}
    if bad:
        raise ValueError(f"{cfg.arch_id} on a model mesh of {model} ranks: "
                         f"{bad} not divisible by {model}")


def apply(params, batch, cfg: ModelConfig, jcfg: JigsawConfig, **kw):
    """The training forward: (prediction, aux); the mixer family takes
    ``rollout``.  Under ``scheme="1d"`` the mixer, dense and VLM families
    run on the rank's blocks; what the port cannot lay out there raises
    (``check_lm_mesh`` on the config's mesh)."""
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
