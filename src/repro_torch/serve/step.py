"""Language-model serving: prefill and greedy decode steps (the port of
``repro/serve/step.py``).

``make_serve_step`` builds the single-token decode step; ``generate`` runs
the prompt through ``prefill`` and then ``steps - 1`` decode steps.  A
family without a fused prefill (the ssm family, as in the reference) is
prefilled token by token through the same decode step
(``prefill_tokenwise``).  Each step writes the model's cache in place
(``models/mamba.py::decode_step``), which stands in for the reference's
buffer donation, and keeps the output tokens on the device until one
concatenate at the end.  Nothing here needs autograd: ``generate`` runs
under ``torch.no_grad``.  The reference's ``extra_batch`` (the enc-dec
family's encoder input) arrives with that family (ROADMAP.md, queue 1
item 14).  Everything runs where the prompts and the
parameters lie: on the card unless the caller made them on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import JigsawConfig
from repro_torch.models import registry as M


def make_serve_step(cfg: ModelConfig, jcfg: JigsawConfig):
    """Returns serve_step(params, cache, tokens [B, 1]) ->
    (next_tokens [B, 1] int32, cache): greedy, with the vocab padding
    masked off before the argmax (which takes the first maximum, as
    ``jnp.argmax``)."""

    def serve_step(params, cache, tokens):
        logits, cache = M.decode_step(params, cache, tokens, cfg, jcfg)
        logits = logits[..., : cfg.vocab_size]
        nxt = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return nxt, cache

    return serve_step


def prefill_tokenwise(params, prompts: torch.Tensor, cfg: ModelConfig,
                      jcfg: JigsawConfig, max_len: int,
                      cache_dtype=torch.bfloat16):
    """Token-by-token prefill through the decode step: a fresh cache on the
    prompts' device, then one step per prompt position.  Returns the token
    after the prompt [B, 1] and the cache."""
    b, s = prompts.shape
    cache = M.init_cache(cfg, b, max_len, dtype=cache_dtype,
                         device=prompts.device)
    step = make_serve_step(cfg, jcfg)
    last = prompts[:, :1]
    for t in range(s):
        last, cache = step(params, cache, prompts[:, t:t + 1])
    return last, cache


def prefill(params, prompts: torch.Tensor, cfg: ModelConfig,
            jcfg: JigsawConfig, max_len: int, cache_dtype=torch.bfloat16,
            fused: Optional[bool] = None):
    """Fill a fresh cache from the prompt.  ``fused=None`` takes the family's
    fused prefill where it has one and goes token-wise otherwise; True
    forces the fused one (and raises where there is none); False forces the
    token-wise path."""
    if fused is False:
        return prefill_tokenwise(params, prompts, cfg, jcfg, max_len,
                                 cache_dtype)
    try:
        logits, cache = M.prefill_cache(params, {"tokens": prompts}, cfg,
                                        jcfg, max_len, dtype=cache_dtype)
    except NotImplementedError:
        if fused:
            raise
        return prefill_tokenwise(params, prompts, cfg, jcfg, max_len,
                                 cache_dtype)
    nxt = torch.argmax(logits[:, -1:, : cfg.vocab_size],
                       dim=-1).to(torch.int32)
    return nxt, cache


@torch.no_grad()
def generate(params, prompts: torch.Tensor, cfg: ModelConfig,
             jcfg: JigsawConfig, *, steps: int, max_len: int,
             fused: Optional[bool] = None) -> torch.Tensor:
    """Greedy generation: prefill, then ``steps - 1`` decode steps.
    Returns the ``steps`` new tokens [B, steps] (int32) on the prompts'
    device."""
    nxt, cache = prefill(params, prompts, cfg, jcfg, max_len, fused=fused)
    step = make_serve_step(cfg, jcfg)
    out = [nxt]
    for _ in range(steps - 1):
        nxt, cache = step(params, cache, nxt)
        out.append(nxt)
    return torch.cat(out, dim=1)
