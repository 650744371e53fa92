"""jamba-1.5-large: the hybrid of Mamba-2, attention and MoE (arXiv:2403.19887).

The port of ``repro/models/hybrid.py``.  The layers are ``n_layers //
attn_every`` repeats of a period of ``attn_every`` slots: slot j is
attention where ``cfg.is_attn_layer(j)`` (Jamba: slot 4 of 8) and a
Mamba-2 mixer otherwise, and its FFN is a MoE where ``cfg.is_moe_layer(j)``
(Jamba: the odd slots) and dense otherwise; each slot is (RMSNorm, mixer,
residual, RMSNorm, FFN or MoE, residual).  As in the reference, the
Mamba-2 (SSD) mixer stands for Jamba's Mamba-1, and the attention has no
positional encoding (``rope_theta=None``).  Parameters are a dict of
tensors as in the reference, except that ``params["periods"]`` is a list
with one dict of ``slot{j}`` dicts per period where the reference stacks
the periods on a leading dim for ``lax.scan`` (``convert.py`` maps
between the two).

``apply`` is the teacher-forced forward (logits and the MoE layers'
summed aux loss).  Under ``kernel="pallas"`` every linear (an SSM slot's
in_z, in_xbc, in_dt and out_proj, attention's q, k, v and o, the dense
FFN's, the MoE router, the head) is a block_matmul launch and every SSM
slot's intra-chunk SSD term one ssd_chunk launch.  ``decode_step`` takes
one token per row against ``init_cache``'s cache, which it writes in
place (every slot and mask from ``cache["pos"]`` on the device), so
``serve/step.py`` can capture it in a CUDA graph.  The reference's hybrid
has no fused prefill, so there is no ``prefill_cache``: ``serve/step.py``
prefills token by token.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import (DEFAULT_JIGSAW, JigsawConfig, head_apply,
                                  linear_init)
from repro_torch.core.precision import dtype_of
from repro_torch.models import layers as L
from repro_torch.models.mamba import conv_dtype


def _slot_kind(cfg: ModelConfig, j: int) -> str:
    return "attn" if cfg.is_attn_layer(j) else "ssm"


def _n_periods(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.attn_every:
        raise ValueError("hybrid depth must be a multiple of the period: "
                         f"n_layers {cfg.n_layers}, attn_every "
                         f"{cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


def period_init(gen: torch.Generator, cfg: ModelConfig, device):
    """One period's params: the reference's ``slot{j}`` dicts."""
    dtype = dtype_of(cfg.param_dtype)
    p = {}
    for j in range(cfg.attn_every):
        blk = {"norm": L.rmsnorm_init(cfg.d_model, device=device)}
        if _slot_kind(cfg, j) == "attn":
            blk["attn"] = L.attention_init(gen, cfg.d_model, cfg.n_heads,
                                           cfg.n_kv_heads, cfg.d_head,
                                           dtype=dtype, bias=cfg.attn_bias,
                                           device=device)
        else:
            blk["ssm"] = L.mamba2_init(gen, cfg.d_model,
                                       d_state=cfg.ssm_state,
                                       n_heads=cfg.ssm_heads,
                                       head_dim=cfg.ssm_head_dim,
                                       conv_kernel=cfg.ssm_conv,
                                       n_groups=cfg.ssm_groups,
                                       expand=cfg.ssm_expand, dtype=dtype,
                                       device=device)
        blk["ffn_norm"] = L.rmsnorm_init(cfg.d_model, device=device)
        if cfg.is_moe_layer(j):
            blk["moe"] = L.moe_init(gen, cfg.d_model, cfg.d_ff,
                                    cfg.n_experts, kind=cfg.ffn_kind,
                                    dtype=dtype, device=device)
        else:
            blk["ffn"] = L.ffn_init(gen, cfg.d_model, cfg.d_ff,
                                    kind=cfg.ffn_kind, dtype=dtype,
                                    device=device)
        p[f"slot{j}"] = blk
    return p


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Fresh weights on ``device`` from a ``torch.Generator`` seeded with
    ``seed``, in ``cfg.param_dtype`` (the norms, the routers and the SSM's
    A_log, D and dt_bias in f32, as the reference's).  Raises ValueError
    where the depth is not a whole number of periods (the reference
    asserts it), RuntimeError where ``device`` is CUDA and there is no
    card."""
    n_periods = _n_periods(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("hybrid.init: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype=dtype,
                              device=device),
        "periods": [period_init(gen, cfg, device) for _ in range(n_periods)],
        "final_norm": L.rmsnorm_init(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_padded,
                                        dtype=dtype, bias=False,
                                        device=device)
    return params


def _lm_head(params, x, cfg: ModelConfig, jcfg: JigsawConfig):
    """The final norm and the head: under ``scheme="1d"`` the rank's vocab
    block of the logits."""
    x = L.rmsnorm_apply(params["final_norm"], x, mesh=L.mesh_1d(jcfg))
    if cfg.tie_embeddings:
        return L.unembed_apply(params["embed"], x, jcfg)
    return head_apply(params["lm_head"]["w"], x, jcfg)


def _slot_apply(blk, x, j: int, cfg: ModelConfig, jcfg: JigsawConfig,
                positions, aux, state=None, pos=None):
    """One layer of the period.  ``state``: None (the teacher-forced
    forward) or the slot's cache entry for this period (attention: its
    "k" and "v", written in place; SSM: its "conv" and "ssm"), with
    ``pos`` the rows' positions.  Returns (x, the SSM slot's new state or
    None, aux plus the MoE layer's).  Under ``scheme="1d"`` x is the
    rank's feature block and the norms, the attention, the Mamba-2 mixer,
    the FFN and the MoE run the rank's blocks (heads, experts)."""
    new_state = None
    mesh = L.mesh_1d(jcfg)
    h = L.rmsnorm_apply(blk["norm"], x, mesh=mesh)
    if _slot_kind(cfg, j) == "attn":
        kv = None if state is None else {"k": state["k"], "v": state["v"],
                                         "pos": pos}
        out, _ = L.attention_apply(
            blk["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            d_head=cfg.d_head, positions=positions, cfg=jcfg,
            window=cfg.sliding_window, rope_theta=cfg.rope_theta,
            kv_cache=kv, rolling=cfg.sliding_window is not None,
            q_chunk=cfg.attn_q_chunk, mesh=mesh)
    else:
        out, new_state = L.mamba2_apply(
            blk["ssm"], h, d_state=cfg.ssm_state, n_heads=cfg.ssm_heads,
            head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
            conv_kernel=cfg.ssm_conv, chunk=cfg.ssm_chunk, cfg=jcfg,
            state=state, mesh=mesh)
    x = x + out
    h = L.rmsnorm_apply(blk["ffn_norm"], x, mesh=mesh)
    if "moe" in blk:
        # decode (a state given): never drop tokens (capacity >= tokens)
        cf = cfg.capacity_factor if state is None else float(cfg.n_experts)
        out, a = L.moe_apply(blk["moe"], h, top_k=cfg.top_k,
                             capacity_factor=cf, cfg=jcfg, mesh=mesh)
        aux = aux + a
    else:
        out = L.ffn_apply(blk["ffn"], h, jcfg)
    return x + out, new_state, aux


def apply(params, batch, cfg: ModelConfig,
          jcfg: JigsawConfig = DEFAULT_JIGSAW
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits [B, S, vocab_padded] of ``batch["tokens"]``
    [B, S], and the MoE layers' summed aux loss (f32).  With ``cfg.remat``
    and autograd recording, each period is checkpointed
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of
    its scan body over the periods): only its inputs are kept, and its
    slots run again in the backward (the MoE routing has nothing random,
    so it routes the same).  Under ``scheme="1d"`` (a 1-D model mesh) the
    rank's blocks, as ``transformer.apply``'s: the residual stream
    [B, S, D/p] and the vocab block of the logits."""
    x = L.embed_apply(params["embed"], batch["tokens"], mesh=L.mesh_1d(jcfg))
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def period(pp, x, aux):
        for j in range(cfg.attn_every):
            x, _, aux = _slot_apply(pp[f"slot{j}"], x, j, cfg, jcfg,
                                    positions, aux)
        return x, aux
    remat = cfg.remat and torch.is_grad_enabled()
    for pp in params["periods"]:
        x, aux = (checkpoint(period, pp, x, aux, use_reentrant=False)
                  if remat else period(pp, x, aux))
    return _lm_head(params, x, cfg, jcfg), aux


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """The decode cache, zeros, the reference's layout: {"pos" [B],
    "slots": {"slot{j}": ...}}, each slot's buffers stacked over the
    periods.  Attention slots: "k", "v" [n_periods, B, S, Hkv, hd] in
    ``dtype`` (S = min(window, max_len) under a sliding window, else
    max_len); SSM slots, O(1) in the sequence: "conv" [n_periods, B, K-1,
    conv_dim] in the dtype the step writes (``mamba.conv_dtype``) and
    "ssm" [n_periods, B, H, P, N] in f32."""
    n_periods = _n_periods(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("hybrid.init_cache: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    w = cfg.sliding_window
    s = min(max_len, w) if w is not None else max_len
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    lead = (n_periods, batch_size)
    slots = {}
    for j in range(cfg.attn_every):
        if _slot_kind(cfg, j) == "attn":
            kv = lead + (s, cfg.n_kv_heads, cfg.d_head)
            slots[f"slot{j}"] = {
                "k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device)}
        else:
            slots[f"slot{j}"] = {
                "conv": torch.zeros(lead + (cfg.ssm_conv - 1, conv_dim),
                                    dtype=conv_dtype(cfg, dtype),
                                    device=device),
                "ssm": torch.zeros(lead + (cfg.ssm_heads, cfg.ssm_head_dim,
                                           cfg.ssm_state),
                                   dtype=torch.float32, device=device)}
    return {"pos": torch.zeros((batch_size,), dtype=torch.int32,
                               device=device),
            "slots": slots}


def decode_step(params, cache, tokens, cfg: ModelConfig,
                jcfg: JigsawConfig = DEFAULT_JIGSAW):
    """One token per row: tokens [B, 1] -> (logits [B, 1, vocab_padded],
    cache).  The periods run in order, each slot on its own buffers of the
    period; every buffer is written in place (the reference donates the
    cache to XLA), "pos" is advanced in place, and the same dict is
    returned.  An SSM slot's conv window must be in the dtype the step
    writes (``init_cache`` makes it so): a narrower one raises rather than
    rounding the window."""
    x = L.embed_apply(params["embed"], tokens)
    pos = cache["pos"]
    positions = pos[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, pp in enumerate(params["periods"]):
        for j in range(cfg.attn_every):
            buf = cache["slots"][f"slot{j}"]
            state = {k: v[p] for k, v in buf.items()}
            x, ns, _ = _slot_apply(pp[f"slot{j}"], x, j, cfg, jcfg,
                                   positions, zero, state=state, pos=pos)
            if ns is not None:
                if ns["conv"].dtype != buf["conv"].dtype:
                    raise TypeError(
                        f"decode_step: slot{j}'s conv window is "
                        f"{ns['conv'].dtype}, the cache's "
                        f"{buf['conv'].dtype}; make the cache with "
                        "init_cache")
                state["conv"].copy_(ns["conv"])
                state["ssm"].copy_(ns["ssm"])
    logits = _lm_head(params, x, cfg, jcfg)
    pos += 1
    return logits, cache
