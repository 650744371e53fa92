"""The decoder-only transformer LM: the dense, VLM and moe families
(``internlm2-1.8b``, ``h2o-danube-1.8b``, ``stablelm-3b``, ``gemma3-27b``,
``pixtral-12b``, ``dbrx-132b``, ``phi3.5-moe-42b-a6.6b``).

The port of ``repro/models/transformer.py``: token embedding (after the
VLM's patch embeddings, when given) -> n_layers of (norm, attention,
residual, norm, FFN or MoE, residual) -> final norm -> the LM head (tied, or its
own ``lm_head``).  Parameters are a dict of tensors as in the reference,
except that ``params["layers"]`` is a list with one dict per layer where
the reference stacks the layers on a leading dim for ``lax.scan``
(``convert.py`` maps between the two).  A layer's attention window is a
Python int (``FULL_WINDOW`` for full causal attention), where the
reference traces it into the scan body.

Serving: ``init_cache`` makes the KV cache, ``prefill_cache`` fills it
from one teacher-forced forward (uniform stacks), and ``decode_step``
takes one token per row, writing the cache in place with every slot and
mask computed on the device from ``cache["pos"]``, so ``serve/step.py``
can capture it in a CUDA graph.  Under ``kernel="pallas"`` every linear
(q, k, v, o, the FFN's or the MoE router, the head) is a block_matmul
launch; the experts' products are plain einsums, as the reference's.  A
MoE layer routes with ``cfg.capacity_factor`` in ``apply`` and
``prefill_cache`` (tokens past an expert's capacity are dropped) and
with ``n_experts`` in ``decode_step`` (the reference's rule: a decode
step never drops), and ``apply`` returns the sum of their aux losses.

``scheme="1d"`` (training on a 1-D Jigsaw model mesh; ``jcfg.mesh`` a
``Mesh1D`` of p ranks): each rank holds its
shard of the parameters by the reference's 1-D layout (``param_spec_1d``:
every ``w`` cut along its contracting dim, the head's and the embedding
table's vocab rows cut, the expert stacks cut on their expert dim, the
norms' scales and the router whole) and the residual stream's block
[B, S, D/p].  The embedding looks up the rank's vocab rows and
reduce-scatters over D; every linear of a layer is ``jigsaw_linear`` (a
reduce-scatter by ``jcfg.impl``), the attention runs the rank's heads
(``layers.attention_apply``), a MoE layer the rank's experts on the
all-gathered features (``layers.moe_apply``: expert parallelism), the
norms all-reduce their row sums over the
tp group; the head all-gathers the features and returns the rank's vocab
block of the logits [B, S, V/p] (``core/api.py::head_apply``), which the
loss reduces over the tp group (``train/loss.py::lm_nll_sharded``).  The
VLM's ``embeds`` arrive as the rank's [B, P, D/p] block.

Serving on a 1-D model mesh: ``init_cache(mesh=)`` makes the rank's block
of the cache (``layers.cache_block``: the layout of the reference's
``cache_specs``, sanitized: the kv heads on the model axis where p divides
them, else the sequence, the batch's rows over data), ``prefill_cache``
runs the fused forward on the rank's blocks and writes each layer's k and
v into it, and ``decode_step`` runs the embedding, every layer and the
head on the rank's blocks, each attention on its cache leaf's layout (the
reference's ``_kv_spec``: ``layers.kv_layout``).
"""
from __future__ import annotations

from functools import partial
from typing import Any, List, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import (DEFAULT_JIGSAW, JigsawConfig, head_apply,
                                  linear_init)
from repro_torch.core.precision import dtype_of
from repro_torch.core.sharding import MODEL_AXIS, Spec
from repro_torch.models import layers as L

FULL_WINDOW = 2 ** 30   # no sliding window
# leaves every rank of a model mesh holds whole (the reference's
# ``_REPLICATED``: the norms' scales and biases, Mamba-2's A_log, D and
# dt_bias; ``pos``; its depthwise conv's bias, which no rule of the
# reference's cuts)
_REPLICATED = {"scale", "bias", "pos", "A_log", "D", "dt_bias", "conv_b"}


def param_spec_1d(path: Sequence[Any], ndim: int) -> Spec:
    """The 1-D spec of the leaf at ``path`` in any language model's tree
    (the 1-D rule of ``repro/launch/specs.py:41-107``, without the FSDP
    hybrid's data entries): every ``w`` [out, in] on its contracting
    (last) dim but the untied head's, which cuts its vocab (out) dim, as
    the embedding ``table`` [V, D] does; every ``b`` on its (last) dim;
    the MoE's expert stacks [E, F, D] / [E, D, F] on their expert dim
    (expert parallelism); Mamba-2's ``conv_w`` [K, conv_dim] and whisper's
    ``dec_pos`` [4096, D] on their last dim; the router, the norms'
    ``scale`` and ``bias`` (the qk-norm's too), Mamba-2's ``A_log``,
    ``D``, ``dt_bias`` and ``conv_b``, and ``pos`` whole."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    dims: list = [None] * ndim
    if name in _REPLICATED or parent == "router":
        return tuple(dims)
    if (name == "w" and parent == "lm_head") or name == "table":
        dims[-2] = MODEL_AXIS
    elif name in ("w", "b", "conv_w", "dec_pos"):
        dims[-1] = MODEL_AXIS
    elif parent == "experts":
        dims[-3] = MODEL_AXIS
    else:
        raise ValueError(f"no 1-D layout for parameter "
                         f"{'/'.join(map(str, path))}")
    return tuple(dims)


# the parameter layout of each sharded scheme
PARAM_SPECS = {"1d": param_spec_1d}


def _norm_init(cfg: ModelConfig, d: int, device):
    return (L.layernorm_init(d, device=device) if cfg.norm == "layernorm"
            else L.rmsnorm_init(d, device=device))


def _norm_apply(cfg: ModelConfig, p, x, mesh=None):
    """The config's norm; with ``mesh`` over the rank's block of the
    features."""
    return (L.layernorm_apply(p, x, mesh=mesh) if cfg.norm == "layernorm"
            else L.rmsnorm_apply(p, x, mesh=mesh))


def layer_init(gen: torch.Generator, cfg: ModelConfig, device):
    """One decoder layer's params: the reference's tree."""
    dtype = dtype_of(cfg.param_dtype)
    p = {
        "attn_norm": _norm_init(cfg, cfg.d_model, device),
        "attn": L.attention_init(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.d_head, dtype=dtype,
                                 bias=cfg.attn_bias, device=device),
        "ffn_norm": _norm_init(cfg, cfg.d_model, device),
    }
    if cfg.qk_norm:
        p["qk_norm"] = {"q": L.rmsnorm_init(cfg.d_head, device=device),
                        "k": L.rmsnorm_init(cfg.d_head, device=device)}
    if cfg.is_moe_layer(0):      # the uniform-MoE stacks (dbrx, phi3.5)
        p["moe"] = L.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                              kind=cfg.ffn_kind, dtype=dtype, device=device)
    else:
        p["ffn"] = L.ffn_init(gen, cfg.d_model, cfg.d_ff, kind=cfg.ffn_kind,
                              dtype=dtype, device=device)
    return p


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Fresh weights on ``device`` from a ``torch.Generator`` seeded with
    ``seed``, in ``cfg.param_dtype`` (the norms in f32, as the
    reference's).  Raises when ``device`` is CUDA and there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("transformer.init: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model, dtype=dtype,
                              device=device),
        "layers": [layer_init(gen, cfg, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": _norm_init(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_padded,
                                        dtype=dtype, bias=False,
                                        device=device)
    return params


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Each layer's attention window (``FULL_WINDOW``: full causal)."""
    return [FULL_WINDOW if w is None else w
            for w in (cfg.layer_window(i) for i in range(cfg.n_layers))]


def _layer_apply(lp, x, *, cfg: ModelConfig, jcfg: JigsawConfig, positions,
                 window: int, kv_cache=None, rolling=False, collect_kv=False,
                 aux_in=0.0, mesh=None, kv_layout=None):
    """One decoder layer: (x, the layer's new cache or collected k/v, the
    aux loss ``aux_in`` plus the MoE layer's).  With ``mesh`` (a 1-D model
    mesh) x is the rank's feature block, the attention runs the rank's
    heads (on its cache block laid out as ``kv_layout`` says) and the MoE
    the rank's experts."""
    h = _norm_apply(cfg, lp["attn_norm"], x, mesh)
    attn_out, new_cache = L.attention_apply(
        lp["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.d_head, positions=positions, cfg=jcfg, window=window,
        rope_theta=cfg.rope_theta, soft_cap=cfg.attn_soft_cap,
        kv_cache=kv_cache, rolling=rolling, collect_kv=collect_kv,
        qk_norm=lp.get("qk_norm"), q_chunk=cfg.attn_q_chunk, mesh=mesh,
        kv_layout=kv_layout)
    x = x + attn_out
    h = _norm_apply(cfg, lp["ffn_norm"], x, mesh)
    if "moe" in lp:
        # decode: a few tokens in flight; never drop (capacity >= tokens)
        cf = cfg.capacity_factor if kv_cache is None else float(cfg.n_experts)
        out, aux = L.moe_apply(lp["moe"], h, top_k=cfg.top_k,
                               capacity_factor=cf, cfg=jcfg, mesh=mesh)
        aux_in = aux_in + aux
    else:
        out = L.ffn_apply(lp["ffn"], h, jcfg)
    return x + out, new_cache, aux_in


def _head(params, x, cfg: ModelConfig, jcfg: JigsawConfig, mesh=None):
    """The final norm and the head (tied or ``lm_head``): under
    ``scheme="1d"`` the rank's vocab block of the logits."""
    x = _norm_apply(cfg, params["final_norm"], x, mesh)
    if cfg.tie_embeddings:
        return L.unembed_apply(params["embed"], x, jcfg)
    return head_apply(params["lm_head"]["w"], x, jcfg)


def apply(params, batch, cfg: ModelConfig,
          jcfg: JigsawConfig = DEFAULT_JIGSAW
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The teacher-forced forward.  batch: {"tokens": [B, S]} (and, for
    the VLM, "embeds": [B, P, D], the vision frontend's patch embeddings,
    put before the text).  Returns the logits [B, P + S, vocab_padded] and
    the reference's aux loss (f32: the MoE layers' sum, 0 without them).
    Under ``scheme="1d"`` the rank's blocks: ``embeds`` [B, P, D/p] in,
    the logits' vocab block [B, P + S, vocab_padded / p] out.
    With ``cfg.remat`` and autograd recording, each layer is checkpointed
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of
    its scan body): only its inputs are kept, and its forward runs again
    in the backward (the MoE routing has nothing random, so it routes the
    same)."""
    mesh = L.mesh_1d(jcfg)
    x = L.embed_apply(params["embed"], batch["tokens"], mesh=mesh)
    if batch.get("embeds") is not None:
        x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp, w in zip(params["layers"], layer_windows(cfg)):
        layer = partial(_layer_apply, cfg=cfg, jcfg=jcfg,
                        positions=positions, window=w, mesh=mesh)
        x, _, aux = (checkpoint(layer, lp, x, aux_in=aux,
                                use_reentrant=False) if remat
                     else layer(lp, x, aux_in=aux))
    return _head(params, x, cfg, jcfg, mesh), aux


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _period(cfg: ModelConfig) -> int:
    """Length of the repeating layer pattern (1 for uniform stacks)."""
    return cfg.local_global_ratio + 1 if cfg.local_global_ratio > 0 else 1


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", mesh=None):
    """The KV cache, zeros, the reference's layout.

    Uniform stacks: {"pos", "k", "v"}, k and v [L, B, S, Hkv, hd]; where
    every layer has a sliding window, S = min(window, max_len) and the
    slots roll.  Local:global stacks (gemma3): ``n_periods`` repeats of
    (ratio local layers + 1 global one); the local layers' rolling buffers
    "lk"/"lv" [n_periods, ratio, B, w, Hkv, hd] (w = min(local_window,
    max_len)), the global ones' "gk"/"gv" [n_periods, B, max_len, Hkv,
    hd], and the layers left over after the last whole period (depth %
    period, all local) "rk"/"rv" [leftover, B, w, Hkv, hd].

    With ``mesh`` (a 1-D model mesh) the rank's block of the cache of the
    whole batch ``batch_size``, and nothing else, is allocated
    (``layers.cache_block``, a ``CacheBlock``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("transformer.init_cache: CUDA is not available; "
                           "pass device='cpu' to run on the CPU")
    if mesh is not None:
        return L.cache_block(init_cache(cfg, batch_size, max_len, dtype,
                                        device="meta"), cfg, mesh, device)

    def zeros(*lead, s):
        return torch.zeros(lead + (batch_size, s, cfg.n_kv_heads,
                                   cfg.d_head), dtype=dtype, device=device)

    pos = torch.zeros((batch_size,), dtype=torch.int32, device=device)
    per = _period(cfg)
    if per == 1:
        w = cfg.sliding_window
        s = min(max_len, w) if w is not None else max_len
        return {"pos": pos, "k": zeros(cfg.n_layers, s=s),
                "v": zeros(cfg.n_layers, s=s)}
    n_per, leftover = divmod(cfg.n_layers, per)
    w = min(cfg.local_window or max_len, max_len)
    ratio = cfg.local_global_ratio
    cache = {"pos": pos,
             "lk": zeros(n_per, ratio, s=w), "lv": zeros(n_per, ratio, s=w),
             "gk": zeros(n_per, s=max_len), "gv": zeros(n_per, s=max_len)}
    if leftover:
        cache["rk"] = zeros(leftover, s=w)
        cache["rv"] = zeros(leftover, s=w)
    return cache


def prefill_cache(params, batch, cfg: ModelConfig, jcfg: JigsawConfig,
                  max_len: int, dtype=torch.bfloat16):
    """The fused prefill: one teacher-forced forward over the prompt that
    also writes every layer's post-RoPE k and v into a fresh cache, where
    token p lands at slot ``p % S`` (a rolling cache keeps the last S
    tokens), as the token-wise decode steps would have put it.  Returns
    (logits [B, S_prompt, V], cache) with "pos" = S_prompt.

    Under ``scheme="1d"`` (a 1-D model mesh) ``batch["tokens"]`` is the
    whole batch: the rank runs its rows (``layers.rows_block``) through
    the mesh forward (``apply``'s blocks) and returns its block of the
    logits [B_rank, S_prompt, V/p] and of the cache (``init_cache(mesh=)``),
    into which each layer's k and v go as the cache's layout holds them:
    the rank's kv heads, or, where the sequence is cut, the tokens whose
    slots are the rank's.

    Uniform stacks only: local:global stacks (gemma3) and VLM embeds raise
    NotImplementedError, as the reference's, and ``serve/step.py`` then
    prefills token by token.  A prompt longer than a non-rolling cache
    raises ValueError."""
    if _period(cfg) != 1:
        raise NotImplementedError("fused prefill: uniform layer stacks "
                                  "only (local:global falls back)")
    if batch.get("embeds") is not None:
        raise NotImplementedError("fused prefill: text prompts only")
    mesh = L.mesh_1d(jcfg)
    tokens = batch["tokens"]
    cache = init_cache(cfg, tokens.shape[0], max_len, dtype,
                       device=tokens.device, mesh=mesh)
    tokens = L.rows_block(tokens, mesh)
    s = tokens.shape[1]
    layout = L.kv_layout(cache, ("k",), mesh)
    seq = layout == "seq"
    s_blk = cache["k"].shape[2]
    s_max = s_blk * mesh.tp_size if seq else s_blk
    if cfg.sliding_window is None and s > s_max:
        raise ValueError(f"prompt length {s} > cache max_len {s_max}")
    m = min(s, s_max)   # a rolling cache keeps only the last window
    slots = torch.arange(s - m, s, device=tokens.device) % s_max
    src = torch.arange(s - m, s, device=tokens.device)
    if seq:             # the tokens whose slots are this rank's
        lo = mesh.tp_index * s_blk
        own = (slots >= lo) & (slots < lo + s_blk)
        slots, src = slots[own] - lo, src[own]
    x = L.embed_apply(params["embed"], tokens, mesh=mesh)
    positions = torch.arange(s, device=x.device)
    for i, (lp, w) in enumerate(zip(params["layers"], layer_windows(cfg))):
        x, kv, _ = _layer_apply(lp, x, cfg=cfg, jcfg=jcfg,
                                positions=positions, window=w,
                                collect_kv=True, mesh=mesh,
                                kv_layout=layout)
        cache["k"][i][:, slots] = kv["k"][:, src].to(dtype)
        cache["v"][i][:, slots] = kv["v"][:, src].to(dtype)
    cache["pos"].fill_(s)
    return _head(params, x, cfg, jcfg, mesh), cache


def decode_step(params, cache, tokens, cfg: ModelConfig,
                jcfg: JigsawConfig = DEFAULT_JIGSAW):
    """One token per row: tokens [B, 1] -> (logits [B, 1, vocab_padded],
    cache).  Every layer's k and v are written into ``cache``'s tensors in
    place (the reference donates the cache to XLA) and "pos" is advanced
    in place; the same dict is returned.  Local:global stacks run their
    layers in order: each period's local layers on their rolling buffers,
    then its global layer, then the leftover local layers.  Under
    ``scheme="1d"`` the rank's blocks: its rows of the tokens, its block
    of the cache (a ``CacheBlock``), its vocab block of the logits [B, 1,
    vocab_padded / p]."""
    mesh = L.mesh_1d(jcfg)
    x = L.embed_apply(params["embed"], tokens, mesh=mesh)
    pos = L.rows_block(cache["pos"], mesh)      # "pos" is whole: the rows'
    positions = pos[:, None]

    def run(lp, h, window, key, index, rolling):
        kc, vc = cache[key][index], cache[key[:-1] + "v"][index]
        h, _, _ = _layer_apply(lp, h, cfg=cfg, jcfg=jcfg,
                               positions=positions, window=window,
                               kv_cache={"k": kc, "v": vc, "pos": pos},
                               rolling=rolling, mesh=mesh,
                               kv_layout=L.kv_layout(cache, (key,), mesh))
        return h

    layers = params["layers"]
    per = _period(cfg)
    if per == 1:
        rolling = cfg.sliding_window is not None
        for i, (lp, w) in enumerate(zip(layers, layer_windows(cfg))):
            x = run(lp, x, w, "k", i, rolling)
    else:
        n_per = cfg.n_layers // per
        ratio = cfg.local_global_ratio
        for p in range(n_per):
            for j in range(per):
                lp = layers[p * per + j]
                if j < ratio:
                    x = run(lp, x, cfg.local_window, "lk", (p, j), True)
                else:
                    x = run(lp, x, FULL_WINDOW, "gk", p, False)
        for r, lp in enumerate(layers[n_per * per:]):
            x = run(lp, x, cfg.local_window, "rk", r, True)
    logits = _head(params, x, cfg, jcfg, mesh)
    cache["pos"] += 1
    return logits, cache
