"""whisper-small: the encoder-decoder audio transformer (the port of
``repro/models/encdec.py``; arXiv:2212.04356).

The modality frontend (mel spectrogram and the two-conv feature extractor)
is a stub in the reference too: the batch carries frame embeddings
[B, n_frames, d_model].  The backbone: a bidirectional encoder over the
frames (sinusoidal positions) and a causal decoder (a learned table of
4,096 positions, read at ``position % 4096``) whose layers attend to the
encoder's states; LayerNorm, GELU FFN, attention biases, no RoPE, the
tied LM head.  Under ``kernel="pallas"`` every linear (q, k, v, o of the
self- and cross-attention, the FFN with its GELU in the first GEMM's
epilogue, the head) is a block_matmul launch.

Parameters follow the port's convention: ``"enc_layers"`` and
``"dec_layers"`` are lists of per-layer dicts where the reference stacks
the layers on a leading dim (``convert.py`` maps between the two).  With
``cfg.remat`` and autograd recording, each encoder and decoder layer is
checkpointed (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint`` of its scan body.

Serving: ``init_cache`` makes {"pos", "k", "v", "enc"}; ``start_cache``
writes the encoder's states into ``cache["enc"]`` before the first prompt
token (``serve/step.py``'s ``extra_batch={"frames": ...}``), and
``decode_step`` takes one token per row, writing k and v in place with
every slot computed on the device from ``pos``, so the step can be
captured in a CUDA graph.  As in
the reference, the decode step recomputes every layer's cross-attention
k and v from ``cache["enc"]``.  There is no fused prefill (the reference
has none): ``serve/step.py`` prefills token by token.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import DEFAULT_JIGSAW, JigsawConfig
from repro_torch.core.precision import dtype_of
from repro_torch.models import layers as L

POS_TABLE = 4096   # rows of the decoder's learned position table


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal encoder positions [length, channels], in f32."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] \
        * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig, device):
    dtype = dtype_of(cfg.param_dtype)
    return {
        "attn_norm": L.layernorm_init(cfg.d_model, device=device),
        "attn": L.attention_init(gen, cfg.d_model, cfg.n_heads,
                                 cfg.n_kv_heads, cfg.d_head, dtype=dtype,
                                 bias=True, device=device),
        "ffn_norm": L.layernorm_init(cfg.d_model, device=device),
        "ffn": L.ffn_init(gen, cfg.d_model, cfg.d_ff, kind="gelu",
                          dtype=dtype, bias=True, device=device),
    }


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig, device):
    p = _enc_layer_init(gen, cfg, device)
    p["cross_norm"] = L.layernorm_init(cfg.d_model, device=device)
    p["cross"] = L.attention_init(gen, cfg.d_model, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.d_head,
                                  dtype=dtype_of(cfg.param_dtype), bias=True,
                                  device=device)
    return p


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Fresh weights on ``device`` from a ``torch.Generator`` seeded with
    ``seed``, in ``cfg.param_dtype`` (the norms in f32): the reference's
    tree, shapes and dtypes.  Raises when ``device`` is CUDA and there is
    no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("encdec.init: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model,
                              dtype=dtype, device=device)}
    params["dec_pos"] = (torch.randn((POS_TABLE, cfg.d_model), generator=gen,
                                     dtype=torch.float32, device=device)
                         * 0.01).to(dtype)
    params["enc_layers"] = [_enc_layer_init(gen, cfg, device)
                            for _ in range(cfg.n_enc_layers)]
    params["enc_norm"] = L.layernorm_init(cfg.d_model, device=device)
    params["dec_layers"] = [_dec_layer_init(gen, cfg, device)
                            for _ in range(cfg.n_layers)]
    params["dec_norm"] = L.layernorm_init(cfg.d_model, device=device)
    return params


def _norm(p, x, jcfg: JigsawConfig):
    return L.layernorm_apply(p, x, mesh=L.mesh_1d(jcfg))


def _attn(p, x, cfg: ModelConfig, jcfg: JigsawConfig, positions, **kw):
    return L.attention_apply(
        p, x, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.d_head, positions=positions, cfg=jcfg, rope_theta=None,
        mesh=L.mesh_1d(jcfg), **kw)


def _enc_layer(lp, h, cfg: ModelConfig, jcfg: JigsawConfig, positions):
    a = _norm(lp["attn_norm"], h, jcfg)
    out, _ = _attn(lp["attn"], a, cfg, jcfg, positions, causal=False,
                   q_chunk=cfg.attn_q_chunk)
    h = h + out
    f = _norm(lp["ffn_norm"], h, jcfg)
    return h + L.ffn_apply(lp["ffn"], f, jcfg)


def _remat(cfg: ModelConfig) -> bool:
    """Checkpoint each layer: ``cfg.remat`` while autograd records."""
    return cfg.remat and torch.is_grad_enabled()


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           jcfg: JigsawConfig = DEFAULT_JIGSAW) -> torch.Tensor:
    """frames [B, n_frames, d_model] (the stub embeddings) -> the encoder's
    states, in the frames' dtype (the residual stream's).  Under
    ``scheme="1d"`` the frames and the states are the rank's feature
    block [B, n_frames, d_model / p], which takes its block of the
    sinusoids."""
    _, s, d = frames.shape
    pos = sinusoids(s, cfg.d_model, device=frames.device)
    if d != cfg.d_model:        # the rank's block of the features
        pos = pos.narrow(1, L.mesh_1d(jcfg).tp_index * d, d)
    x = frames + pos[None].to(frames.dtype)
    positions = torch.arange(s, device=frames.device)
    remat = _remat(cfg)
    for lp in params["enc_layers"]:
        layer = partial(_enc_layer, cfg=cfg, jcfg=jcfg, positions=positions)
        x = (checkpoint(layer, lp, x, use_reentrant=False) if remat
             else layer(lp, x))
    return _norm(params["enc_norm"], x, jcfg)


def _dec_layer(lp, x, enc, cfg: ModelConfig, jcfg: JigsawConfig, positions,
               kv_cache=None):
    """One decoder layer: causal self-attention (on ``kv_cache`` in a
    decode step), cross-attention to ``enc``, the FFN.  Returns (x, the
    self-attention's new cache or None)."""
    a = _norm(lp["attn_norm"], x, jcfg)
    out, nc = _attn(lp["attn"], a, cfg, jcfg, positions, causal=True,
                    kv_cache=kv_cache,
                    q_chunk=0 if kv_cache is not None else cfg.attn_q_chunk)
    x = x + out
    c = _norm(lp["cross_norm"], x, jcfg)
    out, _ = _attn(lp["cross"], c, cfg, jcfg, positions, causal=False,
                   x_kv=enc,
                   q_chunk=0 if positions.ndim > 1 else cfg.attn_q_chunk)
    x = x + out
    f = _norm(lp["ffn_norm"], x, jcfg)
    return x + L.ffn_apply(lp["ffn"], f, jcfg), nc


def _dec_pos(params, positions: torch.Tensor, dtype) -> torch.Tensor:
    """The learned positions at ``positions % 4096`` (whisper's ceiling is
    448 tokens; longer sequences wrap, as the reference's); under
    ``scheme="1d"`` the table is the rank's [4096, D/p] block of it."""
    table = params["dec_pos"]
    return table[torch.remainder(positions, table.shape[0]).long()].to(dtype)


def apply(params, batch, cfg: ModelConfig,
          jcfg: JigsawConfig = DEFAULT_JIGSAW
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The teacher-forced forward.  batch: {"frames": [B, F, D] (the stub),
    "tokens": [B, S]}.  Returns the logits [B, S, vocab_padded] and the
    reference's aux loss (f32 0).

    Under ``scheme="1d"`` (a 1-D model mesh) the rank's blocks: the frames
    [B, F, D/p] in, the residual streams of the encoder and the decoder
    cut on D, every norm over the cut features, self and cross attention
    on the rank's heads (cross attention's k and v from the encoder
    states' block through ``jigsaw_linear``; the biases cut on their out
    dim), the tied head's vocab block of the logits [B, S, V/p] out."""
    enc = encode(params, batch["frames"], cfg, jcfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    x = L.embed_apply(params["embed"], tokens, mesh=L.mesh_1d(jcfg))
    x = x + _dec_pos(params, positions, x.dtype)[None]
    remat = _remat(cfg)
    for lp in params["dec_layers"]:
        layer = partial(_dec_layer, cfg=cfg, jcfg=jcfg, positions=positions)
        x, _ = (checkpoint(layer, lp, x, enc, use_reentrant=False) if remat
                else layer(lp, x, enc))
    x = _norm(params["dec_norm"], x, jcfg)
    logits = L.unembed_apply(params["embed"], x, jcfg)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """The decode cache, zeros, the reference's layout: "pos" [B] int32,
    the decoder's self-attention "k" and "v" [L, B, max_len, Hkv, hd], and
    the encoder's states "enc" [B, n_frames, D] (filled once, before the
    first prompt token)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("encdec.init_cache: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    kv = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.d_head)
    return {
        "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device),
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "enc": torch.zeros((batch_size, cfg.n_frames, cfg.d_model),
                           dtype=dtype, device=device),
    }


@torch.no_grad()
def start_cache(params, cache, extra_batch: dict, cfg: ModelConfig,
                jcfg: JigsawConfig = DEFAULT_JIGSAW):
    """Write the encoder's states of ``extra_batch["frames"]`` into a fresh
    cache's "enc", in place, cast to its dtype (once, before the first
    prompt token)."""
    cache["enc"].copy_(encode(params, extra_batch["frames"], cfg, jcfg))


def decode_step(params, cache, tokens, cfg: ModelConfig,
                jcfg: JigsawConfig = DEFAULT_JIGSAW):
    """One token per row: tokens [B, 1] -> (logits [B, 1, vocab_padded],
    cache).  Each layer's k and v are written into ``cache``'s tensors in
    place at slot ``min(pos, max_len - 1)``, and "pos" is advanced in
    place; the same dict is returned.  Every layer's cross-attention
    projects ``cache["enc"]`` anew, as the reference's step does."""
    pos = cache["pos"]
    x = L.embed_apply(params["embed"], tokens)
    x = x + _dec_pos(params, pos, x.dtype)[:, None, :]
    positions = pos[:, None]
    enc = cache["enc"].to(x.dtype)
    for i, lp in enumerate(params["dec_layers"]):
        x, _ = _dec_layer(lp, x, enc, cfg, jcfg, positions,
                          kv_cache={"k": cache["k"][i], "v": cache["v"][i],
                                    "pos": pos})
    x = L.layernorm_apply(params["dec_norm"], x)
    logits = L.unembed_apply(params["embed"], x, jcfg)
    pos += 1
    return logits, cache
