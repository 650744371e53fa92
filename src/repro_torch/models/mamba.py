"""mamba2-130m: the attention-free SSM language model (SSD, arXiv:2405.21060).

The port of ``repro/models/mamba.py``: token embedding -> n_layers of
(RMSNorm, Mamba-2 mixer, residual) -> final RMSNorm -> the tied LM head.
Parameters are a dict of tensors as in the reference, except that
``params["layers"]`` is a list with one dict per layer where the reference
stacks the layers on a leading dim for ``lax.scan`` (``convert.py`` maps
between the two).

``apply`` is the teacher-forced forward: under ``kernel="pallas"`` its
4 * n_layers + 1 linears run the block_matmul kernel, and each layer's
intra-chunk SSD term one launch of the ssd_chunk kernel (and, in training,
one launch of its backward kernel, ssd_chunk_bwd).  ``decode_step`` is
the recurrent single-token step (no SSD launch); it writes the cache that
``init_cache`` made in place, and allocates nothing that outlives it, so
``serve/step.py`` can capture it in a CUDA graph.  On a 1-D model mesh
(``scheme="1d"``) ``init_cache(mesh=)`` makes the rank's block of the
state (the conv window's channel block and the SSM state's heads, as the
reference's ``cache_specs`` lays them out) and ``decode_step`` runs the
embedding, each mixer, the final norm and the vocab-parallel head on the
rank's blocks.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import DEFAULT_JIGSAW, JigsawConfig
from repro_torch.core.precision import dtype_of, policy_of
from repro_torch.models import layers as L


def layer_init(gen: torch.Generator, cfg: ModelConfig, device):
    return {
        "norm": L.rmsnorm_init(cfg.d_model, device=device),
        "mixer": L.mamba2_init(gen, cfg.d_model, d_state=cfg.ssm_state,
                               n_heads=cfg.ssm_heads,
                               head_dim=cfg.ssm_head_dim,
                               conv_kernel=cfg.ssm_conv,
                               n_groups=cfg.ssm_groups,
                               expand=cfg.ssm_expand,
                               dtype=dtype_of(cfg.param_dtype),
                               device=device),
    }


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Fresh weights on ``device`` from a ``torch.Generator`` seeded with
    ``seed``, in ``cfg.param_dtype`` (A_log, D, dt_bias and the residual
    norms in f32, as the reference's).  Raises when ``device`` is CUDA and
    there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mamba.init: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model,
                              dtype=dtype_of(cfg.param_dtype), device=device),
        "layers": [layer_init(gen, cfg, device)
                   for _ in range(cfg.n_layers)],
        "final_norm": L.rmsnorm_init(cfg.d_model, device=device),
    }


def _mixer(lp, x, cfg: ModelConfig, jcfg: JigsawConfig, state=None):
    mesh = L.mesh_1d(jcfg)
    h = L.rmsnorm_apply(lp["norm"], x, mesh=mesh)
    out, new_state = L.mamba2_apply(
        lp["mixer"], h, d_state=cfg.ssm_state, n_heads=cfg.ssm_heads,
        head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
        conv_kernel=cfg.ssm_conv, chunk=cfg.ssm_chunk, cfg=jcfg,
        state=state, mesh=mesh)
    return x + out, new_state


def apply(params, batch, cfg: ModelConfig,
          jcfg: JigsawConfig = DEFAULT_JIGSAW
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced logits [B, S, vocab_padded] of ``batch["tokens"]``
    [B, S], and the reference's aux loss (0).  With ``cfg.remat`` and
    autograd recording, each layer is checkpointed
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint`` of
    its scan body): only its input is kept, and its forward, the SSD
    kernel's launch among it, runs again in the backward.

    Under ``scheme="1d"`` (a 1-D model mesh) the rank's blocks, as
    ``transformer.apply``'s: the embedding's vocab rows reduce-scattered
    over D, the residual stream [B, S, D/p], each mixer on the rank's
    heads (``layers.mamba2_apply``), the norms over the cut features, and
    the tied head's vocab block of the logits [B, S, vocab_padded / p]."""
    mesh = L.mesh_1d(jcfg)
    x = L.embed_apply(params["embed"], batch["tokens"], mesh=mesh)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        x, _ = (checkpoint(_mixer, lp, x, cfg, jcfg, use_reentrant=False)
                if remat else _mixer(lp, x, cfg, jcfg))
    x = L.rmsnorm_apply(params["final_norm"], x, mesh=mesh)
    logits = L.unembed_apply(params["embed"], x, jcfg)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def conv_dtype(cfg: ModelConfig, dtype=torch.bfloat16) -> torch.dtype:
    """The dtype of the conv window that ``decode_step`` writes into a
    cache of ``dtype``: ``dtype`` promoted with the activations' (the
    policy's compute dtype; the params' under the legacy policy, which
    casts nothing), as the reference's concatenate of the window and the
    new token promotes.  bf16 -> f32 is exact."""
    pol = policy_of(cfg)
    act = pol.param_dtype if pol.name == "legacy" else pol.compute_dtype
    return torch.promote_types(dtype, act)


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", mesh=None):
    """The decode state, O(1) in sequence length: per layer the conv window
    [B, K-1, conv_dim] in ``conv_dtype(cfg, dtype)`` (``dtype``, or the
    activations' where those are wider: the dtype the step writes) and the
    SSM state [B, H, P, N] in f32, stacked on a leading layer dim as in the
    reference.  With ``mesh`` (a 1-D model mesh) the rank's block of the
    state of the whole batch ``batch_size``: the conv window's contiguous
    block of channels [L, B, K-1, conv_dim/p] and the state's heads [L, B,
    H/p, P, N] (``layers.cache_block``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("mamba.init_cache: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    if mesh is not None:
        return L.cache_block(init_cache(cfg, batch_size, max_len, dtype,
                                        device="meta"), cfg, mesh, device)
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return {
        "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device),
        "conv": torch.zeros((cfg.n_layers, batch_size, cfg.ssm_conv - 1,
                             conv_dim), dtype=conv_dtype(cfg, dtype),
                            device=device),
        "ssm": torch.zeros((cfg.n_layers, batch_size, cfg.ssm_heads,
                            cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def decode_step(params, cache, tokens, cfg: ModelConfig,
                jcfg: JigsawConfig = DEFAULT_JIGSAW):
    """One token per row: logits [B, 1, vocab_padded] and the cache.

    The new states are written into ``cache``'s tensors in place (the
    reference donates the cache to XLA), and the same dict is returned.
    The conv window must be in the dtype the step writes
    (``conv_dtype``, as ``init_cache`` makes it): a narrower one raises
    rather than rounding the window.  Under ``scheme="1d"`` the rank's
    blocks: its rows of the tokens, its block of the state, its vocab
    block of the logits [B, 1, vocab_padded / p]."""
    mesh = L.mesh_1d(jcfg)
    x = L.embed_apply(params["embed"], tokens, mesh=mesh)
    conv, ssm = cache["conv"], cache["ssm"]
    for i, lp in enumerate(params["layers"]):
        x, ns = _mixer(lp, x, cfg, jcfg,
                       state={"conv": conv[i], "ssm": ssm[i]})
        if ns["conv"].dtype != conv.dtype:
            raise TypeError(f"decode_step: the conv window is "
                            f"{ns['conv'].dtype}, the cache's {conv.dtype}; "
                            "make the cache with init_cache")
        conv[i].copy_(ns["conv"])
        ssm[i].copy_(ns["ssm"])
    x = L.rmsnorm_apply(params["final_norm"], x, mesh=mesh)
    logits = L.unembed_apply(params["embed"], x, jcfg)
    cache["pos"] += 1
    return logits, cache
