"""WeatherMixer: the paper's MLP-Mixer atmospheric model, undistributed.

The port of ``repro/models/weathermixer.py`` for ``scheme="none"``:
encoder (patch conv as a reshaped linear) -> N mixing blocks (token-mix MLP
over spatial tokens, channel-mix MLP over latent channels, LayerNorm +
residual around each) -> decoder (un-patch linear) -> learned blend with
the input.  Parameters are a dict of tensors as in the reference, except
that ``params["blocks"]`` is a list with one dict per block where the
reference stacks the blocks on a leading layer dim (``convert.py`` maps
between the two).  Under ``kernel="pallas"`` every GEMM of a forecast step
runs the hand-written block_matmul kernel: 2 + 4 * n_layers launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import (DEFAULT_JIGSAW, JigsawConfig, linear_apply,
                                  linear_init, mlp_apply)
from repro_torch.core.precision import dtype_of
from repro_torch.models import layers as L


def n_tokens(cfg: ModelConfig) -> int:
    return (cfg.wm_lat // cfg.wm_patch) * (cfg.wm_lon // cfg.wm_patch)


def patch_dim(cfg: ModelConfig) -> int:
    return cfg.wm_patch * cfg.wm_patch * cfg.wm_channels


def block_init(gen: torch.Generator, cfg: ModelConfig, device):
    t, d = n_tokens(cfg), cfg.d_model
    dtype = dtype_of(cfg.param_dtype)
    return {
        "tok_norm": L.layernorm_init(d, device=device),
        "tok_fc1": linear_init(gen, t, cfg.wm_d_tok, dtype=dtype,
                               device=device),
        "tok_fc2": linear_init(gen, cfg.wm_d_tok, t, dtype=dtype,
                               device=device),
        "ch_norm": L.layernorm_init(d, device=device),
        "ch_fc1": linear_init(gen, d, cfg.wm_d_ch, dtype=dtype,
                              device=device),
        "ch_fc2": linear_init(gen, cfg.wm_d_ch, d, dtype=dtype,
                              device=device),
    }


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Fresh weights on ``device`` from a ``torch.Generator`` seeded with
    ``seed``: LeCun-normal weights stored [d_out, d_in] in
    ``cfg.param_dtype``, zero biases, LayerNorm scale 1 / bias 0, blend 0.
    Raises when ``device`` is CUDA and there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("weathermixer.init: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = dtype_of(cfg.param_dtype)
    pd = patch_dim(cfg)
    return {
        "encoder": linear_init(gen, pd, cfg.d_model, dtype=dtype,
                               device=device),
        "blocks": [block_init(gen, cfg, device)
                   for _ in range(cfg.n_layers)],
        "decoder": linear_init(gen, cfg.d_model, pd, dtype=dtype,
                               device=device),
        "blend": torch.zeros((cfg.wm_channels,), dtype=torch.float32,
                             device=device),
    }


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, lat, lon, C] -> [B, T, p*p*C] over non-overlapping windows."""
    b, lat, lon, c = x.shape
    x = x.reshape(b, lat // p, p, lon // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (lat // p) * (lon // p), p * p * c)


def unpatchify(x: torch.Tensor, lat: int, lon: int, p: int, c: int
               ) -> torch.Tensor:
    b = x.shape[0]
    x = x.reshape(b, lat // p, lon // p, p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, lat, lon, c)


def _token_mix(bp, x: torch.Tensor, jcfg: JigsawConfig) -> torch.Tensor:
    """Token-mixing MLP contracting the token dim of x [B, T, C]: the
    transpose is materialised (``contiguous``) so both GEMMs see row-major
    operands; the result is handed back as a transposed view."""
    xt = x.transpose(-1, -2).contiguous()                  # [B, C, T]
    h = mlp_apply({"fc1": bp["tok_fc1"], "fc2": bp["tok_fc2"]}, xt, jcfg)
    return h.transpose(-1, -2)


def _block_apply(bp, x: torch.Tensor, jcfg: JigsawConfig) -> torch.Tensor:
    h = L.layernorm_apply(bp["tok_norm"], x)
    x = x + _token_mix(bp, h, jcfg)
    h = L.layernorm_apply(bp["ch_norm"], x)
    m = mlp_apply({"fc1": bp["ch_fc1"], "fc2": bp["ch_fc2"]}, h, jcfg)
    return x + m


def processor(params, x: torch.Tensor, jcfg: JigsawConfig,
              rollout: int = 1) -> torch.Tensor:
    """The mixing-block stack, applied ``rollout`` times (encode/decode
    happen once).  ``cfg.remat`` has no effect: nothing is differentiated
    when serving."""
    for _ in range(rollout):
        for bp in params["blocks"]:
            x = _block_apply(bp, x, jcfg)
    return x


def apply(params, batch, cfg: ModelConfig,
          jcfg: JigsawConfig = DEFAULT_JIGSAW, *, rollout: int = 1
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"fields": [B, lat, lon, C]} -> (forecast of the same shape,
    aux = 0)."""
    if jcfg.scheme != "none":
        raise NotImplementedError("only scheme='none' is ported")
    xin = batch["fields"]
    p = cfg.wm_patch
    x = L.boundary_cast(patchify(xin, p), jcfg)            # [B, T, p*p*C]
    h = linear_apply(params["encoder"], x, jcfg)           # [B, T, d]
    h = processor(params, h, jcfg, rollout=rollout)
    y = linear_apply(params["decoder"], h, jcfg)           # [B, T, p*p*C]
    y = unpatchify(y, cfg.wm_lat, cfg.wm_lon, p, cfg.wm_channels)
    # the exit boundary: blend in the INPUT dtype (f32) even under a bf16
    # compute policy
    y = y.to(xin.dtype)
    lam = torch.sigmoid(params["blend"]).to(y.dtype)
    out = lam * xin + (1.0 - lam) * y
    return out, torch.zeros((), dtype=torch.float32, device=xin.device)


def forecast_step(params, fields: torch.Tensor, cfg: ModelConfig,
                  jcfg: JigsawConfig = DEFAULT_JIGSAW) -> torch.Tensor:
    """One serving rollout step: fields [B, lat, lon, C] -> fields at +dt."""
    out, _ = apply(params, {"fields": fields}, cfg, jcfg, rollout=1)
    return out
