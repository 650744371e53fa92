"""Shared building blocks of the port (``repro/models/layers.py``): the
LayerNorm and the precision boundary cast.  Plain PyTorch: none of them is
a kernel in the reference either.  Norms compute in f32 and cast back."""
from __future__ import annotations

import torch

from repro_torch.core.api import JigsawConfig


def boundary_cast(x: torch.Tensor, cfg: JigsawConfig) -> torch.Tensor:
    """Cast a model-entry tensor to the policy compute dtype so the whole
    residual stream carries it.  No-op when no compute dtype is set."""
    if cfg.compute_dtype is None:
        return x
    return x.to(cfg.compute_dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)
