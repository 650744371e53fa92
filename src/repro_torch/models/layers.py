"""Shared building blocks of the port (``repro/models/layers.py``): the
LayerNorm and the precision boundary cast.  Plain PyTorch: none of them is
a kernel in the reference either.  Norms compute in f32 and cast back."""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core import comm
from repro_torch.core.api import JigsawConfig
from repro_torch.core.sharding import Mesh, Mesh1D


def boundary_cast(x: torch.Tensor, cfg: JigsawConfig) -> torch.Tensor:
    """Cast a model-entry tensor to the policy compute dtype so the whole
    residual stream carries it.  No-op when no compute dtype is set."""
    if cfg.compute_dtype is None:
        return x
    return x.to(cfg.compute_dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5,
                    mesh: Optional[Union[Mesh, Mesh1D]] = None
                    ) -> torch.Tensor:
    """LayerNorm over the last dim.  With ``mesh`` (scheme="1d" or "2d")
    that dim is the rank's block of it along the tp axis: the mean and then
    the mean of squared deviations over the whole dim are written out as
    the reductions GSPMD makes of the reference's: an all-reduce over the
    tp group of the row sums, then of the centred square sums, both in
    f32.  The scale and bias are replicated; each rank applies its slice of
    them."""
    xf = x.float()
    scale, bias = params["scale"], params["bias"]
    if mesh is None:
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    else:
        dl = xf.shape[-1]
        d = dl * mesh.tp_size
        mu = comm.all_reduce(xf.sum(dim=-1, keepdim=True), mesh.tp_group) / d
        var = comm.all_reduce(((xf - mu) ** 2).sum(dim=-1, keepdim=True),
                              mesh.tp_group) / d
        scale = scale.narrow(0, mesh.tp_index * dl, dl)
        bias = bias.narrow(0, mesh.tp_index * dl, dl)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)
