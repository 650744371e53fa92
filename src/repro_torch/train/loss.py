"""The weather loss: latitude- and pressure-level-weighted MSE (the port's
copy of the mixer half of ``repro/train/loss.py``)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def latitude_weights(lat_points: int, device=None) -> torch.Tensor:
    """cos(latitude) weights, normalized to mean 1 (WeatherBench2
    convention); grid rows span +90..-90 degrees.  Computed in float64,
    handed out in float32, as the reference."""
    lats = np.linspace(90.0, -90.0, lat_points)
    w = np.maximum(np.cos(np.deg2rad(lats)), 0.0)
    w = w / w.mean()
    return torch.tensor(w, dtype=torch.float32, device=device)


def pressure_level_weights(channels: int, n_surface: int = 4,
                           n_vars: int = 5, n_levels: int = 13,
                           device=None) -> torch.Tensor:
    """The paper's per-channel weights: surface variables 1 and, from high
    to low pressure levels, [1,1,1,1,1,1,.9,.8,.7,.6,.5,.4,.3] per
    variable."""
    lvl = np.array([1, 1, 1, 1, 1, 1, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3])
    w = np.ones(channels)
    for v in range(n_vars):
        lo = n_surface + v * n_levels
        hi = min(lo + n_levels, channels)
        w[lo:hi] = lvl[: hi - lo]
    return torch.tensor(w, dtype=torch.float32, device=device)


def weighted_mse(pred: torch.Tensor, target: torch.Tensor,
                 lat_w: Optional[torch.Tensor] = None,
                 chan_w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """pred/target: [B, lat, lon, C]; the mean in f32."""
    err = (pred.float() - target.float()) ** 2
    if lat_w is not None:
        err = err * lat_w[None, :, None, None]
    if chan_w is not None:
        err = err * chan_w[None, None, None, :]
    return err.mean()
