"""The losses of ``repro/train/loss.py``: the weather loss (latitude- and
pressure-level-weighted MSE) with its per-rank part on a Jigsaw mesh, and
the language models' next-token cross-entropy, whole or over logits cut by
vocab on a 1-D model mesh (``lm_nll_sharded``)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import comm


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


def block_weights(lat_w: torch.Tensor, chan_w: Optional[torch.Tensor], *,
                  lon: int, patch: int, channels: int, rows: range,
                  cols: range):
    """The latitude and channel weight of each element of a block in patch
    space [T, p*p*C]: token rows ``rows``, patch-dim columns ``cols``.
    Token t lies in latitude-patch row t // (lon / p); patch-dim index k
    holds in-patch row (k // C) // p and channel k % C.  Returns (lat [len
    rows, len cols], chan [len cols] or None)."""
    dev = lat_w.device
    tok = torch.as_tensor(rows, device=dev)
    k = torch.as_tensor(cols, device=dev)
    lat = (tok // (lon // patch))[:, None] * patch \
        + ((k // channels) // patch)[None, :]
    return lat_w[lat], None if chan_w is None else chan_w[k % channels]


def weighted_sse(pred: torch.Tensor, target: torch.Tensor,
                 lat_w: torch.Tensor, chan_w: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The weighted sum of squared errors over a block (pred/target
    [B, ...], weights broadcast over the batch), in f32: divided by the
    element count of the whole field and summed over the blocks of all
    ranks, ``weighted_mse`` of the whole field."""
    err = (pred.float() - target.float()) ** 2
    err = err * lat_w
    if chan_w is not None:
        err = err * chan_w
    return err.sum()


def lm_nll(logits: torch.Tensor, labels: torch.Tensor,
           vocab_size: int) -> torch.Tensor:
    """The next-token NLL of every position [B, S], in f32.  logits
    [B, S, Vp] (Vp >= vocab_size: the padded ids get -1e30 added), labels
    [B, S] int.  The gold logit is picked by comparison with an iota, not a
    gather, as the reference's."""
    vp = logits.shape[-1]
    logits = logits.float()
    ids = torch.arange(vp, device=logits.device)
    if vp > vocab_size:
        logits = logits + torch.where(ids >= vocab_size, -1e30, 0.0)
    logz = torch.logsumexp(logits, dim=-1)
    onehot = ids == labels[..., None]
    gold = torch.where(onehot, logits, 0.0).sum(dim=-1)
    return logz - gold


class _ShardedNLL(torch.autograd.Function):
    """``lm_nll`` of logits cut by vocab over a group: the forward's three
    reductions over the vocab are all-reduced (the row max with MAX, the
    sum of exponentials and the gold logit with SUM, all in f32); the
    backward is local, the rank's block of softmax minus one-hot."""

    @staticmethod
    def forward(ctx, logits, labels, vocab_size, group, offset):
        z = logits.float()
        ids = offset + torch.arange(z.shape[-1], device=z.device)
        if offset + z.shape[-1] > vocab_size:
            z = z + torch.where(ids >= vocab_size, -1e30, 0.0)
        m = comm.all_reduce_max_(z.amax(dim=-1), group)
        e = torch.exp(z - m[..., None])
        onehot = ids == labels[..., None]
        sums = comm.all_reduce_(torch.stack(
            [e.sum(dim=-1), torch.where(onehot, z, 0.0).sum(dim=-1)]), group)
        ctx.save_for_backward(e, sums[0], onehot)
        ctx.dtype = logits.dtype
        return torch.log(sums[0]) + m - sums[1]

    @staticmethod
    def backward(ctx, dnll):
        e, total, onehot = ctx.saved_tensors
        grad = dnll[..., None] * (e / total[..., None] - onehot.float())
        return grad.to(ctx.dtype), None, None, None, None


def lm_nll_sharded(logits: torch.Tensor, labels: torch.Tensor,
                   vocab_size: int, mesh) -> torch.Tensor:
    """``lm_nll`` of the rank's vocab block of the logits [B, S, Vp/p] on a
    1-D model mesh (rank r holds ids [r Vp/p, (r + 1) Vp/p); the padded ids
    >= ``vocab_size``, in the last ranks' blocks, get -1e30), the same [B,
    S] f32 on every rank of the tp group.  Differentiable: the gradient of
    the NLL flows into the rank's block only, with no collective (the
    reference's elementwise loss that GSPMD keeps cut)."""
    return _ShardedNLL.apply(logits, labels, vocab_size, mesh.tp_group,
                             mesh.tp_index * logits.shape[-1])


def lm_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                     vocab_size: int,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The mean NLL (``lm_nll``) over the positions, or with ``mask``
    ``sum(nll * mask) / max(sum(mask), 1)``."""
    nll = lm_nll(logits, labels, vocab_size)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
