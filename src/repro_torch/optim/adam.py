"""Adam with global-norm clipping and optional f32 master weights, written
by hand (the port's copy of ``repro/optim/adam.py``; not
``torch.optim.AdamW``, whose clip and state layout differ).

The reference's update is functional and donates its buffers; here the
parameters, moments and masters are updated in place (``copy_`` of the
f32 result into each leaf), so a step never holds a second copy of the
optimizer state: at weathermixer-1b's size that copy would be 16 GB.

With ``master_weights=True`` the state carries an f32 master of every
parameter (a copy, never an alias of an f32 parameter) and f32 moments;
the update runs in f32 from the masters and is rounded into the parameter.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import tree as ptree
from repro_torch.core.precision import dtype_of


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: Optional[str] = None    # None -> same as param dtype
    grad_clip: Optional[float] = 1.0     # global-norm clip (paper: 1.0)
    master_weights: bool = False         # f32 masters + f32 moments


def init(params, cfg: AdamConfig):
    def zeros_like(p):
        if cfg.master_weights:
            dt = torch.float32               # moments ride the masters' f32
        else:
            dt = dtype_of(cfg.state_dtype) if cfg.state_dtype else p.dtype
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    state = {"step": 0,
             "mu": ptree.map(zeros_like, params),
             "nu": ptree.map(zeros_like, params)}
    if cfg.master_weights:
        state["master"] = ptree.map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-dim tensor on
    the leaves' device)."""
    sums = [g.float().square().sum() for g in ptree.leaves(tree)]
    return torch.sqrt(torch.stack(sums).sum())


def clip_by_global_norm(grads, max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-12))`` in
    f32 and cast it back to its own dtype.  Returns (clipped, norm)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return ptree.map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def update(params, grads, state, lr: float, cfg: AdamConfig,
           norm: Optional[torch.Tensor] = None):
    """One AdamW step, in place.  ``norm`` is the global norm of ``grads``
    when the caller has it already.  Returns (params, state), the same
    objects."""
    if cfg.grad_clip is not None:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip, norm)
    step = state["step"] + 1
    b1, b2 = cfg.b1, cfg.b2
    f32 = torch.float32
    # bias corrections in f32, as the reference's b ** step.astype(f32)
    c1 = float(1.0 - torch.tensor(b1, dtype=f32) ** step)
    c2 = float(1.0 - torch.tensor(b2, dtype=f32) ** step)
    masters = state.get("master")
    flat_ma = (ptree.leaves(masters) if masters is not None
               else [None] * len(ptree.leaves(params)))
    for p, g, mu, nu, master in zip(
            ptree.leaves(params), ptree.leaves(grads),
            ptree.leaves(state["mu"]), ptree.leaves(state["nu"]), flat_ma):
        gf = g.float()
        mu_n = b1 * mu.float() + (1 - b1) * gf
        nu_n = b2 * nu.float() + (1 - b2) * gf * gf
        delta = (mu_n / c1) / (torch.sqrt(nu_n / c2) + cfg.eps)
        # f32 base: the master when present, else the param itself
        base = master if master is not None else p.float()
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * base
        p_n = base - lr * delta
        p.copy_(p_n)
        mu.copy_(mu_n)
        nu.copy_(nu_n)
        if master is not None:
            master.copy_(p_n)
    state["step"] = step
    return params, state
