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

ZeRO-1 (``Zero1``) keeps only this data rank's slice of each leaf's
moments and masters; the step runs on the slices and all-gathers the
fresh parameters over the data group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import comm
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


@dataclasses.dataclass(frozen=True)
class Zero1:
    """ZeRO-1's cut of the optimizer state over the data axis (DESIGN.md
    §6.5): ``dims``, a tree of the params' structure holding the dim each
    leaf's state is cut along (None: whole on every data rank;
    ``launch/specs.py::zero1_dims``); this rank's ``index`` among the
    ``parts`` data ranks, and their process ``group``."""
    dims: Any
    index: int
    parts: int
    group: Any

    def take(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's slice of ``t`` along ``dim`` (all of it for None)."""
        if dim is None:
            return t
        n = t.shape[dim] // self.parts
        return t.narrow(dim, self.index * n, n)


def init(params, cfg: AdamConfig, zero1: Optional[Zero1] = None):
    """Zero moments (and f32 masters) for ``params``; under ``zero1`` each
    leaf's state is this rank's slice of it."""
    def zeros_like(p, dim=None):
        if cfg.master_weights:
            dt = torch.float32               # moments ride the masters' f32
        else:
            dt = dtype_of(cfg.state_dtype) if cfg.state_dtype else p.dtype
        return torch.zeros(_take(p, dim, zero1).shape, dtype=dt,
                           device=p.device)
    dims = _dims(params, zero1)
    state = {"step": 0,
             "mu": ptree.map(zeros_like, params, dims),
             "nu": ptree.map(zeros_like, params, dims)}
    if cfg.master_weights:
        state["master"] = ptree.map(
            lambda p, dim: _take(p, dim, zero1).detach().to(
                torch.float32, copy=True), params, dims)
    return state


def _dims(params, zero1: Optional[Zero1]):
    return zero1.dims if zero1 is not None \
        else ptree.map(lambda _: None, params)


def _take(t, dim, zero1: Optional[Zero1]):
    return t if zero1 is None else zero1.take(t, dim)


def state_bytes(state) -> int:
    """This rank's bytes of optimizer state: moments and masters."""
    return sum(t.numel() * t.element_size()
               for k in ("mu", "nu", "master") if k in state
               for t in ptree.leaves(state[k]))


def global_norm(tree, *, owned=None, group=None, pieces=None,
                data: int = 1) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-dim tensor on
    the leaves' device).  For a tree of shards: ``owned`` (a tree of bools
    of the same structure) names the leaves this rank counts, and the
    partial sum is all-reduced over ``group`` first.

    With ``pieces`` (a mesh of ``data`` > 1 data ranks, ``group`` every
    rank in rank order, data outermost) each leaf's squares are summed in
    ``data`` pieces along a dim: ``pieces`` holds per leaf (dim, held),
    dim None for one piece, held the index of the one piece this rank's
    leaf is (the FSDP hybrid's block), or None where it holds them all.
    Every rank's [leaves, data] sums are gathered, each piece is taken from
    the one rank that counted it, and they are added in one fixed order,
    so the norm's bits do not depend on which rank held a piece."""
    leaves = ptree.leaves(tree)
    counted = ptree.leaves(owned) if owned is not None else [True] * len(
        leaves)
    if pieces is None:
        sums = [g.float().square().sum() for g, c in zip(leaves, counted)
                if c]
        # a rank may count no leaf (a replica on a data-only mesh)
        total = (torch.stack(sums).sum() if sums
                 else torch.zeros((), device=leaves[0].device))
        return torch.sqrt(comm.all_reduce_(total, group))

    def squares(t):
        return t.float().square().sum()

    rows = []
    for g, c, (dim, held) in zip(leaves, counted, ptree.leaves(pieces)):
        row = torch.zeros(data, dtype=torch.float32, device=g.device)
        if c and dim is None:
            row[0] = squares(g)
        elif c and held is not None:
            row[held] = squares(g)
        elif c:
            row = torch.stack([squares(part)
                               for part in g.chunk(data, dim)])
        rows.append(row)
    mine = torch.stack(rows)                        # [leaves, data]
    every = torch.stack(comm.all_gather_list(mine, group))
    # [data ranks, model ranks, leaves, pieces]: one rank counted each
    # piece, so the sum over data ranks adds zeros to it, exactly
    every = every.view(data, -1, *mine.shape).sum(0)
    return torch.sqrt(every.sum())


def clip_by_global_norm(grads, max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """Scale every gradient by ``min(1, max_norm / max(norm, 1e-12))`` in
    f32 and cast it back to its own dtype.  Returns (clipped, norm)."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return ptree.map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def update(params, grads, state, lr: float, cfg: AdamConfig,
           norm: Optional[torch.Tensor] = None,
           zero1: Optional[Zero1] = None):
    """One AdamW step, in place.  ``norm`` is the global norm of ``grads``
    when the caller has it already.  Under ``zero1`` (the state made by
    ``init`` with the same) a leaf cut along a dim takes the step on this
    rank's slice of its gradient and state alone, and the fresh parameter
    slices are all-gathered over the data group in rank order into the
    whole local parameter: the update is elementwise, so the parameters
    and the state are bit for bit those of the step without it.  Returns
    (params, state), the same objects."""
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
    for p, g, mu, nu, master, dim in zip(
            ptree.leaves(params), ptree.leaves(grads),
            ptree.leaves(state["mu"]), ptree.leaves(state["nu"]), flat_ma,
            ptree.leaves(_dims(params, zero1))):
        gf = _take(g, dim, zero1).float()
        mu_n = b1 * mu.float() + (1 - b1) * gf
        nu_n = b2 * nu.float() + (1 - b2) * gf * gf
        delta = (mu_n / c1) / (torch.sqrt(nu_n / c2) + cfg.eps)
        # f32 base: the master when present, else the param itself
        base = master if master is not None \
            else _take(p, dim, zero1).float()
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * base
        p_n = base - lr * delta
        if dim is None:
            p.copy_(p_n)
        else:
            p.copy_(torch.cat(comm.all_gather_list(p_n.to(p.dtype),
                                                   zero1.group), dim))
        mu.copy_(mu_n)
        nu.copy_(nu_n)
        if master is not None:
            master.copy_(p_n)
    state["step"] = step
    return params, state
