"""Differentiable collectives of the 2-D path on ``torch.distributed``.

The reference writes them as ``jax.lax.ppermute`` / GSPMD reductions and
lets JAX's AD transpose them.  Here each is an ``autograd.Function`` whose
backward is the transposed collective:

  ``rotate(x, group, shift)``  every rank of ``group`` sends x to the rank
      ``shift`` positions below and receives from the rank ``shift`` above
      (one ``batch_isend_irecv``); its backward is the opposite rotation;
  ``all_reduce(x, group)``  the sum over ``group`` on every rank; its
      backward sums the gradients over ``group``, since each rank consumes
      the sum for its own part of the one global loss.

Positions are ranks within ``group``; the peers of a ``P2POp`` are global
ranks (``dist.get_global_rank``).  A ``group`` of None (the 1x1 mesh)
makes each the identity.  Every rank of a group must call each collective
in the same order; the forward and the backward of a training step do.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist


def _rotate(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    q = dist.get_world_size(group)
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (me - shift) % q), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me + shift) % q), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _rotate(x, group, shift)

    @staticmethod
    def backward(ctx, dy):
        return _rotate(dy, ctx.group, -ctx.shift), None, None


def rotate(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Rank r of ``group`` gets the x of rank (r + shift) mod size."""
    if group is None or shift % dist.get_world_size(group) == 0:
        return x
    return _Rotate.apply(x, group, shift)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, dy):
        g = dy.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over ``group``, differentiable."""
    if group is None:
        return x
    return _AllReduce.apply(x, group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` outside autograd (gradients, metrics);
    a bf16 tensor is summed in f32 and rounded once."""
    if group is None:
        return x
    acc = x.float().contiguous()         # x itself when f32 and contiguous
    dist.all_reduce(acc, group=group)
    return x if acc is x else x.copy_(acc)


def all_gather(x: torch.Tensor, group: Optional[object]
               ) -> List[torch.Tensor]:
    """x of every rank of ``group``, in group-rank order (outside
    autograd)."""
    if group is None:
        return [x]
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x.contiguous(), group=group)
    return out
