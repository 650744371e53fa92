"""Differentiable collectives of the 1-D and 2-D paths on
``torch.distributed``.

The reference writes them as ``jax.lax.ppermute`` / ``psum`` /
``psum_scatter`` / GSPMD reshards and lets JAX's AD transpose them.  Here
each is an ``autograd.Function`` whose backward is the transposed
collective:

  ``rotate(x, group, shift)``  every rank of ``group`` sends x to the rank
      ``shift`` positions below and receives from the rank ``shift`` above
      (one ``batch_isend_irecv``); its backward is the opposite rotation.
      ``ring_shift(x, group)`` is the 1-D ring's hop, rank i's x to rank
      i + 1 (the reference's ``ppermute`` with perm i -> i+1);
  ``all_reduce(x, group)``  the sum over ``group`` on every rank; its
      backward sums the gradients over ``group``, since each rank consumes
      the sum for its own part of the one global loss (``all_reduce_`` and
      ``all_reduce_max_`` the in-place sum and MAX outside autograd);
  ``all_gather(x, group, dim)``  every rank's x concatenated along ``dim``
      in rank order, in one library call (the ring form of the same
      gather, the reference's ``_rank_order_all_gather``, is
      ``kernels/fused_ring.py::ring_all_gather``); its backward is the
      reduce-scatter of the cotangent; ``gather_shards`` is the same gather
      of a parameter's shards (the FSDP hybrid), reduce-scattering in f32;
  ``reduce_scatter(x, group, dim)``  the sum over ``group``, of which rank
      r keeps chunk r along ``dim`` (``psum_scatter(tiled=True)``, the 1-D
      ``rs`` impl); its backward is the all-gather;
  ``all_to_all(x, group, split_dim, cat_dim)``  x cut into p chunks along
      ``split_dim``, chunk s sent to rank s, and what arrives concatenated
      along ``cat_dim`` in rank order: moves the sharded dim from
      ``cat_dim`` to ``split_dim`` (the token mix's reshard under 1-D, the
      all-to-all GSPMD makes of the reference's ``constrain``); its
      backward moves it back.

Positions are ranks within ``group``; the peers of a ``P2POp`` are global
ranks (``dist.get_global_rank``).  A ``group`` of None (a one-rank mesh)
makes each the identity.  Every rank of a group must call each collective
in the same order; the forward and the backward of a training step do.

Gloo runs every collective on the host.  Ranks that share one card run
under gloo (NCCL refuses two ranks on one device: ``launch/mesh.py``), so
under a gloo group every collective on CUDA tensors crosses host memory,
in one of two ways chosen by the collective (not by catching an error):
gloo's own CUDA work copies the collectives of ``GLOO_CUDA_OPS`` into
pinned host memory and back; the others (point-to-point) this module
copies to the host and back itself.  ``through_host`` counts both kinds of
call and ``through_host_bytes`` the bytes each copied, keyed
``"<op>/gloo"`` or ``"<op>/comm"`` by who made the copies.
"""
from __future__ import annotations

import collections
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

# the collectives gloo takes on CUDA tensors (staging them through pinned
# host memory itself), as probed on an H100 under torch 2.11
# (tests/test_torch_cuda.py::test_gloo_device_collectives): all but
# point-to-point, whose send of a device pointer aborts the process
GLOO_CUDA_OPS = frozenset({"all_reduce", "all_gather", "reduce_scatter",
                           "all_to_all"})
through_host: collections.Counter = collections.Counter()
through_host_bytes: collections.Counter = collections.Counter()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _collective(op: str, fn: Callable, out: torch.Tensor, group,
                *inputs: torch.Tensor) -> torch.Tensor:
    """``fn(out, *inputs)``; under gloo on CUDA tensors counted in
    ``through_host``, and copied through the host here when gloo does not
    take the op on the device (in place when ``out`` is one of the
    inputs)."""
    if not (out.is_cuda and dist.get_backend(group) == "gloo"):
        fn(out, *inputs)
        return out
    key = f"{op}/{'gloo' if op in GLOO_CUDA_OPS else 'comm'}"
    through_host[key] += 1
    through_host_bytes[key] += _nbytes(out) + sum(map(_nbytes, inputs))
    if op in GLOO_CUDA_OPS:
        fn(out, *inputs)
        return out
    host_in = [t.cpu() for t in inputs]
    host_out = next((h for t, h in zip(inputs, host_in) if t is out),
                    None)
    if host_out is None:
        host_out = torch.empty(out.shape, dtype=out.dtype)
    fn(host_out, *host_in)
    return out.copy_(host_out)


def barrier(group) -> None:
    """Every rank of ``group`` has reached this point (NCCL: on the
    current device)."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


def _rotate(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    q = dist.get_world_size(group)
    me = dist.get_rank(group)
    x = x.contiguous()

    def p2p(out, src):
        ops = [dist.P2POp(dist.isend, src,
                          dist.get_global_rank(group, (me - shift) % q),
                          group),
               dist.P2POp(dist.irecv, out,
                          dist.get_global_rank(group, (me + shift) % q),
                          group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _collective("send_recv", p2p, torch.empty_like(x), group, x)


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


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """One ring hop: rank i of ``group`` gets the x of rank i - 1."""
    return rotate(x, group, -1)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _collective("all_reduce",
                       lambda o, _: dist.all_reduce(o, group=group), x,
                       group, x)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy.clone(), ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over ``group``, differentiable."""
    if group is None:
        return x
    return _AllReduce.apply(x, group)


def all_reduce_(x: torch.Tensor, *groups) -> torch.Tensor:
    """In-place sum over each of ``groups`` in turn (None: none) outside
    autograd (gradients, metrics); a bf16 tensor is summed in f32 and
    rounded once, after the last group."""
    groups = [g for g in groups if g is not None]
    if not groups:
        return x
    acc = x.float().contiguous()         # x itself when f32 and contiguous
    for group in groups:
        _all_reduce(acc, group)
    return x if acc is x else x.copy_(acc)


def all_reduce_max_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place elementwise MAX over ``group`` (None: none), outside
    autograd."""
    if group is None:
        return x
    return _collective(
        "all_reduce", lambda o, _: dist.all_reduce(o, op=dist.ReduceOp.MAX,
                                                   group=group), x, group, x)


def _gather_stacked(x: torch.Tensor, group) -> torch.Tensor:
    """[p, *x.shape]: every rank's x in rank order."""
    p = dist.get_world_size(group)
    flat = x.contiguous().reshape(-1)
    out = torch.empty(p * flat.numel(), dtype=x.dtype, device=x.device)
    _collective("all_gather",
                lambda o, i: dist.all_gather_into_tensor(o, i, group=group),
                out, group, flat)
    return out.view(p, *x.shape)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return torch.cat(_gather_stacked(x, group).unbind(0), dim=dim)


def _scatter_sum(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    p = dist.get_world_size(group)
    if x.shape[dim] % p:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} is "
                         f"not divisible by {p}")
    parts = torch.stack(x.chunk(p, dim=dim))          # [p, ...] contiguous
    out = torch.empty(parts.shape[1:], dtype=x.dtype, device=x.device)
    _collective("reduce_scatter",
                lambda o, i: dist.reduce_scatter_tensor(o, i, group=group),
                out.view(-1), group, parts.view(-1))
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return _scatter_sum(dy, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter_sum(x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy, ctx.group, ctx.dim), None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, dy):
        return _scatter_sum(dy.float(), ctx.group, ctx.dim).to(dy.dtype), \
            None, None


def gather_shards(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """A parameter's shards (the FSDP hybrid's out-dim blocks) gathered
    over ``group`` along ``dim`` in rank order, differentiable: the
    backward reduce-scatters the cotangent in f32 and rounds it once, as
    ``all_reduce_`` sums the gradient of a parameter each rank holds whole,
    so the two layouts give a rank the same gradient bits (a two-rank sum
    is one IEEE addition either way)."""
    if group is None:
        return x
    return _GatherShards.apply(x, group, dim % x.dim())


def all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every rank's x concatenated along ``dim`` in rank order;
    differentiable (the backward is the reduce-scatter)."""
    if group is None:
        return x
    return _AllGather.apply(x, group, dim % x.dim())


def reduce_scatter(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Chunk r along ``dim`` of the sum of x over ``group``, on rank r;
    differentiable (the backward is the all-gather)."""
    if group is None:
        return x
    return _ReduceScatter.apply(x, group, dim % x.dim())


def _swap(x: torch.Tensor, group, split_dim: int, cat_dim: int
          ) -> torch.Tensor:
    p = dist.get_world_size(group)
    if x.shape[split_dim] % p:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"is not divisible by {p}")
    parts = torch.stack(x.chunk(p, dim=split_dim))    # [p, ...] contiguous
    out = torch.empty_like(parts)
    _collective("all_to_all",
                lambda o, i: dist.all_to_all_single(o, i, group=group), out,
                group, parts)
    return torch.cat(out.unbind(0), dim=cat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.args = (group, cat_dim, split_dim)
        return _swap(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, dy):
        return _swap(dy, *ctx.args), None, None, None


def all_to_all(x: torch.Tensor, group, split_dim: int, cat_dim: int
               ) -> torch.Tensor:
    """x (this rank's chunk of a whole along ``cat_dim``) -> this rank's
    chunk along ``split_dim``, whole along ``cat_dim``; differentiable."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_dim % x.dim(), cat_dim % x.dim())


def all_gather_list(x: torch.Tensor, group: Optional[object]
                    ) -> List[torch.Tensor]:
    """x of every rank of ``group``, in group-rank order (outside
    autograd)."""
    if group is None:
        return [x]
    return list(_gather_stacked(x, group).unbind(0))
