"""2-D Jigsaw: the paper's 4-way scheme generalised to a q x q mesh, with
Cannon's algorithm on ``torch.distributed`` (the 2-D half of
``repro/core/jigsaw.py``).

The reference runs each product inside ``shard_map`` on a named mesh; here
each process is one rank and calls these functions on its own blocks.
Rank (i, j) sits at mdom coordinate i and mtp coordinate j (``Mesh``).

``jigsaw_linear_2d`` (X @ W.T, the encoder, channel mix and decoder):
  x: [..., n/q, d/q]  block X(i, j)   (n on mdom, d on mtp)
  w: [m/q, d/q]       block W(j, i)   (Cannon layout: out on mtp, in on mdom)
  y: [..., n/q, m/q]  block Y(i, j)   -- the layout of x: layers compose.
``jigsaw_linear_2d_t`` (W @ X contracting X's second-to-last dim, the token
mix: the paper's "transposed MLP", no transpose materialised):
  x: [..., t/q, c/q]  block X(i, j)   (t on mdom, c on mtp)
  w: [m/q, t/q]       block W(i, j)
  y: [..., m/q, c/q]  block Y(i, j).

Schedule (both): skew each operand along one axis by the rank's index on
the other (the reference's ``_skew``: q - 1 conditional shifts there, one
rotation by the known index here, the same blocks), then q multiply-
accumulate steps with a rotation by one of both operands between steps.
The wire carries the operands in their (policy-cast) dtype; the q-step
accumulator is ``accum_dtype``.  Differentiable: each rotation's backward
is the opposite rotation.

``kernel="pallas"`` runs each step on the port's kernels (block_matmul for
``_2d``, wx for ``_2d_t``); ``kernel="xla"`` runs plain PyTorch products
accumulated in ``accum_dtype``, as the reference's dot_general.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import comm
from repro_torch.core.sharding import Mesh
from repro_torch.kernels import fused_ring, ops


def _cast_operands(x, w, b, compute_dtype):
    """Cast a linear's operands to the policy compute dtype (params stored
    in param_dtype, GEMMs and rotations run in compute_dtype).  No-op when
    unset."""
    if compute_dtype is None:
        return x, w, b
    return (x.to(compute_dtype), w.to(compute_dtype),
            None if b is None else b.to(compute_dtype))


def jigsaw_matmul_2d(x: torch.Tensor, w: torch.Tensor, *, mesh: Mesh,
                     accum_dtype: Optional[torch.dtype] = torch.float32,
                     kernel: str = "xla") -> torch.Tensor:
    """Cannon's X @ W.T on local blocks (x [..., n/q, d/q], w [m/q, d/q]
    in the Cannon layout) -> the local [..., n/q, m/q] block in
    ``accum_dtype`` (x's dtype when None)."""
    q = mesh.q

    def mm(a, b):
        if kernel == "pallas":
            # the kernel returns a's dtype (its f32 sum is internal); cast
            # up so the q cross-step partial sums accumulate in accum_dtype
            out = ops.matmul_nd(a, b, None)
            return out.to(accum_dtype) if accum_dtype else out
        dt = accum_dtype or a.dtype
        return torch.matmul(a.to(dt), b.to(dt).t())

    a = comm.rotate(x, mesh.tp_group, mesh.i)     # X(i, (j + i) % q)
    bm = comm.rotate(w, mesh.dom_group, mesh.j)   # W(j, (i + j) % q)
    acc = mm(a, bm)
    for _ in range(q - 1):
        a = comm.rotate(a, mesh.tp_group, 1)
        bm = comm.rotate(bm, mesh.dom_group, 1)
        acc = acc + mm(a, bm)
    return acc


def jigsaw_linear_2d(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *, mesh: Mesh,
                     accum_dtype: Optional[torch.dtype] = torch.float32,
                     kernel: str = "xla",
                     compute_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """``x @ w.T + b`` on the rank's blocks (b: the [m/q] block on mtp).
    The product is cast to x's dtype, and only then is the bias added."""
    x, w, b = _cast_operands(x, w, b, compute_dtype)
    y = jigsaw_matmul_2d(x, w, mesh=mesh, accum_dtype=accum_dtype,
                         kernel=kernel).to(x.dtype)
    return y if b is None else y + b


def jigsaw_matmul_2d_t(x: torch.Tensor, w: torch.Tensor, *, mesh: Mesh,
                       accum_dtype: Optional[torch.dtype] = torch.float32,
                       kernel: str = "xla") -> torch.Tensor:
    """Cannon's W @ X contracting x's second-to-last dim, on local blocks
    (x [..., t/q, c/q], w [m/q, t/q]) -> the local [..., m/q, c/q] block in
    ``accum_dtype`` (x's dtype when None)."""
    wl = comm.rotate(w, mesh.tp_group, mesh.i)    # W(i, (j + i) % q)
    xl = comm.rotate(x, mesh.dom_group, mesh.j)   # X((i + j) % q, j)
    if kernel == "pallas":
        return fused_ring.cannon_t_loop(wl, xl, dom_group=mesh.dom_group,
                                        tp_group=mesh.tp_group, q=mesh.q,
                                        accum_dtype=accum_dtype)

    def mm(wb, xb):
        dt = accum_dtype or xb.dtype
        return torch.matmul(wb.to(dt), xb.to(dt))

    acc = mm(wl, xl)
    for _ in range(mesh.q - 1):
        wl = comm.rotate(wl, mesh.tp_group, 1)
        xl = comm.rotate(xl, mesh.dom_group, 1)
        acc = acc + mm(wl, xl)
    return acc


def jigsaw_linear_2d_t(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None, *, mesh: Mesh,
                       accum_dtype: Optional[torch.dtype] = torch.float32,
                       kernel: str = "xla",
                       compute_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """``w @ x + b[:, None]`` on the rank's blocks (b: the [m/q] block on
    mdom).  The product is cast to x's dtype before the bias is added."""
    x, w, b = _cast_operands(x, w, b, compute_dtype)
    y = jigsaw_matmul_2d_t(x, w, mesh=mesh, accum_dtype=accum_dtype,
                           kernel=kernel).to(x.dtype)
    return y if b is None else y + b[:, None]
