"""Jigsaw's distributed products on ``torch.distributed`` (the port of
``repro/core/jigsaw.py``).

The reference runs each product inside ``shard_map`` on a named mesh; here
each process is one rank and calls these functions on its own blocks.

1-D Jigsaw (the paper's 2-way scheme generalised to p ranks, ``Mesh1D``):
x [..., d/p] (features cut), w [m, d/p] (the contracting dim cut); each
rank's partial product [..., m] is completed by a reduce-scatter, leaving
y [..., m/p]: the layout of x, so layers compose.  ``jigsaw_matmul_1d``'s
impls, under the reference's names:

  "ring"          one local GEMM, then ``ring_reduce_scatter`` of its
                  output (p - 1 hops of ``comm.ring_shift``);
  "ring_chunked"  the paper's schedule: chunk j's GEMM right before hop j;
  "ring_fused"    the same schedule as one operation per ring, on the ring
                  step kernels on the card (``kernels/fused_ring.py``);
  "rs"            ``comm.reduce_scatter`` (the library's reduce-scatter);
  "allreduce"     ``comm.all_reduce``, then the rank's chunk;
  "gspmd"         not ported: it is the reference's "no explicit
                  collectives, let GSPMD place them", which PyTorch has no
                  counterpart of (ROADMAP.md).

``vocab_linear_1d`` is the language models' head under 1-D, which the
reference leaves to GSPMD: the features all-gathered, the rank's vocab
rows multiplied locally, the logits left cut over the vocab.

The wire (every hop, the reduce-scatter's operand) carries x's dtype; the
ring's adds run in ``accum_dtype``.  Differentiable: the transpose of each
collective is its autograd backward (a ring reduce-scatter's is the ring
all-gather).

2-D Jigsaw: rank (i, j) sits at mdom coordinate i and mtp coordinate j
(``Mesh``).

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

``kernel="pallas"`` runs the steps on the port's kernels: block_matmul for
``_2d``, and for ``_2d_t`` ``fused_ring.fused_cannon_t`` (at q > 1 on the
card the Cannon kernel, the rotations between steps in-kernel; at q = 1 one
wx launch); ``kernel="xla"`` runs plain PyTorch products accumulated in
``accum_dtype``, as the reference's dot_general.

The analytic wire model at the end (``CommVolume``, ``CommSchedule`` and
their functions) is a copy of the reference's, pure arithmetic: the bytes
a rank sends for one linear's forward under each scheme, which
``telemetry/accounting.py`` turns into the step records'
``comm_fraction``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import comm
from repro_torch.core.sharding import Mesh, Mesh1D
from repro_torch.kernels import fused_ring, ops
from repro_torch.kernels.fused_ring import local_matmul

IMPL_1D = ("ring", "ring_chunked", "ring_fused", "rs", "gspmd", "allreduce")


def check_impl(impl: str, *, runs: bool = True) -> None:
    """Raise ValueError for an impl the reference does not have and, where
    the impl ``runs`` (scheme="1d"), NotImplementedError for "gspmd"."""
    if impl not in IMPL_1D:
        raise ValueError(f"unknown 1-D jigsaw impl {impl!r} (expected one "
                         f"of {IMPL_1D})")
    if runs and impl == "gspmd":
        raise NotImplementedError(
            "impl='gspmd' has no torch counterpart: it leaves the "
            "collectives to GSPMD's sharding propagation (ROADMAP.md)")


def _cast_operands(x, w, b, compute_dtype):
    """Cast a linear's operands to the policy compute dtype (params stored
    in param_dtype, GEMMs and rotations run in compute_dtype).  No-op when
    unset."""
    if compute_dtype is None:
        return x, w, b
    return (x.to(compute_dtype), w.to(compute_dtype),
            None if b is None else b.to(compute_dtype))


# ---------------------------------------------------------------------------
# 1-D Jigsaw
# ---------------------------------------------------------------------------

def ring_reduce_scatter(x: torch.Tensor, group, p: int, me: int,
                        dim: int = -1,
                        accum_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """Ring reduce-scatter of x over ``group`` (p ranks, this rank ``me``):
    every rank holds a whole partial sum, and rank r ends with chunk r of
    the sum along ``dim`` (``fused_ring.ring_walk``: hops in x's dtype,
    adds in ``accum_dtype``)."""
    if p == 1:
        return x
    dim %= x.dim()
    if x.shape[dim] % p:
        raise ValueError(f"ring_reduce_scatter: dim {dim} of "
                         f"{tuple(x.shape)} not divisible by {p}")
    chunk = x.shape[dim] // p
    acc_dt = accum_dtype or x.dtype
    return fused_ring.ring_walk(
        lambda j: x.narrow(dim, j * chunk, chunk).to(acc_dt), group, p, me,
        x.dtype, acc_dt)


def ring_matmul_chunked(x: torch.Tensor, w: torch.Tensor, *, group, p: int,
                        me: int,
                        accum_dtype: Optional[torch.dtype] = torch.float32,
                        kernel: str = "xla") -> torch.Tensor:
    """The paper's chunk-granular ring: w [m, d/p] cut into p chunks of
    m/p rows, chunk j's GEMM issued right before hop j, in
    ``ring_reduce_scatter``'s walk and cast points."""
    if p == 1:
        return local_matmul(x, w, accum_dtype, kernel).to(x.dtype)
    if w.shape[0] % p:
        raise ValueError(f"ring_matmul_chunked: out dim {w.shape[0]} not "
                         f"divisible by {p}")
    return fused_ring.chunk_walk(x, w, group, p, me, accum_dtype, kernel)


def jigsaw_matmul_1d(x: torch.Tensor, w: torch.Tensor, *, mesh: Mesh1D,
                     impl: str = "rs",
                     accum_dtype: Optional[torch.dtype] = torch.float32,
                     kernel: str = "xla") -> torch.Tensor:
    """1-D Jigsaw on the rank's blocks: x [..., d/p], w [m, d/p] -> the
    rank's [..., m/p] block of ``X @ W.T``, in x's dtype."""
    p, me, group = mesh.p, mesh.r, mesh.tp_group
    check_impl(impl)
    if w.shape[0] % p:
        raise ValueError(f"jigsaw_matmul_1d: out dim {w.shape[0]} not "
                         f"divisible by {p} ranks")
    if impl == "ring_fused":
        return fused_ring.fused_ring_matmul(
            x, w, group=group, p=p, rank=me, accum_dtype=accum_dtype,
            kernel=kernel).to(x.dtype)
    if impl == "ring_chunked":
        return ring_matmul_chunked(x, w, group=group, p=p, me=me,
                                   accum_dtype=accum_dtype,
                                   kernel=kernel).to(x.dtype)
    # reduce in the wire dtype: x's (the reference's partial_sum cast)
    partial = local_matmul(x, w, accum_dtype, kernel).to(x.dtype)
    if p == 1:
        return partial
    if impl == "ring":
        return ring_reduce_scatter(partial, group, p, me,
                                   accum_dtype=accum_dtype)
    if impl == "rs":
        return comm.reduce_scatter(partial, group, -1)
    chunk = partial.shape[-1] // p          # "allreduce"
    return comm.all_reduce(partial, group).narrow(-1, me * chunk, chunk)


def fsdp_cut(m: int, mesh: Mesh1D) -> bool:
    """Whether the FSDP hybrid cuts a 1-D weight of out dim ``m`` over the
    data axis: there is more than one data rank and their count divides it
    (the reference's ``fsdp_ok``; else the weight stays whole on every
    data rank)."""
    return mesh.data_size > 1 and m % mesh.data_size == 0


def jigsaw_linear(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None, *, mesh: Mesh1D,
                  impl: str = "rs",
                  accum_dtype: Optional[torch.dtype] = torch.float32,
                  kernel: str = "xla",
                  compute_dtype: Optional[torch.dtype] = None,
                  fsdp: bool = False) -> torch.Tensor:
    """1-D Jigsaw linear ``x @ w.T + b`` on the rank's blocks: x
    [..., d/p], w [m, d/p], b [m/p] (the rank's chunk of the bias; added
    after the reduce, no communication) -> [..., m/p].

    ``fsdp`` (the FSDP hybrid, the reference's ``w_data_sharded``): where
    ``fsdp_cut`` holds for the whole out dim m = p * len(b) (the bias
    block is never cut over data), w is this data rank's [m/data, d/p]
    block of it, and its blocks are all-gathered over the data group in
    rank order before the product (the reference's ``core/jigsaw.py:
    399-401``); the gather's backward reduce-scatters dw over data, the one
    data reduction such a weight's gradient gets.  The gather runs on the
    stored parameter, before the policy cast."""
    if fsdp and mesh.data_size > 1:
        if b is None:
            raise ValueError("jigsaw_linear: the FSDP hybrid reads the "
                             "whole out dim from the bias block; this "
                             "linear has none")
        if fsdp_cut(mesh.p * b.shape[-1], mesh):
            w = comm.gather_shards(w, mesh.data_group, -2)
    x, w, b = _cast_operands(x, w, b, compute_dtype)
    if x.shape[-1] != w.shape[1]:
        raise ValueError(f"jigsaw_linear: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} blocks do not contract")
    y = jigsaw_matmul_1d(x, w, mesh=mesh, impl=impl,
                         accum_dtype=accum_dtype, kernel=kernel)
    return y if b is None else y + b


def vocab_linear_1d(x: torch.Tensor, w: torch.Tensor, *, mesh: Mesh1D,
                    accum_dtype: Optional[torch.dtype] = torch.float32,
                    kernel: str = "xla",
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """The vocab-parallel LM head on the rank's blocks: x [..., D/p] (the
    residual stream's features cut), w [V/p, D] (the rank's vocab rows of
    the head or the tied table) -> the rank's logits [..., V/p], which stay
    cut (the loss reduces over them: ``train/loss.py::lm_nll_sharded``).

    The reference leaves this head to GSPMD (its
    ``core/api.py::head_config``); written out, it all-gathers x's
    features over the tp group (``fused_ring.gather_features``: on the
    card ring hops through the ring workspace's IPC slots, on the CPU the
    library's all-gather), then runs the local GEMM against the rank's vocab rows (block_matmul under
    ``kernel="pallas"``, forward and VJP).  Its backward reduce-scatters dx
    over D (the gather's transpose) and keeps dw local."""
    x, w, _ = _cast_operands(x, w, None, compute_dtype)
    xf = fused_ring.gather_features(x, mesh.tp_group, mesh.p, mesh.r)
    if xf.shape[-1] != w.shape[1]:
        raise ValueError(f"vocab_linear_1d: x {tuple(x.shape)} gathered "
                         f"over {mesh.p} ranks and w {tuple(w.shape)} do "
                         "not contract")
    return local_matmul(xf, w, accum_dtype, kernel).to(x.dtype)


# ---------------------------------------------------------------------------
# 2-D Jigsaw
# ---------------------------------------------------------------------------

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
        return fused_ring.fused_cannon_t(
            wl, xl, dom_group=mesh.dom_group, tp_group=mesh.tp_group,
            model_group=mesh.model_group, q=mesh.q, accum_dtype=accum_dtype)

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


# --------------------------------------------------------------------------
# Analytic communication volume (the reference's, for the cost model)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommVolume:
    """Bytes sent per device for one linear layer's forward pass."""
    scheme: str
    bytes_per_device: float


def comm_volume_jigsaw_1d(tokens: int, m: int, p: int, dtype_bytes: int = 2
                          ) -> CommVolume:
    # ring reduce-scatter of [tokens, m]: (p-1) chunks of tokens*m/p each.
    return CommVolume("jigsaw-1d", (p - 1) / p * tokens * m * dtype_bytes)


def comm_volume_megatron_pair(tokens: int, d: int, p: int,
                              dtype_bytes: int = 2) -> CommVolume:
    # Megatron fuses two linears around one allreduce of [tokens, d]:
    # ring allreduce = 2 (p-1)/p * bytes.
    return CommVolume("megatron-pair",
                      2 * (p - 1) / p * tokens * d * dtype_bytes)


@dataclasses.dataclass(frozen=True)
class CommSchedule:
    """Per-hop accounting of an explicit ring schedule (one linear fwd).

    ``flops_per_hop`` is the local GEMM work the schedule exposes
    *between* consecutive sends -- the compute available to hide each
    hop.  The monolithic ``ring`` finishes its single GEMM before hop 0,
    so it exposes zero overlappable work; ``ring_chunked`` exposes one
    output-chunk GEMM per hop (the paper's overlap).
    """
    scheme: str
    hops: int
    bytes_per_hop: float
    flops_per_hop: float
    bytes_per_device: float

    def overlap_ratio(self, link_bw: float, peak_flops: float) -> float:
        """compute-time / comm-time per hop (>= 1: the hop is hidden)."""
        if self.bytes_per_hop == 0:
            return float("inf")
        t_comm = self.bytes_per_hop / link_bw
        t_comp = self.flops_per_hop / peak_flops
        return t_comp / t_comm if t_comm else float("inf")


def comm_schedule_jigsaw_1d(tokens: int, m: int, d_local: int, p: int,
                            dtype_bytes: int = 2, chunked: bool = True,
                            impl: Optional[str] = None) -> CommSchedule:
    """Hop-level schedule of the explicit 1-D Jigsaw ring.

    All three schedules move the same (p-1)/p * tokens * m bytes per
    device; they differ in what compute is still pending while each hop's
    send is in flight:

      ring         : nothing (the single GEMM finished before hop 0),
      ring_chunked : one output-chunk GEMM (2 * tokens * d_local * m/p
                     flops) between hops,
      ring_fused   : the same chunk GEMM plus the hop add (tokens * m/p
                     flops), inside the ring step kernel.

    ``impl`` ("ring" | "ring_chunked" | "ring_fused") supersedes the
    legacy ``chunked`` bool when given.
    """
    if impl is None:
        impl = "ring_chunked" if chunked else "ring"
    if impl not in ("ring", "ring_chunked", "ring_fused"):
        raise ValueError(f"comm_schedule_jigsaw_1d: unknown impl {impl!r}")
    hop_bytes = tokens * (m / p) * dtype_bytes
    chunk_flops = 2.0 * tokens * d_local * (m / p)
    flops = {"ring": 0.0, "ring_chunked": chunk_flops,
             "ring_fused": chunk_flops + tokens * (m / p)}[impl]
    return CommSchedule(
        scheme="jigsaw-1d-" + impl,
        hops=p - 1, bytes_per_hop=hop_bytes,
        flops_per_hop=flops,
        bytes_per_device=(p - 1) * hop_bytes)


def comm_volume_jigsaw_2d(tokens: int, m: int, q: int, dtype_bytes: int = 2
                          ) -> CommVolume:
    # Cannon on q x q grid: per step each rank forwards its X block
    # [tokens/q, d/q] and W block [m/q, d/q]; 2(q-1) block sends + skews.
    # Expressed in output-proportional terms for comparability.
    blk = tokens / q * m / q
    return CommVolume("jigsaw-2d", 2 * (q - 1) * blk * dtype_bytes)
