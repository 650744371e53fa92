"""The port of ``repro/kernels/fused_ring.py``: the 1-D ring as one
operation per ring (``fused_ring_matmul``, ``impl="ring_fused"``) on the
ring step kernels, and the transposed Cannon: its step on the wx kernel
(``cannon_t_step``, the custom VJP ``_wx_acc``, ``cannon_t_loop``) and the
whole loop on the Cannon kernel (``fused_cannon_t``).

``fused_ring_matmul`` is an ``autograd.Function``.  On the card its forward
is the p launches of the forward step kernel (``kernels/ring.py``, one per
ring step, each writing the successor's slot through its IPC mapping) and
its backward the p launches of the backward step kernel: dy chunks ride the
ring in the all-gather direction while each step computes a dw chunk and
adds to dx.  On the CPU it runs the plain versions of both: the chunk walk
(the reference's ``_chunk_walk``, ``ring_matmul_chunked``'s schedule with
its cast points) and the reference's fallback backward (``_fused_bwd``: the
rank-ordered ring all-gather of the cotangent, ``ring_all_gather``, then
the local backward).  The
reference falls back from its TPU kernel to the chunk walk above a VMEM
budget (12 MiB, every full-width linear); here a CUDA tensor launches the
kernels or raises (the workspace guard: ``ring.WORKSPACE_BUDGET_BYTES``).

In the step loop (``cannon_t_loop``) each multiply-accumulate step
``acc + w @ x`` is one launch of the wx kernel (``kernels/wx.py``), and its
backward runs the reference's VJP: dx through the same kernel, dw through
block_matmul; the rotations between steps are ``core/comm.rotate``.
``fused_cannon_t`` (an ``autograd.Function``, the reference's
``_fused_cannon``) is the loop as the token mix runs it: at q > 1 on a CUDA
tensor its forward is the q launches of the Cannon kernel
(``kernels/cannon.py``), each step's rotations in-kernel stores into the
predecessors' receive slots, and it raises rather than run the step loop
there (``cannon_path``); at q = 1 it is the step loop itself, and on the
CPU its forward is the step loop.  Its backward is the reference's
``_fused_cannon_bwd``: the VJP of the step loop, recomputed on the saved
skewed operands, so its gradients are the step loop's bit for bit.
"""
from __future__ import annotations

import collections
import itertools
import math
from typing import Optional

import torch

from repro_torch.core import comm
from repro_torch.kernels import cannon, ops, ring, sm90
from repro_torch.kernels.block_matmul import block_matmul
from repro_torch.kernels.wx import wx


# ---------------------------------------------------------------------------
# the 1-D ring (impl="ring_fused")
# ---------------------------------------------------------------------------

def local_matmul(x: torch.Tensor, w: torch.Tensor,
                 accum_dtype: Optional[torch.dtype], kernel: str = "xla"
                 ) -> torch.Tensor:
    """x [..., k] @ w [m, k].T -> [..., m], a rank's partial sum:
    block_matmul (in x's dtype) under kernel="pallas", else a plain product
    in ``accum_dtype`` (x's dtype when None).  Every local GEMM of the 1-D
    path, here and in ``core/jigsaw.py``."""
    if kernel == "pallas":
        return ops.matmul_nd(x, w, None)
    dt = accum_dtype or x.dtype
    return torch.matmul(x.to(dt), w.to(dt).t())


def ring_walk(get, group, p, me, wire_dtype, acc_dtype,
              shift=comm.ring_shift):
    """The 1-D ring's walk (the reference's ``ring_reduce_scatter``): start
    with ``get((me + p - 1) % p)``, then p - 1 rounds of one hop to the
    successor in ``wire_dtype`` (``shift(t, group)``) and the add of
    ``get((me - 2 - s) % p)`` in ``acc_dtype``; ``get(j)`` is this rank's
    part of chunk j in ``acc_dtype``.  Ends with this rank's chunk of the
    sum, in ``wire_dtype``."""
    acc = get((me + p - 1) % p)
    for s in range(p - 1):
        acc = shift(acc.to(wire_dtype), group)
        acc = acc.to(acc_dtype) + get((me - 2 - s) % p)
    return acc.to(wire_dtype)


def ring_all_gather(x: torch.Tensor, group, p: int, me: int,
                    dim: int = -1, shift=comm.ring_shift) -> torch.Tensor:
    """Ring all-gather (the transpose of ``ring_walk``'s reduce-scatter,
    the reference's ``_rank_order_all_gather``): p - 1 hops
    (``shift(t, group)``), each piece placed at its owner's rank position
    along ``dim``."""
    if p == 1:
        return x
    pieces = [x]
    cur = x
    for _ in range(p - 1):
        cur = shift(cur, group)
        pieces.append(cur)
    # piece t came from rank (me - t) % p
    ordered = [pieces[(me - r) % p] for r in range(p)]
    return torch.cat(ordered, dim=dim)


# bytes this process copied into its peers' slots by ``ipc_shift``, by
# the collective that made the hop (outside the kernels' own hops)
ipc_bytes: collections.Counter = collections.Counter()


def ipc_shift(t: torch.Tensor, group, s: int, what: str) -> torch.Tensor:
    """One ring hop on the card through the group's ring workspace
    (``ring.workspace``, the successor's slots mapped by CUDA IPC): rank i
    copies t into rank i + 1's slot ``s % 2`` and gets rank i - 1's t.  The
    slot discipline of ``ring.cu``: a stream synchronisation and a group
    barrier before the copy (the successor has read that slot two hops
    ago, and every earlier kernel on the slots is done) and after it (every
    rank's copy has landed); the arrived t is copied out of the slot."""
    t = t.contiguous()
    ws = ring.workspace(group, t.numel() * t.element_size(), t.device)
    stream = torch.cuda.current_stream(t.device)
    stream.synchronize()
    comm.barrier(group)
    ws.peer(s % 2, t.shape, t.dtype).tensor().copy_(t)
    ipc_bytes[what] += t.numel() * t.element_size()
    stream.synchronize()
    comm.barrier(group)
    return ws.own(s % 2, t.shape, t.dtype).tensor().clone()


def ipc_hops(what: str):
    """A ``shift`` for ``ring_walk`` / ``ring_all_gather`` on the card:
    ``ipc_shift``'s hops, numbered from 0 (each hop's slot is its number
    mod 2), counted under ``what``."""
    hops = itertools.count()
    return lambda t, group: ipc_shift(t, group, next(hops), what)


def _label(what: str, op: str) -> str:
    return op if not what else f"{what}/{op}"


def _ipc_reduce_scatter(x, group, p, me, what):
    """This rank's chunk of the sum of x over the group, on the card: the
    ring's walk through the IPC slots, its hops and adds in f32."""
    chunk = x.shape[-1] // p
    y = ring_walk(lambda j: x.narrow(-1, j * chunk, chunk).float(), group,
                  p, me, torch.float32, torch.float32,
                  ipc_hops(_label(what, "reduce_scatter")))
    return y.to(x.dtype)


def _ipc_all_gather(x, group, p, me, what):
    return ring_all_gather(x, group, p, me, -1,
                           ipc_hops(_label(what, "all_gather")))


class _GatherFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, p, me, what):
        ctx.args = (group, p, me, what)
        return _ipc_all_gather(x, *ctx.args)

    @staticmethod
    def backward(ctx, dy):
        # the gather's transpose: the ring's reduce-scatter, added in f32
        return _ipc_reduce_scatter(dy, *ctx.args), None, None, None, None


class _ScatterFeatures(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, p, me, what):
        ctx.args = (group, p, me, what)
        return _ipc_reduce_scatter(x, *ctx.args)

    @staticmethod
    def backward(ctx, dy):
        return _ipc_all_gather(dy, *ctx.args), None, None, None, None


def gather_features(x: torch.Tensor, group, p: int, me: int,
                    what: str = "") -> torch.Tensor:
    """Every rank's x [..., d/p] concatenated along the last dim in rank
    order, differentiable (the backward reduce-scatters the cotangent, the
    rank keeping its chunk): on the card p - 1 ring hops through the ring
    workspace's IPC slots (``ipc_shift``; the backward's walk adds in
    f32), on the CPU ``comm.all_gather``.  The vocab-parallel head's
    gather (``core/jigsaw.py::vocab_linear_1d``), the MoE's and Mamba-2's
    (``models/layers.py``).  ``what`` prefixes the hops' ``ipc_bytes``
    keys ("<what>/all_gather", "<what>/reduce_scatter")."""
    if p == 1:
        return x
    if not x.is_cuda:
        return comm.all_gather(x, group, -1)
    return _GatherFeatures.apply(x, group, p, me, what)


def scatter_features(x: torch.Tensor, group, p: int, me: int,
                     what: str = "") -> torch.Tensor:
    """The sum over the group of every rank's x [..., d], of which this
    rank keeps chunk ``me`` [..., d/p] of the last dim, in x's dtype (the
    transpose of ``gather_features``; its backward all-gathers the
    cotangent): on the card the ring's reduce-scatter through the ring
    workspace's IPC slots, its hops and adds in f32 (``ring_walk`` with
    ``ipc_shift``), on the CPU ``comm.reduce_scatter`` of x in f32.  The
    expert-parallel MoE's combine (``models/layers.py::moe_apply``)."""
    if p == 1:
        return x
    if x.shape[-1] % p:
        raise ValueError(f"scatter_features: last dim of {tuple(x.shape)} "
                         f"not divisible by {p}")
    if not x.is_cuda:
        return comm.reduce_scatter(x.float(), group, -1).to(x.dtype)
    return _ScatterFeatures.apply(x, group, p, me, what)


def chunk_walk(x, w, group, p, me, accum_dtype, kernel):
    """The chunk-granular ring (the reference's ``_chunk_walk`` and
    ``ring_matmul_chunked``, one schedule): chunk j's product, rounded to
    the wire dtype (x's), right before hop j, in ``ring_walk``'s order.
    The plain forward of the fused ring, and the ``ring_chunked`` impl."""
    mc = w.shape[0] // p
    acc_dt = accum_dtype or x.dtype

    def chunk_mm(j):
        y = local_matmul(x, w[j * mc:(j + 1) * mc], accum_dtype, kernel)
        return y.to(x.dtype).to(acc_dt)

    return ring_walk(chunk_mm, group, p, me, x.dtype, acc_dt)


def _local_vjp(x, w, cot, accum_dtype, kernel, need_dx):
    """The ring's plain backward after the gather (the reference's
    ``jax.vjp`` of the local product): the gradients of
    ``local_matmul(x, w).to(x.dtype)`` for the whole cotangent ``cot``."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(need_dx)
        ww = w.detach().requires_grad_(True)
        y = local_matmul(xx, ww, accum_dtype, kernel).to(x.dtype)
        grads = torch.autograd.grad(y, [xx, ww] if need_dx else [ww], cot)
    return (grads[0] if need_dx else None), grads[-1]


def _card_forward(x2, w, group, p, me, accum_dtype):
    """p launches of the forward step kernel: step s computes chunk
    (me - 1 - s) % p, adds the partial that arrived in this rank's slot
    (s-1) % 2 and writes the successor's slot s % 2, or at the last step
    this rank's output."""
    rows = x2.shape[0]
    mc = w.shape[0] // p
    shape = (rows, mc)
    out = torch.empty(shape, dtype=x2.dtype, device=x2.device)
    # x and w in the layout the kernel reads (rows padded where TMA needs
    # it), once per call; the partials in the slots are contiguous
    x2, w = sm90.pad_rows(x2), sm90.pad_rows(w)
    ws = ring.workspace(group, rows * mc * x2.element_size(), x2.device)
    stream = torch.cuda.current_stream(x2.device)
    for s in range(p):
        stream.synchronize()          # the slot discipline of ring.cu
        comm.barrier(group)
        prev = None if s == 0 else ws.own((s - 1) % 2, shape, x2.dtype)
        dest = out if s == p - 1 else ws.peer(s % 2, shape, x2.dtype)
        ring.ring_fwd(x2, w, (me - 1 - s) % p, prev, dest,
                      accum_dtype=accum_dtype)
    return out


def _card_backward(x2, w, dy2, group, p, me, need_dx):
    """p launches of the backward step kernel: step s takes the dy chunk
    of rank (me - s) % p (this rank's own at s = 0, else the one that
    arrived in slot (s-1) % 2), writes its dw chunk, adds its part of dx
    and forwards it to the successor's slot s % 2."""
    rows, k = x2.shape
    mc = dy2.shape[1]
    shape = (rows, mc)
    dw = torch.empty(w.shape, dtype=x2.dtype, device=x2.device)
    dx_acc = dx = None
    if need_dx:
        dx_acc = torch.empty((rows, k), dtype=torch.float32,
                             device=x2.device)
        dx = torch.empty((rows, k), dtype=x2.dtype, device=x2.device)
    # x, w and dy in the layout the kernel reads (rows padded where TMA
    # needs it), once per call; the slots hold dy's layout
    x2, w, dy2 = sm90.pad_rows(x2), sm90.pad_rows(w), sm90.pad_rows(dy2)
    ld = sm90.row_stride(dy2)
    ws = ring.workspace(group, sm90.span_bytes(dy2), x2.device)
    stream = torch.cuda.current_stream(x2.device)
    for s in range(p):
        stream.synchronize()
        comm.barrier(group)
        cur = dy2 if s == 0 else ws.own((s - 1) % 2, shape, x2.dtype, ld)
        fwd = ws.peer(s % 2, shape, x2.dtype, ld) if s < p - 1 else None
        ring.ring_bwd(x2, w, (me - s) % p, cur, fwd, dw, dx_acc, dx,
                      first=s == 0, last=s == p - 1)
    return dx, dw


def ring_forward(x, w, group, p, me, accum_dtype, kernel):
    """The forward of one ring call: on the card p step launches, on the
    CPU the plain chunk walk.  Returns [..., m/p] in x's dtype."""
    if not x.is_cuda:
        return chunk_walk(x, w, group, p, me, accum_dtype, kernel)
    k = x.shape[-1]
    y = _card_forward(x.reshape(-1, k).contiguous(),
                      w.to(x.dtype).contiguous(), group, p, me, accum_dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def ring_backward(x, w, dy, group, p, me, accum_dtype, kernel, need_dx):
    """The backward of one ring call: on the card p step launches, on the
    CPU the rank-ordered all-gather of dy and the local backward.  Returns
    (dx or None, dw) in the dtypes of x and w."""
    if not x.is_cuda:
        cot = ring_all_gather(dy, group, p, me, -1)
        return _local_vjp(x, w, cot, accum_dtype, kernel, need_dx)
    k = x.shape[-1]
    dx, dw = _card_backward(x.reshape(-1, k).contiguous(),
                            w.to(x.dtype).contiguous(),
                            dy.to(x.dtype).reshape(-1, dy.shape[-1])
                            .contiguous(), group, p, me, need_dx)
    return (None if dx is None else dx.reshape(x.shape)), dw.to(w.dtype)


class _FusedRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group, p, me, accum_dtype, kernel):
        ctx.save_for_backward(x, w)
        ctx.args = (group, p, me, accum_dtype, kernel)
        return ring_forward(x, w, group, p, me, accum_dtype, kernel)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = ring_backward(x, w, dy, *ctx.args,
                               need_dx=ctx.needs_input_grad[0])
        return dx, dw, None, None, None, None, None


def fused_ring_matmul(x: torch.Tensor, w: torch.Tensor, *, group, p: int,
                      rank: int,
                      accum_dtype: Optional[torch.dtype] = torch.float32,
                      kernel: str = "xla") -> torch.Tensor:
    """The one-operation ring matmul (``impl="ring_fused"``): x [..., d/p]
    (the rank's block), w [m, d/p] -> the rank's [..., m/p] chunk of
    ``X @ W.T``, in x's dtype; ``rank`` is this rank's index in ``group``
    (p ranks).  Differentiable.  On the card every GEMM runs in the ring
    kernels (``kernel`` is not read there, as on the reference's TPU
    path); on the CPU the plain walk honours it."""
    if p == 1:
        return local_matmul(x, w, accum_dtype, kernel).to(x.dtype)
    if w.shape[0] % p:
        raise ValueError(f"fused_ring: out dim {w.shape[0]} not divisible "
                         f"by {p}")
    return _FusedRing.apply(x, w, group, p, rank, accum_dtype, kernel)


class _WxAcc(torch.autograd.Function):
    """``a + w @ x`` for w [m, t], x [L, t, c], a [L, m, c] or None, in
    ``out_dtype``, with the reference's backward (``_wx_acc_bwd``), for
    dy [L, m, c] in ``out_dtype``:

      * da = dy;
      * dx [L, t, c] = w.T @ dy_l through the same kernel, w read across its
        rows, the result cast to x's dtype.  The reference casts w to dy's
        dtype (``w.T.astype(dy.dtype)``); a bf16 w against an f32 dy goes
        to the kernel as it is (its dx entry: dy split into bf16 terms, on
        the tensor cores, every product exact in f32 as the reference's);
        any other w is cast;
      * dw [m, t] = sum_l dy_l @ x_l.T through block_matmul, dy cast to x's
        dtype, the result cast to w's dtype.  As in the reference, L is
        folded into the contraction as (L, c): dy is copied [m, L, c] (the
        copy that casts it) and x [t, L, c] (a view when L = 1), and one
        launch contracts L * c.
    """

    @staticmethod
    def forward(ctx, w, x, a, out_dtype):
        ctx.save_for_backward(w, x)
        return wx(w, x, a, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        w, x = ctx.saved_tensors
        dy = dy.contiguous()
        ll, t, c = x.shape
        m = w.shape[0]
        dw = dx = da = None
        if ctx.needs_input_grad[0]:
            dyt = torch.empty((m, ll, c), dtype=x.dtype, device=dy.device)
            dyt.copy_(dy.permute(1, 0, 2))
            xt = x.permute(1, 0, 2).reshape(t, ll * c).contiguous()
            dw = block_matmul(dyt.view(m, ll * c), xt).to(w.dtype)
        if ctx.needs_input_grad[1]:
            wd = w if (w.dtype, dy.dtype) == (torch.bfloat16,
                                              torch.float32) \
                else w.to(dy.dtype)
            dx = wx(wd, dy, None, out_dtype=dy.dtype, w_t=True).to(x.dtype)
        if ctx.needs_input_grad[2]:
            da = dy
        return dw, dx, da, None


def cannon_t_step(w: torch.Tensor, x: torch.Tensor,
                  acc: Optional[torch.Tensor], *,
                  accum_dtype: Optional[torch.dtype] = torch.float32
                  ) -> torch.Tensor:
    """One transposed-Cannon multiply-accumulate step, ``acc + w @ x``
    contracting x's second-to-last dim: w [m, t], x [..., t, c], acc
    [..., m, c] or None (a fresh accumulator) -> [..., m, c] in
    ``accum_dtype`` (x's dtype when None).  One wx launch; differentiable.
    w and x are brought to one dtype, the wider of the two."""
    out_dt = accum_dtype or x.dtype
    dt = torch.promote_types(w.dtype, x.dtype)
    w, x = w.to(dt), x.to(dt)
    lead = x.shape[:-2]
    ll = math.prod(lead)
    t, c = x.shape[-2], x.shape[-1]
    m = w.shape[0]
    a3 = None if acc is None else acc.reshape(ll, m, c).to(out_dt)
    y = _WxAcc.apply(w, x.reshape(ll, t, c), a3, out_dt)
    return y.reshape(*lead, m, c)


def cannon_t_loop(wl: torch.Tensor, xl: torch.Tensor, *, dom_group,
                  tp_group, q: int,
                  accum_dtype: Optional[torch.dtype] = torch.float32
                  ) -> torch.Tensor:
    """The q-step transposed Cannon on already-skewed operands: the first
    step, then q - 1 rounds of rotating w by one along mtp and x by one
    along mdom, each followed by a step.  Returns [..., m_l, c_l] in
    ``accum_dtype``; differentiable (each step's Function, and each
    rotation's opposite rotation)."""
    acc = cannon_t_step(wl, xl, None, accum_dtype=accum_dtype)
    for _ in range(q - 1):
        wl = comm.rotate(wl, tp_group, 1)
        xl = comm.rotate(xl, dom_group, 1)
        acc = cannon_t_step(wl, xl, acc, accum_dtype=accum_dtype)
    return acc


# ---------------------------------------------------------------------------
# the fused transposed Cannon: the q-step loop on the Cannon kernel
# ---------------------------------------------------------------------------

def _hop_bytes(ll: int, m_l: int, t_l: int, c_l: int,
               x_dtype: torch.dtype):
    """The bytes of a Cannon step's two hops, w [m_l, t_l] and x [ll, t_l,
    c_l], in the layout the kernel reads (bf16 rows padded to
    ``sm90.tma_ld``)."""
    e = x_dtype.itemsize

    def ld(cols):
        return sm90.tma_ld(cols) if x_dtype == torch.bfloat16 else cols
    return m_l * ld(t_l) * e, ll * t_l * ld(c_l) * e


def cannon_footprint_bytes(ll: int, m_l: int, t_l: int, c_l: int,
                           x_dtype: torch.dtype) -> int:
    """Device memory the fused Cannon takes on the card beside its operands
    and output: two receive slots for w's hops [m_l, t_l] and two for x's
    [ll, t_l, c_l] (raw ``cudaMalloc``, rounded up to ``ring.SLOT_GRANULE``;
    the reference's counts VMEM)."""
    return 2 * sum(ring.slot_bytes_for(b)
                   for b in _hop_bytes(ll, m_l, t_l, c_l, x_dtype))


def cannon_path(ll: int, m_l: int, t_l: int, c_l: int, x_dtype: torch.dtype,
                device) -> str:
    """``"card"``: the Cannon kernel, on a CUDA device; ``"step"``: the step
    loop, on the CPU.  On the card it raises when the slots of a hop would
    exceed ``ring.WORKSPACE_BUDGET_BYTES`` (the reference falls back to the
    step loop above its VMEM budget; here nothing falls back)."""
    if torch.device(device).type != "cuda":
        return "step"
    for nbytes in _hop_bytes(ll, m_l, t_l, c_l, x_dtype):
        ring.check_budget(nbytes)
    return "card"


def _card_cannon(w, x, dom_group, tp_group, model_group, q, out_dt):
    """q launches of the Cannon kernel on this rank's skewed blocks w
    [m, t] and x [L, t, c]: step s reads the blocks that arrived in slots
    (s-1) % 2 (its own at s = 0), adds w @ x into the [L, m, c]
    accumulator and, but at the last step, stores both into the
    predecessors' slots s % 2 (w's in the mtp group, x's in the mdom
    group)."""
    out = torch.empty((x.shape[0], w.shape[0], x.shape[2]), dtype=out_dt,
                      device=x.device)
    # the blocks in the layout the kernel reads (rows padded where TMA
    # needs it), once per loop; the slots hold the same layout
    w, x = sm90.pad_rows(w), sm90.pad_rows(x)
    ld_w, ld_x = sm90.row_stride(w), sm90.row_stride(x)
    w_ws = ring.workspace(tp_group, sm90.span_bytes(w), x.device, peer=-1)
    x_ws = ring.workspace(dom_group, sm90.span_bytes(x), x.device, peer=-1)
    stream = torch.cuda.current_stream(x.device)

    def slot(ws, i, t, ld, own):
        return (ws.own if own else ws.peer)(i, t.shape, t.dtype, ld)

    for s in range(q):
        stream.synchronize()          # the slot discipline of ring.cu
        comm.barrier(model_group)
        last = s == q - 1
        cannon.cannon_step(
            w if s == 0 else slot(w_ws, (s - 1) % 2, w, ld_w, True),
            x if s == 0 else slot(x_ws, (s - 1) % 2, x, ld_x, True), out,
            first=s == 0,
            w_dest=None if last else slot(w_ws, s % 2, w, ld_w, False),
            x_dest=None if last else slot(x_ws, s % 2, x, ld_x, False))
    return out


class _FusedCannon(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wl, xl, dom_group, tp_group, model_group, q,
                accum_dtype):
        ctx.save_for_backward(wl, xl)
        ctx.args = dict(dom_group=dom_group, tp_group=tp_group, q=q,
                        accum_dtype=accum_dtype)
        lead, (t, c), m = xl.shape[:-2], xl.shape[-2:], wl.shape[0]
        ll = math.prod(lead)
        dt = torch.promote_types(wl.dtype, xl.dtype)
        if cannon_path(ll, m, t, c, dt, xl.device) == "step":
            return cannon_t_loop(wl, xl, **ctx.args)
        y = _card_cannon(wl.to(dt).contiguous(),
                         xl.to(dt).reshape(ll, t, c).contiguous(), dom_group,
                         tp_group, model_group, q, accum_dtype or xl.dtype)
        return y.reshape(*lead, m, c)

    @staticmethod
    def backward(ctx, dy):
        # the reference's _fused_cannon_bwd: the VJP of the step loop,
        # its forward recomputed on the saved skewed operands
        wl, xl = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in
                      zip((wl, xl), need)]
            y = cannon_t_loop(*leaves, **ctx.args)
            grads = iter(torch.autograd.grad(
                y, [t for t, n in zip(leaves, need) if n], dy))
        dw, dx = (next(grads) if n else None for n in need)
        return dw, dx, None, None, None, None, None


def fused_cannon_t(wl: torch.Tensor, xl: torch.Tensor, *, dom_group,
                   tp_group, model_group, q: int,
                   accum_dtype: Optional[torch.dtype] = torch.float32
                   ) -> torch.Tensor:
    """The transposed Cannon on already-skewed blocks (the reference's
    ``fused_cannon_t``): w [m_l, t_l], x [..., t_l, c_l] -> [..., m_l, c_l]
    in ``accum_dtype`` (x's dtype when None); differentiable.  At q > 1 on
    the card the q steps and their 2 (q - 1) rotations run as q launches of
    the Cannon kernel, with a barrier over ``model_group`` before each; at
    q = 1, and on the CPU, the step loop (``cannon_t_loop``)."""
    if q == 1:
        return cannon_t_loop(wl, xl, dom_group=dom_group, tp_group=tp_group,
                             q=q, accum_dtype=accum_dtype)
    return _FusedCannon.apply(wl, xl, dom_group, tp_group, model_group, q,
                              accum_dtype)
