"""Plain PyTorch versions of the port's kernels.

They are the oracles the kernels are held against on the card, and the path
a kernel's wrapper takes for a tensor that lies on the CPU.  Each mirrors
``repro/kernels/ref.py`` (``wx_ref``: ``repro/kernels/fused_ring.py``'s
``_wx_raw``, and ``split_bf16x3`` the split of its dx route; the ring steps: one grid step of its ``_ring_fwd_kernel`` and
``_ring_bwd_kernel``; ``cannon_ref``: its ``_cannon_kernel`` over a mesh;
``ssd_intra_ref``: ``repro/kernels/ssd_chunk.py::_kernel``): f32 accumulation (bf16 products are exact in f32,
so an f32 product of the up-cast operands is the reference's
``preferred_element_type=float32``), bias added in f32, the activation in
f32, one rounding to ``x.dtype``.  On the card this needs
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def act(name: str):
    """The epilogue activation by name; GELU is the tanh form, as
    ``jax.nn.gelu``'s default."""
    if name == "gelu":
        return lambda v: F.gelu(v, approximate="tanh")
    if name == "silu":
        return F.silu
    if name == "none":
        return lambda v: v
    raise ValueError(f"unknown epilogue {name!r} (none | gelu | silu)")


def act_grad(name: str):
    """The derivative of the epilogue activation by name, in the value's
    dtype (f32 where it is used): what ``jax.vjp`` of the reference's
    activation computes."""
    if name == "gelu":
        beta, kappa = math.sqrt(2.0 / math.pi), 0.044715

        def gelu_grad(v):
            t = torch.tanh(beta * (v + kappa * v ** 3))
            return 0.5 * (1.0 + t) + 0.5 * v * (1.0 - t * t) * beta * (
                1.0 + 3.0 * kappa * v * v)
        return gelu_grad
    if name == "silu":
        def silu_grad(v):
            s = torch.sigmoid(v)
            return s * (1.0 + v * (1.0 - s))
        return silu_grad
    raise ValueError(f"no derivative for epilogue {name!r} (gelu | silu)")


def block_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None,
                     epilogue: str = "none", *, x_t: bool = False,
                     w_t: bool = False) -> torch.Tensor:
    """``epilogue(A @ B.T + b)`` for A = x [M, K] (x.T when ``x_t``),
    B = w [N, K] (w.T when ``w_t``), b [N] or None."""
    f = act(epilogue)
    a = x.float().t() if x_t else x.float()
    bt = w.float() if w_t else w.float().t()
    out = torch.matmul(a, bt)
    if b is not None:
        out = out + b.float()
    return f(out).to(x.dtype)


def matmul_bwd_ref(x: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor], epilogue: str,
                   dy: torch.Tensor):
    """The plain backward of ``epilogue(x @ w.T + b)`` (the reference's
    ``ops._matmul_bwd``): the pre-activation recomputed and rounded to
    ``x.dtype``, ``dz = act'(z) * dy`` in f32 rounded to ``dy.dtype``, then
    ``dx = dz @ w``, ``dw = dz.T @ x`` and ``db = sum(dz)`` in the dtypes of
    x, w and b.  Returns (dx, dw, db)."""
    if epilogue == "none":
        dz = dy
    else:
        z = block_matmul_ref(x, w.to(x.dtype), b, "none").float()
        dz = (act_grad(epilogue)(z) * dy.float()).to(dy.dtype)
    dx = block_matmul_ref(dz, w.to(dz.dtype), None, "none",
                          w_t=True).to(x.dtype)
    dw = block_matmul_ref(dz, x.to(dz.dtype), None, "none", x_t=True,
                          w_t=True).to(w.dtype)
    db = None if b is None else dz.sum(dim=0).to(b.dtype)
    return dx, dw, db


def mixer_mlp_ref(x: torch.Tensor, w1: torch.Tensor, b1, w2: torch.Tensor,
                  b2) -> torch.Tensor:
    """The WeatherMixer MLP ``gelu(x @ w1.T + b1) @ w2.T + b2`` over the
    last dim of x [..., d_in]; the hidden activation is rounded to
    ``x.dtype`` between the two products."""
    h = block_matmul_ref(x.reshape(-1, x.shape[-1]), w1, b1, "gelu")
    y = block_matmul_ref(h, w2, b2, "none")
    return y.reshape(*x.shape[:-1], w2.shape[0])


def wx_ref(w: torch.Tensor, x: torch.Tensor, a: Optional[torch.Tensor] = None,
           out_dtype: torch.dtype = torch.float32, *,
           w_t: bool = False) -> torch.Tensor:
    """``a[l] + W @ x[l]`` for each l (the reference's ``_wx_raw``): W = w
    [M, K] (w.T when ``w_t``, w stored [K, M]), x [L, K, N], a [L, M, N] or
    None (zero); the product and the add in f32, one rounding to
    ``out_dtype``."""
    wf = w.float().t() if w_t else w.float()
    out = torch.matmul(wf, x.float())
    if a is not None:
        out = a.float() + out
    return out.to(out_dtype)


def split_bf16x3(x: torch.Tensor):
    """An f32 tensor as three bf16 terms (the plain version of ``wx.cu``'s
    split pass): ``hi = bf16(x)``, ``mid = bf16(x - hi)``, ``lo = bf16(x -
    hi - mid)``, each rounded to nearest even; the differences are exact in
    f32.  ``hi + mid + lo == x`` exactly wherever the remainders stay above
    bf16's smallest subnormal (|x| >= 2^-110), and ``mid == lo == 0``
    where x is bf16-exact.  Returns (hi, mid, lo)."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def ring_fwd_step_ref(x: torch.Tensor, w_chunk: torch.Tensor,
                      prev: Optional[torch.Tensor],
                      accum_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """One forward ring step (``_ring_fwd_kernel``'s grid step): the chunk
    product ``x @ w_chunk.T`` (x [R, K], w_chunk [MC, K]) rounded to the
    wire dtype (x.dtype), up to ``accum_dtype`` (x's dtype when None), plus
    the arrived partial ``prev`` [R, MC] (wire dtype, None at step 0) in
    ``accum_dtype``, rounded to the wire dtype: what the step sends on, or
    at the last step the rank's reduce-scattered chunk."""
    acc = accum_dtype or x.dtype
    y = block_matmul_ref(x, w_chunk.to(x.dtype)).to(acc)
    if prev is not None:
        y = prev.to(acc) + y
    return y.to(x.dtype)


def ring_bwd_step_ref(x: torch.Tensor, w_chunk: torch.Tensor,
                      cur: torch.Tensor, dx_acc: Optional[torch.Tensor]):
    """One backward ring step (``_ring_bwd_kernel``'s grid step) for the
    cotangent chunk ``cur`` [R, MC] that arrived (or the rank's own at step
    0): returns (dw_chunk = cur.T @ x [MC, K] rounded to cur's dtype,
    dx_acc + cur @ w_chunk [R, K] in f32; ``dx_acc`` None at step 0).  The
    last step's dx is the accumulator rounded to x.dtype."""
    dw = block_matmul_ref(cur, x.to(cur.dtype), x_t=True, w_t=True)
    d = torch.matmul(cur.float(), w_chunk.float())
    return dw, d if dx_acc is None else dx_acc + d


def ring_walk_all(chunk, p: int, wire_dtype: torch.dtype,
                  accum_dtype: Optional[torch.dtype]):
    """The 1-D ring's walk for p ranks held in one process: ``chunk(r, j)``
    is rank r's part of chunk j of the sum; returns every rank's chunk of
    the sum as the ring leaves it (``ring_reduce_scatter``'s order and cast
    points: hops in ``wire_dtype``, adds in ``accum_dtype``)."""
    acc = accum_dtype or wire_dtype
    carry = [chunk(r, (r - 1) % p).to(wire_dtype).to(acc) for r in range(p)]
    for s in range(p - 1):
        carry = [carry[(r - 1) % p].to(wire_dtype).to(acc)
                 + chunk(r, (r - 2 - s) % p).to(wire_dtype).to(acc)
                 for r in range(p)]
    return [c.to(wire_dtype) for c in carry]


def ring_fwd_all_ref(xs, ws, accum_dtype: Optional[torch.dtype]):
    """The plain forward ring of p ranks (x ``xs[r]``, w ``ws[r]``): every
    rank's output chunk from the plain chunk products."""
    p = len(xs)
    mc = ws[0].shape[0] // p
    return ring_walk_all(
        lambda r, j: block_matmul_ref(xs[r], ws[r][j * mc:(j + 1) * mc]),
        p, xs[0].dtype, accum_dtype)


def ring_bwd_all_ref(xs, ws, dys):
    """The plain backward ring of p ranks: (dx, dw, dx_acc) per rank, each
    step's dw chunk and dx term from ``ring_bwd_step_ref`` in the kernels'
    order (rank r takes rank (r - s) % p's dy chunk at step s)."""
    p = len(xs)
    mc = ws[0].shape[0] // p
    cur, accs = list(dys), [None] * p
    dws = [torch.empty_like(w, dtype=xs[0].dtype) for w in ws]
    for s in range(p):
        for r in range(p):
            j = (r - s) % p
            dws[r][j * mc:(j + 1) * mc], accs[r] = ring_bwd_step_ref(
                xs[r], ws[r][j * mc:(j + 1) * mc], cur[r], accs[r])
        cur = [cur[(r - 1) % p] for r in range(p)]
    return [a.to(x.dtype) for a, x in zip(accs, xs)], dws, accs


def cannon_walk_all(step, ws, xs, q: int):
    """The transposed Cannon of the q x q ranks of a mesh held in one
    process, the rotations done by indexing: rank r = i * q + j starts with
    its skewed blocks ``ws[r]``, ``xs[r]`` and at step s holds those of
    ranks (i, j + s) (w, rotated along mtp) and (i + s, j) (x, along mdom);
    ``step(w, x, acc)`` is one multiply-accumulate (acc None at s = 0).
    Returns every rank's accumulator."""
    accs = [None] * (q * q)
    for s in range(q):
        for r in range(q * q):
            i, j = divmod(r, q)
            accs[r] = step(ws[i * q + (j + s) % q],
                           xs[(i + s) % q * q + j], accs[r])
    return accs


def cannon_ref(ws, xs, q: int, accum_dtype: torch.dtype = torch.float32):
    """The plain transposed Cannon of q x q ranks (``_cannon_kernel``'s
    function): ``acc += w @ x`` in f32 over the q steps, rounded once to
    ``accum_dtype``; w [M, K], x [L, K, N] -> [L, M, N] per rank."""
    def step(w, x, acc):
        y = torch.matmul(w.float(), x.float())
        return y if acc is None else acc + y
    return [a.to(accum_dtype) for a in cannon_walk_all(step, ws, xs, q)]


def ssd_intra_ref(c: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                  dt: torch.Tensor, dac: torch.Tensor) -> torch.Tensor:
    """The Mamba-2 intra-chunk SSD term, per group g of G = batch x chunks x
    heads: c, b [G, Q, N]; x [G, Q, P]; dt, dac [G, Q] (dt after softplus,
    dac the within-chunk cumsum of dt * A).  Returns y [G, Q, P] in x's
    dtype:

      s   = c @ b.T                                  (f32)
      att = where(i >= j, s * exp(dac_i - dac_j), 0) * dt_j
      y   = att.astype(x.dtype) @ x                  (f32, rounded once)

    ``repro/kernels/ref.py::ssd_intra_ref`` with the TPU kernel's one cast
    of att to x's dtype before the second product (a no-op for f32 x, the
    model's path; for bf16 x the kernel's function).  The mask is a select:
    above the diagonal dac_i - dac_j > 0 and exp may overflow to inf, which
    the select drops (a multiply by 0 would make NaN)."""
    s = torch.einsum("gin,gjn->gij", c.float(), b.float())
    seg = dac[:, :, None] - dac[:, None, :]
    q = c.shape[1]
    tri = torch.ones((q, q), dtype=torch.bool, device=c.device).tril()
    att = torch.where(tri[None], s * torch.exp(seg), 0.0) * dt[:, None, :]
    y = torch.einsum("gij,gjp->gip", att.to(x.dtype).float(), x.float())
    return y.to(x.dtype)


def ssd_intra_heads_ref(x: torch.Tensor, dt: torch.Tensor, dac: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor,
                        chunk: int) -> torch.Tensor:
    """The intra-chunk term of every head and chunk at the model's layout:
    x [b, s, h, p]; dt, dac [b, s, h]; B, C [b, s, g, n] (head k reads
    group k // (h // g)); s a whole number of chunks.  Returns y_intra
    [b, s, h, p].  The arrangement ``_ssd_chunked`` made before the kernel
    read the model's layout: B and C repeated over the heads, every operand
    copied into G = (batch, chunk, head) groups of ``chunk`` rows, then
    ``ssd_intra_ref`` and y laid back."""
    bsz, s, h, p = x.shape
    nc = s // chunk
    rep = h // B.shape[2]

    def groups(t):  # [b, s, h, ...] -> [b * nc * h, chunk, ...]
        t = t.reshape((bsz, nc, chunk) + t.shape[2:]).movedim(3, 2)
        return t.reshape((bsz * nc * h, chunk) + t.shape[4:]).contiguous()

    y = ssd_intra_ref(groups(C.repeat_interleave(rep, dim=2)),
                      groups(B.repeat_interleave(rep, dim=2)), groups(x),
                      groups(dt), groups(dac))
    return y.reshape(bsz, nc, h, chunk, p).movedim(2, 3).reshape(bsz, s, h,
                                                                   p)
