"""The transposed Cannon on the wx kernel: the Cannon half of
``repro/kernels/fused_ring.py`` (``cannon_t_step``, the custom VJP
``_wx_acc``, and ``cannon_t_loop``, the form ``fused_cannon_t`` takes
everywhere but on a TPU).

Each multiply-accumulate step ``acc + w @ x`` is one launch of the wx
kernel (``kernels/wx.py``), and its backward runs the reference's VJP:
dx through the same kernel, dw through block_matmul.  The rotations
between steps are ``core/comm.rotate``.  The reference's other form, the
whole q-step loop as one TPU kernel with the rotations as in-kernel remote
copies (``_cannon_kernel``), is not ported: its Hopper counterpart needs
the rotations over NVLink during the step kernel (ROADMAP.md, queue 2
item 5).  The 1-D ring kernels of that file are queue 2 items 2-3.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import comm
from repro_torch.kernels.block_matmul import block_matmul
from repro_torch.kernels.wx import wx


class _WxAcc(torch.autograd.Function):
    """``a + w @ x`` for w [m, t], x [L, t, c], a [L, m, c] or None, in
    ``out_dtype``, with the reference's backward (``_wx_acc_bwd``), for
    dy [L, m, c] in ``out_dtype``:

      * da = dy;
      * dx [L, t, c] = w.T @ dy_l through the same kernel, w read across its
        rows and cast to dy's dtype (the reference's
        ``w.T.astype(dy.dtype)``), the result cast to x's dtype;
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
            dx = wx(w.to(dy.dtype), dy, None, out_dtype=dy.dtype,
                    w_t=True).to(x.dtype)
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
