"""Plain PyTorch versions of the port's kernels.

They are the oracles the kernels are held against on the card, and the path
a kernel's wrapper takes for a tensor that lies on the CPU.  Each mirrors
``repro/kernels/ref.py`` (``wx_ref``: ``repro/kernels/fused_ring.py``'s
``_wx_raw``): f32 accumulation (bf16 products are exact in f32,
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
