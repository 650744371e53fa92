"""Plain PyTorch versions of the port's kernels.

They are the oracles the kernels are held against on the card, and the path
a kernel's wrapper takes for a tensor that lies on the CPU.  Each mirrors
``repro/kernels/ref.py``: f32 accumulation (bf16 products are exact in f32,
so an f32 product of the up-cast operands is the reference's
``preferred_element_type=float32``), bias added in f32, the activation in
f32, one rounding to ``x.dtype``.  On the card this needs
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default).
"""
from __future__ import annotations

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


def block_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None,
                     epilogue: str = "none") -> torch.Tensor:
    """``epilogue(x @ w.T + b)`` for x [M, K], w [N, K], b [N] or None."""
    f = act(epilogue)
    out = torch.matmul(x.float(), w.float().t())
    if b is not None:
        out = out + b.float()
    return f(out).to(x.dtype)


def mixer_mlp_ref(x: torch.Tensor, w1: torch.Tensor, b1, w2: torch.Tensor,
                  b2) -> torch.Tensor:
    """The WeatherMixer MLP ``gelu(x @ w1.T + b1) @ w2.T + b2`` over the
    last dim of x [..., d_in]; the hidden activation is rounded to
    ``x.dtype`` between the two products."""
    h = block_matmul_ref(x.reshape(-1, x.shape[-1]), w1, b1, "gelu")
    y = block_matmul_ref(h, w2, b2, "none")
    return y.reshape(*x.shape[:-1], w2.shape[0])
