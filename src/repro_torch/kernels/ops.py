"""Public GEMM entry points of the port (forward only so far).

The counterparts of ``repro/kernels/ops.py``: ``matmul`` is the local GEMM
engine that ``JigsawConfig(kernel="pallas")`` selects, ``matmul_nd`` runs it
over the last dim of any-rank x, and ``mixer_mlp`` is the WeatherMixer MLP
as two kernel calls with the GELU fused into the first one's epilogue.
The reference pads every dim to its block grid; the Hopper kernel masks
ragged edges itself, so nothing is padded here.  The backward GEMMs
(``_matmul_bwd`` in the reference) come with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.block_matmul import block_matmul


def matmul(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *,
           epilogue: str = "none") -> torch.Tensor:
    """``epilogue(x @ w.T + b)`` for 2-D x [M, K], w [N, K]."""
    if w.dtype != x.dtype:
        # one operand width for the kernel, as the reference's _matmul_raw:
        # w follows x (bf16 weights under f32 activations run an f32 GEMM)
        w = w.to(x.dtype)
    return block_matmul(x, w, b, epilogue)


def matmul_nd(x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None, *,
              epilogue: str = "none") -> torch.Tensor:
    """``matmul`` over the last dim of an arbitrary-rank x [..., d_in]."""
    y = matmul(x.reshape(-1, x.shape[-1]), w, b, epilogue=epilogue)
    return y.reshape(*x.shape[:-1], w.shape[0])


def mixer_mlp(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
              w2: torch.Tensor, b2: Optional[torch.Tensor]) -> torch.Tensor:
    """``gelu(x @ w1.T + b1) @ w2.T + b2`` over the last dim of
    x [..., rows, d_in]; w1 [d_h, d_in], w2 [d_out, d_h].  The hidden
    activation is rounded to ``x.dtype`` between the two kernel calls."""
    x2 = x.reshape(-1, x.shape[-1])
    h = matmul(x2, w1, b1, epilogue="gelu")
    y = matmul(h, w2, b2, epilogue="none")
    return y.reshape(*x.shape[:-1], w2.shape[0])
