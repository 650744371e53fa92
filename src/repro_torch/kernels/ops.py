"""Public kernel entry points of the port.

The counterparts of ``repro/kernels/ops.py``: ``matmul`` is the local GEMM
engine that ``JigsawConfig(kernel="pallas")`` selects, ``matmul_nd`` runs it
over the last dim of any-rank x, and ``mixer_mlp`` is the WeatherMixer MLP
as two kernel calls with the GELU fused into the first one's epilogue; all
three are differentiable.  ``ssd_intra`` is the Mamba-2 intra-chunk term
(forward only), and ``ssd_intra_heads`` the same term read at the model's
layout.
The reference pads every dim to its block grid; the Hopper kernel masks
ragged edges itself, so nothing is padded here.

``matmul`` is an ``autograd.Function`` with the semantics of the
reference's custom VJP (``_matmul_fwd`` / ``_matmul_bwd``): every backward
GEMM is a launch of the same kernel, reading its operands in their stored
layout (``block_matmul``'s ``x_t`` / ``w_t``), so no operand is transposed
in memory.  GELU', the bias gradient and the casts stay plain PyTorch, as
they sit outside the Pallas kernel in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.block_matmul import block_matmul
from repro_torch.kernels.ref import act_grad
from repro_torch.kernels import ssd_chunk
from repro_torch.kernels.ssd_chunk import ssd_intra_chunk


class _Matmul(torch.autograd.Function):
    """``epilogue(x @ w.T + b)`` with the reference's backward.

    Saves (x, w, b), with w in its own dtype.  Backward, for dy [M, N] in
    x.dtype (the output's):

      * epilogue "none": dz = dy.  Otherwise the pre-activation is
        recomputed with one more kernel launch (cheaper than saving it),
        rounded to x.dtype as the kernel's output is, and up-cast:
        dz = (act'(z) * dy) in f32, rounded to dy.dtype;
      * dx [M, K] = dz @ w (w read as w.T, its rows across), in x.dtype;
        skipped when x needs no gradient (the encoder's input is data);
      * dw [N, K] = dz.T @ x (both read across their rows), in w.dtype;
      * db = sum(dz) over rows, in b.dtype.
    """

    @staticmethod
    def forward(ctx, x, w, b, epilogue):
        ctx.epilogue = epilogue
        ctx.save_for_backward(x, w, b)
        # one operand width for the kernel, as the reference's _matmul_raw:
        # w follows x (bf16 weights under f32 activations run an f32 GEMM)
        return block_matmul(x, w.to(x.dtype), b, epilogue)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        # dy is a transposed view where the token mix hands its output back
        # transposed: its contiguous copy is the backward of that transpose
        dy = dy.contiguous()
        wx = w.to(x.dtype)
        if ctx.epilogue == "none":
            dz = dy
        else:
            z = block_matmul(x, wx, b, "none").float()
            dz = (act_grad(ctx.epilogue)(z) * dy.float()).to(dy.dtype)
        dx = db = None
        if ctx.needs_input_grad[0]:
            dx = block_matmul(dz, wx, w_t=True)
        dw = block_matmul(dz, x, x_t=True, w_t=True).to(w.dtype)
        if b is not None and ctx.needs_input_grad[2]:
            db = dz.sum(dim=0).to(b.dtype)
        return dx, dw, db, None


def matmul(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None, *,
           epilogue: str = "none") -> torch.Tensor:
    """``epilogue(x @ w.T + b)`` for 2-D x [M, K], w [N, K]; differentiable
    in x, w and b."""
    return _Matmul.apply(x, w, b, epilogue)


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


def ssd_intra(c: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
              dt: torch.Tensor, dac: torch.Tensor) -> torch.Tensor:
    """The Mamba-2 intra-chunk SSD term on the kernel's grid
    (``kernels/ssd_chunk.py``): c, b [G, Q, N]; x [G, Q, P]; dt, dac [G, Q]
    -> y [G, Q, P].  The caller (``models/layers.py::_ssd_chunked``) lays
    the mamba2 tensors out as G = (batch, chunk, head) groups.  Not
    differentiable: the port runs the ssm family's forward only so far."""
    return ssd_intra_chunk(c, b, x, dt, dac)


def ssd_intra_heads(x: torch.Tensor, dt: torch.Tensor, dac: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       chunk: int) -> torch.Tensor:
    """The same term at the model's layout (``kernels/ssd_chunk.py``):
    x [b, s, h, p]; dt, dac [b, s, h]; B, C [b, s, g, n] with g head
    groups, read where they lie -> y_intra [b, s, h, p].  The caller
    (``models/layers.py::_ssd_chunked``) pads the sequence to whole chunks.
    Not differentiable."""
    return ssd_chunk.ssd_intra_heads(x, dt, dac, B, C, chunk)
