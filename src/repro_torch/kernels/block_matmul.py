"""``C = epilogue(A @ B.T + b)``: the wrapper of the hand-written Hopper
kernel ``csrc/block_matmul.cu``, its builder, and its ctypes binding.

The counterpart of ``repro/kernels/block_matmul.py`` (the Pallas TPU kernel).
A is ``x`` [M, K], or ``x.T`` when ``x_t`` (x stored [K, M]); B is ``w``
[N, K], or ``w.T`` when ``w_t`` (w stored [K, N]).  The backward GEMMs of
``ops.matmul`` read their operands across the rows this way, so no operand is
transposed in memory.  On a CUDA tensor ``block_matmul`` launches the kernel,
or raises; on a CPU tensor it computes the plain PyTorch version
(``ref.block_matmul_ref``).  Nothing falls back from one to the other.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the repository root on first use, one shared library
per source content, and bound with ``ctypes`` (a plain C interface: no
PyTorch headers, so the build takes seconds; ``kernels/build.py``).
``block_matmul.launches`` counts the launches of the kernel, and
``block_matmul.layout_launches`` the same launches by operand layout
``(x_t, w_t)``; nothing else adds to them.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.ref import block_matmul_ref

EPILOGUES = {"none": 0, "gelu": 1, "silu": 2}

_MAX_GRID_Y = 65535
_TILE = 128                      # output tile edge of both kernel variants


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.block_matmul_bf16.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                      i32, i32, i32, vp]
    lib.block_matmul_bf16.restype = i32
    lib.block_matmul_f32.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                     i32, i32, vp]
    lib.block_matmul_f32.restype = i32
    lib.block_matmul_error_string.argtypes = [i32]
    lib.block_matmul_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("block_matmul", "block_matmul.cu", ["gemm_core.cuh"],
                        _bind)
build_info = LIBRARY.info        # build seconds, library path


def build() -> bool:
    """Compile (if these sources have no library yet) and load the kernel
    library.  Returns True when this call ran ``nvcc``."""
    return LIBRARY.load()


def vec_bytes(*tensors: torch.Tensor) -> int:
    """Widest global-load width (16, 8, 4 or 2 bytes) that every bf16
    operand's base pointer, row stride and (for a batch of matrices) batch
    stride, as stored, allow.  The kernels copy along each operand's
    contiguous dimension, whichever of its logical dimensions that is."""
    for vb in (16, 8, 4):
        if all(t.data_ptr() % vb == 0
               and all(t.stride(d) * t.element_size() % vb == 0
                       for d in range(t.dim() - 1))
               for t in tensors):
            return vb
    return 2


def gemm_dims(x: torch.Tensor, w: torch.Tensor, x_t: bool = False,
              w_t: bool = False):
    """(M, N, K) of ``A @ B.T`` for the operands as stored."""
    m, kx = (x.shape[1], x.shape[0]) if x_t else (x.shape[0], x.shape[1])
    n, kw = (w.shape[1], w.shape[0]) if w_t else (w.shape[0], w.shape[1])
    if kx != kw:
        raise ValueError(f"block_matmul: K of x ({kx}) != K of w ({kw}) for "
                         f"x {tuple(x.shape)} (x_t={x_t}) and w "
                         f"{tuple(w.shape)} (w_t={w_t})")
    return m, n, kx


def _check(x, w, b, epilogue, x_t, w_t):
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r} (none|gelu|silu)")
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"block_matmul needs 2-D x and w; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, n, k = gemm_dims(x, w, x_t, w_t)
    if x.dtype != w.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block_matmul needs one operand dtype, float32 or "
                        f"bfloat16; got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if b is not None and (b.shape != (n,) or b.device != x.device):
        raise ValueError(f"bias must be [{n}] on {x.device}; got "
                         f"{tuple(b.shape)} on {b.device}")
    return m, n, k


def block_matmul(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None,
                 epilogue: str = "none", *, x_t: bool = False,
                 w_t: bool = False) -> torch.Tensor:
    """``epilogue(A @ B.T + b)`` -> [M, N] in ``x.dtype``: A = x [M, K]
    (or x.T when ``x_t``, x stored [K, M]), B = w [N, K] (or w.T when
    ``w_t``, w stored [K, N]), b [N] or None; f32 accumulation, bias and
    activation in f32.

    CUDA tensors must be contiguous in the layout they are stored in; the
    kernel masks ragged M, N, K.
    """
    m, n, k = _check(x, w, b, epilogue, x_t, w_t)
    if x.device.type == "cpu":
        return block_matmul_ref(x, w, b, epilogue, x_t=x_t, w_t=w_t)
    if x.device.type != "cuda":
        raise ValueError(f"block_matmul runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("block_matmul needs contiguous x and w")
    if k == 0 or (m + _TILE - 1) // _TILE > _MAX_GRID_Y:
        raise ValueError(f"block_matmul: unsupported shape M={m}, K={k}")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    bias = None if b is None else b.to(torch.float32).contiguous()
    build()
    lib = LIBRARY.lib
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        args = (x.data_ptr(), w.data_ptr(),
                None if bias is None else bias.data_ptr(), y.data_ptr(),
                m, n, k, EPILOGUES[epilogue], int(x_t), int(w_t))
        if x.dtype == torch.bfloat16:
            rc = lib.block_matmul_bf16(*args, vec_bytes(x, w), stream)
        else:
            rc = lib.block_matmul_f32(*args, stream)
    if rc != 0:
        raise RuntimeError(f"block_matmul: launch failed with CUDA error "
                           f"{rc} ({LIBRARY.error_string(rc)}) at M={m} "
                           f"N={n} K={k} {x.dtype} x_t={x_t} w_t={w_t}")
    block_matmul.launches += 1
    block_matmul.layout_launches[(x_t, w_t)] += 1
    return y


block_matmul.launches = 0
# (False, False): forward and recomputes; (False, True): dx = dz @ w;
# (True, True): dw = dz.T @ x
block_matmul.layout_launches = collections.Counter()
