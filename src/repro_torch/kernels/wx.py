"""``out[l] = a[l] + W @ x[l]``: the wrapper of the hand-written Hopper kernel
``csrc/wx.cu``, the transposed-Cannon step of the 2-D token mix.

The counterpart of ``repro/kernels/fused_ring.py::_wx_kernel`` (the Pallas
TPU kernel, called through ``_wx_raw``).  W is ``w`` [M, K], or ``w.T`` when
``w_t`` (w stored [K, M]: the backward's dx = w.T @ dy reads w across its
rows); x is [L, K, N] and is contracted over its second-to-last dim, so it
is never transposed; a is [L, M, N] in ``out_dtype`` or None (zero).  The
sum over K is f32, a is added in f32, and the result is rounded once to
``out_dtype`` (the Cannon accumulator's dtype: f32, or bf16 under the
``bf16_pure`` policy).

On a CUDA tensor ``wx`` launches the kernel, or raises; on a CPU tensor it
computes the plain PyTorch version (``ref.wx_ref``).  Nothing falls back
from one to the other.  ``wx.launches`` counts the launches of the kernel,
and ``wx.layout_launches`` the same launches by ``w_t``; nothing else adds
to them.  The kernel library is built like block_matmul's
(``kernels/build.py``), from its own source, in parallel with it when both
builds are asked for at once.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from repro_torch.kernels.block_matmul import vec_bytes
from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.ref import wx_ref

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID = 65535
_TILE = 128


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wx_bf16.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                            i32, vp]
    lib.wx_bf16.restype = i32
    lib.wx_f32.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp]
    lib.wx_f32.restype = i32
    lib.wx_error_string.argtypes = [i32]
    lib.wx_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("wx", "wx.cu", ["gemm_core.cuh"], _bind)
build_info = LIBRARY.info        # build seconds, library path


def build() -> bool:
    """Compile (if these sources have no library yet) and load the kernel
    library.  Returns True when this call ran ``nvcc``."""
    return LIBRARY.load()


def _check(w, x, a, out_dtype, w_t):
    if w.dim() != 2 or x.dim() != 3:
        raise ValueError(f"wx needs w [M, K] and x [L, K, N]; got "
                         f"{tuple(w.shape)} and {tuple(x.shape)}")
    m, k = (w.shape[1], w.shape[0]) if w_t else (w.shape[0], w.shape[1])
    ll, kx, n = x.shape
    if kx != k:
        raise ValueError(f"wx: K of w ({k}, w_t={w_t}) != K of x ({kx}) for "
                         f"w {tuple(w.shape)} and x {tuple(x.shape)}")
    if w.dtype != x.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"wx needs one operand dtype, float32 or bfloat16; "
                        f"got {w.dtype} and {x.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"wx: out_dtype must be float32 or bfloat16, not "
                        f"{out_dtype}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device}, x on {x.device}")
    if a is not None and (a.shape != (ll, m, n) or a.dtype != out_dtype
                          or a.device != x.device):
        raise ValueError(f"a must be [{ll}, {m}, {n}] {out_dtype} on "
                         f"{x.device}; got {tuple(a.shape)} {a.dtype} on "
                         f"{a.device}")
    return ll, m, n, k


def wx(w: torch.Tensor, x: torch.Tensor, a: Optional[torch.Tensor] = None,
       *, out_dtype: torch.dtype = torch.float32,
       w_t: bool = False) -> torch.Tensor:
    """``a[l] + W @ x[l]`` -> [L, M, N] in ``out_dtype``.

    CUDA tensors must be contiguous as stored; the kernel masks ragged M,
    N, K."""
    ll, m, n, k = _check(w, x, a, out_dtype, w_t)
    if x.device.type == "cpu":
        return wx_ref(w, x, a, out_dtype, w_t=w_t)
    if x.device.type != "cuda":
        raise ValueError(f"wx runs on cuda or cpu, not {x.device}")
    if not (w.is_contiguous() and x.is_contiguous()
            and (a is None or a.is_contiguous())):
        raise ValueError("wx needs contiguous w, x and a")
    if k == 0 or ll > _MAX_GRID or (m + _TILE - 1) // _TILE > _MAX_GRID:
        raise ValueError(f"wx: unsupported shape L={ll}, M={m}, K={k}")
    out = torch.empty((ll, m, n), dtype=out_dtype, device=x.device)
    if ll == 0 or m == 0 or n == 0:
        return out
    build()
    lib = LIBRARY.lib
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        args = (w.data_ptr(), x.data_ptr(),
                None if a is None else a.data_ptr(), out.data_ptr(),
                ll, m, n, k, int(w_t), int(out_dtype == torch.bfloat16))
        if x.dtype == torch.bfloat16:
            rc = lib.wx_bf16(*args, vec_bytes(w, x), stream)
        else:
            rc = lib.wx_f32(*args, stream)
    if rc != 0:
        raise RuntimeError(f"wx: launch failed with CUDA error {rc} "
                           f"({LIBRARY.error_string(rc)}) at L={ll} M={m} "
                           f"N={n} K={k} {x.dtype} w_t={w_t}")
    wx.launches += 1
    wx.layout_launches[w_t] += 1
    return out


wx.launches = 0
# False: forward steps and their recompute; True: dx = w.T @ dy
wx.layout_launches = collections.Counter()
