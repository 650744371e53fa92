"""``C = epilogue(A @ B.T + b)``: the wrapper of the hand-written Hopper
kernel ``csrc/block_matmul.cu``, its builder, and its ctypes binding.

The counterpart of ``repro/kernels/block_matmul.py`` (the Pallas TPU kernel).
A is ``x`` [M, K], or ``x.T`` when ``x_t`` (x stored [K, M]); B is ``w``
[N, K], or ``w.T`` when ``w_t`` (w stored [K, N]).  The backward GEMMs of
``ops.matmul`` read their operands across the rows this way, so no operand is
transposed in memory.  On a CUDA tensor ``block_matmul`` launches the kernel,
or raises; on a CPU tensor it computes the plain PyTorch version
(``ref.block_matmul_ref``).  Nothing falls back from one to the other.

The kernel has three routes (``route``): bf16 operands run the Hopper loop
(``"sm90"``: wgmma fed by TMA, ``csrc/gemm_sm90.cuh``) unless M or N is
under ``SM90_MIN_SIDE``, where a [128 x 256] tile would be mostly empty
(Mamba-2's decode step, M = 4; its in_dt, N = 24): those run the WMMA loop
(``"wmma"``, ``csrc/gemm_core.cuh``).  Both are hand-written and give the
same bits.  f32 operands run exact FMA tiles (``"f32"``).  The Hopper loop
reads each operand through a TMA tensor map, whose row stride must be a
multiple of 16 bytes: an operand with rows of 16,380 bf16 is padded once
per call (``sm90.pad_rows``).

The kernel is compiled with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the repository root on first use, one shared library
per source content, and bound with ``ctypes`` (a plain C interface: no
PyTorch headers, so the build takes seconds; ``kernels/build.py``).
``block_matmul.launches`` counts the launches of the kernel,
``block_matmul.layout_launches`` the same launches by operand layout
``(x_t, w_t)`` and ``block_matmul.route_launches`` by route; nothing else
adds to them.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from repro_torch.kernels import sm90
from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.ref import block_matmul_ref

EPILOGUES = {"none": 0, "gelu": 1, "silu": 2}
ROUTES = {"sm90": 0, "wmma": 1, "f32": 2}   # block_matmul_attrs' numbering
# bf16 GEMMs with M and N both at least this run the Hopper loop; below it
# the WMMA loop's [128 x 128] tiles are the faster (Mamba-2's decode step
# and in_dt on an H100)
SM90_MIN_SIDE = 64

_MAX_GRID_Y = 65535
_TILE = 128                      # output tile edge of the WMMA and f32 loops


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.block_matmul_sm90.argtypes = [vp, vp, vp, vp] + [i32] * 9 + [vp]
    lib.block_matmul_sm90.restype = i32
    lib.block_matmul_bf16.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                      i32, i32, i32, vp]
    lib.block_matmul_bf16.restype = i32
    lib.block_matmul_attrs.argtypes = [i32] * 5 + [ctypes.POINTER(i32)]
    lib.block_matmul_attrs.restype = i32
    lib.block_matmul_f32.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                     i32, i32, vp]
    lib.block_matmul_f32.restype = i32
    lib.block_matmul_error_string.argtypes = [i32]
    lib.block_matmul_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("block_matmul", "block_matmul.cu",
                        ["gemm_core.cuh", "gemm_sm90.cuh"], _bind)
build_info = LIBRARY.info        # build seconds, library path


def build() -> bool:
    """Compile (if these sources have no library yet) and load the kernel
    library.  Returns True when this call ran ``nvcc``."""
    return LIBRARY.load()


def route(m: int, n: int, dtype: torch.dtype) -> str:
    """The kernel route of a GEMM with an [M, N] result in ``dtype``:
    ``"f32"`` for f32 operands; for bf16, ``"sm90"`` (the Hopper loop) when
    M and N are both at least ``SM90_MIN_SIDE``, else ``"wmma"``."""
    if dtype == torch.float32:
        return "f32"
    return "sm90" if min(m, n) >= SM90_MIN_SIDE else "wmma"


def kernel_attrs(route_name: str, x_t: bool = False, w_t: bool = False,
                 epilogue: str = "none", vec: int = 16):
    """Registers, local (spill) bytes, static and dynamic shared bytes and
    block size of a kernel variant: the route, the layout, the epilogue
    (the Hopper loop's variants) or the load width (the WMMA loop's).
    Loads the library."""
    return sm90.kernel_attrs(LIBRARY, "block_matmul_attrs",
                             ROUTES[route_name], int(x_t), int(w_t),
                             EPILOGUES[epilogue], vec)


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
                 w_t: bool = False,
                 route_name: Optional[str] = None) -> torch.Tensor:
    """``epilogue(A @ B.T + b)`` -> [M, N] in ``x.dtype``: A = x [M, K]
    (or x.T when ``x_t``, x stored [K, M]), B = w [N, K] (or w.T when
    ``w_t``, w stored [K, N]), b [N] or None; f32 accumulation, bias and
    activation in f32.

    CUDA tensors must be contiguous in the layout they are stored in; the
    kernel masks ragged M, N, K.  The route: ``route``, unless
    ``route_name`` names one (``"sm90"`` or ``"wmma"`` for bf16): the card
    tests and the smoke run hold the two bf16 routes to each other.
    """
    m, n, k = _check(x, w, b, epilogue, x_t, w_t)
    if x.device.type == "cpu":
        return block_matmul_ref(x, w, b, epilogue, x_t=x_t, w_t=w_t)
    if x.device.type != "cuda":
        raise ValueError(f"block_matmul runs on cuda or cpu, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("block_matmul needs contiguous x and w")
    path = route(m, n, x.dtype)
    if route_name is not None:
        if (route_name == "f32") != (path == "f32") \
                or route_name not in ROUTES:
            raise ValueError(f"block_matmul: no route {route_name!r} for "
                             f"{x.dtype}")
        path = route_name
    if k == 0 or (path != "sm90"
                  and (m + _TILE - 1) // _TILE > _MAX_GRID_Y):
        raise ValueError(f"block_matmul: unsupported shape M={m}, K={k}")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    if path == "sm90":
        ops = sm90.tma_operands_block_matmul(m, n, k, x_t, w_t)
        # rows TMA cannot take (16,380 bf16) padded, once per call
        x, w = sm90.pad_rows(x), sm90.pad_rows(w)
        lds = (sm90.check_tma(x, ops["x"], "block_matmul"),
               sm90.check_tma(w, ops["w"], "block_matmul"))
    bias = None if b is None else b.to(torch.float32).contiguous()
    build()
    lib = LIBRARY.lib
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = (x.data_ptr(), w.data_ptr(),
                None if bias is None else bias.data_ptr(), y.data_ptr(),
                m, n, k)
        flags = (EPILOGUES[epilogue], int(x_t), int(w_t))
        if path == "sm90":
            vec2 = int(n % 2 == 0 and y.data_ptr() % 4 == 0)
            rc = lib.block_matmul_sm90(*ptrs, *lds, *flags, vec2, stream)
        elif path == "wmma":
            rc = lib.block_matmul_bf16(*ptrs, *flags, vec_bytes(x, w),
                                       stream)
        else:
            rc = lib.block_matmul_f32(*ptrs, *flags, stream)
    if rc != 0:
        raise RuntimeError(f"block_matmul: launch failed with CUDA error "
                           f"{rc} ({LIBRARY.error_string(rc)}) at M={m} "
                           f"N={n} K={k} {x.dtype} x_t={x_t} w_t={w_t} "
                           f"route={path}")
    block_matmul.launches += 1
    block_matmul.layout_launches[(x_t, w_t)] += 1
    block_matmul.route_launches[path] += 1
    return y


block_matmul.launches = 0
# (False, False): forward and recomputes; (False, True): dx = dz @ w;
# (True, True): dw = dz.T @ x
block_matmul.layout_launches = collections.Counter()
# "sm90" | "wmma" | "f32" (``route``)
block_matmul.route_launches = collections.Counter()
