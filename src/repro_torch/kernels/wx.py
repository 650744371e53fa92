"""``out[l] = a[l] + W @ x[l]``: the wrapper of the hand-written Hopper kernel
``csrc/wx.cu``, the transposed-Cannon step of the 2-D token mix, and its dx.

The counterpart of ``repro/kernels/fused_ring.py::_wx_kernel`` (the Pallas
TPU kernel, called through ``_wx_raw``).  W is ``w`` [M, K], or ``w.T`` when
``w_t`` (w stored [K, M]: the backward's dx = w.T @ dy reads w across its
rows); x is [L, K, N] and is contracted over its second-to-last dim, so it
is never transposed; a is [L, M, N] in ``out_dtype`` or None (zero).  The
sum over K is f32, a is added in f32, and the result is rounded once to
``out_dtype`` (the Cannon accumulator's dtype: f32, or bf16 under the
``bf16_pure`` policy).

Operand dtypes: both f32 (the exact FMA kernel), both bf16 (the Hopper
loop, ``csrc/gemm_sm90.cuh``), or bf16 w with an f32 x: the dx entry, where
x is the f32 cotangent.  There the kernel splits x into three bf16 terms
(``ref.split_bf16x3``) and runs the Hopper loop over them, or over the
first alone when the other two are zero everywhere, which the card decides
(no host sync): every product of a bf16 w and a split term is exact in
f32, so the result is the f32 product in another summation order.
``dx_terms()`` reads how many terms each such launch took.

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
from typing import Dict, Optional

import torch

from repro_torch.kernels import sm90
from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.ref import wx_ref

_DTYPES = (torch.float32, torch.bfloat16)
SPLIT_TERMS = 3


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wx_bf16.argtypes = [vp] * 6 + [i32] * 9 + [vp]
    lib.wx_split.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.wx_f32.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, vp]
    lib.wx_attrs.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
    for fn in ("wx_bf16", "wx_split", "wx_f32", "wx_attrs"):
        getattr(lib, fn).restype = i32
    lib.wx_error_string.argtypes = [i32]
    lib.wx_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("wx", "wx.cu", ["gemm_core.cuh", "gemm_sm90.cuh"],
                        _bind)
build_info = LIBRARY.info        # build seconds, library path


def build() -> bool:
    """Compile (if these sources have no library yet) and load the kernel
    library.  Returns True when this call ran ``nvcc``."""
    return LIBRARY.load()


def kernel_attrs(kernel: str = "sm90", w_t: bool = False,
                 out_bf16: bool = False) -> Dict[str, int]:
    """Registers, local (spill) bytes, static and dynamic shared bytes and
    block size of a wx kernel: ``"sm90"`` (the Hopper loop) or ``"f32"``
    (the exact FMA loop), at w_t and out_bf16, or ``"split"`` (the dx
    route's split pass).  Loads the library."""
    return sm90.kernel_attrs(LIBRARY, "wx_attrs",
                             {"sm90": 0, "split": 1, "f32": 2}[kernel],
                             int(w_t), int(out_bf16))


# one int32 [4] per device: the split route's launches by term count (1 or
# 3), added to by the kernel itself
_TERM_COUNTS: Dict[torch.device, torch.Tensor] = {}


def _term_counts(device: torch.device) -> torch.Tensor:
    if device not in _TERM_COUNTS:
        _TERM_COUNTS[device] = torch.zeros(4, dtype=torch.int32,
                                           device=device)
    return _TERM_COUNTS[device]


def dx_terms() -> Dict[int, int]:
    """The split route's launches so far (since ``reset_dx_terms``) by the
    number of terms they contracted: {1: n, 3: n}.  Synchronises with the
    devices that hold the counts."""
    out = collections.Counter()
    for counts in _TERM_COUNTS.values():
        c = counts.tolist()
        out[1] += c[1]
        out[SPLIT_TERMS] += c[SPLIT_TERMS]
    return {1: out[1], SPLIT_TERMS: out[SPLIT_TERMS]}


def reset_dx_terms() -> None:
    for counts in _TERM_COUNTS.values():
        counts.zero_()


def split_terms(x: torch.Tensor, ld: Optional[int] = None):
    """The dx entry's split pass alone, on the card: x [L, K, N] f32
    contiguous -> (parts [3 L, K, N] bf16 at row stride ``ld``
    (``sm90.tma_ld(N)`` when None: what TMA takes), flag int32 [1]:
    non-zero where a second or third term is not zero somewhere)."""
    ll, k, n = x.shape
    ld = sm90.tma_ld(n) if ld is None else ld
    parts = torch.empty((SPLIT_TERMS * ll, k, ld), dtype=torch.bfloat16,
                        device=x.device)
    flag = torch.empty(1, dtype=torch.int32, device=x.device)
    build()
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = LIBRARY.lib.wx_split(x.data_ptr(), parts.data_ptr(),
                                  flag.data_ptr(), ll, k, n, ld, stream)
    if rc != 0:
        raise RuntimeError(f"wx_split: launch failed with CUDA error {rc} "
                           f"({LIBRARY.error_string(rc)}) at {list(x.shape)}")
    return parts[..., :n], flag


def _check(w, x, a, out_dtype, w_t):
    if w.dim() != 2 or x.dim() != 3:
        raise ValueError(f"wx needs w [M, K] and x [L, K, N]; got "
                         f"{tuple(w.shape)} and {tuple(x.shape)}")
    m, k = (w.shape[1], w.shape[0]) if w_t else (w.shape[0], w.shape[1])
    ll, kx, n = x.shape
    if kx != k:
        raise ValueError(f"wx: K of w ({k}, w_t={w_t}) != K of x ({kx}) for "
                         f"w {tuple(w.shape)} and x {tuple(x.shape)}")
    if x.dtype not in _DTYPES or w.dtype not in (x.dtype, torch.bfloat16):
        raise TypeError(f"wx needs one operand dtype, float32 or bfloat16, "
                        f"or a bfloat16 w with a float32 x; got {w.dtype} "
                        f"and {x.dtype}")
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
    """``a[l] + W @ x[l]`` -> [L, M, N] in ``out_dtype``.  w and x f32, or
    bf16 w with a bf16 or (the dx entry) an f32 x.

    CUDA tensors must be contiguous as stored; the kernel masks ragged M,
    N, K, and pads bf16 rows that TMA cannot take once per call."""
    ll, m, n, k = _check(w, x, a, out_dtype, w_t)
    if x.device.type == "cpu":
        return wx_ref(w, x, a, out_dtype, w_t=w_t)
    if x.device.type != "cuda":
        raise ValueError(f"wx runs on cuda or cpu, not {x.device}")
    if not (w.is_contiguous() and x.is_contiguous()
            and (a is None or a.is_contiguous())):
        raise ValueError("wx needs contiguous w, x and a")
    f32 = w.dtype == torch.float32
    if k == 0:
        raise ValueError(f"wx: unsupported shape L={ll}, M={m}, K={k}")
    out = torch.empty((ll, m, n), dtype=out_dtype, device=x.device)
    if ll == 0 or m == 0 or n == 0:
        return out
    x_dtype = x.dtype
    split = not f32 and x_dtype == torch.float32
    if not f32:
        ops = sm90.tma_operands_wx(ll, m, n, k, w_t)
        w = sm90.pad_rows(w)          # rows TMA cannot take, once per call
        ld_w = sm90.check_tma(w, ops["w"], "wx")
        flag_ptr = counts = None
        if split:
            x, flag = split_terms(x, ops["x"].ld)
            flag_ptr = flag.data_ptr()
            counts = _term_counts(x.device).data_ptr()
        else:
            x = sm90.pad_rows(x)
        ld_x = sm90.check_tma(x[:ll], ops["x"], "wx")
    build()
    lib = LIBRARY.lib
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        a_ptr = None if a is None else a.data_ptr()
        out_bf16 = int(out_dtype == torch.bfloat16)
        if f32:
            rc = lib.wx_f32(w.data_ptr(), x.data_ptr(), a_ptr,
                            out.data_ptr(), ll, m, n, k, int(w_t), out_bf16,
                            stream)
        else:
            vec2 = int(n % 2 == 0 and out.data_ptr() % 8 == 0
                       and (a is None or a.data_ptr() % 8 == 0))
            rc = lib.wx_bf16(w.data_ptr(), x.data_ptr(), a_ptr,
                             out.data_ptr(), flag_ptr, counts, ll, m, n, k,
                             ld_w, ld_x, int(w_t), out_bf16, vec2, stream)
    if rc != 0:
        raise RuntimeError(f"wx: launch failed with CUDA error {rc} "
                           f"({LIBRARY.error_string(rc)}) at L={ll} M={m} "
                           f"N={n} K={k} {w.dtype} x {x_dtype} w_t={w_t}")
    wx.launches += 1
    wx.layout_launches[w_t] += 1
    return out


wx.launches = 0
# False: forward steps and their recompute; True: dx = w.T @ dy
wx.layout_launches = collections.Counter()
