"""The Mamba-2 intra-chunk SSD term: the wrapper of the hand-written Hopper
kernel ``csrc/ssd_chunk.cu``, its builder and its ctypes binding.

The counterpart of ``repro/kernels/ssd_chunk.py`` (the Pallas TPU kernel
``_kernel``, called through ``ssd_intra_chunk``).  Per group g of
G = batch x chunks x heads, with c, b [Q, N], x [Q, P] and dt, dac [Q]:

  att[i, j] = where(i >= j, (c_i . b_j) * exp(dac_i - dac_j), 0) * dt_j
  y         = att.astype(x.dtype) @ x                      [Q, P]

On a CUDA tensor ``ssd_intra_chunk`` launches the kernel, or raises; on a
CPU tensor it computes the plain PyTorch version (``ref.ssd_intra_ref``).
Nothing falls back from one to the other.  ``ssd_intra_chunk.launches``
counts the launches of the kernel; nothing else adds to it.  The library is
built like block_matmul's (``kernels/build.py``), from its own source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.ref import ssd_intra_ref

Q_MAX, N_MAX, P_MAX = 64, 128, 128     # what one thread block holds
_DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.ssd_chunk_f32, lib.ssd_chunk_bf16):
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, vp]
        fn.restype = i32
    lib.ssd_chunk_error_string.argtypes = [i32]
    lib.ssd_chunk_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("ssd_chunk", "ssd_chunk.cu", [], _bind)
build_info = LIBRARY.info        # build seconds, library path


def build() -> bool:
    """Compile (if this source has no library yet) and load the kernel
    library.  Returns True when this call ran ``nvcc``."""
    return LIBRARY.load()


def _check(c, b, x, dt, dac):
    if c.dim() != 3 or b.shape != c.shape or x.dim() != 3:
        raise ValueError(f"ssd_intra_chunk needs c, b [G, Q, N] and x "
                         f"[G, Q, P]; got {tuple(c.shape)}, {tuple(b.shape)}"
                         f" and {tuple(x.shape)}")
    g, q, n = c.shape
    if x.shape[:2] != (g, q) or dt.shape != (g, q) or dac.shape != (g, q):
        raise ValueError(f"ssd_intra_chunk: x must be [{g}, {q}, P] and dt, "
                         f"dac [{g}, {q}]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)} and {tuple(dac.shape)}")
    if x.dtype not in _DTYPES or c.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"ssd_intra_chunk needs c, b and x of one dtype, "
                        f"float32 or bfloat16; got {c.dtype}, {b.dtype}, "
                        f"{x.dtype}")
    if dt.dtype != torch.float32 or dac.dtype != torch.float32:
        raise TypeError(f"ssd_intra_chunk needs float32 dt and dac; got "
                        f"{dt.dtype} and {dac.dtype}")
    if any(t.device != x.device for t in (c, b, dt, dac)):
        raise ValueError("ssd_intra_chunk: operands on different devices")
    p = x.shape[2]
    if not (1 <= q <= Q_MAX and 1 <= n <= N_MAX and 1 <= p <= P_MAX):
        raise ValueError(f"ssd_intra_chunk: unsupported shape Q={q}, N={n}, "
                         f"P={p} (the kernel takes Q <= {Q_MAX}, N <= "
                         f"{N_MAX}, P <= {P_MAX})")
    return g, q, n, p


def ssd_intra_chunk(c: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                    dt: torch.Tensor, dac: torch.Tensor) -> torch.Tensor:
    """Batched intra-chunk SSD: c, b [G, Q, N]; x [G, Q, P]; dt, dac [G, Q]
    (dt post-softplus, dac the within-chunk cumsum of dt * A).  Returns
    y [G, Q, P] in x's dtype.  G flattens (batch x chunks x heads).

    Q <= 64, N <= 128, P <= 128 on either device (what the kernel holds),
    so a shape the card would refuse fails on the CPU too; CUDA tensors must
    be contiguous."""
    g, q, n, p = _check(c, b, x, dt, dac)
    if x.device.type == "cpu":
        return ssd_intra_ref(c, b, x, dt, dac)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk runs on cuda or cpu, not "
                         f"{x.device}")
    if not all(t.is_contiguous() for t in (c, b, x, dt, dac)):
        raise ValueError("ssd_intra_chunk needs contiguous c, b, x, dt and "
                         "dac")
    y = torch.empty((g, q, p), dtype=x.dtype, device=x.device)
    if g == 0:
        return y
    build()
    lib = LIBRARY.lib
    fn = lib.ssd_chunk_f32 if x.dtype == torch.float32 else lib.ssd_chunk_bf16
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        rc = fn(c.data_ptr(), b.data_ptr(), x.data_ptr(), dt.data_ptr(),
                dac.data_ptr(), y.data_ptr(), g, q, n, p, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra_chunk: launch failed with CUDA error "
                           f"{rc} ({LIBRARY.error_string(rc)}) at G={g} Q={q}"
                           f" N={n} P={p} {x.dtype}")
    ssd_intra_chunk.launches += 1
    return y


ssd_intra_chunk.launches = 0
