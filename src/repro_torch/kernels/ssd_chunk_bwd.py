"""The backward of the Mamba-2 intra-chunk SSD term at the models' layout:
the wrapper of the hand-written Hopper kernel ``csrc/ssd_chunk_bwd.cu``,
its build function and its ctypes binding.

No TPU kernel has this function: the JAX package differentiates its plain
jnp term (``repro/models/layers.py::_ssd_chunked``), and its Pallas kernel
(``repro/kernels/ssd_chunk.py``) has no VJP.  The port runs the forward on
``csrc/ssd_chunk.cu`` (``ssd_chunk.ssd_intra_heads``), so
``ops.ssd_intra_heads``'s backward launches this kernel on CUDA tensors.

``ssd_intra_heads_bwd(x, dt, dac, B, C, dy, chunk)`` takes the forward's
operands as they lie (x, dy [b, s, h, p]; dt, dac [b, s, h]; B, C
[b, s, g, n], head k reading group k // (h // g)), each at its own
strides, and returns (dx, ddt, ddac, dB, dC), contiguous, in f32.  The
kernel takes f32 only: the model casts x, B and C to f32 before
``_ssd_chunked``, so that is all training needs; bf16 raises.  On a CPU
tensor it computes the plain version (``ref.ssd_intra_heads_bwd_ref``,
which also takes float64 there, for gradient checks); on a CUDA tensor it
launches the kernel, or raises.  Nothing falls back from one to the other.

Each launch adds one to ``ssd_intra_heads_bwd.launches``; nothing else
does (but for the replays of a captured CUDA graph,
``kernels/graphs.py::CountedGraph``).  The library is built like the
forward's (``kernels/build.py``), from its own source.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.ref import ssd_intra_heads_bwd_ref

Q_MAX, N_MAX, P_MAX = 64, 128, 128     # what one thread block holds
_NDIMS = 29      # the launch's int64 parameters (csrc/ssd_chunk_bwd.cu)


def _bind(lib: ctypes.CDLL) -> None:
    if lib.ssd_chunk_bwd_ndims() != _NDIMS:
        raise RuntimeError(f"ssd_chunk_bwd: the library takes "
                           f"{lib.ssd_chunk_bwd_ndims()} launch parameters, "
                           f"the wrapper passes {_NDIMS}")
    vp = ctypes.c_void_p
    lib.ssd_chunk_bwd_launch.argtypes = [vp] * 11 + [
        ctypes.POINTER(ctypes.c_longlong), vp]
    lib.ssd_chunk_bwd_launch.restype = ctypes.c_int
    lib.ssd_chunk_bwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ssd_chunk_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_chunk_bwd_attrs.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.ssd_chunk_bwd_attrs.restype = ctypes.c_int
    lib.ssd_chunk_bwd_error_string.argtypes = [ctypes.c_int]
    lib.ssd_chunk_bwd_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("ssd_chunk_bwd", "ssd_chunk_bwd.cu", [], _bind)
build_info = LIBRARY.info        # build seconds, library path


def build() -> bool:
    """Compile (if this source has no library yet) and load the kernel
    library.  Returns True when this call ran ``nvcc``."""
    return LIBRARY.load()


def kernel_attrs(n: int, p: int):
    """Registers, local (spill) bytes, static and dynamic shared bytes and
    block size of the kernel at state width n and head width p.  Loads
    the library."""
    build()
    out = (ctypes.c_int * 4)()
    rc = LIBRARY.lib.ssd_chunk_bwd_attrs(out)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_bwd_attrs: CUDA error {rc} "
                           f"({LIBRARY.error_string(rc)})")
    return {"registers": out[0], "local_bytes": out[1],
            "static_shared_bytes": out[2],
            "dynamic_shared_bytes":
            int(LIBRARY.lib.ssd_chunk_bwd_smem_bytes(n, p)),
            "threads": out[3]}


def _check(x, dt, dac, bm, cm, dy, chunk):
    name = "ssd_intra_heads_bwd"
    if x.dim() != 4 or bm.dim() != 4 or cm.shape != bm.shape:
        raise ValueError(f"{name} needs x [b, s, h, p] and B, C [b, s, g, "
                         f"n]; got {tuple(x.shape)}, {tuple(bm.shape)} and "
                         f"{tuple(cm.shape)}")
    bsz, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    if (bm.shape[:2] != (bsz, s) or dt.shape != (bsz, s, h)
            or dac.shape != (bsz, s, h) or dy.shape != x.shape):
        raise ValueError(f"{name}: B, C must be [{bsz}, {s}, g, n], dt, dac "
                         f"[{bsz}, {s}, {h}] and dy as x; got "
                         f"{tuple(bm.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(dac.shape)} and {tuple(dy.shape)}")
    if g < 1 or h % g != 0:
        raise ValueError(f"{name}: {h} heads do not split into {g} groups")
    ops = (x, dt, dac, bm, cm, dy)
    if any(t.device != x.device for t in ops):
        raise ValueError(f"{name}: operands on different devices")
    # the kernel's type; float64 for the plain version's gradient checks
    ok = (torch.float32,) + ((torch.float64,) if x.device.type == "cpu"
                             else ())
    if x.dtype not in ok or any(t.dtype != x.dtype for t in ops):
        raise TypeError(f"{name} needs every operand in float32 (the "
                        f"kernel's type); got "
                        f"{[str(t.dtype) for t in ops]}")
    if not (1 <= chunk <= Q_MAX and 1 <= n <= N_MAX and 1 <= p <= P_MAX):
        raise ValueError(f"{name}: unsupported shape Q={chunk}, N={n}, "
                         f"P={p} (the kernel takes Q <= {Q_MAX}, N <= "
                         f"{N_MAX}, P <= {P_MAX})")
    if s % chunk != 0:
        raise ValueError(f"{name}: sequence {s} is not whole chunks of "
                         f"{chunk} (the caller pads)")
    return bsz, s, h, p, g, n


def ssd_intra_heads_bwd(x: torch.Tensor, dt: torch.Tensor, dac: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, dy: torch.Tensor,
                        chunk: int):
    """The VJP of ``ssd_chunk.ssd_intra_heads`` for dy [b, s, h, p]:
    (dx [b, s, h, p], ddt, ddac [b, s, h], dB, dC [b, s, g, n]), f32,
    contiguous.  Q <= 64, N <= 128, P <= 128 and s a whole number of
    chunks on either device, so a shape the card would refuse fails on the
    CPU too."""
    bsz, s, h, p, g, n = _check(x, dt, dac, B, C, dy, chunk)
    if x.device.type == "cpu":
        return ssd_intra_heads_bwd_ref(x, dt, dac, B, C, dy, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_heads_bwd runs on cuda or cpu, not "
                         f"{x.device}")
    dx = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    ddt = torch.empty((bsz, s, h), dtype=torch.float32, device=x.device)
    ddac = torch.empty_like(ddt)
    dB = torch.empty((bsz, s, g, n), dtype=torch.float32, device=x.device)
    dC = torch.empty_like(dB)
    if dx.numel() == 0:
        return dx, ddt, ddac, dB, dC
    vals = [bsz, s, h, g, chunk, n, p, *x.stride(), *dy.stride(),
            *B.stride(), *C.stride(), *dt.stride(), *dac.stride()]
    build()
    arr = (ctypes.c_longlong * len(vals))(*vals)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = LIBRARY.lib.ssd_chunk_bwd_launch(
        x.data_ptr(), dt.data_ptr(), dac.data_ptr(), B.data_ptr(),
        C.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
        ddac.data_ptr(), dB.data_ptr(), dC.data_ptr(), arr, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_intra_heads_bwd: launch failed with CUDA "
                           f"error {rc} ({LIBRARY.error_string(rc)}) at "
                           f"{vals}")
    ssd_intra_heads_bwd.launches += 1
    return dx, ddt, ddac, dB, dC


ssd_intra_heads_bwd.launches = 0
