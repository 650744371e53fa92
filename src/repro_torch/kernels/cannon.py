"""One step of the 2-D token mix's transposed Cannon: the wrapper of the
hand-written Hopper kernel ``csrc/cannon.cu``, and the q x q ranks of a
mesh held in one process (``cannon_fwd_all``).

The counterpart of ``repro/kernels/fused_ring.py::_cannon_kernel`` (the
Pallas TPU kernel: one ``pallas_call`` over the q steps of a Cannon loop,
the rotations as remote DMAs to the mtp and mdom predecessors).  Here one
launch is one step of one rank (``cannon_step``): ``out = out + w @ x[l]``
and the stores of w and x into the predecessors' receive slots.
``kernels/fused_ring.py::fused_cannon_t`` runs the q steps of a loop with a
stream synchronisation and a model-group barrier before each (the slot
discipline of ``ring.cu``), its slots in two ``ring.RingWorkspace``s whose
peer is the predecessor: w's in the mtp group, x's in the mdom group.

On CUDA tensors ``cannon_step`` launches the kernel, or raises; on CPU
tensors it computes the plain version (``ref.wx_ref`` and copies).  Nothing
falls back from one to the other.  ``cannon_step.launches`` counts the
launches; nothing else adds to it.  The library is built like
block_matmul's (``kernels/build.py``), from its own source and the headers
it includes.

The bf16 kernel reads w and x through TMA tensor maps, so each may have
padded rows (``ring.row_stride``; the plan: ``ring.tma_operands_cannon``):
the loop's callers pad the rank's own blocks once per loop
(``ring.pad_rows``), the receive slots hold the padded layout, and the
hops copy it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.kernels import ring
from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.ref import wx_ref
from repro_torch.kernels.ring import (Buffer, _addr, _check_buffer,
                                      _check_hop, row_stride, span_bytes)

_DTYPES = (torch.float32, torch.bfloat16)


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cannon_bf16.argtypes = [vp, vp, vp, vp, vp] + [i32] * 11 + [vp]
    lib.cannon_f32.argtypes = [vp, vp, vp, vp, vp] + [i32] * 8 + [vp]
    lib.cannon_attrs.argtypes = [i32, i32, ctypes.POINTER(i32)]
    lib.cannon_bf16.restype = lib.cannon_f32.restype = i32
    lib.cannon_attrs.restype = i32
    lib.cannon_error_string.argtypes = [i32]
    lib.cannon_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("cannon", "cannon.cu",
                        ["gemm_core.cuh", "gemm_sm90.cuh"], _bind)
build_info = LIBRARY.info        # build seconds, library path


def build() -> bool:
    """Compile (if these sources have no library yet) and load the kernel
    library.  Returns True when this call ran ``nvcc``."""
    return LIBRARY.load()


def kernel_attrs(out_bf16: bool = False, f32: bool = False
                 ) -> Dict[str, int]:
    """Registers, local (spill) bytes, static and dynamic shared bytes and
    block size of a Cannon kernel: bf16 operands (the Hopper loop) with an
    f32 or bf16 out, or the f32 kernel.  Loads the library."""
    build()
    out = (ctypes.c_int * 5)()
    rc = LIBRARY.lib.cannon_attrs(int(f32), int(out_bf16), out)
    if rc != 0:
        raise RuntimeError(f"cannon_attrs: CUDA error {rc} "
                           f"({LIBRARY.error_string(rc)})")
    return dict(zip(("registers", "local_bytes", "static_shared_bytes",
                     "dynamic_shared_bytes", "threads"), out))


def _vec16(src: Buffer, dst: Optional[Buffer]) -> int:
    return int(dst is not None and span_bytes(src) % 16 == 0
               and _addr(src) % 16 == 0 and _addr(dst) % 16 == 0)


def cannon_step(w: Buffer, x: Buffer, out: torch.Tensor, *, first: bool,
                w_dest: Optional[Buffer] = None,
                x_dest: Optional[Buffer] = None) -> None:
    """One Cannon step of one rank: ``out[l] = (0 if first else out[l]) +
    w @ x[l]`` for w [M, K], x [L, K, N], out [L, M, N] (the sum over K in
    f32, the add in f32, one rounding to out's dtype, f32 or bf16), and
    ``w_dest = w``, ``x_dest = x`` where given (the predecessors' receive
    slots, in the layout of w and x; None at the last step).  w and x are
    tensors or receive slots, with dense rows at any row stride: bf16 on
    the card at strides that TMA takes (``ring.check_tma``), f32 there
    contiguous; out is contiguous."""
    if len(w.shape) != 2 or len(x.shape) != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"cannon: needs w [M, K] and x [L, K, N]; got "
                         f"{list(w.shape)} and {list(x.shape)}")
    if w.dtype not in _DTYPES or x.dtype != w.dtype:
        raise TypeError(f"cannon: w and x must share a dtype, float32 or "
                        f"bfloat16; got {w.dtype} and {x.dtype}")
    ll, k, n = x.shape
    m = w.shape[0]
    dev = x.device
    for name, b, shape in (("w", w, (m, k)), ("x", x, (ll, k, n))):
        _check_buffer(b, name, shape, b.dtype, dev, "cannon", padded=True)
    _check_buffer(out, "out", (ll, m, n), out.dtype, dev, "cannon")
    if out.dtype not in _DTYPES:
        raise TypeError(f"cannon: out must be float32 or bfloat16, not "
                        f"{out.dtype}")
    for name, dest, src in (("w_dest", w_dest, w), ("x_dest", x_dest, x)):
        if dest is not None:
            _check_buffer(dest, name, tuple(src.shape), src.dtype, dev,
                          "cannon", padded=True)
            _check_hop(src, dest, name, "cannon")
    if dev.type == "cpu":
        out.copy_(wx_ref(w, x, None if first else out, out.dtype))
        for dest, src in ((w_dest, w), (x_dest, x)):
            if dest is not None:
                dest.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"cannon runs on cuda or cpu, not {dev}")
    if k == 0 or m == 0 or n == 0 or ll == 0:
        raise ValueError(f"cannon: unsupported shape L={ll}, M={m}, N={n}, "
                         f"K={k}")
    bf16 = w.dtype == torch.bfloat16
    if bf16:
        ops = ring.tma_operands_cannon(ll, m, n, k)
        lds = (ring.check_tma(w, ops["w"], "cannon"),
               ring.check_tma(x, ops["x"], "cannon"))
    elif row_stride(w) != k or row_stride(x) != n:
        raise ValueError("cannon: the f32 kernel takes w and x contiguous")
    build()
    lib = LIBRARY.lib
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        args = (_addr(w), _addr(x), out.data_ptr(), _addr(w_dest),
                _addr(x_dest), ll, m, n, k)
        hops = (_vec16(w, w_dest), _vec16(x, x_dest))
        out_bf16 = int(out.dtype == torch.bfloat16)
        if bf16:
            vec2 = int(n % 2 == 0 and out.data_ptr() % 8 == 0)
            rc = lib.cannon_bf16(*args, *lds, int(first), out_bf16, vec2,
                                 *hops, stream)
        else:
            rc = lib.cannon_f32(*args, int(first), out_bf16, *hops, stream)
    if rc != 0:
        raise RuntimeError(f"cannon: launch failed with CUDA error {rc} "
                           f"({LIBRARY.error_string(rc)}) at L={ll} M={m} "
                           f"N={n} K={k} {w.dtype}")
    cannon_step.launches += 1


cannon_step.launches = 0


def cannon_fwd_all(ws: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                   q: int, *, accum_dtype: torch.dtype = torch.float32
                   ) -> List[torch.Tensor]:
    """The Cannon loop of the q x q ranks of a mesh held in one process
    (rank r = i * q + j holds its skewed blocks ``ws[r]`` [M, K] and
    ``xs[r]`` [L, K, N]) -> every rank's [L, M, N] in ``accum_dtype``.
    Rank (i, j)'s step s writes the slots s % 2 of ranks (i, j - 1) (w) and
    (i - 1, j) (x), tensors here; all launches run in order on one stream,
    which is the barrier of the slot discipline."""
    n = q * q
    outs = [torch.empty((x.shape[0], w.shape[0], x.shape[2]),
                        dtype=accum_dtype, device=x.device)
            for w, x in zip(ws, xs)]
    # each rank's blocks in the layout the kernel reads (padded rows where
    # TMA needs them), once per loop; the slots hold the same layout
    ws = [ring.pad_rows(w) for w in ws]
    xs = [ring.pad_rows(x) for x in xs]
    w_slots = [[ring.empty_rows_like(w) for _ in range(2)] for w in ws]
    x_slots = [[ring.empty_rows_like(x) for _ in range(2)] for x in xs]
    for s in range(q):
        last = s == q - 1
        for r in range(n):
            i, j = divmod(r, q)
            cannon_step(
                ws[r] if s == 0 else w_slots[r][(s - 1) % 2],
                xs[r] if s == 0 else x_slots[r][(s - 1) % 2], outs[r],
                first=s == 0,
                w_dest=None if last else w_slots[i * q + (j - 1) % q][s % 2],
                x_dest=None if last else x_slots[(i - 1) % q * q + j][s % 2])
    return outs
