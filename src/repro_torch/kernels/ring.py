"""The 1-D Jigsaw ring steps: the wrappers of the hand-written Hopper kernels
``csrc/ring.cu``, the receive slots those kernels write into, and the
per-group workspace that holds a rank's slots and those of the peer it
writes to (the ring's successor, or the transposed Cannon's predecessor:
``kernels/cannon.py``).

The counterparts of ``repro/kernels/fused_ring.py::_ring_fwd_kernel`` and
``::_ring_bwd_kernel`` (Pallas TPU kernels: one ``pallas_call`` over the p
steps of a ring, remote DMAs between neighbours).  Here one launch is one
step of one rank (``ring_fwd``, ``ring_bwd``); ``kernels/fused_ring.py``
runs the p steps of a ring call with a stream synchronisation and a group
barrier before each (the slot discipline is documented in ``ring.cu``).

A step's operands are pointers: x, the weight block and the chunk index,
the slot the arrived partial lies in, and where the step writes: the
successor's slot or the rank's own output.  A slot is a ``DeviceBuffer``,
device memory that torch does not own: this rank's own (a raw
``cudaMalloc``), or another process's, mapped by CUDA IPC.  A slot of a
rank held in the same process may also be a tensor: the kernel code is the
same.

The bf16 backward reads its operands through TMA tensor maps
(``csrc/gemm_sm90.cuh``), so each carries its own row stride: the planning
(``tma_operands_ring_bwd``, ``check_tma``, ``pad_rows``: ``kernels/sm90.py``,
imported here under the names this module has had) is shared with the
other kernels on that loop.  The callers that run a ring call pad the
rank's own operands once per call, the slots hold the padded layout and
the hops copy it.

On a CUDA tensor ``ring_fwd`` / ``ring_bwd`` launch the kernel, or raise;
on CPU tensors they compute the plain versions (``ref.ring_fwd_step_ref``,
``ref.ring_bwd_step_ref``).  Nothing falls back from one to the other.
``ring_fwd.launches`` and ``ring_bwd.launches`` count the launches; nothing
else adds to them.  The library is built like block_matmul's
(``kernels/build.py``), from its own source.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import os
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.kernels import sm90
from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.ref import ring_bwd_step_ref, ring_fwd_step_ref
# the TMA planning of the Hopper loop, shared with block_matmul, wx and the
# Cannon step (``kernels/sm90.py``), under the names this module has had
from repro_torch.kernels.sm90 import (  # noqa: F401
    BOX_K, BOX_MN, H100_SMS, SM90_TILE, TMA_ALIGN, TMA_MAX_BOX,
    TMA_SWIZZLE_BYTES, TmaOperand, check_tma, pad_rows, persistent_grid,
    plan_operand, row_stride, sm90_tiles, span_bytes, tma_ld,
    tma_operands_cannon, tma_operands_ring_bwd)
from repro_torch.kernels.sm90 import addr as _addr
from repro_torch.kernels.sm90 import itemsize as _itemsize

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535
_TILE = 128
# a workspace (two slots) larger than this raises: the counterpart of the
# reference's VMEM guard (fused_ring.py:84-137), which falls back to the
# chunk walk instead
WORKSPACE_BUDGET_BYTES = 4 << 30
# slots grow in steps of this, so that a model's linears share one size
SLOT_GRANULE = 64 << 20


def _bind(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ring_fwd_bf16.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32,
                                  i32, vp]
    lib.ring_fwd_f32.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32,
                                 vp]
    lib.ring_bwd_bf16.argtypes = [vp, vp, vp, vp, vp, vp, vp] + [i32] * 11 \
        + [vp]
    lib.ring_bwd_f32.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                 i32, i32, i32, i32, vp]
    lib.ring_slots_alloc.argtypes = [i32, ctypes.c_size_t,
                                     ctypes.POINTER(vp), ctypes.c_char_p]
    lib.ring_slots_open.argtypes = [i32, ctypes.c_char_p, ctypes.POINTER(vp)]
    lib.ring_slots_close.argtypes = [vp]
    lib.ring_slots_free.argtypes = [vp]
    lib.ring_ipc_handle_bytes.argtypes = []
    lib.ring_attrs.argtypes = [i32, i32, ctypes.POINTER(i32)]
    for fn in ("ring_fwd_bf16", "ring_fwd_f32", "ring_bwd_bf16",
               "ring_bwd_f32", "ring_slots_alloc", "ring_slots_open",
               "ring_slots_close", "ring_slots_free",
               "ring_ipc_handle_bytes", "ring_attrs"):
        getattr(lib, fn).restype = i32
    lib.ring_error_string.argtypes = [i32]
    lib.ring_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("ring", "ring.cu", ["gemm_core.cuh",
                                             "gemm_sm90.cuh"], _bind)
build_info = LIBRARY.info        # build seconds, library path


def build() -> bool:
    """Compile (if these sources have no library yet) and load the kernel
    library.  Returns True when this call ran ``nvcc``."""
    return LIBRARY.load()


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({LIBRARY.error_string(rc)})")


@dataclasses.dataclass(frozen=True)
class DeviceBuffer:
    """A row-major buffer of ``shape`` and ``dtype`` at ``ptr`` on the card
    that torch does not own: a receive slot.  Its rows are ``ld`` elements
    apart (``shape[-1]`` when None: contiguous)."""
    ptr: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: torch.device
    ld: Optional[int] = None

    def is_contiguous(self) -> bool:
        return self.ld is None or self.ld == self.shape[-1]


Buffer = Union[torch.Tensor, DeviceBuffer]


def ring_bwd_tiles(rows: int, d: int, mc: int, need_dx: bool = True
                   ) -> Tuple[int, int]:
    """The bf16 backward step's dw tiles (dw_j [MC, D]) and dx tiles (dx
    [R, D])."""
    return sm90_tiles(mc, d), sm90_tiles(rows, d) if need_dx else 0


def kernel_attrs(kernel: int, vec_bytes: int = 16) -> Dict[str, int]:
    """Registers, local (spill) bytes, static and dynamic shared bytes and
    block size of a ring kernel (``ring_attrs``: 0 the bf16 backward, 1
    the f32 backward, 2 the bf16 forward at ``vec_bytes``, 3 the f32
    forward).  Loads the library."""
    return sm90.kernel_attrs(LIBRARY, "ring_attrs", kernel, vec_bytes)


def _vec_bytes(*operands: Buffer) -> int:
    """The widest global-load width (16, 8, 4 or 2 bytes) that every
    contiguous operand's base address and row stride allow (``vec_bytes``
    of ``kernels/block_matmul.py``, for slots too; a batch stride is a
    multiple of the row stride)."""
    def ok(b, vb):
        es = torch.finfo(b.dtype).bits // 8
        return _addr(b) % vb == 0 and b.shape[-1] * es % vb == 0
    for vb in (16, 8, 4):
        if all(ok(b, vb) for b in operands):
            return vb
    return 2


def _check_buffer(b: Buffer, name: str, shape, dtype, device,
                  who: str = "ring", padded: bool = False) -> None:
    """Shape, dtype and device, and the layout: contiguous, or with
    ``padded`` dense rows at any row stride (``row_stride``)."""
    if tuple(b.shape) != tuple(shape) or b.dtype != dtype \
            or b.device != device:
        raise ValueError(f"{who}: {name} must be {list(shape)} {dtype} on "
                         f"{device}; got {list(b.shape)} {b.dtype} on "
                         f"{b.device}")
    if padded and row_stride(b) is None:
        raise ValueError(f"{who}: {name} must have dense rows at one row "
                         f"stride")
    if not padded and not b.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _check_hop(src: Buffer, dest: Optional[Buffer], name: str,
               who: str) -> None:
    """A hop copies src's span as it lies: dest must have its row stride."""
    if dest is not None and row_stride(dest) != row_stride(src):
        raise ValueError(f"{who}: {name} has row stride {row_stride(dest)}, "
                         f"its source {row_stride(src)}")


def _check_operands(x, w, mc, padded: bool = False):
    if x.dim() != 2 or w.dim() != 2 or w.shape[1] != x.shape[1]:
        raise ValueError(f"ring: needs x [R, K] and w [M, K]; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"ring: x and w must share a dtype, float32 or "
                        f"bfloat16; got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if mc <= 0 or w.shape[0] % mc:
        raise ValueError(f"ring: a chunk of {mc} rows does not divide w's "
                         f"{w.shape[0]} rows")
    if x.device.type == "cuda":
        if padded:
            if row_stride(x) is None or row_stride(w) is None:
                raise ValueError("ring: x and w must have dense rows")
        elif not (x.is_contiguous() and w.is_contiguous()):
            raise ValueError("ring: x and w must be contiguous")
        if x.shape[1] == 0 or (x.shape[0] + _TILE - 1) // _TILE > _MAX_GRID_Y:
            raise ValueError(f"ring: unsupported shape R={x.shape[0]}, "
                             f"K={x.shape[1]}")
    elif x.device.type != "cpu":
        raise ValueError(f"ring runs on cuda or cpu, not {x.device}")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ring_fwd(x: torch.Tensor, w: torch.Tensor, j: int,
             prev: Optional[Buffer], dest: Buffer, *,
             accum_dtype: Optional[torch.dtype] = torch.float32) -> None:
    """One forward ring step: ``dest = wire(acc(prev) + acc(wire(x @
    w_j.T)))`` with w_j = w[j*MC:(j+1)*MC], MC = dest's columns, wire =
    x.dtype, acc = ``accum_dtype`` (x's dtype when None); ``prev`` [R, MC]
    in the wire dtype, or None at step 0."""
    rows, k = x.shape
    mc = dest.shape[1]
    _check_operands(x, w, mc)
    acc = accum_dtype or x.dtype
    if acc not in _DTYPES:
        raise TypeError(f"ring: accum_dtype must be float32 or bfloat16, "
                        f"not {acc}")
    if not 0 <= j < w.shape[0] // mc:
        raise ValueError(f"ring: chunk {j} of {w.shape[0] // mc}")
    for name, b in (("prev", prev), ("dest", dest)):
        if b is not None:
            _check_buffer(b, name, (rows, mc), x.dtype, x.device)
    if x.device.type == "cpu":
        dest.copy_(ring_fwd_step_ref(x, w[j * mc:(j + 1) * mc], prev, acc))
        return
    build()
    lib = LIBRARY.lib
    with torch.cuda.device(x.device):
        args = (x.data_ptr(), w.data_ptr(), _addr(prev), _addr(dest), rows,
                mc, k, j, int(acc == torch.bfloat16))
        if x.dtype == torch.bfloat16:
            rc = lib.ring_fwd_bf16(*args, _vec_bytes(x, w[j * mc:]),
                                   _stream(x.device))
        else:
            rc = lib.ring_fwd_f32(*args, _stream(x.device))
    _raise_on(rc, f"ring_fwd launch at R={rows} MC={mc} K={k} {x.dtype}")
    ring_fwd.launches += 1


def ring_bwd(x: torch.Tensor, w: torch.Tensor, j: int, cur: Buffer,
             fwd: Optional[Buffer], dw: torch.Tensor,
             dx_acc: Optional[torch.Tensor], dx: Optional[torch.Tensor], *,
             first: bool, last: bool) -> None:
    """One backward ring step for the cotangent chunk ``cur`` [R, MC] (x's
    dtype): ``dw[j*MC:(j+1)*MC] = cur.T @ x``; ``dx_acc = cur @ w_j``
    (``first``) or ``dx_acc + cur @ w_j`` in f32, and at the ``last`` step
    ``dx = dx_acc`` rounded to x's dtype; ``fwd = cur`` (the successor's
    slot, in cur's layout; None at the last step).  ``dx_acc`` and ``dx``
    None: no dx.  x, w, cur and fwd may have padded rows (``row_stride``):
    in bf16 on the card each must (``check_tma``), and the f32 kernel
    takes them contiguous; dw, dx_acc and dx are contiguous."""
    rows, k = x.shape
    mc = cur.shape[1]
    _check_operands(x, w, mc, padded=True)
    if not 0 <= j < w.shape[0] // mc:
        raise ValueError(f"ring: chunk {j} of {w.shape[0] // mc}")
    _check_buffer(cur, "cur", (rows, mc), x.dtype, x.device, padded=True)
    if fwd is not None:
        _check_buffer(fwd, "fwd", (rows, mc), x.dtype, x.device, padded=True)
        _check_hop(cur, fwd, "fwd", "ring")
    _check_buffer(dw, "dw", tuple(w.shape), x.dtype, x.device)
    if (dx_acc is None) != (dx is None):
        raise ValueError("ring: dx_acc and dx come together")
    if dx_acc is not None:
        _check_buffer(dx_acc, "dx_acc", (rows, k), torch.float32, x.device)
        _check_buffer(dx, "dx", (rows, k), x.dtype, x.device)
    if x.device.type == "cpu":
        w_j = w[j * mc:(j + 1) * mc]
        dw_j, acc = ring_bwd_step_ref(x, w_j, cur,
                                      None if first else dx_acc)
        dw[j * mc:(j + 1) * mc].copy_(dw_j)
        if dx_acc is not None:
            dx_acc.copy_(acc)
            if last:
                dx.copy_(acc)
        if fwd is not None:
            fwd.copy_(cur)
        return
    need_dx = dx_acc is not None
    if x.dtype == torch.bfloat16:
        ops = tma_operands_ring_bwd(rows, k, mc, need_dx)
        ld_x = check_tma(x, ops["x"], "ring_bwd")
        ld_c = check_tma(cur, ops["cur"], "ring_bwd")
        ld_w = row_stride(w)
        if need_dx:
            check_tma(w[j * mc:(j + 1) * mc], ops["w_j"], "ring_bwd")
        vec2 = int(k % 2 == 0 and all(_addr(b) % 8 == 0 for b in
                                      (dw, dx_acc, dx) if b is not None))
    elif any(row_stride(b) != b.shape[-1] for b in (x, w, cur)):
        raise ValueError("ring_bwd: the f32 kernel takes x, w and cur "
                         "contiguous")
    build()
    lib = LIBRARY.lib
    nbytes = span_bytes(cur)
    vec16 = int(fwd is not None and nbytes % 16 == 0
                and _addr(cur) % 16 == 0 and _addr(fwd) % 16 == 0)
    with torch.cuda.device(x.device):
        ptrs = (x.data_ptr(), w.data_ptr(), _addr(cur), _addr(fwd),
                _addr(dx_acc), _addr(dx), dw.data_ptr(), rows, k, mc, j)
        flags = (int(first), int(last))
        if x.dtype == torch.bfloat16:
            rc = lib.ring_bwd_bf16(*ptrs, ld_x, ld_w, ld_c, *flags, vec2,
                                   vec16, _stream(x.device))
        else:
            rc = lib.ring_bwd_f32(*ptrs, *flags, vec16, _stream(x.device))
    _raise_on(rc, f"ring_bwd launch at R={rows} MC={mc} K={k} {x.dtype}")
    ring_bwd.launches += 1


ring_fwd.launches = 0
ring_bwd.launches = 0


# ---------------------------------------------------------------------------
# p ranks held in one process
# ---------------------------------------------------------------------------

def _local_slots(xs, mc):
    return [[torch.empty((x.shape[0], mc), dtype=x.dtype, device=x.device)
             for _ in range(2)] for x in xs]


def empty_rows_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised buffer of t's shape, dtype, device and row stride
    (a receive slot of a rank held in this process)."""
    ld = row_stride(t)
    buf = torch.empty((*t.shape[:-1], ld), dtype=t.dtype, device=t.device)
    return buf[..., :t.shape[-1]]


def ring_fwd_all(xs, ws, *, accum_dtype: Optional[torch.dtype]
                 = torch.float32):
    """The forward ring of p ranks held in one process (rank r's block x
    ``xs[r]``, weight block ``ws[r]``) -> every rank's output chunk.  Rank
    r's step s writes rank r+1's slot s % 2 (a tensor here), or its output;
    all launches run in order on one stream, which is the barrier of the
    slot discipline."""
    p = len(xs)
    mc = ws[0].shape[0] // p
    slots = _local_slots(xs, mc)
    outs = [torch.empty((x.shape[0], mc), dtype=x.dtype, device=x.device)
            for x in xs]
    for s in range(p):
        for r in range(p):
            prev = None if s == 0 else slots[r][(s - 1) % 2]
            dest = outs[r] if s == p - 1 else slots[(r + 1) % p][s % 2]
            ring_fwd(xs[r], ws[r], (r - 1 - s) % p, prev, dest,
                     accum_dtype=accum_dtype)
    return outs


def ring_bwd_all(xs, ws, dys):
    """The backward ring of p ranks held in one process, for every rank's
    output cotangent ``dys[r]`` -> (dx, dw, dx_acc) per rank: dx in x's
    dtype, dw in x's dtype, and the f32 accumulator dx was rounded from."""
    p = len(xs)
    dws = [torch.empty_like(w) for w in ws]
    accs = [torch.empty(x.shape, dtype=torch.float32, device=x.device)
            for x in xs]
    dxs = [torch.empty_like(x) for x in xs]
    # each rank's operands in the layout the kernel reads (padded rows
    # where TMA needs them), once per ring call; the slots hold cur's
    xs, ws, dys = ([pad_rows(t) for t in ts] for ts in (xs, ws, dys))
    slots = [[empty_rows_like(dy) for _ in range(2)] for dy in dys]
    for s in range(p):
        for r in range(p):
            cur = dys[r] if s == 0 else slots[r][(s - 1) % 2]
            fwd = slots[(r + 1) % p][s % 2] if s < p - 1 else None
            ring_bwd(xs[r], ws[r], (r - s) % p, cur, fwd, dws[r], accs[r],
                     dxs[r], first=s == 0, last=s == p - 1)
    return dxs, dws, accs


# ---------------------------------------------------------------------------
# the receive slots of a process group
# ---------------------------------------------------------------------------

class RingWorkspace:
    """This rank's two receive slots (one raw ``cudaMalloc`` of 2 x
    ``slot_bytes``, exported for CUDA IPC) and those of the rank ``peer``
    positions on in ``group`` (+1: the ring's successor; -1: the Cannon's
    predecessor), mapped into this process by IPC.  Made collectively:
    every rank of ``group`` makes its own at once, and the handles are
    exchanged over the group."""

    def __init__(self, group, slot_bytes: int, device: torch.device,
                 peer: int = 1):
        build()
        lib = LIBRARY.lib
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.group, self.device = group, device
        self.slot_bytes = slot_bytes
        self.own_ptr = self.peer_ptr = None
        p, me = dist.get_world_size(group), dist.get_rank(group)
        handle = ctypes.create_string_buffer(lib.ring_ipc_handle_bytes())
        ptr = ctypes.c_void_p()
        _raise_on(lib.ring_slots_alloc(device.index, 2 * slot_bytes,
                                       ctypes.byref(ptr), handle),
                  f"ring slots: cudaMalloc of {2 * slot_bytes} bytes")
        self.own_ptr = ptr.value
        peers = [None] * p
        dist.all_gather_object(peers, (handle.raw, os.getpid(), device.index),
                               group=group)
        peer_handle, peer_pid, _ = peers[(me + peer) % p]
        if peer_pid == os.getpid():
            raise RuntimeError("ring slots: the peer rank lives in this "
                               "process; IPC maps only another process's "
                               "memory")
        pptr = ctypes.c_void_p()
        rc = lib.ring_slots_open(device.index, peer_handle,
                                 ctypes.byref(pptr))
        if rc != 0:
            lib.ring_slots_free(self.own_ptr)
            self.own_ptr = None
            _raise_on(rc, f"ring slots: cudaIpcOpenMemHandle of peer "
                          f"{peer:+d}'s")
        self.peer_ptr = pptr.value

    def _buffer(self, base: int, i: int, shape, dtype,
                ld: Optional[int]) -> DeviceBuffer:
        ld = shape[-1] if ld is None else ld
        nbytes = math.prod(shape[:-1]) * ld * _itemsize(dtype)
        if nbytes > self.slot_bytes:
            raise ValueError(f"ring slot of {self.slot_bytes} bytes holds "
                             f"no {list(shape)} {dtype} at row stride {ld}")
        return DeviceBuffer(base + i * self.slot_bytes, tuple(shape), dtype,
                            self.device, ld)

    def own(self, i: int, shape, dtype, ld: Optional[int] = None
            ) -> DeviceBuffer:
        """This rank's slot i (0 or 1), read at the step after it; rows
        ``ld`` elements apart (contiguous when None)."""
        return self._buffer(self.own_ptr, i, shape, dtype, ld)

    def peer(self, i: int, shape, dtype, ld: Optional[int] = None
             ) -> DeviceBuffer:
        """The peer's slot i, written by this rank."""
        return self._buffer(self.peer_ptr, i, shape, dtype, ld)

    def close(self, collective: bool = True) -> None:
        """Unmap the peer's slots, wait for the group (so that no rank
        still writes into this rank's), and free this rank's.  Collective;
        with ``collective=False`` (after an error, when the peers may be in
        another collective) only the unmap, and this rank's slots are left
        to the process's end, since a peer may still write into them."""
        lib = LIBRARY.lib
        if collective:
            torch.cuda.synchronize(self.device)
        if self.peer_ptr is not None:
            _raise_on(lib.ring_slots_close(self.peer_ptr),
                      "ring slots: cudaIpcCloseMemHandle")
            self.peer_ptr = None
        if not collective:
            return
        dist.barrier(group=self.group)
        if self.own_ptr is not None:
            _raise_on(lib.ring_slots_free(self.own_ptr),
                      "ring slots: cudaFree")
            self.own_ptr = None


def slot_bytes_for(nbytes: int) -> int:
    """The slot size that holds ``nbytes``: rounded up to SLOT_GRANULE."""
    return -(-nbytes // SLOT_GRANULE) * SLOT_GRANULE


# one workspace per process group and peer (its slots are reused by every
# call of the group: the calls run one after the other on every rank)
_WORKSPACES: Dict[Tuple[object, int], RingWorkspace] = {}


def check_budget(nbytes: int) -> int:
    """The slot size for a hop of ``nbytes``; raises when two such slots
    exceed ``WORKSPACE_BUDGET_BYTES``."""
    size = slot_bytes_for(nbytes)
    if 2 * size > WORKSPACE_BUDGET_BYTES:
        raise ValueError(f"ring: two slots of {size} bytes exceed the "
                         f"workspace budget of {WORKSPACE_BUDGET_BYTES} "
                         f"bytes (a hop of {nbytes} bytes)")
    return size


def workspace(group, nbytes: int, device: torch.device,
              peer: int = 1) -> RingWorkspace:
    """The workspace of ``group`` whose peer is ``peer`` positions on, with
    slots of at least ``nbytes``; made, or remade larger, collectively
    (every rank of the group asks for the same size at the same call).
    Raises above ``WORKSPACE_BUDGET_BYTES``."""
    key = (group, peer)
    ws = _WORKSPACES.get(key)
    if ws is not None and ws.slot_bytes >= nbytes:
        return ws
    size = check_budget(nbytes)
    if ws is not None:
        ws.close()
        del _WORKSPACES[key]
    ws = _WORKSPACES[key] = RingWorkspace(group, size, device, peer)
    return ws


def workspace_bytes() -> int:
    """Device memory of this rank's live slots: raw ``cudaMalloc``s that
    torch's allocator statistics do not see."""
    return sum(2 * ws.slot_bytes for ws in _WORKSPACES.values())


def release_workspaces(collective: bool = True) -> None:
    """Close every group's workspace (collective over each group, unless
    ``collective=False``: see ``RingWorkspace.close``)."""
    while _WORKSPACES:
        _, ws = _WORKSPACES.popitem()
        ws.close(collective)
