"""Operand planning for the Hopper main loop (``csrc/gemm_sm90.cuh``): what
the wrappers of every kernel on that loop (``block_matmul``, ``wx``, the
ring's bf16 backward, the Cannon step) need before a launch.

The loop reads each bf16 operand through a TMA tensor map, which takes only
row strides and base addresses in multiples of 16 bytes.  So every such
operand carries its own row stride ``ld`` (``row_stride``): a tensor whose
rows are padded is a view ``buf[..., :cols]`` of a wider buffer, a receive
slot a ``ring.DeviceBuffer`` with ``ld``.  ``tma_operands_*`` plan each
operand's ``ld`` and boxes from the shapes; the callers pad an operand
whose rows need it once per call (``pad_rows``); the wrappers check each
operand (``check_tma``) and raise on what the kernel does not take.

``persistent_grid`` and ``sm90_tiles`` mirror the loop's grid and tiles
for the smoke run's rows, and ``kernel_attrs`` reads a compiled kernel's
registers, spills and shared memory through its library's C interface.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

# TMA: a tensor map's base address and row strides in multiples of 16
# bytes, dimensions below 2^32, strides below 2^40 bytes, a box side of at
# most 256 elements and, under the 128-byte swizzle, a box row of at most
# 128 bytes
TMA_ALIGN = 16
TMA_MAX_BOX = 256
TMA_SWIZZLE_BYTES = 128
BOX_MN = (64, 64)     # (inner, outer): [64 k][64 m or n], M- or N-major
BOX_K = (64, 128)     # [128 rows][64 k], K-major
# the Hopper loop's output tile (rows, columns) and the SMs of an H100 SXM
# (the persistent grid's size when the runtime is not asked)
SM90_TILE = (128, 256)
H100_SMS = 132
ATTR_KEYS = ("registers", "local_bytes", "static_shared_bytes",
             "dynamic_shared_bytes", "threads")


def itemsize(dtype: torch.dtype) -> int:
    return torch.finfo(dtype).bits // 8


def addr(b) -> Optional[int]:
    """The device address of a tensor or a receive slot (None for None)."""
    if b is None:
        return None
    return b.data_ptr() if isinstance(b, torch.Tensor) else b.ptr


def row_stride(b) -> Optional[int]:
    """The elements between b's rows when its rows are dense and its outer
    dimensions packed around them (``[..., rows, cols]`` at strides
    ``(..., rows * ld, ld, 1)``), else None.  b is a tensor or a receive
    slot (``ring.DeviceBuffer``: its ``ld``, or its width when None)."""
    if not isinstance(b, torch.Tensor):
        return b.shape[-1] if b.ld is None else b.ld
    if b.dim() < 2:
        return b.shape[-1] if b.is_contiguous() else None
    if b.shape[-1] > 1 and b.stride(-1) != 1:
        return None
    ld = b.stride(-2)
    if ld < b.shape[-1]:
        if b.shape[-2] > 1:
            return None
        ld = b.shape[-1]
    want = ld
    for i in range(b.dim() - 2, -1, -1):
        if b.shape[i] > 1 and b.stride(i) != want:
            return None
        want *= b.shape[i]
    return ld


def span_bytes(b) -> int:
    """The bytes b spans from its first element to the end of its last
    row, padding included (what a hop copies)."""
    return math.prod(b.shape[:-1]) * row_stride(b) * itemsize(b.dtype)


def tma_ld(cols: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The least row stride (elements) at or above ``cols`` that TMA
    takes: a multiple of 16 bytes."""
    per = TMA_ALIGN // itemsize(dtype)
    return -(-cols // per) * per


@dataclasses.dataclass(frozen=True)
class TmaOperand:
    """How the Hopper loop reads one bf16 operand: its logical shape, the
    row stride ``ld`` its buffer gets (``tma_ld``), and the TMA boxes
    (inner, outer) it is read in."""
    name: str
    shape: Tuple[int, ...]
    ld: int
    boxes: Tuple[Tuple[int, int], ...]

    @property
    def padded(self) -> bool:
        return self.ld > self.shape[-1]

    def describe(self) -> str:
        pad = (f" (rows padded from {self.shape[-1]})" if self.padded
               else "")
        boxes = ", ".join(f"{o}x{i}" for i, o in self.boxes)
        return f"TMA, ld {self.ld}{pad}, boxes {boxes}"


def plan_operand(name: str, shape, boxes) -> TmaOperand:
    """``TmaOperand`` for a bf16 operand of ``shape`` read in ``boxes``;
    raises ValueError on what a tensor map cannot describe."""
    shape = tuple(int(v) for v in shape)
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"{name}: a TMA operand is [rows, cols] or [batch, "
                         f"rows, cols] with every side >= 1; got "
                         f"{list(shape)}")
    ld = tma_ld(shape[-1])
    if max(shape) >= 1 << 32 or math.prod(shape[:-1]) * ld * 2 >= 1 << 40:
        raise ValueError(f"{name}: {list(shape)} exceeds a tensor map's "
                         f"dimensions or strides")
    for inner, outer in boxes:
        if max(inner, outer) > TMA_MAX_BOX or inner * 2 > TMA_SWIZZLE_BYTES:
            raise ValueError(f"{name}: box {outer}x{inner} exceeds TMA's "
                             f"(sides <= {TMA_MAX_BOX}, rows <= "
                             f"{TMA_SWIZZLE_BYTES} bytes)")
    return TmaOperand(name, shape, ld, tuple(boxes))


def tma_operands_ring_bwd(rows: int, d: int, mc: int, need_dx: bool = True
                          ) -> Dict[str, TmaOperand]:
    """The ring's bf16 backward step: x [R, D] and w_j [MC, D] read
    N-major, cur [R, MC] read M-major (dw) and K-major (dx)."""
    ops = {"x": plan_operand("x", (rows, d), (BOX_MN,)),
           "cur": plan_operand("cur", (rows, mc),
                               (BOX_MN, BOX_K) if need_dx else (BOX_MN,))}
    if need_dx:
        ops["w_j"] = plan_operand("w_j", (mc, d), (BOX_MN,))
    return ops


def tma_operands_cannon(ll: int, m: int, n: int, k: int
                        ) -> Dict[str, TmaOperand]:
    """The bf16 Cannon step: w [M, K] read K-major, x [L, K, N] read
    N-major."""
    return {"w": plan_operand("w", (m, k), (BOX_K,)),
            "x": plan_operand("x", (ll, k, n), (BOX_MN,))}


def tma_operands_block_matmul(m: int, n: int, k: int, x_t: bool = False,
                              w_t: bool = False) -> Dict[str, TmaOperand]:
    """bf16 ``A @ B.T`` on the Hopper loop: x stored [M, K] read K-major in
    a [128][64] box, or [K, M] (``x_t``) M-major in two [64][64] boxes; w
    stored [N, K] read K-major in two [128][64] boxes (the B tile's 256
    rows), or [K, N] (``w_t``) N-major in four [64][64] boxes."""
    return {"x": plan_operand("x", (k, m) if x_t else (m, k),
                              (BOX_MN,) if x_t else (BOX_K,)),
            "w": plan_operand("w", (k, n) if w_t else (n, k),
                              (BOX_MN,) if w_t else (BOX_K,))}


def tma_operands_wx(ll: int, m: int, n: int, k: int, w_t: bool = False
                    ) -> Dict[str, TmaOperand]:
    """bf16 ``a[l] + W @ x[l]`` on the Hopper loop: W = w [M, K] read
    K-major, or w stored [K, M] (``w_t``) read M-major; x [L, K, N] read
    N-major (the dx route's split cotangent: three such, one buffer of
    [3 L, K, N] at this ld)."""
    return {"w": plan_operand("w", (k, m) if w_t else (m, k),
                              (BOX_MN,) if w_t else (BOX_K,)),
            "x": plan_operand("x", (ll, k, n), (BOX_MN,))}


def check_tma(b, op: TmaOperand, who: str) -> int:
    """Raise ValueError unless b can be read as ``op`` through a tensor
    map: bf16, op's shape, dense rows at a row stride (returned) that is
    a multiple of 16 bytes, its base 16-byte aligned."""
    ld = row_stride(b)
    problems = []
    if b.dtype != torch.bfloat16:
        problems.append(f"dtype {b.dtype}, not bfloat16")
    if tuple(b.shape) != op.shape:
        problems.append(f"shape {list(b.shape)}, not {list(op.shape)}")
    if ld is None:
        problems.append("rows not dense at one row stride")
    elif ld * 2 % TMA_ALIGN:
        problems.append(f"row stride {ld} elements is not a multiple of "
                        f"{TMA_ALIGN} bytes (pad the rows to "
                        f"{tma_ld(b.shape[-1])}: pad_rows)")
    if addr(b) % TMA_ALIGN:
        problems.append(f"base address not {TMA_ALIGN}-byte aligned")
    if problems:
        raise ValueError(f"{who}: {op.name} cannot be read through TMA: "
                         + "; ".join(problems))
    return ld


def pad_rows(t: torch.Tensor) -> torch.Tensor:
    """t itself when its rows already suit TMA (bf16 rows at a row stride
    of a multiple of 16 bytes, the base aligned), else a copy into a
    buffer whose rows are padded to ``tma_ld`` (the view ``buf[...,
    :cols]``).  Other dtypes come back as they are."""
    if t.dtype != torch.bfloat16:
        return t
    ld = row_stride(t)
    if ld is not None and ld * 2 % TMA_ALIGN == 0 \
            and t.data_ptr() % TMA_ALIGN == 0:
        return t
    cols = t.shape[-1]
    buf = torch.empty((*t.shape[:-1], tma_ld(cols)), dtype=t.dtype,
                      device=t.device)
    view = buf[..., :cols]
    view.copy_(t)
    return view


def persistent_grid(tiles: int, hop: bool, sms: int = H100_SMS) -> int:
    """The blocks of a Hopper-loop launch (``gemm_sm90.cuh::grid_size``):
    one per SM, at most one per tile, every SM when there is a hop."""
    if hop or tiles > sms:
        return sms
    return max(tiles, 1)


def sm90_tiles(rows: int, cols: int) -> int:
    """The Hopper loop's output tiles over a [rows, cols] result."""
    return -(-rows // SM90_TILE[0]) * -(-cols // SM90_TILE[1])


def kernel_attrs(library, fn: str, *args: int) -> Dict[str, int]:
    """Registers, local (spill) bytes, static and dynamic shared bytes and
    block size of a compiled kernel, through ``library``'s C function
    ``fn(*args, int out[5])``.  Loads (and if need be builds) the
    library."""
    library.load()
    out = (ctypes.c_int * len(ATTR_KEYS))()
    rc = getattr(library.lib, fn)(*args, out)
    if rc != 0:
        raise RuntimeError(f"{fn}{args}: CUDA error {rc} "
                           f"({library.error_string(rc)})")
    return dict(zip(ATTR_KEYS, out))
