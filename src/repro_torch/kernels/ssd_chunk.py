"""The Mamba-2 intra-chunk SSD term: the wrappers of the hand-written Hopper
kernel ``csrc/ssd_chunk.cu``, its builder and its ctypes binding.

The counterpart of ``repro/kernels/ssd_chunk.py`` (the Pallas TPU kernel
``_kernel``, called through ``ssd_intra_chunk``).  Per chunk of a head,
with c, b [Q, N] (its group's C and B rows), x [Q, P] and dt, dac [Q]:

  att[i, j] = where(i >= j, (c_i . b_j) * exp(dac_i - dac_j), 0) * dt_j
  y         = att.astype(x.dtype) @ x                      [Q, P]

Two entries launch the one kernel:

* ``ssd_intra_chunk(c, b, x, dt, dac)``: the reference's [G, Q, N]
  contract (``ops.ssd_intra``), G groups laid out one after another;
* ``ssd_intra_heads(x, dt, dac, B, C, chunk)``: ``_ssd_chunked``'s tensors
  as they lie, x [b, s, h, p], dt and dac [b, s, h], B and C [b, s, g, n]
  (head k reads group k // (h // g)), each at its own strides; y comes back
  [b, s, h, p].  Nothing is repeated over the heads or copied into groups.

On a CUDA tensor an entry launches the kernel, or raises; on a CPU tensor
it computes the plain PyTorch version (``ref.ssd_intra_ref``, and for the
heads entry ``ref.ssd_intra_heads_ref``: the groups arrangement the model
made before this entry existed).  Nothing falls back from one to the other.

Both entries count into ``ssd_intra_chunk.launches``, and by entry and
route into ``ssd_intra_chunk.route_launches`` (``"groups.tma"``,
``"heads.scalar"``, ...); nothing else adds to them, but for the replays
of a captured CUDA graph (``kernels/graphs.py::CountedGraph``).  The route is
``"tma"`` (x, B and C through TMA tensor maps) where they have 16-byte
aligned bases, strides and rows, else ``"scalar"`` (element loads), inside
the same kernel.  The library is built like block_matmul's
(``kernels/build.py``), from its own source.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels.build import KernelLibrary
from repro_torch.kernels.ref import ssd_intra_heads_ref, ssd_intra_ref

Q_MAX, N_MAX, P_MAX = 64, 128, 128     # what one thread block holds
_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's shared memory (csrc/ssd_chunk.cu): the mbarriers and the
# slack that aligns the C/B stages to 1024 bytes, s transposed [64][68] f32,
# two att buffers [64][64] f32 (four where heads go two at a time), then the
# C/B stages (C and B rows in boxes of [64 rows][128 bytes]) and the x
# stages; a block may have 232,448 bytes on an H100
SMEM_LIMIT = 232448
_FIXED_BYTES = 128 + 1024 + Q_MAX * (Q_MAX + 4) * 4
_ATT_BYTES = Q_MAX * Q_MAX * 4
_BOX_BYTES = Q_MAX * 128
MAX_CB_STAGES, MAX_X_STAGES = 2, 4


_NDIMS = 29      # the launch's int64 parameters (csrc/ssd_chunk.cu NDIMS)


def _bind(lib: ctypes.CDLL) -> None:
    if lib.ssd_chunk_ndims() != _NDIMS:
        raise RuntimeError(f"ssd_chunk: the library takes "
                           f"{lib.ssd_chunk_ndims()} launch parameters, the "
                           f"wrapper passes {_NDIMS}")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_chunk_launch.argtypes = [i32, vp, vp, vp, vp, vp, vp,
                                     ctypes.POINTER(ctypes.c_longlong), vp]
    lib.ssd_chunk_launch.restype = i32
    lib.ssd_chunk_attrs.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    lib.ssd_chunk_attrs.restype = i32
    lib.ssd_chunk_error_string.argtypes = [i32]
    lib.ssd_chunk_error_string.restype = ctypes.c_char_p


LIBRARY = KernelLibrary("ssd_chunk", "ssd_chunk.cu", [], _bind)
build_info = LIBRARY.info        # build seconds, library path


def build() -> bool:
    """Compile (if this source has no library yet) and load the kernel
    library.  Returns True when this call ran ``nvcc``."""
    return LIBRARY.load()


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's shared-memory plan for one (N, P, dtype, heads per
    item): C/B and x stages, the 128-byte boxes of a C/B row, the bytes of
    an x row, whether heads go two at a time, and the dynamic shared
    bytes."""
    cb_stages: int
    x_stages: int
    boxes: int
    x_pitch: int
    pairs: bool
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def plan(n: int, p: int, dtype: torch.dtype, heads_per_item: int) -> Plan:
    """Items of one head (the [G, Q, N] entry) take two C/B stages, so that
    the next group's c and b land while this one computes; items of more
    heads go two heads at a time (four att buffers), and from four heads on
    (the model's items: C and B are read once per 24 heads) take one C/B
    stage; then as many x stages, up to four, as the rest of the 232,448
    bytes holds (at least two)."""
    es = 4 if dtype == torch.float32 else 2
    boxes, x_pitch = -(-n * es // 128), -(-p * es // 16) * 16
    pairs = heads_per_item >= 2
    fixed = _FIXED_BYTES + (4 if pairs else 2) * _ATT_BYTES
    cb_bytes = 2 * boxes * _BOX_BYTES
    x_bytes = Q_MAX * x_pitch + 2 * Q_MAX * 4
    first = 1 if heads_per_item >= 4 else MAX_CB_STAGES
    for cb in range(first, 0, -1):
        xs = min(MAX_X_STAGES, (SMEM_LIMIT - fixed - cb * cb_bytes) // x_bytes)
        if xs >= 2:
            return Plan(cb, xs, boxes, x_pitch, pairs,
                        fixed + cb * cb_bytes + xs * x_bytes)
    raise ValueError(f"ssd_chunk: N={n}, P={p} do not fit a block")


def head_shares(items: int, rep: int, sms: int) -> int:
    """Shares each group's ``rep`` heads are split into, so that the work
    items (``items`` (batch, chunk, group) triples times the shares) fill
    the ``sms`` SMs' persistent blocks; 1 (s once per triple) whenever the
    triples alone fill them."""
    return max(1, min(rep, sms // max(items, 1)))


def _aligned(t: torch.Tensor) -> bool:
    es = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[-1] * es % 16 == 0
            and all(t.stride(d) * es % 16 == 0 for d in range(t.dim() - 1)
                    if t.shape[d] > 1))


def route(*tensors: torch.Tensor) -> str:
    """``"tma"`` when every operand the kernel reads through a tensor map
    (x, B, C) has a 16-byte aligned base, row width and strides (of the
    dimensions longer than 1), else ``"scalar"``."""
    return "tma" if all(_aligned(t) for t in tensors) else "scalar"


def kernel_attrs(dtype: torch.dtype, n: int, p: int, heads_per_item: int):
    """Registers, local (spill) bytes, static and dynamic shared bytes,
    block size and stages of the kernel at one width.  Loads the
    library."""
    build()
    out = (ctypes.c_int * 5)()
    rc = LIBRARY.lib.ssd_chunk_attrs(int(dtype == torch.bfloat16), out)
    if rc != 0:
        raise RuntimeError(f"ssd_chunk_attrs: CUDA error {rc} "
                           f"({LIBRARY.error_string(rc)})")
    pl = plan(n, p, dtype, heads_per_item)
    return {"registers": out[0], "local_bytes": out[1],
            "static_shared_bytes": out[2],
            "dynamic_shared_bytes": pl.smem_bytes, "threads": out[4],
            "cb_stages": pl.cb_stages, "x_stages": pl.x_stages}


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
    _check_types("ssd_intra_chunk", x, b, c, dt, dac)
    p = x.shape[2]
    _check_widths("ssd_intra_chunk", q, n, p)
    return g, q, n, p


def _check_types(name, x, b, c, dt, dac):
    if x.dtype not in _DTYPES or c.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"{name} needs c, b and x of one dtype, float32 or "
                        f"bfloat16; got {c.dtype}, {b.dtype}, {x.dtype}")
    if dt.dtype != torch.float32 or dac.dtype != torch.float32:
        raise TypeError(f"{name} needs float32 dt and dac; got {dt.dtype} "
                        f"and {dac.dtype}")
    if any(t.device != x.device for t in (c, b, dt, dac)):
        raise ValueError(f"{name}: operands on different devices")


def _check_widths(name, q, n, p):
    if not (1 <= q <= Q_MAX and 1 <= n <= N_MAX and 1 <= p <= P_MAX):
        raise ValueError(f"{name}: unsupported shape Q={q}, N={n}, P={p} "
                         f"(the kernel takes Q <= {Q_MAX}, N <= {N_MAX}, "
                         f"P <= {P_MAX})")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(entry, x, dt, dac, bm, cm, y, dims, strides, rep, n, p):
    """One launch of the kernel: x, bm and cm viewed [batch, seq, heads or
    groups, width] with ``strides`` (x, dt, dac, B, C: three each)."""
    rt = route(x, bm, cm)
    batch, seqlen, heads, groups, q = dims
    shares = head_shares(batch * (seqlen // q) * groups, rep,
                         _sm_count(x.device.index))
    pl = plan(n, p, x.dtype, -(-rep // shares))
    vals = [batch, seqlen, heads, groups, q, n, p, *strides,
            int(rt == "tma"), shares, pl.cb_stages, pl.x_stages, pl.boxes,
            pl.x_pitch, int(pl.pairs)]
    build()
    arr = (ctypes.c_longlong * len(vals))(*vals)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = LIBRARY.lib.ssd_chunk_launch(
        int(x.dtype == torch.bfloat16), x.data_ptr(), dt.data_ptr(),
        dac.data_ptr(), bm.data_ptr(), cm.data_ptr(), y.data_ptr(), arr,
        stream)
    if rc != 0:
        raise RuntimeError(f"{entry}: launch failed with CUDA error {rc} "
                           f"({LIBRARY.error_string(rc)}) at {vals} "
                           f"{x.dtype}")
    ssd_intra_chunk.launches += 1
    ssd_intra_chunk.route_launches[f"{entry}.{rt}"] += 1


def _strides(t: torch.Tensor):
    """The batch, seq and head (or group) strides of ``t`` in elements, a
    dimension of length 1 given its row's width rounded up to 16 bytes (its
    index is always 0; the kernel's tensor maps take strides in multiples
    of 16 bytes only)."""
    per16 = 16 // t.element_size()
    row = -(-t.shape[-1] // per16) * per16 if t.dim() == 4 else per16
    return tuple(t.stride(d) if t.shape[d] > 1 else row for d in range(3))


def _cuda(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


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
    _cuda("ssd_intra_chunk", x)
    if not all(t.is_contiguous() for t in (c, b, x, dt, dac)):
        raise ValueError("ssd_intra_chunk needs contiguous c, b, x, dt and "
                         "dac")
    y = torch.empty((g, q, p), dtype=x.dtype, device=x.device)
    if g == 0:
        return y
    # the case batch = G, seq = Q, heads = groups = 1 of the heads layout
    _launch("groups", x, dt, dac, b, c, y, (g, q, 1, 1, q),
            (q * p, p, p, q, 1, 1, q, 1, 1, q * n, n, n, q * n, n, n),
            1, n, p)
    return y


ssd_intra_chunk.launches = 0
ssd_intra_chunk.route_launches = collections.Counter()


def _check_heads(x, dt, dac, bm, cm, chunk):
    name = "ssd_intra_heads"
    if x.dim() != 4 or bm.dim() != 4 or cm.shape != bm.shape:
        raise ValueError(f"{name} needs x [b, s, h, p] and B, C [b, s, g, "
                         f"n]; got {tuple(x.shape)}, {tuple(bm.shape)} and "
                         f"{tuple(cm.shape)}")
    bsz, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    if (bm.shape[:2] != (bsz, s) or dt.shape != (bsz, s, h)
            or dac.shape != (bsz, s, h)):
        raise ValueError(f"{name}: B, C must be [{bsz}, {s}, g, n] and dt, "
                         f"dac [{bsz}, {s}, {h}]; got {tuple(bm.shape)}, "
                         f"{tuple(dt.shape)} and {tuple(dac.shape)}")
    if g < 1 or h % g != 0:
        raise ValueError(f"{name}: {h} heads do not split into {g} groups")
    _check_types(name, x, bm, cm, dt, dac)
    if any(t.stride(-1) != 1 for t in (x, bm, cm)):
        raise ValueError(f"{name} needs a unit inner stride of x, B and C; "
                         f"got {x.stride()}, {bm.stride()}, {cm.stride()}")
    _check_widths(name, chunk, n, p)
    if s % chunk != 0:
        raise ValueError(f"{name}: sequence {s} is not whole chunks of "
                         f"{chunk} (the caller pads)")
    return bsz, s, h, p, g, n


def ssd_intra_heads(x: torch.Tensor, dt: torch.Tensor, dac: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """The intra-chunk SSD term of every head and chunk, read where the
    model has it: x [b, s, h, p]; dt, dac [b, s, h] (float32; dac the
    within-chunk cumsum of dt * A); B, C [b, s, g, n] with g head groups
    (head k reads group k // (h // g)), all at their own strides, x, B and
    C with a unit inner stride; s a whole number of chunks.  Returns
    y_intra [b, s, h, p] in x's dtype, contiguous."""
    bsz, s, h, p, g, n = _check_heads(x, dt, dac, B, C, chunk)
    if x.device.type == "cpu":
        return ssd_intra_heads_ref(x, dt, dac, B, C, chunk)
    _cuda("ssd_intra_heads", x)
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    _launch("heads", x, dt, dac, B, C, y, (bsz, s, h, g, chunk),
            (*_strides(x), *_strides(dt), *_strides(dac), *_strides(B),
             *_strides(C)), h // g, n, p)
    return y
