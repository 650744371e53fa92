"""The input pipeline: synthetic weather batches, or the language models'
token rows, made on the host, copied to the device, and prefetched by a
background thread (the port of ``repro/data/pipeline.py``; one process is
one rank).

A language model's batches come from ``TokenBatchSource``: a data rank
makes only its rows of ``tokens`` and ``labels`` (``TokenDataset.
sample_shard``, bit for bit the rows of the whole batch); the VLM's
``embeds`` and the audio family's ``frames`` are a full f32 draw per step,
cut to the rank's rows and, on a 1-D model mesh, to its block of D.  ``make_source`` / ``make_pipeline`` pick the
source by family.  The rest of this docstring is the weather source's.

On one device (``mesh=None``) both modes read the whole batch. On a mesh
``"sync-full"`` makes the whole batch on every rank (the model cuts its
block), and ``"sharded"`` reads only this rank's block (paper §5: every
model-parallel rank loads its slice): the ``_ReadPlan`` of each key lists
its data rank's rows of the batch and the boxes of the grid whose pixels
make up the block that ``models/weathermixer.py::field_block`` cuts from
the patchified fields (``launch/specs.py::block_specs``), and the pipeline
hands the model that block, [b, T/q, p*p*C/q] under 2-D, [b, T, p*p*C/p]
under 1-D (b = B / data, or B where the data extent does not divide it),
bit-equal to cutting the whole batch.  A token band need not be whole
patch rows, so a block is up to three boxes of patches by up to five of
in-patch pixels.  ``PipelineStats`` counts the bytes each rank reads.

Batches are a pure function of (seed, step, horizon); the prefetch thread
changes timing only, never values.

On a CUDA device the prefetch thread copies each batch on a side stream
from pinned host memory and waits for the copy, so the training stream
never waits on a host-to-device transfer it did not ask for.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import queue
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.core.sharding import Spec, block_range, sanitize_batch
from repro_torch.data.tokens import TokenDataConfig, TokenDataset
from repro_torch.data.weather import (Cancelled, WeatherDataConfig,
                                      WeatherDataset)
from repro_torch.launch.specs import block_specs

MODES = ("sharded", "sync-full")


# ---------------------------------------------------------------------------
# Stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PipelineStats:
    """Host-side read accounting, updated by the pipeline once per batch:
    ``rank_bytes[key][rank]``, the bytes each rank read (``rank`` the
    global rank, ``Mesh.rank``; -1 for a whole-batch read): what
    ``io_bytes_per_rank`` models. One process is one rank, so every byte
    read was made here (the reference's ``generated_bytes`` deduplicates
    the reads of the devices one host feeds, and has no counterpart).

    ``record_batch`` applies one batch's reads under the tracer's lock and
    adds the totals to its counters in the same critical section, so the
    prefetch worker and a reader never see half a batch."""
    steps: int = 0
    plan_builds: int = 0
    rank_bytes: Dict[str, Dict[int, int]] = dataclasses.field(
        default_factory=dict)

    def record_batch(self, reads: Sequence[Tuple[str, int, int]],
                     steps: int = 0, plan_builds: int = 0) -> None:
        """Apply read records ``(key, rank, nbytes)``."""
        total = 0
        tr = telemetry.get_tracer()
        with tr.lock:
            self.steps += steps
            self.plan_builds += plan_builds
            for key, rank, nbytes in reads:
                per = self.rank_bytes.setdefault(key, {})
                per[rank] = per.get(rank, 0) + nbytes
                total += nbytes
            updates = {"pipeline.batches": steps,
                       "pipeline.plan_builds": plan_builds,
                       "pipeline.read_bytes": total}
            tr.add_counters_locked({k: v for k, v in updates.items() if v})


# ---------------------------------------------------------------------------
# The read plan of a rank's block
# ---------------------------------------------------------------------------

def _boxes(lo: int, hi: int, shape: Sequence[int]
           ) -> List[Tuple[Tuple[int, int], ...]]:
    """The flat range [lo, hi) of a row-major array of ``shape`` as boxes,
    each a (start, stop) per dim, in order; each box is a contiguous run of
    the flat range."""
    if lo >= hi:
        return []
    if len(shape) == 1:
        return [((lo, hi),)]
    inner = math.prod(shape[1:])
    (a0, r0), (a1, r1) = divmod(lo, inner), divmod(hi, inner)
    rest = tuple((0, n) for n in shape[1:])
    if a0 == a1:
        return [((a0, a0 + 1),) + b for b in _boxes(r0, r1, shape[1:])]
    out = []
    if r0:
        out += [((a0, a0 + 1),) + b for b in _boxes(r0, inner, shape[1:])]
        a0 += 1
    if a1 > a0:
        out.append(((a0, a1),) + rest)
    if r1:
        out += [((a1, a1 + 1),) + b for b in _boxes(0, r1, shape[1:])]
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class _Read:
    """One box of the grid: its lat, lon and channel indices, and where its
    pixels land in the block: ``tokens`` and ``cols`` (slices of the
    block's token and patch dims) and ``dims`` = (patch rows, in-patch
    rows, patch cols, in-patch cols, channels)."""
    lat: np.ndarray
    lon: np.ndarray
    chan: np.ndarray
    tokens: slice
    cols: slice
    dims: Tuple[int, int, int, int, int]


@dataclasses.dataclass(frozen=True, eq=False)
class _ReadPlan:
    """This rank's reads for a batch spec: the block's shape
    [b, tokens, patch dim], its rows of the batch and the boxes that fill
    it.  Built once per pipeline and spec (specs and shapes are
    step-invariant), so the keys of one spec share it."""
    shape: Tuple[int, int, int]
    rows: slice
    reads: Tuple[_Read, ...]


def read_plan(spec: Spec, mesh, batch: int, lat: int, lon: int,
              channels: int, patch: int) -> _ReadPlan:
    """The rows of the batch and the boxes of the [B, lat, lon, C] grid
    whose pixels make up this rank's block under ``spec`` of the
    patchified fields [B, T, p*p*C] (``weathermixer.patchify``: tokens
    patch-row-major, the patch dim [in-patch row, in-patch col, channel]):
    the rows [d*b, (d+1)*b) of data rank d (b = B / data; every row where
    the data extent does not divide B, ``sanitize_batch``)."""
    p = patch
    grid = (lat // p, lon // p)
    r0, r1 = block_range(mesh, sanitize_batch(spec, mesh, batch)[0], batch)
    t0, t1 = block_range(mesh, spec[1], grid[0] * grid[1])
    k0, k1 = block_range(mesh, spec[2], p * p * channels)
    reads = []
    for (a0, a1), (b0, b1) in _boxes(t0, t1, grid):
        for (i0, i1), (j0, j1), (c0, c1) in _boxes(k0, k1,
                                                   (p, p, channels)):
            tok = a0 * grid[1] + b0 - t0
            col = (i0 * p + j0) * channels + c0 - k0
            dims = (a1 - a0, i1 - i0, b1 - b0, j1 - j0, c1 - c0)
            reads.append(_Read(
                lat=(np.arange(a0, a1)[:, None] * p
                     + np.arange(i0, i1)).reshape(-1),
                lon=(np.arange(b0, b1)[:, None] * p
                     + np.arange(j0, j1)).reshape(-1),
                chan=np.arange(c0, c1),
                tokens=slice(tok, tok + dims[0] * dims[2]),
                cols=slice(col, col + dims[1] * dims[3] * dims[4]),
                dims=dims))
    return _ReadPlan((r1 - r0, t1 - t0, k1 - k0), slice(r0, r1),
                     tuple(reads))


# ---------------------------------------------------------------------------
# Batch source
# ---------------------------------------------------------------------------

class WeatherBatchSource:
    """ERA5-like fields and their target ``horizon`` steps ahead: the whole
    batch, or a rank's block of the patchified fields (``patch``: the
    model's patch size)."""

    keys = ("fields", "target")

    def __init__(self, ds: WeatherDataset, batch_size: int, patch: int):
        self.ds = ds
        self.batch_size = batch_size
        self.patch = patch
        self._memo_key: Any = None
        self._memo: Dict[str, np.ndarray] = {}

    def full_batch(self, step: int, horizon: int,
                   cancel: Optional[threading.Event] = None
                   ) -> Dict[str, np.ndarray]:
        return self.ds.sample_batch(step, self.batch_size, horizon=horizon,
                                    cancel=cancel)

    def plan(self, spec: Spec, mesh) -> _ReadPlan:
        c = self.ds.cfg
        return read_plan(spec, mesh, self.batch_size, c.lat, c.lon,
                         c.channels, self.patch)

    def read_key(self, key: str, step: int, horizon: int,
                 plan: _ReadPlan,
                 cancel: Optional[threading.Event] = None) -> np.ndarray:
        """``key``'s block under ``plan``; fields and target share one
        plan, so one read of its boxes serves both (memoised per step; a
        cancelled read memoises nothing)."""
        if self._memo_key != (step, horizon, plan):
            memo = {k: np.empty(plan.shape, np.float32) for k in self.keys}
            got = self.ds.sample_index(
                step, self.batch_size,
                [(r.lat, r.lon, r.chan) for r in plan.reads], horizon,
                rows=plan.rows, cancel=cancel)
            for r, box in zip(plan.reads, got):
                na, ni, nb, nj, nc = r.dims
                for k, v in box.items():
                    memo[k][:, r.tokens, r.cols] = (
                        v.reshape(-1, na, ni, nb, nj, nc)
                        .transpose(0, 1, 3, 2, 4, 5)
                        .reshape(-1, na * nb, ni * nj * nc))
            self._memo_key, self._memo = (step, horizon, plan), memo
        return self._memo[key]

    def sync_block(self, value: np.ndarray, spec: Spec, mesh) -> np.ndarray:
        """A key of the whole batch as ``"sync-full"`` hands it over: whole
        (the model cuts its block, ``weathermixer.field_block``)."""
        return value


def _rows(spec: Spec, mesh, batch: int) -> slice:
    """The rows of a batch of ``batch`` that ``spec``'s batch entry gives
    this rank (every row where the data extent does not divide it)."""
    return slice(*block_range(mesh, sanitize_batch(spec, mesh, batch)[0],
                              batch))


@dataclasses.dataclass(frozen=True, eq=False)
class _RowPlan:
    """A data rank's rows of a token batch, and the spec and mesh that cut
    the trailing dims of the dense side inputs (D on the feature axis)."""
    rows: slice
    spec: Spec = ()
    mesh: Any = None

    def cut(self, value: np.ndarray) -> np.ndarray:
        """The rank's block of a side input [B, n, D]: its rows, and its
        block of each trailing dim the spec cuts."""
        tail = tuple(slice(*block_range(self.mesh, e, n)) for e, n in
                     zip(self.spec[1:], value.shape[1:]))
        return np.ascontiguousarray(value[(self.rows,) + tail])


class TokenBatchSource:
    """The language models' batches: ``tokens`` and ``labels`` rows of a
    ``TokenDataset`` and, for the VLM and audio families, the dense side
    inputs ``extras`` (name -> trailing shape: ``embeds`` [n_patches, D],
    ``frames`` [n_frames, D]), an f32 normal draw from
    ``np.random.default_rng(step)`` over the whole batch (the reference's:
    preprocessed modality features), cut to the rank's rows and its block
    of D (the block spec's feature entry: on a 1-D model mesh).  A rank's
    token rows come from ``sample_shard``: only its rows are made."""

    def __init__(self, ds: TokenDataset, batch_size: int,
                 extras: Optional[Dict[str, Tuple[int, ...]]] = None):
        self.ds = ds
        self.batch_size = batch_size
        self.extras = dict(extras or {})
        self.keys = ("tokens", "labels") + tuple(self.extras)
        self._memo_key: Any = None
        self._memo: Dict[Any, Dict[str, np.ndarray]] = {}

    def _step_memo(self, step: int) -> Dict[Any, Dict[str, np.ndarray]]:
        """The memo of ``step`` (rows read and extras drawn), emptied when
        the step changes."""
        if self._memo_key != step:
            self._memo_key, self._memo = step, {}
        return self._memo

    def _extra(self, key: str, step: int) -> np.ndarray:
        memo = self._step_memo(step).setdefault("extras", {})
        if key not in memo:
            rng = np.random.default_rng(step)
            memo[key] = rng.normal(0, 1, (self.batch_size,)
                                   + self.extras[key]).astype(np.float32)
        return memo[key]

    def full_batch(self, step: int, horizon: int,
                   cancel: Optional[threading.Event] = None
                   ) -> Dict[str, np.ndarray]:
        del horizon, cancel
        out = self.ds.sample_batch(step, self.batch_size)
        for k in self.extras:
            out[k] = self._extra(k, step)
        return out

    def plan(self, spec: Spec, mesh) -> _RowPlan:
        return _RowPlan(_rows(spec, mesh, self.batch_size), spec, mesh)

    def read_key(self, key: str, step: int, horizon: int, plan: _RowPlan,
                 cancel: Optional[threading.Event] = None) -> np.ndarray:
        """``key``'s rows under ``plan`` (tokens and labels made once per
        step and plan)."""
        del horizon, cancel
        if key in self.extras:
            return plan.cut(self._extra(key, step))
        memo = self._step_memo(step)
        if plan not in memo:
            memo[plan] = self.ds.sample_shard(step, self.batch_size,
                                              row_slice=plan.rows)
        return memo[plan][key]

    def sync_block(self, value: np.ndarray, spec: Spec, mesh) -> np.ndarray:
        """A key of the whole batch as ``"sync-full"`` hands it over: the
        rank's rows (the model takes the rows it is given) and, of a side
        input, its block of D."""
        return self.plan(spec, mesh).cut(value)


class InputPipeline:
    """Domain-parallel, prefetching input pipeline.

    ``source``: a ``WeatherBatchSource`` or a ``TokenBatchSource``;
    ``mesh``: this rank's ``Mesh`` or ``Mesh1D``, or None (one device);
    ``specs``: the batch keys' block specs (``launch/specs.py::
    block_specs``), required with a mesh.
    ``prefetch`` is the number of batches the background thread keeps in
    flight (0: batches are made on the caller's thread).  ``cursor`` is the
    next step the pipeline will serve: batches are pure functions of the
    step, so it is the pipeline's whole state.
    """

    def __init__(self, source, *, mesh=None,
                 specs: Optional[Dict[str, Spec]] = None,
                 mode: str = "sharded", prefetch: int = 2, device="cuda"):
        if mode not in MODES:
            raise ValueError(f"unknown pipeline mode {mode!r} "
                             f"(expected one of {MODES})")
        if mesh is not None and specs is None:
            raise ValueError("specs required when a mesh is given")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("InputPipeline: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        self.source = source
        self.mesh = mesh
        self.specs = specs or {}
        self.rank = -1 if mesh is None else mesh.rank
        self.mode = mode
        self.prefetch = int(prefetch)
        self.stats = PipelineStats()
        self.cursor = 0
        self._plans: Dict[Spec, _ReadPlan] = {}
        self._queue: Optional[queue.Queue] = None
        self._stop_event: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # -- host-side ------------------------------------------------------
    def host_batch(self, step: int, horizon: int = 1,
                   cancel: Optional[threading.Event] = None
                   ) -> Dict[str, np.ndarray]:
        """The full batch on the host."""
        return self.source.full_batch(step, horizon, cancel)

    # -- device-side ----------------------------------------------------
    def get(self, step: int, horizon: int = 1,
            cancel: Optional[threading.Event] = None
            ) -> Dict[str, torch.Tensor]:
        """The batch for ``step`` on the pipeline's device, copied on the
        current stream: the whole batch, or on a mesh in ``"sharded"`` mode
        this rank's block.  Raises ``weather.Cancelled`` once ``cancel`` is
        set (checked between the host's chunks of work, and before the
        copy to the device: none starts after it)."""
        reads: list = []
        if self.mesh is None or self.mode == "sync-full":
            host = self.host_batch(step, horizon, cancel)
            if self.mesh is not None:
                reads.extend((k, -1, v.nbytes) for k, v in host.items())
                host = {k: self.source.sync_block(v, self.specs[k],
                                                  self.mesh)
                        for k, v in host.items()}
        else:
            host = {k: self._assemble(k, step, horizon, reads, cancel)
                    for k in self.source.keys}
        if cancel is not None and cancel.is_set():
            raise Cancelled()
        out = {k: self._to_device(v) for k, v in host.items()}
        self.stats.record_batch(reads, steps=1)
        return out

    def _plan_for(self, key: str) -> _ReadPlan:
        """This rank's (cached) read plan for ``key``'s spec."""
        spec = self.specs[key]
        plan = self._plans.get(spec)
        if plan is None:
            plan = self._plans[spec] = self.source.plan(spec, self.mesh)
            self.stats.record_batch([], plan_builds=1)
        return plan

    def _assemble(self, key: str, step: int, horizon: int, reads: list,
                  cancel: Optional[threading.Event] = None) -> np.ndarray:
        """This rank's block of ``key`` from its plan's reads; the read's
        record is appended to ``reads`` for the caller's one
        ``record_batch``."""
        block = self.source.read_key(key, step, horizon,
                                     self._plan_for(key), cancel)
        reads.append((key, self.rank, block.nbytes))
        return block

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- resume state ----------------------------------------------------
    def state(self) -> Dict[str, int]:
        return {"cursor": int(self.cursor)}

    def set_state(self, state: Dict[str, int]) -> None:
        self.cursor = int(state["cursor"])

    # -- prefetching iterator -------------------------------------------
    def iterate(self, horizons: Sequence[int],
                start_step: Optional[int] = None
                ) -> Iterable[Dict[str, torch.Tensor]]:
        """Yield device batches for steps ``start_step + i`` with rollout
        horizons ``horizons[i]``; ``start_step=None`` continues from the
        cursor.  With ``prefetch > 0`` a daemon thread makes and copies
        batches ahead of the consumer; values are the same either way."""
        n = len(horizons)
        if start_step is None:
            start_step = self.cursor
        if self.prefetch <= 0:
            for i in range(n):
                batch = self.get(start_step + i, int(horizons[i]))
                self.cursor = start_step + i + 1
                yield batch
            return

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        tr = telemetry.get_tracer()
        side = (torch.cuda.Stream(self.device)
                if self.device.type == "cuda" else None)

        def worker():
            try:
                for i in range(n):
                    if stop.is_set():
                        return
                    with tr.span("pipeline.produce", step=start_step + i):
                        ctx = (torch.cuda.stream(side) if side is not None
                               else contextlib.nullcontext())
                        with ctx:
                            batch = self.get(start_step + i,
                                             int(horizons[i]), stop)
                        if side is not None:
                            side.synchronize()
                    while not stop.is_set():
                        # bounded put: never blocks forever against a
                        # consumer that has already given up (stop())
                        try:
                            q.put((batch, None), timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except Cancelled:                # stop() mid-batch
                return
            except BaseException as e:       # surfaced on the consumer
                q.put((None, e))

        t = threading.Thread(target=worker, name="input-pipeline",
                             daemon=True)
        self._queue, self._stop_event, self._thread = q, stop, t
        t.start()
        try:
            for i in range(n):
                # depth before the blocking get: 0 means the consumer is
                # about to stall on the producer
                tr.gauge("pipeline.queue_depth", q.qsize())
                while True:
                    try:
                        batch, err = q.get(timeout=0.1)
                        break
                    except queue.Empty:
                        if stop.is_set():        # stop() from elsewhere
                            return
                if err is not None:
                    raise err
                if side is not None:
                    # made on the side stream, used on this one: keep the
                    # allocator from reusing the memory before it is done
                    cur = torch.cuda.current_stream(self.device)
                    for v in batch.values():
                        v.record_stream(cur)
                self.cursor = start_step + i + 1
                yield batch
        finally:
            self.stop()

    def stop(self, timeout: float = 5.0) -> bool:
        """Cancel the prefetch worker: set its stop flag (the batch it is
        making stops at its next chunk of host work, and starts no copy
        to the device), drain the queue so a blocked ``put`` wakes up, and
        join with ``timeout``.  Returns True when the thread is down
        (idempotent; call again to join longer)."""
        t, q, stop = self._thread, self._queue, self._stop_event
        if t is None:
            return True
        stop.set()
        while True:                          # unblock a producer in put()
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=timeout)
        alive = t.is_alive()
        if not alive:
            self._queue = self._stop_event = self._thread = None
        return not alive

    # -- modeled I/O -----------------------------------------------------
    def io_bytes_per_rank(self, n_ranks: int) -> int:
        """Modeled bytes per rank per step of one key (the dataset's model;
        held against ``stats.rank_bytes`` in the tests)."""
        return self.source.ds.io_bytes_per_rank(self.source.batch_size,
                                                n_ranks)


def make_source(cfg, batch_size: int, seq_len: int = 128, seed: int = 0):
    """The batch source of a ModelConfig's family: weather fields for the
    mixer, token rows of ``seq_len`` for the language models (with the
    VLM's ``embeds`` and the audio family's ``frames``)."""
    if cfg.family == "mixer":
        ds = WeatherDataset(WeatherDataConfig(
            lat=cfg.wm_lat, lon=cfg.wm_lon, channels=cfg.wm_channels,
            seed=seed))
        return WeatherBatchSource(ds, batch_size, patch=cfg.wm_patch)
    ds = TokenDataset(TokenDataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=seq_len, seed=seed))
    extras: Dict[str, Tuple[int, ...]] = {}
    if cfg.family == "vlm":
        extras["embeds"] = (cfg.n_patches, cfg.d_model)
    if cfg.family == "audio":
        extras["frames"] = (cfg.n_frames, cfg.d_model)
    return TokenBatchSource(ds, batch_size, extras)


def make_pipeline(cfg, *, batch_size: int, seq_len: int = 128,
                  mode: str = "sharded", prefetch: int = 2, seed: int = 0,
                  device="cuda", mesh=None) -> InputPipeline:
    """The pipeline of a ModelConfig; on a ``mesh`` its batches are laid
    out by ``launch/specs.py::block_specs``."""
    specs = None if mesh is None else block_specs(cfg, mesh.rules)
    return InputPipeline(make_source(cfg, batch_size, seq_len=seq_len,
                                     seed=seed),
                         mesh=mesh, specs=specs, mode=mode,
                         prefetch=prefetch, device=device)
