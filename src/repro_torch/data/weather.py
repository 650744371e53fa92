"""Synthetic ERA5-like weather fields (the port's copy of
``repro/data/weather.py``, numpy only).

Each sample is a superposition of smooth spherical-harmonic-ish modes whose
coefficients are a pure function of (seed, sample_index, channel), so every
grid point is an independent closed form of its indices and any
(lat, lon, channel) slice can be generated alone.  The values are
bit-equal to the reference's.  One change: ``_eval`` works through the
grid in tiles of a channel and a block of latitude rows, the tiles
spread over the process's pool of threads (numpy's ufuncs and einsum
release the GIL).  The reference builds a [B, C, modes, lat, lon]
float64 intermediate, about 4.6 GB per sample at the full 728x1440x69
grid; here a tile's is about ``TILE_BYTES``, small enough that the
allocator reuses its memory instead of faulting in fresh pages for every
tile.  Each tile writes its own block of the output with the reference's
arithmetic, so neither the tile nor the pool changes a bit.  A call runs
at most ``host_workers`` tiles at once: the cores this process may use,
shared among the ranks of the host (``LOCAL_WORLD_SIZE``), less one left
to the training loop and the checkpoint writer, and no more than the
available memory holds.  The target's noise (one draw of the whole
batch's values from one stream) is drawn on the pool while the fields
are evaluated.  A ``cancel`` event (the input pipeline's stop) is checked
between tiles: the evaluation raises ``Cancelled``.

The "forecast" target is the same field advanced by one phase step
(advection + mild nonlinearity).
"""
from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

# float64 [B, channels, modes, lat, lon] arrays alive at once while a tile
# is evaluated: the two products of ``s`` and their sum
CHUNK_TEMPS = 3
# the temporaries of one tile: its latitude rows are as many as fit
TILE_BYTES = 16 << 20
# the share of the host's available memory the pool's chunks may hold
MEM_SHARE = 0.5
# below this many bytes of temporaries a tile, handing tiles to threads
# costs more than it saves: the caller's thread evaluates them
POOL_MIN_CHUNK_BYTES = 8 << 20

_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


class Cancelled(Exception):
    """A field evaluation stopped between chunks: its ``cancel`` event was
    set (the input pipeline's ``stop``)."""


def _check(cancel: Optional[threading.Event]) -> None:
    if cancel is not None and cancel.is_set():
        raise Cancelled()


def _available_bytes() -> int:
    """The host's available memory (``MemAvailable``), or its free pages
    where /proc/meminfo is missing."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def host_workers(chunk_bytes: int) -> int:
    """Chunks of ``chunk_bytes`` temporaries each to evaluate at once: the
    cores this process may use, divided among the ranks that share the
    host (``LOCAL_WORLD_SIZE``, set by the launchers), less one for the
    training loop's own host work (the copies to and from the card, the
    checkpoint writer), and no more chunks in flight than ``MEM_SHARE``
    of the available memory, divided the same way, holds."""
    local = max(1, int(os.environ.get("LOCAL_WORLD_SIZE", "1")))
    cores = len(os.sched_getaffinity(0))
    by_mem = int(MEM_SHARE * _available_bytes() / local) // max(chunk_bytes, 1)
    return max(1, min(cores // local - 1, by_mem))


def _field_pool() -> ThreadPoolExecutor:
    """The process's one pool of field threads, made at first use; it
    starts a thread only when a call has more chunks running than it has
    idle threads."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(len(os.sched_getaffinity(0)),
                                       thread_name_prefix="weather-fields")
        return _pool


@dataclasses.dataclass(frozen=True)
class WeatherDataConfig:
    lat: int
    lon: int
    channels: int
    n_modes: int = 8
    seed: int = 0
    dt_phase: float = 0.35          # time-step phase advance (the "6h")
    noise: float = 0.02


class WeatherDataset:
    def __init__(self, cfg: WeatherDataConfig):
        self.cfg = cfg

    # -- deterministic per-sample mode coefficients ---------------------
    def _coeffs(self, sample_idx: np.ndarray):
        """amplitudes/frequencies/phases: [B, C, M] each."""
        c = self.cfg
        b = sample_idx.shape[0]
        rngs = [np.random.default_rng(
            np.random.SeedSequence([c.seed, int(s)])) for s in sample_idx]
        amp = np.stack([r.normal(0, 1, (c.channels, c.n_modes)) for r in rngs])
        fla = np.stack([r.integers(1, 5, (c.channels, c.n_modes))
                        for r in rngs]).astype(np.float64)
        flo = np.stack([r.integers(1, 7, (c.channels, c.n_modes))
                        for r in rngs]).astype(np.float64)
        phs = np.stack([r.uniform(0, 2 * np.pi, (c.channels, c.n_modes))
                        for r in rngs])
        return amp, fla, flo, phs

    def _eval(self, sample_idx, lat_ix, lon_ix, chan_ix, t: float,
              chan_chunk: int = 1,
              cancel: Optional[threading.Event] = None) -> np.ndarray:
        """Evaluate fields at time offset t on an index sub-grid, in tiles
        of at most ``chan_chunk`` channels and as many latitude rows as
        keep a tile's temporaries within ``TILE_BYTES``, ``host_workers``
        tiles at once on the field pool (on the caller's thread where a
        tile is too small to pay for a thread); raises ``Cancelled`` once
        ``cancel`` is set, checked between tiles.
        Returns [B, len(lat_ix), len(lon_ix), len(chan_ix)] float32."""
        c = self.cfg
        coeffs = tuple(a[:, chan_ix] for a in self._coeffs(sample_idx))
        la = 2 * np.pi * lat_ix[None, :] / c.lat      # [1, La]
        lo = 2 * np.pi * lon_ix[None, :] / c.lon      # [1, Lo]
        out = np.empty((len(sample_idx), len(lat_ix), len(lon_ix),
                        len(chan_ix)), np.float32)
        width = max(1, min(chan_chunk, len(chan_ix)))
        row = (CHUNK_TEMPS * 8 * len(sample_idx) * c.n_modes * width
               * len(lon_ix))
        rows = max(1, min(len(lat_ix), TILE_BYTES // max(row, 1)))

        def tile(c0, l0):
            amp, fla, flo, phs = (a[:, c0:c0 + width] for a in coeffs)
            # field = sum_m amp * sin(f_la*la + f_lo*lo + phase + t)
            #   evaluated separably: sin(A+B) = sinA cosB + cosA sinB
            arg_lat = (fla[:, :, :, None]
                       * la[None, None, :, l0:l0 + rows])     # [B, C, M, La]
            arg_lon = (flo[:, :, :, None] * lo[None, None]
                       + phs[:, :, :, None] + t)              # [B, C, M, Lo]
            s = (np.sin(arg_lat)[:, :, :, :, None]
                 * np.cos(arg_lon)[:, :, :, None, :]
                 + np.cos(arg_lat)[:, :, :, :, None]
                 * np.sin(arg_lon)[:, :, :, None, :])         # [B,C,M,La,Lo]
            f = np.einsum("bcm,bcmxy->bxyc", amp, s) / np.sqrt(c.n_modes)
            # mild nonlinearity so the map is not purely linear
            f = f + 0.1 * f ** 2
            out[:, l0:l0 + rows, :, c0:c0 + width] = f

        tiles = [(c0, l0) for c0 in range(0, len(chan_ix), width)
                 for l0 in range(0, len(lat_ix), rows)]
        per = row * rows
        n = min(1 if per < POOL_MIN_CHUNK_BYTES else host_workers(per),
                len(tiles))
        if n <= 1:
            for c0, l0 in tiles:
                _check(cancel)
                tile(c0, l0)
        else:
            # n threads take the tiles in turn until none is left, the
            # stop is set, or a tile failed
            todo = iter(tiles)
            lock, failed = threading.Lock(), threading.Event()

            def drain():
                while not (failed.is_set() or
                           (cancel is not None and cancel.is_set())):
                    with lock:
                        item = next(todo, None)
                    if item is None:
                        return
                    try:
                        tile(*item)
                    except BaseException:
                        failed.set()
                        raise

            for fut in [_field_pool().submit(drain) for _ in range(n)]:
                fut.result()
        _check(cancel)
        return out

    # -- public API ------------------------------------------------------
    def sample_batch(self, step: int, batch_size: int,
                     horizon: int = 1,
                     cancel: Optional[threading.Event] = None) -> dict:
        """``horizon``: number of dt steps between input and target (the
        rollout fine-tuning target is the state ``horizon`` steps ahead,
        paper §6).  ``cancel``: as ``_eval``'s."""
        idx = np.arange(batch_size, dtype=np.int64) + step * batch_size
        lat = np.arange(self.cfg.lat)
        lon = np.arange(self.cfg.lon)
        ch = np.arange(self.cfg.channels)
        noise = self._noise_async(step, batch_size)
        x = self._eval(idx, lat, lon, ch, 0.0, cancel=cancel)
        y = self._eval(idx, lat, lon, ch, horizon * self.cfg.dt_phase,
                       cancel=cancel)
        if noise is not None:
            _check(cancel)
            y = y + self.cfg.noise * noise.result()
        return {"fields": x, "target": y}

    def sample_fields(self, step: int, batch_size: int) -> np.ndarray:
        """``sample_batch(step, batch_size)["fields"]`` without computing
        the target (serving needs initial conditions only)."""
        idx = np.arange(batch_size, dtype=np.int64) + step * batch_size
        return self._eval(idx, np.arange(self.cfg.lat),
                          np.arange(self.cfg.lon),
                          np.arange(self.cfg.channels), 0.0)

    def _noise(self, step: int, batch_size: int) -> np.ndarray:
        """The target's noise over the whole grid: one draw per step, as in
        ``sample_batch``."""
        c = self.cfg
        r = np.random.default_rng(np.random.SeedSequence([c.seed, 999, step]))
        return r.normal(size=(batch_size, c.lat, c.lon, c.channels)
                        ).astype(np.float32)

    def _noise_async(self, step: int, batch_size: int):
        """``_noise`` drawn on the field pool, beside the evaluation of the
        fields (a future; None without noise)."""
        if not self.cfg.noise:
            return None
        return _field_pool().submit(self._noise, step, batch_size)

    def sample_index(self, step: int, batch_size: int, boxes,
                     horizon: int = 1, rows=slice(None),
                     cancel: Optional[threading.Event] = None) -> list:
        """Domain-parallel read by index arrays: for each box ``(lat_ix,
        lon_ix, chan_ix)`` of the grid, the fields and target of the
        ``rows`` of the batch at those points, [b, len(lat_ix),
        len(lon_ix), len(chan_ix)], bit-equal to indexing
        ``sample_batch(..., horizon=horizon)``'s with ``np.ix_``; only the
        boxes are evaluated.  The noise is per full grid (regenerated, once
        for all boxes, and indexed).  ``cancel``: as ``_eval``'s."""
        idx = (np.arange(batch_size, dtype=np.int64)
               + step * batch_size)[rows]
        pending = self._noise_async(step, batch_size)
        noise = None
        out = []
        for lat, lon, ch in boxes:
            x = self._eval(idx, lat, lon, ch, 0.0, cancel=cancel)
            y = self._eval(idx, lat, lon, ch, horizon * self.cfg.dt_phase,
                           cancel=cancel)
            if pending is not None and noise is None:
                _check(cancel)
                noise = pending.result()[rows]
            if noise is not None:
                y = y + self.cfg.noise * noise[np.ix_(np.arange(len(idx)),
                                                      lat, lon, ch)]
            out.append({"fields": x, "target": y})
        return out

    def sample_shard(self, step: int, batch_size: int,
                     lon_slice: slice = slice(None),
                     chan_slice: slice = slice(None),
                     row_slice: slice = slice(None),
                     lat_slice: slice = slice(None),
                     horizon: int = 1) -> dict:
        """Domain-parallel read: only the (lon, channel) partition this
        model-parallel rank owns (paper §5 "Data loading"), and only the
        ``row_slice`` rows of the global batch this data-parallel rank
        owns (``sample_index`` of one box).  Identical to slicing
        ``sample_batch(..., horizon=horizon)``, but touches only the sliced
        portion of the grid."""
        c = self.cfg
        box = (np.arange(c.lat)[lat_slice], np.arange(c.lon)[lon_slice],
               np.arange(c.channels)[chan_slice])
        return self.sample_index(step, batch_size, [box], horizon,
                                 rows=row_slice)[0]

    def io_bytes_per_rank(self, batch_size: int, n_ranks: int) -> int:
        """Modeled I/O volume per rank per step (for the Fig-7 roofline's
        I/O-bandwidth-limited regime): domain parallelism divides the
        sample bytes by the number of model-parallel ranks."""
        c = self.cfg
        return 4 * batch_size * c.lat * c.lon * c.channels // n_ranks
