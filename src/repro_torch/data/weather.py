"""Synthetic ERA5-like weather fields (the port's copy of
``repro/data/weather.py``, numpy only).

Each sample is a superposition of smooth spherical-harmonic-ish modes whose
coefficients are a pure function of (seed, sample_index, channel), so every
grid point is an independent closed form of its indices and any
(lat, lon, channel) slice can be generated alone.  The values are
bit-equal to the reference's.  One change: ``_eval`` works through the
channels a few at a time.  The reference builds a
[B, C, modes, lat, lon] float64 intermediate, about 4.6 GB per sample at
the full 728x1440x69 grid; here it is [B, chunk, modes, lat, lon].

The "forecast" target is the same field advanced by one phase step
(advection + mild nonlinearity).
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
              chan_chunk: int = 4) -> np.ndarray:
        """Evaluate fields at time offset t on an index sub-grid, working
        through ``chan_chunk`` channels at a time.
        Returns [B, len(lat_ix), len(lon_ix), len(chan_ix)] float32."""
        c = self.cfg
        coeffs = tuple(a[:, chan_ix] for a in self._coeffs(sample_idx))
        la = 2 * np.pi * lat_ix[None, :] / c.lat      # [1, La]
        lo = 2 * np.pi * lon_ix[None, :] / c.lon      # [1, Lo]
        out = np.empty((len(sample_idx), len(lat_ix), len(lon_ix),
                        len(chan_ix)), np.float32)
        for c0 in range(0, len(chan_ix), chan_chunk):
            amp, fla, flo, phs = (a[:, c0:c0 + chan_chunk] for a in coeffs)
            # field = sum_m amp * sin(f_la*la + f_lo*lo + phase + t)
            #   evaluated separably: sin(A+B) = sinA cosB + cosA sinB
            arg_lat = fla[:, :, :, None] * la[None, None]     # [B, C, M, La]
            arg_lon = (flo[:, :, :, None] * lo[None, None]
                       + phs[:, :, :, None] + t)              # [B, C, M, Lo]
            s = (np.sin(arg_lat)[:, :, :, :, None]
                 * np.cos(arg_lon)[:, :, :, None, :]
                 + np.cos(arg_lat)[:, :, :, :, None]
                 * np.sin(arg_lon)[:, :, :, None, :])         # [B,C,M,La,Lo]
            f = np.einsum("bcm,bcmxy->bxyc", amp, s) / np.sqrt(c.n_modes)
            # mild nonlinearity so the map is not purely linear
            f = f + 0.1 * f ** 2
            out[..., c0:c0 + chan_chunk] = f
        return out

    # -- public API ------------------------------------------------------
    def sample_batch(self, step: int, batch_size: int,
                     horizon: int = 1) -> dict:
        """``horizon``: number of dt steps between input and target (the
        rollout fine-tuning target is the state ``horizon`` steps ahead,
        paper §6)."""
        idx = np.arange(batch_size, dtype=np.int64) + step * batch_size
        lat = np.arange(self.cfg.lat)
        lon = np.arange(self.cfg.lon)
        ch = np.arange(self.cfg.channels)
        x = self._eval(idx, lat, lon, ch, 0.0)
        y = self._eval(idx, lat, lon, ch, horizon * self.cfg.dt_phase)
        if self.cfg.noise:
            r = np.random.default_rng(
                np.random.SeedSequence([self.cfg.seed, 999, step]))
            y = y + self.cfg.noise * r.normal(size=y.shape).astype(np.float32)
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

    def sample_index(self, step: int, batch_size: int, boxes,
                     horizon: int = 1, rows=slice(None)) -> list:
        """Domain-parallel read by index arrays: for each box ``(lat_ix,
        lon_ix, chan_ix)`` of the grid, the fields and target of the
        ``rows`` of the batch at those points, [b, len(lat_ix),
        len(lon_ix), len(chan_ix)], bit-equal to indexing
        ``sample_batch(..., horizon=horizon)``'s with ``np.ix_``; only the
        boxes are evaluated.  The noise is per full grid (regenerated, once
        for all boxes, and indexed)."""
        idx = (np.arange(batch_size, dtype=np.int64)
               + step * batch_size)[rows]
        noise = self._noise(step, batch_size)[rows] if self.cfg.noise \
            else None
        out = []
        for lat, lon, ch in boxes:
            x = self._eval(idx, lat, lon, ch, 0.0)
            y = self._eval(idx, lat, lon, ch, horizon * self.cfg.dt_phase)
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
