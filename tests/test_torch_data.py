"""The port's copy of the synthetic weather data against the reference's.

The copy evaluates tiles of a few channels and latitude rows at a time
(the reference's intermediate is ~4.6 GB per sample at the full grid),
the tiles on a pool of threads; the values must stay bit-equal, whatever
the tile and the pool.  The tests below set the number of tiles run at
once (``host_workers``), let tiles of these small grids go to the pool
(``POOL_MIN_CHUNK_BYTES``) and cut their latitude rows (``TILE_BYTES``).
"""
import os
import threading
import time

import numpy as np
import pytest

from repro.data.weather import WeatherDataConfig as RefConfig
from repro.data.weather import WeatherDataset as RefDataset
from repro_torch.data import weather
from repro_torch.data.pipeline import InputPipeline, WeatherBatchSource
from repro_torch.data.weather import WeatherDataConfig, WeatherDataset


@pytest.mark.parametrize("lat,lon,chans,seed", [
    (32, 64, 8, 0), (16, 32, 4, 3), (24, 48, 69, 1), (8, 16, 3, 5)])
def test_sample_batch_bit_equal(lat, lon, chans, seed):
    kw = dict(lat=lat, lon=lon, channels=chans, seed=seed)
    want = RefDataset(RefConfig(**kw)).sample_batch(2, 3, horizon=2)
    ds = WeatherDataset(WeatherDataConfig(**kw))
    got = ds.sample_batch(2, 3, horizon=2)
    assert np.array_equal(got["fields"], want["fields"])
    assert np.array_equal(got["target"], want["target"])
    assert np.array_equal(ds.sample_fields(2, 3), want["fields"])


def test_sample_shard_bit_equal():
    kw = dict(lat=16, lon=32, channels=7, seed=2)
    sl = dict(lon_slice=slice(8, 24), chan_slice=slice(1, 6),
              row_slice=slice(1, 3), lat_slice=slice(2, 10))
    want = RefDataset(RefConfig(**kw)).sample_shard(4, 4, **sl)
    got = WeatherDataset(WeatherDataConfig(**kw)).sample_shard(4, 4, **sl)
    for k in ("fields", "target"):
        assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("chunk", [1, 2, 5, 100])
def test_channel_chunking_does_not_change_values(chunk):
    ds = WeatherDataset(WeatherDataConfig(lat=8, lon=16, channels=9))
    idx, lat, lon, ch = (np.arange(2), np.arange(8), np.arange(16),
                         np.arange(9))
    assert np.array_equal(ds._eval(idx, lat, lon, ch, 0.3, chan_chunk=chunk),
                          ds._eval(idx, lat, lon, ch, 0.3, chan_chunk=9))


# -- the host's fields on a worker pool ---------------------------------

def _workers(monkeypatch, n):
    """Every field evaluation runs ``n`` chunks at once, small ones too."""
    monkeypatch.setattr(weather, "host_workers", lambda chunk_bytes: n)
    monkeypatch.setattr(weather, "POOL_MIN_CHUNK_BYTES", 0)


@pytest.mark.parametrize("workers", [1, 2, 4])
@pytest.mark.parametrize("chunk", [1, 3, 4, 100])
def test_pool_is_bit_equal_to_reference(monkeypatch, workers, chunk):
    """Any pool size and chunk size: the reference's ``sample_batch`` and
    ``_eval`` bit for bit (each chunk writes its own channels)."""
    _workers(monkeypatch, workers)
    kw = dict(lat=16, lon=32, channels=13, seed=4)
    ref = RefDataset(RefConfig(**kw))
    ds = WeatherDataset(WeatherDataConfig(**kw))
    idx, lat, lon, ch = (np.arange(3) + 6, np.arange(16), np.arange(32),
                         np.arange(13))
    assert np.array_equal(
        ds._eval(idx, lat, lon, ch, 0.7, chan_chunk=chunk),
        ref._eval(idx, lat, lon, ch, 0.7))
    want = ref.sample_batch(2, 3, horizon=2)
    got = ds.sample_batch(2, 3, horizon=2)
    for k in ("fields", "target"):
        assert np.array_equal(got[k], want[k])


@pytest.mark.parametrize("rows", [1, 3, 7])
def test_latitude_tiles_are_bit_equal_to_reference(monkeypatch, rows):
    """Tiles of ``rows`` latitude rows (``TILE_BYTES`` set so), one or two
    channels, on the pool and on one thread: the reference's ``_eval``
    and ``sample_batch`` bit for bit, a ragged last block of rows too."""
    kw = dict(lat=16, lon=32, channels=5, seed=6)
    ref = RefDataset(RefConfig(**kw))
    ds = WeatherDataset(WeatherDataConfig(**kw))
    idx, lat, lon, ch = (np.arange(2) + 3, np.arange(16), np.arange(32),
                         np.arange(5))
    want = ref._eval(idx, lat, lon, ch, 0.4)
    for workers in (1, 3):
        _workers(monkeypatch, workers)
        for width in (1, 2):
            row = weather.CHUNK_TEMPS * 8 * 2 * ds.cfg.n_modes * width * 32
            monkeypatch.setattr(weather, "TILE_BYTES", rows * row)
            assert np.array_equal(
                ds._eval(idx, lat, lon, ch, 0.4, chan_chunk=width), want)
        got = ds.sample_batch(1, 2, horizon=3)
        for k, v in ref.sample_batch(1, 2, horizon=3).items():
            assert np.array_equal(got[k], v)


def test_host_workers_share_cores_and_memory(monkeypatch):
    """The pool takes the cores this process may use, divided among the
    ranks of the host, less one for the loop, and no more chunks than half
    the available memory holds."""
    cores = len(os.sched_getaffinity(0))
    avail = 64 << 30
    monkeypatch.setattr(weather, "_available_bytes", lambda: avail)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert weather.host_workers(1) == max(1, cores - 1)
    assert weather.host_workers(avail) == 1
    assert weather.host_workers(avail // 8) == max(1, min(cores - 1, 4))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert weather.host_workers(1) == max(1, cores // 4 - 1)
    assert weather.host_workers(avail // 8) == 1


def test_cancel_between_chunks(monkeypatch):
    _workers(monkeypatch, 2)
    ds = WeatherDataset(WeatherDataConfig(lat=8, lon=16, channels=9))
    ev = threading.Event()
    ev.set()
    with pytest.raises(weather.Cancelled):
        ds.sample_batch(0, 2, cancel=ev)


def test_pipeline_stop_mid_batch_returns_promptly(monkeypatch):
    """A batch that takes seconds to make: ``stop()`` during it returns
    True within 5 s (the producer stops at its next chunk), and a consumer
    waiting on the batch ends."""
    _workers(monkeypatch, 2)
    ds = WeatherDataset(WeatherDataConfig(lat=182, lon=360, channels=512))
    pipe = InputPipeline(WeatherBatchSource(ds, 2, patch=2), prefetch=1,
                         device="cpu")
    it = pipe.iterate([1, 1])
    consumer = threading.Thread(target=lambda: list(it), daemon=True)
    consumer.start()
    t0 = time.monotonic()
    while pipe._thread is None:
        assert time.monotonic() - t0 < 30
        time.sleep(0.01)
    time.sleep(0.5)                       # inside the first batch
    t0 = time.monotonic()
    assert pipe.stop(timeout=5.0)
    assert time.monotonic() - t0 < 5.0
    consumer.join(timeout=5.0)
    assert not consumer.is_alive()
    assert pipe.cursor == 0               # no batch was made
