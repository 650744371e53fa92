"""The port's copy of the synthetic weather data against the reference's.

The copy evaluates a few channels at a time (the reference's intermediate
is ~4.6 GB per sample at the full grid); the values must stay bit-equal.
"""
import numpy as np
import pytest

from repro.data.weather import WeatherDataConfig as RefConfig
from repro.data.weather import WeatherDataset as RefDataset
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
