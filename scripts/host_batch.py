#!/usr/bin/env python3
"""The host's synthetic full-grid batches (``data/weather.py``) on one
thread and on the worker pool, on one machine, in one process.

    python3 scripts/host_batch.py [--batch 2] [--steps 3] [--no-train]

1. ``sample_batch`` of ``weathermixer-1b``'s 728x1440x69 grid at batch 2,
   step 0, rollout horizon 1, made with one thread (each channel chunk in
   turn on the calling thread, as before the pool) and with the pool
   (``host_workers``) three ways: as the pool first ran it (chunks of 4
   channels and every latitude row, the noise drawn after the fields),
   in tiles of a channel and ``TILE_BYTES`` of latitude rows with the
   noise still after, and as it runs now (tiles, the noise drawn on the
   pool beside the fields); all must be equal bit for bit.  Printed: the
   seconds of each, the pool's size and the tile.
2. Unless ``--no-train``: the full-width bf16 training run of
   ``chip_smoke.py``'s train phase (``TrainEngine``, batch 2, rollout up
   to 2, seed 0, ``--steps`` steps; needs a GPU; the kernel is built
   first) once with the fields on one thread and once on the pool, each
   printing its ``data_wait`` share of the run's step time and its (loss,
   lr, grad_norm) history; the two histories must be equal bit for bit.

Each measurement is one JSON line; the last line before the result is the
card's name and power limit (``nvidia-smi``) where a card is present.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(SRC))

import numpy as np  # noqa: E402

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.data import weather  # noqa: E402


def one_thread(fn):
    """``fn()`` with every field evaluation on the calling thread."""
    real = weather.host_workers
    weather.host_workers = lambda chunk_bytes: 1
    try:
        return fn()
    finally:
        weather.host_workers = real


class _Later:
    """A future whose value is computed when it is asked for: the noise
    drawn after the fields, as before it went to the pool."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def result(self):
        return self.fn(*self.args)


def patched(fn, chunks=False, noise_after=False):
    """``fn()`` with the pool's first arrangement of the fields (chunks of
    4 channels and every latitude row: ``chunks``) and the noise drawn
    after the fields (``noise_after``)."""
    cls = weather.WeatherDataset
    real = weather.TILE_BYTES, cls._eval, cls._noise_async
    if chunks:
        weather.TILE_BYTES = 1 << 62
        cls._eval = lambda self, *a, **kw: real[1](self, *a,
                                                   **dict(kw, chan_chunk=4))
    if noise_after:
        cls._noise_async = lambda self, step, b: (
            _Later(self._noise, step, b) if self.cfg.noise else None)
    try:
        return fn()
    finally:
        weather.TILE_BYTES, cls._eval, cls._noise_async = real


def batches(cfg, batch):
    ds = weather.WeatherDataset(weather.WeatherDataConfig(
        lat=cfg.wm_lat, lon=cfg.wm_lon, channels=cfg.wm_channels, seed=0))
    chunk = (weather.CHUNK_TEMPS * 8 * batch * ds.cfg.n_modes * 4
             * cfg.wm_lat * cfg.wm_lon)
    workers = weather.host_workers(chunk)
    runs = (("one_thread", one_thread),
            ("pool_before", lambda f: patched(f, True, True)),
            ("pool_tiles", lambda f: patched(f, False, True)),
            ("pool", lambda f: f()))
    out = {}
    for name, run in runs:
        t0 = time.perf_counter()
        got = run(lambda: ds.sample_batch(0, batch, horizon=1))
        out[name] = (time.perf_counter() - t0, got)
    want = out["one_thread"][1]
    equal = all(np.array_equal(want[k], got[k]) for _, got in out.values()
                for k in ("fields", "target"))
    print(json.dumps(dict(
        what="sample_batch", batch=batch, grid=[cfg.wm_lat, cfg.wm_lon,
                                               cfg.wm_channels],
        **{f"{name}_s": t for name, (t, _) in out.items()},
        pool_workers=workers, chunk_channels_before=4,
        chunk_temp_bytes_before=chunk, tile_channels=1,
        tile_temp_bytes=weather.TILE_BYTES, bitwise_equal=equal)),
        flush=True)
    if not equal:
        raise SystemExit("the pool's batches differ from one thread's")


def train(batch, steps):
    import torch
    from repro_torch.kernels import block_matmul as BM
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    BM.build()      # nvcc before the runs, not inside the first one's step
    cfg = EngineConfig(steps=steps, batch=batch, rollout=2,
                       precision="bf16", lr=1e-4, log_every=1, seed=0)
    hists = {}
    for name, run in (("one_thread", one_thread), ("pool", lambda f: f())):
        def go():
            eng = TrainEngine("weathermixer-1b", reduced=False,
                              device="cuda", config=cfg)
            t0 = time.perf_counter()
            hist = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            recs = eng.tracer.step_records()
            wait = sum(r["data_wait_s"] for r in recs)
            del eng
            torch.cuda.empty_cache()
            return hist, wall, wait, sum(r["dur_s"] for r in recs)
        hist, wall, wait, dur = run(go)
        hists[name] = [(h["loss"], h["lr"], h["grad_norm"]) for h in hist]
        print(json.dumps(dict(what="train", fields=name, steps=steps,
                              batch=batch, wall_s=wall, data_wait_s=wait,
                              data_wait_share=wait / dur,
                              history=hists[name])), flush=True)
    if hists["one_thread"] != hists["pool"]:
        raise SystemExit("the two training histories differ")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--no-train", action="store_true")
    args = ap.parse_args()
    batches(get_config("weathermixer-1b"), args.batch)
    if not args.no_train:
        train(args.batch, args.steps)
    try:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
    except (OSError, subprocess.SubprocessError):
        pass
    print(json.dumps({"ok": True}))


if __name__ == "__main__":
    main()
