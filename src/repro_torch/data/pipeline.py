"""The input pipeline on one device: synthetic weather batches made on the
host, copied to the device, and prefetched by a background thread (the
one-device part, ``mesh=None``, of ``repro/data/pipeline.py``).

Batches are a pure function of (seed, step, horizon); the prefetch thread
changes timing only, never values.  On one device the reference's two modes
read the same full batch, so ``"sharded"`` and ``"sync-full"`` are both
accepted and give identical batches.  The per-rank read plans of the
domain-parallel path (each model-parallel rank reading only its slice of
the grid) come with the multi-GPU slice (ROADMAP.md, queue 1 item 6).

On a CUDA device the prefetch thread copies each batch on a side stream
from pinned host memory and waits for the copy, so the training stream
never waits on a host-to-device transfer it did not ask for.
"""
from __future__ import annotations

import contextlib
import queue
import threading
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.data.weather import WeatherDataConfig, WeatherDataset

MODES = ("sharded", "sync-full")


class WeatherBatchSource:
    """ERA5-like fields and their target ``horizon`` steps ahead."""

    keys = ("fields", "target")

    def __init__(self, ds: WeatherDataset, batch_size: int):
        self.ds = ds
        self.batch_size = batch_size

    def full_batch(self, step: int, horizon: int) -> Dict[str, np.ndarray]:
        return self.ds.sample_batch(step, self.batch_size, horizon=horizon)


class InputPipeline:
    """Prefetching input pipeline on one device.

    ``prefetch`` is the number of batches the background thread keeps in
    flight (0: batches are made on the caller's thread).  ``cursor`` is the
    next step the pipeline will serve: batches are pure functions of the
    step, so it is the pipeline's whole state.
    """

    def __init__(self, source: WeatherBatchSource, *, mode: str = "sharded",
                 prefetch: int = 2, device="cuda"):
        if mode not in MODES:
            raise ValueError(f"unknown pipeline mode {mode!r} "
                             f"(expected one of {MODES})")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("InputPipeline: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        self.source = source
        self.mode = mode
        self.prefetch = int(prefetch)
        self.cursor = 0
        self._queue: Optional[queue.Queue] = None
        self._stop_event: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # -- host-side ------------------------------------------------------
    def host_batch(self, step: int, horizon: int = 1
                   ) -> Dict[str, np.ndarray]:
        """The full batch on the host."""
        return self.source.full_batch(step, horizon)

    # -- device-side ----------------------------------------------------
    def get(self, step: int, horizon: int = 1) -> Dict[str, torch.Tensor]:
        """The batch for ``step`` on the pipeline's device, copied on the
        current stream."""
        out = {k: self._to_device(v)
               for k, v in self.host_batch(step, horizon).items()}
        telemetry.get_tracer().counter("pipeline.batches")
        return out

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
                                             int(horizons[i]))
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
                batch, err = q.get()
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
        """Cancel the prefetch worker: set its stop flag, drain the queue so
        a blocked ``put`` wakes up, and join with ``timeout``.  Returns True
        when the thread is down (idempotent)."""
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


def make_source(cfg, batch_size: int, seed: int = 0) -> WeatherBatchSource:
    """The batch source of a mixer-family ModelConfig."""
    if cfg.family != "mixer":
        raise NotImplementedError(
            f"the port's pipeline serves the mixer family only; "
            f"{cfg.arch_id} is {cfg.family!r} (ROADMAP.md, queue 1 item 14)")
    ds = WeatherDataset(WeatherDataConfig(
        lat=cfg.wm_lat, lon=cfg.wm_lon, channels=cfg.wm_channels,
        seed=seed))
    return WeatherBatchSource(ds, batch_size)


def make_pipeline(cfg, *, batch_size: int, mode: str = "sharded",
                  prefetch: int = 2, seed: int = 0,
                  device="cuda") -> InputPipeline:
    return InputPipeline(make_source(cfg, batch_size, seed=seed), mode=mode,
                         prefetch=prefetch, device=device)
