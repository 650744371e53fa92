"""Async checkpoint writer: hide checkpoint I/O behind training compute
(the port of ``repro/checkpoint/writer.py``).

The same two-phase split as the input pipeline's prefetch thread
(``data/pipeline.py``), mirrored onto the output side:

  1. ``save()`` SYNCHRONOUSLY copies this rank's blocks to host memory
     (``sharded.snapshot``) -- this must happen on the caller's thread,
     before the next train step updates the parameters and the optimizer
     state in place -- then
  2. hands the Snapshot to a background thread that streams the shard
     files and manifest to disk while the train loop keeps stepping.

Guards:

  * at most ONE write is in flight: a second ``save()`` first waits for
    the previous write (bounding host memory to ~2 snapshots and
    keeping checkpoint directories internally consistent);
  * ``wait()`` is the barrier -- it joins the worker and re-raises any
    write error on the caller's thread (a failed checkpoint must not be
    silent);
  * transient ``OSError``s (an NFS blip, a full-but-draining disk) are
    retried with jittered exponential backoff (``retries`` attempts,
    before the error is surfaced at all -- a preemption save should not
    die on the first EIO of a node being reclaimed;
  * the writer is reusable after ``wait()``.
"""
from __future__ import annotations

import random
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch import telemetry
from repro_torch.checkpoint import sharded


class AsyncCheckpointWriter:
    """Background writer for sharded checkpoints.

    ``write_fn(snapshot, path)`` defaults to ``sharded.write_snapshot``
    and is injectable for tests (e.g. a slowed writer to assert the
    train loop genuinely overlaps the write).  ``retries``/
    ``retry_backoff`` bound the transient-``OSError`` retry loop
    (attempts total; backoff doubles per attempt, with jitter).
    """

    def __init__(self, write_fn: Optional[Callable] = None, *,
                 retries: int = 3, retry_backoff: float = 0.25):
        self._write_fn = write_fn or sharded.write_snapshot
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.retries = max(1, int(retries))
        self.retry_backoff = retry_backoff
        self.saves = 0            # completed + in-flight submissions

    # -- state ----------------------------------------------------------
    @property
    def in_flight(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # -- barrier --------------------------------------------------------
    def wait(self) -> None:
        """Block until the in-flight write (if any) finishes; re-raise
        its error here."""
        with self._lock:
            self._wait_locked()

    def _wait_locked(self) -> None:
        # caller holds self._lock; the worker never takes it, so joining
        # under the lock cannot deadlock
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- the write itself ------------------------------------------------
    def _write_with_retry(self, snap: sharded.Snapshot, path: str,
                          kwargs: dict) -> None:
        """Run write_fn; retry transient OSErrors with jittered
        exponential backoff before re-raising (non-OSError failures are
        bugs, not weather -- they surface immediately)."""
        tr = telemetry.get_tracer()
        for attempt in range(1, self.retries + 1):
            try:
                with tr.span("ckpt.write", path=path, attempt=attempt):
                    return self._write_fn(snap, path, **kwargs)
            except OSError as e:
                if attempt >= self.retries:
                    raise
                tr.counter("ckpt.retries")
                tr.event("ckpt.retry", path=path, attempt=attempt,
                         error=repr(e))
                delay = (self.retry_backoff * (2 ** (attempt - 1))
                         * (1.0 + random.random()))
                print(f"[ckpt] transient write error on {path!r} "
                      f"(attempt {attempt}/{self.retries}): {e!r}; "
                      f"retrying in {delay:.2f}s")
                time.sleep(delay)

    # -- submission -----------------------------------------------------
    def save(self, path: str, groups: Dict[str, Any], *, step: int = 0,
             extra: Optional[dict] = None, mesh=None,
             specs: Optional[Dict[str, Any]] = None, block: bool = False,
             prune: Optional[List[str]] = None,
             process_index: int = 0,
             process_count: int = 1) -> sharded.Snapshot:
        """Snapshot ``groups`` now; write them in the background.

        ``mesh`` and ``specs`` place each leaf (``sharded.snapshot``).
        Returns the Snapshot (its ``bytes_per_rank`` is the per-rank
        byte accounting).  ``block=True`` degrades to a synchronous
        save.

        ``prune`` lists older checkpoint directories to delete (the
        engine's keep-last-k GC) -- removed only AFTER this save's files
        are fully on disk, so an interrupted write never leaves the run
        with fewer durable checkpoints than before.

        ``process_index``/``process_count`` select the mesh's write path
        (each rank a process: per-process shard index + rank-0 manifest
        merge, ``sharded.write_snapshot``); the defaults are the
        single-process behavior."""
        prune = list(prune or [])
        kwargs = ({} if process_count <= 1
                  else {"process_index": process_index,
                        "process_count": process_count})
        with self._lock:
            self._wait_locked()               # in-flight guard
            snap = sharded.snapshot(groups, step=step, extra=extra,
                                    mesh=mesh, specs=specs)
            self.saves += 1
            if block:
                self._write_with_retry(snap, path, kwargs)
                self._prune(prune)
                return snap

            def work():
                try:
                    self._write_with_retry(snap, path, kwargs)
                    self._prune(prune)
                except BaseException as e:    # surfaced at next wait()
                    self._error = e

            self._thread = threading.Thread(
                target=work, name=f"ckpt-writer:{path}", daemon=True)
            self._thread.start()
            return snap

    @staticmethod
    def _prune(paths: List[str]) -> None:
        """Delete GC'd checkpoint dirs (missing ones are fine)."""
        if not paths:
            return
        with telemetry.get_tracer().span("ckpt.prune", n=len(paths)):
            for p in paths:
                shutil.rmtree(p, ignore_errors=True)
