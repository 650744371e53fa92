"""Request scheduling for the forecast serving engine.

A copy of ``repro/serve/scheduler.py``, kept in the port so that the port
imports nothing of the JAX package.  Host-side policy only -- no torch,
no jax -- so every
scheduling decision (coalescing, continuous admission, bucket growth,
lead-time fan-out) is unit-testable with a fake clock, and the engine
(``serve/engine.py``) owns every device interaction.

The scheduler advances in *rollout-step boundaries*: one ``tick()``
decides what happens before the next autoregressive model step (form or
grow the batch, admit queued requests into free slots, or wait out the
coalescing window), the engine runs the device step, and ``advance()``
then ages every in-flight request, returning which slots must be peeled
(a requested lead time was reached) and which are finished and freed.

Why admission only at step boundaries: every request in the batch shares
ONE rollout step, so the only points where the batch composition
may change without tearing that step apart are between applications of
it.  Admitting there costs a single O(fields) row write into the
state buffer; admitting mid-step would mean re-running the partial step
(wasted compute).
Draining instead (classic static batching) makes every request wait for
the slowest lead time in its batch.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

Lead = Union[int, Sequence[int]]

_RID = itertools.count()


class ForecastResult:
    """Future-style handle for one submitted forecast request.

    ``leads`` may name several horizons: the request occupies ONE batch
    slot for ``max_lead`` rollout steps and *peels off* an output at
    each requested lead (lead-time fan-out) -- intermediate horizons
    are free, they ride the same rollout.
    """

    def __init__(self, fields, leads: Tuple[int, ...], submit_t: float):
        self.fields = fields                     # host array [lat, lon, C]
        self.leads = leads                       # sorted, unique, >= 1
        self.rid = next(_RID)
        self.submit_t = submit_t
        self.start_t: Optional[float] = None     # admission time
        self.done_t: Optional[float] = None
        self.outputs: Dict[int, object] = {}     # lead -> fields array
        self._event = threading.Event()

    @property
    def max_lead(self) -> int:
        return self.leads[-1]

    def deliver(self, lead: int, out, now: float) -> None:
        self.outputs[lead] = out
        if lead == self.max_lead:
            self.done_t = now
            self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until the final lead is delivered; returns its fields."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done")
        return self.outputs[self.max_lead]

    def output(self, lead: int):
        return self.outputs[lead]

    def latency(self) -> float:
        return self.done_t - self.submit_t

    def queue_delay(self) -> float:
        return self.start_t - self.submit_t


class _Slot:
    __slots__ = ("req", "age")

    def __init__(self, req: ForecastResult):
        self.req = req
        self.age = 0          # rollout steps taken since admission


class Tick:
    """One boundary's worth of instructions for the engine."""
    __slots__ = ("wait", "form", "grow", "admit", "step")

    def __init__(self, *, wait: Optional[float] = None,
                 form: Optional[int] = None, grow: Optional[int] = None,
                 admit: Optional[List[Tuple[int, ForecastResult]]] = None,
                 step: bool = False):
        self.wait = wait        # seconds left in the coalescing window
        self.form = form        # build a fresh state at this bucket
        self.grow = grow        # pad the live state up to this bucket
        self.admit = admit or []  # [(slot index, request)]
        self.step = step        # run the device rollout step

    @property
    def idle(self) -> bool:
        return (self.wait is None and self.form is None
                and self.grow is None and not self.admit and not self.step)


class MicrobatchScheduler:
    """Continuous-batching policy over padded batch buckets.

    * ``buckets``: ascending padded batch sizes; the engine sets up one
      state buffer per bucket and reuses it.  A batch of n
      live requests runs at ``bucket_for(n)`` -- the smallest bucket
      >= n, or the largest bucket when oversubscribed (the rest queue).
    * ``mode="continuous"``: queued requests are admitted into free
      slots at every step boundary; the batch grows to the NEXT bucket
      (one hop per boundary)
      when full.  Shrinking happens only by re-forming after the batch
      empties -- compacting a live batch downward would buy nothing (the
      padded rows are free) and cost a gather.
    * ``mode="drain"``: classic static batching -- admission only into
      an EMPTY batch; the reference baseline the benchmark beats.
    * ``coalesce_s``: when idle, hold the first arrival this long (or
      until a full max-size bucket is queued) before forming a batch, so
      bursty traffic coalesces into one microbatch instead of n singleton
      batches.
    """

    def __init__(self, buckets: Sequence[int] = (1, 2, 4, 8), *,
                 mode: str = "continuous", coalesce_s: float = 0.0,
                 clock=time.monotonic):
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"bad buckets {buckets!r}")
        if mode not in ("continuous", "drain"):
            raise ValueError(f"unknown mode {mode!r} "
                             "(expected 'continuous' | 'drain')")
        self.buckets = buckets
        self.mode = mode
        self.coalesce_s = coalesce_s
        self.clock = clock
        self._lock = threading.Lock()
        self._queue: deque = deque()
        self._slots: List[Optional[_Slot]] = []
        self.counters = {"admitted": 0, "completed": 0, "formed": 0,
                         "grown": 0, "waited": 0}

    # -- introspection ----------------------------------------------------
    @property
    def bucket(self) -> int:
        return len(self._slots)

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def active(self) -> int:
        with self._lock:
            return sum(s is not None for s in self._slots)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_bucket

    # -- the boundary protocol --------------------------------------------
    def submit(self, req: ForecastResult) -> None:
        with self._lock:
            self._queue.append(req)

    def tick(self, now: Optional[float] = None) -> Tick:
        """Decide what happens at this rollout-step boundary."""
        with self._lock:
            now = self.clock() if now is None else now
            active = sum(s is not None for s in self._slots)
            if active == 0:
                self._slots = []          # collapse the drained batch
                if not self._queue:
                    return Tick()
                if (self.coalesce_s > 0
                        and len(self._queue) < self.max_bucket):
                    deadline = self._queue[0].submit_t + self.coalesce_s
                    if now < deadline:
                        self.counters["waited"] += 1
                        return Tick(wait=deadline - now)
                b = self.bucket_for(len(self._queue))
                self._slots = [None] * b
                self.counters["formed"] += 1
                return Tick(form=b, admit=self._admit_free(now), step=True)
            # a batch is in flight
            grow = None
            admits: List[Tuple[int, ForecastResult]] = []
            if self.mode == "continuous" and self._queue:
                if (all(s is not None for s in self._slots)
                        and self.bucket < self.max_bucket):
                    nxt = self.buckets[self.buckets.index(self.bucket) + 1]
                    self._slots.extend([None] * (nxt - self.bucket))
                    self.counters["grown"] += 1
                    grow = nxt
                admits = self._admit_free(now)
            return Tick(grow=grow, admit=admits, step=True)

    def _admit_free(self, now: float) -> List[Tuple[int, ForecastResult]]:
        admits = []
        for i, s in enumerate(self._slots):
            if s is None and self._queue:
                req = self._queue.popleft()
                req.start_t = now
                self._slots[i] = _Slot(req)
                admits.append((i, req))
                self.counters["admitted"] += 1
        return admits

    def advance(self):
        """Account one completed device step.

        Returns ``(peels, finished)``: ``peels`` = [(slot, request,
        lead)] whose outputs must be read off the state now (the engine
        delivers them), ``finished`` = [(slot, request)] freed at this
        boundary (their last lead was reached).
        """
        with self._lock:
            peels, finished = [], []
            for i, s in enumerate(self._slots):
                if s is None:
                    continue
                s.age += 1
                if s.age in s.req.leads:
                    peels.append((i, s.req, s.age))
                if s.age >= s.req.max_lead:
                    finished.append((i, s.req))
                    self._slots[i] = None
                    self.counters["completed"] += 1
            return peels, finished
