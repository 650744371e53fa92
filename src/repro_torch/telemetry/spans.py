"""Structured spans, counters, gauges, and histograms.

A copy of ``repro/telemetry/spans.py``, kept in the port so that the port
imports nothing of the JAX package.

The process-wide observability primitive every subsystem reports into:

  * ``Tracer.span(name, **args)`` -- a context manager timing a region on
    the monotonic clock.  Spans nest per thread (a thread-local stack
    tracks depth), land in a bounded ring buffer, and export as Chrome
    trace-event "X" (complete) events -- one track per (pid, tid), so a
    Perfetto load shows ckpt-write and ring-hop spans nested under their
    steps, with background threads (prefetch producer, async ckpt
    writer) on their own tracks.
  * ``counter`` / ``add_counters`` -- monotonic accumulators.  The
    ``add_counters`` form applies a whole dict under ONE lock
    acquisition -- the input pipeline uses it to publish a batch's worth
    of I/O accounting atomically from its producer thread (the fix for
    the racy read-modify-write ``PipelineStats`` used to do).
  * ``gauge`` -- last-value instruments (prefetch queue depth); gauge
    updates also record Chrome "C" counter events so the value is a
    plotted track in Perfetto.
  * ``observe`` -- histogram samples with ``percentile``/``hist_summary``
    readouts (the serving engine's admission-to-delivery latencies).
  * ``step_record`` -- one structured dict per training step (the JSONL
    rows of the export).

Everything is guarded by one lock per tracer and costs O(µs) per call;
a disabled tracer (``enabled=False``) skips event recording but keeps
counters/gauges live, so subsystems can always report through it.

Zero dependencies beyond the standard library.
"""
from __future__ import annotations

import collections
import io
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple


def _monotonic_ns() -> int:
    return time.perf_counter_ns()


class Span:
    """One timed region.  Returned by ``Tracer.span`` -- ``dur_s`` is
    readable after the ``with`` block exits (the engine feeds its
    data-wait durations into the step records this way)."""

    __slots__ = ("name", "args", "t0_ns", "dur_ns", "tid", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args
        self.t0_ns = 0
        self.dur_ns = 0
        self.tid = 0

    @property
    def dur_s(self) -> float:
        return self.dur_ns / 1e9

    def __enter__(self) -> "Span":
        self.t0_ns = _monotonic_ns()
        self._tracer._push(self)
        return self

    def __exit__(self, *exc) -> None:
        self.dur_ns = _monotonic_ns() - self.t0_ns
        self._tracer._pop(self)


class _NullSpan:
    """Shared no-op span for disabled tracers (one instance, no
    allocation on the hot path)."""

    __slots__ = ()
    name = ""
    dur_ns = 0
    dur_s = 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()

# span stacks are per (tracer, thread): the tracer keyes the thread-local
# by its own id so two tracers in one process never share a stack
_TLS = threading.local()


class Tracer:
    """Thread-safe span/counter/gauge/histogram recorder with Chrome
    trace-event and JSONL export.

    Parameters
    ----------
    enabled : record span/instant/gauge events into the ring buffer.
        Counters, gauges and histograms stay live either way.
    ring : maximum buffered events (a per-process ring: the newest
        ``ring`` events win -- a multi-day run cannot OOM the host).
    max_hist : per-histogram sample cap (newest samples win).
    """

    def __init__(self, *, enabled: bool = True, ring: int = 200_000,
                 max_hist: int = 100_000):
        self.enabled = enabled
        self.lock = threading.Lock()
        self.pid = os.getpid()
        self.t0_ns = _monotonic_ns()
        self._events: collections.deque = collections.deque(maxlen=ring)
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, collections.deque] = {}
        self._steps: List[Dict[str, Any]] = []
        self._meta: Dict[str, Any] = {}
        self._max_hist = max_hist
        self._thread_names: Dict[int, str] = {}

    # -- spans ----------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager timing a region; nests per thread."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, args)

    def _stack(self) -> List[Span]:
        stacks = getattr(_TLS, "stacks", None)
        if stacks is None:
            stacks = _TLS.stacks = {}
        st = stacks.get(id(self))
        if st is None:
            st = stacks[id(self)] = []
        return st

    def _push(self, span: Span) -> None:
        st = self._stack()
        span.tid = threading.get_ident()
        st.append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        depth = len(st)
        with self.lock:
            self._events.append(
                ("X", span.name, span.t0_ns - self.t0_ns, span.dur_ns,
                 span.tid, depth, span.args or None))
            tn = self._thread_names
            if span.tid not in tn:
                t = threading.current_thread()
                tn[span.tid] = t.name

    def current_span(self) -> Optional[Span]:
        st = self._stack()
        return st[-1] if st else None

    # -- instants / counters / gauges / histograms ----------------------
    def event(self, name: str, **args) -> None:
        """Instant event (Chrome "i" phase) -- restarts, signals,
        final-save markers."""
        if not self.enabled:
            return
        tid = threading.get_ident()
        with self.lock:
            self._events.append(
                ("i", name, _monotonic_ns() - self.t0_ns, 0, tid, 0,
                 args or None))

    def counter(self, name: str, inc: float = 1.0) -> float:
        """Add ``inc`` to a monotonic counter; returns the new total."""
        with self.lock:
            v = self._counters.get(name, 0.0) + inc
            self._counters[name] = v
            return v

    def add_counters(self, updates: Mapping[str, float]) -> None:
        """Apply many counter increments under ONE lock acquisition --
        the batch form producer threads use."""
        with self.lock:
            self.add_counters_locked(updates)

    def add_counters_locked(self, updates: Mapping[str, float]) -> None:
        """Counter increments for callers already inside ``with
        tracer.lock`` -- lets a subsystem update its own state AND its
        counters atomically under the one tracer lock (the input
        pipeline's per-batch I/O accounting)."""
        for name, inc in updates.items():
            self._counters[name] = self._counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        """Set an instantaneous value; recorded as a Chrome "C" counter
        track when tracing is enabled."""
        tid = threading.get_ident()
        with self.lock:
            self._gauges[name] = value
            if self.enabled:
                self._events.append(
                    ("C", name, _monotonic_ns() - self.t0_ns, 0, tid, 0,
                     {"value": value}))

    def observe(self, name: str, value: float) -> None:
        """Record one histogram sample."""
        with self.lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = collections.deque(
                    maxlen=self._max_hist)
            h.append(value)

    # -- readouts -------------------------------------------------------
    def counters(self) -> Dict[str, float]:
        with self.lock:
            return dict(self._counters)

    def gauges(self) -> Dict[str, float]:
        with self.lock:
            return dict(self._gauges)

    def percentile(self, name: str, p: float) -> float:
        """p in [0, 1]; nan when the histogram is empty."""
        with self.lock:
            h = self._hists.get(name)
            vals = sorted(h) if h else []
        if not vals:
            return float("nan")
        return vals[min(len(vals) - 1, int(p * len(vals)))]

    def hist_summary(self, name: str) -> Dict[str, float]:
        with self.lock:
            h = self._hists.get(name)
            vals = sorted(h) if h else []
        if not vals:
            return {"count": 0}
        pick = lambda p: vals[min(len(vals) - 1, int(p * len(vals)))]
        return {"count": len(vals), "p50": pick(0.50), "p95": pick(0.95),
                "p99": pick(0.99), "min": vals[0], "max": vals[-1],
                "mean": sum(vals) / len(vals)}

    def hist_names(self) -> List[str]:
        with self.lock:
            return sorted(self._hists)

    # -- structured step records ----------------------------------------
    def set_meta(self, **fields) -> None:
        """Run-level constants stamped into the JSONL header record
        (cost-model terms, mesh shape, policy -- what ``trace_report``
        needs to recompute every derived field)."""
        with self.lock:
            self._meta.update(fields)

    def step_record(self, **fields) -> Dict[str, Any]:
        """Append one per-step record (the JSONL rows)."""
        with self.lock:
            self._steps.append(fields)
        return fields

    def step_records(self) -> List[Dict[str, Any]]:
        with self.lock:
            return list(self._steps)

    def span_summary(self) -> Dict[str, Dict[str, float]]:
        """Aggregate buffered spans by name: count / total_s / mean_s."""
        with self.lock:
            events = list(self._events)
        out: Dict[str, Dict[str, float]] = {}
        for ev in events:
            if ev[0] != "X":
                continue
            agg = out.setdefault(ev[1], {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += ev[3] / 1e9
        for agg in out.values():
            agg["mean_s"] = agg["total_s"] / max(agg["count"], 1)
        return out

    # -- exporters ------------------------------------------------------
    def chrome_events(self) -> List[Dict[str, Any]]:
        """The buffered events in Chrome trace-event dict form (ts/dur
        in microseconds, one (pid, tid) track per thread)."""
        with self.lock:
            events = list(self._events)
            names = dict(self._thread_names)
        out: List[Dict[str, Any]] = []
        out.append({"name": "process_name", "ph": "M", "pid": self.pid,
                    "tid": 0, "args": {"name": f"repro_torch:{self.pid}"}})
        for tid, tname in sorted(names.items()):
            out.append({"name": "thread_name", "ph": "M", "pid": self.pid,
                        "tid": tid, "args": {"name": tname}})
        for ph, name, ts_ns, dur_ns, tid, _depth, args in events:
            ev: Dict[str, Any] = {"name": name, "ph": ph,
                                  "ts": ts_ns / 1e3, "pid": self.pid,
                                  "tid": tid}
            if ph == "X":
                ev["dur"] = dur_ns / 1e3
            if ph == "i":
                ev["s"] = "t"          # thread-scoped instant
            if args:
                ev["args"] = dict(args)
            out.append(ev)
        return out

    def export_chrome(self, path: str) -> None:
        """Write the Chrome trace-event JSON (open in Perfetto /
        chrome://tracing).  Atomic: tmp + rename, so a trace file is
        never torn by a preemption mid-export."""
        doc = {"traceEvents": self.chrome_events(),
               "displayTimeUnit": "ms"}
        tmp = f"{path}.tmp.{self.pid}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)

    def jsonl_records(self) -> List[Dict[str, Any]]:
        """All structured records: meta header, per-step rows, then
        span/counter/gauge/histogram summaries."""
        with self.lock:
            meta = dict(self._meta)
            steps = list(self._steps)
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hist_names = sorted(self._hists)
        recs: List[Dict[str, Any]] = []
        # discriminator last so a meta field named "kind" cannot mask it
        recs.append({**meta, "kind": "meta"})
        for s in steps:
            recs.append({"kind": "step", **s})
        recs.append({"kind": "spans", "spans": self.span_summary()})
        recs.append({"kind": "counters", "counters": counters})
        recs.append({"kind": "gauges", "gauges": gauges})
        for name in hist_names:
            recs.append({"kind": "histogram", "name": name,
                         **self.hist_summary(name)})
        return recs

    def export_jsonl(self, path: str) -> None:
        """Write one JSON object per line (atomic tmp + rename)."""
        buf = io.StringIO()
        for rec in self.jsonl_records():
            buf.write(json.dumps(rec) + "\n")
        tmp = f"{path}.tmp.{self.pid}"
        with open(tmp, "w") as f:
            f.write(buf.getvalue())
        os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Process-wide default tracer
# ---------------------------------------------------------------------------

# Subsystems report through ``get_tracer()``; an engine that wants export
# installs its own via ``set_tracer``.  The default is a disabled tracer:
# counters/gauges stay live (the pipeline's stats lock rides on it even
# in untraced unit tests) but no events are buffered.
_DEFAULT = Tracer(enabled=False)
_CURRENT: Tracer = _DEFAULT


def get_tracer() -> Tracer:
    return _CURRENT


def set_tracer(tracer: Optional[Tracer]) -> Tracer:
    """Install ``tracer`` as the process tracer (None restores the
    disabled default); returns the previous one."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = tracer if tracer is not None else _DEFAULT
    return prev


def jsonl_path_for(trace_path: str) -> str:
    """Sibling JSONL path for a Chrome trace path:
    ``out.trace.json`` -> ``out.trace.jsonl``."""
    return (trace_path[:-5] if trace_path.endswith(".json")
            else trace_path) + ".jsonl"
