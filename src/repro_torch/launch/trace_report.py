"""Render a telemetry JSONL (the sibling of ``--trace out.trace.json``)
into a human-readable run report (a copy of
``repro/launch/trace_report.py``; pure Python):

  PYTHONPATH=src python -m repro_torch.launch.trace_report \
      out.trace.jsonl [--check]

Three sections:

  1. step-time breakdown -- per-step wall / data-wait / mfu /
     comm_fraction aggregates over the run's step records;
  2. span table -- every span name with count / total / mean, straight
     from the tracer's span summary;
  3. roofline attribution -- the measured mean step time split into the
     analytic compute and collective terms of the run's
     ``StepCostModel`` (stamped into the meta header) plus the measured
     data-wait share, ending in a one-line verdict ("this run was 31%
     data-bound"): the Fig. 7 regime classification applied to a real
     trace instead of the analytic model.

``--check`` is the CI mode: exit non-zero unless the file has a meta
header and >= 1 step records whose mfu / comm_fraction / achieved_tflops
are all finite and sane (0 <= mfu <= 1, 0 <= comm_fraction <= 1).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Any, Dict, List, Optional, Tuple


def load_records(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def split_records(recs: List[Dict[str, Any]]
                  ) -> Tuple[Dict, List[Dict], Dict, Dict, Dict, List[Dict]]:
    """(meta, steps, spans, counters, gauges, histograms)."""
    meta: Dict[str, Any] = {}
    steps: List[Dict[str, Any]] = []
    spans: Dict[str, Dict[str, float]] = {}
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: List[Dict[str, Any]] = []
    for r in recs:
        kind = r.get("kind")
        if kind == "meta":
            meta.update({k: v for k, v in r.items() if k != "kind"})
        elif kind == "step":
            steps.append(r)
        elif kind == "spans":
            spans.update(r.get("spans", {}))
        elif kind == "counters":
            counters.update(r.get("counters", {}))
        elif kind == "gauges":
            gauges.update(r.get("gauges", {}))
        elif kind == "histogram":
            hists.append(r)
    return meta, steps, spans, counters, gauges, hists


def _mean(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else float("nan")


def _pct(xs: List[float], p: float) -> float:
    if not xs:
        return float("nan")
    s = sorted(xs)
    return s[min(len(s) - 1, int(p * len(s)))]


def attribution(meta: Dict[str, Any], steps: List[Dict[str, Any]]
                ) -> Optional[Dict[str, float]]:
    """Mean-step-time shares: data / compute / collective / other.

    ``data`` is measured (the data_wait span -- time the consumer
    actually stalled on the input pipeline); compute and collective are
    the cost model's analytic roofline terms scaled by the step's
    rollout; ``other`` is whatever the model does not explain
    (dispatch, host overhead, py loop).  Shares are clamped to [0, 1]
    of the mean step time."""
    cm = meta.get("cost_model")
    if not cm or not steps:
        return None
    durs = [s["dur_s"] for s in steps if "dur_s" in s]
    waits = [s.get("data_wait_s", 0.0) for s in steps]
    rolls = [max(int(s.get("rollout", 1)), 1) for s in steps]
    if not durs:
        return None
    mean_dur = _mean(durs)
    mean_roll = _mean([float(r) for r in rolls])
    if not mean_dur or mean_dur <= 0:
        return None
    t_comp = cm.get("t_compute_s", 0.0) * mean_roll
    t_coll = cm.get("t_collective_s", 0.0) * mean_roll
    data = min(_mean(waits) / mean_dur, 1.0)
    compute = min(t_comp / mean_dur, 1.0)
    collective = min(t_coll / mean_dur, 1.0)
    other = max(0.0, 1.0 - data - compute - collective)
    return {"mean_step_s": mean_dur, "data": data, "compute": compute,
            "collective": collective, "other": other}


def verdict(att: Dict[str, float]) -> str:
    shares = {"data": att["data"], "compute": att["compute"],
              "comm": att["collective"], "overhead": att["other"]}
    name = max(shares, key=shares.get)
    return (f"this run was {shares[name] * 100:.0f}% {name}-bound "
            f"(data {att['data'] * 100:.0f}% / "
            f"compute {att['compute'] * 100:.0f}% / "
            f"comm {att['collective'] * 100:.0f}% / "
            f"other {att['other'] * 100:.0f}%)")


def check(meta: Dict[str, Any], steps: List[Dict[str, Any]]) -> List[str]:
    """CI assertions; returns a list of failures (empty = pass)."""
    fails: List[str] = []
    if not meta:
        fails.append("no meta header record")
    if not steps:
        fails.append("no step records")
    for s in steps:
        i = s.get("step", "?")
        for key, lo, hi in (("mfu", 0.0, 1.0),
                            ("comm_fraction", 0.0, 1.0),
                            ("achieved_tflops", 0.0, float("inf")),
                            ("dur_s", 0.0, float("inf"))):
            v = s.get(key)
            if v is None:
                fails.append(f"step {i}: missing {key}")
            elif not math.isfinite(v):
                fails.append(f"step {i}: {key}={v} not finite")
            elif not (lo <= v <= hi):
                fails.append(f"step {i}: {key}={v} outside [{lo}, {hi}]")
    return fails


def render(path: str, out=sys.stdout) -> None:
    meta, steps, spans, counters, gauges, hists = split_records(
        load_records(path))

    w = out.write
    w(f"== trace report: {path} ==\n")
    head = {k: meta[k] for k in ("arch", "mesh_model", "mesh_data",
                                 "scheme", "impl", "kernel", "precision",
                                 "batch", "rollout", "mode")
            if k in meta}
    if head:
        w("run: " + " ".join(f"{k}={v}" for k, v in head.items()) + "\n")

    if steps:
        durs = [s["dur_s"] for s in steps if "dur_s" in s]
        waits = [s.get("data_wait_s", 0.0) for s in steps]
        mfus = [s.get("mfu") for s in steps if s.get("mfu") is not None]
        comms = [s.get("comm_fraction") for s in steps
                 if s.get("comm_fraction") is not None]
        tf = [s.get("achieved_tflops") for s in steps
              if s.get("achieved_tflops") is not None]
        # the port's records: bytes of the step's collectives that
        # crossed host memory (gloo), beside the NVLink model's share
        host = [s["through_host_bytes"] for s in steps
                if "through_host_bytes" in s]
        w(f"\n-- steps ({len(steps)}) --\n")
        w(f"{'metric':<18}{'mean':>12}{'p50':>12}{'p95':>12}\n")
        for name, xs, scale in (("step_s", durs, 1.0),
                                ("data_wait_s", waits, 1.0),
                                ("mfu", mfus, 1.0),
                                ("comm_fraction", comms, 1.0),
                                ("achieved_tflops", tf, 1.0),
                                ("through_host_bytes", host, 1.0)):
            if xs:
                w(f"{name:<18}{_mean(xs) * scale:>12.4g}"
                  f"{_pct(xs, 0.5) * scale:>12.4g}"
                  f"{_pct(xs, 0.95) * scale:>12.4g}\n")

    if spans:
        w(f"\n-- spans --\n")
        w(f"{'name':<24}{'count':>8}{'total_s':>12}{'mean_s':>12}\n")
        for name in sorted(spans, key=lambda n: -spans[n]["total_s"]):
            agg = spans[name]
            w(f"{name:<24}{agg['count']:>8}{agg['total_s']:>12.4g}"
              f"{agg['mean_s']:>12.4g}\n")

    if counters:
        w(f"\n-- counters --\n")
        for name in sorted(counters):
            w(f"{name:<32}{counters[name]:>16,.0f}\n")

    if hists:
        w(f"\n-- histograms --\n")
        w(f"{'name':<32}{'count':>8}{'p50':>12}{'p95':>12}{'p99':>12}\n")
        for h in hists:
            if not h.get("count"):
                continue
            w(f"{h['name']:<32}{h['count']:>8}{h.get('p50', 0):>12.4g}"
              f"{h.get('p95', 0):>12.4g}{h.get('p99', 0):>12.4g}\n")

    att = attribution(meta, steps)
    if att:
        w(f"\n-- roofline attribution --\n")
        w(f"mean step {att['mean_step_s'] * 1e3:.2f} ms = "
          f"data {att['data'] * 100:.1f}% + "
          f"compute {att['compute'] * 100:.1f}% + "
          f"comm {att['collective'] * 100:.1f}% + "
          f"other {att['other'] * 100:.1f}%\n")
        w(verdict(att) + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("jsonl", help="telemetry JSONL (the .jsonl sibling "
                                  "of --trace's Chrome JSON)")
    ap.add_argument("--check", action="store_true",
                    help="CI mode: exit 1 unless every step record has "
                         "finite, in-range mfu / comm_fraction / "
                         "achieved_tflops")
    args = ap.parse_args(argv)
    meta, steps, *_ = split_records(load_records(args.jsonl))
    if args.check:
        fails = check(meta, steps)
        if fails:
            for f in fails:
                print(f"[trace-check] FAIL: {f}")
            return 1
        print(f"[trace-check] OK: {len(steps)} step records, all "
              f"derived metrics finite and in range")
        return 0
    render(args.jsonl)
    return 0


if __name__ == "__main__":
    sys.exit(main())
