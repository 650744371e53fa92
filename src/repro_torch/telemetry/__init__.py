"""Telemetry of the port: structured spans, counters, gauges and
histograms (``spans.py``, a copy of the reference's).  The MFU / comm
accounting of ``repro/telemetry/accounting.py`` is ported with ROADMAP.md
queue 1 item 12."""
from repro_torch.telemetry.spans import (Span, Tracer, get_tracer,
                                         jsonl_path_for, set_tracer)

__all__ = ["Span", "Tracer", "get_tracer", "jsonl_path_for", "set_tracer"]
