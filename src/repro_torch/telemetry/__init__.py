"""Telemetry of the port: structured spans, counters, gauges and
histograms (``spans.py``, a copy of the reference's), and the analytic
cost model that turns a step's wall time into ``mfu``,
``achieved_tflops`` and ``comm_fraction`` at the H100's peaks
(``accounting.py``)."""
from repro_torch.telemetry.accounting import (StepCostModel,
                                              build_cost_model, fig7_point,
                                              gemm_peak,
                                              measured_comm_bytes)
from repro_torch.telemetry.spans import (Span, Tracer, get_tracer,
                                         jsonl_path_for, set_tracer)

__all__ = ["Span", "StepCostModel", "Tracer", "build_cost_model",
           "fig7_point", "gemm_peak", "get_tracer", "jsonl_path_for",
           "measured_comm_bytes", "set_tracer"]
