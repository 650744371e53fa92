"""Analytic FLOP / wire-byte accounting behind every step record (the port
of ``repro/telemetry/accounting.py``).

A step record's ``mfu``, ``achieved_tflops`` and ``comm_fraction`` are
derived: a measured wall-clock step time divided into an analytic cost
model, built once per (ModelConfig, Jigsaw scheme, mesh shape):

  ``mfu``               achieved FLOP/s per device / the card's peak for
                        the dtype the step's GEMMs run in,
  ``achieved_tflops``   achieved TFLOP/s per device,
  ``comm_fraction``     modeled collective seconds at the NVLink rate /
                        measured step seconds.

The FLOPs are ``launch/analysis.py``'s exact matmul-dims model, the wire
bytes ``core/jigsaw.py``'s volumes and ring schedule, the formulas the
reference's.  The constants are the H100's (``launch/analysis.py``:
datasheet figures of the SXM5 80 GB at 700 W): bf16 989.4 TFLOP/s, f32
66.9 (the f32 loop runs on the FMA units), NVLink 450 GB/s each way.

What the model does not see: ranks that share one card run under gloo,
which moves every collective on CUDA tensors through host memory
(``core/comm.py``), far slower than NVLink.  ``comm_fraction`` stays the
NVLink model; the engine's step record carries the measured
``through_host_bytes`` of the step beside it, and
``measured_comm_bytes`` (the counterpart of the reference's
``hlo_collective_bytes``, which parsed XLA's HLO) reads the same counters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.core import comm
from repro_torch.core import precision
from repro_torch.core.jigsaw import (comm_schedule_jigsaw_1d,
                                     comm_volume_jigsaw_1d,
                                     comm_volume_jigsaw_2d)
from repro_torch.launch import analysis as A

# fig7's I/O model constants (paper §5: one 0.25-deg f32 sample over a
# shared Lustre-like host stream)
DISK_BW = 2e9
SAMPLE_BYTES = 4 * 721 * 1440 * 69


def _wire_dtype_bytes(cfg) -> int:
    """Bytes per element on the Jigsaw wire: the policy's compute dtype
    (what the ring ships), param dtype otherwise."""
    pol = precision.policy_of(cfg)
    if pol.name != "legacy":
        return pol.compute_dtype.itemsize
    return precision.dtype_of(getattr(cfg, "param_dtype", None)
                              or "float32").itemsize


def gemm_peak(cfg) -> float:
    """The card's peak FLOP/s for the dtype the step's GEMMs run in: the
    policy's compute dtype.  Under the legacy policy (no casts) a GEMM runs
    in its activations' dtype: f32 for the mixer (its f32 fields make
    every launch an f32 one), the stored weights' for a language model
    (its residual stream is the embedding table's)."""
    pol = precision.policy_of(cfg)
    if pol.name != "legacy":
        dt = pol.compute_dtype
    elif cfg.family == "mixer":
        dt = torch.float32
    else:
        dt = precision.dtype_of(cfg.param_dtype)
    return A.peak_flops(precision.name_of(dt))


def _tokens_per_sample(cfg) -> int:
    if cfg.family == "mixer":
        return (cfg.wm_lat // cfg.wm_patch) * (cfg.wm_lon // cfg.wm_patch)
    return 0


@dataclasses.dataclass(frozen=True)
class StepCostModel:
    """Analytic per-step costs for one (config, scheme, mesh) triple.

    ``flops_per_step`` / ``comm_bytes_per_device`` are for ONE rollout
    step (rollout=1); ``metrics`` scales both by the step's actual
    rollout length."""
    arch: str
    scheme: str
    impl: str
    n_model: int
    n_data: int
    batch: int
    flops_per_step: float          # global fwd+bwd(+remat) FLOPs
    comm_bytes_per_device: float   # jigsaw collective bytes, per device
    hops: int                      # ring hops per jigsaw'd linear fwd
    bytes_per_hop: float           # wire bytes per hop per device
    wire_dtype_bytes: int
    approx_comm: bool              # True = non-mixer fallback estimate
    peak_flops: float = A.PEAK_FLOPS_BF16
    link_bw: float = A.NVLINK_BW

    @property
    def n_devices(self) -> int:
        return max(self.n_model * self.n_data, 1)

    @property
    def t_compute_s(self) -> float:
        """Compute roofline term: per-device FLOPs at peak."""
        return self.flops_per_step / self.n_devices / self.peak_flops

    @property
    def t_collective_s(self) -> float:
        """Collective roofline term: per-device wire bytes at the link's
        rate."""
        return self.comm_bytes_per_device / self.link_bw

    def metrics(self, step_time_s: float,
                rollout: int = 1) -> Dict[str, float]:
        """The derived fields of one step record, from a measured wall
        duration.  All finite for any step_time_s > 0."""
        if step_time_s <= 0:
            return {"mfu": 0.0, "achieved_tflops": 0.0,
                    "comm_fraction": 0.0}
        r = max(int(rollout), 1)
        achieved = (r * self.flops_per_step / self.n_devices
                    / step_time_s)
        return {
            "mfu": achieved / self.peak_flops,
            "achieved_tflops": achieved / 1e12,
            "comm_fraction": min(1.0, r * self.t_collective_s
                                 / step_time_s),
        }

    def as_meta(self) -> Dict[str, Any]:
        """JSON-serializable constants for the trace JSONL header --
        enough for ``trace_report`` to recompute every derived field."""
        d = dataclasses.asdict(self)
        d["t_compute_s"] = self.t_compute_s
        d["t_collective_s"] = self.t_collective_s
        d["n_devices"] = self.n_devices
        return d


def build_cost_model(cfg, *, n_model: int = 1, n_data: int = 1,
                     batch: int = 1, seq_len: int = 128,
                     peak: Optional[float] = None,
                     link: float = A.NVLINK_BW) -> StepCostModel:
    """Cost model for one training step of ``cfg`` on an
    (n_model x n_data) mesh with global batch ``batch``.

    FLOPs: ``launch/analysis.flops_step(kind="train")`` (fwd + bwd, remat
    re-forward when configured) -- exact matmul dims.  ``peak`` defaults
    to ``gemm_peak(cfg)``.

    Wire bytes: the Jigsaw collective volume of every sharded linear.
    For the mixer family this is the paper's Fig. 7 model -- fwd+bwd
    (3x) of 2 ring reduce-scatters of ``[tokens, d_ch]`` per layer under
    scheme="1d" (``comm_volume_jigsaw_1d``), Cannon block rotates under
    scheme="2d" (``comm_volume_jigsaw_2d``) -- at the policy's wire
    dtype.  Non-mixer families get a d_model-proportional estimate
    (flagged ``approx_comm``)."""
    n_model = max(int(n_model), 1)
    n_data = max(int(n_data), 1)
    flops = A.flops_step(cfg, "train", batch, seq_len)
    wire = _wire_dtype_bytes(cfg)
    scheme = cfg.scheme if n_model > 1 else "none"
    impl = getattr(cfg, "impl", "ring") or "ring"

    comm_bytes = 0.0
    hops, hop_bytes, approx = 0, 0.0, False
    if scheme != "none" and n_model > 1:
        if cfg.family == "mixer":
            tokens = batch * _tokens_per_sample(cfg)
            m = cfg.wm_d_ch
        else:
            tokens = batch * seq_len
            m = cfg.d_model
            approx = True
        q = int(math.isqrt(n_model))
        if scheme == "2d" and q * q == n_model and q > 1:
            vol = comm_volume_jigsaw_2d(tokens, m, q, dtype_bytes=wire)
            comm_bytes = 3.0 * vol.bytes_per_device * 2 * cfg.n_layers
            hops = 2 * (q - 1)
            hop_bytes = vol.bytes_per_device / hops
        else:
            p = n_model
            sched = comm_schedule_jigsaw_1d(
                tokens, m, cfg.d_model // p or 1, p,
                dtype_bytes=wire,
                impl=impl if impl in ("ring", "ring_chunked",
                                      "ring_fused") else "ring")
            comm_bytes = 3.0 * (comm_volume_jigsaw_1d(tokens, m, p,
                                                      dtype_bytes=wire)
                                .bytes_per_device * 2 * cfg.n_layers)
            hops, hop_bytes = sched.hops, sched.bytes_per_hop
    return StepCostModel(
        arch=cfg.arch_id, scheme=scheme, impl=impl,
        n_model=n_model, n_data=n_data, batch=batch,
        flops_per_step=float(flops), comm_bytes_per_device=float(comm_bytes),
        hops=hops, bytes_per_hop=float(hop_bytes),
        wire_dtype_bytes=wire, approx_comm=approx,
        peak_flops=gemm_peak(cfg) if peak is None else peak, link_bw=link)


# ---------------------------------------------------------------------------
# fig7's row, and the measured side of the wire bytes
# ---------------------------------------------------------------------------

def fig7_point(cfg, way: int, impl: Optional[str] = None, *,
               peak: float = A.PEAK_FLOPS_BF16,
               link: float = A.NVLINK_BW) -> Dict[str, float]:
    """One row of the paper's Fig. 7 roofline, by the reference's
    formulas (its ``fig7_point``), at the card's bf16 peak and NVLink
    rate unless ``peak`` and ``link`` say otherwise.

    Returns t_step_s / tflops_per_dev / peak_frac / regime for a mixer
    config at jigsaw width ``way`` (1, 2 = 1-D ring, 4 = 2-D Cannon);
    ``impl`` in ("ring_chunked", "ring_fused") applies the overlap
    schedule ``t_comp/p + max(t_comp (p-1)/p, t_coll)``."""
    flops = 3 * sum(A.flops_forward(cfg, 1, 0).values())
    t_tokens = _tokens_per_sample(cfg)
    t_io = SAMPLE_BYTES / (way * DISK_BW)
    t_comp = flops / (way * peak)
    if way == 1:
        t_coll, p_ring = 0.0, 1
    elif way == 2:
        v = 3 * (comm_volume_jigsaw_1d(t_tokens, cfg.wm_d_ch, way)
                 .bytes_per_device * 2 * cfg.n_layers)
        t_coll, p_ring = v / link, way
    else:
        v = 3 * (comm_volume_jigsaw_2d(t_tokens, cfg.wm_d_ch, 2)
                 .bytes_per_device * 2 * cfg.n_layers)
        t_coll, p_ring = v / link, 2
    if impl in ("ring_chunked", "ring_fused") and p_ring > 1:
        t_cc = t_comp / p_ring + max(t_comp * (p_ring - 1) / p_ring,
                                     t_coll)
    else:
        t_cc = t_comp + t_coll
    t_step = max(t_io, t_cc)
    achieved = flops / t_step / way
    return {"t_step_s": t_step, "t_io_s": t_io, "t_comp_s": t_comp,
            "t_coll_s": t_coll,
            "tflops_per_dev": achieved / 1e12,
            "peak_frac": achieved / peak,
            "regime": "io" if t_io > t_cc else "compute-comm"}


def measured_comm_bytes() -> float:
    """This process's bytes of collectives that crossed host memory so far
    (``comm.through_host_bytes``, every key summed): the measured side of
    the wire-byte cross-check, in place of the reference's HLO parse.
    Take the difference of two reads around a step."""
    return float(sum(comm.through_host_bytes.values()))
