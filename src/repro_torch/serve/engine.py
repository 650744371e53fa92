"""Continuous-batching forecast serving engine on one device.

The port of ``repro/serve/engine.py::ForecastEngine`` for one device (the
reference's ``mesh_data=1``; the whole contraction is local,
``scheme="none"``; data-parallel serving is ROADMAP.md queue 1 item 11).  One
engine owns:

  * one preallocated f32 state buffer per padded batch bucket.  Forming a
    batch zeroes a bucket's buffer, ``admit`` writes a request's initial
    condition into a row, ``peel`` copies a row back to the host, ``grow``
    copies the live rows into the next bucket's buffer, and ``step`` runs
    ``forecast_step`` on the live buffer and writes the result back in
    place;
  * ``stats["compiles"]``, which counts the per-bucket buffer setups and
    the kernel build.  ``warmup()`` performs all of them (and one step per
    bucket), so steady-state serving adds none;
  * a ``MicrobatchScheduler`` (serve/scheduler.py) that decides, at every
    rollout-step boundary, which queued requests to admit, when to
    coalesce or grow, or, in ``drain`` mode, to wait for the batch to
    empty.

The weights come from ``ckpt=`` (the params group of a training
checkpoint of either package and any mesh, in the reference's format:
``checkpoint/serving.py``, shapes checked and dtypes cast to the serving
policy; ``restored_step`` is its step), else ``params=`` (whole, in the
port's layout), else a fresh init from ``config.seed``.

Requests are ``submit()``-ed (thread-safe) and return future-style
``ForecastResult`` handles; ``drain()`` (or the ``start()`` background
thread) advances boundaries until the queue empties.  The engine runs on
``device="cuda"`` unless the caller asks for ``device="cpu"``; it raises
when CUDA is asked for and absent.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.configs.registry import get_config
from repro_torch.core import precision
from repro_torch.kernels import block_matmul as BM
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import registry as M
from repro_torch.serve.scheduler import (ForecastResult, Lead,
                                         MicrobatchScheduler)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving policy knobs (the engine ctor takes the device)."""
    buckets: Tuple[int, ...] = (1, 2, 4, 8)
    mode: str = "continuous"          # | "drain" (static-batching baseline)
    coalesce_s: float = 0.0           # idle burst-coalescing window
    precision: Optional[str] = None   # serving policy preset
    seed: int = 0
    telemetry: bool = True            # span tracing (histograms stay live)
    trace: Optional[str] = None       # Chrome trace export path

    def replace(self, **kw) -> "ServeConfig":
        return dataclasses.replace(self, **kw)


def _cast_params(params, param_dtype: torch.dtype, device):
    """Linear weights and biases ("w", "b") to the serving param dtype;
    norms and the blend stay f32, as ``init`` makes them."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        dtype = param_dtype if key in ("w", "b") else torch.float32
        return node.to(device=device, dtype=dtype)
    return walk(params)


def _param_shapes(cfg):
    """The model's params under ``cfg`` as fake tensors: shapes and
    dtypes, no memory (the reference's ``jax.eval_shape`` of init)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return M.init(cfg, seed=0, device="cpu")


class ForecastEngine:
    """Batched autoregressive forecast serving on one device."""

    def __init__(self, arch: str, *, reduced: bool = True, params=None,
                 ckpt: Optional[str] = None,
                 config: ServeConfig = ServeConfig(),
                 config_override=None, clock=time.monotonic,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ForecastEngine: CUDA is not available; pass "
                               "device='cpu' to serve on the CPU")
        self.arch = arch
        self.config = config
        cfg = config_override if config_override is not None \
            else get_config(arch)
        if reduced:
            cfg = cfg.reduced()
        # serving is data-parallel only: the whole contraction is local
        cfg = cfg.replace(scheme="none", impl="rs")
        if config.precision:
            cfg = precision.apply_policy(cfg, config.precision)
        self.policy = precision.policy_of(cfg)
        if cfg.family != "mixer":
            raise ValueError(
                f"ForecastEngine drives the autoregressive field rollout; "
                f"{arch} is family {cfg.family!r}")
        self.cfg = cfg
        self.jcfg = jigsaw_for(cfg)
        self.field_shape = (cfg.wm_lat, cfg.wm_lon, cfg.wm_channels)

        self.stats = {"compiles": 0, "device_steps": 0, "wait_ticks": 0,
                      "warmup_s": 0.0}
        # engine-local tracer: admission-to-delivery histograms (one per
        # lead time) + serve spans
        self.tracer = telemetry.Tracer(enabled=config.telemetry)
        self.tracer.set_meta(surface="serve", arch=arch, reduced=reduced,
                             device=str(self.device), mode=config.mode,
                             buckets=list(config.buckets))
        self.sched = MicrobatchScheduler(
            config.buckets, mode=config.mode,
            coalesce_s=config.coalesce_s, clock=clock)
        self._clock = clock
        self._sleep = time.sleep

        # -- params: restore > passed-in > fresh init -----------------------
        self.restored_step = None
        if ckpt is not None:
            from repro_torch.checkpoint.serving import restore_serving_params
            params, man = restore_serving_params(
                ckpt, arch=arch, like=_param_shapes(cfg),
                device=self.device)
            self.restored_step = man.step
        elif params is None:
            params = M.init(cfg, seed=config.seed, device=self.device)
        else:
            params = _cast_params(params, self.policy.param_dtype,
                                  self.device)
        self.params = params

        self._buffers = {}          # bucket -> f32 state [b, lat, lon, C]
        self._state: Optional[torch.Tensor] = None
        self._bucket = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- per-bucket setup ----------------------------------------------------
    def _buffer(self, b: int) -> torch.Tensor:
        if b not in self._buffers:
            self.stats["compiles"] += 1
            self._buffers[b] = torch.zeros((b, *self.field_shape),
                                           dtype=torch.float32,
                                           device=self.device)
        return self._buffers[b]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> int:
        """Set up every bucket's buffer, build the kernel, and run one
        step at each bucket, so steady-state serving sets nothing up.
        Returns the setup count, also stamped into
        ``stats["warm_compiles"]``."""
        t0 = time.perf_counter()
        if self.device.type == "cuda" and self.jcfg.kernel == "pallas":
            self.stats["compiles"] += int(BM.build())
        for b in tuple(sorted(buckets or self.config.buckets)):
            state = self._buffer(b)
            state.copy_(self._forecast(state))
            state.zero_()
        self._sync()
        self.stats["warmup_s"] += time.perf_counter() - t0
        self.stats["warm_compiles"] = self.stats["compiles"]
        return self.stats["compiles"]

    # -- device operations ---------------------------------------------------
    def _forecast(self, state: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return M.forecast_step(self.params, state, self.cfg, self.jcfg)

    def _form(self, b: int) -> None:
        self._state = self._buffer(b)
        self._state.zero_()
        self._bucket = b

    def _grow(self, b_to: int) -> None:
        new = self._buffer(b_to)
        new[:self._bucket].copy_(self._state)
        new[self._bucket:].zero_()
        self._state, self._bucket = new, b_to

    def _admit(self, slot: int, fields: np.ndarray) -> None:
        self._state[slot].copy_(torch.from_numpy(fields))

    def _peel(self, slot: int) -> np.ndarray:
        # a copy even on the CPU, where .cpu() would alias the live buffer
        return self._state[slot].to("cpu", copy=True).numpy()

    # -- request path --------------------------------------------------------
    def submit(self, fields, lead: Lead = 1) -> ForecastResult:
        """Enqueue one forecast request (thread-safe).

        fields: [lat, lon, C] initial condition.  lead: rollout steps
        ahead -- an int, or a sequence of horizons that share the rollout
        and peel off at their own step (lead-time fan-out)."""
        leads = (int(lead),) if np.isscalar(lead) else \
            tuple(sorted(set(int(x) for x in lead)))
        if not leads or leads[0] < 1:
            raise ValueError(f"leads must be >= 1, got {leads}")
        fields = np.asarray(fields, np.float32)
        if fields.shape != self.field_shape:
            raise ValueError(f"fields shape {fields.shape} != "
                             f"{self.field_shape}")
        req = ForecastResult(fields, leads, submit_t=self._clock())
        self.sched.submit(req)
        self._wake.set()
        return req

    def step_once(self) -> str:
        """Advance one rollout-step boundary.

        Returns "idle" (nothing to do), "wait" (coalescing window still
        open) or "step" (one device rollout step ran)."""
        tick = self.sched.tick()
        if tick.idle:
            return "idle"
        if tick.wait is not None:
            self.stats["wait_ticks"] += 1
            return "wait"
        tr = self.tracer
        if tick.form is not None:
            with tr.span("serve.form", bucket=tick.form):
                self._form(tick.form)
        elif tick.grow is not None:
            with tr.span("serve.grow", b_from=self._bucket, b_to=tick.grow):
                self._grow(tick.grow)
        if tick.admit:
            with tr.span("serve.admit", n=len(tick.admit),
                         bucket=self._bucket):
                for slot, req in tick.admit:
                    self._admit(slot, req.fields)
        with tr.span("serve.step", bucket=self._bucket):
            self._state.copy_(self._forecast(self._state))
            self._sync()
        self.stats["device_steps"] += 1
        tr.counter("serve.device_steps")
        peels, _finished = self.sched.advance()
        now = self._clock()
        for slot, req, lead in peels:
            with tr.span("serve.peel", lead=lead):
                out = self._peel(slot)
            req.deliver(lead, out, now)
            # admission-to-delivery latency histograms: the engine's
            # serving SLO, one track per lead time plus the overall one
            lat = now - req.submit_t
            tr.observe("serve.latency_s", lat)
            tr.observe(f"serve.latency_s/lead={lead}", lat)
        return "step"

    def drain(self, poll_s: float = 1e-3) -> None:
        """Run boundaries until queue and batch are empty."""
        while True:
            r = self.step_once()
            if r == "idle":
                return
            if r == "wait":
                self._sleep(poll_s)

    def serve(self, fields_batch, leads: Sequence[Lead]):
        """Convenience: submit a batch of requests and drain."""
        out = [self.submit(f, ld) for f, ld in zip(fields_batch, leads)]
        self.drain()
        return out

    # -- background serving loop (for live submitters, e.g. the CLI) --------
    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("engine already started")
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                r = self.step_once()
                if r == "idle":
                    self._wake.wait(0.005)
                    self._wake.clear()
                elif r == "wait":
                    self._sleep(1e-3)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="forecast-serve")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._wake.set()
        self._thread.join()
        self._thread = None

    # -- reporting -----------------------------------------------------------
    def summary(self, results: Sequence[ForecastResult]) -> dict:
        """Serving report over everything this engine delivered; the
        percentiles come from the engine's telemetry histograms."""
        h = self.tracer.hist_summary("serve.latency_s")
        nan = float("nan")
        sc = self.sched.counters
        leads = {}
        for name in self.tracer.hist_names():
            if name.startswith("serve.latency_s/lead="):
                lead = int(name.split("=", 1)[1])
                leads[lead] = self.tracer.hist_summary(name)
        return {"requests": len(results),
                "p50_s": h.get("p50", nan), "p95_s": h.get("p95", nan),
                "p99_s": h.get("p99", nan),
                "deliveries": h.get("count", 0),
                "lead_latency_s": leads,
                "device_steps": self.stats["device_steps"],
                "compiles": self.stats["compiles"],
                "admitted": sc["admitted"], "completed": sc["completed"],
                "formed": sc["formed"], "grown": sc["grown"]}

    def export_trace(self, path: Optional[str] = None) -> Optional[str]:
        """Write this engine's Chrome trace (+ sibling JSONL) to
        ``path`` or ``config.trace``; returns the path (None = no-op)."""
        path = path or self.config.trace
        if not path:
            return None
        self.tracer.export_chrome(path)
        self.tracer.export_jsonl(telemetry.jsonl_path_for(path))
        return path
