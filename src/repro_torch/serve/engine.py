"""Continuous-batching forecast serving engine, on one device or a
data-only mesh.

The port of ``repro/serve/engine.py::ForecastEngine``.  Serving is
data-parallel only: every rank holds the whole model and the whole Jigsaw
contraction is local (``scheme="none"``).  One engine owns:

  * one preallocated f32 state buffer per padded batch bucket.  Forming a
    batch zeroes a bucket's buffer, ``admit`` writes a request's initial
    condition into a row, ``peel`` copies a row back to the host, ``grow``
    copies the live rows into the next bucket's buffer, and a step runs
    ``forecast_step`` on the live buffer and writes the result back in
    place;
  * on CUDA (``ServeConfig(graphs=True)``, the default there), one CUDA
    graph per bucket of ``buffer.copy_(forecast_step(params, buffer))``,
    the counterpart of the reference's per-bucket jitted executables.
    ``warmup()`` runs each bucket's step eagerly once (the kernel's
    attributes set, the allocator primed) and then captures it, the
    largest bucket first; all the graphs share one memory pool (one bucket
    runs at a time, and each graph's only live output is its own buffer).
    A step replays the bucket's graph (``kernels/graphs.py::CountedGraph``:
    the kernels' launch counters count replays).  No graph is captured
    after ``warmup()``; a capture that fails raises.  ``graphs=False`` runs
    every step eagerly (the smoke run's comparison); on the CPU the engine
    is eager;
  * ``stats["compiles"]``, which counts the per-bucket buffer setups, the
    graph captures and the kernel build.  ``warmup()`` performs all of
    them, so steady-state serving adds none;
  * a ``MicrobatchScheduler`` (serve/scheduler.py) that decides, at every
    rollout-step boundary, which queued requests to admit, when to
    coalesce or grow, or, in ``drain`` mode, to wait for the batch to
    empty.

``mesh_data=n > 1`` serves on n ranks of a (data n, model 1) mesh
(``launch/mesh.py::make_host_mesh``; the process group from
``torch.distributed.run``'s environment unless the caller joined one).  A
bucket's rows lie on the data axis where n divides it, else every rank
holds all of them (``launch/specs.py::state_spec``, the reference's
``sanitize_spec`` rule).  Rank 0 alone takes ``submit()`` and runs the
scheduler; at each boundary it broadcasts the tick (form or grow, the
admitted slots; after the step the slots to peel; or stop) over a gloo
group, and the other ranks follow it in ``serve_worker()`` until rank 0's
``close()``.  An admitted request's fields go from rank 0 to the rank that
holds its slot (to every rank where the bucket is whole), a peeled row
from its rank to rank 0, which delivers it, and a grow moves rows whose
rank changes.  These cross host memory as host tensors under gloo;
``core/comm.py``'s ``through_host`` / ``through_host_bytes`` count them
under ``"admit/serve"``, ``"peel/serve"`` and ``"grow/serve"`` (each rank
its sends and receives).  A rank that loses its peers raises from gloo.

The weights come from ``ckpt=`` (the params group of a training
checkpoint of either package and any mesh, in the reference's format:
``checkpoint/serving.py``, read whole on every rank, shapes checked and
dtypes cast to the serving policy; ``restored_step`` is its step), else
``params=`` (whole, in the port's layout, on every rank), else a fresh
init from ``config.seed`` (the same on every rank).

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
import torch.distributed as dist

from repro_torch import telemetry
from repro_torch.configs.registry import get_config
from repro_torch.core import comm, precision
from repro_torch.core.sharding import DATA_AXIS
from repro_torch.kernels import block_matmul as BM
from repro_torch.kernels.graphs import CountedGraph
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.launch.specs import state_spec
from repro_torch.models import registry as M
from repro_torch.serve.scheduler import (ForecastResult, Lead,
                                         MicrobatchScheduler)

_STOP, _STEP = 0, 1                 # the tick's op (rank 0 -> the others)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving policy knobs (the engine ctor takes the device and mesh)."""
    buckets: Tuple[int, ...] = (1, 2, 4, 8)
    mode: str = "continuous"          # | "drain" (static-batching baseline)
    coalesce_s: float = 0.0           # idle burst-coalescing window
    precision: Optional[str] = None   # serving policy preset
    seed: int = 0
    telemetry: bool = True            # span tracing (histograms stay live)
    trace: Optional[str] = None       # Chrome trace export path
    graphs: bool = True               # CUDA graphs per bucket (CUDA only)

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
    """Batched autoregressive forecast serving on one device or a
    data-only mesh of ranks."""

    def __init__(self, arch: str, *, reduced: bool = True, params=None,
                 ckpt: Optional[str] = None, mesh_data: int = 1,
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

        # -- the serving mesh: data-only, every rank the whole model ---------
        self.mesh = None
        self.rank, self.n_data = 0, int(mesh_data)
        self._group = None
        if self.n_data > 1:
            from repro_torch.launch.mesh import make_host_mesh
            self.mesh = make_host_mesh(model=1, data=self.n_data,
                                       device=self.device)
            self.rank = self.mesh.rank
            if self.device.type == "cuda":
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            # the ticks and rows go between host tensors: a gloo group
            self._group = (dist.group.WORLD if dist.get_backend() == "gloo"
                           else dist.new_group(backend="gloo"))
        self.graphs = config.graphs and self.device.type == "cuda"

        self.stats = {"compiles": 0, "device_steps": 0, "wait_ticks": 0,
                      "warmup_s": 0.0, "graph_pool_bytes": 0}
        # engine-local tracer: admission-to-delivery histograms (one per
        # lead time) + serve spans
        self.tracer = telemetry.Tracer(enabled=config.telemetry)
        self.tracer.set_meta(surface="serve", arch=arch, reduced=reduced,
                             device=str(self.device), mode=config.mode,
                             mesh_data=self.n_data, graphs=self.graphs,
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

        self._buffers = {}          # bucket -> this rank's f32 rows of it
        self._graphs = {}           # bucket -> CountedGraph of its step
        self._pool = None           # the graphs' shared memory pool
        self._warm = False
        self._state: Optional[torch.Tensor] = None
        self._bucket = 0
        self._closed = False
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- placement of a bucket's rows ----------------------------------------
    def _split(self, b: int) -> bool:
        """Whether bucket ``b``'s rows are cut over the data axis."""
        return self.mesh is not None and \
            state_spec(b, self.mesh)[0] == DATA_AXIS

    def _rows(self, b: int) -> int:
        """This rank's rows of bucket ``b``."""
        return b // self.n_data if self._split(b) else b

    def _holders(self, b: int, slot: int) -> Tuple[int, ...]:
        """The ranks that hold row ``slot`` of bucket ``b``."""
        if not self._split(b):
            return tuple(range(self.n_data))
        return (slot // self._rows(b),)

    def _local(self, b: int, slot: int) -> int:
        """Row ``slot`` of bucket ``b`` in its holder's buffer."""
        return slot % self._rows(b) if self._split(b) else slot

    # -- per-bucket setup ----------------------------------------------------
    def _buffer(self, b: int) -> torch.Tensor:
        if b not in self._buffers:
            if self._warm and self.graphs:
                raise RuntimeError(f"ForecastEngine: bucket {b} was not "
                                   "warmed up; its graph would be captured "
                                   "while serving")
            self.stats["compiles"] += 1
            self._buffers[b] = torch.zeros(
                (self._rows(b), *self.field_shape), dtype=torch.float32,
                device=self.device)
        return self._buffers[b]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _capture(self, b: int) -> None:
        """Capture bucket ``b``'s step on its buffer (one eager step on
        it has run: the kernel's attributes are set, the pool primed)."""
        state = self._buffers[b]
        if self._pool is None and self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        graph = CountedGraph()
        graph.capture(lambda: state.copy_(self._forecast(state)),
                      pool=self._pool)
        self._graphs[b] = graph
        self.stats["compiles"] += 1

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> int:
        """Set up every bucket's buffer, build the kernel, run one step at
        each bucket and (graphs on) capture it, so steady-state serving
        sets nothing up.  Local to each rank.  Returns the setup count,
        also stamped into ``stats["warm_compiles"]``."""
        t0 = time.perf_counter()
        if self.device.type == "cuda" and self.jcfg.kernel == "pallas":
            self.stats["compiles"] += int(BM.build())
        buckets = tuple(sorted(buckets or self.config.buckets))
        for b in buckets:
            state = self._buffer(b)
            state.copy_(self._forecast(state))
            state.zero_()
        if self.graphs:
            cuda = self.device.type == "cuda"
            self._sync()
            if cuda:            # what the graphs' pool keeps, captured
                torch.cuda.empty_cache()
                before = torch.cuda.memory_reserved(self.device)
            # largest first: the smaller buckets' intermediates are then
            # carved from the blocks the largest one's capture left free
            for b in reversed(buckets):
                if b not in self._graphs:
                    self._capture(b)
            self._sync()
            if cuda:
                self.stats["graph_pool_bytes"] = \
                    torch.cuda.memory_reserved(self.device) - before
        self._sync()
        self._warm = True
        self.stats["warmup_s"] += time.perf_counter() - t0
        self.stats["warm_compiles"] = self.stats["compiles"]
        return self.stats["compiles"]

    # -- device operations ---------------------------------------------------
    def _forecast(self, state: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return M.forecast_step(self.params, state, self.cfg, self.jcfg)

    def _step(self) -> None:
        """One rollout step of the live bucket, in place: its graph's
        replay, or the eager step (graphs off, or the CPU).  Before
        ``warmup()`` a bucket's first step runs eagerly and its graph is
        captured after it (the reference's jit traces at first use)."""
        graph = self._graphs.get(self._bucket)
        if graph is not None:
            graph.replay()
            return
        self._state.copy_(self._forecast(self._state))
        if self.graphs:
            if self._warm:
                raise RuntimeError(f"ForecastEngine: bucket {self._bucket} "
                                   "has no graph after warmup()")
            self._sync()
            self._capture(self._bucket)

    def _form(self, b: int) -> None:
        self._state = self._buffer(b)
        self._state.zero_()
        self._bucket = b

    def _grow(self, b_to: int) -> None:
        """The live rows into bucket ``b_to``'s buffer: rows that stay on
        a rank are copied there, the others sent from a rank that held
        them to each rank that holds them now."""
        b_from, old = self._bucket, self._state
        new = self._buffer(b_to)
        new.zero_()
        me = self.rank
        for slot in range(b_from):
            src = self._holders(b_from, slot)
            for dst in self._holders(b_to, slot):
                if dst == me and me in src:
                    new[self._local(b_to, slot)].copy_(
                        old[self._local(b_from, slot)])
                elif dst == me:
                    new[self._local(b_to, slot)].copy_(
                        self._recv_row(min(src), "grow"))
                elif dst not in src and me == min(src):
                    self._send_row(old[self._local(b_from, slot)], dst,
                                   "grow")
        self._state, self._bucket = new, b_to

    def _admit(self, slot: int, fields: Optional[np.ndarray]) -> None:
        """Row ``slot``'s initial condition: written where this rank holds
        it; rank 0 (``fields``) sends it to the ranks that hold it."""
        b = self._bucket
        holders = self._holders(b, slot)
        if self.mesh is None:
            row = torch.from_numpy(fields)
        elif len(holders) > 1:                     # the bucket is whole
            row = torch.from_numpy(fields) if self.rank == 0 \
                else torch.empty(self.field_shape, dtype=torch.float32)
            dist.broadcast(row, src=0, group=self._group)
            self._count("admit", row)
        elif holders[0] == self.rank == 0:
            row = torch.from_numpy(fields)
        elif self.rank == 0:
            self._send_row(torch.from_numpy(fields), holders[0], "admit")
            return
        elif holders[0] == self.rank:
            row = self._recv_row(0, "admit")
        else:
            return
        self._state[self._local(b, slot)].copy_(row)

    def _peel(self, slot: int) -> Optional[np.ndarray]:
        """Row ``slot`` on the host of rank 0 (its holder sends it there);
        None on the other ranks."""
        holders = self._holders(self._bucket, slot)
        if 0 in holders:
            if self.rank != 0:
                return None
            # a copy even on the CPU, where .cpu() would alias the buffer
            return self._state[self._local(self._bucket, slot)].to(
                "cpu", copy=True).numpy()
        if self.rank == 0:
            return self._recv_row(holders[0], "peel").numpy()
        if self.rank == holders[0]:
            self._send_row(self._state[self._local(self._bucket, slot)], 0,
                           "peel")
        return None

    # -- rank to rank --------------------------------------------------------
    def _count(self, what: str, row: torch.Tensor) -> None:
        key = f"{what}/serve"
        comm.through_host[key] += 1
        comm.through_host_bytes[key] += row.numel() * row.element_size()

    def _send_row(self, row: torch.Tensor, dst: int, what: str) -> None:
        host = row.to("cpu", copy=True)
        dist.send(host, dst=dst, group=self._group)
        self._count(what, host)

    def _recv_row(self, src: int, what: str) -> torch.Tensor:
        host = torch.empty(self.field_shape, dtype=torch.float32)
        dist.recv(host, src=src, group=self._group)
        self._count(what, host)
        return host

    def _tick_msg(self, values: Sequence[int]) -> list:
        """Rank 0's ``values`` on every rank (the others pass ``()``).
        One fixed-length int64 message: the count, then the values."""
        msg = torch.zeros(4 + self.sched.max_bucket, dtype=torch.int64)
        if self.rank == 0:
            msg[0] = len(values)
            msg[1:1 + len(values)] = torch.tensor(values, dtype=torch.int64)
        dist.broadcast(msg, src=0, group=self._group)
        return msg[1:1 + int(msg[0])].tolist()

    # -- request path --------------------------------------------------------
    def submit(self, fields, lead: Lead = 1) -> ForecastResult:
        """Enqueue one forecast request (thread-safe; rank 0 only).

        fields: [lat, lon, C] initial condition.  lead: rollout steps
        ahead -- an int, or a sequence of horizons that share the rollout
        and peel off at their own step (lead-time fan-out)."""
        if self.rank != 0:
            raise RuntimeError(f"ForecastEngine.submit on rank {self.rank}: "
                               "rank 0 takes the requests; the other ranks "
                               "run serve_worker()")
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

    def _boundary(self, form: int, grow: int, admit) -> None:
        """One boundary's device work on every rank: form or grow, the
        admits (``admit``: [(slot, fields or None)]), the step."""
        tr = self.tracer
        if form:
            with tr.span("serve.form", bucket=form):
                self._form(form)
        elif grow:
            with tr.span("serve.grow", b_from=self._bucket, b_to=grow):
                self._grow(grow)
        if admit:
            with tr.span("serve.admit", n=len(admit), bucket=self._bucket):
                for slot, fields in admit:
                    self._admit(slot, fields)
        with tr.span("serve.step", bucket=self._bucket):
            self._step()
            self._sync()
        self.stats["device_steps"] += 1
        tr.counter("serve.device_steps")

    def step_once(self) -> str:
        """Advance one rollout-step boundary (rank 0).

        Returns "idle" (nothing to do), "wait" (coalescing window still
        open) or "step" (one device rollout step ran)."""
        if self.rank != 0:
            raise RuntimeError("ForecastEngine.step_once runs on rank 0; "
                               "the other ranks run serve_worker()")
        tick = self.sched.tick()
        if tick.idle:
            return "idle"
        if tick.wait is not None:
            self.stats["wait_ticks"] += 1
            return "wait"
        form, grow = tick.form or 0, tick.grow or 0
        if self.mesh is not None:
            self._tick_msg([_STEP, form, grow]
                           + [slot for slot, _ in tick.admit])
        self._boundary(form, grow,
                       [(slot, req.fields) for slot, req in tick.admit])
        peels, _finished = self.sched.advance()
        if self.mesh is not None:
            self._tick_msg([slot for slot, _, _ in peels])
        now = self._clock()
        tr = self.tracer
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

    def serve_worker(self) -> int:
        """The loop of a rank other than 0: follow rank 0's ticks until
        its ``close()``.  Returns the device steps this rank ran."""
        if self.rank == 0:
            raise RuntimeError("serve_worker runs on ranks other than 0")
        while True:
            msg = self._tick_msg(())
            if msg[0] == _STOP:
                self._closed = True
                return self.stats["device_steps"]
            form, grow = msg[1], msg[2]
            self._boundary(form, grow, [(slot, None) for slot in msg[3:]])
            for slot in self._tick_msg(()):
                self._peel(slot)

    def close(self) -> None:
        """Stop the background thread; on rank 0 of a mesh, release the
        other ranks from ``serve_worker()`` (collective with them)."""
        self.stop()
        if self.mesh is not None and self.rank == 0 and not self._closed:
            self._tick_msg([_STOP])
            self._closed = True

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
