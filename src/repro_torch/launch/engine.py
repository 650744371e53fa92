"""TrainEngine: the training loop of the port (``repro/launch/engine.py``),
on one device or on a 1-D or 2-D Jigsaw mesh.

The engine owns

  * the config, the precision policy and the ``JigsawConfig``: on one
    device ``scheme="none"`` (the whole contraction is local, as the
    reference forces whenever ``mesh_model * mesh_data == 1``); with
    ``mesh_model=p`` ranks ``scheme="1d"`` on a (data, model=p) mesh
    (``impl`` picks how each linear's reduce completes), or with
    ``mesh_model=q*q`` ranks ``scheme="2d"`` on a (data, mdom=q, mtp=q)
    mesh, ``mesh_data`` copies of the model group, one process per rank
    (``launch/mesh.py``), each holding its shard of the parameters
    (``launch/specs.py::param_specs``; under 1-D with the config's
    ``shard_params_over_data`` the FSDP hybrid cuts the weights over data
    too) and of the optimizer state (ZeRO-1, ``EngineConfig.zero1``: each
    data rank keeps its slice of the moments and masters);
  * the parameters and the Adam state, updated in place each step;
  * one step function per rollout length (the paper's §6 randomized
    rollout: step i runs ``r_sched[i]`` passes of the processor);
  * the input pipeline (prefetch thread, copies to the device);
  * eval on held-out steps, the metrics history and its JSONL/JSON file,
    and the span tracer (``data_wait`` / ``step`` / ``dispatch``);
  * zero-redundancy sharded checkpoints in the reference's on-disk format
    (``repro_torch.checkpoint``: each rank writes its own blocks, the
    file writes stream from a background thread, keep-last-k GC and the
    best-eval marker), and exact resume (``EngineConfig(resume=...)``:
    params, optimizer state, step, pipeline cursor) from a checkpoint of
    either package on any mesh;
  * preemption (``EngineConfig.preemption``, or the ``preempt_at_step``
    chaos hook; ``launch/resilience.py``): a SIGTERM or SIGUSR1 lets the
    in-flight step finish, then the run takes a final synchronous save
    and raises ``Preempted``.  On a mesh the ranks agree after every step
    (one MAX all-reduce of the flag), so all of them stop after the same
    step and take part in the same save, whichever was signalled.

A language model (the dense, VLM, moe, audio, ssm and hybrid families)
trains on one device or on a data-only mesh (``mesh_model=1,
mesh_data=n``: every rank holds the whole model, reads its rows of the
batch of ``seq_len`` tokens and all-reduces the gradients over data;
ZeRO-1 as for the mixer), or on a 1-D model mesh (``mesh_model=p``:
``scheme="1d"``, each rank its shard by the reference's 1-D layout, the
MoE's experts cut over the ranks, Mamba-2's heads and whisper's encoder
on them, ``impl`` as for the mixer, the VLM's embeds and whisper's frames
cut along D).  What still raises, naming ROADMAP.md's queue 1 item 19:
the checkpoints of a language model on a model mesh (``save`` and
``resume``) and the FSDP hybrid's cut of a language model over more than
one data rank (item 19.3), and a language model on a 2-D model mesh
(``models/registry.py::check_lm_mesh``).

It runs on ``device="cuda"`` unless the caller asks for ``device="cpu"``,
and raises when CUDA is asked for and absent.  On a mesh each rank reads
only its block of the batch, its data rank's rows of it (``pipeline=
"sharded"``, the default: paper §5), or makes the whole batch and takes its
block (``"sync-full"``: the same blocks, bit for bit); every rank computes
the same loss and gradient norm, and rank 0 alone prints and writes the
metrics.  Every step record carries ``mfu``, ``achieved_tflops`` and
``comm_fraction`` from the analytic cost model
(``telemetry/accounting.py``, the H100's peaks; its constants stamped into
the trace's meta header for ``launch/trace_report.py``) and the step's
measured ``through_host_bytes`` (``core/comm.py``'s counters).
``close()`` releases the ring's and the Cannon's IPC workspaces
(collective).

    eng = TrainEngine("weathermixer-1b", reduced=False,
                      config=EngineConfig(steps=10, batch=2, rollout=2,
                                          precision="bf16"))
    history = eng.run()
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch import telemetry
from repro_torch.configs.registry import get_config
from repro_torch.convert import shard_params_1d, shard_params_2d
from repro_torch.core import precision
from repro_torch.core import tree as ptree
from repro_torch.core.sharding import DATA_AXIS
from repro_torch.data.pipeline import InputPipeline, make_pipeline
from repro_torch.kernels import ring
from repro_torch.launch import resilience, specs
from repro_torch.launch.mesh import make_host_mesh, make_ring_mesh
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import registry as M
from repro_torch.models import transformer
from repro_torch.optim import adam, schedule as sched
from repro_torch.train.step import make_eval_step, make_train_step

# held-out validation stream: step indices far past any training step
EVAL_STEP_OFFSET = 1 << 20


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Step-dispatch policy of a TrainEngine."""
    steps: int = 100
    batch: int = 8
    seq_len: int = 128         # tokens per row (the language models)
    rollout: int = 1           # randomized-rollout fine-tuning upper bound
    lr: float = 1e-3
    log_every: int = 10
    eval_every: int = 0        # 0 = no mid-training eval
    eval_batches: int = 2
    accum: int = 1             # microbatch gradient accumulation
    precision: Optional[str] = None   # policy preset: fp32|bf16|bf16_pure;
                               # None = the config's own dtypes
    seed: int = 0
    pipeline: str = "sharded"  # "sharded" (a rank reads its block) |
                               # "sync-full" (the whole batch); the same
                               # batches on 1 device
    prefetch: int = 2          # 0 disables the background thread
    zero1: bool = False        # ZeRO-1: shard optimizer state over data
    ckpt: Optional[str] = None
    ckpt_every: int = 0        # 0 = only a final checkpoint (if ckpt set)
    keep_ckpts: int = 0        # keep last k periodic ckpts (0 = keep all)
    resume: Optional[str] = None   # checkpoint dir: exact-resume from it
    async_save: bool = True    # background checkpoint writes
    metrics_out: Optional[str] = None
    metrics_format: str = "jsonl"  # "jsonl" (append per flush) | "json"
                               # (whole history at the end of the run)
    telemetry: bool = True     # span tracing (counters stay live)
    trace: Optional[str] = None    # Chrome trace-event export path; a
                               # sibling .jsonl gets the step records
    preemption: bool = False   # SIGTERM/SIGUSR1 -> final save + Preempted
    preempt_at_step: Optional[int] = None  # chaos hook: self-SIGTERM
                               # after this step (or REPRO_PREEMPT_AT_STEP)


class TrainEngine:
    """Owns params/opt state, the step functions and the input pipeline."""

    def __init__(self, arch: str, *, reduced: bool = True,
                 mesh_model: int = 1, mesh_data: int = 1,
                 scheme: Optional[str] = None, impl: Optional[str] = None,
                 kernel: Optional[str] = None,
                 config: EngineConfig = EngineConfig(),
                 init_params=None, config_override=None, device="cuda"):
        """``init_params``: whole parameters in the port's layout (on a
        mesh each rank takes its shard of them); None draws them from
        ``config.seed``."""
        cfg = config_override if config_override is not None \
            else get_config(arch)
        # what the port cannot train raises alike on any device, before
        # any process group is joined
        specs.check_lm_mesh(cfg, mesh_model,
                            fsdp=mesh_data > 1 and cfg.shard_params_over_data,
                            scheme=scheme or "1d")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TrainEngine: CUDA is not available; pass "
                               "device='cpu' to train on the CPU")
        if config.metrics_format not in ("jsonl", "json"):
            raise ValueError(
                f"unknown metrics_format {config.metrics_format!r} "
                f"(expected 'jsonl' or 'json')")
        self.arch = arch
        self.config = config
        self.reduced = reduced
        if reduced:
            cfg = cfg.reduced()
        if scheme:
            cfg = cfg.replace(scheme=scheme)
        if impl:
            cfg = cfg.replace(impl=impl)
        if kernel:
            cfg = cfg.replace(kernel=kernel)
        if config.precision:
            cfg = precision.apply_policy(cfg, config.precision)
        self.policy = precision.policy_of(cfg)
        self.mesh = None
        if cfg.family != "mixer" and mesh_model > 1:
            # a language model on a 1-D model mesh
            cfg = cfg.replace(scheme="1d")
            specs.check_lm_mesh(cfg, mesh_model)
            self.mesh = make_ring_mesh(model=mesh_model, data=mesh_data,
                                       device=self.device)
        elif cfg.family != "mixer":
            # a language model: whole on every rank of a data-only mesh,
            # each linear's contraction local
            if mesh_data > 1:
                self.mesh = make_ring_mesh(model=1, data=mesh_data,
                                           device=self.device)
            cfg = cfg.replace(scheme="none", impl="rs")
        elif mesh_model * mesh_data > 1:
            if cfg.scheme not in ("1d", "2d"):
                raise NotImplementedError(
                    f"TrainEngine: scheme={cfg.scheme!r} on a mesh leaves "
                    "the collectives to GSPMD in the reference, which has "
                    "no torch counterpart; pass scheme='1d' or '2d'")
            make = make_ring_mesh if cfg.scheme == "1d" else make_host_mesh
            self.mesh = make(model=mesh_model, data=mesh_data,
                             device=self.device)
        else:
            # one device: the whole contraction is local
            cfg = cfg.replace(scheme="none", impl="rs")
        if self.mesh is not None and self.device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.cfg = cfg
        self.jcfg = jigsaw_for(cfg).replace(mesh=self.mesh)
        self.is_rank0 = self.mesh is None or self.mesh.rank == 0

        # the analytic cost model turns each step's wall time into mfu /
        # comm_fraction / achieved_tflops (telemetry/accounting.py)
        self.tracer = telemetry.Tracer(enabled=config.telemetry)
        telemetry.set_tracer(self.tracer)
        self.cost_model = telemetry.build_cost_model(
            cfg, n_model=mesh_model, n_data=mesh_data, batch=config.batch,
            seq_len=config.seq_len)
        self.tracer.set_meta(
            surface="train", arch=arch, reduced=reduced,
            device=str(self.device), mesh_model=mesh_model,
            mesh_data=mesh_data, scheme=cfg.scheme, impl=self.jcfg.impl,
            kernel=cfg.kernel,
            precision=self.policy.name, steps=config.steps,
            batch=config.batch, seq_len=config.seq_len,
            rollout=config.rollout, accum=config.accum,
            zero1=config.zero1, cost_model=self.cost_model.as_meta())

        if init_params is None:
            self.params = M.init(cfg, seed=config.seed, device=self.device)
        else:
            # a copy: the step updates the params in place, and the caller
            # may still hold its tensors.  Under a named policy every
            # floating leaf adopts the policy's storage dtype, as in the
            # reference (the masters are re-derived from them below)
            pdt = precision.dtype_of(cfg.param_dtype)
            self.params = ptree.map(
                lambda p: p.to(device=self.device,
                               dtype=pdt if config.precision
                               and p.is_floating_point() else p.dtype,
                               copy=True), init_params)
        # the shards' specs and ZeRO-1's cut, from the whole parameters
        self.param_specs = self.zero1 = None
        if self.mesh is not None:
            # every rank holds the whole init; each keeps its shard
            m = self.mesh
            pspecs = specs.param_specs(self.params, cfg, m.rules)
            if cfg.family != "mixer" and cfg.scheme != "1d":
                # a language model on a data-only mesh: whole everywhere
                pspecs = ptree.map(lambda sp: (None,) * len(sp), pspecs)
            self.param_specs = specs.sanitize_tree(self.params, pspecs, m)
            if config.zero1 and m.data_size > 1:
                self.zero1 = adam.Zero1(
                    specs.zero1_dims(self.params, self.param_specs, m),
                    m.data_index, m.data_size, m.data_group)
            if cfg.scheme == "1d":
                # a language model by the language models' rule (no FSDP
                # cut)
                self.params = shard_params_1d(
                    self.params, m.r, m.p, m.data_index, m.data_size,
                    self.jcfg.fsdp, spec=None if cfg.family == "mixer"
                    else transformer.param_spec_1d)
            elif cfg.scheme == "2d":
                self.params = shard_params_2d(self.params, m.i, m.j, m.q)
        pol = self.policy
        self.adam_cfg = adam.AdamConfig(
            weight_decay=0.0, master_weights=pol.master_weights,
            state_dtype=None if pol.moment_dtype is None
            else precision.name_of(pol.moment_dtype))
        self.opt_state = adam.init(self.params, self.adam_cfg, self.zero1)
        self.lr_fn = partial(
            sched.warmup_cosine, base_lr=config.lr,
            warmup_steps=max(config.steps // 10, 1),
            total_steps=config.steps, min_lr=config.lr * 0.1)
        # randomized-rollout fine-tuning (paper §6): each update draws a
        # rollout length r in [1, rollout]; one step function per r
        self.step_fns = {
            r: make_train_step(cfg, self.jcfg, adam_cfg=self.adam_cfg,
                               lr_fn=self.lr_fn, rollout=r,
                               accum=config.accum, specs=self.param_specs,
                               zero1=self.zero1)
            for r in range(1, config.rollout + 1)}
        r_rng = np.random.default_rng(config.seed + 1)
        self.r_sched = (
            r_rng.integers(1, config.rollout + 1, config.steps)
            if config.rollout > 1 else np.ones(config.steps, np.int64))

        self.pipeline = self._make_pipeline(config.prefetch)
        self._eval_pipeline: Optional[InputPipeline] = None
        self._eval_fn = None
        self.history: List[Dict] = []
        self._metrics_flushed = 0   # history records already appended
        self.step_idx = 0
        # async sharded checkpointing: snapshot on this thread, stream
        # files from a background one
        self._writer = ckpt.AsyncCheckpointWriter()
        self.last_save = None      # Snapshot of the most recent save
        self._ckpt_history: List[str] = []   # periodic dirs, oldest first
        self._prune_backlog: List[str] = []  # GC'd paths pending deletion
        self._stale_ckpt_error: Optional[BaseException] = None
        self.best_val = float("inf")
        self.best_ckpt: Optional[str] = None
        self.preempt_stats: Optional[Dict] = None  # final-save timing
        self.preempt_origin: Optional[int] = None  # signalled rank
        if config.resume:
            self._check_ckpt_mesh()
            self._restore(config.resume)

    def _check_ckpt_mesh(self) -> None:
        """Checkpoints of a language model on a model mesh raise
        NotImplementedError (ROADMAP.md, queue 1 item 19.3)."""
        if self.cfg.family != "mixer" and self.cfg.scheme == "1d":
            raise NotImplementedError(
                f"{self.arch}: checkpoints of a language model on a model "
                "mesh are not ported (ROADMAP.md, queue 1 item 19.3)")

    def opt_state_bytes(self) -> int:
        """This rank's bytes of optimizer state: moments, and masters
        where the policy keeps them (ZeRO-1 divides them by the data
        extent, but for the leaves it leaves whole)."""
        return adam.state_bytes(self.opt_state)

    def _make_pipeline(self, prefetch: int) -> InputPipeline:
        return make_pipeline(self.cfg, batch_size=self.config.batch,
                             seq_len=self.config.seq_len,
                             mode=self.config.pipeline, prefetch=prefetch,
                             seed=self.config.seed, device=self.device,
                             mesh=self.mesh)

    # -- single dispatch -------------------------------------------------
    def dispatch(self, batch, rollout_len: int = 1) -> Dict:
        """Run one update on ``batch``; returns the step's metrics (tensors
        on the device, and the lr)."""
        self.params, self.opt_state, metrics = \
            self.step_fns[rollout_len](self.params, self.opt_state, batch)
        self.step_idx += 1
        return metrics

    # -- the loop --------------------------------------------------------
    def run(self) -> List[Dict]:
        """Train from ``step_idx`` to ``config.steps``; returns the metrics
        history (one record per log step and per eval).

        With ``config.preemption`` (or the ``preempt_at_step`` chaos hook)
        a SIGTERM/SIGUSR1 lets the in-flight step complete, then takes a
        final SYNCHRONOUS checkpoint and raises ``resilience.Preempted``
        (DESIGN.md §12's orderly exit)."""
        c = self.config
        start = self.step_idx
        tr = self.tracer
        handler = None
        if c.preemption or c.preempt_at_step is not None:
            handler = resilience.PreemptionHandler(
                preempt_at_step=c.preempt_at_step).install()
        try:
            t0 = time.time()
            it = iter(self.pipeline.iterate(self.r_sched[start:],
                                            start_step=start))
            t_prev = time.perf_counter()
            host_prev = telemetry.measured_comm_bytes()
            for i in range(start, c.steps):
                # data_wait: time the loop spends blocked on the input
                # pipeline (0 when prefetch is ahead)
                with tr.span("data_wait", step=i) as dw:
                    try:
                        batch = next(it)
                    except StopIteration:
                        break
                r = int(self.r_sched[i])
                with tr.span("step", step=i, rollout=r):
                    with tr.span("dispatch", step=i):
                        metrics = self.dispatch(batch, r)
                    # per-step wall time = submit-to-submit delta: launches
                    # are asynchronous, so the device time of step i
                    # surfaces as backpressure on step i+1 (and at every
                    # metrics read)
                    now = time.perf_counter()
                    wall, t_prev = now - t_prev, now
                    host = telemetry.measured_comm_bytes()
                    tr.step_record(step=i, rollout=r, dur_s=wall,
                                   data_wait_s=dw.dur_s,
                                   through_host_bytes=host - host_prev,
                                   **self.cost_model.metrics(wall,
                                                             rollout=r))
                    host_prev = host
                    if i % c.log_every == 0 or i == c.steps - 1:
                        m = {k: float(v) for k, v in metrics.items()}
                        m["step"] = i
                        m["wall_s"] = round(time.time() - t0, 1)
                        self.history.append(m)
                        self._write_metrics()
                        if self.is_rank0:
                            print(f"step {i:5d}  loss {m['loss']:.4f}  "
                                  f"lr {m['lr']:.2e}  ({m['wall_s']}s)")
                    pending_val = None
                    if c.eval_every and i and i % c.eval_every == 0:
                        with tr.span("eval", step=i):
                            em = self.evaluate()
                        self.history.append(dict(em, step=i, eval=True))
                        self._write_metrics()
                        if self.is_rank0:
                            print(f"step {i:5d}  val_loss "
                                  f"{em['val_loss']:.4f}")
                        pending_val = em["val_loss"]
                    if c.ckpt and c.ckpt_every and i \
                            and i % c.ckpt_every == 0:
                        self.save(f"{c.ckpt}-{i}", periodic=True)
                    if pending_val is not None:
                        # after the save: when eval and ckpt cadences
                        # align, the marker points at THIS step's
                        # checkpoint
                        self._mark_best(pending_val)
                if handler is not None and self._agree_stop(i, handler):
                    self._preempt_finalize(i, handler)
            if c.ckpt:
                self.save(c.ckpt)
                if self.is_rank0:
                    print(f"checkpoint -> {c.ckpt}")
            self.wait_checkpoints()    # barrier for in-flight writes
            self._write_metrics(final=True)
            self._export_telemetry()
            return self.history
        finally:
            if handler is not None:
                handler.uninstall()

    def _agree_stop(self, i: int, handler) -> bool:
        """Whether the run stops after step ``i``.  On one device, the
        handler's flag.  On a mesh, one MAX all-reduce over the world of
        (rank + 1 if this rank's flag is up, else 0): every rank stops
        after the same step if any was signalled, and learns the highest
        signalled rank (``preempt_origin``)."""
        flag = handler.poll(i)
        if self.mesh is None:
            self.preempt_origin = 0 if flag else None
            return flag
        origin = self._world_max(self.mesh.rank + 1 if flag else 0) - 1
        self.preempt_origin = origin if origin >= 0 else None
        return origin >= 0

    def _world_max(self, value: int) -> int:
        """The MAX of one integer over the world group (a mesh only)."""
        dev = (self.device if dist.get_backend() == "nccl"
               else torch.device("cpu"))
        code = torch.tensor([value], dtype=torch.int64, device=dev)
        dist.all_reduce(code, op=dist.ReduceOp.MAX)
        return int(code.item())

    def _preempt_finalize(self, i: int, handler) -> None:
        """Orderly preemption exit: the step that was in flight has
        completed.  Stop the prefetch thread, drain (and absorb) any
        pending async-write error, take a final SYNCHRONOUS checkpoint,
        persist the metrics history and the trace, and raise ``Preempted``
        for ``launch/train.py`` to turn into the resumable exit code.  On a
        mesh every rank comes here after the same step: each writes its
        blocks of the save, and rank 0 merges the manifest."""
        c = self.config
        sig = handler.received
        self.tracer.event("preempt.signal", signum=sig, step=i,
                          origin_rank=self.preempt_origin)
        if self.is_rank0:
            print(f"[preempt] signal {sig} after step {i} (origin rank "
                  f"{self.preempt_origin}): final synchronous save, then "
                  f"resumable exit")
        # the producer stops at its next chunk of host work; a thread
        # still in numpy or a copy to the card at exit could turn the
        # resumable exit into a crash, so the exit waits for it (bounded)
        if not (self.pipeline.stop(timeout=5.0)
                or self.pipeline.stop(timeout=120.0)):
            print("[preempt] the input pipeline's thread did not stop in "
                  "125 s; exiting beside it")
        try:
            self.wait_checkpoints()
        except Exception as e:
            # an EARLIER async write failed; its prune list is still in
            # _prune_backlog (re-queued by the next save) -- it must not
            # abort the final preemption save, which may become the only
            # durable copy of this run segment
            print(f"[preempt] pending async save had failed: {e!r}; "
                  f"final save proceeds")
        path, save_s = None, None
        if c.ckpt:
            path = f"{c.ckpt}-{i}"
            # the periodic cadence may have saved this very step: that
            # save is the preemption checkpoint only if its write finished
            # whole (a failed one was absorbed just above).  Rank 0 merges
            # the manifest, so its view, taken after its writer is done,
            # decides for every rank: the final save stays collective
            saved = (self._ckpt_history[-1:] == [path]
                     and self.is_rank0 and ckpt.checkpoint_complete(path))
            if self.mesh is not None:
                saved = bool(self._world_max(int(saved)))
            if not saved:
                t0 = time.time()
                self.save(path, block=True,
                          periodic=path not in self._ckpt_history)
                save_s = time.time() - t0
                self.tracer.event("preempt.final_save", step=i,
                                  dur_s=save_s, path=path)
            if self.is_rank0:
                print(f"[preempt] checkpoint durable -> {path}")
        self.preempt_stats = {"step": i, "final_save_s": save_s}
        self._write_metrics(final=True)
        # flush the trace BEFORE raising: the Preempted exit is exactly
        # when the operator needs to see where the run's time went
        self._export_telemetry()
        raise resilience.Preempted(step=self.step_idx, checkpoint=path,
                                   signum=sig)

    def _write_metrics(self, final: bool = False) -> None:
        """Persist the history: ``jsonl`` appends the records added since
        the last flush, one JSON object per line; ``json`` writes the whole
        history once, at the end of the run.  On a mesh, rank 0 writes."""
        path = self.config.metrics_out
        if not path or not self.is_rank0:
            return
        if self.config.metrics_format == "json":
            if final:
                with open(path, "w") as f:
                    json.dump(self.history, f, indent=1)
            return
        new = self.history[self._metrics_flushed:]
        if not new:
            return
        with open(path, "a") as f:
            for rec in new:
                f.write(json.dumps(rec) + "\n")
        self._metrics_flushed = len(self.history)

    def _export_telemetry(self) -> None:
        c = self.config
        if not c.trace or not self.is_rank0:
            return
        self.tracer.export_chrome(c.trace)
        jsonl = telemetry.jsonl_path_for(c.trace)
        self.tracer.export_jsonl(jsonl)
        print(f"trace -> {c.trace} (+ {jsonl})")

    # -- checkpointing ---------------------------------------------------
    def _ckpt_specs(self):
        """The spec trees of this rank's blocks of each checkpoint group
        (None on one device): the params' sanitized specs; the optimizer
        state's the same, with the data axis on the dim ZeRO-1 cuts."""
        if self.mesh is None:
            return None

        def state_spec(spec, dim):
            if dim is None:
                return spec
            return tuple(DATA_AXIS if d == dim else e
                         for d, e in enumerate(spec))

        dims = (self.zero1.dims if self.zero1 is not None
                else ptree.map(lambda _: None, self.param_specs))
        ospec = ptree.map(state_spec, self.param_specs, dims)
        opt = {"step": (), "mu": ospec, "nu": ospec}
        if "master" in self.opt_state:
            opt["master"] = ospec
        return {"params": self.param_specs, "opt_state": opt}

    def save(self, path: str, block: Optional[bool] = None,
             periodic: bool = False) -> None:
        """Sharded checkpoint of params/opt_state/step + resume state.

        Each rank writes only its own blocks (no gather); with
        ``config.async_save`` the device->host snapshot happens here and
        the file writes stream from a background thread while training
        continues (``wait_checkpoints`` is the barrier).  On a mesh every
        rank calls this at the same step: each writes its shard file and
        index fragment, and rank 0's writer merges the fragments into the
        manifest.

        ``periodic=True`` registers the path for keep-last-k GC
        (``EngineConfig(keep_ckpts=k)``): once more than k periodic
        checkpoints exist, the oldest are deleted -- except the one the
        ``best`` marker points at.  Rank 0 deletes them, only AFTER the
        new checkpoint is complete."""
        self._check_ckpt_mesh()
        c = self.config
        block = (not c.async_save) if block is None else block
        prune = []
        if periodic:
            self._ckpt_history.append(path)
            if c.keep_ckpts > 0:
                keep = set(self._ckpt_history[-c.keep_ckpts:])
                if self.best_ckpt:
                    keep.add(self.best_ckpt)
                prune = [p for p in self._ckpt_history if p not in keep]
                self._ckpt_history = [p for p in self._ckpt_history
                                      if p not in prune]
                # re-queue paths whose earlier prune never ran (a failed
                # async write skips its prune) so GC'd dirs cannot leak
                prune += [p for p in self._prune_backlog
                          if p not in prune and p not in keep
                          and os.path.isdir(p)]
        else:
            # final saves drain the backlog too: this may be the run's
            # last save, so an orphaned prune list would leak GC'd
            # directories forever
            prune = [p for p in self._prune_backlog if os.path.isdir(p)]
        self._prune_backlog = prune
        # the reference's keys: either package's _restore reads them
        extra = {"arch": self.arch, "reduced": self.reduced,
                 "seed": c.seed, "steps": c.steps, "rollout": c.rollout,
                 "scheme": self.cfg.scheme,
                 "precision": self.policy.name,
                 "pipeline": self.pipeline.state(),
                 "best": {"val": (None if self.best_val == float("inf")
                                  else self.best_val),
                          "ckpt": self.best_ckpt},
                 "ckpt_history": list(self._ckpt_history),
                 "prune_backlog": list(self._prune_backlog)}
        try:
            self._writer.wait()
        except Exception as e:
            # a FAILED earlier async write surfaces at the writer's
            # in-flight guard.  It must not abort THIS save; its prune
            # list stays queued in _prune_backlog, and the error is
            # re-raised at the next wait_checkpoints() barrier.
            print(f"[ckpt] earlier async checkpoint write failed: {e!r}; "
                  f"proceeding with save of {path!r}")
            self._stale_ckpt_error = e
        m = self.mesh
        # ckpt_submit covers the synchronous part the train loop pays
        # for: the device->host snapshot (plus, under block=True, the
        # whole write); the background streaming shows up as ckpt.write
        # spans on the writer thread's own track
        with self.tracer.span("ckpt_submit", path=path, block=block,
                              step=self.step_idx):
            self.last_save = self._writer.save(
                path, {"params": self.params,
                       "opt_state": self.opt_state},
                step=self.step_idx, extra=extra, mesh=m,
                specs=self._ckpt_specs(), block=block,
                prune=prune if self.is_rank0 else [],
                process_index=0 if m is None else m.rank,
                process_count=1 if m is None
                else m.data_size * m.model_size)

    def _mark_best(self, val_loss: float) -> None:
        """Track the best eval loss; point the ``<ckpt>-best.json`` marker
        (rank 0 writes it) at the newest periodic checkpoint at-or-before
        the eval when it improves.  ``eval_step``/``val_loss`` describe
        the weights that were evaluated, ``ckpt_step`` the (possibly
        earlier) checkpoint the path refers to."""
        if val_loss >= self.best_val:
            return
        self.best_val = float(val_loss)
        if not (self.config.ckpt and self._ckpt_history):
            return
        self.best_ckpt = self._ckpt_history[-1]
        if not self.is_rank0:
            return
        suffix = self.best_ckpt.rsplit("-", 1)[-1]
        marker = {"path": self.best_ckpt, "val_loss": self.best_val,
                  "eval_step": self.step_idx,
                  "ckpt_step": int(suffix) if suffix.isdigit() else None}
        with open(f"{self.config.ckpt}-best.json", "w") as f:
            json.dump(marker, f, indent=1)

    def wait_checkpoints(self) -> None:
        """Barrier for in-flight checkpoint writes (re-raises their
        errors on this thread) -- including an absorbed error from an
        earlier failed write that ``save`` proceeded past."""
        self._writer.wait()
        if self._stale_ckpt_error is not None:
            err, self._stale_ckpt_error = self._stale_ckpt_error, None
            raise err

    def _restore(self, path: str) -> None:
        """Exact resume: params, optimizer state (with Adam's step), the
        loop's step index and the pipeline's cursor -- an interrupted run
        continues with a bit-identical history.

        The restore is elastic: the checkpoint may come from either
        package and any mesh.  Each rank reads, from the manifest's global
        bounds, only its blocks of THIS engine's own param and ZeRO-1
        layouts, into its own tensors.  The pipeline needs no refit: its
        read plans come from the current mesh, only the cursor is
        restored."""
        c = self.config
        man = ckpt.load_manifest(path)
        for field in ("seed", "rollout", "steps"):
            want, got = getattr(c, field), man.extra.get(field)
            if got is not None and got != want:
                raise ValueError(
                    f"resume {path!r}: checkpoint {field}={got} != engine "
                    f"{field}={want} -- the rollout schedule / lr "
                    f"schedule would diverge; pass the saved value")
        arch = man.extra.get("arch")
        if arch is not None and arch != self.arch:
            raise ValueError(f"resume {path!r}: checkpoint arch {arch!r} "
                             f"!= engine arch {self.arch!r}")
        prec = man.extra.get("precision")
        if prec is not None and prec != self.policy.name:
            hint = ("omit --precision (the checkpoint predates the "
                    "policy presets)" if prec == "legacy"
                    else f"pass --precision {prec}")
            raise ValueError(
                f"resume {path!r}: checkpoint precision {prec!r} != engine "
                f"policy {self.policy.name!r} -- param dtypes and the "
                f"master-weight state would not line up; {hint}")
        cur_shape = (None if self.mesh is None
                     else tuple(self.mesh.shape.values()))
        if (man.mesh_shape is not None and cur_shape is not None
                and tuple(man.mesh_shape) != cur_shape and self.is_rank0):
            print(f"[resume] elastic reshard: checkpoint mesh "
                  f"{tuple(man.mesh_shape)} -> current mesh {cur_shape}")
        specs = self._ckpt_specs() or {}
        for group, tree in (("params", self.params),
                            ("opt_state", self.opt_state)):
            ckpt.restore_tree(path, group, out=tree, mesh=self.mesh,
                              specs=specs.get(group), manifest=man)
        self.step_idx = man.step
        self.pipeline.set_state(man.extra.get("pipeline",
                                              {"cursor": man.step}))
        # best-marker state: the synchronously-written <ckpt>-best.json is
        # authoritative (the manifest's copy can be one eval stale when
        # the eval and ckpt cadences align); manifest extra is the
        # fallback when this run has no ckpt or the marker is gone
        best = man.extra.get("best") or {}
        marker_file = f"{c.ckpt}-best.json" if c.ckpt else None
        if marker_file and os.path.exists(marker_file):
            with open(marker_file) as f:
                mk = json.load(f)
            best = {"val": mk.get("val_loss"), "ckpt": mk.get("path")}
        if best.get("val") is not None:
            self.best_val = float(best["val"])
            self.best_ckpt = best.get("ckpt")
        self._ckpt_history = [p for p in man.extra.get("ckpt_history", [])
                              if os.path.isdir(p)]
        # deletions the dead process never ran: re-queued at the next save
        self._prune_backlog = [
            p for p in man.extra.get("prune_backlog", [])
            if os.path.isdir(p)]

    def close(self, collective: bool = True) -> None:
        """Release what outlives the steps: the ring's and the Cannon's IPC
        workspaces (collective over the mesh; a no-op where neither ran on
        the card).
        After an error, ``collective=False`` only unmaps the peers' slots:
        the peers may be waiting in another collective."""
        ring.release_workspaces(collective)

    # -- evaluation ------------------------------------------------------
    def evaluate(self) -> Dict[str, float]:
        """Mean metrics over ``eval_batches`` held-out batches (step indices
        offset past the training stream, on a pipeline of their own)."""
        if self._eval_pipeline is None:
            self._eval_pipeline = self._make_pipeline(prefetch=0)
            self._eval_fn = make_eval_step(self.cfg, self.jcfg)
        vals: Dict[str, List[float]] = {}
        for j in range(self.config.eval_batches):
            b = self._eval_pipeline.get(EVAL_STEP_OFFSET + j)
            for k, v in self._eval_fn(self.params, b).items():
                vals.setdefault(k, []).append(float(v))
        return {f"val_{k}": float(np.mean(v)) for k, v in vals.items()}
