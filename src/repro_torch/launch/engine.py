"""TrainEngine on one device: the training loop of the port (the one-device
part of ``repro/launch/engine.py``).

The engine owns

  * the config, the precision policy and the ``JigsawConfig``
    (``scheme="none"``: the whole contraction is local, as the reference
    forces whenever ``mesh_model * mesh_data == 1``);
  * the parameters and the Adam state, updated in place each step;
  * one step function per rollout length (the paper's §6 randomized
    rollout: step i runs ``r_sched[i]`` passes of the processor);
  * the input pipeline (prefetch thread, copies to the device);
  * eval on held-out steps, the metrics history and its JSONL/JSON file,
    and the span tracer (``data_wait`` / ``step`` / ``dispatch``).

It runs on ``device="cuda"`` unless the caller asks for ``device="cpu"``,
and raises when CUDA is asked for and absent.  Left for later slices
(ROADMAP.md): checkpoints and resume, preemption, ZeRO-1, meshes and the
analytic cost model.

    eng = TrainEngine("weathermixer-1b", reduced=False,
                      config=EngineConfig(steps=10, batch=2, rollout=2,
                                          precision="bf16"))
    history = eng.run()
"""
from __future__ import annotations

import dataclasses
import json
import time
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.configs.registry import get_config
from repro_torch.core import precision
from repro_torch.core import tree as ptree
from repro_torch.data.pipeline import InputPipeline, make_pipeline
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import registry as M
from repro_torch.optim import adam, schedule as sched
from repro_torch.train.step import make_eval_step, make_train_step

# held-out validation stream: step indices far past any training step
EVAL_STEP_OFFSET = 1 << 20


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Step-dispatch policy of a TrainEngine."""
    steps: int = 100
    batch: int = 8
    rollout: int = 1           # randomized-rollout fine-tuning upper bound
    lr: float = 1e-3
    log_every: int = 10
    eval_every: int = 0        # 0 = no mid-training eval
    eval_batches: int = 2
    accum: int = 1             # microbatch gradient accumulation
    precision: Optional[str] = None   # policy preset: fp32|bf16|bf16_pure;
                               # None = the config's own dtypes
    seed: int = 0
    pipeline: str = "sharded"  # "sharded" | "sync-full" (same on 1 device)
    prefetch: int = 2          # 0 disables the background thread
    metrics_out: Optional[str] = None
    metrics_format: str = "jsonl"  # "jsonl" (append per flush) | "json"
                               # (whole history at the end of the run)
    telemetry: bool = True     # span tracing (counters stay live)
    trace: Optional[str] = None    # Chrome trace-event export path; a
                               # sibling .jsonl gets the step records


class TrainEngine:
    """Owns params/opt state, the step functions and the input pipeline."""

    def __init__(self, arch: str, *, reduced: bool = True,
                 kernel: Optional[str] = None,
                 config: EngineConfig = EngineConfig(),
                 init_params=None, config_override=None, device="cuda"):
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
        cfg = config_override if config_override is not None \
            else get_config(arch)
        if reduced:
            cfg = cfg.reduced()
        if kernel:
            cfg = cfg.replace(kernel=kernel)
        if config.precision:
            cfg = precision.apply_policy(cfg, config.precision)
        self.policy = precision.policy_of(cfg)
        # one device: the whole contraction is local
        cfg = cfg.replace(scheme="none", impl="rs")
        self.cfg = cfg
        self.jcfg = jigsaw_for(cfg)

        self.tracer = telemetry.Tracer(enabled=config.telemetry)
        telemetry.set_tracer(self.tracer)
        self.tracer.set_meta(
            surface="train", arch=arch, reduced=reduced,
            device=str(self.device), scheme=cfg.scheme, kernel=cfg.kernel,
            precision=self.policy.name, steps=config.steps,
            batch=config.batch, rollout=config.rollout, accum=config.accum)

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
        pol = self.policy
        self.adam_cfg = adam.AdamConfig(
            weight_decay=0.0, master_weights=pol.master_weights,
            state_dtype=None if pol.moment_dtype is None
            else precision.name_of(pol.moment_dtype))
        self.opt_state = adam.init(self.params, self.adam_cfg)
        self.lr_fn = partial(
            sched.warmup_cosine, base_lr=config.lr,
            warmup_steps=max(config.steps // 10, 1),
            total_steps=config.steps, min_lr=config.lr * 0.1)
        # randomized-rollout fine-tuning (paper §6): each update draws a
        # rollout length r in [1, rollout]; one step function per r
        self.step_fns = {
            r: make_train_step(cfg, self.jcfg, adam_cfg=self.adam_cfg,
                               lr_fn=self.lr_fn, rollout=r,
                               accum=config.accum)
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

    def _make_pipeline(self, prefetch: int) -> InputPipeline:
        return make_pipeline(self.cfg, batch_size=self.config.batch,
                             mode=self.config.pipeline, prefetch=prefetch,
                             seed=self.config.seed, device=self.device)

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
        history (one record per log step and per eval)."""
        c = self.config
        start = self.step_idx
        tr = self.tracer
        t0 = time.time()
        it = iter(self.pipeline.iterate(self.r_sched[start:],
                                        start_step=start))
        t_prev = time.perf_counter()
        for i in range(start, c.steps):
            # data_wait: time the loop spends blocked on the input pipeline
            # (0 when prefetch is ahead)
            with tr.span("data_wait", step=i) as dw:
                try:
                    batch = next(it)
                except StopIteration:
                    break
            r = int(self.r_sched[i])
            with tr.span("step", step=i, rollout=r):
                with tr.span("dispatch", step=i):
                    metrics = self.dispatch(batch, r)
                # per-step wall time = submit-to-submit delta: launches are
                # asynchronous, so the device time of step i surfaces as
                # backpressure on step i+1 (and at every metrics read)
                now = time.perf_counter()
                wall, t_prev = now - t_prev, now
                tr.step_record(step=i, rollout=r, dur_s=wall,
                               data_wait_s=dw.dur_s)
                if i % c.log_every == 0 or i == c.steps - 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = i
                    m["wall_s"] = round(time.time() - t0, 1)
                    self.history.append(m)
                    self._write_metrics()
                    print(f"step {i:5d}  loss {m['loss']:.4f}  "
                          f"lr {m['lr']:.2e}  ({m['wall_s']}s)")
                if c.eval_every and i and i % c.eval_every == 0:
                    with tr.span("eval", step=i):
                        em = self.evaluate()
                    self.history.append(dict(em, step=i, eval=True))
                    self._write_metrics()
                    print(f"step {i:5d}  val_loss {em['val_loss']:.4f}")
        self._write_metrics(final=True)
        self._export_telemetry()
        return self.history

    def _write_metrics(self, final: bool = False) -> None:
        """Persist the history: ``jsonl`` appends the records added since
        the last flush, one JSON object per line; ``json`` writes the whole
        history once, at the end of the run."""
        path = self.config.metrics_out
        if not path:
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
        if not c.trace:
            return
        self.tracer.export_chrome(c.trace)
        jsonl = telemetry.jsonl_path_for(c.trace)
        self.tracer.export_jsonl(jsonl)
        print(f"trace -> {c.trace} (+ {jsonl})")

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
