"""Forecast serving driver: a thin CLI over the port's ``ForecastEngine``
(the counterpart of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch weathermixer-1b \\
      [--full] [--ckpt out/ck-100] [--precision bf16] [--requests 8] \\
      [--leads 1,2] [--buckets 1,2,4] [--mode continuous|drain] \\
      [--coalesce-ms 0] [--device cuda|cpu] [--no-graphs]

  # data-parallel serving: n ranks, each the whole model (gloo on one card)
  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 2 -m repro_torch.launch.serve --mesh-data 2

``--mesh-data n`` serves on n ranks of a data-only mesh and must run as
``WORLD_SIZE = n`` ranks under ``torch.distributed.run``: rank 0 takes the
requests, runs the scheduler and prints the report; the others follow its
ticks (``ForecastEngine.serve_worker``); then the ranks leave the process
group together (a barrier, ``destroy_process_group``), as the train CLI's
do.  On CUDA each bucket's step is a
CUDA graph captured at warmup; ``--no-graphs`` runs it eagerly.
``--ckpt`` restores the params group of any training checkpoint (either
package's, any saving mesh; cast to the serving precision); without it the
engine serves fresh weights from ``--seed``.  Requests are synthetic
initial conditions from the weather dataset, submitted up-front with leads
cycling through ``--leads``; the engine batches continuously at
rollout-step boundaries and reports requests/s and latency percentiles.
``--device`` defaults to cuda and fails without a card.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch.distributed as dist

from repro_torch.configs.registry import MIXER_IDS
from repro_torch.data.weather import WeatherDataConfig, WeatherDataset
from repro_torch.serve.engine import ForecastEngine, ServeConfig


def serve(arch: str, *, ckpt: Optional[str] = None, requests: int = 32,
          leads: Sequence[int] = (1, 2, 4, 8),
          precision: Optional[str] = None, mode: str = "continuous",
          buckets: Sequence[int] = (1, 2, 4, 8), coalesce_ms: float = 0.0,
          seed: int = 0, reduced: bool = True, warmup: bool = True,
          trace: Optional[str] = None, config_override=None,
          device: str = "cuda", quiet: bool = False, mesh_data: int = 1,
          graphs: bool = True):
    """Build an engine, push ``requests`` synthetic forecasts through it,
    and return ``(results, engine, wall_seconds)``.  With ``mesh_data > 1``
    every rank calls this: rank 0 serves and returns its results, the
    others follow it and return ``([], engine, wall_seconds)``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != mesh_data:
        raise ValueError(f"--mesh-data {mesh_data} needs {mesh_data} ranks "
                         f"(torch.distributed.run --nproc-per-node "
                         f"{mesh_data}); WORLD_SIZE is {world}")
    engine = ForecastEngine(
        arch, reduced=reduced, ckpt=ckpt, config_override=config_override,
        device=device, mesh_data=mesh_data,
        config=ServeConfig(buckets=tuple(buckets), mode=mode,
                           coalesce_s=coalesce_ms / 1e3,
                           precision=precision, seed=seed, trace=trace,
                           graphs=graphs))
    quiet = quiet or engine.rank != 0
    if warmup:
        engine.warmup()
        if not quiet:
            print(f"[serve] warmup: {engine.stats['compiles']} setups "
                  f"in {engine.stats['warmup_s']:.2f}s")
    if engine.rank != 0:
        t0 = time.perf_counter()
        engine.serve_worker()
        return [], engine, time.perf_counter() - t0
    cfg = engine.cfg
    ds = WeatherDataset(WeatherDataConfig(
        lat=cfg.wm_lat, lon=cfg.wm_lon, channels=cfg.wm_channels,
        seed=seed))
    fields = ds.sample_fields(0, requests)
    t0 = time.perf_counter()
    results = [engine.submit(fields[i], leads[i % len(leads)])
               for i in range(requests)]
    engine.drain()
    wall = time.perf_counter() - t0
    engine.close()
    if not quiet:
        s = engine.summary(results)
        src = (f"ckpt {ckpt} (step {engine.restored_step})" if ckpt
               else "fresh init")
        print(f"[serve] {arch} ({src}) on {engine.device} x{mesh_data} "
              f"precision={engine.policy.name} mode={mode} "
              f"graphs={engine.graphs}")
        print(f"[serve] {requests} requests in {wall:.2f}s = "
              f"{requests / wall:.3f} req/s | p50 {s['p50_s'] * 1e3:.1f}ms "
              f"p95 {s['p95_s'] * 1e3:.1f}ms | {s['device_steps']} rollout "
              f"steps, {s['formed']} batch forms, {s['grown']} grows, "
              f"{s['compiles']} setups (0 post-warmup = steady state)")
    out = engine.export_trace()
    if out and not quiet:
        print(f"[serve] trace -> {out}")
    return results, engine, wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="weathermixer-1b", choices=MIXER_IDS)
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config -- needs a GPU")
    ap.add_argument("--ckpt", default=None,
                    help="serve the params of this training checkpoint "
                         "(default: fresh weights from --seed)")
    ap.add_argument("--precision", default=None,
                    choices=["fp32", "bf16", "bf16_pure"],
                    help="serving precision policy")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--leads", default="1,2,4,8",
                    help="comma-separated lead times (rollout steps), "
                         "assigned round-robin to requests")
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "drain"],
                    help="continuous batching vs drain-and-refill baseline")
    ap.add_argument("--buckets", default="1,2,4,8",
                    help="padded batch buckets (one state buffer each)")
    ap.add_argument("--coalesce-ms", type=float, default=0.0,
                    help="idle burst-coalescing window")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None,
                    help="Chrome trace-event export path for the serving "
                         "spans + latency histograms")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data-parallel serving ranks (run this many under "
                         "torch.distributed.run)")
    ap.add_argument("--no-graphs", action="store_true",
                    help="run every step eagerly (CUDA graphs per bucket "
                         "are the default on CUDA)")
    args = ap.parse_args(argv)
    _, engine, _ = serve(
        args.arch, ckpt=args.ckpt, requests=args.requests,
        leads=[int(x) for x in args.leads.split(",")],
        precision=args.precision, mode=args.mode,
        buckets=[int(x) for x in args.buckets.split(",")],
        coalesce_ms=args.coalesce_ms, seed=args.seed, reduced=not args.full,
        trace=args.trace, device=args.device, mesh_data=args.mesh_data,
        graphs=not args.no_graphs)
    if engine.mesh is not None:
        # every rank has left the serving loop: leave the process group
        # together, before the interpreter tears down gloo's threads (a
        # rank exiting beside a peer's last collective can abort, turning
        # a clean run into a crash)
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
