"""One-device training from the command line: a thin CLI over the port's
``TrainEngine`` (the counterpart of ``repro/launch/train.py``, with the
flags that apply on one device, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch weathermixer-1b \\
      [--full] [--steps 100] [--batch 8] [--rollout 3] [--accum 2] \\
      [--precision bf16] [--kernel pallas|xla] [--pipeline sharded] \\
      [--prefetch 2] [--metrics-out m.jsonl] [--device cuda|cpu]

Reduced configs (the default) run real optimization on the synthetic
weather data; ``--full`` trains the published width and needs a GPU.
``--device`` defaults to cuda and fails without a card.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import MIXER_IDS
from repro_torch.launch.engine import EngineConfig, TrainEngine


def train(arch: str, *, steps: int = 100, batch: int = 8,
          reduced: bool = True, kernel: str = None, precision: str = None,
          rollout: int = 1, lr: float = 1e-3, log_every: int = 10,
          seed: int = 0, metrics_out: str = None,
          metrics_format: str = "jsonl", trace: str = None,
          telemetry: bool = True, pipeline: str = "sharded",
          prefetch: int = 2, accum: int = 1, eval_every: int = 0,
          device: str = "cuda"):
    """Functional entry point; returns (history, params)."""
    engine = TrainEngine(
        arch, reduced=reduced, kernel=kernel, device=device,
        config=EngineConfig(
            steps=steps, batch=batch, rollout=rollout, lr=lr,
            log_every=log_every, seed=seed, precision=precision,
            metrics_out=metrics_out, metrics_format=metrics_format,
            trace=trace, telemetry=telemetry, pipeline=pipeline,
            prefetch=prefetch, accum=accum, eval_every=eval_every))
    history = engine.run()
    return history, engine.params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="weathermixer-1b", choices=MIXER_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--full", action="store_true",
                    help="full (non-reduced) config -- needs a GPU")
    ap.add_argument("--kernel", default=None, choices=["xla", "pallas"],
                    help="local GEMM engine: pallas = the hand-written "
                         "block_matmul kernel (its plain version on the "
                         "CPU); xla = plain PyTorch ops")
    ap.add_argument("--precision", default=None,
                    choices=["fp32", "bf16", "bf16_pure"],
                    help="precision policy: bf16 = bf16 params and "
                         "compute, f32 masters and moments")
    ap.add_argument("--rollout", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--metrics-format", default="jsonl",
                    choices=["jsonl", "json"])
    ap.add_argument("--trace", default=None,
                    help="Chrome trace-event export path")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable span tracing (counters stay live)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipeline", default="sharded",
                    choices=["sharded", "sync-full"],
                    help="input read mode (identical batches on one "
                         "device)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches prefetched by the background thread "
                         "(0 = synchronous)")
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatch gradient-accumulation factor")
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, batch=args.batch,
          reduced=not args.full, kernel=args.kernel,
          precision=args.precision, rollout=args.rollout, lr=args.lr,
          log_every=args.log_every, seed=args.seed,
          metrics_out=args.metrics_out,
          metrics_format=args.metrics_format, trace=args.trace,
          telemetry=not args.no_telemetry, pipeline=args.pipeline,
          prefetch=args.prefetch, accum=args.accum,
          eval_every=args.eval_every, device=args.device)


if __name__ == "__main__":
    main()
