"""Training from the command line: a thin CLI over the port's
``TrainEngine`` (the counterpart of ``repro/launch/train.py``, with the
flags that are ported, plus ``--device`` and ``--init-params``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch weathermixer-1b \\
      [--full] [--steps 100] [--batch 8] [--rollout 3] [--accum 2] \\
      [--precision bf16] [--kernel pallas|xla] [--pipeline sharded] \\
      [--prefetch 2] [--metrics-out m.jsonl] [--device cuda|cpu]

``--arch`` takes every id of ``configs/registry.py``.  The language
models (the dense, VLM, moe, audio, ssm and hybrid families) train on
synthetic token rows of ``--seq-len`` tokens (default 128; the VLM's patch
embeddings and whisper's frames are random f32 draws), on one device or on
a data-only mesh (``--mesh-data n``, ``--mesh-model 1``):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch mamba2-130m --steps 5 --seq-len 32 --log-every 1

Every language model also trains on a 1-D Jigsaw model mesh
(``--mesh-model p``, ``--scheme 1d`` implied; ``--impl`` as below, default
the config's ``rs``), one process per rank under ``torch.distributed.run``:
the dense and VLM transformers, the MoE with its experts cut over the
ranks, Mamba-2 and the hybrid with their heads on the ranks, whisper's
encoder and cross attention:

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 2 -m repro_torch.launch.train --arch mamba2-130m \
      --mesh-model 2 [--mesh-data n] [--impl ring_fused] --device cpu

The FSDP hybrid's cut of a language model over more than one data rank
(ROADMAP.md, queue 1 item 19.3) and a language model on a 2-D model mesh
(item 19) raise NotImplementedError.

1-D Jigsaw on p processes and 2-D Jigsaw on q*q, one per rank, each model
group replicated ``--mesh-data`` times (the launcher gives each process
its rank and the rendezvous; gloo on the CPU, NCCL on GPUs, gloo for ranks
that share a card: four ranks of the 2x2 mesh fit on one H100).  Each rank
reads only its block of its data rank's rows of the batch (``--pipeline
sharded``, the default; ``sync-full`` makes the whole batch on every rank);
``--zero1`` shards the optimizer state over data:

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --mesh-model 4 \\
      --scheme 1d --impl ring_fused [--device cpu] ...
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --mesh-model 4 \\
      --scheme 2d [--full] [--device cpu] ...
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --mesh-model 2 \\
      --mesh-data 2 --scheme 1d --zero1 [--device cpu] ...

``--impl`` (1-D only) defaults to the config's own (weathermixer-1b:
``ring_chunked``).

Checkpoints, in the reference's on-disk format (``repro_torch.checkpoint``:
either package's restore reads the other's), each rank writing only its
own blocks, the writes in the background unless ``--sync-save``:

  ... --ckpt out/ck [--ckpt-every 50] [--keep-ckpts 3] [--sync-save]
  ... --resume out/ck-50          # the same --steps/--seed/--rollout

``--ckpt-every k`` saves ``out/ck-<i>`` after every k-th step i (and the
final ``out/ck``); ``--resume`` continues bit for bit from any of them, on
any mesh (each rank reads only its blocks of the new layout).  The same
flags work for every language model on a 1-D model mesh (and with
``--supervise``, below):

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 2 -m repro_torch.launch.train --arch mamba2-130m \
      --mesh-model 2 --device cpu --steps 4 --ckpt out/ck --ckpt-every 2
  ... the same with --resume out/ck-2

Preemption (``launch/resilience.py``): a SIGTERM or SIGUSR1 lets the step
in flight finish, takes a final synchronous save at ``<ckpt>-<step>`` and
exits 75 (``RESUMABLE_EXIT_CODE``; "[preempt] ..."); on a mesh every rank
stops after the same step.  ``REPRO_PREEMPT_AT_STEP=N`` sends the signal
after step N.  ``--supervise`` relaunches the run (``--max-restarts``,
default 3) from the latest complete checkpoint under ``--ckpt``'s
directory: at once after exit 75, with backoff after a crash.  On a mesh
it launches the ranks itself, one process each, and takes the world's
code (``torch.distributed.run`` would report the ranks' 75 as its own
failure), so it is run once, not under torchrun:

  ... --ckpt out/ck --supervise [--max-restarts 3] \
      [--mesh-model 2 --mesh-data 2 --scheme 1d --device cpu]

Reduced configs (the default) run real optimization on the synthetic
data; ``--full`` trains the published width and needs a GPU.
``--device`` defaults to cuda and fails without a card.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch.distributed as dist

from repro_torch.configs.registry import ARCH_IDS
from repro_torch.convert import params_from_npz
from repro_torch.launch import resilience
from repro_torch.launch.engine import EngineConfig, TrainEngine


def train(arch: str, *, steps: int = 100, batch: int = 8,
          seq_len: int = 128,
          reduced: bool = True, kernel: str = None, precision: str = None,
          rollout: int = 1, lr: float = 1e-3, log_every: int = 10,
          seed: int = 0, metrics_out: str = None,
          metrics_format: str = "jsonl", trace: str = None,
          telemetry: bool = True, pipeline: str = "sharded",
          prefetch: int = 2, accum: int = 1, eval_every: int = 0,
          device: str = "cuda", mesh_model: int = 1, mesh_data: int = 1,
          scheme: str = None, impl: str = None, init_params: str = None,
          zero1: bool = False, ckpt: str = None, ckpt_every: int = 0,
          keep_ckpts: int = 0, resume: str = None, async_save: bool = True,
          preemption: bool = False, preempt_at_step: int = None):
    """Functional entry point; returns (history, params).  ``init_params``:
    an npz of reference weights (``convert.params_from_npz``)."""
    engine = TrainEngine(
        arch, reduced=reduced, kernel=kernel, device=device,
        mesh_model=mesh_model, mesh_data=mesh_data, scheme=scheme,
        impl=impl, init_params=(None if init_params is None
                     else params_from_npz(init_params, device="cpu")),
        config=EngineConfig(
            steps=steps, batch=batch, seq_len=seq_len, rollout=rollout, lr=lr,
            log_every=log_every, seed=seed, precision=precision,
            metrics_out=metrics_out, metrics_format=metrics_format,
            trace=trace, telemetry=telemetry, pipeline=pipeline,
            prefetch=prefetch, accum=accum, eval_every=eval_every,
            zero1=zero1, ckpt=ckpt, ckpt_every=ckpt_every,
            keep_ckpts=keep_ckpts, resume=resume, async_save=async_save,
            preemption=preemption, preempt_at_step=preempt_at_step))
    try:
        history = engine.run()
    except BaseException:
        engine.close(collective=False)    # the peers may be elsewhere
        raise
    engine.close()
    return history, engine.params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="weathermixer-1b", choices=ARCH_IDS,
                    help="any id of configs/registry.py")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128,
                    help="tokens per row (the language models)")
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
                    help="Chrome trace-event export path (load in "
                         "Perfetto); a sibling .jsonl gets the per-step "
                         "mfu/comm_fraction records for "
                         "launch/trace_report.py")
    ap.add_argument("--no-telemetry", action="store_true",
                    help="disable span tracing (counters stay live)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pipeline", default="sharded",
                    choices=["sharded", "sync-full"],
                    help="input read mode: sharded = each rank reads its "
                         "block; sync-full = every rank makes the whole "
                         "batch (the same blocks)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="model-parallel ranks (p for --scheme 1d, q*q for "
                         "2d), one process each")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="data-parallel copies of the model mesh (the run "
                         "takes mesh-model x mesh-data processes)")
    ap.add_argument("--zero1", action="store_true",
                    help="ZeRO-1: shard the optimizer state (moments, "
                         "masters) over the data axis")
    ap.add_argument("--scheme", default=None, choices=["1d", "2d", "none"],
                    help="Jigsaw scheme on a mesh (default: the config's)")
    ap.add_argument("--impl", default=None,
                    choices=["ring", "ring_chunked", "ring_fused", "rs",
                             "allreduce"],
                    help="1-D Jigsaw: how each linear's reduce-scatter "
                         "completes (default: the config's)")
    ap.add_argument("--init-params", default=None,
                    help="start from the weights in this npz (a reference "
                         "pytree saved flat, keys joined with '/')")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path prefix: periodic saves go to "
                         "<ckpt>-<step>, the final one to <ckpt>")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="save every k steps (0 = final save only)")
    ap.add_argument("--keep-ckpts", type=int, default=0,
                    help="keep only the last k periodic checkpoints "
                         "(0 = keep all; the best-eval one is spared)")
    ap.add_argument("--resume", default=None,
                    help="resume exactly from this checkpoint directory")
    ap.add_argument("--sync-save", action="store_true",
                    help="write checkpoints on the training thread "
                         "(default: a background writer)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches prefetched by the background thread "
                         "(0 = synchronous)")
    ap.add_argument("--accum", type=int, default=1,
                    help="microbatch gradient-accumulation factor")
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--supervise", action="store_true",
                    help="run under the relaunch Supervisor: restart on "
                         "resumable exits and crashes, resuming from the "
                         "latest complete checkpoint (needs --ckpt; on a "
                         "mesh it launches the ranks itself)")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="relaunch budget under --supervise")
    args = ap.parse_args(argv)
    if args.supervise:
        if not args.ckpt:
            ap.error("--supervise requires --ckpt (the supervisor "
                     "discovers resume points under its directory)")
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            ap.error("--supervise launches the ranks itself: run it once, "
                     "not under torch.distributed.run")
        sys.exit(resilience.supervise_train_cli(
            args, sys.argv[1:] if argv is None else argv))
    code = 0
    try:
        train(args.arch, steps=args.steps, batch=args.batch,
              seq_len=args.seq_len, reduced=not args.full, kernel=args.kernel,
              precision=args.precision, rollout=args.rollout, lr=args.lr,
              log_every=args.log_every, seed=args.seed,
              metrics_out=args.metrics_out,
              metrics_format=args.metrics_format, trace=args.trace,
              telemetry=not args.no_telemetry, pipeline=args.pipeline,
              prefetch=args.prefetch, accum=args.accum,
              eval_every=args.eval_every, device=args.device,
              mesh_model=args.mesh_model, mesh_data=args.mesh_data,
              scheme=args.scheme, impl=args.impl, init_params=args.init_params,
              zero1=args.zero1, ckpt=args.ckpt, ckpt_every=args.ckpt_every,
              keep_ckpts=args.keep_ckpts, resume=args.resume,
              async_save=not args.sync_save, preemption=True)
    except resilience.Preempted as p:
        print(f"[train] {p}; exiting resumable "
              f"({resilience.RESUMABLE_EXIT_CODE})")
        code = resilience.RESUMABLE_EXIT_CODE
    if dist.is_initialized():
        # every rank finished or stopped after the same step: leave the
        # process group together, before the interpreter tears down
        # gloo's threads (a rank exiting beside a peer's last collective
        # can abort, turning 0 or 75 into a crash)
        dist.barrier()
        dist.destroy_process_group()
    sys.exit(code)


if __name__ == "__main__":
    main()
