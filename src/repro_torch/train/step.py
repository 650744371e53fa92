"""Train-step builders on one device: loss -> grad -> clip -> Adam (the
port's copy of the mixer half of ``repro/train/step.py``).

Autograd takes the place of ``jax.value_and_grad``: the step runs the
forward on detached views of the parameters that require grad (no copy),
and ``torch.autograd.grad`` returns the gradients in the parameters'
dtypes, as JAX does.  The optimizer then updates the parameters in place.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree as ptree
from repro_torch.core.api import JigsawConfig
from repro_torch.models import registry as M
from repro_torch.optim import adam, schedule as sched
from repro_torch.train import loss as losses


def loss_fn(params, batch, cfg: ModelConfig, jcfg: JigsawConfig,
            rollout: int = 1):
    """Returns (scalar loss, metrics dict).  Level weights apply from 69
    channels on (the full ERA5 variable set)."""
    if cfg.family != "mixer":
        raise NotImplementedError(
            f"the port trains the mixer family only; {cfg.arch_id} is "
            f"{cfg.family!r} (ROADMAP.md, queue 1 item 14: model zoo)")
    pred, _ = M.apply(params, batch, cfg, jcfg, rollout=rollout)
    lat_w = losses.latitude_weights(cfg.wm_lat, device=pred.device)
    chan_w = (losses.pressure_level_weights(cfg.wm_channels,
                                            device=pred.device)
              if cfg.wm_channels >= 69 else None)
    main = losses.weighted_mse(pred, batch["target"], lat_w, chan_w)
    return main, {"loss": main, "mse": main}


def value_and_grad(params, batch, cfg: ModelConfig, jcfg: JigsawConfig,
                   rollout: int = 1):
    """(metrics, grads): the metrics detached, the grads a tree of the
    params' structure and dtypes."""
    flat = ptree.leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(ptree.unflatten(params, live), batch, cfg,
                                jcfg, rollout)
        grads = torch.autograd.grad(loss, live)
    return ({k: v.detach() for k, v in metrics.items()},
            ptree.unflatten(params, grads))


def make_train_step(cfg: ModelConfig, jcfg: JigsawConfig,
                    adam_cfg: adam.AdamConfig = adam.AdamConfig(),
                    lr_fn: Callable = None, rollout: int = 1,
                    accum: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); params and opt_state are updated in place.

    ``rollout`` > 1 runs the processor ``rollout`` times per update (the
    paper's randomized-rollout fine-tuning).  ``accum`` > 1 splits the
    batch's leading dim into ``accum`` consecutive microbatches run one
    after the other; their gradients are summed in f32 and divided by
    ``accum`` before one update, and the metrics are their mean.
    """
    lr_fn = lr_fn or partial(sched.warmup_cosine)

    def apply_update(params, opt_state, grads, metrics):
        lr = lr_fn(opt_state["step"])
        # the norm of the unclipped grads: reported, and the clip's input
        norm = adam.global_norm(grads)
        params, opt_state = adam.update(params, grads, opt_state, lr,
                                        adam_cfg, norm=norm)
        return params, opt_state, dict(metrics, lr=lr, grad_norm=norm)

    if accum == 1:
        def train_step(params, opt_state, batch):
            metrics, grads = value_and_grad(params, batch, cfg, jcfg,
                                            rollout)
            return apply_update(params, opt_state, grads, metrics)
        return train_step

    def train_step(params, opt_state, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % accum != 0:
            raise ValueError(
                f"batch dim {rows} not divisible by accum={accum}")
        mb = rows // accum
        gsum, stacked = None, []
        for i in range(accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            metrics, grads = value_and_grad(params, micro, cfg, jcfg,
                                            rollout)
            if gsum is None:
                gsum = ptree.map(lambda g: g.to(torch.float32, copy=True),
                                 grads)
            else:
                ptree.map(lambda a, g: a.add_(g.float()), gsum, grads)
            stacked.append(metrics)
            del grads
        grads = ptree.map(lambda g: g.div_(accum), gsum)
        metrics = {k: torch.stack([m[k] for m in stacked]).mean()
                   for k in stacked[0]}
        return apply_update(params, opt_state, grads, metrics)

    return train_step


def make_eval_step(cfg: ModelConfig, jcfg: JigsawConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params, batch, cfg, jcfg)
        return metrics
    return eval_step
