"""Train steps: loss -> grad -> clip -> Adam (the port's copy of
the mixer half of ``repro/train/step.py``), on one device or on the
shards of a 2-D Jigsaw mesh.

Autograd takes the place of ``jax.value_and_grad``: the step runs the
forward on detached views of the parameters that require grad (no copy),
and ``torch.autograd.grad`` returns the gradients in the parameters'
dtypes, as JAX does.  The optimizer then updates the parameters in place.

On a mesh (``scheme="1d"`` or ``"2d"``, ``jcfg.mesh``) each rank
differentiates its part of the loss.  A weight block belongs to one rank,
and its gradient (gathered back through the collectives' backward) stays
local.  A leaf replicated over some model axes (under 2-D biases over the
axis their block is not cut along; LayerNorm parameters and ``blend``
under both) gets its gradient summed over the ranks that share it, in
f32, so every copy takes the same update and stays bitwise equal.  The
gradient norm counts each logical element once: one rank of each replica
group counts the leaf, and the partial sums are all-reduced over the
model ranks.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core import tree as ptree
from repro_torch.core.api import JigsawConfig
from repro_torch.core.sharding import replicated_axes
from repro_torch.models import registry as M
from repro_torch.optim import adam, schedule as sched
from repro_torch.train import loss as losses


def loss_fn(params, batch, cfg: ModelConfig, jcfg: JigsawConfig,
            rollout: int = 1):
    """Returns (objective, metrics dict): the scalar to differentiate, and
    the loss.  Level weights apply from 69 channels on (the full ERA5
    variable set).  Under ``scheme="1d"`` / ``"2d"`` the objective is this
    rank's part, the weighted squared error of its block over the whole field's
    element count: the parts of all ranks sum to the loss, so the
    gradients, summed through the collectives' backward, are the loss's.
    The metrics carry the whole loss (the parts all-reduced), the same on
    every rank."""
    if cfg.family != "mixer":
        raise NotImplementedError(
            f"the port trains the mixer family only; {cfg.arch_id} is "
            f"{cfg.family!r} (ROADMAP.md, queue 1 item 14: model zoo)")
    pred, _ = M.apply(params, batch, cfg, jcfg, rollout=rollout)
    lat_w = losses.latitude_weights(cfg.wm_lat, device=pred.device)
    chan_w = (losses.pressure_level_weights(cfg.wm_channels,
                                            device=pred.device)
              if cfg.wm_channels >= 69 else None)
    mesh = jcfg.rank_mesh
    if mesh is not None:
        target = M.module_for(cfg).field_block(batch["target"], cfg, jcfg)
        rows, cols = pred.shape[-2], pred.shape[-1]
        i, j = mesh.dom_index, mesh.tp_index
        lat_b, chan_b = losses.block_weights(
            lat_w, chan_w, lon=cfg.wm_lon, patch=cfg.wm_patch,
            channels=cfg.wm_channels,
            rows=range(i * rows, (i + 1) * rows),
            cols=range(j * cols, (j + 1) * cols))
        sse = losses.weighted_sse(pred, target, lat_b, chan_b)
        n = pred.shape[0] * cfg.wm_lat * cfg.wm_lon * cfg.wm_channels
        main = comm.all_reduce_(sse.detach().clone(), mesh.model_group) / n
        return sse / n, {"loss": main, "mse": main}
    main = losses.weighted_mse(pred, batch["target"], lat_w, chan_w)
    return main, {"loss": main, "mse": main}


def replica_axes(params, cfg: ModelConfig, jcfg: JigsawConfig):
    """The tree of the model axes each parameter shard is replicated over
    (``()`` for a weight block, which one rank holds), from the model's
    own layout for the scheme."""
    spec = M.module_for(cfg).PARAM_SPECS[jcfg.scheme]
    rules = jcfg.rank_mesh.rules
    return ptree.map_with_path(
        lambda path, p: replicated_axes(spec(path, p.ndim), rules), params)


def _norm_args(params, cfg: ModelConfig, jcfg: JigsawConfig):
    """``global_norm``'s arguments for a tree of shards: the rank at
    coordinate 0 of every axis a leaf is replicated over counts it."""
    mesh = jcfg.rank_mesh
    if mesh is None or mesh.model_group is None:
        return {}
    owned = ptree.map(lambda axes: all(mesh.coord(a) == 0 for a in axes),
                      replica_axes(params, cfg, jcfg))
    return {"owned": owned, "group": mesh.model_group}


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
    mesh = jcfg.rank_mesh
    if mesh is not None and mesh.model_group is not None:
        for g, axes in zip(grads, ptree.leaves(replica_axes(params, cfg,
                                                            jcfg))):
            comm.all_reduce_(g, mesh.group(axes))
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
        norm = adam.global_norm(grads, **_norm_args(params, cfg, jcfg))
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
