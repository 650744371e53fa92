"""Train steps: loss -> grad -> clip -> Adam (the port of
``repro/train/step.py``), on one device or on the shards of a 1-D or 2-D
Jigsaw mesh with a data axis.

The loss is the family's: the weather loss for the mixer, and for the
language models (dense, VLM, moe, audio, ssm, hybrid) the next-token
cross-entropy plus ``AUX_WEIGHT`` times the MoE load-balance loss.  A
language model trains on one device, on a data-only mesh (``jcfg.mesh``
a ``Mesh1D`` of one model rank under ``scheme="none"``: every rank holds
the whole model and its data rank's rows) or, the dense and VLM families,
on a 1-D model mesh (``scheme="1d"``: each rank its shard, the logits cut
by vocab and the loss reduced over the tp group, ``losses.lm_nll_sharded``).

Autograd takes the place of ``jax.value_and_grad``: the step runs the
forward on detached views of the parameters that require grad (no copy),
and ``torch.autograd.grad`` returns the gradients in the parameters'
dtypes, as JAX does.  The optimizer then updates the parameters in place.

On a mesh (``scheme="1d"`` or ``"2d"``, ``jcfg.mesh``) each rank
differentiates its part of the loss: its model block of its data rank's
rows.  A weight block belongs to one rank of its model group, and its
gradient (gathered back through the collectives' backward) stays local
there.  A leaf replicated over some axes (under 2-D biases over the model
axis their block is not cut along; LayerNorm parameters and ``blend``
under both; every leaf over the data axis, but the FSDP hybrid's weights)
gets its gradient summed over the ranks that share it, in f32, so every
copy takes the same update and stays bitwise equal.  The gradient norm
counts each logical element once: one rank of each replica group counts
the leaf, and the partial sums are reduced over every rank.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core import tree as ptree
from repro_torch.core.api import JigsawConfig
from repro_torch.core.sharding import (DATA_AXIS, entry_axes,
                                      replicated_axes, spec_axes)
from repro_torch.models import registry as M
from repro_torch.optim import adam, schedule as sched
from repro_torch.train import loss as losses

AUX_WEIGHT = 0.01   # MoE load-balance loss weight


def train_mesh(cfg: ModelConfig, jcfg: JigsawConfig):
    """The mesh the step reduces over: the mixer's Jigsaw mesh
    (``jcfg.rank_mesh``), a language model's mesh (``jcfg.mesh``: data-only
    under ``scheme="none"``, a 1-D model mesh under ``"1d"``), or None on
    one device."""
    return jcfg.rank_mesh if cfg.family == "mixer" else jcfg.mesh


def lm_loss_fn(params, batch, cfg: ModelConfig, jcfg: JigsawConfig):
    """The language models' (objective, metrics): ``lm_cross_entropy`` of
    the logits (the VLM's last ``labels.shape[1]`` positions: text only)
    plus ``AUX_WEIGHT`` times the aux loss; metrics {"loss", "nll",
    "aux"}.  On a data mesh the objective is this rank's part: its NLL sum
    over the token (or mask) count of all ranks, and its aux over the
    data extent, so that the parts sum to the loss; the metrics are the
    sums of the parts.  On a 1-D model mesh every rank of a model group
    holds the same NLL of its rows (``losses.lm_nll_sharded``, whose
    gradient reaches only the rank's vocab block), so the counts and the
    metrics are summed over the data group alone."""
    logits, aux = M.apply(params, batch, cfg, jcfg)
    labels = batch["labels"]
    if cfg.family == "vlm":
        logits = logits[:, -labels.shape[1]:]
    mask = batch.get("mask")
    mesh = train_mesh(cfg, jcfg)
    if mesh is None or mesh.mesh_group is None:
        nll = losses.lm_cross_entropy(logits, labels, cfg.vocab_size,
                                      mask=mask)
        total = nll + AUX_WEIGHT * aux
        return total, {"loss": total, "nll": nll, "aux": aux}
    if jcfg.scheme == "1d":
        group = mesh.data_group
        per = losses.lm_nll_sharded(logits, labels, cfg.vocab_size, mesh)
    else:
        group = mesh.mesh_group
        per = losses.lm_nll(logits, labels, cfg.vocab_size)
    w = torch.ones_like(per) if mask is None else mask.float()
    count = comm.all_reduce_(w.sum().detach(), group)
    nll = (per * w).sum() / torch.clamp(count, min=1.0)
    aux = aux / mesh.data_size
    sums = comm.all_reduce_(torch.stack([nll, aux]).detach(), group)
    return nll + AUX_WEIGHT * aux, {
        "loss": sums[0] + AUX_WEIGHT * sums[1], "nll": sums[0],
        "aux": sums[1]}


def loss_fn(params, batch, cfg: ModelConfig, jcfg: JigsawConfig,
            rollout: int = 1):
    """Returns (objective, metrics dict): the scalar to differentiate, and
    the loss.  The language models' is ``lm_loss_fn``.  The mixer's: level
    weights apply from 69 channels on (the full ERA5 variable set).  Under ``scheme="1d"`` / ``"2d"`` the objective is this
    rank's part, the weighted squared error of its block over the element
    count of the whole global batch (its rows times the data extent: where
    the batch is cut over data, the global batch's count; where every data
    rank holds it whole, that count times the data extent): the parts of
    all ranks sum to the loss, so the gradients, summed through the
    collectives' backward and over the data axis, are the loss's.  The
    metrics carry the whole loss (the parts all-reduced over every rank),
    the same on every rank."""
    if cfg.family != "mixer":
        return lm_loss_fn(params, batch, cfg, jcfg)
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
        n = (pred.shape[0] * mesh.data_size * cfg.wm_lat * cfg.wm_lon
             * cfg.wm_channels)
        main = comm.all_reduce_(sse.detach().clone(), mesh.mesh_group) / n
        return sse / n, {"loss": main, "mse": main}
    main = losses.weighted_mse(pred, batch["target"], lat_w, chan_w)
    return main, {"loss": main, "mse": main}


def leaf_specs(params, cfg: ModelConfig, jcfg: JigsawConfig, specs=None):
    """The spec of each parameter shard: ``specs`` (the sanitized
    ``launch/specs.py::param_specs`` the shards were cut by) or, when None,
    the model's own layout for the scheme (a language model's leaves are
    whole on every rank but under ``scheme="1d"``).  The FSDP hybrid's
    layout depends on the whole shapes, so a data mesh under it needs
    ``specs``."""
    if specs is not None:
        return specs
    if cfg.family != "mixer" and jcfg.scheme != "1d":
        return ptree.map(lambda p: (None,) * p.ndim, params)
    if jcfg.fsdp and jcfg.rank_mesh.data_size > 1:
        raise ValueError("the FSDP hybrid's layout needs the shards' specs "
                         "(launch/specs.py::param_specs, sanitized)")
    spec = M.module_for(cfg).PARAM_SPECS[jcfg.scheme]
    return ptree.map_with_path(lambda path, p: spec(path, p.ndim), params)


def replica_axes(params, cfg: ModelConfig, jcfg: JigsawConfig, specs=None):
    """The tree of the mesh axes (model and data) each parameter shard is
    replicated over (``()`` for a weight block that one rank holds and,
    under the FSDP hybrid, cuts over data too)."""
    mesh = train_mesh(cfg, jcfg)
    return ptree.map(lambda sp: replicated_axes(sp, mesh),
                     leaf_specs(params, cfg, jcfg, specs))


def _norm_args(params, cfg: ModelConfig, jcfg: JigsawConfig, specs=None):
    """``global_norm``'s arguments for a tree of shards: the rank at
    coordinate 0 of every axis a leaf is replicated over counts it, and
    the partial sums are reduced over every rank of the mesh.  With more
    than one data rank each leaf's squares are summed in ``data`` pieces
    along the dim the FSDP hybrid cuts (its first dim the data extent
    divides), whoever holds them, so that the norm's bits do not depend on
    the layout (``adam.global_norm``'s ``pieces``).  A language model's
    leaves are never cut over data: data rank 0 counts each whole, in the
    one-device order, so the norm is the one device's bit for bit."""
    mesh = train_mesh(cfg, jcfg)
    if mesh is None or mesh.mesh_group is None:
        return {}
    specs = leaf_specs(params, cfg, jcfg, specs)
    owned = ptree.map(lambda sp: all(mesh.coord(a) == 0 for a in
                                     replicated_axes(sp, mesh)), specs)
    if mesh.data_size == 1:
        return {"owned": owned, "group": mesh.model_group}
    if cfg.family != "mixer":
        return {"owned": owned, "group": mesh.mesh_group}
    n = mesh.data_size

    def piece(p, sp):
        if DATA_AXIS in spec_axes(sp):
            return next(d for d, e in enumerate(sp)
                        if DATA_AXIS in entry_axes(e)), mesh.data_index
        return next((d for d, s in enumerate(p.shape) if s % n == 0),
                    None), None
    return {"owned": owned, "group": mesh.mesh_group,
            "pieces": ptree.map(piece, params, specs), "data": n}


def value_and_grad(params, batch, cfg: ModelConfig, jcfg: JigsawConfig,
                   rollout: int = 1, specs=None):
    """(metrics, grads): the metrics detached, the grads a tree of the
    params' structure and dtypes.  On a mesh each gradient is summed over
    the model axes its leaf is replicated over, then over the data axis
    (in f32, rounded once), unless the leaf is cut over data (the FSDP
    hybrid, whose gather's backward summed it already); ``specs`` as
    ``leaf_specs`` takes them."""
    flat = ptree.leaves(params)
    live = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss, metrics = loss_fn(ptree.unflatten(params, live), batch, cfg,
                                jcfg, rollout)
        grads = torch.autograd.grad(loss, live)
    mesh = train_mesh(cfg, jcfg)
    if mesh is not None and mesh.mesh_group is not None:
        for g, axes in zip(grads, ptree.leaves(
                replica_axes(params, cfg, jcfg, specs))):
            comm.all_reduce_(
                g, mesh.group([a for a in axes if a != DATA_AXIS]),
                mesh.group([a for a in axes if a == DATA_AXIS]))
    return ({k: v.detach() for k, v in metrics.items()},
            ptree.unflatten(params, grads))


def make_train_step(cfg: ModelConfig, jcfg: JigsawConfig,
                    adam_cfg: adam.AdamConfig = adam.AdamConfig(),
                    lr_fn: Callable = None, rollout: int = 1,
                    accum: int = 1, specs=None, zero1=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics); params and opt_state are updated in place.

    ``rollout`` > 1 runs the processor ``rollout`` times per update (the
    paper's randomized-rollout fine-tuning).  ``accum`` > 1 splits the
    batch's leading dim (on a mesh, of the rank's block) into ``accum``
    consecutive microbatches run one after the other; their gradients are
    summed in f32 and divided by ``accum`` before one update, and the
    metrics are their mean.  ``specs``: the shards' specs (``leaf_specs``);
    ``zero1``: ``adam.Zero1``, the optimizer state's cut over the data
    axis (``opt_state`` made by ``adam.init`` with the same).
    """
    lr_fn = lr_fn or partial(sched.warmup_cosine)

    def apply_update(params, opt_state, grads, metrics):
        lr = lr_fn(opt_state["step"])
        # the norm of the unclipped grads, before ZeRO-1 takes its slices:
        # reported, and the clip's input
        norm = adam.global_norm(grads,
                                **_norm_args(params, cfg, jcfg, specs))
        params, opt_state = adam.update(params, grads, opt_state, lr,
                                        adam_cfg, norm=norm, zero1=zero1)
        return params, opt_state, dict(metrics, lr=lr, grad_norm=norm)

    if accum == 1:
        def train_step(params, opt_state, batch):
            metrics, grads = value_and_grad(params, batch, cfg, jcfg,
                                            rollout, specs)
            return apply_update(params, opt_state, grads, metrics)
        return train_step

    def train_step(params, opt_state, batch):
        if cfg.family == "mixer" and jcfg.rank_mesh is not None:
            # the rank's block first (a whole batch from "sync-full"), so
            # that both read modes split the same rows into microbatches
            batch = {k: M.module_for(cfg).field_block(v, cfg, jcfg)
                     for k, v in batch.items()}
        rows = next(iter(batch.values())).shape[0]
        if rows % accum != 0:
            raise ValueError(
                f"batch dim {rows} not divisible by accum={accum}")
        mb = rows // accum
        gsum, stacked = None, []
        for i in range(accum):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            metrics, grads = value_and_grad(params, micro, cfg, jcfg,
                                            rollout, specs)
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
