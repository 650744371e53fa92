"""Specs of the parameters, the optimizer state and the input batch on a
mesh (the port of ``repro/launch/specs.py``), as the port's ``Spec``
tuples: one entry per dim, an axis, a tuple of axes or None.

``mesh`` is anything with a ``shape`` mapping of axis -> extent (the
port's ``Mesh``/``Mesh1D``, or a plain object standing for the reference's
mesh), so nothing here needs a process group.  The reference lets GSPMD
place each array from its spec; the port has no GSPMD, so the specs
describe exactly the blocks the port's ranks hold: ``param_specs``
(sanitized) those that ``convert.shard_params_1d`` / ``_2d`` cut,
``block_specs`` the block of the patchified fields a rank reads
(``data/pipeline.py``), and ``zero1_dims`` where ZeRO-1 cuts a leaf's
optimizer state.  ``state_spec`` places the forecast engine's state
buffer of a batch bucket on the serving mesh (``serve/engine.py``), and
``cache_specs`` a language model's decode cache on a (data, model=p)
mesh (sanitized: the blocks ``init_cache`` makes and
``convert.shard_cache_1d`` cuts).
A language model of any family takes the reference's 1-D layout
(``models/transformer.py::param_spec_1d``) on a (data, model=p) mesh; on
a data-only mesh its parameters stay whole on every rank.  Those specs,
sanitized, are also the layout its checkpoints are written and restored
in (``TrainEngine._ckpt_specs``, ``checkpoint.restore_serving_params(
specs=)``).  What raises (``check_lm_mesh``): NotImplementedError,
naming ROADMAP.md queue 1 item 19, for the FSDP hybrid's cut of a
language model over more than one data rank (item 19.3) and for a
language model on a 2-D model mesh; ValueError for a model extent that
does not divide a dim the layout cuts.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import tree as ptree
from repro_torch.core.sharding import (DATA_AXIS, ShardingRules, Spec,
                                      entry_axes, sanitize_spec, spec_axes)
from repro_torch.models import layers as L
from repro_torch.models import transformer, weathermixer
from repro_torch.models.registry import check_lm_mesh

__all__ = ["param_specs", "opt_specs", "batch_specs", "block_specs",
           "cache_specs", "check_lm_mesh", "sanitize_spec", "sanitize_tree",
           "state_spec", "zero1_dims"]


def param_specs(params, cfg: ModelConfig, rules: ShardingRules):
    """The spec tree of ``params`` (tensors, arrays or shape structs; the
    port's per-block list or the reference's stacked blocks): the model's
    layout for the scheme (``weathermixer.PARAM_SPECS``) and, under 1-D
    with ``cfg.shard_params_over_data``, every weight's out dim on the data
    axis too (the FSDP hybrid; the reference's 2-D rule has no data
    entry).  Leading stacked dims stay whole.  A language model (every
    family) takes the reference's 1-D rule under 1-D rules
    (``transformer.param_spec_1d``: contracting dims, the head's and the
    table's vocab, the expert stacks' expert dim, ``conv_w``'s and
    ``dec_pos``' last dim on the model axis) without its FSDP data
    entries: the FSDP hybrid's cut of a language model over more than one
    data rank is refused by ``check_lm_mesh``, which the callers run on
    their mesh, as it refuses a 2-D model mesh (under 2-D rules a language
    model's leaves are whole, its data-only mesh's layout)."""
    if cfg.family != "mixer":
        if rules.is_2d:
            return ptree.map(lambda a: (None,) * np.ndim(a), params)
        return ptree.map_with_path(
            lambda path, a: transformer.param_spec_1d(path, np.ndim(a)),
            params)
    if rules.is_2d:
        return ptree.map_with_path(
            lambda path, a: weathermixer.param_spec_2d(path, a.ndim), params)
    fsdp = cfg.shard_params_over_data
    return ptree.map_with_path(
        lambda path, a: weathermixer.param_spec_1d(path, a.ndim, fsdp),
        params)


def opt_specs(moments, pspecs, zero1_axis: Optional[str] = None,
              mesh=None, master: bool = False):
    """The optimizer state's specs: the moments (and, with ``master``, the
    f32 masters) take their parameters' specs; ``step`` is replicated.

    ``zero1_axis`` (ZeRO-1): every moment also takes that axis on its
    first unsharded dim (``moments``' leaves give the shapes).  With
    ``mesh`` the choice is shape-aware: a dim the axis extent does not
    divide is skipped."""
    extent = mesh.shape[zero1_axis] if (mesh is not None and zero1_axis) \
        else None

    def z1(spec: Spec, shape) -> Spec:
        if zero1_axis is None:
            return spec
        dims = list(spec) + [None] * (len(shape) - len(spec))
        if zero1_axis in spec_axes(dims):
            return tuple(dims)
        for i, entry in enumerate(dims):
            if entry is not None:
                continue
            if extent is not None and shape[i] % extent != 0:
                continue
            dims[i] = zero1_axis
            break
        return tuple(dims)

    mspecs = ptree.map(lambda leaf, sp: z1(sp, np.shape(leaf)), moments,
                       pspecs)
    out = {"step": (), "mu": mspecs, "nu": mspecs}
    if master:
        out["master"] = mspecs
    return out


def batch_specs(cfg: ModelConfig, rules: ShardingRules) -> Dict[str, Spec]:
    """The specs of the batch's keys.  The mixer's over the grid [B, lat,
    lon, C]: the batch dim over the batch axes, and the sample itself cut
    (paper §5): lon on mdom and C on mtp under 2-D, C on the model axis
    under 1-D.  A language model's: the rows of ``tokens`` and ``labels``
    over the batch axes, and the VLM's ``embeds`` and the audio family's
    ``frames`` [B, n, D] with D on the feature axis, as the reference's."""
    if cfg.family != "mixer":
        rows = (rules.batch_axes, None)
        out = {"tokens": rows, "labels": rows}
        if cfg.family == "vlm":
            out["embeds"] = rows + (rules.tp_axis,)
        if cfg.family == "audio":
            out["frames"] = rows + (rules.tp_axis,)
        return out
    if rules.is_2d:
        fields = (rules.batch_axes, None, rules.dom_axis, rules.tp_axis)
    else:
        fields = (rules.batch_axes, None, None, rules.tp_axis)
    return {"fields": fields, "target": fields}


def block_specs(cfg: ModelConfig, rules: ShardingRules) -> Dict[str, Spec]:
    """The spec of each batch key's block as the port's ranks read it: the
    patchified fields [B, T, p*p*C] cut as the activations are (the batch
    dim over the batch axes, the tokens over mdom under 2-D, the patch dim
    over the feature axis; ``weathermixer.field_block``).  The reference
    cuts the grid by ``batch_specs`` and lets GSPMD reshard it into this
    layout; the port has no GSPMD, so a rank reads this block instead, the
    same bytes per rank and no collective.  A language model's blocks are
    its ``batch_specs``."""
    if cfg.family != "mixer":
        return batch_specs(cfg, rules)
    return {k: rules.act(3, domain_dim=1) for k in batch_specs(cfg, rules)}


def cache_specs(cache, cfg: ModelConfig, rules: ShardingRules, mesh):
    """The spec tree of a decode cache (a whole cache of any language
    model family: tensors, arrays or shape structs, flat or the hybrid's
    nested slots), unsanitized, as the reference's ``cache_specs``: each
    leaf by ``layers.cache_spec`` on the mesh's extent of the tp axis (the
    kv heads, the sequence or head_dim of the attention caches, the SSM
    state's heads, the conv window's channels, "enc"'s D; the batch over
    the batch axes; "pos" whole).  ``sanitize_tree`` then leaves whole
    every dim the mesh does not divide."""
    p = mesh.shape.get(rules.tp_axis, 1)
    return ptree.map_with_path(
        lambda path, a: L.cache_spec(path[-1], np.ndim(a), cfg, p,
                                     rules.tp_axis, rules.batch_axes),
        cache)


def state_spec(b: int, mesh, ndim: int = 4) -> Spec:
    """The spec of a serving bucket's state [b, lat, lon, C] on a data-only
    mesh: its rows cut over the data axis where the axis' extent divides
    ``b``, else whole on every rank (the reference's ``sanitize_spec`` of
    ``P("data")``, as its engine's ``_state_sharding``)."""
    return sanitize_spec((b,) + (1,) * (ndim - 1), (DATA_AXIS,), mesh)


def sanitize_tree(shapes_tree, spec_tree, mesh):
    """``sanitize_spec`` of every leaf (``shapes_tree``'s leaves: anything
    ``np.shape`` reads, a Python number among them)."""
    return ptree.map(lambda s, sp: sanitize_spec(np.shape(s), sp, mesh),
                     shapes_tree, spec_tree)


def zero1_dims(params, pspecs, mesh):
    """The dim of each leaf's optimizer state that ZeRO-1 cuts over the
    data axis (None: the state stays whole on every data rank), from the
    whole ``params`` and their sanitized specs: ``opt_specs``' rule, then
    ``sanitize_spec``.  An axis of extent 1 cuts nothing, so its entries
    count as unsharded here: at (data 2, 1x1) a 2-D weight's moments are
    cut too, where the reference's rule (every dim of the Cannon layout
    named) finds no free dim.  A leaf whose parameter is already cut over
    data (the FSDP hybrid) needs no more."""
    def live(spec):
        return tuple(e if any(mesh.shape[a] > 1 for a in entry_axes(e))
                     else None for e in spec)

    live_specs = ptree.map(live, pspecs)
    mspecs = sanitize_tree(params, opt_specs(params, live_specs, DATA_AXIS,
                                             mesh)["mu"], mesh)

    def dim(pspec, mspec):
        if DATA_AXIS in spec_axes(pspec) or DATA_AXIS not in spec_axes(mspec):
            return None
        return next(d for d, e in enumerate(mspec)
                    if DATA_AXIS in entry_axes(e))
    return ptree.map(dim, pspecs, mspecs)
