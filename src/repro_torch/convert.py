"""Weight carry-over between the JAX package and the port.

The reference keeps a model's parameters as a pytree of arrays whose
layers are stacked on a leading layer dim: WeatherMixer's ``"blocks"``,
the language models' ``"layers"``, the hybrid's ``"periods"``, the
enc-dec's ``"enc_layers"`` and ``"dec_layers"``; the port keeps a list of
per-layer (per-period) dicts there.
Both functions go through numpy, so neither package imports the other:

  ``params_from_numpy(tree)``  reference pytree (numpy leaves) -> port;
  ``params_to_numpy(params)``  port -> reference pytree (numpy leaves);
  ``shard_params_2d(tree, i, j, q)``  a whole parameter tree (the
      reference's numpy pytree or the port's tensors) -> rank (i, j)'s
      shard on a q x q 2-D Jigsaw mesh (WeatherMixer's 2-D layout,
      ``models/weathermixer.py::param_spec_2d``);
  ``gather_params_2d(shards, q)``  every rank's shard -> the whole tree,
      bit for bit;
  ``shard_params_1d(tree, r, p, d, data, fsdp, spec)`` /
      ``gather_params_1d(shards, p, data, fsdp, spec)``  the same for rank
      (d, r) of a (data, model=p) 1-D Jigsaw mesh (WeatherMixer's
      ``param_spec_1d``: every ``w`` cut along its contracting dim, and
      under the FSDP hybrid its out dim over data; every ``b`` along its
      out dim; or the caller's leaf rule ``spec``, such as a language
      model's ``models/transformer.py::param_spec_1d``);
  ``param_bounds(path, shape, mesh, fsdp, spec)``  the [start, stop) bounds
      of each dim of a rank's shard in the whole leaf: the inverse of
      ``shard_params_1d`` / ``_2d`` (``whole[bounds]`` is the shard), what
      a sharded checkpoint records of each rank's block
      (``block_bounds`` under any spec);
  ``params_from_npz(path)``  a reference pytree saved flat with
      ``np.savez`` under "/"-joined keys ("blocks/tok_fc1/w") -> port;
  ``shard_cache_1d(cache, cfg, mesh)`` / ``gather_cache_1d(blocks, cfg,
      mesh)``  the same for a language model's decode cache: a whole
      cache (numpy or tensors) -> the rank's block on a 1-D mesh (the
      reference's ``cache_specs``, sanitized; a ``CacheBlock``), and the
      ranks' blocks -> the whole cache, bit for bit.

bf16 travels as its uint16 bits, with no float round trip.  numpy has no
bfloat16 of its own: a reference leaf arrives as an ``ml_dtypes.bfloat16``
array (recognised by its dtype name; this module does not import
ml_dtypes), and ``params_to_numpy`` hands bf16 back as uint16 bits, viewed
as ``bf16_dtype`` when the caller passes one.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import tree as ptree
from repro_torch.core.sharding import (DATA_AXIS, MDOM_AXIS, MODEL_AXIS,
                                      Mesh, Mesh1D, Spec, block_range,
                                      sanitize_spec)
from repro_torch.models.layers import CacheBlock, sanitized_cache_specs
from repro_torch.models.weathermixer import param_spec_1d, param_spec_2d


# the entries of a parameter tree whose layers the reference stacks
STACKED = ("blocks", "layers", "periods", "enc_layers", "dec_layers")


def _rule_1d(spec, fsdp: bool):
    """The 1-D leaf rule ``(path, ndim) -> Spec``: the caller's ``spec``
    (a language model's, ``transformer.param_spec_1d``), else
    WeatherMixer's under ``fsdp``."""
    if spec is not None:
        return spec
    return lambda path, ndim: param_spec_1d(path, ndim, fsdp)


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor, bf16_dtype: Optional[Any]) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits if bf16_dtype is None else bits.view(bf16_dtype)
    return t.numpy()


def params_from_numpy(tree, device="cuda"):
    """Reference pytree (numpy leaves) -> the port's params on ``device``
    (the card unless the caller asks for the CPU); each stacked entry
    (``STACKED``) is split into a list."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("params_from_numpy: CUDA is not available; pass "
                           "device='cpu' to convert onto the CPU")
    out = {k: ptree.map(lambda a: _to_tensor(a, device), v)
           for k, v in tree.items() if k not in STACKED}
    for k in STACKED:
        if k in tree:
            stacked = ptree.map(lambda a: _to_tensor(a, device), tree[k])
            n_layers = len(ptree.leaves(stacked)[0])
            out[k] = [ptree.map(lambda t, i=i: t[i].clone(), stacked)
                      for i in range(n_layers)]
    return out


def params_from_npz(path, device="cuda"):
    """``params_from_numpy`` of the reference pytree saved flat in ``path``
    (keys joined with "/")."""
    tree: dict = {}
    with np.load(path) as f:
        for key in f.files:
            *outer, leaf = key.split("/")
            node = tree
            for k in outer:
                node = node.setdefault(k, {})
            node[leaf] = f[key]
    return params_from_numpy(tree, device=device)


def params_to_numpy(params, bf16_dtype: Optional[Any] = None):
    """The port's params -> the reference's pytree layout with numpy
    leaves; the layer list is stacked on a leading layer dim."""
    out = {k: ptree.map(lambda t: _to_numpy(t, bf16_dtype), v)
           for k, v in params.items() if k not in STACKED}
    for k in STACKED:
        if k in params:
            out[k] = ptree.map(lambda *ts: np.stack(
                [_to_numpy(t, bf16_dtype) for t in ts]), *params[k])
    return out


def _own(a):
    """A block as an array of its own (not a view of the whole)."""
    return a.clone() if isinstance(a, torch.Tensor) \
        else np.ascontiguousarray(a).copy()


def shard_params_2d(tree, i: int, j: int, q: int):
    """Rank (i, j)'s shard of a whole parameter tree on a q x q mesh (i on
    mdom, j on mtp): token-mix ``w`` in (mdom, mtp) blocks, every other
    ``w`` (mtp, mdom); token-mix ``b`` on mdom, every other ``b`` on mtp;
    ``scale``, ``bias`` and ``blend`` whole.  Leaves are numpy arrays or
    tensors (the reference's stacked blocks or the port's block list); the
    shard's leaves own their memory."""
    mesh = Mesh(q=q, i=i, j=j)
    return ptree.map_with_path(
        lambda path, a: _own(mesh.block(a, param_spec_2d(path, a.ndim))),
        tree)


def gather_params_2d(shards, q: int):
    """The whole tree from the q*q shards, listed in rank order
    r = i * q + j; replicated leaves are taken from rank 0."""
    def coord(r, axis):
        return r // q if axis == MDOM_AXIS else r % q

    def gather(path, *leaves):
        named = [(d, a) for d, a in
                 enumerate(param_spec_2d(path, leaves[0].ndim)) if a]
        blocks = {}
        for r, leaf in enumerate(leaves):
            blocks.setdefault(tuple(coord(r, a) for _, a in named), leaf)

        def assemble(key):
            if len(key) == len(named):
                return blocks[key]
            parts = [assemble(key + (c,)) for c in range(q)]
            dim = named[len(key)][0]
            return (torch.cat(parts, dim) if isinstance(parts[0], torch.Tensor)
                    else np.concatenate(parts, dim))
        return _own(assemble(()))

    if len(shards) != q * q:
        raise ValueError(f"gather_params_2d: {len(shards)} shards for a "
                         f"{q}x{q} mesh")
    return ptree.map_with_path(
        lambda path, _: gather(path, *(_leaf_at(s, path) for s in shards)),
        shards[0])


def shard_params_1d(tree, r: int, p: int, d: int = 0, data: int = 1,
                    fsdp: bool = False, spec=None):
    """Rank (d, r)'s shard of a whole parameter tree on a (data, model=p)
    1-D mesh: every ``w`` cut along its contracting (last) dim and, under
    the FSDP hybrid (``fsdp``), along its out dim over the ``data`` ranks
    where their count divides it; every ``b`` along its (last) dim;
    ``scale``, ``bias`` and ``blend`` whole (``param_spec_1d``,
    sanitized), or each leaf by the caller's rule ``spec(path, ndim)``.
    Leaves are numpy arrays or tensors; the shard's leaves own their
    memory."""
    mesh = Mesh1D(p=p, r=r, data_size=data, data_index=d)
    rule = _rule_1d(spec, fsdp)

    def shard(path, a):
        return _own(mesh.block(a, sanitize_spec(a.shape, rule(path, a.ndim),
                                                mesh)))
    return ptree.map_with_path(shard, tree)


def gather_params_1d(shards, p: int, data: int = 1, fsdp: bool = False,
                     spec=None):
    """The whole tree from the data x p shards, listed in rank order
    d * p + r (cut by ``shard_params_1d`` with the same ``fsdp`` and
    ``spec``); replicated leaves are taken from rank 0.  Under ``fsdp`` a
    ``w``'s whole out dim is p times its linear's bias block (the bias is
    never cut over data), which says whether its shards were cut."""
    rule = _rule_1d(spec, fsdp)
    if len(shards) != p * data:
        raise ValueError(f"gather_params_1d: {len(shards)} shards for "
                         f"{data} x {p} ranks")

    def cat(leaves, dim):
        if isinstance(leaves[0], torch.Tensor):
            return torch.cat(leaves, dim)
        return np.concatenate(leaves, dim)

    def gather(path, *leaves):
        spec = rule(path, leaves[0].ndim)
        if DATA_AXIS in spec:
            out = p * _leaf_at(shards[0], path[:-1] + ("b",)).shape[-1]
            if out % data:
                spec = tuple(None if e == DATA_AXIS else e for e in spec)
        cut = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
        per_data = [leaves[k] if cut is None else cat(leaves[k:k + p], cut)
                    for k in range(0, len(leaves), p)]
        if DATA_AXIS in spec:
            return _own(cat(per_data, spec.index(DATA_AXIS)))
        return _own(per_data[0])

    return ptree.map_with_path(
        lambda path, _: gather(path, *(_leaf_at(s, path) for s in shards)),
        shards[0])


def block_bounds(mesh, spec: Spec, shape) -> tuple:
    """[start, stop) of each dim of the rank's block of a whole array of
    ``shape`` cut under ``spec`` (sanitized) on ``mesh``."""
    return tuple(block_range(mesh, e, n) for e, n in zip(spec, shape))


def param_bounds(path, shape, mesh, fsdp: bool = False,
                 spec=None) -> tuple:
    """The bounds in the whole parameter leaf at ``path`` (of ``shape``:
    the reference's stacked leaf or the port's per-layer one) of the
    rank's shard on ``mesh``: ``shard_params_1d``'s rule on a ``Mesh1D``
    (with the FSDP hybrid's ``fsdp``, or the caller's ``spec``),
    ``param_spec_2d`` on a ``Mesh``, sanitized.
    ``whole[tuple(slice(*b) for b in bounds)]`` is the leaf of
    ``shard_params_1d`` / ``shard_params_2d``."""
    ndim = len(shape)
    spec = (_rule_1d(spec, fsdp)(path, ndim) if isinstance(mesh, Mesh1D)
            else param_spec_2d(path, ndim))
    return block_bounds(mesh, sanitize_spec(shape, spec, mesh), shape)


def shard_cache_1d(cache, cfg, mesh: Mesh1D) -> CacheBlock:
    """The rank's block of a whole decode cache of ``cfg`` (numpy arrays
    or tensors; flat, or the hybrid's nested slots) on the (data,
    model=p) mesh ``mesh`` (a ``Mesh1D``: its p, r, data extent and
    index): each leaf cut by the reference's ``cache_specs``, sanitized
    (``layers.sanitized_cache_specs``); a ``CacheBlock`` whose leaves own
    their memory and whose ``specs`` the decode step reads."""
    specs = sanitized_cache_specs(cache, cfg, mesh)
    return CacheBlock(ptree.map(lambda a, sp: _own(mesh.block(a, sp)),
                                cache, specs), specs)


def gather_cache_1d(blocks, cfg, mesh: Mesh1D, specs=None):
    """The whole decode cache from the blocks of every rank of ``mesh``'s
    (data, model=p) mesh, listed in rank order d * p + r: each leaf's
    blocks concatenated along the dims its spec cuts, the model axis
    inside the data axis; a dim left whole is taken from the first block.
    ``specs``: the sanitized spec tree of the whole cache (by default the
    blocks' own, ``CacheBlock.specs``).  Bit for bit the cache
    ``shard_cache_1d`` cut.  ``cfg`` names the model the cache is of."""
    del cfg
    p, data = mesh.p, mesh.data_size
    if len(blocks) != p * data:
        raise ValueError(f"gather_cache_1d: {len(blocks)} blocks for "
                         f"{data} x {p} ranks")
    specs = blocks[0].specs if specs is None else specs

    def cat(leaves, dim):
        if isinstance(leaves[0], torch.Tensor):
            return torch.cat(leaves, dim)
        return np.concatenate(leaves, dim)

    def gather(path, spec):
        leaves = [_leaf_at(b, path) for b in blocks]
        dims = {a: d for d, e in enumerate(spec) for a in
                (e if isinstance(e, tuple) else (e,)) if a is not None}
        if MODEL_AXIS in dims:
            leaves = [cat(leaves[k:k + p], dims[MODEL_AXIS])
                      for k in range(0, len(leaves), p)]
        else:
            leaves = leaves[::p]
        if DATA_AXIS in dims:
            return _own(cat(leaves, dims[DATA_AXIS]))
        return _own(leaves[0])

    return ptree.map_with_path(gather, specs)


def _leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree
