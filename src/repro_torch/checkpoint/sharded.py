"""Zero-redundancy sharded checkpoint save/restore (the port of
``repro/checkpoint/sharded.py``: the same files, so a checkpoint either
package writes restores in the other).

Save never gathers the model: each rank copies only its own block of every
leaf to host, and of the ranks that hold the same block (those that differ
only on the mesh axes the leaf's spec does not name,
``core/sharding.py::replicated_axes``) only the one at coordinate 0 on all
of them writes it, so every byte of a leaf is written exactly once.  Each
writing rank makes one npz (``shard-dNNNNN.npz``, its rank's number), and a
``manifest.json`` describes the global layout
(``repro_torch.checkpoint.manifest``).  A Jigsaw + ZeRO-1 run therefore
writes ~``total_bytes / n_ranks`` per rank.

The reference reads a leaf's place from its jax sharding; the port holds
each rank's block explicitly, so the caller names each leaf's spec
(``specs``: a tree of the port's spec tuples, sanitized, as the engine
keeps them; ZeRO-1's cut of the optimizer state is the ``data`` axis on
the dim it cuts) and the mesh (``Mesh1D`` / ``Mesh``: extents and this
rank's coordinates).  A leaf's global shape is its local shape times the
extents of its spec, its bounds ``convert.block_bounds``.

The port keeps a list of per-layer dicts where the reference stacks the
layers on a leading dim (``convert.STACKED``: the mixer's ``"blocks"``, a
language model's ``"layers"``, the hybrid's ``"periods"`` of ``slot{j}``
dicts, whisper's ``"enc_layers"`` and ``"dec_layers"``): a leaf of such a
list is saved stacked (one npz member, global shape [n_layers, ...], its
spec with a leading ``None``; every layer of the list must share that
spec), and restore splits it again.  A language model on a (data, model=p)
mesh saves each leaf by its sanitized 1-D layout
(``models/transformer.py::param_spec_1d``, the engine's ``param_specs``):
the linears on their contracting dim, the vocab-cut ``embed/table`` and
``lm_head/w`` on ``vocab_padded``, the experts on E, ``conv_w``'s and
``dec_pos``' last dim (Mamba-2's ``in_xbc`` and ``conv_w`` hold contiguous
blocks of the conv channels), and whole where the layout or
``sanitize_spec`` names no axis: those leaves are written once, by the
rank at coordinate 0 of every axis.

Restore is topology-free: ``restore_tree(path, group, like=..., mesh=...,
specs=...)`` reads, for every leaf, only the slices of the shard files
that overlap the block this rank's layout asks for; the saving mesh does
not matter.  Shape and dtype are validated against ``like`` leaf by leaf;
coverage against the manifest.

The save is split into a synchronous ``snapshot`` (the device -> host copy
of this rank's blocks: a fresh host copy, so the in-place updates of the
next steps cannot reach it) and a ``write_snapshot`` that touches only
host memory and disk -- that split lets the async writer
(``repro_torch.checkpoint.writer``) stream files while training continues.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import manifest as MF
from repro_torch.checkpoint.manifest import (SEP, Bounds, LeafEntry,
                                             Manifest, ShardEntry,
                                             load_manifest)
from repro_torch.convert import STACKED, block_bounds
from repro_torch.core.sharding import (entry_axes, replicated_axes,
                                       sanitize_spec)

# numpy's raw 2-byte void: how an npz holds bf16 (the reference's too)
_V2 = np.dtype("V2")


def _shard_file(rank: int) -> str:
    return f"shard-d{rank:05d}.npz"


# ---------------------------------------------------------------------------
# The port's trees <-> the manifest's flat keys
# ---------------------------------------------------------------------------

class Layers(list):
    """One key's leaves across a layer list, saved stacked on a leading
    dim (the reference's layout)."""


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a": {"b": leaf}} -> {"a/b": leaf}``; a list of per-layer trees
    gives each of its keys a ``Layers`` of the layers' leaves
    (``{"blocks": [{"w": w0}, {"w": w1}]} -> {"blocks/w": Layers([w0,
    w1])}``)."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}{SEP}"))
        return out
    if isinstance(tree, list):
        per = [flatten_tree(t) for t in tree]
        for k in (per[0] if per else {}):
            key = f"{prefix}{k}" if k else prefix.rstrip(SEP)
            out[key] = Layers(p[k] for p in per)
        return out
    out[prefix.rstrip(SEP)] = tree
    return out


def unflatten_tree(flat: Dict[str, Any]):
    """The inverse of ``flatten_tree``: a ``Layers`` value becomes one leaf
    in each dict of the layer list named by its key's stacked component
    (``convert.STACKED``)."""
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        if not isinstance(val, Layers):
            _put(tree, parts, val)
            continue
        cut = next(i for i, p in enumerate(parts) if p in STACKED)
        node = tree
        for p in parts[:cut]:
            node = node.setdefault(p, {})
        inner = parts[cut + 1:]
        if not inner:
            node[parts[cut]] = list(val)
            continue
        layers = node.setdefault(parts[cut], [{} for _ in val])
        for layer, v in zip(layers, val):
            _put(layer, inner, v)
    return tree


def _put(tree, parts, val) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = val


def _stacked(key: str) -> bool:
    """Whether the manifest's leaf ``key`` is stacked layers (a component
    is a stacked entry: ``blocks/...``, ``mu/blocks/...``)."""
    return any(p in STACKED for p in key.split(SEP))


def _flat_specs(specs) -> Dict[str, Any]:
    """A spec tree in the port's layout, flat; a layer list's specs give
    one, which every layer of the list must share (its leaves are saved
    stacked under that one spec): a list whose layers disagree raises
    ValueError naming the key."""
    if specs is None:
        return {}
    out = {}
    for k, v in flatten_tree(specs).items():
        if isinstance(v, Layers):
            if any(tuple(s or ()) != tuple(v[0] or ()) for s in v[1:]):
                raise ValueError(
                    f"checkpoint specs: the layers of {k!r} do not share "
                    f"one spec ({[tuple(s or ()) for s in v]}); a stacked "
                    "leaf is saved under one")
            v = v[0]
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# Where a rank's leaf sits in the global array
# ---------------------------------------------------------------------------

def _local_shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else ()


def _dtype_name(x) -> str:
    if isinstance(x, Layers):
        x = x[0]
    if isinstance(x, torch.Tensor):
        return MF.dtype_name(x.dtype)
    if isinstance(x, bool):
        return "bool"
    if isinstance(x, int):
        return "int32"            # the reference's Adam step (jnp.int32)
    if isinstance(x, float):
        return "float32"
    return MF.dtype_name(np.asarray(x).dtype)


def _place(leaf, spec, mesh):
    """(global shape, this rank's bounds, spec as saved, whether this rank
    writes) of a leaf (a ``Layers`` in stacked coordinates) under its
    per-layer ``spec`` (None: whole, saved as ``[]`` as the reference
    saves an unsharded array) on ``mesh`` (None: one process, whole)."""
    layers = isinstance(leaf, Layers)
    shape = _local_shape(leaf[0] if layers else leaf)
    given = spec is not None
    spec = tuple(spec or ()) + (None,) * (len(shape) - len(spec or ()))
    if mesh is None:
        gshape = shape
        bounds = tuple((0, n) for n in shape)
        writes = True
    else:
        gshape = tuple(n * math.prod(mesh.extent(a) for a in entry_axes(e))
                       for n, e in zip(shape, spec))
        bounds = block_bounds(mesh, spec, gshape)
        writes = all(mesh.coord(a) == 0
                     for a in replicated_axes(spec, mesh))
    if layers:
        n = len(leaf)
        gshape, bounds, spec = (n,) + gshape, ((0, n),) + bounds, \
            (None,) + spec
    return gshape, bounds, (spec if given else ()), writes


def describe_tree(tree, specs=None, mesh=None
                  ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """Flat key -> (global shape, dtype name) of every leaf of a tree in
    the port's layout (``validate_like``'s ``like``)."""
    sflat = _flat_specs(specs)
    return {k: (_place(v, sflat.get(k), mesh)[0], _dtype_name(v))
            for k, v in flatten_tree(tree).items()}


def _bits(host: torch.Tensor) -> np.ndarray:
    """A host tensor's numpy view as the npz stores it (bf16 as |V2)."""
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(_V2)
    return host.numpy()


def _host(x) -> np.ndarray:
    """A fresh host copy of a leaf (a ``Layers`` stacked): never a view of
    the caller's memory, which the next step updates in place; the copy
    from the card is finished when this returns."""
    if isinstance(x, Layers):
        if isinstance(x[0], torch.Tensor):
            host = torch.empty((len(x), *x[0].shape), dtype=x[0].dtype)
            for h, t in zip(host, x):
                h.copy_(t)
            return _bits(host)
        return np.stack([_host(v) for v in x])
    if isinstance(x, torch.Tensor):
        host = torch.empty(x.shape, dtype=x.dtype)
        host.copy_(x)
        return _bits(host)
    if isinstance(x, (bool, int, float)):
        return np.asarray(x, MF.dtype_entry(_dtype_name(x))[1])
    arr = np.array(x, copy=True)
    if arr.dtype.name == "bfloat16":        # an ml_dtypes array
        return arr.view(np.uint16).view(_V2)
    return arr


# ---------------------------------------------------------------------------
# Snapshot (synchronous) + write (backgroundable)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Snapshot:
    """Host-side image of a checkpoint: the manifest plus the per-file
    npz payloads.  Holding one of these is enough to finish the save
    with no further access to device memory -- the async writer's unit
    of work."""
    manifest: Manifest
    blobs: Dict[str, Dict[str, np.ndarray]]     # file -> {npz key: data}
    bytes_per_rank: Dict[int, int]              # rank -> bytes written

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_per_rank.values())


def snapshot(groups: Dict[str, Any], *, step: int = 0,
             extra: Optional[dict] = None, mesh=None,
             specs: Optional[Dict[str, Any]] = None) -> Snapshot:
    """Copy this rank's block of every leaf it writes to host.

    ``groups`` maps group name ("params", "opt_state", ...) to a tree in
    the port's layout (tensors; numpy arrays and Python numbers too);
    ``specs`` maps a group name to its spec tree (leaves absent from it,
    or a group absent, are whole on every rank); ``mesh`` is this rank's
    place (None: one process).  No gather happens: per-rank host memory
    is bounded by the rank's own bytes."""
    rank = 0 if mesh is None else mesh.rank
    fname = _shard_file(rank)
    blobs: Dict[str, Dict[str, np.ndarray]] = {}
    bytes_per_rank: Dict[int, int] = {rank: 0}
    mgroups: Dict[str, Dict[str, LeafEntry]] = {}
    specs = specs or {}
    for group, tree in groups.items():
        sflat = _flat_specs(specs.get(group))
        entries: Dict[str, LeafEntry] = {}
        for key, leaf in flatten_tree(tree).items():
            shape, bounds, spec, writes = _place(leaf, sflat.get(key), mesh)
            shards: Tuple[ShardEntry, ...] = ()
            if writes:
                data = _host(leaf)
                nkey = f"{group}{SEP}{key}#0"
                blobs.setdefault(fname, {})[nkey] = data
                bytes_per_rank[rank] += data.nbytes
                shards = (ShardEntry(fname, nkey, bounds, rank),)
            entries[key] = LeafEntry(shape=shape, dtype=_dtype_name(leaf),
                                     spec=MF.spec_to_json(spec),
                                     shards=shards)
        mgroups[group] = entries
    man = Manifest(
        step=int(step), extra=dict(extra or {}),
        mesh_axes=None if mesh is None else tuple(mesh.shape),
        mesh_shape=None if mesh is None else tuple(mesh.shape.values()),
        groups=mgroups)
    return Snapshot(man, blobs, bytes_per_rank)


def _write_npz_atomic(fname: str, members: Dict[str, np.ndarray]) -> None:
    """Write an npz via tmp + os.replace: a process killed mid-write can
    leave a stale ``.tmp`` behind, but never a truncated shard at the
    final name -- so 'file exists' means 'file is whole'."""
    tmp = fname + ".tmp"
    # an open file object sidesteps np.savez's extension munging AND
    # makes the write target explicit
    with open(tmp, "wb") as f:
        # uncompressed: the async writer's job is to get off the train
        # loop's critical path, not to spend CPU on gzip
        np.savez(f, **members)
    os.replace(tmp, fname)


def write_snapshot(snap: Snapshot, path: str, *, process_index: int = 0,
                   process_count: int = 1) -> None:
    """Stream a Snapshot to disk: shard files first (each atomically),
    manifest last (its presence marks the checkpoint complete).

    On a mesh (``process_count > 1``, one process per rank): every process
    writes its shard file, then publishes an ``index-pNNNNN.json``
    fragment; process 0 additionally waits for ALL fragments and merges
    them into the final ``manifest.json`` -- the save is atomic as a
    whole, not per process (a save missing any rank's index never grows a
    manifest, so ``latest_checkpoint`` never resumes from it).  No
    collective runs here: this may be the writer's thread."""
    os.makedirs(path, exist_ok=True)
    for fname, members in snap.blobs.items():
        _write_npz_atomic(os.path.join(path, fname), members)
    if process_count <= 1:
        snap.manifest.save(path)
        return
    snap.manifest.save_index(path, process_index, process_count)
    if process_index == 0:
        finalize_checkpoint(path, process_count)


def finalize_checkpoint(path: str, process_count: int, *,
                        timeout: float = 120.0,
                        poll: float = 0.05) -> Manifest:
    """Rank 0's merge barrier: wait for every per-process index file,
    merge the fragments, write the global manifest (atomically).  Raises
    ``TimeoutError`` naming the missing ranks if the save never
    completes -- the manifest is then never written and the directory
    stays invisible to ``latest_checkpoint``."""
    names = [MF.index_name(i) for i in range(process_count)]
    deadline = time.monotonic() + timeout
    while True:
        missing = [n for n in names
                   if not os.path.exists(os.path.join(path, n))]
        if not missing:
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint {path!r}: per-process index files "
                f"{missing} still missing after {timeout}s -- save "
                f"incomplete, manifest NOT written")
        time.sleep(poll)
    man = MF.merge_manifests(
        [MF.load_index(path, i) for i in range(process_count)])
    man.save(path)
    return man


def partition_snapshot(snap: Snapshot, assign: Dict[int, int]
                       ) -> Dict[int, Snapshot]:
    """Split a single-process Snapshot into per-process fragments by
    writing rank (``assign``: rank -> process index) -- the fragment
    shapes a multi-process save produces natively.  Every fragment
    describes the WHOLE leaf set (global shapes/specs) with only its own
    shard entries."""
    out: Dict[int, Snapshot] = {}
    for pi in sorted(set(assign.values())):
        groups: Dict[str, Dict[str, LeafEntry]] = {}
        for g, leaves in snap.manifest.groups.items():
            groups[g] = {
                k: LeafEntry(e.shape, e.dtype, e.spec,
                             tuple(s for s in e.shards
                                   if assign[s.device] == pi))
                for k, e in leaves.items()}
        man = Manifest(step=snap.manifest.step,
                       extra=dict(snap.manifest.extra),
                       mesh_axes=snap.manifest.mesh_axes,
                       mesh_shape=snap.manifest.mesh_shape, groups=groups)
        files = man.shard_files()
        out[pi] = Snapshot(
            man, {f: snap.blobs[f] for f in files},
            {d: b for d, b in snap.bytes_per_rank.items()
             if assign.get(d) == pi})
    return out


def save_checkpoint(path: str, groups: Dict[str, Any], *, step: int = 0,
                    extra: Optional[dict] = None, mesh=None,
                    specs: Optional[Dict[str, Any]] = None) -> Snapshot:
    """Synchronous sharded save of one process; returns the Snapshot
    (byte accounting)."""
    snap = snapshot(groups, step=step, extra=extra, mesh=mesh, specs=specs)
    write_snapshot(snap, path)
    return snap


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------

def _storage(raw: np.ndarray, name: str) -> np.ndarray:
    """An npz member as the numpy dtype holding the manifest dtype's
    bits: raw void bytes ('|Vn') are reinterpreted; other numbers are
    converted by value (a bf16 leaf through torch's rounding)."""
    sdt = MF.dtype_entry(name)[1]
    if raw.dtype == sdt:
        return raw
    if raw.dtype.kind == "V" and raw.dtype.itemsize == sdt.itemsize:
        return raw.view(sdt)
    if name == "bfloat16":
        t = torch.from_numpy(np.asarray(raw, np.float32)).to(torch.bfloat16)
        return t.view(torch.int16).numpy().view(np.uint16)
    return raw.astype(sdt, copy=False)


class _ShardReader:
    """Lazy reader over a checkpoint's npz files: ``np.load`` on an
    uncompressed npz only materializes the members actually indexed, so
    restoring a small slice of a big checkpoint reads a small file
    region, not the whole thing."""

    def __init__(self, path: str):
        self.path = path
        self._files: Dict[str, Any] = {}

    def member(self, shard: ShardEntry, name: str) -> np.ndarray:
        f = self._files.get(shard.file)
        if f is None:
            fname = os.path.join(self.path, shard.file)
            if not os.path.exists(fname):
                raise FileNotFoundError(
                    f"checkpoint shard file missing: {fname} (partial "
                    f"save, or a multi-host checkpoint restored from "
                    f"one host's files?)")
            f = np.load(fname)
            self._files[shard.file] = f
        return _storage(f[shard.key], name)

    def read(self, entry: LeafEntry, req: Bounds) -> np.ndarray:
        """The ``req`` slice of a global leaf, assembled from every
        saved shard that overlaps it (in the dtype holding its bits)."""
        for sh in entry.shards:                      # exact-match fast path
            if sh.bounds == req:
                return self.member(sh, entry.dtype)
        out = np.empty([b - a for a, b in req], MF.dtype_entry(entry.dtype)[1])
        # boolean coverage mask: overlapping shards must not be able to
        # mask a hole (summing overlap volumes double-counts)
        filled = np.zeros(out.shape, dtype=bool)
        for sh in entry.shards:
            ov = tuple((max(a0, b0), min(a1, b1)) for (a0, a1), (b0, b1)
                       in zip(sh.bounds, req))
            if any(a >= b for a, b in ov):
                continue
            src = tuple(slice(a - s0, b - s0) for (a, b), (s0, _s1)
                        in zip(ov, sh.bounds))
            dst = tuple(slice(a - r0, b - r0) for (a, b), (r0, _r1)
                        in zip(ov, req))
            out[dst] = self.member(sh, entry.dtype)[src]
            filled[dst] = True
        if not filled.all():
            raise ValueError(
                f"shards cover {int(filled.sum())}/{filled.size} elements "
                f"of slice {req} -- manifest inconsistent with shard files")
        return out


def _tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """A CPU tensor of the manifest dtype ``name`` over ``arr``'s bits."""
    tdt = MF.dtype_entry(name)[0]
    a = np.asarray(arr, order="C")
    if not a.flags.writeable:
        a = a.copy()
    if tdt == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _fit_spec(shape: Tuple[int, ...], spec, mesh) -> Tuple:
    """Refit a (possibly foreign-topology) spec onto the current mesh:
    drop axes the mesh does not have, and axes whose extent does not
    divide the dim (those dims stay whole)."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    kept = [e if all(a in mesh.shape for a in entry_axes(e)) else None
            for e in dims]
    return sanitize_spec(shape, kept, mesh)


def restore_tree(path: str, group: str, *, like=None, mesh=None,
                 specs=None, manifest: Optional[Manifest] = None,
                 reader: Optional[_ShardReader] = None, device="cpu",
                 out=None):
    """Restore one group's tree, in the port's layout (layer lists), from
    a sharded checkpoint.

    like  : optional tree (tensors, an int for the Adam step; on a mesh
            this rank's blocks) validated leaf by leaf against the
            manifest -- global shape AND dtype; raises naming the
            offending key path.  The result takes its structure, each
            tensor its device, and an int leaf comes back an int.
    mesh  : None -> whole leaves on ``device``; otherwise this rank's
            block of every leaf on THIS mesh (which may differ from the
            saving one), reading only the shard-file slices it needs.
    specs : the spec tree of this rank's layout (the port's layout;
            absent leaves whole); None refits the saved specs to ``mesh``.
    out   : a tree like ``like`` (its default) whose tensors receive the
            values in place; returned.
    """
    man = manifest or load_manifest(path)
    if group not in man.groups:
        raise KeyError(f"checkpoint has no group {group!r} "
                       f"(has {sorted(man.groups)})")
    entries = man.groups[group]
    if like is None:
        like = out
    sflat = _flat_specs(specs)
    flat_like = flatten_tree(like) if like is not None else None
    if flat_like is not None:
        MF.validate_like(entries, describe_tree(like, specs, mesh), group)
    rd = reader or _ShardReader(path)
    flat_out = flatten_tree(out) if out is not None else {}
    vals: Dict[str, Any] = {}
    for key in (flat_like if flat_like is not None else entries):
        e = entries[key]
        ref = flat_like[key] if flat_like is not None else None
        layers = (isinstance(ref, Layers) if flat_like is not None
                  else _stacked(key))
        if mesh is None:
            req = tuple((0, d) for d in e.shape)
        else:
            if specs is not None:
                spec = sflat.get(key) or ()
                spec = tuple(spec) + (None,) * (
                    len(e.shape) - layers - len(spec))
                spec = ((None,) + spec) if layers else spec
            else:
                spec = _fit_spec(e.shape, MF.spec_from_json(e.spec), mesh)
            req = block_bounds(mesh, spec, e.shape)
        t = _tensor(rd.read(e, req), e.dtype)
        first = ref[0] if layers and ref is not None else ref
        if isinstance(first, int) and not isinstance(first, bool):
            vals[key] = int(t)                          # the Adam step
        elif out is not None:
            # straight from host into the caller's tensors
            for d, v in zip(flat_out[key] if layers else [flat_out[key]],
                            t if layers else [t]):
                d.copy_(v)
            continue
        else:
            dev = first.device if isinstance(first, torch.Tensor) \
                else device
            vals[key] = (Layers(v.to(dev, copy=True) for v in t) if layers
                         else t.to(dev))
        if out is not None:
            _put(out, key.split(SEP), vals[key])
    if out is not None:
        return out
    return unflatten_tree(vals)


def restore_checkpoint(path: str, like_groups: Optional[Dict[str, Any]]
                       = None, *, mesh=None, specs=None, device="cpu"
                       ) -> Tuple[Dict[str, Any], int, dict]:
    """Restore every group; returns (groups, step, extra).  ``specs``
    maps group name -> spec tree (as ``restore_tree``'s)."""
    man = load_manifest(path)
    rd = _ShardReader(path)
    like_groups = like_groups or {}
    specs = specs or {}
    groups = {g: restore_tree(path, g, like=like_groups.get(g), mesh=mesh,
                              specs=specs.get(g), manifest=man, reader=rd,
                              device=device)
              for g in man.groups}
    return groups, man.step, man.extra


# ---------------------------------------------------------------------------
# Completeness + discovery (the auto-resume contract)
# ---------------------------------------------------------------------------

def checkpoint_complete(path: str) -> bool:
    """True iff ``path`` holds a FINISHED sharded checkpoint: the
    manifest is present and parsable and every shard file it references
    exists.  A save killed mid-flight fails one of these -- shard files
    land atomically (tmp + replace) and the manifest is written last, so
    there is no window where a torn save looks whole."""
    try:
        man = load_manifest(path)
    except Exception:
        return False
    return all(os.path.exists(os.path.join(path, f))
               for f in man.shard_files())


def latest_checkpoint(root: str, prefix: Optional[str] = None
                      ) -> Optional[str]:
    """The newest COMPLETE checkpoint under ``root`` (or ``root``
    itself, if it is one), by manifest step then manifest mtime; torn
    saves -- missing manifest, orphaned index fragments, missing shard
    files -- are skipped, never selected.  ``prefix`` restricts
    discovery to ``<prefix>`` / ``<prefix>-*`` entries (the engine's
    ``--ckpt out/ck`` layout).  Returns None when nothing complete
    exists (cold start)."""
    if not os.path.isdir(root):
        return None
    cands = []
    for name in sorted(os.listdir(root)):
        p = os.path.join(root, name)
        if not os.path.isdir(p):
            continue
        if prefix is not None and name != prefix \
                and not name.startswith(prefix + "-"):
            continue
        cands.append(p)
    if os.path.exists(os.path.join(root, MF.MANIFEST_NAME)):
        cands.append(root)
    best, best_key = None, None
    for p in cands:
        if not checkpoint_complete(p):
            continue
        man = load_manifest(p)
        key = (man.step,
               os.path.getmtime(os.path.join(p, MF.MANIFEST_NAME)))
        if best_key is None or key > best_key:
            best, best_key = p, key
    return best
