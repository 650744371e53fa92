"""Checkpoint manifest: the metadata contract between save and restore
(the port's copy of ``repro/checkpoint/manifest.py``, with the port's spec
tuples and its own table of dtype names; the on-disk format is the
reference's, so a checkpoint either package writes restores in the other).

A checkpoint directory holds one ``manifest.json`` plus one shard file
per writing rank (``shard-dNNNNN.npz``).  The manifest records, for
every leaf of every group (``params`` / ``opt_state`` / ...):

  * the GLOBAL shape and dtype (layers stacked on a leading dim, as the
    reference keeps them: ``blocks/tok_fc1/w`` is [n_layers, out, in]),
  * the spec it was saved under, as JSON (``null`` entries for
    replicated dims), and
  * the list of shards -- ``(file, npz key, per-dim [start, stop)
    bounds, writing rank)`` -- that tile the global array exactly once.

Because the manifest describes global arrays in terms of index bounds
(not ranks), restore is topology-free: any mesh whose layout asks for a
slice of the global array is served by reading the shard files that
overlap it (``repro_torch.checkpoint.sharded``).

Dtype names are numpy's, as the reference writes them.  numpy has no
``bfloat16`` without ``ml_dtypes``, which the port does not use: ``DTYPES``
maps each name to its torch dtype and the numpy dtype its bits are held
in (bf16 as uint16, written to the npz as raw ``|V2``, as the reference's
npz stores it).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

FORMAT = "jigsaw-ckpt-v1"
MANIFEST_NAME = "manifest.json"
INDEX_PREFIX = "index-p"
SEP = "/"


def index_name(process_index: int) -> str:
    """Per-process shard index file: each process of a pod-scale save
    publishes one of these (atomically, after its shard files are on
    disk); process 0 merges them into the final ``manifest.json``."""
    return f"{INDEX_PREFIX}{process_index:05d}.json"

Bounds = Tuple[Tuple[int, int], ...]

# manifest dtype name -> (torch dtype, numpy dtype holding its bits)
DTYPES = {
    "float32": (torch.float32, np.dtype(np.float32)),
    "float64": (torch.float64, np.dtype(np.float64)),
    "float16": (torch.float16, np.dtype(np.float16)),
    "bfloat16": (torch.bfloat16, np.dtype(np.uint16)),
    "int8": (torch.int8, np.dtype(np.int8)),
    "int16": (torch.int16, np.dtype(np.int16)),
    "int32": (torch.int32, np.dtype(np.int32)),
    "int64": (torch.int64, np.dtype(np.int64)),
    "uint8": (torch.uint8, np.dtype(np.uint8)),
    "bool": (torch.bool, np.dtype(np.bool_)),
}
_NAMES = {t: name for name, (t, _) in DTYPES.items()}


def dtype_entry(name: str) -> Tuple[torch.dtype, np.dtype]:
    """(torch dtype, numpy storage dtype) of a manifest dtype name."""
    if name not in DTYPES:
        raise ValueError(f"checkpoint dtype {name!r} is not one the port "
                         f"reads (have {sorted(DTYPES)})")
    return DTYPES[name]


def dtype_name(dtype) -> str:
    """Manifest dtype name of a torch or numpy dtype (an ``ml_dtypes``
    bfloat16 array's dtype is recognised by its name)."""
    if isinstance(dtype, torch.dtype):
        if dtype not in _NAMES:
            raise ValueError(f"no checkpoint dtype for {dtype}")
        return _NAMES[dtype]
    return np.dtype(dtype).name


# ---------------------------------------------------------------------------
# Spec serialization
# ---------------------------------------------------------------------------

def spec_to_json(spec) -> List:
    """Spec tuple -> JSON list: None | "axis" | ["ax1", "ax2"]."""
    out: List = []
    for e in spec:
        if e is None:
            out.append(None)
        elif isinstance(e, (tuple, list)):
            out.append([str(a) for a in e])
        else:
            out.append(str(e))
    return out


def spec_from_json(entries: Sequence) -> Tuple:
    """JSON list -> the port's spec tuple (``core/sharding.py``)."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in entries)


# ---------------------------------------------------------------------------
# Manifest records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardEntry:
    """One saved shard of one leaf."""
    file: str            # npz file (relative to the checkpoint dir)
    key: str             # member key inside the npz
    bounds: Bounds       # per-dim [start, stop) in the global array
    device: int          # writing rank (byte accounting / debug)

    def to_json(self):
        return {"file": self.file, "key": self.key,
                "bounds": [list(b) for b in self.bounds],
                "device": self.device}

    @staticmethod
    def from_json(d) -> "ShardEntry":
        return ShardEntry(d["file"], d["key"],
                          tuple((int(a), int(b)) for a, b in d["bounds"]),
                          int(d["device"]))


@dataclasses.dataclass(frozen=True)
class LeafEntry:
    """Global description of one pytree leaf."""
    shape: Tuple[int, ...]
    dtype: str
    spec: List                       # spec_to_json form
    shards: Tuple[ShardEntry, ...]

    def to_json(self):
        return {"shape": list(self.shape), "dtype": self.dtype,
                "spec": self.spec,
                "shards": [s.to_json() for s in self.shards]}

    @staticmethod
    def from_json(d) -> "LeafEntry":
        return LeafEntry(tuple(d["shape"]), d["dtype"], d["spec"],
                         tuple(ShardEntry.from_json(s)
                               for s in d["shards"]))


@dataclasses.dataclass
class Manifest:
    step: int = 0
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    mesh_axes: Optional[Tuple[str, ...]] = None   # saving topology (info)
    mesh_shape: Optional[Tuple[int, ...]] = None
    groups: Dict[str, Dict[str, LeafEntry]] = dataclasses.field(
        default_factory=dict)

    def to_json(self):
        return {
            "format": FORMAT,
            "step": int(self.step),
            "extra": self.extra,
            "mesh": (None if self.mesh_axes is None else
                     {"axes": list(self.mesh_axes),
                      "shape": list(self.mesh_shape)}),
            "groups": {g: {k: e.to_json() for k, e in leaves.items()}
                       for g, leaves in self.groups.items()},
        }

    @staticmethod
    def from_json(d) -> "Manifest":
        if d.get("format") != FORMAT:
            raise ValueError(
                f"not a {FORMAT} checkpoint (format={d.get('format')!r})")
        mesh = d.get("mesh")
        return Manifest(
            step=int(d["step"]), extra=dict(d.get("extra") or {}),
            mesh_axes=None if mesh is None else tuple(mesh["axes"]),
            mesh_shape=None if mesh is None else tuple(mesh["shape"]),
            groups={g: {k: LeafEntry.from_json(e)
                        for k, e in leaves.items()}
                    for g, leaves in d["groups"].items()})

    def shard_files(self):
        """The set of shard files this manifest references -- what must
        exist on disk for the checkpoint to be complete."""
        return {s.file for leaves in self.groups.values()
                for e in leaves.values() for s in e.shards}

    def save(self, path: str) -> None:
        """Write manifest.json atomically (tmp + rename): shard files are
        written FIRST, the manifest LAST, so a crashed save is never
        mistaken for a complete checkpoint."""
        self._dump_json(self.to_json(), path, MANIFEST_NAME)

    def save_index(self, path: str, process_index: int,
                   process_count: int) -> None:
        """Write this process's shard-index fragment (same schema as the
        manifest, shard lists restricted to what THIS process wrote),
        atomically, as the per-process completeness marker of a
        pod-scale save."""
        d = self.to_json()
        d["process"] = {"index": int(process_index),
                        "count": int(process_count)}
        self._dump_json(d, path, index_name(process_index))

    @staticmethod
    def _dump_json(d: dict, path: str, name: str) -> None:
        tmp = os.path.join(path, name + ".tmp")
        with open(tmp, "w") as f:
            json.dump(d, f, indent=1)
        os.replace(tmp, os.path.join(path, name))


def load_manifest(path: str) -> Manifest:
    fname = os.path.join(path, MANIFEST_NAME)
    if not os.path.exists(fname):
        raise FileNotFoundError(
            f"no {MANIFEST_NAME} under {path!r} -- not a sharded "
            f"checkpoint (or an interrupted save)")
    with open(fname) as f:
        return Manifest.from_json(json.load(f))


def load_index(path: str, process_index: int) -> Manifest:
    fname = os.path.join(path, index_name(process_index))
    with open(fname) as f:
        d = json.load(f)
    d.pop("process", None)
    return Manifest.from_json(d)


def merge_manifests(parts: Sequence[Manifest]) -> Manifest:
    """Merge per-process manifest fragments into the global manifest.

    Every fragment carries the SAME leaf set with the same global
    shape/dtype/spec (each process describes the whole pytree, shard
    lists restricted to what it wrote); the merge concatenates the shard
    lists, deduplicating identical ``(file, key)`` entries.  Coverage of
    the merged shard set is validated at restore time by the reader's
    boolean fill mask, so a fragment that silently lost shards still
    fails loudly."""
    if not parts:
        raise ValueError("merge_manifests: no fragments")
    base = parts[0]
    for i, p in enumerate(parts[1:], 1):
        if set(p.groups) != set(base.groups):
            raise ValueError(
                f"per-process index {i} disagrees on the group set: "
                f"{sorted(p.groups)} != {sorted(base.groups)}")
        if p.step != base.step:
            raise ValueError(
                f"per-process index {i} is from step {p.step}, "
                f"rank 0's from {base.step} -- torn pod save")
    groups: Dict[str, Dict[str, LeafEntry]] = {}
    for g, leaves in base.groups.items():
        out: Dict[str, LeafEntry] = {}
        for k, e in leaves.items():
            shards: List[ShardEntry] = []
            seen = set()
            for i, p in enumerate(parts):
                pe = p.groups[g].get(k)
                if pe is None:
                    raise ValueError(
                        f"{g}[{SEP}{k}]: missing from per-process "
                        f"index {i}")
                if (pe.shape, pe.dtype) != (e.shape, e.dtype):
                    raise ValueError(
                        f"{g}[{SEP}{k}]: fragment {i} disagrees on "
                        f"shape/dtype ({pe.shape}/{pe.dtype} != "
                        f"{e.shape}/{e.dtype})")
                for s in pe.shards:
                    sid = (s.file, s.key)
                    if sid not in seen:
                        seen.add(sid)
                        shards.append(s)
            out[k] = LeafEntry(e.shape, e.dtype, e.spec, tuple(shards))
        groups[g] = out
    return Manifest(step=base.step, extra=base.extra,
                    mesh_axes=base.mesh_axes, mesh_shape=base.mesh_shape,
                    groups=groups)


# ---------------------------------------------------------------------------
# Validation against a ``like`` pytree
# ---------------------------------------------------------------------------

def validate_like(entries: Dict[str, LeafEntry],
                  like: Dict[str, Tuple[Tuple[int, ...], str]],
                  group: str) -> None:
    """Every leaf of ``like`` (flat: key -> (global shape, dtype name),
    ``sharded.describe_tree`` of a tree) must exist in the manifest with
    the same shape AND dtype; extra/missing keys are errors too.  Raises
    with the offending ``group[/key/path]``."""
    if set(like) != set(entries):
        missing = sorted(set(like) - set(entries))
        extra = sorted(set(entries) - set(like))
        raise ValueError(
            f"{group}: key mismatch (missing in checkpoint: "
            f"{missing[:5]}, unexpected in checkpoint: {extra[:5]})")
    for key, (shape, dtype) in like.items():
        e = entries[key]
        if tuple(shape) != e.shape:
            raise ValueError(
                f"{group}[{SEP}{key}]: checkpoint shape {e.shape} != "
                f"expected {tuple(shape)}")
        if e.dtype != dtype:
            raise ValueError(
                f"{group}[{SEP}{key}]: checkpoint dtype {e.dtype} != "
                f"expected {dtype}")
