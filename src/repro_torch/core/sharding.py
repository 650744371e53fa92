"""Mesh axes, sharding rules and the rank's place on the mesh (the port of
``repro/core/sharding.py``).

The reference names its mesh axes and lets GSPMD place each array from a
PartitionSpec.  The port runs one process per rank and holds each rank's
block explicitly: a spec here is a tuple with one entry per dim, the mesh
axis that dim is cut along (or a tuple of axes, the first the major one,
as the reference's batch entry ``("data",)``) or None, and ``Mesh.block``
cuts the rank's contiguous block out of a whole array.

1-D Jigsaw (the paper's 2-way, generalised to p ranks) cuts activations
along their feature dim and every weight [out, in] along its contracting
(in) dim, both on the one ``model`` axis (``RULES_1D``, ``Mesh1D``).

2-D Jigsaw (the paper's 4-way, generalised to q x q) factors the model axis
into ``mdom`` (domain: tokens) and ``mtp`` (tensor: channels/features):
activations are cut (tokens on mdom, features on mtp), linear weights
[out, in] in the Cannon layout (out on mtp, in on mdom), token-mix weights
[m, t] in the transposed layout (m on mdom, t on mtp) (``RULES_2D``,
``Mesh``).  Which parameter takes which layout is the model's to say
(``models/weathermixer.py::PARAM_SPECS``, the rules of
``repro/launch/specs.py``).

Both meshes carry a ``data`` axis outside the model axes (the reference's
``(data, model)`` and ``(data, mdom, mtp)``): each Jigsaw model group is
replicated over ``data``, the batch's rows are cut over it
(``ShardingRules.batch_axes``), and a rank's global number is ``data_index
* model ranks + its place in the model group``.  The default, one data
rank with no data group, is the data-1 mesh of every earlier path.

Both meshes answer the same questions (``tp_size``/``tp_index``: the
rank's place along the feature axis; ``dom_size``/``dom_index``: along the
token axis, 1 and 0 under 1-D; ``model_group``: the ranks of this rank's
model group; ``mesh_group``: every rank of the mesh), so the model's
LayerNorm, blend and loss serve both.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

DATA_AXIS = "data"
MODEL_AXIS = "model"  # the 1-D mesh's one model axis
MDOM_AXIS = "mdom"  # domain (spatial / token) sub-axis
MTP_AXIS = "mtp"    # tensor (channel / feature) sub-axis

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def entry_axes(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (none, one, or a tuple of them)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names, in dim order."""
    return tuple(a for e in spec for a in entry_axes(e))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """The mesh axes that carry Jigsaw: ``tp_axis`` (channels/features)
    and, for 2-D, ``dom_axis`` (tokens; None under 1-D); ``batch_axes``,
    the pure data-parallel axes (the batch's rows, gradient sums)."""

    dom_axis: Optional[str] = MDOM_AXIS
    tp_axis: str = MTP_AXIS
    batch_axes: Tuple[str, ...] = (DATA_AXIS,)

    @property
    def is_2d(self) -> bool:
        return self.dom_axis is not None

    def act(self, ndim: int, *, domain_dim: Optional[int] = None,
            feature_dim: int = -1) -> Spec:
        """Activation spec: the batch dim (dim 0) on the batch axes, the
        feature dim on the tp axis and, under 2-D, the domain dim (if any)
        on the dom axis."""
        dims: list = [None] * ndim
        dims[0] = self.batch_axes
        dims[feature_dim % ndim] = self.tp_axis
        if self.is_2d and domain_dim is not None:
            dims[domain_dim % ndim] = self.dom_axis
        return tuple(dims)

    def weight(self, ndim: int = 2, *, contracting_dim: int = -1,
               out_dim: int = -2) -> Spec:
        """Weight spec.  1-D: the contracting (in) dim on the tp axis
        (zero redundancy; a reduce-scatter completes the product).  2-D,
        the Cannon layout: out-features on mtp, in-features on mdom."""
        dims: list = [None] * ndim
        if self.is_2d:
            dims[out_dim % ndim] = self.tp_axis
            dims[contracting_dim % ndim] = self.dom_axis
        else:
            dims[contracting_dim % ndim] = self.tp_axis
        return tuple(dims)


RULES_1D = ShardingRules(dom_axis=None, tp_axis=MODEL_AXIS)
RULES_2D = ShardingRules()


def replicated_axes(spec: Spec, mesh) -> Tuple[str, ...]:
    """The mesh axes (model and data) a leaf of this spec is replicated
    over: its gradient is summed over them, and one rank of them counts it
    in the norm."""
    named = spec_axes(spec)
    return tuple(a for a in mesh.shape if a not in named)


def block_range(mesh, entry: Entry, n: int) -> Tuple[int, int]:
    """[start, stop) of the rank's block of a dim of ``n`` cut along the
    axes of ``entry`` (None: the whole dim), on either mesh."""
    axes = entry_axes(entry)
    if not axes:
        return 0, n
    parts = math.prod(mesh.extent(a) for a in axes)
    if n % parts:
        raise ValueError(f"a dim of {n} is not divisible by the mesh "
                         f"extent {parts}")
    c = 0
    for a in axes:
        c = c * mesh.extent(a) + mesh.coord(a)
    size = n // parts
    return c * size, (c + 1) * size


def sanitize_spec(shape: Sequence[int], spec: Spec, mesh) -> Spec:
    """``spec`` padded to ``len(shape)`` dims, with every entry whose mesh
    extent does not divide its dim dropped (that dim replicates instead),
    as the reference's ``launch/specs.py::sanitize_spec``: a batch of 1
    over two data ranks stays whole on each.  ``mesh`` is anything with a
    ``shape`` mapping of axis -> extent."""
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for size, entry in zip(shape, dims):
        extent = math.prod(mesh.shape[a] for a in entry_axes(entry))
        out.append(entry if size % extent == 0 else None)
    return tuple(out)


def sanitize_batch(spec: Spec, mesh, rows: int) -> Spec:
    """``spec`` with its batch entry (dim 0) dropped where the mesh's extent
    of it does not divide the batch's ``rows``: such a batch stays whole on
    every data rank, as ``sanitize_spec`` leaves it (a batch of 1 over two
    data ranks); the other entries as they are."""
    return sanitize_spec((rows,), spec[:1], mesh) + tuple(spec[1:])


def _block(mesh, x, spec: Spec):
    """The rank's contiguous block of the whole array ``x`` (numpy or
    torch; a view) under ``spec``, on either mesh."""
    return x[tuple(slice(*block_range(mesh, axis, n))
                   for axis, n in zip(spec, x.shape))]


class _Place:
    """What both meshes answer from their axes: extents, coordinates, the
    process group of a set of axes, the rank's block of an array."""

    def extent(self, axis: str) -> int:
        return self.shape[axis]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    @property
    def model_size(self) -> int:
        return math.prod(v for a, v in self.shape.items() if a != DATA_AXIS)

    @property
    def rank(self) -> int:
        """This rank's global number: data outermost, as the reference's
        axis order."""
        return self.data_index * self.model_size + self.model_rank

    @property
    def mesh_group(self):
        """The process group of every rank of the mesh (None for one
        rank)."""
        return self.group(tuple(self.shape))

    def group(self, axes: Sequence[str]):
        """The process group spanning ``axes``; axes of extent 1 span
        nothing, so a set of them (or none) has no group (None)."""
        axes = {a for a in axes if self.extent(a) > 1}
        if not axes:
            return None
        model = axes - {DATA_AXIS}
        if not model:
            return self.data_group
        if DATA_AXIS not in axes:
            return self._model_group(model)
        if model == {a for a, v in self.shape.items()
                     if a != DATA_AXIS and v > 1}:
            return self.world_group
        raise ValueError(f"no process group for axes {sorted(axes)}")

    def block(self, x, spec: Spec):
        """This rank's contiguous block of the whole array ``x`` (numpy or
        torch; a view) under ``spec``."""
        return _block(self, x, spec)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh1D(_Place):
    """This rank's place on a (data, model=p) mesh: its index ``r`` on the
    model axis and the process group of its p model ranks (None for a
    one-rank model group: every model collective is then the identity);
    its index on the data axis, the group of the ``data_size`` ranks that
    share its model index (None for one), and the group of every rank
    (``world_group``, needed only where both axes have more than one)."""

    p: int = 1
    r: int = 0
    tp_group: Any = None
    data_size: int = 1
    data_index: int = 0
    data_group: Any = None
    world_group: Any = None

    rules = RULES_1D
    dom_size, dom_index = 1, 0

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data_size, MODEL_AXIS: self.p}

    @property
    def coords(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data_index, MODEL_AXIS: self.r}

    @property
    def model_rank(self) -> int:
        return self.r

    @property
    def tp_size(self) -> int:
        return self.p

    @property
    def tp_index(self) -> int:
        return self.r

    @property
    def model_group(self):
        return self.tp_group

    def _model_group(self, axes):
        return self.tp_group


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh(_Place):
    """This rank's place on a (data, mdom=q, mtp=q) mesh: its coordinates
    ``i`` (mdom) and ``j`` (mtp), and the process groups of its mdom column
    (the q ranks sharing j), its mtp row (sharing i) and its model group;
    its data index, data group and the group of every rank as ``Mesh1D``
    has them.  The 1x1 model mesh (the default) has no model group: every
    collective of the 2-D path is then the identity."""

    q: int = 1
    i: int = 0
    j: int = 0
    dom_group: Any = None
    tp_group: Any = None
    model_group: Any = None
    data_size: int = 1
    data_index: int = 0
    data_group: Any = None
    world_group: Any = None

    rules = RULES_2D

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data_size, MDOM_AXIS: self.q,
                MTP_AXIS: self.q}

    @property
    def coords(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data_index, MDOM_AXIS: self.i,
                MTP_AXIS: self.j}

    @property
    def model_rank(self) -> int:
        return self.i * self.q + self.j

    @property
    def tp_size(self) -> int:
        return self.q

    @property
    def tp_index(self) -> int:
        return self.j

    @property
    def dom_size(self) -> int:
        return self.q

    @property
    def dom_index(self) -> int:
        return self.i

    def _model_group(self, axes):
        if axes == {MDOM_AXIS}:
            return self.dom_group
        if axes == {MTP_AXIS}:
            return self.tp_group
        return self.model_group
