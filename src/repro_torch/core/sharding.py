"""Mesh axes, sharding rules and the rank's place on the mesh (the port of
``repro/core/sharding.py``).

The reference names its mesh axes and lets GSPMD place each array from a
PartitionSpec.  The port runs one process per rank and holds each rank's
block explicitly: a spec here is a tuple with one entry per dim, the mesh
axis that dim is cut along or None, and ``Mesh.block`` cuts the rank's
contiguous block out of a whole array.

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

Both meshes answer the same questions (``tp_size``/``tp_index``: the
rank's place along the feature axis; ``dom_size``/``dom_index``: along the
token axis, 1 and 0 under 1-D; ``model_group``: every model rank), so the
model's LayerNorm, blend and loss serve both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

DATA_AXIS = "data"
MODEL_AXIS = "model"  # the 1-D mesh's one model axis
MDOM_AXIS = "mdom"  # domain (spatial / token) sub-axis
MTP_AXIS = "mtp"    # tensor (channel / feature) sub-axis

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """The mesh axes that carry Jigsaw: ``tp_axis`` (channels/features)
    and, for 2-D, ``dom_axis`` (tokens; None under 1-D).  The reference's
    ``batch_axes`` (ROADMAP.md, queue 1 item 8) come with the slice that
    ports them."""

    dom_axis: Optional[str] = MDOM_AXIS
    tp_axis: str = MTP_AXIS

    @property
    def is_2d(self) -> bool:
        return self.dom_axis is not None

    @property
    def model_axes(self) -> Tuple[str, ...]:
        return (self.dom_axis, self.tp_axis) if self.is_2d \
            else (self.tp_axis,)

    def act(self, ndim: int, *, domain_dim: Optional[int] = None,
            feature_dim: int = -1) -> Spec:
        """Activation spec: the feature dim on the tp axis and, under 2-D,
        the domain dim (if any) on the dom axis; the batch dim stays
        whole."""
        dims: list = [None] * ndim
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


def replicated_axes(spec: Spec, rules: ShardingRules = RULES_2D
                    ) -> Tuple[str, ...]:
    """The model axes a leaf of this spec is replicated over: its gradient
    is summed over them, and one rank of them counts it in the norm."""
    return tuple(a for a in rules.model_axes if a not in spec)


def block_range(mesh, axis: Optional[str], n: int) -> Tuple[int, int]:
    """[start, stop) of the rank's block of a dim of ``n`` cut along
    ``axis`` (None: the whole dim), on either mesh."""
    if axis is None:
        return 0, n
    parts = mesh.extent(axis)
    if n % parts:
        raise ValueError(f"a dim of {n} is not divisible by the mesh "
                         f"extent {parts}")
    c, size = mesh.coord(axis), n // parts
    return c * size, (c + 1) * size


def _block(mesh, x, spec: Spec):
    """The rank's contiguous block of the whole array ``x`` (numpy or
    torch; a view) under ``spec``, on either mesh."""
    return x[tuple(slice(*block_range(mesh, axis, n))
                   for axis, n in zip(spec, x.shape))]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh1D:
    """This rank's place on a (data=1, model=p) mesh: its index ``r`` on
    the model axis and the process group of the p model ranks (None for a
    one-rank mesh: every collective is then the identity)."""

    p: int = 1
    r: int = 0
    tp_group: Any = None

    rules = RULES_1D
    dom_size, dom_index = 1, 0

    @property
    def tp_size(self) -> int:
        return self.p

    @property
    def tp_index(self) -> int:
        return self.r

    @property
    def model_group(self):
        return self.tp_group

    def extent(self, axis: str) -> int:
        return {MODEL_AXIS: self.p}[axis]

    def coord(self, axis: str) -> int:
        return {MODEL_AXIS: self.r}[axis]

    def group(self, axes: Sequence[str]):
        """The process group spanning ``axes`` (the model axis or none)."""
        if self.p == 1 or not axes:
            return None
        if set(axes) != {MODEL_AXIS}:
            raise ValueError(f"no process group for axes {sorted(axes)}")
        return self.tp_group

    def block(self, x, spec: Spec):
        return _block(self, x, spec)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on a (data=1, mdom=q, mtp=q) mesh: its coordinates
    ``i`` (mdom) and ``j`` (mtp), and the process groups of its mdom column
    (the q ranks sharing j), its mtp row (sharing i) and all model ranks.
    The 1x1 mesh (the default) has no process group: every collective of
    the 2-D path is then the identity."""

    q: int = 1
    i: int = 0
    j: int = 0
    dom_group: Any = None
    tp_group: Any = None
    model_group: Any = None

    rules = RULES_2D

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

    def extent(self, axis: str) -> int:
        return {MDOM_AXIS: self.q, MTP_AXIS: self.q}[axis]

    def coord(self, axis: str) -> int:
        return {MDOM_AXIS: self.i, MTP_AXIS: self.j}[axis]

    def group(self, axes: Sequence[str]):
        """The process group spanning ``axes`` (a subset of the model
        axes); None on a 1x1 mesh or for no axis."""
        if self.q == 1 or not axes:
            return None
        axes = set(axes)
        if axes == {MDOM_AXIS}:
            return self.dom_group
        if axes == {MTP_AXIS}:
            return self.tp_group
        if axes == {MDOM_AXIS, MTP_AXIS}:
            return self.model_group
        raise ValueError(f"no process group for axes {sorted(axes)}")

    def block(self, x, spec: Spec):
        """This rank's contiguous block of the whole array ``x`` (numpy or
        torch; a view) under ``spec``."""
        return _block(self, x, spec)
