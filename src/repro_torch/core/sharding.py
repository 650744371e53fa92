"""Mesh axes, sharding rules and the rank's place on the mesh (the port of
the 2-D half of ``repro/core/sharding.py``).

The reference names its mesh axes and lets GSPMD place each array from a
PartitionSpec.  The port runs one process per rank and holds each rank's
block explicitly: a spec here is a tuple with one entry per dim, the mesh
axis that dim is cut along or None, and ``Mesh.block`` cuts the rank's
contiguous block out of a whole array.

2-D Jigsaw (the paper's 4-way, generalised to q x q) factors the model axis
into ``mdom`` (domain: tokens) and ``mtp`` (tensor: channels/features):
activations are cut (tokens on mdom, features on mtp), linear weights
[out, in] in the Cannon layout (out on mtp, in on mdom), token-mix weights
[m, t] in the transposed layout (m on mdom, t on mtp).  Which parameter
takes which layout is the model's to say (``models/weathermixer.py::
param_spec_2d``, the 2-D rule of ``repro/launch/specs.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

DATA_AXIS = "data"
MDOM_AXIS = "mdom"  # domain (spatial / token) sub-axis
MTP_AXIS = "mtp"    # tensor (channel / feature) sub-axis

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """The mesh axes that carry 2-D Jigsaw: ``dom_axis`` (tokens) and
    ``tp_axis`` (channels/features).  The 1-D rules (ROADMAP.md, queue 1
    item 5) and the reference's ``batch_axes`` (item 8) come with the
    slices that port them."""

    dom_axis: str = MDOM_AXIS
    tp_axis: str = MTP_AXIS

    @property
    def model_axes(self) -> Tuple[str, str]:
        return (self.dom_axis, self.tp_axis)

    def act(self, ndim: int, *, domain_dim: Optional[int] = None,
            feature_dim: int = -1) -> Spec:
        """Activation spec: the feature dim on the tp axis and the domain
        dim (if any) on the dom axis; the batch dim stays whole."""
        dims: list = [None] * ndim
        dims[feature_dim % ndim] = self.tp_axis
        if domain_dim is not None:
            dims[domain_dim % ndim] = self.dom_axis
        return tuple(dims)

    def weight(self, ndim: int = 2, *, contracting_dim: int = -1,
               out_dim: int = -2) -> Spec:
        """Cannon-layout weight spec: out-features on mtp, in-features on
        mdom."""
        dims: list = [None] * ndim
        dims[out_dim % ndim] = self.tp_axis
        dims[contracting_dim % ndim] = self.dom_axis
        return tuple(dims)


RULES_2D = ShardingRules()


def replicated_axes(spec: Spec, rules: ShardingRules = RULES_2D
                    ) -> Tuple[str, ...]:
    """The model axes a leaf of this spec is replicated over: its gradient
    is summed over them, and one rank of them counts it in the norm."""
    return tuple(a for a in rules.model_axes if a not in spec)


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
        index = []
        for d, axis in enumerate(spec):
            if axis is None:
                index.append(slice(None))
                continue
            n = x.shape[d]
            if n % self.q:
                raise ValueError(f"dim {d} of {tuple(x.shape)} is not "
                                 f"divisible by the mesh extent {self.q}")
            c, size = self.coord(axis), n // self.q
            index.append(slice(c * size, (c + 1) * size))
        return x[tuple(index)]
