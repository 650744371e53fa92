"""CUDA graphs whose replays count the kernel launches they hold.

Each hand-written kernel's wrapper adds to its launch counters
(``block_matmul.launches`` and its ``layout_launches`` /
``route_launches``, ``ssd_intra_chunk.launches`` and its
``route_launches``, ``wx``, ``ring_fwd``, ``ring_bwd``, ``cannon_step``)
where it launches, in Python, at call time.  Under stream capture that
call records the launch into the graph and runs nothing; a replay runs the
launch and calls no Python.  ``CountedGraph`` keeps the counters equal to
the launches actually executed: it records every counter's change during
the capture, takes the change back out (nothing ran), and adds it again on
each replay.

A capture that fails raises; nothing here falls back to running eagerly.
"""
from __future__ import annotations

import collections
import copy
from contextlib import contextmanager
from typing import Callable, Dict, Tuple

import torch

COUNTERS = ("launches", "layout_launches", "route_launches")


def counted_kernels():
    """The counted wrappers of every hand-written kernel."""
    from repro_torch.kernels import (block_matmul, cannon, ring, ssd_chunk,
                                     ssd_chunk_bwd, wx)
    return (block_matmul.block_matmul, ssd_chunk.ssd_intra_chunk,
            ssd_chunk_bwd.ssd_intra_heads_bwd, wx.wx, ring.ring_fwd,
            ring.ring_bwd, cannon.cannon_step)


Key = Tuple[str, str]   # (wrapper name, counter name)


def snapshot() -> Dict[Key, object]:
    """Every counter's value: ints as they are, Counters copied."""
    out = {}
    for fn in counted_kernels():
        for name in COUNTERS:
            if hasattr(fn, name):
                out[(fn.__name__, name)] = copy.copy(getattr(fn, name))
    return out


def apply(values: Dict[Key, object], *, add: bool) -> None:
    """Set every counter to ``values`` (``add=False``; the Counters kept as
    objects and refilled in place), or add ``values`` to it."""
    by_name = {fn.__name__: fn for fn in counted_kernels()}
    for (fn_name, name), v in values.items():
        fn = by_name[fn_name]
        cur = getattr(fn, name)
        if isinstance(cur, collections.Counter):
            if not add:
                cur.clear()
            cur.update(v)
        else:
            setattr(fn, name, cur + v if add else v)


def delta(after: Dict[Key, object], before: Dict[Key, object]
          ) -> Dict[Key, object]:
    """What each counter gained from ``before`` to ``after``."""
    return {k: v - before[k] for k, v in after.items()}


class CountedGraph:
    """A ``torch.cuda.CUDAGraph`` of one step, its replays counted.

    ``capture(fn, pool)`` captures ``fn()`` (under ``torch.no_grad``) into
    the graph on ``pool`` (a ``torch.cuda.graph_pool_handle()`` that
    several graphs may share) and returns what ``fn`` returned: tensors
    of the graph's memory, rewritten by each replay.  ``replay()`` runs
    the graph and adds the captured launches to the counters.
    ``launches`` holds them per replay.  ``graph`` may be a stand-in with
    ``replay()`` (tests on the CPU, with ``_capturing`` overridden)."""

    def __init__(self, graph=None):
        self.graph = torch.cuda.CUDAGraph() if graph is None else graph
        self.launches: Dict[Key, object] = {}
        self.captured = False

    @contextmanager
    def _capturing(self, pool):
        with torch.cuda.graph(self.graph, pool=pool):
            yield

    def capture(self, fn: Callable, pool=None):
        if self.captured:
            raise RuntimeError("CountedGraph: already captured")
        before = snapshot()
        try:
            with torch.no_grad(), self._capturing(pool):
                out = fn()
        finally:
            after = snapshot()
            apply(before, add=False)        # nothing ran
        self.launches = delta(after, before)
        self.captured = True
        return out

    def replay(self) -> None:
        if not self.captured:
            raise RuntimeError("CountedGraph: replay before capture")
        self.graph.replay()
        apply(self.launches, add=True)

    def launches_of(self, name: str = "block_matmul") -> int:
        """Launches of wrapper ``name`` per replay."""
        return int(self.launches.get((name, "launches"), 0))
