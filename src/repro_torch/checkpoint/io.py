"""The (path, params, opt_state, step) facade over the sharded format
(the port of ``repro/checkpoint/io.py``).

``save``/``restore`` keep the reference's signature; the storage
underneath is the zero-redundancy sharded format of
``repro_torch.checkpoint.sharded``: per-rank shard files +
``manifest.json``.

``restore`` validates EVERY leaf of ``like_params`` / ``like_opt``
against the manifest -- shape and dtype -- and raises naming the
offending key path.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.checkpoint import sharded
from repro_torch.checkpoint.manifest import load_manifest


def save(path: str, params, opt_state=None, step: int = 0,
         extra: dict = None) -> None:
    """Sharded, synchronous save of one process (the engine uses the
    async writer; this facade is the simple blocking entry point)."""
    groups: Dict[str, Any] = {"params": params}
    if opt_state is not None:
        groups["opt_state"] = opt_state
    sharded.save_checkpoint(path, groups, step=step, extra=extra)


def restore(path: str, like_params=None, like_opt=None, mesh=None,
            specs=None, device="cpu") -> Tuple[Any, Any, int]:
    """Returns (params, opt_state, step).

    ``like_*`` trees are validated leaf-by-leaf (shape AND dtype; errors
    name the offending key path).  With ``mesh`` the leaves are this
    rank's blocks of them (``specs``: ``{"params": ..., "opt_state":
    ...}`` spec trees, else the saved specs refit to it); without it they
    are whole tensors on ``device``."""
    man = load_manifest(path)
    specs = specs or {}
    params = sharded.restore_tree(path, "params", like=like_params,
                                  mesh=mesh, specs=specs.get("params"),
                                  manifest=man, device=device)
    opt_state = None
    if "opt_state" in man.groups:
        opt_state = sharded.restore_tree(
            path, "opt_state", like=like_opt, mesh=mesh,
            specs=specs.get("opt_state"), manifest=man, device=device)
    return params, opt_state, man.step
