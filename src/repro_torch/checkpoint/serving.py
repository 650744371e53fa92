"""Read-only serving restore (the port of ``repro/checkpoint/serving.py``).

Training checkpoints are zero-redundancy sharded saves whose manifest
records the *saving* topology's specs.  Serving needs none of that
topology: only the ``params`` group, on the serving device or as the
rank's blocks of the serving mesh, possibly at a different precision than
training kept its weights in.

``restore_serving_params`` is that path: it validates the checkpoint's
architecture against the engine's, restores ONLY ``params`` (never
``opt_state`` -- a serving process must not pay for Adam moments), and
finally casts leaves to the serving policy's dtypes (a bf16-trained
checkpoint can serve fp32 and vice versa; shapes are validated
leaf-by-leaf, dtypes are converted).  Without a mesh every caller reads
the whole group; with ``mesh=`` (a language model's (data, model=p) 1-D
mesh, ``serve/step.py::generate`` on it) each rank reads only its block of
every leaf, by ``specs`` (the serving layout) or, without them, the saved
specs refit to the mesh: the saving mesh may be any, of either package.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.checkpoint.manifest import Manifest, load_manifest
from repro_torch.checkpoint.sharded import describe_tree, restore_tree
from repro_torch.core import tree as ptree


def _cast_like(params, like):
    """Validate shapes against ``like`` and cast dtypes to its leaves.

    ``like`` is the model's params tree under the SERVING config (tensors
    of any device, shapes and dtypes only are read), so a precision
    mismatch between checkpoint and serving policy becomes a cast here
    instead of a restore error."""
    def fit(path, ref):
        key = "".join(f"[{k!r}]" for k in path)
        leaf = params
        try:
            for k in path:
                leaf = leaf[k]
        except (KeyError, IndexError, TypeError) as e:
            raise ValueError(
                f"serving restore: checkpoint param tree does not match "
                f"the model's (no {key}: {e!r})") from e
        if tuple(leaf.shape) != tuple(ref.shape):
            raise ValueError(
                f"serving restore: param {key} shape {tuple(leaf.shape)} "
                f"!= model shape {tuple(ref.shape)} -- wrong config for "
                "this checkpoint?")
        return leaf.to(ref.dtype)

    out = ptree.map_with_path(fit, like)
    if len(ptree.leaves(params)) != len(ptree.leaves(out)):
        raise ValueError("serving restore: checkpoint param tree does not "
                         "match the model's (extra leaves)")
    return out


def _check_global_shapes(man: Manifest, like, specs, mesh) -> None:
    """On a mesh: the global shape of each of ``like``'s blocks (its local
    shape times the extents its spec names) against the checkpoint's, so a
    wrong config raises before any read, naming the leaf."""
    saved = man.groups["params"]
    for key, (shape, _) in describe_tree(like, specs, mesh).items():
        if key not in saved:
            raise ValueError(f"serving restore: the checkpoint has no param "
                             f"{key!r} (wrong config for this checkpoint?)")
        if tuple(saved[key].shape) != tuple(shape):
            raise ValueError(
                f"serving restore: param {key!r} global "
                f"shape {tuple(shape)} on the serving mesh != checkpoint "
                f"shape {tuple(saved[key].shape)} -- wrong config for this "
                "checkpoint?")


def restore_serving_params(path: str, *, arch: Optional[str] = None,
                           like=None, mesh=None, specs=None, device="cpu"
                           ) -> Tuple[object, Manifest]:
    """Restore a training checkpoint's params for serving.  No collective
    runs: each caller reads its own bytes.

    path   : sharded checkpoint directory (any saving topology).
    arch   : expected arch id; mismatches against the manifest raise
             (checkpoints without the ``arch`` extra pass through).
    like   : optional params tree under the SERVING config (on a mesh,
             this rank's blocks) -- shapes validated (on a mesh the
             blocks' global shapes too), dtypes cast (``_cast_like``).
    mesh   : None -> the whole params on ``device`` (one device, or every
             rank of a data-only serving mesh); a ``Mesh1D`` -> this
             rank's block of every leaf, reading only the shard-file
             slices it needs.
    specs  : the spec tree of the serving layout (the port's layout, as
             ``launch/specs.py::param_specs`` sanitized; absent leaves
             whole); None refits the saved specs onto ``mesh``.
    device : where the params land.

    Returns ``(params, manifest)`` -- the manifest carries training
    metadata (step, precision, scheme) for logging/validation.
    """
    man = load_manifest(path)
    if "params" not in man.groups:
        raise ValueError(f"serving restore: {path!r} has no 'params' group "
                         f"(groups: {sorted(man.groups)})")
    ck_arch = man.extra.get("arch")
    if arch is not None and ck_arch is not None and ck_arch != arch:
        raise ValueError(f"serving restore: checkpoint arch {ck_arch!r} "
                         f"!= serving arch {arch!r}")
    if like is not None and mesh is not None:
        _check_global_shapes(man, like, specs, mesh)
    params = restore_tree(path, "params", manifest=man, mesh=mesh,
                          specs=specs, device=device)
    if like is not None:
        params = _cast_like(params, like)
    return params, man
