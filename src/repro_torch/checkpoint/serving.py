"""Read-only serving restore (the port of ``repro/checkpoint/serving.py``).

Training checkpoints are zero-redundancy sharded saves whose manifest
records the *saving* topology's specs.  Serving needs none of that
topology: only the ``params`` group, whole on the serving device,
possibly at a different precision than training kept its weights in.

``restore_serving_params`` is that path: it validates the checkpoint's
architecture against the engine's, restores ONLY ``params`` (never
``opt_state`` -- a serving process must not pay for Adam moments), and
finally casts leaves to the serving policy's dtypes (a bf16-trained
checkpoint can serve fp32 and vice versa; shapes are validated
leaf-by-leaf, dtypes are converted).
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.checkpoint.manifest import Manifest, load_manifest
from repro_torch.checkpoint.sharded import restore_tree
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


def restore_serving_params(path: str, *, arch: Optional[str] = None,
                           like=None, device="cpu"
                           ) -> Tuple[object, Manifest]:
    """Restore a training checkpoint's params for serving on one device,
    or on each rank of a data-only serving mesh: every rank calls this and
    reads the whole params group (no collective; the saving mesh may be
    any, of either package).

    path   : sharded checkpoint directory (any saving topology).
    arch   : expected arch id; mismatches against the manifest raise
             (checkpoints without the ``arch`` extra pass through).
    like   : optional params tree under the SERVING config -- shapes
             validated, dtypes cast (see ``_cast_like``).
    device : where the params land (whole on every serving rank).

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
    params = restore_tree(path, "params", manifest=man, device=device)
    if like is not None:
        params = _cast_like(params, like)
    return params, man
