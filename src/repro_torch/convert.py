"""Weight carry-over between the JAX package and the port.

The reference keeps WeatherMixer's parameters as a pytree of arrays whose
``"blocks"`` entry stacks the blocks on a leading layer dim; the port keeps
a list of per-block dicts.  Both functions go through numpy, so neither
package imports the other:

  ``params_from_numpy(tree)``  reference pytree (numpy leaves) -> port;
  ``params_to_numpy(params)``  port -> reference pytree (numpy leaves).

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


def _map(fn, *trees):
    """Apply ``fn`` leafwise over dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def params_from_numpy(tree, device="cuda"):
    """Reference WeatherMixer pytree (numpy leaves) -> the port's params on
    ``device`` (the card unless the caller asks for the CPU); the stacked
    ``"blocks"`` are split into a list."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("params_from_numpy: CUDA is not available; pass "
                           "device='cpu' to convert onto the CPU")
    out = {k: _map(lambda a: _to_tensor(a, device), v)
           for k, v in tree.items() if k != "blocks"}
    stacked = _map(lambda a: _to_tensor(a, device), tree["blocks"])
    n_layers = len(next(_leaves(stacked)))
    out["blocks"] = [_map(lambda t, i=i: t[i].clone(), stacked)
                     for i in range(n_layers)]
    return out


def params_to_numpy(params, bf16_dtype: Optional[Any] = None):
    """The port's params -> the reference's pytree layout with numpy
    leaves; the block list is stacked on a leading layer dim."""
    out = {k: _map(lambda t: _to_numpy(t, bf16_dtype), v)
           for k, v in params.items() if k != "blocks"}
    out["blocks"] = _map(lambda *ts: np.stack([_to_numpy(t, bf16_dtype)
                                               for t in ts]),
                         *params["blocks"])
    return out
