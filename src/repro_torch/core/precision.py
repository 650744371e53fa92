"""Precision policy: which dtype each stage of the hot path runs in.

The port's copy of ``repro/core/precision.py``, with torch dtypes.  A
``Policy`` names

  param_dtype    storage dtype of the parameters;
  compute_dtype  dtype of every GEMM operand (linears cast their operands
                 to it at entry, ``core/api.py::_cast_operands``);
  accum_dtype    dtype partial sums are accumulated in between kernel calls
                 (the block_matmul kernel itself always accumulates in f32);

plus the optimizer split (``master_weights``, ``moment_dtype``) that the
training slice of the port will read.

Named presets (``get_policy``): ``fp32`` (the numerical reference), ``bf16``
(bf16 params and compute, f32 accumulation and masters) and ``bf16_pure``.
``policy_of(cfg)`` resolves a ModelConfig: an explicit ``cfg.precision``
names a preset; otherwise a legacy policy is derived from the config's
``param_dtype``/``compute_dtype`` strings (f32 accumulation, no masters).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


def dtype_of(name: str) -> torch.dtype:
    """torch dtype for a config's dtype string ("float32", "bfloat16")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def name_of(dtype: torch.dtype) -> str:
    """Config dtype string for a torch dtype (torch.bfloat16 -> "bfloat16")."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str = "fp32"
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32
    master_weights: bool = False
    moment_dtype: Optional[torch.dtype] = None   # None -> param dtype

    def replace(self, **kw) -> "Policy":
        return dataclasses.replace(self, **kw)


PRESETS = {
    "fp32": Policy("fp32", torch.float32, torch.float32, torch.float32,
                   master_weights=False, moment_dtype=torch.float32),
    "bf16": Policy("bf16", torch.bfloat16, torch.bfloat16, torch.float32,
                   master_weights=True, moment_dtype=torch.float32),
    "bf16_pure": Policy("bf16_pure", torch.bfloat16, torch.bfloat16,
                        torch.bfloat16, master_weights=False,
                        moment_dtype=torch.bfloat16),
}


def get_policy(p: Union[str, Policy, None]) -> Policy:
    """Resolve a preset name (or pass a Policy through; None -> fp32)."""
    if p is None:
        return PRESETS["fp32"]
    if isinstance(p, Policy):
        return p
    if p not in PRESETS:
        raise ValueError(f"unknown precision preset {p!r} "
                         f"(have {sorted(PRESETS)})")
    return PRESETS[p]


def policy_of(cfg) -> Policy:
    """Policy for a ModelConfig: the named preset, or the legacy policy
    derived from the config's dtype strings."""
    name = getattr(cfg, "precision", None)
    if name:
        return get_policy(name)
    return Policy(name="legacy",
                  param_dtype=dtype_of(cfg.param_dtype),
                  compute_dtype=dtype_of(cfg.compute_dtype),
                  accum_dtype=torch.float32, master_weights=False,
                  moment_dtype=None)


def apply_policy(cfg, p: Union[str, Policy]):
    """Return ``cfg`` with the policy threaded into its dtype fields."""
    pol = get_policy(p)
    return cfg.replace(precision=pol.name,
                       param_dtype=name_of(pol.param_dtype),
                       compute_dtype=name_of(pol.compute_dtype))
