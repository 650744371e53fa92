"""The input batch's layout on a mesh (the mixer part of
``repro/launch/specs.py::batch_specs``), as far as the per-rank read plan
needs it: which block of the fields each rank owns.

The reference cuts the batch [B, lat, lon, C] with lon over mdom and C over
mtp (paper §5: each rank loads only its slice) and lets GSPMD reshard it
into the model's layout.  The port has no GSPMD.  A rank reads instead the
block the model takes (``models/weathermixer.py::field_block``): the
patchified fields [B, T, p*p*C] cut as the activations are, the tokens over
mdom (2-D only) and the patch dim over the feature axis (mtp, or the 1-D
model axis).  The bytes per rank are 1/q**2 (1/p) of the batch, as the
reference's, and no collective moves the batch.  The rest of ``specs.py``
(parameter, optimizer and cache specs, the data axis) waits for ROADMAP.md
queue 1 item 8.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sharding import ShardingRules, Spec


def batch_specs(cfg: ModelConfig, rules: ShardingRules) -> Dict[str, Spec]:
    """The spec of each batch key over the patchified fields [B, T, p*p*C]
    (the batch dim whole: no data axis is ported)."""
    if cfg.family != "mixer":
        raise NotImplementedError(
            f"batch_specs covers the mixer family only; {cfg.arch_id} is "
            f"{cfg.family!r} (ROADMAP.md, queue 1 item 14)")
    fields = rules.act(3, domain_dim=1)
    return {"fields": fields, "target": fields}
