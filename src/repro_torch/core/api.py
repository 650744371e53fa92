"""Linear-layer API of the port: functional init / apply pairs over dicts
of tensors (the counterpart of ``repro/core/api.py``).

``JigsawConfig`` selects how each linear completes its contraction:
``scheme="none"`` (the whole contraction local) or ``"2d"`` (Cannon on a
q x q mesh, ``core/jigsaw.py``, called by the model on its blocks;
``mesh`` is the rank's place on it, the 1x1 mesh when None).  ``"1d"``
raises until its slice lands.  ``kernel`` selects the engine of every
local GEMM, under the reference's names:

  "pallas"  the hand-written block_matmul kernel (kernels/block_matmul.py),
            with bias and activation fused into its epilogue;
  "xla"     plain PyTorch ops in the order of the reference's XLA branch:
            an f32-accumulated product rounded to x's dtype, then the bias
            and the activation in that dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core.jigsaw import _cast_operands
from repro_torch.core.sharding import Mesh
from repro_torch.kernels import ops
from repro_torch.kernels.ref import act

SCHEMES = ("1d", "2d", "none")
KERNELS = ("xla", "pallas")


@dataclasses.dataclass(frozen=True)
class JigsawConfig:
    scheme: str = "none"          # "none" | "2d" ("1d" is not ported)
    accum_dtype: Optional[torch.dtype] = torch.float32
    kernel: str = "xla"           # "xla" | "pallas" (local GEMM engine)
    # precision-policy compute dtype: every linear casts its operands here
    # before the GEMM.  None = no cast (legacy).
    compute_dtype: Optional[torch.dtype] = None
    # scheme="2d": this rank's place on the mesh (None: the 1x1 mesh)
    mesh: Optional[Mesh] = None

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"JigsawConfig: unknown scheme {self.scheme!r}"
                             " (expected '1d' | '2d' | 'none')")
        if self.scheme == "1d":
            raise NotImplementedError(
                "scheme='1d' is not ported yet (ROADMAP.md, queue 1 item 5: "
                "1-D Jigsaw on torch.distributed)")
        if self.kernel not in KERNELS:
            raise ValueError(f"JigsawConfig: unknown kernel {self.kernel!r}"
                             f" (expected one of {KERNELS})")

    def replace(self, **kw) -> "JigsawConfig":
        return dataclasses.replace(self, **kw)

    @property
    def mesh_2d(self) -> Mesh:
        return self.mesh if self.mesh is not None else Mesh()


DEFAULT_JIGSAW = JigsawConfig()


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, d_in: int, d_out: int, *,
                dtype=torch.float32, bias: bool = True,
                scale: Optional[float] = None, device=None):
    """Weights stored [d_out, d_in] (y = x @ w.T + b), LeCun-normal init
    drawn in f32 from ``gen`` on ``device`` (the generator's device)."""
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    device = gen.device if device is None else device
    w = torch.randn((d_out, d_in), generator=gen, dtype=torch.float32,
                    device=device) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear_apply(params, x: torch.Tensor,
                 cfg: JigsawConfig = DEFAULT_JIGSAW, *,
                 epilogue: str = "none") -> torch.Tensor:
    """``y = epilogue(x @ w.T + b)`` over the last dim of x."""
    x, w, b = _cast_operands(x, params["w"], params.get("b"),
                             cfg.compute_dtype)
    if cfg.kernel == "pallas":
        return ops.matmul_nd(x, w, b, epilogue=epilogue)
    acc = cfg.accum_dtype or x.dtype
    y = torch.matmul(x.to(acc), w.to(acc).t()).to(x.dtype)
    y = y if b is None else y + b
    return act(epilogue)(y)


# ---------------------------------------------------------------------------
# MLP (two linears + GELU) -- the WeatherMixer building block
# ---------------------------------------------------------------------------

def mlp_apply(params, x: torch.Tensor,
              cfg: JigsawConfig = DEFAULT_JIGSAW) -> torch.Tensor:
    """``gelu(x @ w1.T + b1) @ w2.T + b2``.  Under kernel="pallas" it is the
    fused two-kernel ``ops.mixer_mlp``."""
    if cfg.kernel == "pallas":
        x, w1, b1 = _cast_operands(x, params["fc1"]["w"],
                                   params["fc1"].get("b"), cfg.compute_dtype)
        _, w2, b2 = _cast_operands(x, params["fc2"]["w"],
                                   params["fc2"].get("b"), cfg.compute_dtype)
        return ops.mixer_mlp(x, w1, b1, w2, b2)
    h = linear_apply(params["fc1"], x, cfg, epilogue="gelu")
    return linear_apply(params["fc2"], h, cfg)
