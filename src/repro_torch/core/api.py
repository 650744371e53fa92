"""Linear-layer API of the port: functional init / apply pairs over dicts
of tensors (the counterpart of ``repro/core/api.py``).

``JigsawConfig`` selects how each linear completes its contraction:
``scheme="none"`` (the whole contraction local), ``"1d"`` (a reduce-
scatter over p ranks by ``impl``, ``core/jigsaw.py::jigsaw_linear``) or
``"2d"`` (Cannon on a q x q mesh, called by the model on its blocks);
``mesh`` is the rank's place on its mesh (``Mesh1D`` / ``Mesh``; a
one-rank mesh when None).  ``kernel`` selects the engine of every local
GEMM, under the reference's names:

  "pallas"  the hand-written block_matmul kernel (kernels/block_matmul.py),
            with bias and activation fused into its epilogue;
  "xla"     plain PyTorch ops in the order of the reference's XLA branch:
            an f32-accumulated product rounded to x's dtype, then the bias
            and the activation in that dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from repro_torch.core.jigsaw import (_cast_operands, check_impl,
                                    jigsaw_linear, vocab_linear_1d)
from repro_torch.core.sharding import Mesh, Mesh1D
from repro_torch.kernels import ops
from repro_torch.kernels.ref import act

SCHEMES = ("1d", "2d", "none")
KERNELS = ("xla", "pallas")


@dataclasses.dataclass(frozen=True)
class JigsawConfig:
    scheme: str = "none"          # "none" | "1d" | "2d"
    impl: str = "rs"              # scheme="1d": how the reduce completes
    accum_dtype: Optional[torch.dtype] = torch.float32
    kernel: str = "xla"           # "xla" | "pallas" (local GEMM engine)
    # precision-policy compute dtype: every linear casts its operands here
    # before the GEMM.  None = no cast (legacy).
    compute_dtype: Optional[torch.dtype] = None
    # this rank's place on the mesh: Mesh1D under "1d", Mesh under "2d"
    # (None: a one-rank mesh)
    mesh: Optional[Union[Mesh, Mesh1D]] = None
    # scheme="1d": the FSDP hybrid, each weight's out dim also cut over
    # the data axis (core/jigsaw.py::jigsaw_linear)
    fsdp: bool = False

    def __post_init__(self):
        # fail fast on unknown knobs and on the 1-D impl that is not ported
        # (the reference's JigsawConfig.__post_init__ validates the same;
        # it warns where impl is set under another scheme, and jigsaw_for
        # here sets it only under "1d")
        if self.scheme not in SCHEMES:
            raise ValueError(f"JigsawConfig: unknown scheme {self.scheme!r}"
                             " (expected '1d' | '2d' | 'none')")
        check_impl(self.impl, runs=self.scheme == "1d")
        if self.kernel not in KERNELS:
            raise ValueError(f"JigsawConfig: unknown kernel {self.kernel!r}"
                             f" (expected one of {KERNELS})")

    def replace(self, **kw) -> "JigsawConfig":
        return dataclasses.replace(self, **kw)

    @property
    def mesh_2d(self) -> Mesh:
        return self.mesh if self.mesh is not None else Mesh()

    @property
    def mesh_1d(self) -> Mesh1D:
        return self.mesh if self.mesh is not None else Mesh1D()

    @property
    def rank_mesh(self) -> Optional[Union[Mesh, Mesh1D]]:
        """The rank's mesh of a sharded scheme ("1d", "2d"); None under
        "none"."""
        return {"1d": self.mesh_1d, "2d": self.mesh_2d}.get(self.scheme)


DEFAULT_JIGSAW = JigsawConfig()


def head_apply(w: torch.Tensor, x: torch.Tensor,
               cfg: JigsawConfig = DEFAULT_JIGSAW) -> torch.Tensor:
    """The LM head ``x @ w.T``, w [V, D] (the tied embedding table or
    ``lm_head``'s weight).  Under ``scheme="1d"`` the vocab-parallel head
    on the rank's blocks (``jigsaw.vocab_linear_1d``: x [..., D/p], w the
    rank's [V/p, D] vocab rows -> logits [..., V/p]), which the reference
    leaves to GSPMD (its ``head_config``: the port has none); otherwise a
    linear under ``cfg``."""
    if cfg.scheme == "1d":
        return vocab_linear_1d(x, w, mesh=cfg.mesh_1d,
                               accum_dtype=cfg.accum_dtype,
                               kernel=cfg.kernel,
                               compute_dtype=cfg.compute_dtype)
    return linear_apply({"w": w}, x, cfg)


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
    """``y = epilogue(x @ w.T + b)`` over the last dim of x.  Under
    ``scheme="1d"`` x, w and b are the rank's blocks, and the epilogue runs
    after the reduce."""
    if cfg.scheme == "1d":
        y = jigsaw_linear(x, params["w"], params.get("b"), mesh=cfg.mesh_1d,
                          impl=cfg.impl, accum_dtype=cfg.accum_dtype,
                          kernel=cfg.kernel, compute_dtype=cfg.compute_dtype,
                          fsdp=cfg.fsdp)
        return act(epilogue)(y)
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

def mlp_init(gen: torch.Generator, d_in: int, d_hidden: int, d_out: int, *,
             dtype=torch.float32, bias: bool = True, device=None):
    """``fc1`` [d_hidden, d_in] then ``fc2`` [d_out, d_hidden], each
    ``linear_init`` from ``gen``."""
    return {"fc1": linear_init(gen, d_in, d_hidden, dtype=dtype, bias=bias,
                               device=device),
            "fc2": linear_init(gen, d_hidden, d_out, dtype=dtype, bias=bias,
                               device=device)}


def mlp_apply(params, x: torch.Tensor,
              cfg: JigsawConfig = DEFAULT_JIGSAW) -> torch.Tensor:
    """``gelu(x @ w1.T + b1) @ w2.T + b2``.  Under kernel="pallas" and
    scheme="none" it is the fused two-kernel ``ops.mixer_mlp``; otherwise
    linear, GELU, linear (under "1d" the contraction is incomplete until
    the reduce, so nothing fuses into the GEMM)."""
    if cfg.kernel == "pallas" and cfg.scheme == "none":
        x, w1, b1 = _cast_operands(x, params["fc1"]["w"],
                                   params["fc1"].get("b"), cfg.compute_dtype)
        _, w2, b2 = _cast_operands(x, params["fc2"]["w"],
                                   params["fc2"].get("b"), cfg.compute_dtype)
        return ops.mixer_mlp(x, w1, b1, w2, b2)
    h = linear_apply(params["fc1"], x, cfg, epilogue="gelu")
    return linear_apply(params["fc2"], h, cfg)
