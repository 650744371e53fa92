"""WeatherMixer: the paper's MLP-Mixer atmospheric model.

The port of ``repro/models/weathermixer.py``: encoder (patch conv as a
reshaped linear) -> N mixing blocks (token-mix MLP over spatial tokens,
channel-mix MLP over latent channels, LayerNorm + residual around each)
-> decoder (un-patch linear) -> learned blend with the input.  Parameters
are a dict of tensors as in the reference, except that
``params["blocks"]`` is a list with one dict per block where the reference
stacks the blocks on a leading layer dim (``convert.py`` maps between the
two).

``scheme="none"``: the whole model on one device.  Under
``kernel="pallas"`` every GEMM runs the hand-written block_matmul kernel:
2 + 4 * n_layers launches per forecast step; in training the backward
GEMMs run it too (``kernels/ops.py``).

``scheme="1d"``: 1-D Jigsaw on p ranks (``jcfg.mesh``, a ``Mesh1D``). Each
rank holds its shard of the parameters (``convert.shard_params_1d``: every
``w`` cut along its contracting dim, every ``b`` along its out dim) and its
block of the patchified fields (the patch dim cut). The encoder, the four
mixing linears of each block and the decoder are ``jigsaw_linear`` (a
reduce-scatter by ``jcfg.impl``), GELU after the reduce; the token mix
moves the cut from the feature dim to the token dim with an all-to-all (the
reference's swap to [B, C, T] with T on the model axis,
``weathermixer.py:106-115``) and back before the residual add; the
LayerNorms reduce over the tp group. Under the FSDP hybrid (``jcfg.fsdp``)
each weight's out dim is also cut over the data ranks and gathered before
its product (``core/jigsaw.py::jigsaw_linear``). The decoder's output stays
cut: the blend runs per rank in patch space, and the loss is taken per rank
(``train/step.py``), as under 2-D.

``scheme="2d"``: 2-D Jigsaw on a q x q mesh (``jcfg.mesh``).  Each rank
holds its shard of the parameters (``convert.shard_params_2d``) and its
block of the patchified fields (tokens cut along mdom, the patch dim along
mtp: the reference's ``act(3, domain_dim=1)``).  The encoder, channel mix
and decoder are ``jigsaw_linear_2d`` (Cannon), the token mix
``jigsaw_linear_2d_t`` (the transposed Cannon, on the wx kernel under
``kernel="pallas"``), with GELU outside the linears as in the reference's
2-D branch; the LayerNorms reduce over the mtp group, and the blend runs
per rank in patch space.  Under either scheme ``apply`` returns the rank's
block of the forecast in patch space, for its data rank's rows of the
batch (every data rank of a mesh runs the same model group's program).
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core.api import (DEFAULT_JIGSAW, JigsawConfig, linear_apply,
                                  linear_init, mlp_apply)
from repro_torch.core.jigsaw import jigsaw_linear_2d, jigsaw_linear_2d_t
from repro_torch.core.precision import dtype_of
from repro_torch.core.sharding import (DATA_AXIS, RULES_1D, RULES_2D, Spec,
                                      sanitize_batch)
from repro_torch.kernels.ref import act
from repro_torch.models import layers as L


def n_tokens(cfg: ModelConfig) -> int:
    return (cfg.wm_lat // cfg.wm_patch) * (cfg.wm_lon // cfg.wm_patch)


def patch_dim(cfg: ModelConfig) -> int:
    return cfg.wm_patch * cfg.wm_patch * cfg.wm_channels


def block_init(gen: torch.Generator, cfg: ModelConfig, device):
    t, d = n_tokens(cfg), cfg.d_model
    dtype = dtype_of(cfg.param_dtype)
    return {
        "tok_norm": L.layernorm_init(d, device=device),
        "tok_fc1": linear_init(gen, t, cfg.wm_d_tok, dtype=dtype,
                               device=device),
        "tok_fc2": linear_init(gen, cfg.wm_d_tok, t, dtype=dtype,
                               device=device),
        "ch_norm": L.layernorm_init(d, device=device),
        "ch_fc1": linear_init(gen, d, cfg.wm_d_ch, dtype=dtype,
                              device=device),
        "ch_fc2": linear_init(gen, cfg.wm_d_ch, d, dtype=dtype,
                              device=device),
    }


def init(cfg: ModelConfig, *, seed: int = 0, device="cuda"):
    """Fresh weights on ``device`` from a ``torch.Generator`` seeded with
    ``seed``: LeCun-normal weights stored [d_out, d_in] in
    ``cfg.param_dtype``, zero biases, LayerNorm scale 1 / bias 0, blend 0.
    Raises when ``device`` is CUDA and there is no card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("weathermixer.init: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = dtype_of(cfg.param_dtype)
    pd = patch_dim(cfg)
    return {
        "encoder": linear_init(gen, pd, cfg.d_model, dtype=dtype,
                               device=device),
        "blocks": [block_init(gen, cfg, device)
                   for _ in range(cfg.n_layers)],
        "decoder": linear_init(gen, cfg.d_model, pd, dtype=dtype,
                               device=device),
        "blend": torch.zeros((cfg.wm_channels,), dtype=torch.float32,
                             device=device),
    }


# leaves every rank holds whole, and the token-mix linears, whose weights
# take the transposed Cannon layout
_REPLICATED = {"scale", "bias", "blend"}
_TOKEN_MIX = {"tok_fc1", "tok_fc2"}


def param_spec_2d(path: Sequence[Any], ndim: int) -> Spec:
    """The 2-D spec of the parameter leaf at ``path`` (the 2-D rule of
    ``repro/launch/specs.py``): token-mix ``w`` (mdom, mtp), every other
    ``w`` (mtp, mdom); token-mix ``b`` on mdom, every other ``b`` on mtp;
    LayerNorm ``scale`` and ``bias`` and ``blend`` replicated.  Stacked
    leading dims (the reference's layer dim) stay whole."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    dims: list = [None] * ndim
    if name in _REPLICATED:
        return tuple(dims)
    if name == "w":
        if parent in _TOKEN_MIX:
            dims[-2], dims[-1] = RULES_2D.dom_axis, RULES_2D.tp_axis
            return tuple(dims)
        return RULES_2D.weight(ndim)
    if name == "b":
        dims[-1] = (RULES_2D.dom_axis if parent in _TOKEN_MIX
                    else RULES_2D.tp_axis)
        return tuple(dims)
    raise ValueError(f"no 2-D layout for parameter "
                     f"{'/'.join(map(str, path))}")


def param_spec_1d(path: Sequence[Any], ndim: int, fsdp: bool = False
                  ) -> Spec:
    """The 1-D spec of the parameter leaf at ``path`` (the 1-D rule of
    ``repro/launch/specs.py``): every ``w`` [out, in] on its contracting
    (last) dim and, under the FSDP hybrid (``fsdp``), its out dim on the
    data axis; every ``b`` on its (last) dim; LayerNorm ``scale`` and
    ``bias`` and ``blend`` replicated.  Where the data extent does not
    divide the out dim, ``sanitize_spec`` drops the data entry."""
    name = path[-1]
    dims: list = [None] * ndim
    if name in _REPLICATED:
        return tuple(dims)
    if name == "w":
        dims = list(RULES_1D.weight(ndim))
        if fsdp and ndim >= 2:
            dims[-2] = DATA_AXIS
        return tuple(dims)
    if name == "b":
        dims[-1] = RULES_1D.tp_axis
        return tuple(dims)
    raise ValueError(f"no 1-D layout for parameter "
                     f"{'/'.join(map(str, path))}")


# the parameter layout of each sharded scheme
PARAM_SPECS = {"1d": param_spec_1d, "2d": param_spec_2d}


def patchify(x: torch.Tensor, p: int) -> torch.Tensor:
    """[B, lat, lon, C] -> [B, T, p*p*C] over non-overlapping windows."""
    b, lat, lon, c = x.shape
    x = x.reshape(b, lat // p, p, lon // p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (lat // p) * (lon // p), p * p * c)


def unpatchify(x: torch.Tensor, lat: int, lon: int, p: int, c: int
               ) -> torch.Tensor:
    b = x.shape[0]
    x = x.reshape(b, lat // p, lon // p, p, p, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, lat, lon, c)


def _linear_2d(fn, p, x: torch.Tensor, jcfg: JigsawConfig) -> torch.Tensor:
    return fn(x, p["w"], p["b"], mesh=jcfg.mesh_2d,
              accum_dtype=jcfg.accum_dtype, kernel=jcfg.kernel,
              compute_dtype=jcfg.compute_dtype)


def _token_mix(bp, x: torch.Tensor, jcfg: JigsawConfig) -> torch.Tensor:
    """Token-mixing MLP contracting the token dim of x [B, T, C].

    ``scheme="2d"``: two transposed-Cannon linears on the rank's blocks,
    contracting the token dim in place.  ``scheme="none"``: the transpose
    is materialised (``contiguous``) so both GEMMs see row-major operands;
    the result is handed back as a transposed view.  ``scheme="1d"``: x is
    [B, T, C/p]; an all-to-all cuts T instead of C, the transpose gives
    [B, C, T/p], the two 1-D linears contract the token dim, and the
    all-to-all back gives [B, T, C/p] again."""
    if jcfg.scheme == "2d":
        h = _linear_2d(jigsaw_linear_2d_t, bp["tok_fc1"], x, jcfg)
        h = act("gelu")(h)
        return _linear_2d(jigsaw_linear_2d_t, bp["tok_fc2"], h, jcfg)
    group = jcfg.mesh_1d.tp_group if jcfg.scheme == "1d" else None
    x = comm.all_to_all(x, group, split_dim=-2, cat_dim=-1)   # [B, T/p, C]
    xt = x.transpose(-1, -2).contiguous()                  # [B, C, T/p]
    h = mlp_apply({"fc1": bp["tok_fc1"], "fc2": bp["tok_fc2"]}, xt, jcfg)
    return comm.all_to_all(h.transpose(-1, -2), group, split_dim=-1,
                           cat_dim=-2)                     # [B, T, C/p]


def _block_apply(bp, x: torch.Tensor, jcfg: JigsawConfig) -> torch.Tensor:
    mesh = jcfg.rank_mesh
    h = L.layernorm_apply(bp["tok_norm"], x, mesh=mesh)
    x = x + _token_mix(bp, h, jcfg)
    h = L.layernorm_apply(bp["ch_norm"], x, mesh=mesh)
    if jcfg.scheme == "2d":
        m = _linear_2d(jigsaw_linear_2d, bp["ch_fc1"], h, jcfg)
        m = act("gelu")(m)
        m = _linear_2d(jigsaw_linear_2d, bp["ch_fc2"], m, jcfg)
    else:
        m = mlp_apply({"fc1": bp["ch_fc1"], "fc2": bp["ch_fc2"]}, h, jcfg)
    return x + m


def processor(params, x: torch.Tensor, cfg: ModelConfig,
              jcfg: JigsawConfig, rollout: int = 1) -> torch.Tensor:
    """The mixing-block stack, applied ``rollout`` times (encode/decode
    happen once).  With ``cfg.remat`` and autograd recording, each block
    application is checkpointed, as the reference's ``jax.checkpoint``:
    only its input is kept, and its forward runs again in the backward."""
    remat = cfg.remat and torch.is_grad_enabled()
    for _ in range(rollout):
        for bp in params["blocks"]:
            if remat:
                x = checkpoint(_block_apply, bp, x, jcfg, use_reentrant=False)
            else:
                x = _block_apply(bp, x, jcfg)
    return x


def field_block(fields: torch.Tensor, cfg: ModelConfig, jcfg: JigsawConfig
                ) -> torch.Tensor:
    """This rank's block of the patchified fields [B, lat, lon, C]: its
    data rank's rows (all of them where the data extent does not divide B)
    and, under 2-D, [T/q, p*p*C/q] of each (tokens cut along mdom, the
    patch dim along mtp), under 1-D [T, p*p*C/p] (the patch dim cut).  A
    block already cut ([b, tokens, patch dim]: what the sharded input
    pipeline hands over, ``data/pipeline.py``) is returned as it is."""
    if fields.dim() == 3:
        return fields
    mesh = jcfg.rank_mesh
    spec = sanitize_batch(mesh.rules.act(3, domain_dim=1), mesh,
                          fields.shape[0])
    return mesh.block(patchify(fields, cfg.wm_patch), spec)


def blend_weights(blend: torch.Tensor, cfg: ModelConfig, jcfg: JigsawConfig
                  ) -> torch.Tensor:
    """sigmoid(blend) for the rank's patch-dim columns: patch-dim index k
    holds channel k % C."""
    mesh = jcfg.rank_mesh
    pd = patch_dim(cfg) // mesh.tp_size
    k = mesh.tp_index * pd + torch.arange(pd, device=blend.device)
    return torch.sigmoid(blend)[k % cfg.wm_channels]


def _apply_sharded(params, xin: torch.Tensor, cfg: ModelConfig,
                   jcfg: JigsawConfig, rollout: int) -> torch.Tensor:
    """The 1-D or 2-D forward on the rank's block xin of the patchified
    fields (f32) -> the rank's block of the forecast, in xin's dtype."""
    x = L.boundary_cast(xin, jcfg)
    if jcfg.scheme == "2d":
        h = _linear_2d(jigsaw_linear_2d, params["encoder"], x, jcfg)
    else:
        h = linear_apply(params["encoder"], x, jcfg)
    h = processor(params, h, cfg, jcfg, rollout=rollout)
    if jcfg.scheme == "2d":
        y = _linear_2d(jigsaw_linear_2d, params["decoder"], h, jcfg)
    else:
        y = linear_apply(params["decoder"], h, jcfg)
    y = y.to(xin.dtype)
    lam = blend_weights(params["blend"], cfg, jcfg).to(y.dtype)
    return lam * xin + (1.0 - lam) * y


def apply(params, batch, cfg: ModelConfig,
          jcfg: JigsawConfig = DEFAULT_JIGSAW, *, rollout: int = 1
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: {"fields": [B, lat, lon, C]} -> (forecast, aux = 0).  The
    forecast has the fields' shape under ``scheme="none"``; under
    ``scheme="1d"`` / ``"2d"`` it is the rank's block in patch space
    (``field_block``'s: the rank is handed the whole fields and takes its
    block, or is handed its block)."""
    xin = batch["fields"]
    zero = torch.zeros((), dtype=torch.float32, device=xin.device)
    if jcfg.scheme in ("1d", "2d"):
        return _apply_sharded(params, field_block(xin, cfg, jcfg), cfg,
                              jcfg, rollout), zero
    p = cfg.wm_patch
    x = L.boundary_cast(patchify(xin, p), jcfg)            # [B, T, p*p*C]
    h = linear_apply(params["encoder"], x, jcfg)           # [B, T, d]
    h = processor(params, h, cfg, jcfg, rollout=rollout)
    y = linear_apply(params["decoder"], h, jcfg)           # [B, T, p*p*C]
    y = unpatchify(y, cfg.wm_lat, cfg.wm_lon, p, cfg.wm_channels)
    # the exit boundary: blend in the INPUT dtype (f32) even under a bf16
    # compute policy
    y = y.to(xin.dtype)
    lam = torch.sigmoid(params["blend"]).to(y.dtype)
    out = lam * xin + (1.0 - lam) * y
    return out, zero


def gather_field(block: torch.Tensor, cfg: ModelConfig, jcfg: JigsawConfig
                 ) -> torch.Tensor:
    """The whole field [B, lat, lon, C] from every rank's block in patch
    space (an all-gather over the model ranks, rank r = i * tp + j)."""
    mesh = jcfg.rank_mesh
    parts = comm.all_gather_list(block.contiguous(), mesh.model_group)
    tp = mesh.tp_size
    rows = [torch.cat(parts[i * tp:(i + 1) * tp], dim=-1)
            for i in range(mesh.dom_size)]
    return unpatchify(torch.cat(rows, dim=-2), cfg.wm_lat, cfg.wm_lon,
                      cfg.wm_patch, cfg.wm_channels)


def forecast_step(params, fields: torch.Tensor, cfg: ModelConfig,
                  jcfg: JigsawConfig = DEFAULT_JIGSAW, *,
                  gather: bool = False) -> torch.Tensor:
    """One serving rollout step: fields [B, lat, lon, C] -> fields at +dt.
    Under ``scheme="1d"`` / ``"2d"`` it returns the rank's block in patch
    space, or, with ``gather``, the whole field on every rank."""
    out, _ = apply(params, {"fields": fields}, cfg, jcfg, rollout=1)
    if jcfg.scheme != "none" and gather:
        return gather_field(out, cfg, jcfg)
    return out
