"""Shared building blocks of the port (``repro/models/layers.py``): the
LayerNorm and RMSNorm, the precision boundary cast, the Mamba-2 mixer and
the tied embedding / LM head.  Plain PyTorch, except where the reference
calls a kernel: the linears (``core/api.py``) and the Mamba-2 intra-chunk
term (``kernels/ops.py::ssd_intra``).  Norms compute in f32 and cast
back."""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import comm
from repro_torch.core.api import (DEFAULT_JIGSAW, JigsawConfig, head_config,
                                  linear_apply, linear_init)
from repro_torch.core.sharding import Mesh, Mesh1D
from repro_torch.kernels import ops


def boundary_cast(x: torch.Tensor, cfg: JigsawConfig) -> torch.Tensor:
    """Cast a model-entry tensor to the policy compute dtype so the whole
    residual stream carries it.  No-op when no compute dtype is set."""
    if cfg.compute_dtype is None:
        return x
    return x.to(cfg.compute_dtype)


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(params, x: torch.Tensor, eps: float = 1e-5,
                    mesh: Optional[Union[Mesh, Mesh1D]] = None
                    ) -> torch.Tensor:
    """LayerNorm over the last dim.  With ``mesh`` (scheme="1d" or "2d")
    that dim is the rank's block of it along the tp axis: the mean and then
    the mean of squared deviations over the whole dim are written out as
    the reductions GSPMD makes of the reference's: an all-reduce over the
    tp group of the row sums, then of the centred square sums, both in
    f32.  The scale and bias are replicated; each rank applies its slice of
    them."""
    xf = x.float()
    scale, bias = params["scale"], params["bias"]
    if mesh is None:
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    else:
        dl = xf.shape[-1]
        d = dl * mesh.tp_size
        mu = comm.all_reduce(xf.sum(dim=-1, keepdim=True), mesh.tp_group) / d
        var = comm.all_reduce(((xf - mu) ** 2).sum(dim=-1, keepdim=True),
                              mesh.tp_group) / d
        scale = scale.narrow(0, mesh.tp_index * dl, dl)
        bias = bias.narrow(0, mesh.tp_index * dl, dl)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 (SSD -- state-space duality, arXiv:2405.21060)
# ---------------------------------------------------------------------------

def softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(v, 0), with no threshold (torch's
    ``F.softplus`` returns v itself above 20)."""
    return torch.logaddexp(v, torch.zeros_like(v))


def mamba2_init(gen: torch.Generator, d_model: int, *, d_state: int = 128,
                n_heads: int = 24, head_dim: int = 64, conv_kernel: int = 4,
                n_groups: int = 1, expand: int = 2, dtype=torch.float32,
                device=None):
    """The reference's tree: the input projection split into its
    [z | xBC | dt] slices (``in_z``, ``in_xbc``, ``in_dt``), the causal
    depthwise conv, A_log, D, dt_bias (f32), the gated RMSNorm and
    ``out_proj``; weights drawn in f32 from ``gen``."""
    d_inner = n_heads * head_dim
    if d_inner != expand * d_model:
        raise ValueError(f"mamba2: n_heads*head_dim ({d_inner}) must equal "
                         f"expand*d_model ({expand * d_model})")
    conv_dim = d_inner + 2 * n_groups * d_state
    device = gen.device if device is None else device
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_z": linear_init(gen, d_model, d_inner, dtype=dtype, bias=False,
                            device=device),
        "in_xbc": linear_init(gen, d_model, conv_dim, dtype=dtype,
                              bias=False, device=device),
        "in_dt": linear_init(gen, d_model, n_heads, dtype=dtype, bias=False,
                             device=device),
        "conv_w": (torch.randn((conv_kernel, conv_dim), generator=gen, **f32)
                   * (1.0 / math.sqrt(conv_kernel))).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        "D": torch.ones((n_heads,), **f32),
        "dt_bias": torch.zeros((n_heads,), **f32),
        "norm": rmsnorm_init(d_inner, dtype, device),
        "out_proj": linear_init(gen, d_inner, d_model, dtype=dtype,
                                bias=False, device=device),
    }


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])], 1)


def _ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD chunked scan.  x: [b, s, h, p]; dt: [b, s, h] (post-softplus);
    A: [h] (negative); B, C: [b, s, g, n] with g groups broadcast to h.
    Returns y [b, s, h, p] and the final state [b, h, p, n].

    The intra-chunk (attention-like) term goes through
    ``ops.ssd_intra_heads``, the hand-written kernel on the card, which
    reads x, dt, the within-chunk cumsum and the un-repeated B and C where
    they lie and writes y_intra [b, s, h, p].  The chunk states, the
    inter-chunk recurrence (a loop over chunks, the reference's
    ``lax.scan``) and ``y_inter`` stay plain torch, as the reference's
    plain jnp, on B and C repeated over the heads.  A ragged sequence is
    zero-padded to whole chunks (dt = 0 there, so the padding adds
    nothing)."""
    b, s, h, p = x.shape
    g = B.shape[2]
    rep = h // g
    if s % chunk != 0:
        pad = chunk - s % chunk
        x, dt, B, C = (_pad_seq(t, pad) for t in (x, dt, B, C))
    sp = x.shape[1]
    nc = sp // chunk
    Bh = B.repeat_interleave(rep, dim=2)             # [b, sp, h, n]
    Ch = C.repeat_interleave(rep, dim=2)

    def ck(t):  # [b, s, ...] -> [b, nc, chunk, ...]
        return t.reshape((b, nc, chunk) + t.shape[2:])

    xc, dtc, Bc, Cc = ck(x), ck(dt), ck(Bh), ck(Ch)
    dA = dtc * A[None, None, None, :]                 # [b, nc, l, h] (<= 0)
    dA_cum = torch.cumsum(dA, dim=2)                  # within-chunk

    y_intra = ops.ssd_intra_heads(x, dt, dA_cum.reshape(b, sp, h), B, C,
                                  chunk).reshape(b, nc, chunk, h, p)

    # chunk states: sum_j exp(dA_cum[end] - dA_cum[j]) dt_j B_j x_j^T
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)   # [b,nc,l,h]
    states = torch.einsum("bzlh,bzlhn,bzlhp->bzhpn", decay_to_end * dtc, Bc,
                          xc)                                 # [b,nc,h,p,n]
    # inter-chunk recurrence over nc
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])              # [b,nc,h]
    h_prev = torch.zeros(states.shape[:1] + states.shape[2:], dtype=x.dtype,
                         device=x.device)
    h_prevs = []
    for z in range(nc):
        h_prevs.append(h_prev)
        h_prev = h_prev * chunk_decay[:, z, :, None, None] + states[:, z]
    h_prevs = torch.stack(h_prevs, dim=1)                     # [b,nc,h,p,n]
    # contribution of the carried state to each position
    state_decay = torch.exp(dA_cum)                           # [b,nc,l,h]
    y_inter = torch.einsum("bzlhn,bzhpn,bzlh->bzlhp", Cc, h_prevs,
                           state_decay)
    y = (y_intra + y_inter).reshape(b, sp, h, p)[:, :s]
    return y, h_prev


def mamba2_apply(params, x: torch.Tensor, *, d_state: int, n_heads: int,
                 head_dim: int, n_groups: int = 1, conv_kernel: int = 4,
                 chunk: int = 64, cfg: JigsawConfig = DEFAULT_JIGSAW,
                 state: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Mamba-2 mixer.  Prefill / teacher-forced: ``state=None``.  Decode:
    one token against ``state`` = {"conv": [B, K-1, conv_dim],
    "ssm": [B, H, P, N]}; returns the new state (conv in the dtype the
    window promotes to, as the reference's concatenate; ssm in the state's
    dtype)."""
    del conv_kernel                      # conv_w carries it
    b, s, _ = x.shape
    d_inner = n_heads * head_dim
    z = linear_apply(params["in_z"], x, cfg)
    xBC = linear_apply(params["in_xbc"], x, cfg)
    dt = linear_apply(params["in_dt"], x, cfg)
    dt = softplus(dt.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    split = [d_inner, n_groups * d_state, n_groups * d_state]
    cw = params["conv_w"]                                 # [K, conv_dim]
    k = cw.shape[0]

    new_state = None
    if state is None:
        # causal depthwise conv over the sequence
        xp = torch.cat([xBC.new_zeros((b, k - 1, xBC.shape[2])), xBC], 1)
        conv = sum(xp[:, i:i + s, :] * cw[i][None, None, :] for i in range(k))
        xBC = F.silu(conv + params["conv_b"][None, None, :])
        xs, B, C = torch.split(xBC, split, dim=-1)
        xs = xs.reshape(b, s, n_heads, head_dim)
        B = B.reshape(b, s, n_groups, d_state)
        C = C.reshape(b, s, n_groups, d_state)
        y, _ = _ssd_chunked(xs.float(), dt, A, B.float(), C.float(), chunk)
        y = y + xs.float() * params["D"][None, None, :, None]
    else:
        # single-token decode
        window = torch.cat([state["conv"], xBC], dim=1)   # [B, K, conv]
        wdt = torch.promote_types(window.dtype, cw.dtype)
        conv = torch.einsum("bkc,kc->bc", window.to(wdt),
                            cw.to(wdt))[:, None, :]
        xBC = F.silu(conv + params["conv_b"][None, None, :])
        xs, B, C = torch.split(xBC, split, dim=-1)
        xs = xs.reshape(b, 1, n_heads, head_dim).float()
        B = B.reshape(b, 1, n_groups, d_state).float()
        C = C.reshape(b, 1, n_groups, d_state).float()
        rep = n_heads // n_groups
        Bh = B[:, 0].repeat_interleave(rep, dim=1)        # [B, H, N]
        Ch = C[:, 0].repeat_interleave(rep, dim=1)
        dA = torch.exp(dt[:, 0, :] * A[None, :])          # [B, H]
        ssm = state["ssm"].float()                        # [B, H, P, N]
        upd = torch.einsum("bh,bhn,bhp->bhpn", dt[:, 0], Bh, xs[:, 0])
        ssm_new = ssm * dA[:, :, None, None] + upd
        y = torch.einsum("bhn,bhpn->bhp", Ch, ssm_new)[:, None]
        y = y + xs * params["D"][None, None, :, None]
        new_state = {"conv": window[:, 1:],
                     "ssm": ssm_new.to(state["ssm"].dtype)}

    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm_apply(params["norm"], y)
    out = linear_apply(params["out_proj"], y, cfg)
    return out, new_state


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype=torch.float32, device=None):
    device = gen.device if device is None else device
    tbl = torch.randn((vocab, d_model), generator=gen, dtype=torch.float32,
                      device=device) * (1.0 / math.sqrt(d_model))
    return {"table": tbl.to(dtype)}


def embed_apply(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens.long()]


def unembed_apply(params_embed, x: torch.Tensor,
                  cfg: JigsawConfig = DEFAULT_JIGSAW) -> torch.Tensor:
    """Tied LM head: logits = x @ table.T, a linear over d_model under the
    head's Jigsaw config (``core/api.py::head_config``)."""
    return linear_apply({"w": params_embed["table"]}, x, head_config(cfg))
