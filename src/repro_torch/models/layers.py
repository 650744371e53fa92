"""Shared building blocks of the port (``repro/models/layers.py``): the
LayerNorm and RMSNorm, the precision boundary cast, rotary embeddings,
attention (GQA; causal, sliding-window, bidirectional and cross; the
decode step's KV cache), the feed-forward variants, the mixture of experts
(GShard top-k routing with capacity drops), the Mamba-2 mixer and the tied
embedding / LM head.
Plain PyTorch, except where the reference calls a kernel: the linears
(``core/api.py``; the MoE router among them) and the Mamba-2 intra-chunk
term (``kernels/ops.py::ssd_intra``).  The experts' products are plain
einsums, as the reference's.  The reference computes attention in
plain jnp, outside any Pallas kernel, so the port's is plain torch in the
reference's order of roundings (``sdpa``).  Norms compute in f32 and cast
back."""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import comm
from repro_torch.core.api import (DEFAULT_JIGSAW, JigsawConfig, head_apply,
                                  linear_apply, linear_init, mlp_apply,
                                  mlp_init)
from repro_torch.core.sharding import Mesh, Mesh1D
from repro_torch.kernels import fused_ring, ops


def mesh_1d(cfg: JigsawConfig) -> Optional[Mesh1D]:
    """A language model's rank mesh: the 1-D model mesh under
    ``scheme="1d"``, else None (one device or a data-only mesh)."""
    return cfg.mesh_1d if cfg.scheme == "1d" else None


def boundary_cast(x: torch.Tensor, cfg: JigsawConfig) -> torch.Tensor:
    """Cast a model-entry tensor to the policy compute dtype so the whole
    residual stream carries it.  No-op when no compute dtype is set."""
    if cfg.compute_dtype is None:
        return x
    return x.to(cfg.compute_dtype)


def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-6,
                  mesh: Optional[Union[Mesh, Mesh1D]] = None
                  ) -> torch.Tensor:
    """RMSNorm over the last dim, in f32.  With ``mesh`` that dim is the
    rank's block of it along the tp axis: the row sums of squares are
    all-reduced over the tp group in f32 and divided by the whole dim (the
    reduction GSPMD makes of the reference's mean), and each rank applies
    its slice of the replicated scale."""
    xf = x.float()
    scale = params["scale"]
    if mesh is None:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    else:
        dl = xf.shape[-1]
        var = comm.all_reduce((xf * xf).sum(dim=-1, keepdim=True),
                              mesh.tp_group) / (dl * mesh.tp_size)
        scale = scale.narrow(0, mesh.tp_index * dl, dl)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


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
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] or [S].  Rotates the pairs
    (even half, odd half), as llama; the angles in f32, the output in x's
    dtype."""
    half = x.shape[-1] // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device)
    inv = 1.0 / (theta ** (freq / half))
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * inv               # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; full-causal / sliding-window)
# ---------------------------------------------------------------------------

def attention_init(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, d_head: int, *, dtype=torch.float32,
                   bias: bool = False, device=None):
    kw = dict(dtype=dtype, bias=bias, device=device)
    return {"wq": linear_init(gen, d_model, n_heads * d_head, **kw),
            "wk": linear_init(gen, d_model, n_kv_heads * d_head, **kw),
            "wv": linear_init(gen, d_model, n_kv_heads * d_head, **kw),
            "wo": linear_init(gen, n_heads * d_head, d_model, **kw)}


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, hd] -> [B, S, Hkv * n_rep, hd], each kv head repeated
    for the n_rep query heads of its group."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool = True,
         window: Optional[int] = None,
         kv_mask: Optional[torch.Tensor] = None,
         soft_cap: Optional[float] = None) -> torch.Tensor:
    """Scaled dot-product attention, the GQA repeat done by the caller.

    q: [B, Sq, H, hd]; k, v: [B, Skv, H, hd]; q_pos [B, Sq] or [Sq] and
    kv_pos [B, Skv] or [Skv] the absolute positions of the queries and
    keys (a rolling cache's slots hold positions out of order); kv_mask
    [B, Skv] the valid cache slots.  The reference's order of roundings:
    the scores in f32 (each product of q and k exact in f32, never rounded
    to q's dtype), then the scale, the soft cap and the -1e30 mask; the
    softmax in f32, the probabilities cast to q's dtype, then ``@ v`` (in
    the promoted dtype where v's differs).
    1-D positions keep the mask [Sq, Skv], batch-free."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores.mul_(scale)
    if soft_cap is not None:
        scores = torch.tanh(scores / soft_cap) * soft_cap
    dq = q_pos[..., :, None]            # [.., Sq, 1]
    dk = kv_pos[..., None, :]           # [.., 1, Skv]
    mask = None
    if causal:
        mask = dk <= dq
    if window is not None:
        m = dq - dk < window
        mask = m if mask is None else mask & m
    if kv_mask is not None:
        m = kv_mask[..., None, :].expand(*kv_mask.shape[:-1], dq.shape[-2],
                                         kv_mask.shape[-1])
        mask = m if mask is None else mask & m
    if mask is not None:
        mask = mask[None, None] if mask.ndim == 2 else mask[:, None]
        scores.masked_fill_(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    del scores
    # jnp.einsum promotes mixed operands (bf16 queries against f32 keys
    # and values: cross-attention to f32 encoder states)
    return _einsum("bhqk,bkhd->bqhd", probs, v)


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 q_pos: torch.Tensor, kv_pos: torch.Tensor,
                 causal: bool = True, window: Optional[int] = None,
                 q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """Memory-bounded attention: query chunks, each with an online softmax
    over key/value chunks (the flash-attention recurrence in plain torch),
    so the largest score buffer is [B, H, q_chunk, kv_chunk].  1-D
    positions only, no kv_mask or soft cap (``attention_apply`` takes
    ``sdpa`` there)."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    if q_pos.ndim != 1 or kv_pos.ndim != 1:
        raise ValueError("sdpa_chunked: 1-D positions only")
    scale = 1.0 / math.sqrt(hd)
    nq, nk = -(-sq // q_chunk), -(-skv // kv_chunk)
    q_pad, kv_pad = nq * q_chunk - sq, nk * kv_chunk - skv
    if q_pad:
        q = _pad_seq(q, q_pad)
        q_pos = F.pad(q_pos, (0, q_pad), value=-(2 ** 30))
    if kv_pad:
        k, v = _pad_seq(k, kv_pad), _pad_seq(v, kv_pad)
        kv_pos = F.pad(kv_pos, (0, kv_pad), value=2 ** 30)
    qc = q.reshape(b, nq, q_chunk, h, hd).permute(1, 0, 3, 2, 4)
    kc = k.reshape(b, nk, kv_chunk, h, hd).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, nk, kv_chunk, h, hd).permute(1, 0, 3, 2, 4)
    qp = q_pos.reshape(nq, q_chunk)
    kp = kv_pos.reshape(nk, kv_chunk)
    f32 = dict(dtype=torch.float32, device=q.device)
    outs = []
    for qi, qpi in zip(qc, qp):                     # [B, H, Qc, hd], [Qc]
        m = torch.full((b, h, q_chunk), -math.inf, **f32)
        l = torch.zeros((b, h, q_chunk), **f32)
        acc = torch.zeros((b, h, q_chunk, hd), **f32)
        for ki, vi, kpi in zip(kc, vc, kp):
            s = torch.einsum("bhqd,bhkd->bhqk", qi.float(), ki.float()) * scale
            msk = None
            if causal:
                msk = kpi[None, :] <= qpi[:, None]
            if window is not None:
                mw = qpi[:, None] - kpi[None, :] < window
                msk = mw if msk is None else msk & mw
            if msk is not None:
                s = s.masked_fill(~msk[None, None], -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vi.dtype), vi)
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(
        b, nq * q_chunk, h, hd)
    return out[:, :sq]


def attention_apply(params, x: torch.Tensor, *, n_heads: int,
                    n_kv_heads: int, d_head: int, positions: torch.Tensor,
                    cfg: JigsawConfig = DEFAULT_JIGSAW,
                    causal: bool = True, window: Optional[int] = None,
                    rope_theta: Optional[float] = 10000.0,
                    soft_cap: Optional[float] = None,
                    kv_cache: Optional[dict] = None, rolling: bool = False,
                    collect_kv: bool = False,
                    x_kv: Optional[torch.Tensor] = None,
                    qk_norm: Optional[dict] = None, q_chunk: int = 0,
                    mesh: Optional[Mesh1D] = None
                    ) -> Tuple[torch.Tensor, Optional[dict]]:
    """The attention layer: the q, k, v projections, qk_norm (RMSNorm over
    d_head), RoPE, attention, the output projection.  Causal self-attention
    by default; ``causal=False`` is bidirectional (the enc-dec family's
    encoder), and ``x_kv`` [B, F, D] makes it cross-attention: k and v
    project ``x_kv``, RoPE is skipped, the keys sit at positions
    ``arange(F)`` and no mask applies (the decoder attending to the
    encoder's states; no cache).

    Training / prefill: x [B, S, D], positions [S] (or [B, S]), no cache;
    ``collect_kv`` returns every position's post-RoPE k and v, before the
    GQA repeat ({"k", "v"}: what the decode branch would have cached token
    by token).  Decode: x [B, 1, D], positions [B, 1], kv_cache = {"k":
    [B, S_max, Hkv, hd], "v": ..., "pos": [B] the next write offset}: the
    new k and v are written into the cache's tensors in place, at slot
    ``pos % S_max`` (``rolling``, a sliding-window cache) or ``min(pos,
    S_max - 1)``, and attention reads the whole cache; returns {"k", "v"}
    (the same tensors) and "pos" + 1.  Everything is computed on the
    device from ``pos``, with no host read, so the step can be captured
    in a CUDA graph.

    With ``mesh`` (a 1-D model mesh of p ranks, ``cfg.scheme="1d"``;
    training, no cache): x is the rank's block [B, S, D/p] and the rank
    runs its ``n_heads / p`` heads, the contiguous out blocks of wq
    (whole heads).  Where p divides ``n_kv_heads`` the out blocks of wk
    and wv are the kv heads those q heads read (GQA's map stays within a
    rank); else k and v are all-gathered over the tp group and the rank
    takes the kv head of each of its q heads.  The qk-norm and RoPE run
    per head as above, and wo contracts the cut heads.
    Not ported: the reference's ``kv_spec`` (the cache's layout on a model
    mesh; the port serves a language model on one device or a data-only
    mesh)."""
    b, s, _ = x.shape
    xkv = x if x_kv is None else x_kv
    f = xkv.shape[1]
    p = 1 if mesh is None else mesh.tp_size
    h_l = n_heads // p
    q = linear_apply(params["wq"], x, cfg).reshape(b, s, h_l, d_head)
    k = linear_apply(params["wk"], xkv, cfg)
    v = linear_apply(params["wv"], xkv, cfg)
    n_rep = n_heads // n_kv_heads
    if p > 1 and n_kv_heads % p:
        # each q head's kv head, out of the kv heads gathered whole
        heads = torch.arange(mesh.tp_index * h_l, (mesh.tp_index + 1) * h_l,
                             device=x.device) // n_rep
        k, v = (comm.all_gather(t, mesh.tp_group, -1)
                .reshape(b, f, n_kv_heads, d_head)[:, :, heads]
                for t in (k, v))
        n_rep = 1
    else:
        k = k.reshape(b, f, n_kv_heads // p, d_head)
        v = v.reshape(b, f, n_kv_heads // p, d_head)
    if qk_norm is not None:
        q = rmsnorm_apply(qk_norm["q"], q)
        k = rmsnorm_apply(qk_norm["k"], k)
    if rope_theta is not None and x_kv is None:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)

    new_cache = None
    if kv_cache is not None:
        ck, cv, pos = kv_cache["k"], kv_cache["v"], kv_cache["pos"]
        s_max = ck.shape[1]
        # floor modulo (Python's): slot - i below goes negative
        slot = (torch.remainder(pos, s_max) if rolling
                else pos.clamp(max=s_max - 1))
        rows = (torch.arange(b, device=pos.device), slot.long())
        ck.index_put_(rows, k[:, 0].to(ck.dtype))
        cv.index_put_(rows, v[:, 0].to(cv.dtype))
        slot_idx = torch.arange(s_max, device=pos.device)[None, :]
        if rolling:
            # slot i holds absolute position pos - ((slot - i) % s_max)
            kv_pos = pos[:, None] - torch.remainder(slot[:, None] - slot_idx,
                                                    s_max)
        else:
            kv_pos = slot_idx.expand(b, s_max)
        kv_mask = (kv_pos >= 0) & (kv_pos <= pos[:, None])
        out = sdpa(q, _repeat_kv(ck.to(q.dtype), n_rep),
                   _repeat_kv(cv.to(q.dtype), n_rep), q_pos=positions,
                   kv_pos=kv_pos, causal=True, window=window,
                   kv_mask=kv_mask, soft_cap=soft_cap)
        new_cache = {"k": ck, "v": cv, "pos": pos + 1}
    else:
        if collect_kv:
            new_cache = {"k": k, "v": v}
        kk, vv = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
        kv_pos = (positions if x_kv is None
                  else torch.arange(f, device=x.device))
        masked = causal and x_kv is None
        if q_chunk and positions.ndim == 1 and soft_cap is None:
            out = sdpa_chunked(q, kk, vv, q_pos=positions, kv_pos=kv_pos,
                               causal=masked, window=window,
                               q_chunk=q_chunk)
        else:
            out = sdpa(q, kk, vv, q_pos=positions, kv_pos=kv_pos,
                       causal=masked, window=window, soft_cap=soft_cap)
    out = out.reshape(b, s, h_l * d_head)
    return linear_apply(params["wo"], out, cfg), new_cache


# ---------------------------------------------------------------------------
# Feed-forward variants
# ---------------------------------------------------------------------------

def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             kind: str = "swiglu", dtype=torch.float32, bias: bool = False,
             device=None):
    kw = dict(dtype=dtype, bias=bias, device=device)
    if kind == "swiglu":
        return {"gate": linear_init(gen, d_model, d_ff, **kw),
                "up": linear_init(gen, d_model, d_ff, **kw),
                "down": linear_init(gen, d_ff, d_model, **kw)}
    if kind == "gelu":
        return mlp_init(gen, d_model, d_ff, d_model, **kw)
    raise ValueError(kind)


def ffn_apply(params, x: torch.Tensor,
              cfg: JigsawConfig = DEFAULT_JIGSAW) -> torch.Tensor:
    """SwiGLU (``silu(gate) * up``, then ``down``) or the GELU MLP (under
    kernel="pallas" its GELU rides the first GEMM's epilogue)."""
    if "gate" in params:
        g = linear_apply(params["gate"], x, cfg)
        u = linear_apply(params["up"], x, cfg)
        return linear_apply(params["down"], F.silu(g) * u, cfg)
    return mlp_apply({"fc1": params["fc1"], "fc2": params["fc2"]}, x, cfg)


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k router, capacity-based one-hot dispatch, GShard)
# ---------------------------------------------------------------------------

def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             *, kind: str = "swiglu", dtype=torch.float32, device=None):
    """The reference's tree: the f32 router [E, d_model] (no bias) and the
    experts' stacked weights, [E, d_ff, d_model] in, [E, d_model, d_ff]
    out, drawn in f32 from ``gen`` and cast to ``dtype``."""
    device = gen.device if device is None else device
    router = linear_init(gen, d_model, n_experts, dtype=torch.float32,
                         bias=False, device=device)

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) / math.sqrt(fan_in)).to(dtype)
    up = (n_experts, d_ff, d_model)
    down = (n_experts, d_model, d_ff)
    if kind == "swiglu":
        experts = {"gate": normal(up, d_model), "up": normal(up, d_model),
                   "down": normal(down, d_ff)}
    elif kind == "gelu":
        experts = {"fc1": normal(up, d_model), "fc2": normal(down, d_ff)}
    else:
        raise ValueError(kind)
    return {"router": router, "experts": experts}


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last dim in x's dtype: exp(x - max),
    then over its sum."""
    u = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return u / u.sum(dim=-1, keepdim=True)


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a comparison with an arange, so an index outside
    [0, n) gives a row of zeros (``F.one_hot`` raises there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` of two operands: both in their promoted dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def moe_route(router, xg: torch.Tensor, top_k: int, capacity: int,
              cfg: JigsawConfig = DEFAULT_JIGSAW):
    """The router of ``moe_apply`` on the groups xg [G, gs, D]: the f32
    router linear (``scheme="none"``: a block_matmul launch under
    ``kernel="pallas"``), the softmax, the top k of a stable descending
    sort (ties to the lower index, as ``jax.lax.top_k``), the gates
    normalised over the k, and each (token, k)'s place in its expert's
    buffer: the exclusive cumsum over the flattened (token, k) order,
    kept where below ``capacity``.  Returns (probs [G, gs, E], gate_vals,
    gate_idx, pos, keep [G, gs, k]); no host read."""
    logits = linear_apply(router, xg.float(), cfg.replace(scheme="none"))
    probs = _softmax(logits)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :top_k], idx[..., :top_k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp(
        min=1e-9)
    g, gs, e = probs.shape
    onehot = _one_hot(gate_idx, e, torch.int32)             # [G, gs, k, E]
    flat = onehot.reshape(g, gs * top_k, e)
    before = (torch.cumsum(flat, dim=1) - flat).reshape(g, gs, top_k, e)
    pos = (before * onehot).sum(dim=-1)                     # [G, gs, k]
    return probs, gate_vals, gate_idx, pos, pos < capacity


def moe_apply(params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25,
              cfg: JigsawConfig = DEFAULT_JIGSAW,
              group_size: int = 1024,
              mesh: Optional[Mesh1D] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style grouped MoE: (output [B, S, D], aux loss).  The tokens
    are split into groups of ``group_size`` (the last one zero-padded; its
    pad rows are routed and count in the aux loss, as in the reference),
    each routed on its own (``moe_route``) with capacity ``max(1,
    int(capacity_factor * top_k * gs / E))`` a group and expert, so a
    token past its expert's capacity is dropped (adds nothing).  The
    dispatch and combine one-hots [G, gs, E, C] are built one k at a time
    in x's dtype; the expert products are plain einsums, as the
    reference's (it calls no kernel there).  The aux loss is the
    Switch/GShard load balance over all groups.

    With ``mesh`` (a 1-D model mesh of p ranks; expert parallelism, the
    reference's expert stacks cut on their E dim): x is the rank's feature
    block [B, S, D/p] and ``params["experts"]`` the rank's E/p experts
    [r*E/p, (r+1)*E/p).  The features are all-gathered over the tp group
    (``fused_ring.gather_features``: on the card through the ring
    workspace's IPC slots), every rank routes all tokens with the whole
    router and the whole expert count (the same routes, drops and aux on
    every rank), dispatches only into its experts (its slice of the
    one-hots), runs them, and its partial output [T, D] is reduce-scattered
    over D back to [B, S, D/p] (``fused_ring.scatter_features``, summed in
    f32).  Every rank returns the whole aux; the caller counts its
    gradient once (``train/step.py::lm_loss_fn``)."""
    e = params["router"]["w"].shape[0]
    if mesh is not None and mesh.tp_size > 1:
        x = fused_ring.gather_features(x, mesh.tp_group, mesh.tp_size,
                                       mesh.tp_index, "moe")
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    gs = min(group_size, t)
    pad = (-t) % gs
    if pad:
        xt = torch.cat([xt, xt.new_zeros((pad, d))])
    g = xt.shape[0] // gs
    xg = xt.reshape(g, gs, d)
    capacity = max(1, int(capacity_factor * top_k * gs / e))
    probs, gate_vals, gate_idx, pos, keep = moe_route(
        params["router"], xg, top_k, capacity, cfg)

    me = probs.float().mean(dim=(0, 1)).to(probs.dtype)            # [E]
    ce = _one_hot(gate_idx, e, torch.int32).sum(dim=2).float().mean(
        dim=(0, 1))
    aux = e * (me * ce).sum()

    w = params["experts"]
    e_l = next(iter(w.values())).shape[0]        # the rank's experts
    first = 0 if mesh is None else mesh.tp_index * e_l
    dispatch = x.new_zeros((g, gs, e_l, capacity))
    combine = x.new_zeros((g, gs, e_l, capacity))
    for kk in range(top_k):
        term = (_one_hot(gate_idx[..., kk] - first, e_l, x.dtype)[..., None]
                * _one_hot(pos[..., kk], capacity, x.dtype)[..., None, :])
        term = term * keep[..., kk, None, None].to(x.dtype)
        dispatch = dispatch + term
        combine = combine + term * gate_vals[..., kk, None, None].to(x.dtype)

    xe = _einsum("gtec,gtd->gecd", dispatch, xg)                # [G, E, C, D]
    if "gate" in w:
        gt = _einsum("gecd,efd->gecf", xe, w["gate"])
        u = _einsum("gecd,efd->gecf", xe, w["up"])
        ye = _einsum("gecf,edf->gecd", F.silu(gt) * u, w["down"])
    else:
        h = F.gelu(_einsum("gecd,efd->gecf", xe, w["fc1"]),
                   approximate="tanh")
        ye = _einsum("gecf,edf->gecd", h, w["fc2"])
    yt = _einsum("gtec,gecd->gtd", combine, ye).reshape(g * gs, d)
    y = yt[:t].reshape(b, s, d)
    if mesh is not None and mesh.tp_size > 1:
        y = fused_ring.scatter_features(y, mesh.tp_group, mesh.tp_size,
                                        mesh.tp_index, "moe")
    return y, aux


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


def _heads_channels(xbc: torch.Tensor, mesh: Mesh1D, d_inner: int,
                    n_groups: int, d_state: int) -> torch.Tensor:
    """Re-lay the conv's output channels from the rank's contiguous block
    of ``conv_dim = d_inner + 2 * n_groups * d_state`` (the layout of
    ``in_xbc`` and ``conv_w`` cut on ``model``, which need not fall on
    head bounds) to the rank's heads: its block of the x channels, then
    the B and C channels of its groups (all of them when ``n_groups`` is
    1, its ``n_groups / p`` else).  The blocks are all-gathered over the
    tp group (``fused_ring.gather_features``: on the card through the ring
    workspace's IPC slots; (p - 1) / p of [B, S, conv_dim] a rank), then
    sliced: exact, and the gather's backward sums each channel's
    gradient over the ranks that read it."""
    p, r = mesh.tp_size, mesh.tp_index
    whole = fused_ring.gather_features(xbc, mesh.tp_group, p, r,
                                       "ssm_channels")
    di, gn = d_inner // p, n_groups * d_state
    g0, gl = (0, gn) if n_groups == 1 else (r * gn // p, gn // p)
    return torch.cat([whole[..., r * di:(r + 1) * di],
                      whole[..., d_inner + g0:d_inner + g0 + gl],
                      whole[..., d_inner + gn + g0:d_inner + gn + g0 + gl]],
                     dim=-1)


def mamba2_apply(params, x: torch.Tensor, *, d_state: int, n_heads: int,
                 head_dim: int, n_groups: int = 1, conv_kernel: int = 4,
                 chunk: int = 64, cfg: JigsawConfig = DEFAULT_JIGSAW,
                 state: Optional[dict] = None,
                 mesh: Optional[Mesh1D] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Mamba-2 mixer.  Prefill / teacher-forced: ``state=None``.  Decode:
    one token against ``state`` = {"conv": [B, K-1, conv_dim],
    "ssm": [B, H, P, N]}; returns the new state (conv in the dtype the
    window promotes to, as the reference's concatenate; ssm in the state's
    dtype).

    With ``mesh`` (a 1-D model mesh of p ranks, ``cfg.scheme="1d"``;
    teacher-forced only: a decode state raises) the rank runs its
    ``n_heads / p`` heads: x is its feature block [B, S, D/p]; ``in_z``
    and ``in_dt`` give its heads' blocks of z and dt (``jigsaw_linear``);
    ``in_xbc`` and ``conv_w`` hold the rank's contiguous block of the conv
    channels, so the depthwise conv and SiLU run on that block (with its
    slice of the whole ``conv_b``) and ``_heads_channels`` re-lays the
    result to the rank's heads' x and its groups' B and C.  The SSD scan
    runs the rank's heads (``A_log``, ``D`` and ``dt_bias`` sliced to
    them; local head k reads local group k // (heads per group)), the
    gated RMSNorm reduces over the cut d_inner (``rmsnorm_apply(mesh=)``)
    and ``out_proj`` contracts the rank's d_inner block.  A group count
    that p neither divides nor equals 1 raises ValueError."""
    del conv_kernel                      # conv_w carries it
    b, s, _ = x.shape
    p = 1 if mesh is None else mesh.tp_size
    if p > 1:
        if state is not None:
            raise NotImplementedError(
                "mamba2_apply: a decode step on a model mesh (serving on a "
                "model mesh: ROADMAP.md, queue 1 item 19)")
        if n_groups > 1 and n_groups % p:
            raise ValueError(f"mamba2_apply: {n_groups} groups on {p} "
                             "ranks (p must divide the groups or they "
                             "must be 1)")
    d_inner = n_heads * head_dim
    z = linear_apply(params["in_z"], x, cfg)
    xBC = linear_apply(params["in_xbc"], x, cfg)
    dt = linear_apply(params["in_dt"], x, cfg)
    # the rank's heads and groups (all of them on one rank)
    h_l, g_l = n_heads // p, n_groups if n_groups == 1 else n_groups // p
    heads, conv_b = slice(None), params["conv_b"]
    if p > 1:
        r, c_l = mesh.tp_index, xBC.shape[-1]
        heads = slice(r * h_l, (r + 1) * h_l)
        conv_b = conv_b[r * c_l:(r + 1) * c_l]
    dt = softplus(dt.float() + params["dt_bias"][heads][None, None, :])
    A = -torch.exp(params["A_log"][heads])
    split = [h_l * head_dim, g_l * d_state, g_l * d_state]
    cw = params["conv_w"]                                 # [K, conv_dim]
    k = cw.shape[0]

    new_state = None
    if state is None:
        # causal depthwise conv over the sequence
        xp = torch.cat([xBC.new_zeros((b, k - 1, xBC.shape[2])), xBC], 1)
        conv = sum(xp[:, i:i + s, :] * cw[i][None, None, :] for i in range(k))
        xBC = F.silu(conv + conv_b[None, None, :])
        if p > 1:
            xBC = _heads_channels(xBC, mesh, d_inner, n_groups, d_state)
        xs, B, C = torch.split(xBC, split, dim=-1)
        xs = xs.reshape(b, s, h_l, head_dim)
        B = B.reshape(b, s, g_l, d_state)
        C = C.reshape(b, s, g_l, d_state)
        y, _ = _ssd_chunked(xs.float(), dt, A, B.float(), C.float(), chunk)
        y = y + xs.float() * params["D"][heads][None, None, :, None]
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

    y = y.reshape(b, s, h_l * head_dim).to(x.dtype)
    y = y * F.silu(z)
    y = rmsnorm_apply(params["norm"], y, mesh=mesh)
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


def embed_apply(params, tokens: torch.Tensor,
                mesh: Optional[Mesh1D] = None) -> torch.Tensor:
    """The rows of the table [V, D] at ``tokens``.  With ``mesh`` (a 1-D
    model mesh) the table is the rank's block of vocab rows [V/p, D]: an
    id outside it gives a zero row, and the rows are reduce-scattered over
    D, which leaves x in the 1-D layout [B, S, D/p].  Every sum has one
    non-zero term, so the rows are exact (summed in f32, which holds every
    table dtype); the backward all-gathers dx over D and scatter-adds it
    into the rank's rows."""
    table = params["table"]
    if mesh is None:
        return table[tokens.long()]
    vl = table.shape[0]
    local = tokens.long() - mesh.tp_index * vl
    hit = (local >= 0) & (local < vl)
    rows = torch.where(hit[..., None], table[local.clamp(0, vl - 1)], 0.0)
    return comm.reduce_scatter(rows.float(), mesh.tp_group, -1).to(
        table.dtype)


def unembed_apply(params_embed, x: torch.Tensor,
                  cfg: JigsawConfig = DEFAULT_JIGSAW) -> torch.Tensor:
    """Tied LM head: logits = x @ table.T (``core/api.py::head_apply``:
    under ``scheme="1d"`` the rank's vocab block of them)."""
    return head_apply(params_embed["table"], x, cfg)
