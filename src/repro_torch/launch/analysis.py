"""The analytic FLOP and byte model of a step, and the card's peaks (the
port of the model half of ``repro/launch/analysis.py``).

The formulas are the reference's, copied: exact matmul dims per component
(``flops_forward``), a step's total by kind (``flops_step``: train =
forward + backward (2x) + the remat re-forward), approximate HBM traffic
(``hbm_bytes_step``) and the 6·N·D / 2·N model FLOPs.  The constants are
the card's, not the reference's TPU v5e values: published datasheet
figures of the NVIDIA H100 SXM5 80 GB at its 700 W power limit (a card
set below 700 W runs slower under load; ``nvidia-smi --query-gpu=
power.limit`` says which).

The reference's other half parses XLA's compiled HLO text for the
collectives' bytes and trip counts (``collective_stats``,
``roofline_from``).  The port has no compiled program to read: its
collectives are ``core/comm.py``'s calls, whose counters
(``comm.through_host`` / ``through_host_bytes``) take that parse's place
(``telemetry/accounting.py::measured_comm_bytes``).
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM5 80 GB, dense rates at the 700 W limit (datasheet)
PEAK_FLOPS_BF16 = 989.4e12     # FLOP/s, bf16 tensor cores
PEAK_FLOPS_F32 = 66.9e12       # FLOP/s, f32 FMA (no tensor cores)
HBM_BW = 3.35e12               # bytes/s, HBM3
NVLINK_BW = 450e9              # bytes/s, NVLink, each direction

PEAK_FLOPS = {"bfloat16": PEAK_FLOPS_BF16, "float32": PEAK_FLOPS_F32}


def peak_flops(dtype_name: str) -> float:
    """The card's peak for GEMMs whose operands are ``dtype_name``
    ("bfloat16" or "float32"; the f32 loop runs on the FMA units)."""
    try:
        return PEAK_FLOPS[dtype_name]
    except KeyError:
        raise ValueError(f"no peak for dtype {dtype_name!r} (have "
                         f"{sorted(PEAK_FLOPS)})") from None


def _dense_matmul_params(cfg) -> float:
    """Matmul-participating params per *layer stack* (excl. embeddings),
    counting each expert (for per-token math use active fraction)."""
    D = cfg.d_model
    hd = cfg.d_head
    attn = (D * cfg.n_heads * hd + 2 * D * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * D) if cfg.n_heads else 0
    ffn = (3 if cfg.ffn_kind == "swiglu" else 2) * D * cfg.d_ff
    ssm = 0
    if cfg.ssm_heads:
        din = cfg.ssm_d_inner
        dinp = 2 * din + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads
        ssm = D * dinp + din * D
    total = 0.0
    for i in range(cfg.n_layers):
        if cfg.family == "ssm" or not cfg.is_attn_layer(i):
            total += ssm
        else:
            total += attn
        if cfg.is_moe_layer(i):
            total += cfg.top_k * ffn     # active experts only
        elif cfg.d_ff:
            total += ffn
    return total


def flops_forward(cfg, batch: int, seq: int) -> Dict[str, float]:
    """Forward-pass FLOPs by component for one global batch."""
    D = cfg.d_model
    T = batch * seq
    out = {}
    out["matmul"] = 2.0 * _dense_matmul_params(cfg) * T
    # attention score/AV matmuls (causal not exploited)
    if cfg.n_heads:
        attn = 0.0
        for i in range(cfg.n_layers):
            if cfg.family == "ssm" or not cfg.is_attn_layer(i):
                continue
            w = cfg.layer_window(i)
            s_eff = min(seq, w) if w is not None else seq
            attn += 4.0 * batch * cfg.n_heads * cfg.d_head * seq * s_eff
        out["attention"] = attn
    # SSD chunked scan (intra-chunk quadratic + state einsums)
    if cfg.ssm_heads:
        Q = cfg.ssm_chunk
        H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        n_ssm = sum(1 for i in range(cfg.n_layers)
                    if cfg.family == "ssm" or not cfg.is_attn_layer(i))
        per_tok = (2 * Q * H * N            # CB^T within chunk
                   + 2 * Q * H * Pd         # att @ x
                   + 6 * H * Pd * N)        # states + y_inter
        out["ssd_scan"] = n_ssm * T * per_tok
    # MoE dispatch/combine einsums
    if cfg.n_experts:
        n_moe = sum(1 for i in range(cfg.n_layers) if cfg.is_moe_layer(i))
        # dispatch [T,E,C]x[T,D] + combine: 2 einsums of 2*T*(k*cf)*D
        out["moe_dispatch"] = (n_moe * 4.0 * T * cfg.top_k
                               * cfg.capacity_factor * D)
        out["router"] = n_moe * 2.0 * T * cfg.n_experts * D
    # LM head / embeddings
    if cfg.vocab_size:
        out["head"] = 2.0 * T * D * cfg.vocab_padded
    if cfg.family == "mixer":
        t_tok = (cfg.wm_lat // cfg.wm_patch) * (cfg.wm_lon // cfg.wm_patch)
        pin = cfg.wm_patch ** 2 * cfg.wm_channels
        B = batch
        out["matmul"] = 2.0 * B * (
            t_tok * pin * D * 2                                   # enc+dec
            + cfg.n_layers * (2 * t_tok * cfg.wm_d_tok * D        # token MLP
                              + 2 * t_tok * D * cfg.wm_d_ch))     # chan MLP
    return out


def flops_step(cfg, shape_kind: str, batch: int, seq: int) -> float:
    """Total FLOPs for one step of the given kind (global)."""
    f = sum(flops_forward(cfg, batch, seq).values())
    if shape_kind == "train":
        # fwd + bwd(2x) + remat re-fwd
        return f * (4.0 if cfg.remat else 3.0)
    if shape_kind == "prefill":
        return f
    # decode: one token against a cache
    fd = sum(flops_forward(cfg, batch, 1).values())
    # attention against the cache: 4*B*H*hd*S_cache per attn layer
    if cfg.n_heads:
        extra = 0.0
        for i in range(cfg.n_layers):
            if cfg.family == "ssm" or not cfg.is_attn_layer(i):
                continue
            w = cfg.layer_window(i)
            s_eff = min(seq, w) if w is not None else seq
            extra += 4.0 * batch * cfg.n_heads * cfg.d_head * s_eff
        fd += extra
    return fd


def hbm_bytes_step(cfg, shape_kind: str, batch: int, seq: int,
                   param_bytes_total: float, cache_bytes_total: float = 0.0,
                   opt_bytes_total: float = 0.0) -> float:
    """Approximate HBM traffic (global, all devices summed) for one step.

    train:   params fwd+bwd+update (3 reads + 2 writes) + opt states rw
             + activations (~14 residual-stream rw per layer, remat ~+50%)
             + attention score traffic
    prefill: params read + activations write/read once
    decode:  params read + full cache read + cache write (1 slot)
    """
    D = cfg.d_model
    T = batch * seq
    act_dtype = 2.0
    if shape_kind == "train":
        p = 3 * param_bytes_total + 2 * param_bytes_total
        p += 2 * opt_bytes_total
        act = 14.0 * cfg.n_layers * T * D * act_dtype
        if cfg.remat:
            act *= 1.5
        if cfg.n_heads:
            for i in range(cfg.n_layers):
                if cfg.family == "ssm" or not cfg.is_attn_layer(i):
                    continue
                w = cfg.layer_window(i)
                s_eff = min(seq, w) if w is not None else seq
                act += 6.0 * batch * cfg.n_heads * seq * s_eff * act_dtype
        return p + act
    if shape_kind == "prefill":
        act = 8.0 * cfg.n_layers * T * D * act_dtype
        if cfg.n_heads:
            for i in range(cfg.n_layers):
                if not cfg.is_attn_layer(i) or cfg.family == "ssm":
                    continue
                w = cfg.layer_window(i)
                s_eff = min(seq, w) if w is not None else seq
                act += 2.0 * batch * cfg.n_heads * seq * s_eff * act_dtype
        return param_bytes_total + act
    # decode
    return param_bytes_total + cache_bytes_total * 1.0 + \
        cache_bytes_total / max(seq, 1) + \
        8.0 * cfg.n_layers * batch * D * act_dtype


def _active_params(cfg) -> float:
    """``param_count()`` less the inactive experts' share."""
    n = cfg.param_count()
    if cfg.n_experts and cfg.top_k:
        moe_layers = sum(1 for i in range(cfg.n_layers)
                         if cfg.is_moe_layer(i))
        per_layer_moe = cfg.n_experts * (3 if cfg.ffn_kind == "swiglu"
                                         else 2) * cfg.d_model * cfg.d_ff
        n = n - moe_layers * per_layer_moe * (1 - cfg.top_k / cfg.n_experts)
    return n


def model_flops_train(cfg, tokens: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for one step."""
    return 6.0 * _active_params(cfg) * tokens


def model_flops_decode(cfg, new_tokens: int) -> float:
    """2*N_active per generated token (forward only)."""
    return 2.0 * _active_params(cfg) * new_tokens
