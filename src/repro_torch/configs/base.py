"""Architecture configuration system (the port's copy of
``repro/configs/base.py``).

Every architecture gets a ``configs/<id>.py`` exporting ``CONFIG`` (exact
published dimensions, source cited) built on this dataclass.  ``reduced()``
derives the CPU smoke-test variant of the same family.  The fields and
``reduced()`` are those of the JAX package, so a config built here equals
its reference field by field, and ``param_count()`` is the reference's
formula for every family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional



def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense|moe|hybrid|ssm|vlm|audio|mixer
    n_layers: int
    d_model: int
    # --- attention ---
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0                # 0 -> d_model // n_heads
    rope_theta: Optional[float] = 10000.0
    attn_bias: bool = False
    attn_soft_cap: Optional[float] = None
    qk_norm: bool = False
    sliding_window: Optional[int] = None   # all layers (SWA archs)
    attn_q_chunk: int = 0                  # >0: chunked online-softmax attn
    kv_shard: str = "auto"                 # decode cache: auto|heads|seq|headdim
    local_window: Optional[int] = None     # local layers (local:global)
    local_global_ratio: int = 0            # N local : 1 global; 0 = off
    # --- ffn ---
    d_ff: int = 0
    ffn_kind: str = "swiglu"               # swiglu|gelu
    # --- vocab / embeddings ---
    vocab_size: int = 0
    tie_embeddings: bool = True
    norm: str = "rmsnorm"                  # rmsnorm|layernorm
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_every: int = 1                     # layer i is MoE iff i % moe_every
    moe_offset: int = 0                    #   == moe_offset (when n_experts)
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 64
    ssm_expand: int = 2
    attn_every: int = 0                    # hybrid: 1 attn layer per this
    attn_offset: int = 0
    # --- enc-dec / frontends (stubs provide the embeddings) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_frames: int = 1500                   # audio frontend stub output len
    n_patches: int = 1024                  # vision frontend stub output len
    # --- WeatherMixer ---
    wm_lat: int = 0
    wm_lon: int = 0
    wm_channels: int = 0
    wm_patch: int = 0
    wm_d_tok: int = 0                      # token-mixing hidden dim
    wm_d_ch: int = 0                       # channel-mixing hidden dim
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    precision: Optional[str] = None        # policy preset (core/precision):
                                           # fp32|bf16|bf16_pure; None =
                                           # legacy dtypes above, fp32 accum
    # --- parallelism defaults (overridable from the launcher) ---
    scheme: str = "1d"                     # jigsaw scheme: 1d|2d|none
    impl: str = "rs"                       # 1d impl: ring|ring_chunked|
                                           #   ring_fused|rs|gspmd|allreduce
    kernel: str = "xla"                    # local GEMM engine: xla|pallas
    shard_params_over_data: bool = False   # FSDP-hybrid for >~25B params
    remat: bool = True
    # --- capability flags ---
    supports_decode: bool = True
    supports_long_context: bool = False    # sub-quadratic decode at 500k
    source: str = ""                       # citation

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.n_heads and not self.d_head:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so the LM head shards evenly 16-way."""
        return pad_to_multiple(self.vocab_size, 256) if self.vocab_size else 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    def is_moe_layer(self, i: int) -> bool:
        return (self.n_experts > 0 and self.moe_every > 0
                and i % self.moe_every == self.moe_offset)

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid archs: which layers are attention (vs SSM)."""
        if self.attn_every <= 0:
            return True
        return i % self.attn_every == self.attn_offset

    def layer_window(self, i: int) -> Optional[int]:
        """Attention window for layer i (None = full causal)."""
        if self.sliding_window is not None:
            return self.sliding_window
        if self.local_global_ratio > 0:
            # pattern: ratio local layers, then 1 global
            if i % (self.local_global_ratio + 1) != self.local_global_ratio:
                return self.local_window
        return None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        kw = dict(
            n_layers=2, d_model=min(self.d_model, 256),
            param_dtype="float32", compute_dtype="float32", precision=None,
            scheme="none", remat=False, shard_params_over_data=False,
            # pallas on CPU is interpret-mode (slow): smoke tests opt in
            # explicitly instead of inheriting the production default;
            # impl resets with scheme (a 1-D impl under scheme="none"
            # would trip the JigsawConfig ignored-impl warning)
            kernel="xla", impl="rs",
        )
        if self.n_heads:
            kw["n_heads"] = min(self.n_heads, 4)
            kw["n_kv_heads"] = min(self.n_kv_heads or self.n_heads, 2)
            kw["d_head"] = kw["d_model"] // kw["n_heads"]
        if self.d_ff:
            kw["d_ff"] = min(self.d_ff, 512)
        if self.vocab_size:
            kw["vocab_size"] = min(self.vocab_size, 1024)
        if self.n_experts:
            kw["n_experts"] = min(self.n_experts, 4)
            kw["top_k"] = min(self.top_k, 2)
        if self.ssm_heads:
            kw["ssm_heads"] = 8
            kw["ssm_head_dim"] = (kw["d_model"] * self.ssm_expand) // 8
            kw["ssm_state"] = min(self.ssm_state, 32)
        if self.attn_every:
            kw["attn_every"] = 2
            kw["attn_offset"] = min(self.attn_offset, 1)
        if self.moe_every > 1:
            kw["moe_every"] = 2
        if self.n_enc_layers:
            kw["n_enc_layers"] = 2
        if self.enc_dec:
            kw["n_frames"] = 64
        if self.family == "vlm":
            kw["n_patches"] = 16
        if self.sliding_window:
            kw["sliding_window"] = 64
        if self.local_window:
            kw["local_window"] = 32
        if self.wm_lat:
            kw.update(wm_lat=32, wm_lon=64, wm_channels=8, wm_patch=4,
                      wm_d_tok=128, wm_d_ch=128, d_model=128)
        return self.replace(**kw)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D and the
        zero-redundancy memory checks)."""
        n = 0
        D = self.d_model
        if self.family == "mixer":
            t = (self.wm_lat // self.wm_patch) * (self.wm_lon // self.wm_patch)
            pin = self.wm_patch * self.wm_patch * self.wm_channels
            n += pin * D + D  # encoder
            per = (t * self.wm_d_tok * 2 + self.wm_d_tok + t            # token MLP
                   + D * self.wm_d_ch * 2 + self.wm_d_ch + D            # channel MLP
                   + 4 * D)                                             # norms
            n += self.n_layers * per
            n += D * pin + pin  # decoder
            n += 2  # blend
            return n
        V = self.vocab_padded
        n += V * D
        if not self.tie_embeddings:
            n += V * D
        hd = self.d_head
        attn = D * self.n_heads * hd + 2 * D * (self.n_kv_heads * hd) \
            + self.n_heads * hd * D if self.n_heads else 0
        ffn_dense = (3 if self.ffn_kind == "swiglu" else 2) * D * self.d_ff
        ffn_moe = self.n_experts * ffn_dense + self.n_experts * D
        ssm = 0
        if self.ssm_heads:
            # (each Mamba-2 layer's conv bias, conv_dim values, is left
            # out, as the reference leaves it out)
            din = self.ssm_d_inner
            dinp = (2 * din + 2 * self.ssm_groups * self.ssm_state
                    + self.ssm_heads)
            ssm = D * dinp + din * D \
                + self.ssm_conv * (din + 2 * self.ssm_groups * self.ssm_state) \
                + 3 * self.ssm_heads + din
        for i in range(self.n_layers):
            if self.family == "ssm":
                n += ssm + D
                continue
            if self.is_attn_layer(i):
                n += attn + D
            else:
                n += ssm + D
            if self.is_moe_layer(i):
                n += ffn_moe + D
            elif self.d_ff:
                n += ffn_dense + D
        n += D  # final norm
        if self.enc_dec:
            enc_per = attn + ffn_dense + 3 * D
            dec_cross = attn + D
            n += self.n_enc_layers * enc_per + self.n_layers * dec_cross
            n += 4096 * D  # learned decoder position table
        return n
