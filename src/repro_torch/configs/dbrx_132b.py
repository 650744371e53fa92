"""dbrx-132b: fine-grained MoE decoder [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16 experts
top-4.  Full attention -> long_500k skipped (DESIGN.md).
The port's copy of ``repro/configs/dbrx_132b.py``, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    n_experts=16, top_k=4, ffn_kind="swiglu",
    rope_theta=500000.0, tie_embeddings=False,
    shard_params_over_data=True,          # 132B: params exceed 16-way HBM
    supports_long_context=False,
    source="hf:databricks/dbrx-base",
)
