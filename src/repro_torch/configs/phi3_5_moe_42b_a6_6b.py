"""phi3.5-moe-42b-a6.6b: MoE decoder [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, 16 experts top-2.
Full attention -> long_500k skipped.
The port's copy of ``repro/configs/phi3_5_moe_42b_a6_6b.py``, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2, ffn_kind="swiglu",
    rope_theta=10000.0, tie_embeddings=False,
    shard_params_over_data=True,          # 42B
    supports_long_context=False,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
