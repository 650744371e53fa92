"""jamba-1.5-large-398b: hybrid Mamba+attention 1:7 with MoE
[arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Period of 8 layers: 1 attention + 7 SSM; MoE every other layer.  SSM
state is O(1) -> runs long_500k.
The port's copy of ``repro/configs/jamba_1_5_large_398b.py``, field for field.
"""
from repro_torch.configs.base import ModelConfig

D = 8192
CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=D, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    attn_every=8, attn_offset=4,          # jamba puts attn mid-period
    ssm_state=128, ssm_heads=2 * D // 64, ssm_head_dim=64, ssm_groups=8,
    rope_theta=None,                      # jamba uses no positional enc.
    tie_embeddings=False,
    shard_params_over_data=True,          # 398B
    supports_long_context=True,
    source="arXiv:2403.19887",
)
