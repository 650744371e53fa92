"""internlm2-1.8b: dense GQA decoder [arXiv:2403.17297].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
Full attention -> long_500k skipped.
The port's copy of ``repro/configs/internlm2_1_8b.py``, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92544, ffn_kind="swiglu",
    rope_theta=1000000.0, tie_embeddings=True,
    supports_long_context=False,
    source="arXiv:2403.17297",
)
