"""stablelm-3b: dense decoder [hf:stabilityai/stablelm-2-1_6b family].

32L d_model=2560 32H (GQA kv=32 = MHA) d_ff=6912 vocab=50304.
Full attention -> long_500k skipped.
The port's copy of ``repro/configs/stablelm_3b.py``, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab_size=50304, ffn_kind="swiglu",
    rope_theta=10000.0, tie_embeddings=True,
    supports_long_context=False,
    source="hf:stabilityai/stablelm-2-1_6b",
)
