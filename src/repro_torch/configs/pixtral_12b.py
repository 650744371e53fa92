"""pixtral-12b: VLM -- mistral-nemo decoder consuming pixtral-ViT patch
embeddings [hf:mistralai/Pixtral-12B-2409].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.  The vision
frontend is a STUB per the assignment carve-out: input_specs() provides
precomputed patch embeddings [B, n_patches, d_model].
Full attention -> long_500k skipped.
The port's copy of ``repro/configs/pixtral_12b.py``, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=131072, ffn_kind="swiglu",
    rope_theta=1000000000.0, tie_embeddings=False,
    n_patches=1024,
    supports_long_context=False,
    source="hf:mistralai/Pixtral-12B-2409",
)
