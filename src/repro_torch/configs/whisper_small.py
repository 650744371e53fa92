"""whisper-small: encoder-decoder audio transformer [arXiv:2212.04356].

12L (decoder; +12 encoder) d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
The mel+conv frontend is a stub: the batch carries frame embeddings
[B, 1500, 768].  Whisper's real decoder ceiling is 448 tokens.
The port's copy of ``repro/configs/whisper_small.py``, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, ffn_kind="gelu",
    norm="layernorm", attn_bias=True, rope_theta=None,
    enc_dec=True, n_enc_layers=12, n_frames=1500,
    tie_embeddings=True,
    supports_long_context=False,
    source="arXiv:2212.04356",
)
