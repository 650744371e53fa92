"""gemma3-27b: dense decoder, 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt family].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.  Local layers
use a 1024-token sliding window -> rolling caches make long_500k decode
feasible (only the 1-in-6 global layers hold full-length caches).
The port's copy of ``repro/configs/gemma3_27b.py``, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_head=128,
    d_ff=21504, vocab_size=262144, ffn_kind="gelu",
    local_window=1024, local_global_ratio=5,
    rope_theta=1000000.0, qk_norm=True, tie_embeddings=True,
    shard_params_over_data=True,          # 27B + 262k-vocab embeddings
    supports_long_context=True,
    source="hf:google/gemma-3-1b-pt",
)
