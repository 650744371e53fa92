"""h2o-danube-1.8b: llama+mistral-style dense decoder with sliding-window
attention [arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, SWA window 4096.
Window caches are O(window) -> runs long_500k.
The port's copy of ``repro/configs/h2o_danube_1_8b.py``, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32000, ffn_kind="swiglu",
    sliding_window=4096,
    rope_theta=10000.0, tie_embeddings=False,
    supports_long_context=True,
    source="arXiv:2401.16818",
)
