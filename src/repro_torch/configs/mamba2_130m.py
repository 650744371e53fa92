"""mamba2-130m: attention-free SSM LM, SSD [arXiv:2405.21060].

24L d_model=768, ssm_state=128, vocab=50280 (padded to 50432 for 16-way
sharding).  O(1) decode state.  The port's copy of
``repro/configs/mamba2_130m.py``, field for field.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_heads=24, ssm_head_dim=64, ssm_groups=1,
    ssm_conv=4, ssm_chunk=64, ssm_expand=2,
    rope_theta=None, tie_embeddings=True,
    supports_long_context=True,
    source="arXiv:2405.21060",
)
