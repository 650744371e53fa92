"""WeatherMixer: the paper's own architecture (§3, §6.2).

The 1-billion-parameter configuration from §6.2.1: 3 MLP-Mixing blocks,
d_emb = 4320, d_tok = 8640, d_ch = 4320, on 0.25-degree ERA5
(721x1440 grid, padded to 728x1440 for 8x8 patching; 69 variables:
4 surface + 5x13 pressure levels).  Table 1 gives the scaling zoo (``ZOO``).
"""
from repro_torch.configs.base import ModelConfig

def _wm(name, d_emb, d_tok, d_ch, n_layers=3, lat=728, lon=1440, chans=69,
        patch=8):
    return ModelConfig(
        arch_id=name, family="mixer",
        n_layers=n_layers, d_model=d_emb,
        wm_lat=lat, wm_lon=lon, wm_channels=chans, wm_patch=patch,
        wm_d_tok=d_tok, wm_d_ch=d_ch,
        norm="layernorm", scheme="2d",
        # production compute engine: the block_matmul kernel (in the port,
        # kernels/csrc/block_matmul.cu; "pallas" names it as the reference
        # does).  reduced() resets it for CPU smoke tests.
        kernel="pallas", impl="ring_chunked",
        supports_decode=False, supports_long_context=False,
        source="Kieckhefen et al. 2025 (the reproduced paper), §6.2/Table 1",
    )

CONFIG = _wm("weathermixer-1b", 4320, 8640, 4320)

# Table 1 scaling zoo (TFLOPs/forward pass -> dims), models 1-9.
ZOO = {
    1: _wm("wm-zoo-0.25t", 240, 540, 240),
    2: _wm("wm-zoo-0.5t", 512, 2160, 512),
    3: _wm("wm-zoo-1t", 896, 2160, 896),
    4: _wm("wm-zoo-2t", 1600, 2160, 1600),
    5: _wm("wm-zoo-4t", 2192, 4320, 2192),
    6: _wm("wm-zoo-8t", 2832, 8640, 2832),
    7: _wm("wm-zoo-16t", 4896, 8640, 4896),
    8: _wm("wm-zoo-32t", 6064, 17280, 6064),
    9: _wm("wm-zoo-64t", 10352, 17280, 10352),
}
