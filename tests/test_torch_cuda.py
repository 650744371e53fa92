"""The port's CUDA kernel on the card (marked ``cuda``; skips without one).

Run on a GPU machine with
``python -m pytest -m cuda tests/test_torch_cuda.py``.  This file imports
torch and the port only, so it runs where JAX is not installed.
Tolerances as ``tests/test_kernels.py``: fp32 2e-5, bf16 3e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import block_matmul as BM
from repro_torch.kernels import ref

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, m, k, n, dtype, bias=True):
    x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
    w = (torch.randn(n, k, generator=gen, device="cuda") / k ** 0.5).to(dtype)
    b = (0.1 * torch.randn(n, generator=gen, device="cuda")).to(dtype) \
        if bias else None
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", ["none", "gelu", "silu"])
@pytest.mark.parametrize("mkn", [(300, 700, 130), (129, 97, 257),
                                 (33, 16380, 40)])
def test_kernel_matches_plain_version(cuda, dtype, epilogue, mkn):
    x, w, b = _inputs(cuda, *mkn, dtype)
    before = BM.block_matmul.launches
    y = BM.block_matmul(x, w, b, epilogue)
    torch.cuda.synchronize()
    assert BM.block_matmul.launches == before + 1
    r = ref.block_matmul_ref(x, w, b, epilogue)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               r.float().cpu().numpy(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_do_not_depend_on_launch_size(cuda, dtype):
    """Batch invariance: rows of a sub-block equal the same rows of the
    whole launch, bit for bit, wherever they fall in the 128-row tiles."""
    x, w, b = _inputs(cuda, 1000, 4320, 256, dtype)
    whole = BM.block_matmul(x, w, b, "gelu")
    part = BM.block_matmul(x[37:700].contiguous(), w, b, "gelu")
    assert torch.equal(part, whole[37:700])


@pytest.mark.cuda
def test_wrapper_rejects_non_contiguous(cuda):
    x, w, _ = _inputs(cuda, 64, 32, 16, torch.bfloat16, bias=False)
    x_strided = x.t().contiguous().t()           # [64, 32], column-major
    with pytest.raises(ValueError, match="contiguous"):
        BM.block_matmul(x_strided, w)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["bf16", None])
def test_engine_midflight_admission_bitwise_vs_solo(cuda, precision):
    """The serving contract on the card: a request admitted mid-rollout
    gives bit for bit what it gives alone at bucket 1."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import ForecastEngine, ServeConfig
    cfg = get_config("weathermixer-1b").reduced().replace(
        wm_lat=16, wm_lon=32, wm_channels=4, d_model=64, wm_d_tok=64,
        wm_d_ch=64, kernel="pallas")
    eng = ForecastEngine("weathermixer-1b", reduced=False,
                         config_override=cfg, device="cuda",
                         config=ServeConfig(buckets=(1, 2, 4),
                                            precision=precision))
    eng.warmup()
    rng = np.random.default_rng(1)
    fs = rng.normal(size=(4, *eng.field_shape)).astype(np.float32)
    before = BM.block_matmul.launches
    first = eng.submit(fs[0], 4)
    assert eng.step_once() == "step"
    late = [eng.submit(fs[i], i) for i in (1, 2, 3)]
    eng.drain()
    steps = eng.stats["device_steps"]
    assert BM.block_matmul.launches - before == (2 + 4 * cfg.n_layers) * steps

    def solo(f, lead):
        state = torch.from_numpy(f)[None].cuda()
        for _ in range(lead):
            state = eng._forecast(state)
        return state[0].cpu().numpy()

    assert np.array_equal(first.result(), solo(fs[0], 4))
    for i, r in zip((1, 2, 3), late):
        assert np.array_equal(r.result(), solo(fs[i], i))
