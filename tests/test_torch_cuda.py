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


# ---------------------------------------------------------------------------
# the operand layouts of the backward, and the training step
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_t,w_t", [(False, True), (True, False),
                                     (True, True)])
@pytest.mark.parametrize("mkn", [(300, 700, 130), (129, 97, 257),
                                 (16380, 40, 4420), (97, 33, 4419)])
def test_layout_variant_matches_plain_version(cuda, dtype, x_t, w_t, mkn):
    """Each operand read across its rows: ragged M, N, K, and stored rows of
    16,380 (8-byte copies), 97 or 33 elements (2-byte copies)."""
    m, k, n = mkn
    x, w, b = _inputs(cuda, m, k, n, dtype)
    xs = x.t().contiguous() if x_t else x
    ws = w.t().contiguous() if w_t else w
    before = BM.block_matmul.launches
    y = BM.block_matmul(xs, ws, b, "gelu", x_t=x_t, w_t=w_t)
    torch.cuda.synchronize()
    assert BM.block_matmul.launches == before + 1
    r = ref.block_matmul_ref(xs, ws, b, "gelu", x_t=x_t, w_t=w_t)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               r.float().cpu().numpy(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernels_match_plain_backward(cuda, dtype):
    from repro_torch.kernels import ops
    x, w, b = _inputs(cuda, 333, 270, 150, dtype)
    dy = torch.randn(333, 150, generator=cuda, device="cuda").to(dtype)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    before = BM.block_matmul.launches
    layouts = dict(BM.block_matmul.layout_launches)
    got = torch.autograd.grad(ops.matmul(*leaves, epilogue="gelu"), leaves,
                              dy)
    torch.cuda.synchronize()
    assert BM.block_matmul.launches == before + 4
    # forward + pre-activation recompute, dx, dw
    for key, n in (((False, False), 2), ((False, True), 1),
                   ((True, True), 1)):
        assert BM.block_matmul.layout_launches[key] == layouts.get(key, 0) + n
    want = ref.matmul_bwd_ref(x, w, b, "gelu", dy)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype
        # dz is rounded to dtype before dx/dw: 2 roundings in bf16
        tol = 2 * TOL[dtype] if dtype == torch.bfloat16 else 1e-4
        np.testing.assert_allclose(g.float().cpu().numpy(),
                                   r.float().cpu().numpy(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
def test_training_step_grads_bitwise_repeatable(cuda):
    """Two identical steps give the same gradients, bit for bit: the kernel
    has no split-K and no atomics, and the plain ops around it reduce in a
    fixed order."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.train.step import value_and_grad
    cfg = get_config("weathermixer-1b").reduced().replace(
        wm_lat=16, wm_lon=32, wm_channels=4, d_model=64, wm_d_tok=64,
        wm_d_ch=64, kernel="pallas", remat=True, n_layers=3)
    eng = TrainEngine("weathermixer-1b", reduced=False, config_override=cfg,
                      device="cuda",
                      config=EngineConfig(steps=1, batch=2, rollout=2,
                                          precision="bf16", prefetch=0))
    batch = eng.pipeline.get(0, 2)
    before = BM.block_matmul.launches
    runs = [value_and_grad(eng.params, batch, eng.cfg, eng.jcfg, 2)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert BM.block_matmul.launches - before == 2 * (5 + 54 * 2)
    (m0, g0), (m1, g1) = runs
    assert torch.equal(m0["loss"], m1["loss"])
    from repro_torch.core import tree as ptree
    assert all(torch.equal(a, b) for a, b in zip(ptree.leaves(g0),
                                                 ptree.leaves(g1)))
