"""The port's CUDA kernels on the card (marked ``cuda``; skips without one).

Run on a GPU machine with
``python -m pytest -m cuda tests/test_torch_cuda.py``.  This file imports
torch and the port only, so it runs where JAX is not installed.
Tolerances as ``tests/test_kernels.py``: fp32 2e-5, bf16 3e-2.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import block_matmul as BM
from repro_torch.kernels import cannon as CANNON
from repro_torch.kernels import ref
from repro_torch.kernels import ring as RING
from repro_torch.kernels import sm90 as SM90
from repro_torch.kernels import ssd_chunk as SSD
from repro_torch.kernels import ssd_chunk_bwd as SSDB
from repro_torch.kernels import wx as WX

ROOT = Path(__file__).resolve().parents[1]

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
@pytest.mark.parametrize("x_t,w_t", [(False, False), (False, True),
                                     (True, False), (True, True)])
@pytest.mark.parametrize("epilogue", ["none", "gelu", "silu"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("mkn", [(300, 700, 130), (129, 97, 257),
                                 (200, 16380, 72), (1000, 333, 4419)])
def test_sm90_route_matches_plain_and_wmma_bitwise(cuda, x_t, w_t, epilogue,
                                                   bias, mkn):
    """The Hopper loop (bf16, M and N at least 64) in every layout,
    epilogue and bias, at ragged M, N, K and stored rows of 97, 129, 333
    or 16,380 elements (padded per call): within the bf16 bound of the
    plain version, and bit for bit the WMMA loop on the same operands."""
    m, k, n = mkn
    x, w, b = _inputs(cuda, m, k, n, torch.bfloat16, bias)
    xs = x.t().contiguous() if x_t else x
    ws = w.t().contiguous() if w_t else w
    assert BM.route(m, n, torch.bfloat16) == "sm90"
    routes = dict(BM.block_matmul.route_launches)
    y = BM.block_matmul(xs, ws, b, epilogue, x_t=x_t, w_t=w_t)
    torch.cuda.synchronize()
    assert BM.block_matmul.route_launches["sm90"] == routes.get("sm90",
                                                                0) + 1
    r = ref.block_matmul_ref(xs, ws, b, epilogue, x_t=x_t, w_t=w_t)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               r.float().cpu().numpy(), rtol=TOL[y.dtype],
                               atol=TOL[y.dtype])
    y_w = BM.block_matmul(xs, ws, b, epilogue, x_t=x_t, w_t=w_t,
                          route_name="wmma")
    assert torch.equal(y, y_w)


@pytest.mark.cuda
def test_route_rule_and_counter(cuda):
    """M or N under 64 (Mamba-2's decode, M = 4; its in_dt, N = 24) takes
    the WMMA loop, the rest the Hopper loop, f32 the FMA tiles; each
    launch counts once under its route.  A route the dtype has not raises
    before launching."""
    cases = [((4, 768, 1536), "wmma"), ((8192, 768, 24), "wmma"),
             ((64, 100, 64), "sm90"), ((300, 50, 130), "sm90")]
    for (m, k, n), want in cases:
        x, w, _ = _inputs(cuda, m, k, n, torch.bfloat16, bias=False)
        before = dict(BM.block_matmul.route_launches)
        BM.block_matmul(x, w)
        assert BM.block_matmul.route_launches[want] == before.get(want,
                                                                  0) + 1
    x, w, _ = _inputs(cuda, 70, 30, 80, torch.float32, bias=False)
    before = BM.block_matmul.launches
    for bad in ("sm90", "wmma", "tpu"):
        with pytest.raises(ValueError, match="route"):
            BM.block_matmul(x, w, route_name=bad)
    assert BM.block_matmul.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("who", ["block_matmul", "wx"])
def test_sm90_wrappers_pad_what_tma_cannot_take_and_raise_on_layouts(
        cuda, who):
    """block_matmul and wx pad, once per call, a contiguous bf16 operand
    whose rows or base TMA cannot take (rows of 97 elements; a base 2
    bytes off 16), with the same bits as an aligned copy; a layout they do
    not take (not contiguous) raises ValueError and launches nothing."""
    bf = torch.bfloat16
    x = torch.randn(130, 97, generator=cuda, device="cuda").to(bf)
    off = torch.empty(130 * 97 + 1, dtype=bf, device="cuda")[1:].view(
        130, 97)
    off.copy_(x)
    assert off.data_ptr() % 16 and SM90.pad_rows(off) is not off
    if who == "block_matmul":
        w = torch.randn(140, 97, generator=cuda, device="cuda").to(bf)
        assert torch.equal(BM.block_matmul(off, w), BM.block_matmul(x, w))
        before = BM.block_matmul.launches
        with pytest.raises(ValueError, match="contiguous"):
            BM.block_matmul(x.t().contiguous().t(), w)
        assert BM.block_matmul.launches == before
    else:
        xs = torch.randn(2, 97, 72, generator=cuda, device="cuda").to(bf)
        assert torch.equal(WX.wx(off, xs), WX.wx(x, xs))
        before = WX.wx.launches
        with pytest.raises(ValueError, match="contiguous"):
            WX.wx(x.t().contiguous().t(), xs)
        assert WX.wx.launches == before


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


# ---------------------------------------------------------------------------
# wx: the transposed-Cannon step kernel
# ---------------------------------------------------------------------------

# bf16 operands into an f32 output: the products are exact in f32, so the
# kernel and the plain version differ only in summation order; a bf16
# rounding of the accumulator, a or the output would exceed this
WX_MIXED_TOL = 1e-3


def _wx_inputs(gen, ll, m, t, c, dtype, out_dtype, w_t, with_a):
    w = (torch.randn(m, t, generator=gen, device="cuda") / t ** 0.5
         ).to(dtype)
    ws = w.t().contiguous() if w_t else w
    x = torch.randn(ll, t, c, generator=gen, device="cuda").to(dtype)
    a = (torch.randn(ll, m, c, generator=gen, device="cuda").to(out_dtype)
         if with_a else None)
    return ws, x, a


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w_t", [False, True])
@pytest.mark.parametrize("shape", [(1, 300, 700, 130), (3, 129, 97, 257),
                                   (2, 33, 8190, 40), (1, 4420, 33, 97)])
def test_wx_matches_plain_version(cuda, dtype, out_dtype, w_t, shape):
    """a + W @ x[l] over ragged M, K, N, batches of 1-3, W read along or
    across its rows, stored rows of 97, 33 (2-byte copies) or 8,190 (4-byte)
    elements, with and without a."""
    ll, m, t, c = shape
    for with_a in (True, False):
        w, x, a = _wx_inputs(cuda, ll, m, t, c, dtype, out_dtype, w_t,
                             with_a)
        before = WX.wx.launches
        y = WX.wx(w, x, a, out_dtype=out_dtype, w_t=w_t)
        torch.cuda.synchronize()
        assert WX.wx.launches == before + 1 and y.dtype == out_dtype
        r = ref.wx_ref(w, x, a, out_dtype, w_t=w_t)
        tol = (WX_MIXED_TOL if (dtype, out_dtype) == (torch.bfloat16,
                                                      torch.float32)
               else max(TOL[dtype], TOL[out_dtype]))
        np.testing.assert_allclose(y.float().cpu().numpy(),
                                   r.float().cpu().numpy(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("case,exc", [
    ("dtype", TypeError), ("k", ValueError), ("a_shape", ValueError),
    ("a_dtype", ValueError), ("device", ValueError),
    ("contiguous", ValueError), ("out_dtype", TypeError)])
def test_wx_wrapper_rejects_bad_inputs(cuda, case, exc):
    """The wrapper raises on what the kernel does not take, and launches
    nothing: no fallback to the plain version on a CUDA tensor."""
    w, x, a = _wx_inputs(cuda, 2, 64, 48, 32, torch.bfloat16, torch.float32,
                         False, True)
    kw = {}
    if case == "dtype":     # a bf16 w may meet an f32 x (dx), not the reverse
        w = w.float()
    elif case == "k":
        x = x[:, :40].contiguous()
    elif case == "a_shape":
        a = a[:, :10].contiguous()
    elif case == "a_dtype":
        a = a.to(torch.bfloat16)
    elif case == "device":
        w = w.cpu()
    elif case == "contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "out_dtype":
        kw["out_dtype"] = torch.float16
    before = WX.wx.launches
    with pytest.raises(exc):
        WX.wx(w, x, a, **kw)
    assert WX.wx.launches == before


# dx against a float64 oracle, max-normalised: f32 accumulation of exact
# products (~1e-6 of the max here); dropping the second and third terms of
# an inexact dy errs by bf16's rounding of dy (~1e-3)
WX_DX_F64_TOL = 1e-4


def _max_rel64(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("terms", [1, 3])
@pytest.mark.parametrize("w_t", [True, False])
@pytest.mark.parametrize("shape", [(1, 300, 700, 130), (2, 129, 97, 257),
                                   (3, 64, 8190, 40), (1, 4420, 33, 97)])
def test_wx_dx_split_terms(cuda, terms, w_t, shape):
    """The dx entry, a bf16 w with an f32 x: one split term where x is
    bf16-exact, three where it is not, as the card's counts record; within
    1e-4 of the plain version and of a float64 oracle (max-normalised),
    where contracting the first term alone would not be."""
    ll, m, t, c = shape
    w, x, a = _wx_inputs(cuda, ll, m, t, c, torch.bfloat16, torch.float32,
                         w_t, True)
    x = torch.randn(ll, t, c, generator=cuda, device="cuda")
    if terms == 1:
        x = x.to(torch.bfloat16).float()
    WX.reset_dx_terms()
    before = WX.wx.launches
    y = WX.wx(w, x, a, w_t=w_t)
    torch.cuda.synchronize()
    assert WX.wx.launches == before + 1
    assert WX.dx_terms() == {1: int(terms == 1), 3: int(terms == 3)}
    r = ref.wx_ref(w, x, a, w_t=w_t)
    np.testing.assert_allclose(y.cpu().numpy(), r.cpu().numpy(), rtol=1e-4,
                               atol=1e-4)
    wd = w.double().t() if w_t else w.double()
    oracle = a.double() + torch.matmul(wd, x.double())
    assert _max_rel64(y, oracle) <= WX_DX_F64_TOL
    if terms == 3:
        hi_only = WX.wx(w, x.to(torch.bfloat16), a, w_t=w_t)
        assert _max_rel64(hi_only, oracle) > WX_DX_F64_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 33, 40), (1, 7, 97), (3, 129, 4420)])
def test_wx_split_pass_is_the_plain_split(cuda, shape):
    """The split pass's three terms equal ref.split_bf16x3's bit for bit
    (rows padded to what TMA takes), and its flag is set exactly when a
    second or third term is not zero."""
    x = torch.randn(*shape, generator=cuda, device="cuda") * torch.exp2(
        torch.randint(-60, 60, shape, generator=cuda, device="cuda").float())
    for v, want_flag in ((x, True), (x.to(torch.bfloat16).float(), False)):
        parts, flag = WX.split_terms(v)
        torch.cuda.synchronize()
        ll = shape[0]
        assert SM90.row_stride(parts) == SM90.tma_ld(shape[-1])
        for i, term in enumerate(ref.split_bf16x3(v)):
            assert torch.equal(parts[i * ll:(i + 1) * ll], term)
        assert bool(flag.item()) == want_flag


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cannon_step_grads_match_cpu(cuda, dtype):
    """cannon_t_step's forward and backward on the card (wx forward and dx,
    block_matmul dw) against the same Function on CPU tensors (the plain
    versions)."""
    from repro_torch.kernels.fused_ring import cannon_t_step
    w, x, a = _wx_inputs(cuda, 3, 96, 80, 40, dtype, torch.float32, False,
                         True)
    dy = torch.randn(3, 96, 40, generator=cuda, device="cuda")
    outs = []
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).clone().requires_grad_() for t in (w, x, a)]
        y = cannon_t_step(*leaves[:2], leaves[2])
        outs.append([y] + list(torch.autograd.grad(y, leaves, dy.to(dev))))
    tol = 2 * TOL[dtype] if dtype == torch.bfloat16 else 1e-4
    for g, r in zip(*outs):
        assert g.dtype == r.dtype
        np.testing.assert_allclose(g.detach().float().cpu().numpy(),
                                   r.detach().float().numpy(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
def test_2d_step_launch_counts_and_none_parity(cuda):
    """One 2-D training forward and backward on the 1x1 mesh: 18 r wx and
    5 + 30 r block_matmul launches at 3 blocks with remat, every dx launch
    at one split term, and the gradients of the scheme="none" step within
    the bf16 bound."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree as ptree
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.train.step import value_and_grad
    cfg = get_config("weathermixer-1b").reduced().replace(
        wm_lat=16, wm_lon=32, wm_channels=4, d_model=64, wm_d_tok=64,
        wm_d_ch=64, kernel="pallas", remat=True, n_layers=3)
    eng = TrainEngine("weathermixer-1b", reduced=False, config_override=cfg,
                      device="cuda",
                      config=EngineConfig(steps=1, batch=2, precision="bf16",
                                          prefetch=0))
    batch = eng.pipeline.get(0, 1)
    m0, g0 = value_and_grad(eng.params, batch, eng.cfg, eng.jcfg, 1)
    bm, wx = BM.block_matmul.launches, WX.wx.launches
    WX.reset_dx_terms()
    m2, g2 = value_and_grad(eng.params, batch, eng.cfg.replace(scheme="2d"),
                            eng.jcfg.replace(scheme="2d"), 1)
    torch.cuda.synchronize()
    assert (BM.block_matmul.launches - bm, WX.wx.launches - wx) == (35, 18)
    # the 6 dx launches each contracted one split term: dy is bf16-exact
    assert WX.dx_terms() == {1: 6, 3: 0}
    assert abs(float(m2["loss"]) - float(m0["loss"])) <= 5e-2 * abs(
        float(m0["loss"]))
    for a, b in zip(ptree.leaves(g2), ptree.leaves(g0)):
        err = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert float(err) <= 5e-2


# ---------------------------------------------------------------------------
# the 1-D ring step kernels
# ---------------------------------------------------------------------------

# the bf16 forward rounds to bf16 at every hop: a summation order other
# than the plain version's flips some roundings (the bf16 GEMM bound); the
# f32 accumulator of dx differs from the plain one in summation order only
RING_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
RING_DX_TOL = 1e-4


def _ring_case(gen, p, rows, dl, m, dtype):
    xs = [torch.randn(rows, dl, generator=gen, device="cuda").to(dtype)
          for _ in range(p)]
    ws = [(torch.randn(m, dl, generator=gen, device="cuda")
           / (p * dl) ** 0.5).to(dtype) for _ in range(p)]
    dys = [torch.randn(rows, m // p, generator=gen, device="cuda").to(dtype)
           for _ in range(p)]
    return xs, ws, dys


def _max_rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,rows,dl,m", [(2, 300, 70, 260), (3, 129, 97, 99),
                                         (4, 33, 200, 4420), (2, 1, 8, 4)])
def test_ring_kernels_match_plain_and_ring(cuda, dtype, p, rows, dl, m):
    """p ranks in one process at ragged shapes: the forward is bit for bit
    the ring of block_matmul's products, and within RING_TOL of the plain
    version; dw is bit for bit block_matmul's dw of the gathered cotangent;
    dx's f32 accumulator is within RING_DX_TOL (max-normalised) of the plain
    one, and dx is it rounded.  p launches of each kernel per rank."""
    xs, ws, dys = _ring_case(cuda, p, rows, dl, m, dtype)
    mc = m // p
    f0, b0 = RING.ring_fwd.launches, RING.ring_bwd.launches
    outs = RING.ring_fwd_all(xs, ws)
    dxs, dws, accs = RING.ring_bwd_all(xs, ws, dys)
    torch.cuda.synchronize()
    assert (RING.ring_fwd.launches - f0, RING.ring_bwd.launches - b0) == (
        p * p, p * p)
    parts = [BM.block_matmul(x, w) for x, w in zip(xs, ws)]
    ring = ref.ring_walk_all(lambda r, j: parts[r][:, j * mc:(j + 1) * mc],
                             p, dtype, torch.float32)
    plain = ref.ring_fwd_all_ref(xs, ws, torch.float32)
    pdx, pdw, pacc = ref.ring_bwd_all_ref(xs, ws, dys)
    gathered = torch.cat(dys, dim=1)
    for r in range(p):
        assert torch.equal(outs[r], ring[r])
        np.testing.assert_allclose(outs[r].float().cpu().numpy(),
                                   plain[r].float().cpu().numpy(),
                                   rtol=RING_TOL[dtype], atol=RING_TOL[dtype])
        assert torch.equal(dws[r], BM.block_matmul(gathered, xs[r],
                                                   x_t=True, w_t=True))
        np.testing.assert_allclose(dws[r].float().cpu().numpy(),
                                   pdw[r].float().cpu().numpy(),
                                   rtol=RING_TOL[dtype], atol=RING_TOL[dtype])
        assert _max_rel(accs[r], pacc[r]) <= RING_DX_TOL
        assert torch.equal(dxs[r], accs[r].to(dtype))
    if dtype == torch.bfloat16:
        _assert_dx_is_the_wx_step_loop(xs, ws, dys, accs)


def _assert_dx_is_the_wx_step_loop(xs, ws, dys, accs):
    """dx's f32 accumulator bit for bit what the kernel it replaces gave:
    the wx step loop acc = wx(cur_s, w_j[None], acc), rank r taking rank
    (r - s) % p's dy chunk at step s (the WMMA loop and epilogue)."""
    p = len(xs)
    mc = ws[0].shape[0] // p
    for r in range(p):
        loop = None
        for s in range(p):
            j = (r - s) % p
            loop = WX.wx(dys[j], ws[r][j * mc:(j + 1) * mc][None], loop)
        assert torch.equal(accs[r], loop[0]), r


def _wide(gen, shape, lo=-20, hi=20):
    """bf16 values of random sign and magnitude 2^lo .. 2^hi: products of
    every magnitude meet in one k16 step and their sums cancel, so a k16
    step that rounded otherwise than the WMMA loop's would show."""
    mant = 1 + torch.rand(shape, generator=gen, device="cuda")
    e = torch.randint(lo, hi, shape, generator=gen, device="cuda").float()
    sign = torch.rand(shape, generator=gen, device="cuda") < 0.5
    return (torch.where(sign, -mant, mant) * torch.exp2(e)).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["randn", "wide"])
@pytest.mark.parametrize("p,rows,dl,m", [(2, 300, 97, 260), (2, 129, 98, 130),
                                         (4, 200, 129, 516), (3, 77, 1000, 99),
                                         (2, 1, 8, 4)])
def test_ring_bwd_odd_strides_and_cancelling_inputs(cuda, inputs, p, rows,
                                                    dl, m):
    """The bf16 backward at row strides of 2 and 4 bytes mod 16 (dl = 97,
    98, 129: x and w_j padded by ring_bwd_all), ragged R, D and MC (not
    multiples of 64 or 128), p = 4, and inputs that cancel across a wide
    exponent range: dw bit for bit block_matmul's dw of the gathered
    cotangent, dx's accumulator bit for bit the wx step loop and within
    RING_DX_TOL of the plain one (randn; the wide inputs cancel to where a
    max-normalised bound says nothing)."""
    mc = m // p
    if inputs == "wide":
        xs = [_wide(cuda, (rows, dl)) for _ in range(p)]
        ws = [_wide(cuda, (m, dl)) for _ in range(p)]
        dys = [_wide(cuda, (rows, mc)) for _ in range(p)]
    else:
        xs, ws, dys = _ring_case(cuda, p, rows, dl, m, torch.bfloat16)
    b0 = RING.ring_bwd.launches
    dxs, dws, accs = RING.ring_bwd_all(xs, ws, dys)
    torch.cuda.synchronize()
    assert RING.ring_bwd.launches - b0 == p * p
    gathered = torch.cat(dys, dim=1)
    for dw, x in zip(dws, xs):
        assert torch.equal(dw, BM.block_matmul(gathered, x, x_t=True,
                                               w_t=True))
    _assert_dx_is_the_wx_step_loop(xs, ws, dys, accs)
    assert all(torch.equal(dx, a.to(torch.bfloat16))
               for dx, a in zip(dxs, accs))
    if inputs == "randn":
        _, _, pacc = ref.ring_bwd_all_ref(xs, ws, dys)
        assert all(_max_rel(a, b) <= RING_DX_TOL for a, b in zip(accs, pacc))


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["randn", "wide"])
@pytest.mark.parametrize("accum", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,rows,dl,m", [(2, 300, 97, 262), (3, 129, 200, 771),
                                         (4, 77, 1000, 516), (2, 200, 40, 600),
                                         (2, 1, 8, 4)])
def test_ring_fwd_sm90_bitwise_block_matmul_at_ragged_shapes(cuda, inputs,
                                                             accum, p, rows,
                                                             dl, m):
    """The bf16 forward on the Hopper loop at ragged R, MC and K (not
    multiples of 128, 256 or 64; MC odd: 131, 257, 129, scalar stores; K
    of 40, under one 64-wide box), rows of 97 and 1,000 bf16 (x and w
    padded by ring_fwd_all), an f32 and a bf16 accumulator, and inputs
    that cancel across a wide exponent range: every rank bit for bit the
    ring of block_matmul's products; p launches per rank."""
    mc = m // p
    if inputs == "wide":
        xs = [_wide(cuda, (rows, dl)) for _ in range(p)]
        ws = [_wide(cuda, (m, dl)) for _ in range(p)]
    else:
        xs, ws, _ = _ring_case(cuda, p, rows, dl, m, torch.bfloat16)
    f0 = RING.ring_fwd.launches
    outs = RING.ring_fwd_all(xs, ws, accum_dtype=accum)
    torch.cuda.synchronize()
    assert RING.ring_fwd.launches - f0 == p * p
    parts = [BM.block_matmul(x, w) for x, w in zip(xs, ws)]
    ring = ref.ring_walk_all(lambda r, j: parts[r][:, j * mc:(j + 1) * mc],
                             p, torch.bfloat16, accum)
    for r in range(p):
        assert torch.equal(outs[r], ring[r]), r


def _f64_rel(y, oracle):
    return float((y.double() - oracle).abs().max()
                 / oracle.abs().max().clamp_min(1e-300))


# f32 shapes (m, k, n) for the exact FMA loop: K % 4 != 0 (4-byte loads),
# rows under 16, K under one k-tile of 16, and the smoke run's long K
F32_SHAPES = [(5, 3, 7), (12, 9, 200), (129, 97, 257), (300, 700, 130),
              (1, 1, 1), (33, 16380, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("mkn", F32_SHAPES)
def test_f32_loop_against_f64_oracle_in_every_layout(cuda, mkn):
    """block_matmul in f32 at ragged shapes, each operand stored either
    way (x [M, K] or [K, M], w [N, K] or [K, N]): within 1e-4
    (max-normalised) of a float64 oracle, and the four layouts bit for bit
    each other: the loop gives every output one fmaf chain in K order
    whatever the layout and the load width."""
    m, k, n = mkn
    x, w, _ = _inputs(cuda, m, k, n, torch.float32, bias=False)
    oracle = x.double() @ w.double().t()
    got = {}
    for x_t in (False, True):
        for w_t in (False, True):
            xs = x.t().contiguous() if x_t else x
            ws = w.t().contiguous() if w_t else w
            got[(x_t, w_t)] = BM.block_matmul(xs, ws, x_t=x_t, w_t=w_t)
    torch.cuda.synchronize()
    base = got[(False, False)]
    assert _f64_rel(base, oracle) <= 1e-4
    assert all(torch.equal(y, base) for y in got.values())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 129, 97, 262), (3, 33, 40, 9),
                                   (2, 5, 3, 14)])
def test_f32_loop_kernels_agree_bit_for_bit(cuda, shape):
    """The five f32 kernels run one loop: at ragged shapes (K of 97, 40 and
    3; rows under 16) the ring forward is bit for bit the ring of
    block_matmul's f32 products and the ring backward's dw block_matmul's
    dw; the Cannon (q = 2) is bit for bit the wx step loop, and wx is bit
    for bit block_matmul with w read across its rows."""
    p, rows, dl, m = shape
    mc = m // p
    xs, ws, dys = _ring_case(cuda, p, rows, dl, m, torch.float32)
    outs = RING.ring_fwd_all(xs, ws)
    _, dws, _ = RING.ring_bwd_all(xs, ws, dys)
    parts = [BM.block_matmul(x, w) for x, w in zip(xs, ws)]
    ring = ref.ring_walk_all(lambda r, j: parts[r][:, j * mc:(j + 1) * mc],
                             p, torch.float32, torch.float32)
    gathered = torch.cat(dys, dim=1)
    for r in range(p):
        assert torch.equal(outs[r], ring[r])
        assert torch.equal(dws[r], BM.block_matmul(gathered, xs[r],
                                                   x_t=True, w_t=True))
    cws, cxs = _cannon_case(cuda, 2, 2, rows, dl, mc, torch.float32)
    got = CANNON.cannon_fwd_all(cws, cxs, 2)
    loop = ref.cannon_walk_all(lambda w, x, a: WX.wx(w, x, a), cws, cxs, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, loop))
    y = WX.wx(cws[0], cxs[0][:1])
    assert torch.equal(y[0], BM.block_matmul(cws[0], cxs[0][0], w_t=True))


@pytest.mark.cuda
def test_ring_bf16_accumulator_and_step_errors(cuda):
    """accum_dtype=bf16 under an f32 wire rounds the chunk products, the
    arrived partials and every hop's add to bf16, as the plain walk does
    (bit for bit against block_matmul's products); the wrapper raises on
    what the kernel does not take, and launches nothing."""
    xs, ws, _ = _ring_case(cuda, 3, 64, 48, 48, torch.float32)
    got = RING.ring_fwd_all(xs, ws, accum_dtype=torch.bfloat16)
    parts = [BM.block_matmul(x, w) for x, w in zip(xs, ws)]
    want = ref.ring_walk_all(lambda r, j: parts[r][:, j * 16:(j + 1) * 16],
                             3, torch.float32, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    xs, ws, _ = _ring_case(cuda, 2, 64, 48, 32, torch.bfloat16)
    x, w = xs[0], ws[0]
    dest = torch.empty(64, 16, dtype=torch.bfloat16, device="cuda")
    before = RING.ring_fwd.launches
    for bad in (dict(x=x.float()), dict(dest=dest[:, :8]),
                dict(j=2), dict(x=x.t().contiguous().t()),
                dict(dest=dest.float())):
        kw = dict(x=x, w=w, j=0, prev=None, dest=dest)
        kw.update(bad)
        with pytest.raises((ValueError, TypeError)):
            RING.ring_fwd(kw["x"], kw["w"], kw["j"], kw["prev"], kw["dest"])
    assert RING.ring_fwd.launches == before


@pytest.mark.cuda
def test_ring_failed_library_build_raises(cuda, tmp_path, monkeypatch):
    """A source nvcc refuses: the wrapper raises, with no plain-version
    fallback on a CUDA tensor."""
    from repro_torch.kernels import build
    bad = tmp_path / "ring_broken.cu"
    bad.write_text("this is not CUDA\n")
    lib = build.KernelLibrary("ring_broken", "ring.cu", [], RING._bind)
    lib.source = bad
    monkeypatch.setattr(RING, "LIBRARY", lib)
    xs, ws, _ = _ring_case(cuda, 2, 16, 8, 8, torch.float32)
    dest = torch.empty(16, 4, device="cuda")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        RING.ring_fwd(xs[0], ws[0], 0, None, dest)


@pytest.mark.cuda
def test_ring_failed_ipc_open_raises(cuda, monkeypatch):
    """A successor's IPC handle that does not open: the workspace raises
    (and frees its own slots) instead of falling back."""
    me = os.getpid()

    def fake_gather(out, obj, group=None):
        out[0], out[1] = obj, (b"\0" * len(obj[0]), me + 1, obj[2])
    monkeypatch.setattr(RING.dist, "get_world_size", lambda g: 2)
    monkeypatch.setattr(RING.dist, "get_rank", lambda g: 0)
    monkeypatch.setattr(RING.dist, "all_gather_object", fake_gather)
    with pytest.raises(RuntimeError, match="cudaIpcOpenMemHandle"):
        RING.RingWorkspace(None, 1 << 20, torch.device("cuda", 0))


# ---------------------------------------------------------------------------
# the Cannon kernel
# ---------------------------------------------------------------------------

# the bf16 forward's output is f32 and bf16 products are exact in f32: the
# plain Cannon differs in summation order only (chip_smoke.py's WX_TOL)
CANNON_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


def _cannon_case(gen, q, ll, m, t, c, dtype):
    ws = [(torch.randn(m, t, generator=gen, device="cuda") / t ** 0.5
           ).to(dtype) for _ in range(q * q)]
    xs = [torch.randn(ll, t, c, generator=gen, device="cuda").to(dtype)
          for _ in range(q * q)]
    return ws, xs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q,ll,m,t,c", [(2, 2, 300, 130, 70),
                                        (3, 1, 129, 97, 257),
                                        (3, 3, 33, 40, 8), (2, 1, 1, 1, 1)])
def test_cannon_kernel_matches_step_loop_and_plain(cuda, dtype, out_dtype,
                                                   q, ll, m, t, c):
    """q x q ranks in one process at ragged shapes (rows of 97 bf16 take
    2-byte loads): the Cannon kernel's q launches per rank are bit for bit
    the step loop (one wx launch per step, the blocks rotated the same
    way), and within CANNON_TOL of the plain Cannon (f32 out)."""
    ws, xs = _cannon_case(cuda, q, ll, m, t, c, dtype)
    before = CANNON.cannon_step.launches
    got = CANNON.cannon_fwd_all(ws, xs, q, accum_dtype=out_dtype)
    torch.cuda.synchronize()
    assert CANNON.cannon_step.launches - before == q ** 3
    loop = ref.cannon_walk_all(
        lambda w, x, a: WX.wx(w, x, a, out_dtype=out_dtype), ws, xs, q)
    for a, b in zip(got, loop):
        assert a.dtype == out_dtype and torch.equal(a, b)
    if out_dtype == torch.float32:
        for a, b in zip(got, ref.cannon_ref(ws, xs, q)):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=CANNON_TOL[dtype],
                                       atol=CANNON_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["randn", "wide"])
@pytest.mark.parametrize("q,ll,m,t,c", [(2, 1, 300, 97, 130),
                                        (2, 2, 129, 98, 97),
                                        (3, 2, 200, 129, 70),
                                        (3, 1, 65, 1000, 258)])
def test_cannon_odd_strides_and_cancelling_inputs(cuda, inputs, q, ll, m, t,
                                                  c):
    """The bf16 Cannon at row strides of 2 and 4 bytes mod 16 (w's rows of
    97, 98, 129; x's of 97, 130, 70: padded once per loop by
    cannon_fwd_all, the slots in the padded layout), ragged M, N and K,
    L = 2, q = 3, and inputs that cancel across a wide exponent range: bit
    for bit the step loop (one wx launch per step) in an f32 and a bf16
    accumulator, and within CANNON_TOL of the plain Cannon (randn)."""
    if inputs == "wide":
        ws = [_wide(cuda, (m, t)) for _ in range(q * q)]
        xs = [_wide(cuda, (ll, t, c)) for _ in range(q * q)]
    else:
        ws, xs = _cannon_case(cuda, q, ll, m, t, c, torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = CANNON.cannon_step.launches
        got = CANNON.cannon_fwd_all(ws, xs, q, accum_dtype=out_dtype)
        torch.cuda.synchronize()
        assert CANNON.cannon_step.launches - before == q ** 3
        loop = ref.cannon_walk_all(
            lambda w, x, a: WX.wx(w, x, a, out_dtype=out_dtype), ws, xs, q)
        assert all(torch.equal(a, b) for a, b in zip(got, loop))
        if inputs == "randn" and out_dtype == torch.float32:
            for a, b in zip(got, ref.cannon_ref(ws, xs, q)):
                np.testing.assert_allclose(
                    a.cpu().numpy(), b.cpu().numpy(),
                    rtol=CANNON_TOL[torch.bfloat16],
                    atol=CANNON_TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("who,case", [("ring", "stride"), ("ring", "base"),
                                      ("cannon", "stride"),
                                      ("cannon", "base")])
def test_sm90_wrappers_raise_on_rows_tma_does_not_take(cuda, who, case):
    """A bf16 operand whose rows are 2 bytes mod 16 apart (not padded) or
    whose base is not 16-byte aligned: the wrapper raises ValueError and
    launches nothing; there is no fallback on a CUDA tensor."""
    bf = torch.bfloat16
    if case == "stride":
        x = torch.randn(40, 97, device="cuda").to(bf)
    else:
        x = torch.randn(40 * 104 + 1, device="cuda").to(bf)[1:].view(
            40, 104)[:, :97]
    if who == "ring":
        w = RING.pad_rows(torch.randn(60, 97, device="cuda").to(bf))
        cur = RING.pad_rows(torch.randn(40, 30, device="cuda").to(bf))
        before = RING.ring_bwd.launches
        with pytest.raises(ValueError, match="TMA"):
            RING.ring_bwd(x, w, 0, cur, None,
                          torch.empty(60, 97, dtype=bf, device="cuda"),
                          None, None, first=True, last=True)
        assert RING.ring_bwd.launches == before
    else:
        xc = RING.pad_rows(torch.randn(1, 97, 16, device="cuda").to(bf))
        before = CANNON.cannon_step.launches
        with pytest.raises(ValueError, match="TMA"):
            CANNON.cannon_step(x, xc, torch.empty(1, 40, 16, device="cuda"),
                               first=True)
        assert CANNON.cannon_step.launches == before


@pytest.mark.cuda
def test_sm90_kernels_start_with_the_registers_setmaxnreg_moves(cuda):
    """The Hopper-loop kernels (Cannon, the ring's two steps, every
    block_matmul and wx variant) run 384 threads, one block per SM, start
    with enough registers for setmaxnreg to give the consumers 232 and the
    producer 40 (else the launch refuses, rather than wait forever), and
    spill nothing."""
    need = 232 * 256 + 40 * 128
    variants = [CANNON.kernel_attrs(), CANNON.kernel_attrs(out_bf16=True),
                RING.kernel_attrs(0), RING.kernel_attrs(2)]
    variants += [BM.kernel_attrs("sm90", x_t, w_t, epi)
                 for x_t in (False, True) for w_t in (False, True)
                 for epi in ("none", "gelu", "silu")]
    variants += [WX.kernel_attrs("sm90", w_t, out_bf16)
                 for w_t in (False, True) for out_bf16 in (False, True)]
    for attrs in variants:
        assert attrs["threads"] >= 384
        assert attrs["registers"] * 384 >= need, attrs
        assert attrs["dynamic_shared_bytes"] <= 232448
        assert attrs["local_bytes"] == 0, attrs   # no spills (GELU too)
    assert WX.kernel_attrs("split")["local_bytes"] == 0


@pytest.mark.cuda
def test_f32_kernels_spill_nothing_and_fit_two_blocks_an_sm(cuda):
    """The five kernels on the f32 loop (every block_matmul layout, wx and
    Cannon with an f32 or bf16 out, the ring's two steps): 256 threads, no
    spills, the loop's two stages of static shared memory, and at most 128
    registers, so two blocks share an SM."""
    variants = [BM.kernel_attrs("f32", x_t, w_t)
                for x_t in (False, True) for w_t in (False, True)]
    variants += [WX.kernel_attrs("f32", w_t, out_bf16)
                 for w_t in (False, True) for out_bf16 in (False, True)]
    variants += [CANNON.kernel_attrs(out_bf16=o, f32=True)
                 for o in (False, True)]
    variants += [RING.kernel_attrs(1), RING.kernel_attrs(3)]
    for attrs in variants:
        assert attrs["threads"] >= 256, attrs
        assert attrs["local_bytes"] == 0, attrs
        assert attrs["registers"] <= 128, attrs
        assert attrs["static_shared_bytes"] == 2 * 2 * 16 * 132 * 4, attrs


@pytest.mark.cuda
def test_cannon_wrapper_rejects_bad_inputs(cuda):
    """What the kernel does not take raises, and launches nothing."""
    ws, xs = _cannon_case(cuda, 1, 2, 16, 8, 4, torch.bfloat16)
    w, x = ws[0], xs[0]
    out = torch.empty(2, 16, 4, device="cuda")
    before = CANNON.cannon_step.launches
    for bad in (dict(x=x.transpose(1, 2).contiguous().transpose(1, 2)),
                dict(w=w.float()), dict(out=out.cpu()),
                dict(w_dest=torch.empty(16, 8, device="cuda")),
                dict(x_dest=torch.empty(2, 8, 3, dtype=torch.bfloat16,
                                        device="cuda"))):
        kw = dict(w=w, x=x, out=out, w_dest=None, x_dest=None)
        kw.update(bad)
        with pytest.raises((ValueError, TypeError)):
            CANNON.cannon_step(kw["w"], kw["x"], kw["out"], first=True,
                               w_dest=kw["w_dest"], x_dest=kw["x_dest"])
    assert CANNON.cannon_step.launches == before


@pytest.mark.cuda
def test_cannon_failed_ipc_open_raises(cuda, monkeypatch):
    """A predecessor's IPC handle that does not open: the Cannon's
    workspace (peer -1) raises instead of falling back."""
    me = os.getpid()

    def fake_gather(out, obj, group=None):
        out[0], out[1] = obj, (b"\0" * len(obj[0]), me + 1, obj[2])
    monkeypatch.setattr(RING.dist, "get_world_size", lambda g: 2)
    monkeypatch.setattr(RING.dist, "get_rank", lambda g: 0)
    monkeypatch.setattr(RING.dist, "all_gather_object", fake_gather)
    with pytest.raises(RuntimeError, match="peer -1"):
        RING.RingWorkspace(None, 1 << 20, torch.device("cuda", 0), peer=-1)


def _ssd_inputs(gen, g, q, n, p, dtype, decay=0.1):
    c = (0.3 * torch.randn(g, q, n, generator=gen, device="cuda")).to(dtype)
    b = (0.3 * torch.randn(g, q, n, generator=gen, device="cuda")).to(dtype)
    x = torch.randn(g, q, p, generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(g, q, generator=gen, device="cuda"))
    dac = torch.cumsum(-dt * decay, dim=1)
    return c, b, x, dt, dac


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gqnp", [(6, 64, 32, 16), (5, 37, 128, 64),
                                  (3, 64, 128, 128), (2, 1, 1, 1)])
def test_ssd_kernel_matches_plain_version(cuda, dtype, gqnp):
    """f32 2e-4 (the reference's kernel tolerance; sums of 128 and 64 terms
    in another order); bf16 3e-2 (att and y rounded to bf16)."""
    args = _ssd_inputs(cuda, *gqnp, dtype)
    before = SSD.ssd_intra_chunk.launches
    y = SSD.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert SSD.ssd_intra_chunk.launches == before + 1
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ref.ssd_intra_ref(*args).float().cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_ssd_kernel_overflow_above_the_diagonal_is_masked(cuda):
    args = _ssd_inputs(cuda, 4, 64, 128, 64, torch.float32, decay=16.0)
    dac = args[4]
    assert torch.isinf(torch.exp(dac[:, :, None] - dac[:, None, :])).any()
    y = SSD.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y, ref.ssd_intra_ref(*args), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.cuda
def test_ssd_wrapper_rejects_non_contiguous(cuda):
    c, b, x, dt, dac = _ssd_inputs(cuda, 2, 16, 8, 4, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        SSD.ssd_intra_chunk(c.transpose(1, 2).contiguous().transpose(1, 2),
                            b, x, dt, dac)


def _heads_inputs(gen, bsz, s, h, p, g, n, dtype, wide=False, chunk=64):
    """x [b, s, h, p], dt, dac [b, s, h] (dac the within-chunk cumsum of
    dt * A at ``chunk``), B, C [b, s, g, n].  ``wide``: x, B and C are
    column slices of one [b, s, h p + 2 g n + 8] buffer, as the model's
    split of its conv output (rows of a stride other than their width)."""
    if wide:
        buf = torch.randn(bsz, s, h * p + 2 * g * n + 8, generator=gen,
                          device="cuda")
        buf[..., h * p:] *= 0.3
        buf = buf.to(dtype)
        x = buf[..., :h * p].unflatten(-1, (h, p))
        bm = buf[..., h * p:h * p + g * n].unflatten(-1, (g, n))
        cm = buf[..., h * p + g * n:h * p + 2 * g * n].unflatten(-1, (g, n))
    else:
        x = torch.randn(bsz, s, h, p, generator=gen, device="cuda").to(dtype)
        bm = (0.3 * torch.randn(bsz, s, g, n, generator=gen,
                                device="cuda")).to(dtype)
        cm = (0.3 * torch.randn(bsz, s, g, n, generator=gen,
                                device="cuda")).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(bsz, s, h, generator=gen, device="cuda"))
    a = -torch.linspace(1.0, 16.0, h, device="cuda")
    dac = torch.cumsum((dt * a).unflatten(1, (-1, chunk)), dim=2).flatten(
        1, 2)
    return x, dt, dac, bm, cm


def _as_groups(x, dt, dac, bm, cm, chunk):
    """The heads layout copied into [G, Q, N] groups, as the model laid it
    out before the heads entry."""
    bsz, s, h, _ = x.shape
    rep = h // bm.shape[2]
    nc = s // chunk

    def groups(t):
        t = t.reshape((bsz, nc, chunk) + t.shape[2:]).movedim(3, 2)
        return t.reshape((bsz * nc * h, chunk) + t.shape[4:]).contiguous()
    return (groups(cm.repeat_interleave(rep, 2)),
            groups(bm.repeat_interleave(rep, 2)), groups(x), groups(dt),
            groups(dac))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 256, 24, 64, 1, 128, False),
                                   (2, 256, 24, 64, 1, 128, True),
                                   (1, 192, 8, 32, 2, 64, True),
                                   (3, 128, 4, 16, 4, 32, False)])
def test_ssd_heads_entry_is_the_groups_entry_bit_for_bit(cuda, dtype,
                                                         shape):
    """The model's entry, reading x, dt, dac, B and C where they lie (one,
    two and four head groups; operands as slices of one wide buffer too),
    equals the [G, Q, N] entry on the same operands copied into groups, bit
    for bit (the same fmaf chains); one launch a call, on the TMA
    route."""
    *dims, wide = shape
    args = _heads_inputs(cuda, *dims, dtype, wide=wide)
    SSD.ssd_intra_chunk.route_launches.clear()
    before = SSD.ssd_intra_chunk.launches
    y = SSD.ssd_intra_heads(*args, 64)
    torch.cuda.synchronize()
    assert SSD.ssd_intra_chunk.launches == before + 1
    assert SSD.ssd_intra_chunk.route_launches == {"heads.tma": 1}
    bsz, s, h, p = args[0].shape
    want = SSD.ssd_intra_chunk(*_as_groups(*args, 64))
    want = want.reshape(bsz, s // 64, h, 64, p).movedim(2, 3).reshape(
        bsz, s, h, p)
    assert torch.equal(y, want)
    np.testing.assert_allclose(
        y.float().cpu().numpy(),
        ref.ssd_intra_heads_ref(*args, 64).float().cpu().numpy(),
        rtol=2e-4 if dtype == torch.float32 else 3e-2,
        atol=2e-4 if dtype == torch.float32 else 3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gqnp", [(5, 37, 5, 3), (3, 64, 7, 9),
                                  (4, 20, 4, 6)])
def test_ssd_odd_widths_take_the_scalar_route(cuda, dtype, gqnp):
    """Rows that TMA cannot take (odd N or P, a bf16 row of 8
    bytes) go through the kernel's element-load route, counted, one launch,
    within the kernel tolerance of the plain version."""
    args = _ssd_inputs(cuda, *gqnp, dtype)
    SSD.ssd_intra_chunk.route_launches.clear()
    before = SSD.ssd_intra_chunk.launches
    y = SSD.ssd_intra_chunk(*args)
    torch.cuda.synchronize()
    assert SSD.ssd_intra_chunk.launches == before + 1
    assert SSD.ssd_intra_chunk.route_launches == {"groups.scalar": 1}
    tol = 2e-4 if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               ref.ssd_intra_ref(*args).float().cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_ssd_heads_entry_odd_widths_take_the_scalar_route(cuda):
    """The model's entry at an odd state width (n = 5): the scalar route,
    bit for bit the groups entry (which takes that route too)."""
    args = _heads_inputs(cuda, 2, 128, 4, 6, 2, 5, torch.float32)
    SSD.ssd_intra_chunk.route_launches.clear()
    y = SSD.ssd_intra_heads(*args, 64)
    torch.cuda.synchronize()
    assert SSD.ssd_intra_chunk.route_launches == {"heads.scalar": 1}
    want = SSD.ssd_intra_chunk(*_as_groups(*args, 64))
    assert torch.equal(y, want.reshape(2, 2, 4, 64, 6).movedim(2, 3)
                       .reshape(2, 128, 4, 6))


@pytest.mark.cuda
def test_ssd_chunked_calls_the_heads_entry(cuda, monkeypatch):
    """``_ssd_chunked`` on the card: one heads-entry launch, B and C passed
    un-repeated and x, dt as they lie (no groups copy), the result within
    the scan tolerance of the plain arrangement."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import _ssd_chunked
    x, dt, _, bm, cm = _heads_inputs(cuda, 2, 256, 8, 32, 2, 64,
                                     torch.float32, wide=True)
    a = -torch.linspace(1.0, 16.0, 8, device="cuda")
    seen = []
    real = ops.ssd_intra_heads

    def spy(*args):
        seen.append(args)
        return real(*args)
    monkeypatch.setattr(ops, "ssd_intra_heads", spy)
    SSD.ssd_intra_chunk.route_launches.clear()
    y, state = _ssd_chunked(x, dt, a, bm, cm, 64)
    torch.cuda.synchronize()
    assert SSD.ssd_intra_chunk.route_launches == {"heads.tma": 1}
    (xa, dta, _, ba, ca, _), = seen
    assert xa is x and dta is dt and ba is bm and ca is cm
    monkeypatch.setattr(ops, "ssd_intra_heads", ref.ssd_intra_heads_ref)
    y_p, state_p = _ssd_chunked(x, dt, a, bm, cm, 64)
    torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state, state_p, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_mamba_forward_and_decode_launch_counts(cuda):
    """The ssm family on the card (reduced config, kernel="pallas"): one
    ssd launch per layer and 4 per layer + 1 block_matmul launches per
    forward, within 2e-3 of the plain forward (bf16-free f32 path); the
    decode step launches no ssd kernel."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.shapes import jigsaw_for
    from repro_torch.models import registry as M
    cfg = get_config("mamba2-130m").reduced()
    jcfg = jigsaw_for(cfg).replace(kernel="pallas")
    params = M.init(cfg, seed=0, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), generator=cuda,
                           device="cuda")
    s0, b0 = SSD.ssd_intra_chunk.launches, BM.block_matmul.launches
    logits, _ = M.apply(params, {"tokens": tokens}, cfg, jcfg)
    torch.cuda.synchronize()
    assert SSD.ssd_intra_chunk.launches - s0 == cfg.n_layers
    assert BM.block_matmul.launches - b0 == 4 * cfg.n_layers + 1
    plain, _ = M.apply(params, {"tokens": tokens}, cfg,
                       jcfg.replace(kernel="xla"))
    torch.testing.assert_close(logits, plain, rtol=2e-3, atol=2e-3)
    cache = M.init_cache(cfg, 2, 4, device="cuda")
    s0 = SSD.ssd_intra_chunk.launches
    M.decode_step(params, cache, tokens[:, :1], cfg, jcfg)
    torch.cuda.synchronize()
    assert SSD.ssd_intra_chunk.launches == s0


def _bwd_err(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 74, 2, 3, 1, 5, 37, False),      # ragged Q 37, N 5, P 3
    (2, 128, 4, 64, 2, 128, 64, True),   # two groups, slices of one buffer
    (2, 128, 6, 64, 1, 128, 64, False),  # one group of six heads
    (1, 192, 8, 32, 4, 64, 64, True)])
def test_ssd_bwd_kernel_matches_plain_version(cuda, shape):
    """The backward kernel (``csrc/ssd_chunk_bwd.cu``) against
    ``ref.ssd_intra_heads_bwd_ref`` on the same operands, x, B and C at
    their strides: each of dx, ddt, ddac, dB and dC within 1e-4
    max-normalised of the plain version in f32 and of the same in float64
    (sums of up to 64 heads' [Q, Q] terms in another order), finite,
    where the models' decays (A to -16) overflow exp above the diagonal;
    one launch a call, and a second launch bit for bit the first (one
    block an item, no atomics)."""
    b, s, h, p, g, n, q, wide = shape
    x, dt, dac, bm, cm = _heads_inputs(cuda, b, s, h, p, g, n,
                                       torch.float32, wide=wide, chunk=q)
    dy = torch.randn(b, s, h, p, generator=cuda, device="cuda")
    args = (x, dt, dac, bm, cm, dy)
    before = SSDB.ssd_intra_heads_bwd.launches
    got = SSDB.ssd_intra_heads_bwd(*args, q)
    again = SSDB.ssd_intra_heads_bwd(*args, q)
    torch.cuda.synchronize()
    assert SSDB.ssd_intra_heads_bwd.launches == before + 2
    plain = ref.ssd_intra_heads_bwd_ref(*args, q)
    f64 = ref.ssd_intra_heads_bwd_ref(*(t.double() for t in args), q)
    for name, k, r, r64, k2 in zip(("dx", "ddt", "ddac", "dB", "dC"), got,
                                    plain, f64, again):
        assert k.shape == r.shape and k.is_contiguous(), name
        assert bool(torch.isfinite(k).all()), name
        assert torch.equal(k, k2), name
        assert _bwd_err(k, r) <= 1e-4, (name, _bwd_err(k, r))
        assert _bwd_err(k, r64) <= 1e-4, (name, _bwd_err(k, r64))


@pytest.mark.cuda
def test_ssd_heads_autograd_launches_the_backward_kernel(cuda):
    """``ops.ssd_intra_heads`` on CUDA tensors: the forward one ssd launch,
    ``backward`` one ssd_chunk_bwd launch whose gradients are the
    kernel's own; bf16 operands raise in the backward."""
    from repro_torch.kernels import ops
    x, dt, dac, bm, cm = _heads_inputs(cuda, 2, 128, 4, 16, 2, 32,
                                       torch.float32, wide=True)
    leaves = [t.detach().requires_grad_(True) for t in (x, dt, dac, bm, cm)]
    f0, b0 = SSD.ssd_intra_chunk.launches, SSDB.ssd_intra_heads_bwd.launches
    y = ops.ssd_intra_heads(*leaves, 64)
    dy = torch.randn_like(y)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert SSD.ssd_intra_chunk.launches == f0 + 1
    assert SSDB.ssd_intra_heads_bwd.launches == b0 + 1
    want = SSDB.ssd_intra_heads_bwd(x, dt, dac, bm, cm, dy, 64)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    xb = x.detach().to(torch.bfloat16).requires_grad_(True)
    y = ops.ssd_intra_heads(xb, dt, dac, bm.to(torch.bfloat16),
                            cm.to(torch.bfloat16), 64)
    with pytest.raises(TypeError, match="float32"):
        y.float().sum().backward()


@pytest.mark.cuda
def test_mamba_train_step_launch_counts(cuda, monkeypatch):
    """One remat training step of the ssm family on the card (reduced,
    kernel="pallas"): 2 ssd forward launches a layer (forward and
    recompute) and 1 ssd_chunk_bwd launch, loss and grad norm within 1e-4
    of the same step with the plain SSD term (both directions) and every
    gradient finite."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree as ptree
    from repro_torch.data.pipeline import make_source
    from repro_torch.launch.shapes import jigsaw_for
    from repro_torch.models import registry as M
    from repro_torch.optim.adam import global_norm
    from repro_torch.train.step import value_and_grad
    cfg = get_config("mamba2-130m").reduced().replace(kernel="pallas",
                                                      remat=True)
    jcfg = jigsaw_for(cfg)
    params = M.init(cfg, seed=0, device="cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in make_source(
        cfg, 2, seq_len=128).full_batch(0, 1).items()}
    f0, b0 = SSD.ssd_intra_chunk.launches, SSDB.ssd_intra_heads_bwd.launches
    m, g = value_and_grad(params, batch, cfg, jcfg)
    torch.cuda.synchronize()
    assert SSD.ssd_intra_chunk.launches - f0 == 2 * cfg.n_layers
    assert SSDB.ssd_intra_heads_bwd.launches - b0 == cfg.n_layers
    monkeypatch.setattr(SSD, "ssd_intra_heads", ref.ssd_intra_heads_ref)
    monkeypatch.setattr(SSDB, "ssd_intra_heads_bwd",
                        ref.ssd_intra_heads_bwd_ref)
    mr, gr = value_and_grad(params, batch, cfg, jcfg)
    assert abs(float(m["loss"]) - float(mr["loss"])) <= 1e-4 * abs(
        float(mr["loss"]))
    n, nr = float(global_norm(g)), float(global_norm(gr))
    assert abs(n - nr) <= 1e-4 * nr
    assert all(bool(torch.isfinite(t).all()) for t in ptree.leaves(g))


@pytest.mark.cuda
def test_2x2_mesh_four_processes_on_one_card(cuda, tmp_path):
    """Four processes of a 2x2 mesh on one card under gloo, each rank's
    Cannon slots mapped into its predecessors by CUDA IPC: fused_cannon_t
    forward and backward equal the step loop's bit for bit with q launches
    per rank; a 2-D training step through TrainEngine with per-rank reads
    gives the loss and grad norm of the step-loop variant bit for bit,
    with 24 Cannon launches at r = 1 (3 blocks, remat), 12 wx recompute
    and 12 wx dx launches, 70 block_matmul launches and no ring launch."""
    res = _run_ranks("--cannon-rank", tmp_path, 4)
    assert all(r["loss"] == res[0]["loss"] for r in res)
    for r in res:
        assert r["fused_launches"] == 2
        assert r["fused_equal"], r
        assert r["loss"] == r["loss_step_loop"]
        assert r["grad_norm"] == r["grad_norm_step_loop"]
        assert r["launches"] == dict(cannon=24, wx_fwd=12, wx_dx=12,
                                     block_matmul=70, ring=0)
        assert r["block_equal"] and r["read_share"] == 0.25


@pytest.mark.cuda
def test_data_mesh_four_processes_on_one_card(cuda, tmp_path):
    """A (data 2, p 2) 1-D mesh of four processes on one card, each model
    group's ring slots mapped by CUDA IPC apart from the other's: each
    rank reads 1/4 of the batch, a step at r = 1 (3 blocks, remat) runs
    52 ring_fwd and 28 ring_bwd launches and no block_matmul, and two
    steps with ZeRO-1, and with ZeRO-1 and the FSDP hybrid, give the
    losses, grad norms and parameters of the run without either bit for
    bit; the FSDP hybrid holds half of each weight."""
    res = _run_ranks("--data-rank", tmp_path, 4)
    for r in res:
        assert r["read_share"] == 0.25
        for tag in ("base", "zero1", "fsdp"):
            assert r[tag]["launches"] == dict(ring_fwd=52, ring_bwd=28,
                                              block_matmul=0), (tag, r)
            assert r[tag]["loss"] == r["base"]["loss"]
            assert r[tag]["grad_norm"] == r["base"]["grad_norm"]
        assert r["zero1"]["params_equal"] and r["fsdp"]["params_equal"]
        assert r["fsdp"]["weight_share"] == 0.5
    assert all(r["base"]["loss"] == res[0]["base"]["loss"] for r in res)


def _data_rank_main(r, n, init, out_dir):
    """One rank of ``test_data_mesh_four_processes_on_one_card``."""
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree as ptree
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    os.environ["LOCAL_RANK"] = str(r)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=r, world_size=n)
    res, kept = {}, None
    for tag, fsdp, zero1 in (("base", False, False), ("zero1", False, True),
                             ("fsdp", True, True)):
        cfg = get_config("weathermixer-1b").reduced().replace(
            wm_lat=20, wm_lon=24, wm_channels=4, wm_patch=4, d_model=64,
            wm_d_tok=64, wm_d_ch=64, kernel="pallas", remat=True,
            n_layers=3, shard_params_over_data=fsdp)
        eng = TrainEngine("weathermixer-1b", reduced=False,
                          config_override=cfg, mesh_model=2, mesh_data=2,
                          scheme="1d", impl="ring_fused", device="cuda",
                          config=EngineConfig(steps=2, batch=2,
                                              precision="bf16", prefetch=0,
                                              zero1=zero1))
        batch = eng.pipeline.get(0, 1)
        res["read_share"] = (eng.pipeline.stats.rank_bytes["fields"]
                             [eng.mesh.rank] / (2 * 20 * 24 * 4 * 4))
        for f in (RING.ring_fwd, RING.ring_bwd, BM.block_matmul):
            f.launches = 0
        m1 = eng.dispatch(batch, 1)
        torch.cuda.synchronize()
        launches = dict(ring_fwd=RING.ring_fwd.launches,
                        ring_bwd=RING.ring_bwd.launches,
                        block_matmul=BM.block_matmul.launches)
        m2 = eng.dispatch(batch, 1)
        leaves = [t.cpu() for t in ptree.leaves(eng.params)]
        rec = dict(launches=launches,
                   loss=[float(m["loss"]) for m in (m1, m2)],
                   grad_norm=[float(m["grad_norm"]) for m in (m1, m2)])
        if kept is None:
            kept = leaves
        else:
            def same(a, b):
                if a.shape != b.shape:      # the FSDP hybrid's block of a
                    a = a.narrow(0, eng.mesh.data_index * b.shape[0],
                                 b.shape[0])
                return torch.equal(a, b)
            rec["params_equal"] = all(same(a, b)
                                      for a, b in zip(kept, leaves))
            rec["weight_share"] = sum(
                b.numel() for a, b in zip(kept, leaves) if b.dim() == 2) / sum(
                a.numel() for a in kept if a.dim() == 2)
        res[tag] = rec
        eng.close()
    (Path(out_dir) / f"--data-rank{r}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def _run_ranks(mode, tmp_path, n=2, timeout=300):
    """This file run as n scripts in ``mode`` on the one card, joined by a
    file store; returns their JSON results."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(r), str(n),
         f"file://{tmp_path / 'store'}", str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    return [json.loads((tmp_path / f"{mode}{r}.json").read_text())
            for r in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3])
def test_ring_two_processes_on_one_card_through_ipc(cuda, tmp_path, n):
    """n processes on one card under gloo, each rank's slots mapped into
    its predecessor by CUDA IPC: fused_ring_matmul's forward and backward
    equal the one-process form of the same kernels bit for bit, and each
    rank launched n kernels each way."""
    for res in _run_ranks("--ring-rank", tmp_path, n):
        assert res["fwd_launches"] == res["bwd_launches"] == n
        assert res["fwd_equal"] and res["dw_equal"] and res["dx_equal"], res


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 3])
def test_vocab_head_gather_through_ipc(cuda, tmp_path, n):
    """The vocab-parallel head's all-gather on n processes of one card,
    hops through the ring workspace's IPC slots: every rank's features in
    rank order bit for bit; its backward each rank's chunk of the summed
    cotangent, rounded once to bf16 (bit for bit at n = 2, one f32 add;
    at n = 3 the f32 adds run in the ring's order, so a rounding may land
    one bf16 step away: 2^-7 of the max); ``vocab_linear_1d`` under
    kernel="pallas" bit for bit block_matmul on the gathered features,
    with one launch; the bytes copied counted in ``fused_ring.ipc_bytes``
    and none through host memory."""
    for res in _run_ranks("--vocab-rank", tmp_path, n):
        assert res["gather_equal"] and res["head_equal"], res
        assert res["dx_err"] <= (0.0 if n == 2 else 2.0 ** -7), res
        assert res["head_launches"] == 1 and res["through_host"] == 0, res
        assert res["ipc"] == {"all_gather": (n - 1) * res["x_bytes"],
                              "reduce_scatter": (n - 1) * res["dx_bytes"]}


# the collectives the port calls, run on CUDA tensors under gloo without
# staging; which of them gloo takes is what comm.GLOO_CUDA_OPS records
_PROBES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
           "send_recv")


@pytest.mark.cuda
def test_gloo_device_collectives(cuda, tmp_path):
    """Which collectives gloo runs on CUDA tensors: each probed alone on two
    processes of one card (a probe's result is "ok", the error it raised,
    or the signal that ended it: gloo aborts the process on some device
    pointers).  Every collective comm hands to gloo on CUDA tensors must
    be one that works."""
    from repro_torch.core import comm
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {op: [subprocess.Popen(
        [sys.executable, __file__, "--gloo-probe", str(r), "2",
         f"file://{tmp_path / op}", str(tmp_path), op], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)] for op in _PROBES}
    found = {}
    for op, pair in procs.items():
        try:
            errs = [q.communicate(timeout=120)[1] for q in pair]
        finally:
            for q in pair:
                q.kill()
        path = tmp_path / f"{op}0.json"
        if path.exists():
            found[op] = json.loads(path.read_text())
        else:
            found[op] = f"exit {pair[0].returncode}: " + (
                errs[0].strip().splitlines() or [""])[-1][:160]
    print("gloo on CUDA tensors:", json.dumps(found))
    native = {op for op, r in found.items() if r == "ok"}
    assert comm.GLOO_CUDA_OPS <= native, found


def _ring_rank_main(r, n, init, out_dir):
    """One rank of ``test_ring_two_processes_on_one_card_through_ipc``."""
    import torch.distributed as dist
    from repro_torch.kernels import fused_ring
    from repro_torch.launch.mesh import make_ring_mesh
    os.environ["LOCAL_RANK"] = str(r)
    dist.init_process_group("gloo", init_method=init, rank=r, world_size=n)
    mesh = make_ring_mesh(n, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    xs, ws, dys = _ring_case(gen, n, 200, 72, 12 * n, torch.bfloat16)
    outs = RING.ring_fwd_all(xs, ws)
    dxs, dws, _ = RING.ring_bwd_all(xs, ws, dys)
    x = xs[r].clone().requires_grad_()
    w = ws[r].clone().requires_grad_()
    f0, b0 = RING.ring_fwd.launches, RING.ring_bwd.launches
    y = fused_ring.fused_ring_matmul(x, w, group=mesh.tp_group, p=n,
                                     rank=r)
    dx, dw = torch.autograd.grad(y, (x, w), dys[r])
    torch.cuda.synchronize()
    res = dict(fwd_launches=RING.ring_fwd.launches - f0,
               bwd_launches=RING.ring_bwd.launches - b0,
               fwd_equal=bool(torch.equal(y, outs[r])),
               dw_equal=bool(torch.equal(dw, dws[r])),
               dx_equal=bool(torch.equal(dx, dxs[r])))
    RING.release_workspaces()
    (Path(out_dir) / f"--ring-rank{r}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def _vocab_rank_main(r, n, init, out_dir):
    """One rank of ``test_vocab_head_gather_through_ipc``: every rank draws
    every rank's x and cotangent from one seed, so each knows the whole."""
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.core.jigsaw import vocab_linear_1d
    from repro_torch.kernels import fused_ring
    from repro_torch.launch.mesh import make_ring_mesh
    os.environ["LOCAL_RANK"] = str(r)
    dist.init_process_group("gloo", init_method=init, rank=r, world_size=n)
    mesh = make_ring_mesh(n, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows, dl, vl = 96, 40, 136
    xs = [torch.randn(2, rows // 2, dl, generator=gen, device="cuda")
          .to(torch.bfloat16) for _ in range(n)]
    dys = [torch.randn(2, rows // 2, n * dl, generator=gen, device="cuda")
           .to(torch.bfloat16) for _ in range(n)]
    w = torch.randn(vl, n * dl, generator=gen,
                    device="cuda").to(torch.bfloat16)
    fused_ring.ipc_bytes.clear()
    comm.through_host_bytes.clear()
    x = xs[r].clone().requires_grad_()
    got = fused_ring.gather_features(x, mesh.tp_group, n, r)
    (dx,) = torch.autograd.grad(got, (x,), dys[r])
    whole = torch.cat(xs, -1)
    total = torch.stack([d.float() for d in dys]).sum(0)
    want_dx = total[..., r * dl:(r + 1) * dl].to(torch.bfloat16)
    ipc = dict(fused_ring.ipc_bytes)
    before = BM.block_matmul.launches
    with torch.no_grad():
        logits = vocab_linear_1d(xs[r], w, mesh=mesh, kernel="pallas")
    launches = BM.block_matmul.launches - before
    torch.cuda.synchronize()
    res = dict(gather_equal=bool(torch.equal(got, whole)),
               dx_err=float((dx.float() - want_dx.float()).abs().max()
                            / want_dx.float().abs().max()),
               head_equal=bool(torch.equal(
                   logits, BM.block_matmul(whole.reshape(rows, -1), w)
                   .reshape(2, rows // 2, vl))),
               head_launches=launches,
               through_host=sum(comm.through_host_bytes.values()),
               ipc=ipc, x_bytes=x.numel() * x.element_size(),
               dx_bytes=4 * dx.numel())
    RING.release_workspaces()
    (Path(out_dir) / f"--vocab-rank{r}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def _step_loop(wl, xl, *, model_group, **kw):
    """fused_cannon_t forced to the step loop (one wx launch per step)."""
    from repro_torch.kernels import fused_ring
    return fused_ring.cannon_t_loop(wl, xl, **kw)


def _cannon_rank_main(r, n, init, out_dir):
    """One rank of ``test_2x2_mesh_four_processes_on_one_card``."""
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.kernels import fused_ring
    from repro_torch.models import weathermixer as W
    from repro_torch.optim.adam import global_norm
    from repro_torch.train.step import _norm_args, value_and_grad
    os.environ["LOCAL_RANK"] = str(r)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, rank=r, world_size=n)
    cfg = get_config("weathermixer-1b").reduced().replace(
        wm_lat=20, wm_lon=24, wm_channels=4, wm_patch=4, d_model=64,
        wm_d_tok=64, wm_d_ch=64, kernel="pallas", remat=True, n_layers=3)
    eng = TrainEngine("weathermixer-1b", reduced=False, config_override=cfg,
                      mesh_model=n, scheme="2d", device="cuda",
                      config=EngineConfig(steps=1, batch=2, precision="bf16",
                                          prefetch=0, pipeline="sharded"))
    mesh = eng.mesh
    groups = dict(dom_group=mesh.dom_group, tp_group=mesh.tp_group, q=2)
    gen = torch.Generator(device="cuda").manual_seed(7 + r)
    w = torch.randn(40, 30, generator=gen, device="cuda").to(torch.bfloat16)
    x = torch.randn(2, 30, 20, generator=gen,
                    device="cuda").to(torch.bfloat16)
    dy = torch.randn(2, 40, 20, generator=gen, device="cuda")
    outs = []
    for fn, kw in ((fused_ring.fused_cannon_t,
                    dict(groups, model_group=mesh.model_group)),
                   (fused_ring.cannon_t_loop, groups)):
        leaves = [w.clone().requires_grad_(), x.clone().requires_grad_()]
        before = CANNON.cannon_step.launches
        y = fn(*leaves, **kw)
        outs.append([y, *torch.autograd.grad(y, leaves, dy),
                     CANNON.cannon_step.launches - before])
    res = dict(fused_launches=outs[0][3],
               fused_equal=all(torch.equal(a, b) for a, b in
                               zip(outs[0][:3], outs[1][:3])))
    batch = eng.pipeline.get(0, 1)
    whole = eng.pipeline.host_batch(0, 1)
    res["block_equal"] = all(torch.equal(batch[k].cpu(), W.field_block(
        torch.from_numpy(whole[k]), eng.cfg, eng.jcfg)) for k in whole)
    res["read_share"] = (eng.pipeline.stats.rank_bytes["fields"]
                         [eng.pipeline.rank] / whole["fields"].nbytes)
    counters = dict(cannon=CANNON.cannon_step, block_matmul=BM.block_matmul,
                    ring=RING.ring_fwd)
    for f in (*counters.values(), RING.ring_bwd, WX.wx):
        f.launches = 0
    WX.wx.layout_launches.clear()
    metrics, grads = value_and_grad(eng.params, batch, eng.cfg, eng.jcfg, 1)
    torch.cuda.synchronize()
    res["launches"] = {k: f.launches for k, f in counters.items()}
    res["launches"]["ring"] += RING.ring_bwd.launches
    res["launches"].update(wx_fwd=WX.wx.layout_launches[False],
                           wx_dx=WX.wx.layout_launches[True])
    norm_args = _norm_args(eng.params, eng.cfg, eng.jcfg)
    res["loss"] = float(metrics["loss"])
    res["grad_norm"] = float(global_norm(grads, **norm_args))
    real = fused_ring.fused_cannon_t
    fused_ring.fused_cannon_t = _step_loop
    try:
        m2, g2 = value_and_grad(eng.params, batch, eng.cfg, eng.jcfg, 1)
    finally:
        fused_ring.fused_cannon_t = real
    res["loss_step_loop"] = float(m2["loss"])
    res["grad_norm_step_loop"] = float(global_norm(g2, **norm_args))
    eng.close()
    (Path(out_dir) / f"--cannon-rank{r}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


def _gloo_probe_main(r, n, init, out_dir, op):
    """One collective of ``_PROBES`` on CUDA tensors under gloo, as is,
    its result held to the values it must give."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=r, world_size=n)
    x = torch.arange(4.0, device="cuda") + 10 * r
    xs = [torch.arange(4.0) + 10 * k for k in range(n)]    # every rank's

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return y, sum(xs)

    def all_gather():
        y = torch.empty(4 * n, device="cuda")
        dist.all_gather_into_tensor(y, x)
        return y, torch.cat(xs)

    def reduce_scatter():
        y = torch.empty(4 // n, device="cuda")
        dist.reduce_scatter_tensor(y, x)
        return y, sum(xs).chunk(n)[r]

    def all_to_all():
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return y, torch.cat([v.chunk(n)[r] for v in xs])

    def send_recv():
        y = torch.empty_like(x)
        for q in dist.batch_isend_irecv(
                [dist.P2POp(dist.isend, x, (r + 1) % n),
                 dist.P2POp(dist.irecv, y, (r - 1) % n)]):
            q.wait()
        return y, xs[(r - 1) % n]

    calls = dict(all_reduce=all_reduce, all_gather=all_gather,
                 reduce_scatter=reduce_scatter, all_to_all=all_to_all,
                 send_recv=send_recv)
    try:
        got, want = calls[op]()
        torch.cuda.synchronize()
        res = "ok" if torch.equal(got.cpu(), want) else "wrong values"
    except (RuntimeError, ValueError, NotImplementedError) as e:
        res = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    (Path(out_dir) / f"{op}{r}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


if __name__ == "__main__":
    mode, rank, n, init, out, *extra = sys.argv[1:]
    main = {"--ring-rank": _ring_rank_main,
            "--vocab-rank": _vocab_rank_main,
            "--cannon-rank": _cannon_rank_main,
            "--data-rank": _data_rank_main,
            "--gloo-probe": _gloo_probe_main}[mode]
    main(int(rank), int(n), init, out, *extra)
