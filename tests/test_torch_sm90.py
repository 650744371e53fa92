"""block_matmul and wx on the Hopper loop (``csrc/gemm_sm90.cuh``), on the
CPU: their TMA operand plans at every shape of ``chip_smoke.py``, the
route rule, the split of wx's dx route (``ref.split_bf16x3``) and the dx
entry's CPU path against the reference's VJP.

The plans are held to a stride rule computed here apart from the code
(the least multiple of 8 bf16, 16 bytes, at or above a row's width) and
to the operands each smoke shape must pad: rows of T = 16,380 tokens
(tok_fc1's x and w, tok_fc2's dz) and a 2x2 rank's 8,190.  The card half
is ``tests/test_torch_cuda.py``.
"""
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import fused_ring as ref_fused_ring
from repro_torch.kernels import block_matmul as BM
from repro_torch.kernels import cannon as CANNON
from repro_torch.kernels import ref
from repro_torch.kernels import ring as RING
from repro_torch.kernels import sm90 as SM90
from repro_torch.kernels import ssd_chunk as SSD
from repro_torch.kernels import wx as WX

BF = torch.bfloat16
# weathermixer-1b: tokens, d_model, patch dim, d_tok, d_ch
T, D, PD, D_TOK, D_CH = 16380, 4320, 4416, 8640, 4320
# chip_smoke.py's SHAPES: (label, M, K, N) of the forward x [M, K] @ w.T
SHAPES = [("encoder", T, PD, D), ("tok_fc1", D, T, D_TOK),
          ("tok_fc2", D, D_TOK, T), ("ch_fc1", T, D, D_CH),
          ("ch_fc2", T, D_CH, D), ("decoder", T, D, PD)]
# chip_smoke.py's MAMBA_SHAPES: (label, M, K, N)
MAMBA_SHAPES = [(f"{tag}.{name}", m, k, n)
                for tag, m in (("fwd", 8192), ("decode", 4))
                for name, k, n in (("in_z", 768, 1536), ("in_xbc", 768, 1792),
                                   ("in_dt", 768, 24), ("out_proj", 1536, 768),
                                   ("head", 768, 50432))]
# chip_smoke.py's WX_SHAPES: (label, m, t, c) of w [m, t] @ x [L, t, c]
WX_SHAPES = [("q1.tok_fc1", D_TOK, T, D), ("q1.tok_fc2", T, D_TOK, D),
             ("2x2.tok_fc1", D_TOK // 2, T // 2, D // 2),
             ("2x2.tok_fc2", T // 2, D_TOK // 2, D // 2)]


def _ld(cols):
    """The padded row stride, computed apart from the code: the least
    multiple of 8 bf16 (16 bytes) at or above cols."""
    return cols + (-cols) % 8


def _gemms(label, m, k, n):
    """The smoke run's three launches of a linear: (kind, M, N, K, x_t,
    w_t) of the forward, dx = dz @ w and dw = dz.T @ x."""
    return [("fwd", m, n, k, False, False), ("dx", m, k, n, False, True),
            ("dw", n, k, m, True, True)]


# the operands each launch pads (rows of 16,380 elements)
PADDED = {("tok_fc1", "fwd"): {"x", "w"}, ("tok_fc1", "dx"): {"w"},
          ("tok_fc1", "dw"): {"w"}, ("tok_fc2", "dx"): {"x"},
          ("tok_fc2", "dw"): {"x"}}


@pytest.mark.parametrize("label,m,k,n", SHAPES)
def test_block_matmul_plans_at_the_smoke_shapes(label, m, k, n):
    """Each launch's x and w: stored [M, K] / [N, K] read K-major in
    [128][64] boxes, or [K, M] / [K, N] (x_t / w_t) read M- or N-major in
    [64][64] boxes; ld the width rounded up to 16 bytes, padded exactly
    where the width is not a multiple of 8."""
    for kind, gm, gn, gk, x_t, w_t in _gemms(label, m, k, n):
        ops = SM90.tma_operands_block_matmul(gm, gn, gk, x_t, w_t)
        assert set(ops) == {"x", "w"}
        want = {"x": (gk, gm) if x_t else (gm, gk),
                "w": (gk, gn) if w_t else (gn, gk)}
        for name, op in ops.items():
            assert op.shape == want[name]
            assert op.ld == _ld(op.shape[-1]) and op.ld * 2 % 16 == 0
            assert op.padded == (op.shape[-1] % 8 != 0)
            t = x_t if name == "x" else w_t
            assert op.boxes == (((64, 64),) if t else ((64, 128),))
        padded = {name for name, op in ops.items() if op.padded}
        assert padded == PADDED.get((label, kind), set()), (label, kind)
        assert BM.route(gm, gn, BF) == "sm90"


@pytest.mark.parametrize("x_t,w_t", [(False, False), (False, True),
                                     (True, False), (True, True)])
@pytest.mark.parametrize("label,m,k,n", SHAPES)
def test_block_matmul_plans_in_every_layout(label, m, k, n, x_t, w_t):
    """All four layouts at each smoke shape's [M, N, K] (the smoke runs
    three: the forward, dx and dw; (x_t, w_t) = (1, 0) is an M-major A
    with a K-major B): x and w stored as the layout says, their boxes,
    and ld padded exactly where the stored width is not a multiple of 8
    (the widths of 16,380)."""
    ops = SM90.tma_operands_block_matmul(m, n, k, x_t, w_t)
    x_shape = (k, m) if x_t else (m, k)
    w_shape = (k, n) if w_t else (n, k)
    assert (ops["x"].shape, ops["w"].shape) == (x_shape, w_shape)
    assert ops["x"].boxes == (((64, 64),) if x_t else ((64, 128),))
    assert ops["w"].boxes == (((64, 64),) if w_t else ((64, 128),))
    for op, shape in ((ops["x"], x_shape), (ops["w"], w_shape)):
        assert op.ld == _ld(shape[-1])
        assert op.padded == (shape[-1] == T)


@pytest.mark.parametrize("label,m,k,n", MAMBA_SHAPES)
def test_block_matmul_plans_and_routes_at_the_mamba_shapes(label, m, k, n):
    """mamba2-130m's forward and decode GEMMs (x [M, K] @ w [N, K].T: the
    ssm family runs no backward) need no padding (K of 768 or 1,536);
    M = 4 (decode) or N = 24 (in_dt) takes the WMMA loop, the rest the
    Hopper loop: chip_smoke.py's route counts."""
    ops = SM90.tma_operands_block_matmul(m, n, k)
    assert not any(op.padded for op in ops.values())
    small = m == 4 or n == 24
    assert BM.route(m, n, BF) == ("wmma" if small else "sm90")
    assert BM.route(m, n, torch.float32) == "f32"


@pytest.mark.parametrize("w_t", [False, True])
@pytest.mark.parametrize("ll", [1, 2])
@pytest.mark.parametrize("label,m,t,c", WX_SHAPES)
def test_wx_plans_at_the_smoke_shapes(label, m, t, c, ll, w_t):
    """The forward reads w [m, t] K-major in a [128][64] box, dx (w_t) the
    same buffer as W = w.T, M-major in [64][64] boxes; x [L, t, c] (or the
    cotangent [L, m, c], and its split terms at the same ld) N-major in
    [64][64] boxes.  w's rows of 16,380 (q = 1 tok_fc1) and 8,190 (2x2
    tok_fc1) are padded, no x is."""
    gm, gk = (t, m) if w_t else (m, t)
    ops = SM90.tma_operands_wx(ll, gm, c, gk, w_t)
    assert ops["w"].shape == (m, t) and ops["x"].shape == (ll, gk, c)
    assert ops["w"].boxes == (((64, 64),) if w_t else ((64, 128),))
    assert ops["x"].boxes == ((64, 64),)
    for op in ops.values():
        assert op.ld == _ld(op.shape[-1])
    assert ops["w"].padded == label.endswith("tok_fc1")
    assert not ops["x"].padded


def test_plans_live_in_one_module():
    """The planning the ring and the Cannon step used is the shared one:
    ring's names resolve to kernels/sm90.py's."""
    for name in ("tma_ld", "TmaOperand", "plan_operand", "check_tma",
                 "pad_rows", "persistent_grid", "sm90_tiles", "row_stride",
                 "span_bytes", "tma_operands_ring_bwd",
                 "tma_operands_cannon"):
        assert getattr(RING, name) is getattr(SM90, name), name


@pytest.mark.parametrize("module", [BM, WX, RING, CANNON, SSD])
def test_every_included_header_is_in_the_library_digest(module):
    """A library is named by the digest of its source and the headers it
    lists, so each header the source includes must be listed, or a change
    to it would not rebuild the library."""
    lib = module.LIBRARY
    included = set(re.findall(r'#include "([^"]+)"',
                              lib.source.read_text()))
    assert included == {h.name for h in lib.headers}


def _split_cases():
    """f32 values over most of the normal range (|x| from ~2^-100 to
    2^100), of random sign and significand, and values at a binade's top
    that round up to the next (1.99999988 * 2^e)."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=4000) * np.exp2(rng.integers(-90, 100, 4000))
         ).astype(np.float32)
    top = (np.float32(2) - np.float32(2) ** -23) * np.exp2(
        rng.integers(-100, 100, 64)).astype(np.float32)
    return torch.from_numpy(np.concatenate([x, top, -top]))


def test_split_bf16x3_sums_to_its_input_exactly():
    """hi + mid + lo == x exactly (summed in float64), hi = x rounded to
    nearest even, and each term bf16."""
    x = _split_cases()
    hi, mid, lo = ref.split_bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == BF
    assert torch.equal(hi, x.to(BF))
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())
    assert bool((mid != 0).any() & (lo != 0).any())


def test_split_bf16x3_of_a_bf16_exact_input_has_one_term():
    """Where x is bf16-exact (a bf16 cotangent cast up), mid and lo are 0
    exactly: the one-term route's condition."""
    x = _split_cases().to(BF).float()
    hi, mid, lo = ref.split_bf16x3(x)
    assert torch.equal(hi.float(), x)
    assert not bool(mid.any()) and not bool(lo.any())


@pytest.mark.parametrize("ll,m,t,c", [(1, 6, 5, 3), (2, 33, 97, 40),
                                      (3, 64, 130, 7)])
def test_dx_entry_cpu_path_matches_reference_vjp(ll, m, t, c):
    """wx with a bf16 w and an f32 cotangent (the dx entry, w read across
    its rows) on the CPU against the reference's ``_wx_acc`` VJP dx
    (``jax.vjp``, Pallas in interpret mode) on the same numpy values:
    both are the f32 product of the bf16 w and dy, 1e-5 (summation
    order)."""
    rng = np.random.default_rng(ll * 1000 + m)
    w = (rng.normal(size=(m, t)) / np.sqrt(t)).astype(np.float32)
    x = rng.normal(size=(ll, t, c)).astype(np.float32)
    a = rng.normal(size=(ll, m, c)).astype(np.float32)
    dy = rng.normal(size=(ll, m, c)).astype(np.float32)
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda w_, x_, a_: ref_fused_ring._wx_acc(
        w_, x_, a_, "float32"), wj, jnp.asarray(x), jnp.asarray(a))
    _, want, _ = vjp(jnp.asarray(dy))
    wb = torch.from_numpy(w).to(BF)
    before = WX.wx.launches
    got = WX.wx(wb, torch.from_numpy(dy), None, out_dtype=torch.float32,
                w_t=True)
    assert WX.wx.launches == before and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_dx_entry_takes_only_a_bf16_w_with_an_f32_x():
    """bf16 w with f32 x is the dx entry; f32 w with bf16 x is refused."""
    w, x = torch.randn(6, 4), torch.randn(2, 4, 3)
    WX.wx(w.to(BF), x)
    with pytest.raises(TypeError):
        WX.wx(w, x.to(BF))
