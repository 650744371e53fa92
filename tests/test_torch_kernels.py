"""The port's block_matmul module against the JAX package's.

The same numpy inputs (made from a seed) go through ``repro.kernels`` (the
Pallas kernel in interpret mode, and its jnp oracle) and through
``repro_torch.kernels`` (on the CPU: the plain PyTorch version the wrapper
takes for CPU tensors).  Tolerances are those of ``tests/test_kernels.py``:
fp32 2e-5, bf16 3e-2.  The gradients of ``ops.matmul`` / ``mixer_mlp`` (an
``autograd.Function``) are held against ``jax.grad`` of the reference's
custom VJP: ``mixer_mlp``'s at f32 2e-5; ``matmul``'s, the port's and the
reference's both, against a float64 oracle within each element's f32 error
bound (``_grads_oracle``).  The card-side half (the CUDA kernel against its
plain version) is ``tests/test_torch_cuda.py``; ``chip_smoke.py`` runs it at
the model's full shapes.
"""
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import block_matmul as BM
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _np_inputs(m, k, n, seed=0, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(n, k)) / np.sqrt(k)).astype(np.float32)
    b = (0.1 * rng.normal(size=(n,))).astype(np.float32) if bias else None
    return x, w, b


def _both(a, dtype):
    """The same values for both packages (f32 -> bf16 rounds to nearest
    even in both)."""
    if a is None:
        return None, None
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", ["none", "gelu", "silu"])
@pytest.mark.parametrize("bias", [True, False])
def test_block_matmul_ref_matches_reference(dtype, epilogue, bias):
    x, w, b = _np_inputs(48, 96, 40, seed=1, bias=bias)
    (jx, tx), (jw, tw), (jb, tb) = (_both(a, dtype) for a in (x, w, b))
    want = rref.block_matmul_ref(jx, jw, jb, epilogue)
    got = ref.block_matmul_ref(tx, tw, tb, epilogue)
    assert got.dtype == getattr(torch, dtype) and got.shape == (48, 40)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", ["none", "gelu"])
def test_matmul_matches_pallas_interpret(dtype, epilogue):
    """Ragged shapes: the reference pads to its block grid, the port's
    kernel masks; both agree with each other."""
    x, w, b = _np_inputs(300, 700, 130, seed=3)
    (jx, tx), (jw, tw), (jb, tb) = (_both(a, dtype) for a in (x, w, b))
    want = rops.matmul(jx, jw, jb, epilogue=epilogue, block_m=128,
                       block_n=128, block_k=256)
    got = ops.matmul(tx, tw, tb, epilogue=epilogue)
    assert got.shape == (300, 130)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_matmul_casts_weight_to_activation_dtype():
    """bf16 weights under f32 activations run an f32 GEMM (the legacy
    full-width path), as the reference's ``_matmul_raw`` does."""
    x, w, b = _np_inputs(32, 64, 48, seed=4)
    jw, tw = _both(w, "bfloat16")
    jb, tb = _both(b, "bfloat16")
    want = rops.matmul(jnp.asarray(x), jw, jb, epilogue="gelu")
    got = ops.matmul(torch.from_numpy(x), tw, tb, epilogue="gelu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_nd_and_mixer_mlp_match_reference(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32)
    w1 = (0.1 * rng.normal(size=(96, 64))).astype(np.float32)
    b1 = (0.1 * rng.normal(size=(96,))).astype(np.float32)
    w2 = (0.1 * rng.normal(size=(40, 96))).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(40,))).astype(np.float32)
    j, t = zip(*(_both(a, dtype) for a in (x, w1, b1, w2, b2)))
    want = rops.mixer_mlp(*j)
    got = ops.mixer_mlp(*t)
    assert got.shape == (2, 24, 40)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    np.testing.assert_allclose(_f32(ref.mixer_mlp_ref(*t)), _f32(want),
                               rtol=TOL[dtype], atol=TOL[dtype])
    got_nd = ops.matmul_nd(t[0], t[1], t[2], epilogue="gelu")
    want_nd = rops.matmul_nd(j[0], j[1], j[2], epilogue="gelu")
    assert got_nd.shape == (2, 24, 96)
    np.testing.assert_allclose(_f32(got_nd), _f32(want_nd), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_cpu_tensor_takes_plain_version_without_launching():
    x, w, b = _np_inputs(16, 32, 8)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    before = BM.block_matmul.launches
    y = BM.block_matmul(tx, tw, tb, "silu")
    assert BM.block_matmul.launches == before
    assert torch.equal(y, ref.block_matmul_ref(tx, tw, tb, "silu"))


@pytest.mark.parametrize("case,exc", [
    ("dtype_mismatch", TypeError), ("float16", TypeError),
    ("k_mismatch", ValueError), ("bias_shape", ValueError),
    ("epilogue", ValueError), ("rank", ValueError),
])
def test_wrapper_rejects_bad_inputs(case, exc):
    x = torch.zeros(4, 8)
    w = torch.zeros(6, 8)
    b = torch.zeros(6)
    epi = "none"
    if case == "dtype_mismatch":
        w = w.to(torch.bfloat16)
    elif case == "float16":
        x, w = x.half(), w.half()
    elif case == "k_mismatch":
        w = torch.zeros(6, 7)
    elif case == "bias_shape":
        b = torch.zeros(5)
    elif case == "epilogue":
        epi = "relu"
    elif case == "rank":
        x = torch.zeros(2, 4, 8)
    with pytest.raises(exc):
        BM.block_matmul(x, w, b, epi)


@pytest.mark.parametrize("k,want", [(4416, 16), (4320, 16), (8640, 16),
                                    (16380, 8), (130, 4), (97, 2)])
def test_vec_bytes_follows_row_stride(k, want):
    """tok_fc1's bf16 rows (K = 16380) are 32,760 bytes: 8-byte copies."""
    x = torch.zeros(3, k, dtype=torch.bfloat16)
    w = torch.zeros(5, k, dtype=torch.bfloat16)
    assert BM.vec_bytes(x, w) == want
    # a view that starts one element in is only 2-byte aligned
    assert BM.vec_bytes(torch.zeros(3 * k + 1, dtype=torch.bfloat16)[1:]
                        .view(3, k), w) == 2


_IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|jaxlib|ml_dtypes|repro)"
                     r"(?:[.\s,]|$)"
                     r"|import_module\(\s*['\"](?:jax|ml_dtypes|repro)"
                     r"[.'\"]", re.MULTILINE)


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {f.relative_to(ROOT).as_posix().removeprefix("src/repro_torch/")
             for f in files}
    assert {"core/comm.py", "core/jigsaw.py", "core/sharding.py",
            "kernels/build.py", "kernels/fused_ring.py", "kernels/ring.py",
            "kernels/wx.py", "launch/mesh.py", "checkpoint/manifest.py",
            "checkpoint/sharded.py", "checkpoint/writer.py",
            "kernels/graphs.py", "launch/analysis.py",
            "launch/trace_report.py", "telemetry/accounting.py",
            "serve/engine.py", "serve/step.py"} <= names
    bad = {str(f.relative_to(ROOT)): m.group(0).strip()
           for f in files for m in [_IMPORT.search(f.read_text())] if m}
    assert not bad, bad


# ---------------------------------------------------------------------------
# operand layouts and the backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("x_t,w_t", [(False, True), (True, False),
                                     (True, True)])
def test_layout_variants_match_transposed_product(dtype, x_t, w_t):
    """A = x.T when x_t, B = w.T when w_t: the same function as the
    K-contiguous variant on the materialised transposes."""
    x, w, b = _np_inputs(37, 53, 29, seed=6)
    tx, tw, tb = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (x, w, b))
    xs = tx.t().contiguous() if x_t else tx
    ws = tw.t().contiguous() if w_t else tw
    assert BM.gemm_dims(xs, ws, x_t, w_t) == (37, 29, 53)
    got = BM.block_matmul(xs, ws, tb, "gelu", x_t=x_t, w_t=w_t)
    assert torch.equal(got, ref.block_matmul_ref(tx, tw, tb, "gelu"))


def test_layout_k_mismatch_raises():
    with pytest.raises(ValueError, match="K of x"):
        BM.block_matmul(torch.zeros(4, 8), torch.zeros(6, 8), w_t=True)


def test_vec_bytes_reads_the_stored_row_stride():
    """The copy width follows each operand's contiguous dimension as
    stored: tok_fc2's dz [4320, 16380] read as A = dz.T has 32,760-byte
    rows (8-byte copies); the encoder's x [16380, 4416] read as B = x.T has
    8,832-byte rows (16-byte copies)."""
    dz = torch.zeros(6, 16380, dtype=torch.bfloat16)
    x = torch.zeros(6, 4416, dtype=torch.bfloat16)
    assert BM.vec_bytes(dz, x) == 8
    assert BM.vec_bytes(x, x) == 16


def _grads_ref(x, w, b, dy, epilogue):
    """jax.grad of <matmul(x, w, b), dy> through the reference's custom
    VJP (Pallas in interpret mode)."""
    def f(x, w, b):
        y = rops.matmul(x, w, b, epilogue=epilogue, block_m=128,
                        block_n=128, block_k=128)
        return jnp.sum(y * dy)
    args = (jnp.asarray(x), jnp.asarray(w),
            None if b is None else jnp.asarray(b))
    argnums = (0, 1) if b is None else (0, 1, 2)
    return [np.asarray(g) for g in jax.grad(f, argnums)(*args)]


def _grads_port(x, w, b, dy, epilogue):
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    leaves = [tx, tw]
    tb = None
    if b is not None:
        tb = torch.from_numpy(b).requires_grad_()
        leaves.append(tb)
    y = ops.matmul(tx, tw, tb, epilogue=epilogue)
    return [g.numpy() for g in
            torch.autograd.grad(y, leaves, torch.from_numpy(dy))]


# float32 machine epsilon, 2^-23: twice the unit roundoff, so K * EPS32 is
# twice the worst-case error bound of a K-term f32 sum in any order
EPS32 = 2.0 ** -23
# the f32 evaluation of GELU' and its product with dy: a few roundings of
# terms no larger than 1 + |z| (tanh's cancellation in 1 - t^2 included)
ACT_ROUNDINGS = 8


def _gelu_grads64(z):
    """GELU' and GELU'' (tanh form) in float64."""
    beta, kappa = np.sqrt(2.0 / np.pi), 0.044715
    u = beta * (z + kappa * z ** 3)
    du = beta * (1.0 + 3.0 * kappa * z ** 2)
    t = np.tanh(u)
    sech2 = 1.0 - t * t
    g1 = 0.5 * (1.0 + t) + 0.5 * z * sech2 * du
    g2 = sech2 * du + 0.5 * z * (-2.0 * t * sech2 * du * du
                                 + sech2 * 6.0 * beta * kappa * z)
    return g1, g2


def _grads_oracle(x, w, b, dy, epilogue):
    """The gradients of <epilogue(x @ w.T + b), dy> in float64, and each
    element's bound on an f32 computation's error.

    A GEMM C = A @ B summed in f32 over K terms, in any order, is within
    K * EPS32 * (|A| @ |B|) of the exact sum of its f32 operands (c = 1 at
    EPS32 = 2^-23; the rounding of the output adds one more EPS32, so K + 1
    is used).  dx = dz @ w sums over n, dw = dz.T @ x and db over m.  For
    the GELU epilogue dz itself is f32: z's sum over k (plus the bias) is
    off by up to (k + 1) * EPS32 * (|x| @ |w|.T + |b|), which GELU'' carries
    into dz, and GELU' and its product with dy add ACT_ROUNDINGS roundings
    of terms up to 1 + |z|; that error e_dz rides through the backward
    GEMMs as |e_dz| @ |B|.  The worst elements are small results of large
    cancelling sums, which an rtol / atol pair cannot bound."""
    x64, w64, dy64 = (a.astype(np.float64) for a in (x, w, dy))
    m, k = x.shape
    n = w.shape[0]
    if epilogue == "none":
        dz, e_dz = dy64, np.zeros_like(dy64)
    else:
        b64 = np.zeros(n) if b is None else b.astype(np.float64)
        z = x64 @ w64.T + b64
        zmag = np.abs(x64) @ np.abs(w64).T + np.abs(b64)
        g1, g2 = _gelu_grads64(z)
        dz = g1 * dy64
        e_dz = EPS32 * ((k + 1) * zmag * np.abs(g2)
                        + ACT_ROUNDINGS * (1.0 + np.abs(z))) * np.abs(dy64)
    adz = np.abs(dz) + e_dz
    grads = [dz @ w64, dz.T @ x64]
    bounds = [e_dz @ np.abs(w64) + (n + 1) * EPS32 * (adz @ np.abs(w64)),
              e_dz.T @ np.abs(x64) + (m + 1) * EPS32 * (adz.T @ np.abs(x64))]
    if b is not None:
        grads.append(dz.sum(axis=0))
        bounds.append(e_dz.sum(axis=0) + (m + 1) * EPS32 * adz.sum(axis=0))
    return grads, bounds


@pytest.mark.parametrize("epilogue", ["none", "gelu"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("mkn", [(300, 140, 130), (33, 200, 17)])
def test_matmul_grads_match_reference_custom_vjp(epilogue, bias, mkn):
    """The port's gradients and the reference's custom VJP, each held to
    the float64 oracle within each element's f32 error bound
    (``_grads_oracle``).  A fixed rtol / atol between the two failed at
    random: dw = dz.T @ x sums 300 rows whose reduction order differs with
    the BLAS and its threads."""
    m, k, n = mkn
    x, w, b = _np_inputs(m, k, n, seed=7, bias=bias)
    dy = np.random.default_rng(8).normal(size=(m, n)).astype(np.float32)
    want = _grads_ref(x, w, b, dy, epilogue)
    got = _grads_port(x, w, b, dy, epilogue)
    oracle, bounds = _grads_oracle(x, w, b, dy, epilogue)
    assert len(got) == len(want) == len(oracle) == (3 if bias else 2)
    for g, r, o, bound in zip(got, want, oracle, bounds):
        assert g.shape == r.shape == o.shape and g.dtype == np.float32
        assert np.all(np.abs(g - o) <= bound), np.max(np.abs(g - o) / bound)
        assert np.all(np.abs(r - o) <= bound), np.max(np.abs(r - o) / bound)


def test_mixer_mlp_grads_match_reference():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 24, 40)).astype(np.float32)
    w1 = (0.2 * rng.normal(size=(56, 40))).astype(np.float32)
    b1 = (0.1 * rng.normal(size=(56,))).astype(np.float32)
    w2 = (0.2 * rng.normal(size=(24, 56))).astype(np.float32)
    b2 = (0.1 * rng.normal(size=(24,))).astype(np.float32)
    dy = rng.normal(size=(2, 24, 24)).astype(np.float32)
    args = (x, w1, b1, w2, b2)
    want = jax.grad(lambda *a: jnp.sum(rops.mixer_mlp(*a) * dy),
                    argnums=tuple(range(5)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = torch.autograd.grad(ops.mixer_mlp(*leaves), leaves,
                              torch.from_numpy(dy))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-5)


def test_legacy_mixed_dtype_grads_follow_operand_dtypes():
    """f32 activations, bf16 weight and bias (the legacy policy): the GEMMs
    run in f32 and dw / db come back in bf16, as the reference's."""
    x, w, b = _np_inputs(40, 64, 24, seed=10)
    dy = np.random.default_rng(11).normal(size=(40, 24)).astype(np.float32)
    jw, tw = _both(w, "bfloat16")
    jb, tb = _both(b, "bfloat16")

    def f(x, w, b):
        return jnp.sum(rops.matmul(x, w, b, epilogue="gelu") * dy)
    want = jax.grad(f, (0, 1, 2))(jnp.asarray(x), jw, jb)
    tx = torch.from_numpy(x).requires_grad_()
    tw.requires_grad_()
    tb.requires_grad_()
    got = torch.autograd.grad(ops.matmul(tx, tw, tb, epilogue="gelu"),
                              [tx, tw, tb], torch.from_numpy(dy))
    assert [g.dtype for g in got] == [torch.float32, torch.bfloat16,
                                      torch.bfloat16]
    for g, r, tol in zip(got, want, (2e-5, 3e-2, 3e-2)):
        np.testing.assert_allclose(_f32(g), _f32(r), rtol=tol, atol=tol)


def test_backward_equals_plain_backward():
    x, w, b = _np_inputs(30, 50, 20, seed=12)
    dy = torch.from_numpy(
        np.random.default_rng(13).normal(size=(30, 20)).astype(np.float32))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    got = torch.autograd.grad(ops.matmul(tx, tw, tb, epilogue="gelu"),
                              [tx, tw, tb], dy)
    want = ref.matmul_bwd_ref(tx.detach(), tw.detach(), tb.detach(), "gelu",
                              dy)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


class _Recorder:
    """Stands in for the wrapper inside ``ops``: records each call's
    operands (storage pointers) and layout flags, then computes."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(ops, "block_matmul", self)

    def __call__(self, x, w, b=None, epilogue="none", *, x_t=False,
                 w_t=False):
        self.calls.append((x.data_ptr(), w.data_ptr(), epilogue, x_t, w_t))
        return BM.block_matmul(x, w, b, epilogue, x_t=x_t, w_t=w_t)


def test_backward_reads_saved_operands_in_place(monkeypatch):
    """The backward GEMMs take x and w themselves (no transposed copy): dx
    reads w as w.T, dw reads dz as dz.T and x as x.T; the GELU epilogue
    recomputes its pre-activation with one more launch."""
    rec = _Recorder(monkeypatch)
    x, w, b = _np_inputs(24, 40, 16, seed=14)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y = ops.matmul(tx, tw, tb, epilogue="gelu")
    y.backward(torch.ones_like(y))
    px, pw = tx.data_ptr(), tw.data_ptr()
    assert [c[2:] for c in rec.calls] == [
        ("gelu", False, False),       # forward
        ("none", False, False),       # pre-activation recompute
        ("none", False, True),        # dx = dz @ w
        ("none", True, True)]         # dw = dz.T @ x
    assert rec.calls[1][:2] == (px, pw)
    assert rec.calls[2][1] == pw
    assert rec.calls[3][1] == px


def test_backward_skips_dx_of_data_input(monkeypatch):
    """The encoder's input needs no gradient: no dx launch."""
    rec = _Recorder(monkeypatch)
    x, w, b = _np_inputs(24, 40, 16, seed=15)
    tw, tb = (torch.from_numpy(a).requires_grad_() for a in (w, b))
    y = ops.matmul(torch.from_numpy(x), tw, tb)
    y.sum().backward()
    assert [c[2:] for c in rec.calls] == [("none", False, False),
                                          ("none", True, True)]
    assert tw.grad is not None and tb.grad is not None
