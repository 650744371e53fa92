"""The port's Mamba-2 intra-chunk SSD term and chunked scan against the JAX
package's.

The same numpy inputs (made from a seed) go through ``repro`` (the Pallas
kernel ``ops.ssd_intra`` in interpret mode, its jnp oracle
``ref.ssd_intra_ref`` and the model's ``_ssd_chunked``) and through
``repro_torch`` (on the CPU the wrapper takes the plain PyTorch version).
Tolerances: the kernel term 2e-4 in f32 (the reference's own,
``tests/test_kernels.py``); with bf16 x, one bf16 step of the output
(2^-7 relative) plus 2e-4 against the reference's kernel, since both round
y once from an f32 sum taken in another order; the f32 scan 1e-5.  The
card-side half is ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models.layers import _ssd_chunked as ref_ssd_chunked
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as SSD
from repro_torch.models.layers import _ssd_chunked

TOL = 2e-4
BF16_STEP = 2.0 ** -7          # one bf16 step, relative to the value
SCAN_TOL = 1e-5


def _inputs(g, q, n, p, seed=0, decay=0.1):
    """c, b, x, dt (after softplus), dac = cumsum(-dt * decay) as f32 numpy
    arrays, the reference test's distributions."""
    rng = np.random.default_rng(seed)
    c = (0.3 * rng.normal(size=(g, q, n))).astype(np.float32)
    b = (0.3 * rng.normal(size=(g, q, n))).astype(np.float32)
    x = rng.normal(size=(g, q, p)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(g, q)), 0.0).astype(np.float32)
    dac = (-np.cumsum(dt * decay, axis=1)).astype(np.float32)
    return c, b, x, dt, dac


def _port(c, b, x, dt, dac, dtype):
    td = getattr(torch, dtype)
    return ops.ssd_intra(*(torch.from_numpy(a).to(td) for a in (c, b, x)),
                         torch.from_numpy(dt), torch.from_numpy(dac))


def _reference(fn, c, b, x, dt, dac, dtype):
    jd = getattr(jnp, dtype)
    y = fn(*(jnp.asarray(a, jd) for a in (c, b, x)), jnp.asarray(dt),
           jnp.asarray(dac))
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("gqnp", [(6, 64, 32, 16), (3, 37, 32, 16),
                                  (2, 64, 128, 64)])
def test_ssd_intra_matches_reference_f32(gqnp):
    c, b, x, dt, dac = _inputs(*gqnp)
    y = _port(c, b, x, dt, dac, "float32").numpy()
    for fn in (rops.ssd_intra, rref.ssd_intra_ref):
        np.testing.assert_allclose(y, _reference(fn, c, b, x, dt, dac,
                                                 "float32"),
                                   rtol=TOL, atol=TOL)


def test_ssd_intra_matches_reference_bf16():
    """bf16 x (and c, b): the port rounds att to bf16 before the second
    product, as the reference's kernel does; y then differs from the
    kernel's at most by one bf16 step where the two f32 sums straddle a
    rounding boundary, and nearly every element is equal."""
    c, b, x, dt, dac = _inputs(6, 64, 32, 16)
    y = _port(c, b, x, dt, dac, "bfloat16").float().numpy()
    want = _reference(rops.ssd_intra, c, b, x, dt, dac, "bfloat16")
    np.testing.assert_allclose(y, want, rtol=BF16_STEP, atol=TOL)
    assert np.mean(y == want) > 0.99


def test_ssd_intra_overflow_above_the_diagonal_is_masked():
    """A strongly decaying dac: above the diagonal exp(dac_i - dac_j)
    overflows to inf.  The mask selects, so the output is finite and equal
    to the reference's kernel and oracle."""
    c, b, x, dt, dac = _inputs(4, 64, 32, 16, seed=3, decay=16.0)
    with np.errstate(over="ignore"):
        seg = dac[:, :, None] - dac[:, None, :]
        assert np.isinf(np.exp(seg)).any()
    y = _port(c, b, x, dt, dac, "float32").numpy()
    assert np.isfinite(y).all()
    for fn in (rops.ssd_intra, rref.ssd_intra_ref):
        np.testing.assert_allclose(y, _reference(fn, c, b, x, dt, dac,
                                                 "float32"),
                                   rtol=TOL, atol=TOL)


def test_cpu_tensor_takes_plain_version_without_launching():
    c, b, x, dt, dac = (torch.from_numpy(a) for a in _inputs(2, 16, 8, 4))
    before = SSD.ssd_intra_chunk.launches
    y = SSD.ssd_intra_chunk(c, b, x, dt, dac)
    assert SSD.ssd_intra_chunk.launches == before
    assert torch.equal(y, ref.ssd_intra_ref(c, b, x, dt, dac))


@pytest.mark.parametrize("case,exc", [
    ("q_too_long", ValueError), ("n_too_wide", ValueError),
    ("p_too_wide", ValueError), ("shape_mismatch", ValueError),
    ("mixed_dtype", TypeError), ("bf16_dt", TypeError)])
def test_wrapper_rejects_bad_inputs(case, exc):
    g, q, n, p = 2, 16, 8, 4
    if case == "q_too_long":
        q = SSD.Q_MAX + 1
    elif case == "n_too_wide":
        n = SSD.N_MAX + 1
    elif case == "p_too_wide":
        p = SSD.P_MAX + 1
    c, b, x, dt, dac = (torch.from_numpy(a) for a in _inputs(g, q, n, p))
    if case == "shape_mismatch":
        dt = dt[:, :-1]
    elif case == "mixed_dtype":
        x = x.bfloat16()
    elif case == "bf16_dt":
        dt = dt.bfloat16()
    with pytest.raises(exc):
        SSD.ssd_intra_chunk(c, b, x, dt, dac)


# ---------------------------------------------------------------------------
# the chunked scan
# ---------------------------------------------------------------------------

def _scan_inputs(bsz, s, h, p, g, n, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(bsz, s, h)), 0.0).astype(np.float32)
    a = (-np.exp(0.3 * rng.normal(size=(h,)))).astype(np.float32)
    bm = (0.3 * rng.normal(size=(bsz, s, g, n))).astype(np.float32)
    cm = (0.3 * rng.normal(size=(bsz, s, g, n))).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("s", [128, 100])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_reference(s, groups):
    """y and the final state of the f32 chunked scan (two chunks of 64; at
    s = 100 the second is zero-padded)."""
    args = _scan_inputs(2, s, 4, 8, groups, 16)
    y, state = _ssd_chunked(*(torch.from_numpy(a) for a in args), 64)
    ry, rstate = ref_ssd_chunked(*(jnp.asarray(a) for a in args), 64)
    assert y.shape == (2, s, 4, 8) and state.shape == (2, 4, 8, 16)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(rstate),
                               rtol=SCAN_TOL, atol=SCAN_TOL)


def test_kernel_term_is_the_scan_of_one_chunk():
    """One chunk carries no state in, so the scan is the kernel term alone:
    the port's kernel arrangement (G = batch x heads groups) equals the
    port's _ssd_chunked, as ``tests/test_kernels.py`` asserts of the
    reference."""
    bsz, s, h, p, n = 1, 64, 2, 8, 16
    x, dt, a, bm, cm = (torch.from_numpy(v)
                        for v in _scan_inputs(bsz, s, h, p, 1, n, seed=2))
    y_full, _ = _ssd_chunked(x, dt, a, bm, cm, 64)
    dac = torch.cumsum(dt * a[None, None, :], dim=1)

    def tog(t):
        return t.movedim(2, 1).reshape((bsz * h, s) + t.shape[3:])
    y_k = ops.ssd_intra(tog(cm.repeat_interleave(h, 2)),
                        tog(bm.repeat_interleave(h, 2)), tog(x),
                        dt.movedim(2, 1).reshape(bsz * h, s),
                        dac.movedim(2, 1).reshape(bsz * h, s))
    y_k = y_k.reshape(bsz, h, s, p).movedim(1, 2)
    np.testing.assert_allclose(y_k.numpy(), y_full.numpy(), rtol=SCAN_TOL,
                               atol=SCAN_TOL)
