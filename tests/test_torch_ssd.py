"""The port's Mamba-2 intra-chunk SSD term and chunked scan against the JAX
package's.

The same numpy inputs (made from a seed) go through ``repro`` (the Pallas
kernel ``ops.ssd_intra`` in interpret mode, its jnp oracle
``ref.ssd_intra_ref`` and the model's ``_ssd_chunked``) and through
``repro_torch`` (on the CPU the wrappers take the plain PyTorch version:
for the model's heads entry, the groups arrangement and ``ssd_intra_ref``,
held here bit for bit to that arrangement written out).  The kernel's
shared-memory plan, its route rule and its head shares are checked here
too; they decide what the card runs.
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


# ---------------------------------------------------------------------------
# the heads entry (the model's layout): plain version, checks, plan, route
# ---------------------------------------------------------------------------

def _heads_inputs(bsz, s, h, p, g, n, chunk=64, seed=4, valid=None):
    """x [b, s, h, p], dt, dac (the within-chunk cumsum of dt * A) [b, s,
    h], B, C [b, s, g, n] as f32 tensors; s a whole number of chunks.
    Positions from ``valid`` on are zero-padding, as ``_pad_seq`` makes it
    (dt = 0 there, so dac stays at the chunk's last value)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(bsz, s, h)), 0.0).astype(np.float32)
    bm = (0.3 * rng.normal(size=(bsz, s, g, n))).astype(np.float32)
    cm = (0.3 * rng.normal(size=(bsz, s, g, n))).astype(np.float32)
    for t in (x, dt, bm, cm):
        t[:, valid:] = 0
    a = -np.linspace(1.0, 16.0, h).astype(np.float32)
    dac = np.cumsum((dt * a).reshape(bsz, s // chunk, chunk, h),
                    axis=2).reshape(bsz, s, h).astype(np.float32)
    return tuple(torch.from_numpy(v) for v in (x, dt, dac, bm, cm))


def _groups_arrangement(x, dt, dac, bm, cm, chunk):
    """What ``_ssd_chunked`` did before the heads entry: B and C repeated
    over the heads, each operand copied into (batch, chunk, head) groups,
    the [G, Q, N] term, y laid back."""
    bsz, s, h, p = x.shape
    rep, nc = h // bm.shape[2], s // chunk

    def groups(t):
        t = t.reshape((bsz, nc, chunk) + t.shape[2:]).movedim(3, 2)
        return t.reshape((bsz * nc * h, chunk) + t.shape[4:]).contiguous()
    y = ref.ssd_intra_ref(groups(cm.repeat_interleave(rep, dim=2)),
                          groups(bm.repeat_interleave(rep, dim=2)),
                          groups(x), groups(dt), groups(dac))
    return y.reshape(bsz, nc, h, chunk, p).movedim(2, 3).reshape(bsz, s, h, p)


@pytest.mark.parametrize("s", [128, 100])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_heads_entry_plain_is_the_groups_arrangement(s, groups):
    """On the CPU the heads entry is the groups arrangement plus
    ``ref.ssd_intra_ref`` bit for bit, so the model's CPU results do not
    move; at s = 100 the sequence is zero-padded to two chunks first, as
    ``_ssd_chunked`` pads it."""
    sp = -(-s // 64) * 64
    x, dt, dac, bm, cm = _heads_inputs(2, sp, 4, 8, groups, 16, valid=s)
    before = SSD.ssd_intra_chunk.launches
    y = ops.ssd_intra_heads(x, dt, dac, bm, cm, 64)
    assert SSD.ssd_intra_chunk.launches == before
    assert y.shape == (2, sp, 4, 8)
    assert torch.equal(y, _groups_arrangement(x, dt, dac, bm, cm, 64))


def test_heads_entry_matches_reference_kernel():
    """The heads entry against the reference's Pallas kernel (interpret
    mode) on the reference's own arrangement of the same operands, at the
    kernel tolerance, with two head groups and a chunk of 32."""
    x, dt, dac, bm, cm = _heads_inputs(1, 64, 4, 16, 2, 32, chunk=32)
    y = SSD.ssd_intra_heads(x, dt, dac, bm, cm, 32).numpy()

    def groups(t):
        t = t.reshape((1, 2, 32) + t.shape[2:]).movedim(3, 2)
        return jnp.asarray(t.reshape((8, 32) + t.shape[4:]).numpy())
    want = rops.ssd_intra(groups(cm.repeat_interleave(2, dim=2)),
                          groups(bm.repeat_interleave(2, dim=2)), groups(x),
                          groups(dt), groups(dac))
    want = np.asarray(want).reshape(1, 2, 4, 32, 16).transpose(
        0, 1, 3, 2, 4).reshape(1, 64, 4, 16)
    np.testing.assert_allclose(y, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case,exc", [
    ("x_inner_stride", ValueError), ("b_inner_stride", ValueError),
    ("heads_not_groups", ValueError), ("dt_heads", ValueError),
    ("ragged_sequence", ValueError), ("chunk_too_long", ValueError),
    ("x_float64", TypeError), ("mixed_dtype", TypeError),
    ("bf16_dac", TypeError)])
def test_heads_wrapper_rejects_bad_inputs(case, exc):
    """A non-unit inner stride, a head count that does not split into the
    groups, a mismatched dt, a sequence that is not whole chunks, a chunk
    over 64 and a wrong dtype raise on either device, before a launch."""
    x, dt, dac, bm, cm = _heads_inputs(2, 128, 4, 8, 2, 16)
    chunk = 64
    if case == "x_inner_stride":
        x = torch.cat([x, x], dim=-1)[..., ::2]
    elif case == "b_inner_stride":
        bm = torch.cat([bm, bm], dim=-1)[..., ::2]
    elif case == "heads_not_groups":
        bm, cm = (torch.cat([t, t[:, :, :1]], dim=2) for t in (bm, cm))
    elif case == "dt_heads":
        dt = dt[:, :, :3]
    elif case == "ragged_sequence":
        chunk = 48
    elif case == "chunk_too_long":
        chunk = 128
    elif case == "x_float64":
        x = x.double()
    elif case == "mixed_dtype":
        bm = bm.bfloat16()
    elif case == "bf16_dac":
        dac = dac.bfloat16()
    before = SSD.ssd_intra_chunk.launches
    with pytest.raises(exc):
        SSD.ssd_intra_heads(x, dt, dac, bm, cm, chunk)
    assert SSD.ssd_intra_chunk.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("np_", [(128, 64), (128, 128), (5, 3), (32, 16),
                                 (96, 72), (1, 1)])
@pytest.mark.parametrize("heads", [1, 24])
def test_plan_fits_a_block(dtype, np_, heads):
    """Every width the wrapper takes fits one block's 232,448 bytes with at
    least two x stages; a C/B row takes whole 128-byte boxes (TMA's
    128-byte swizzle) and an x row a 16-byte pitch."""
    n, p = np_
    pl = SSD.plan(n, p, dtype, heads)
    es = 4 if dtype == torch.float32 else 2
    assert pl.smem_bytes <= SSD.SMEM_LIMIT
    assert 2 <= pl.x_stages <= SSD.MAX_X_STAGES
    assert 1 <= pl.cb_stages <= SSD.MAX_CB_STAGES
    assert (pl.boxes - 1) * 128 < n * es <= pl.boxes * 128
    assert pl.x_pitch % 16 == 0 and p * es <= pl.x_pitch < p * es + 16


def test_plan_at_mamba2_widths():
    """mamba2-130m (f32, N = 128, P = 64): the [G, Q, N] entry's one-head
    items take two C/B stages and two x stages (216,192 bytes); the model's
    24-head items go two heads at a time, with one C/B stage and four x
    stages (217,216)."""
    assert SSD.plan(128, 64, torch.float32, 1) == SSD.Plan(
        2, 2, 4, 256, False, 216192)
    assert SSD.plan(128, 64, torch.float32, 24) == SSD.Plan(
        1, 4, 4, 256, True, 217216)


def test_route_rule():
    """TMA where x, B and C have 16-byte aligned bases, rows and
    strides (the model's tensors, contiguous or column slices of its conv
    output); element loads for odd widths, a bf16 row of 8 bytes or a base
    off by one element."""
    x, _, _, bm, cm = _heads_inputs(2, 128, 4, 8, 1, 16)
    assert SSD.route(x, bm, cm) == "tma"
    wide = torch.zeros(2, 128, 4 * 8 + 2 * 16)
    xs = wide[..., :32].unflatten(-1, (4, 8))
    bs, cs = (wide[..., k:k + 16].unflatten(-1, (1, 16)) for k in (32, 48))
    assert SSD.route(xs, bs, cs) == "tma"
    assert SSD.route(torch.zeros(6, 37, 5), torch.zeros(6, 37, 3)) == "scalar"
    assert SSD.route(torch.zeros(3, 64, 4, dtype=torch.bfloat16)) == "scalar"
    assert SSD.route(torch.zeros(3, 64, 8, dtype=torch.bfloat16)) == "tma"
    assert SSD.route(torch.zeros(2 * 64 * 16 + 1)[1:].view(2, 64, 16)) == \
        "scalar"


@pytest.mark.parametrize("items,rep,shares", [(128, 24, 1), (32, 24, 4),
                                              (1, 1, 1), (10, 24, 13),
                                              (3072, 1, 1), (1, 24, 24)])
def test_head_shares(items, rep, shares):
    """The heads of a group are split only where the (batch, chunk, group)
    items leave SMs idle, never into more shares than heads; mamba2-130m at
    sequence 4096, batch 2 (128 items) keeps s once per item."""
    assert SSD.head_shares(items, rep, 132) == shares
