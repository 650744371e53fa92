"""Training the port's ssm and hybrid families (``mamba2-130m``,
``jamba-1.5-large-398b``) against the JAX package's, and the SSD term's
backward (``ops.ssd_intra_heads``: on the CPU ``ref.ssd_intra_heads_bwd_ref``,
on the card ``csrc/ssd_chunk_bwd.cu``, held in ``tests/test_torch_cuda.py``).

The reference's gradient of this term is NaN at the models' own decays:
``repro/models/layers.py::_ssd_chunked`` masks after the exponential
(``L = jnp.where(li, jnp.exp(seg), 0.0)``), and above the diagonal
``seg`` passes ~88 once ``A`` reaches -16 over a chunk of 64, so ``exp``
gives inf and the VJP forms 0 * inf.  Its forward drops those entries, so
it is right.  The reference is not edited: the tests here build a copy of
``_ssd_chunked`` from its own source with that one line replaced by
``L = jnp.exp(jnp.where(li, seg, -jnp.inf))`` (``SAFE_SSD``), assert that
the copy's forward is the original's bit for bit, and set it into
``repro.models.layers`` for the test's duration (``safe_reference``).  The
port, whose mask comes before the exponential, is held to that copy, and
to the original wherever the original's gradient is finite.

Both packages start from the same weights of the reduced configs (d_model
256, 2 layers, vocab 1024; 8 SSM heads of 64, state 32, chunk 64; jamba's
period of an SSM slot with a dense FFN and an attention slot with 4
experts top-2), drawn by the port's init from seed 0 and carried to the
reference's layout through ``repro_torch.convert``, and both draw the
same ``TokenDataset`` rows.  All f32 on the CPU.

Tolerances:
  * the SSD gradients (x, dt, A, B, C of ``_ssd_chunked``) 2e-4
    max-normalised (max|a - b| / max|b|): measured at most 6.2e-5 (dt and
    A at the models' decays, sums over every position of terms that
    cancel), 1e-5 elsewhere;
  * ``gradcheck`` of the autograd Function in float64: its defaults;
  * one train step: loss, nll, aux and grad norm 1e-4 relative, as the
    other families' (``tests/test_torch_lm_train.py``); every gradient
    leaf 2e-4 max-normalised (the SSD term's bound; measured below 2e-5);
    every updated leaf 1e-6 absolute;
  * remat on against off: bit for bit; the five-step histories 1e-4
    relative; a (data 2, model 1) gloo run bit for bit the one-device run
    with ``accum=2`` on one thread, ZeRO-1 bit for bit the run without.
"""
import functools
import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.models.layers as RL
from repro.configs.registry import get_config as ref_get_config
from repro.data import pipeline as ref_pipeline
from repro.launch import shapes as RSH
from repro.launch.engine import EngineConfig as REngineConfig
from repro.launch.engine import TrainEngine as RTrainEngine
from repro.optim import adam as ref_adam
from repro.train import step as ref_step
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import tree as ptree
from repro_torch.data.pipeline import make_source
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_chunk as SSD
from repro_torch.kernels import ssd_chunk_bwd as SSDB
from repro_torch.launch import train as train_cli
from repro_torch.launch.engine import EngineConfig, TrainEngine
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import layers as L
from repro_torch.models import registry as M
from repro_torch.optim import adam
from repro_torch.train import step

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["mamba2-130m", "jamba-1.5-large-398b"]
HIST_KEYS = ("loss", "grad_norm", "lr")
SEQ = 32
STEPS = 5
GRAD_TOL = 2e-4
METRIC_TOL = 1e-4
LEAF_TOL = 1e-6

UNSAFE = "L = jnp.where(li[None, None, :, :, None], jnp.exp(seg), 0.0)"
SAFE = "L = jnp.exp(jnp.where(li[None, None, :, :, None], seg, -jnp.inf))"


def _safe_ssd_chunked():
    """The reference's ``_ssd_chunked`` with its one masking line put
    before the exponential, compiled from its own source in a copy of its
    module's namespace (the module itself is untouched)."""
    src = textwrap.dedent(inspect.getsource(RL._ssd_chunked))
    assert src.count(UNSAFE) == 1, "the reference's mask line changed"
    ns = dict(vars(RL))
    exec(compile(src.replace(UNSAFE, SAFE), "<safe _ssd_chunked>", "exec"),
         ns)
    return ns["_ssd_chunked"]


ORIG_SSD = RL._ssd_chunked
SAFE_SSD = _safe_ssd_chunked()


def _ssd_inputs(b, s, h, p, g, n, a_max, seed=0, a_min=1.0):
    """x, dt (softplus of N(0, 1)), A = -linspace(a_min, a_max, h) (the
    models' init: 1 to 16), B, C (0.3 N(0, 1)) and the cotangents of y
    and the final state, f32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.normal(size=(b, s, h)), 0.0).astype(np.float32)
    a = (-np.linspace(a_min, a_max, h)).astype(np.float32)
    bm = (0.3 * rng.normal(size=(b, s, g, n))).astype(np.float32)
    cm = (0.3 * rng.normal(size=(b, s, g, n))).astype(np.float32)
    dy = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dh = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return (x, dt, a, bm, cm), (dy, dh)


def _ref_vjp(fn, ins, cts, chunk):
    """(y, final state) and the VJP of ``fn`` (a reference
    ``_ssd_chunked``) at ``ins`` for the cotangents ``cts``, jitted (one
    compile takes a tenth of the eager op-by-op time)."""
    def both(ins, cts):
        out, vjp = jax.vjp(lambda *a: fn(*a, chunk), *ins)
        return out, vjp(cts)
    out, grads = jax.jit(both)(tuple(map(jnp.asarray, ins)),
                               tuple(map(jnp.asarray, cts)))
    return [np.asarray(o) for o in out], [np.asarray(g) for g in grads]


def _forwards_equal(shape, chunk, seed=0):
    """The copy's (y, final state) the original's bit for bit, at A to
    -16 (where the original's gradient is NaN)."""
    ins, cts = _ssd_inputs(*shape, 16.0, seed=seed)
    for a, b in zip(_ref_vjp(ORIG_SSD, ins, cts, chunk)[0],
                    _ref_vjp(SAFE_SSD, ins, cts, chunk)[0]):
        np.testing.assert_array_equal(a, b)


def _port_vjp(ins, cts, chunk):
    t = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, h_last = L._ssd_chunked(*t, chunk)
    grads = torch.autograd.grad((y, h_last), t,
                                tuple(map(torch.from_numpy, cts)))
    return [g.numpy() for g in grads]


def _max_norm_err(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_safe_copy_forward_is_the_reference_bit_for_bit():
    """At the models' decays (A to -16, chunk 64, where the original's
    gradient is NaN) and at a ragged sequence of two groups: the copy's
    y and final state equal the original's bit for bit."""
    _forwards_equal((1, 128, 4, 16, 1, 8), 64)
    _forwards_equal((2, 100, 4, 8, 2, 16), 32)


@pytest.fixture
def safe_reference(monkeypatch):
    """The reference's ``_ssd_chunked`` replaced by ``SAFE_SSD`` in
    ``repro.models.layers`` (which ``mamba2_apply`` reads it from) for the
    test; first its forward checked bit for bit against the original's at
    mamba2-130m's decays."""
    _forwards_equal((1, 64, 4, 8, 1, 8), 64, seed=3)
    monkeypatch.setattr(RL, "_ssd_chunked", SAFE_SSD)


# ---------------------------------------------------------------------------
# the SSD term's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,chunk", [
    ((2, 128, 4, 16, 1, 8), 64),       # one group, two chunks
    ((2, 96, 4, 8, 2, 16), 64),        # two groups, a ragged last chunk
    ((1, 100, 4, 16, 2, 8), 32),       # ragged, chunk 32
    ((2, 64, 8, 64, 1, 32), 32)])      # the reduced configs' widths
def test_ssd_gradient_matches_reference_where_finite(shape, chunk):
    """``_ssd_chunked``'s gradient in x, dt, A, B and C (through the
    autograd Function's plain backward, the padding, the cumsum and the
    plain inter-chunk loop) against ``jax.vjp`` of the reference's own
    ``_ssd_chunked`` (not the copy), at decays slow enough (A from -0.25
    to -1) that its gradient is finite, which is asserted first."""
    ins, cts = _ssd_inputs(*shape, 1.0, a_min=0.25)
    _, want = _ref_vjp(ORIG_SSD, ins, cts, chunk)
    assert all(np.isfinite(g).all() for g in want)
    got = _port_vjp(ins, cts, chunk)
    for name, a, b in zip(("x", "dt", "A", "B", "C"), got, want):
        assert np.isfinite(a).all(), name
        assert _max_norm_err(a, b) <= GRAD_TOL, name


@pytest.mark.parametrize("shape", [(1, 128, 4, 16, 1, 8),
                                   (2, 128, 8, 64, 2, 32)])
def test_ssd_gradient_at_the_models_decays(shape):
    """mamba2-130m's A range (-1 to -16) and chunk 64: the reference's
    ``jax.vjp`` is NaN in dt and A (its recorded fault: the mask after the
    exponential), the port's gradient is finite and matches ``jax.vjp`` of
    the one-line copy; both forwards agree."""
    ins, cts = _ssd_inputs(*shape, 16.0)
    out, orig = _ref_vjp(ORIG_SSD, ins, cts, 64)
    assert np.isnan(orig[1]).any() and np.isnan(orig[2]).any()
    assert all(np.isfinite(o).all() for o in out)
    _, want = _ref_vjp(SAFE_SSD, ins, cts, 64)
    assert all(np.isfinite(g).all() for g in want)
    got = _port_vjp(ins, cts, 64)
    for name, a, b in zip(("x", "dt", "A", "B", "C"), got, want):
        assert np.isfinite(a).all(), name
        assert _max_norm_err(a, b) <= GRAD_TOL, name


def test_plain_mask_is_nan_safe_and_its_forward_unchanged():
    """``ref.ssd_intra_ref`` masks the exponent before exp: at a decay that
    overflows above the diagonal its forward is the select-after-exp
    forward bit for bit (+0 above the diagonal), and autograd through it
    is finite where the select after the exponential alone gives NaN."""
    rng = np.random.default_rng(0)
    g, q, n, p = 3, 64, 8, 4
    c, b = (torch.from_numpy(0.3 * rng.normal(size=(g, q, n)).astype(
        np.float32)).requires_grad_(True) for _ in range(2))
    x = torch.from_numpy(rng.normal(size=(g, q, p)).astype(np.float32))
    dt = torch.from_numpy(np.logaddexp(rng.normal(size=(g, q)), 0.0).astype(
        np.float32))
    dac = torch.cumsum(-16.0 * dt, dim=1).requires_grad_(True)
    tri = torch.ones((q, q), dtype=torch.bool).tril()
    seg = dac[:, :, None] - dac[:, None, :]
    assert torch.isinf(torch.exp(seg)).any()
    s = torch.einsum("gin,gjn->gij", c, b)
    old_att = torch.where(tri, s * torch.exp(seg), 0.0) * dt[:, None, :]
    old = torch.einsum("gij,gjp->gip", old_att, x)
    new = ref.ssd_intra_ref(c, b, x, dt, dac)
    assert torch.equal(new, old)
    assert torch.isnan(torch.autograd.grad(old.sum(), dac,
                                           retain_graph=True)[0]).any()
    grads = torch.autograd.grad(new.sum(), (c, b, dac))
    assert all(torch.isfinite(t).all() for t in grads)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(1, 8, 2, 3, 1, 2, 4),
                                                (2, 12, 4, 2, 2, 3, 6)])
def test_autograd_function_gradcheck_float64(b, s, h, p, g, n, chunk):
    """``torch.autograd.gradcheck`` of ``ops.ssd_intra_heads`` (the
    Function's CPU path: the plain forward and ``ssd_intra_heads_bwd_ref``)
    in float64 in x, dt, dac, B and C, B and C strided slices of one
    tensor as in the model."""
    gen = torch.Generator().manual_seed(0)
    f64 = dict(dtype=torch.float64, generator=gen)
    x = torch.randn(b, s, h, p, **f64)
    dt = torch.nn.functional.softplus(torch.randn(b, s, h, **f64))
    dac = torch.cumsum((-dt).reshape(b, s // chunk, chunk, h), 2).reshape(
        b, s, h)
    bc = torch.randn(b, s, 2 * g * n, **f64)
    args = [t.requires_grad_(True) for t in (x, dt, dac)]
    bc.requires_grad_(True)

    def fn(x, dt, dac, bc):
        bm, cm = bc.reshape(b, s, 2, g, n).unbind(2)
        return ops.ssd_intra_heads(x, dt, dac, bm, cm, chunk)
    assert torch.autograd.gradcheck(fn, (*args, bc))


def test_backward_refusals():
    """The backward takes f32 (float64 on the CPU, for gradient checks):
    a bf16 gradient raises on the CPU as on the card, and so does the
    reference's [G, Q, N] entry, which stays forward-only."""
    x = torch.randn(1, 8, 2, 4, dtype=torch.bfloat16, requires_grad=True)
    dt = torch.rand(1, 8, 2)
    dac = -torch.cumsum(dt, 1)
    bm = torch.randn(1, 8, 1, 2, dtype=torch.bfloat16)
    y = ops.ssd_intra_heads(x, dt, dac, bm, bm, 4)
    with pytest.raises(TypeError, match="float32"):
        y.float().sum().backward()
    c = torch.randn(2, 4, 3, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        ops.ssd_intra(c, c.detach(), torch.randn(2, 4, 5), torch.rand(2, 4),
                      torch.zeros(2, 4))
    with torch.no_grad():
        ops.ssd_intra(c, c, torch.randn(2, 4, 5), torch.rand(2, 4),
                      torch.zeros(2, 4))
    with pytest.raises(ValueError, match="cuda or cpu"):
        SSDB.ssd_intra_heads_bwd(*(t.to("meta") for t in (
            x.detach().float(), dt, dac, bm.float(), bm.float(),
            x.detach().float())), 4)


# ---------------------------------------------------------------------------
# one step, remat
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_init(arch, seed=0):
    """Weights of the reduced config in the reference's layout, numpy:
    the port's init (a fraction of a second; the reference's own takes
    seconds, eagerly), so that both packages start from the same values;
    every reader copies the leaves."""
    return params_to_numpy(M.init(get_config(arch).reduced(), seed=seed,
                                  device="cpu"))


def _batch(arch, batch=2, seq=SEQ, step_i=0):
    return make_source(get_config(arch).reduced(), batch,
                       seq_len=seq).full_batch(step_i, 1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(arch, safe_reference):
    """The reference's ``make_train_step`` (under the one-line copy) and
    the port's on the same weights and batch: loss, nll, aux and grad
    norm; every gradient leaf (at step 0 the warm-up lr is ~1e-6, so the
    updated leaves alone would pass a wrong gradient); every updated
    leaf."""
    rcfg = ref_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    tree = _ref_init(arch)
    rbatch = ref_pipeline.make_source(rcfg, 2, seq_len=SEQ).full_batch(0, 1)
    batch = _batch(arch)
    for k in batch:
        np.testing.assert_array_equal(batch[k], rbatch[k])
    rparams = jax.tree.map(jnp.asarray, tree)
    rjcfg = RSH.jigsaw_for(rcfg)
    train_step = ref_step.make_train_step(rcfg, rjcfg, ref_adam.AdamConfig())

    def both(p, o, b):   # the step and its gradients, one compile
        return train_step(p, o, b), jax.grad(
            lambda q: ref_step.loss_fn(q, b, rcfg, rjcfg)[0])(p)
    (rnew, _, rm), rgrads = jax.jit(both)(
        rparams, ref_adam.init(rparams, ref_adam.AdamConfig()),
        {k: jnp.asarray(v) for k, v in rbatch.items()})
    params = params_from_numpy(tree, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, grads = step.value_and_grad(params, tb, cfg, jigsaw_for(cfg))
    new, opt, m = step.make_train_step(cfg, jigsaw_for(cfg),
                                       adam.AdamConfig())(
        params, adam.init(params, adam.AdamConfig()), tb)
    assert set(m) == set(rm)
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        assert np.isfinite(float(rm[k])), k
        assert _rel(float(m[k]), float(rm[k])) <= METRIC_TOL, (k, m[k], rm[k])
    assert (float(m["aux"]) > 0) == (cfg.n_experts > 0)
    assert int(opt["step"]) == 1
    got, want = (jax.tree.leaves(params_to_numpy(grads)),
                 jax.tree.leaves(jax.tree.map(np.asarray, rgrads)))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert _max_norm_err(a, b) <= GRAD_TOL
    for a, b in zip(jax.tree.leaves(params_to_numpy(new)),
                    jax.tree.leaves(jax.tree.map(np.asarray, rnew))):
        np.testing.assert_allclose(a, b, rtol=0, atol=LEAF_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_step_is_nan_without_the_copy(arch):
    """The recorded reference fault: its own ``make_train_step`` on seed-0
    weights and batch of the reduced config gives a finite loss and a NaN
    grad norm; the port's step on the same is finite."""
    rcfg = ref_get_config(arch).reduced()
    tree = _ref_init(arch)
    rbatch = ref_pipeline.make_source(rcfg, 2, seq_len=SEQ).full_batch(0, 1)
    rparams = jax.tree.map(jnp.asarray, tree)
    _, _, rm = jax.jit(ref_step.make_train_step(
        rcfg, RSH.jigsaw_for(rcfg), ref_adam.AdamConfig()))(
        rparams, ref_adam.init(rparams, ref_adam.AdamConfig()),
        {k: jnp.asarray(v) for k, v in rbatch.items()})
    assert np.isfinite(float(rm["loss"])) and np.isnan(float(rm["grad_norm"]))
    cfg = get_config(arch).reduced()
    params = params_from_numpy(tree, device="cpu")
    _, _, m = step.make_train_step(cfg, jigsaw_for(cfg), adam.AdamConfig())(
        params, adam.init(params, adam.AdamConfig()),
        {k: torch.from_numpy(v) for k, v in _batch(arch).items()})
    assert np.isfinite(float(m["grad_norm"])) and float(m["grad_norm"]) > 0


def _grads(arch, **over):
    cfg = get_config(arch).reduced().replace(kernel="pallas", **over)
    params = params_from_numpy(_ref_init(arch), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    return step.value_and_grad(params, batch, cfg, jigsaw_for(cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bitwise_the_step_without(arch):
    """``cfg.remat`` checkpoints each Mamba-2 layer and each jamba period;
    the recompute runs the same forward on the same inputs (the MoE routes
    the same): metrics and gradients bit for bit."""
    m0, g0 = _grads(arch, remat=False)
    m1, g1 = _grads(arch, remat=True)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(ptree.leaves(g0), ptree.leaves(g1)):
        assert torch.equal(a, b)


def ssm_train_calls(cfg):
    """block_matmul and SSD calls of one remat training step under
    ``kernel="pallas"``, by kind: the forward, the remat recompute (every
    layer's or period's, not the head's), dx and dw (every linear's); the
    SSD forward once per SSM layer and again in the recompute, and its
    backward once.  A Mamba-2 layer has 4 linears (in_z, in_xbc, in_dt,
    out_proj); a jamba slot its mixer's 4 (q, k, v, o or the Mamba-2's)
    and its FFN's 3 or, with a MoE, the router's 1."""
    if cfg.family == "ssm":
        per, ssm = 4 * cfg.n_layers, cfg.n_layers
    else:
        slots = range(cfg.n_layers)
        per = sum(4 + (1 if cfg.is_moe_layer(j % cfg.attn_every) else 3)
                  for j in slots)
        ssm = sum(not cfg.is_attn_layer(j % cfg.attn_every) for j in slots)
    return dict(forward=per + 1, remat=per, dx=per + 1, dw=per + 1,
                ssd_forward=ssm, ssd_remat=ssm, ssd_backward=ssm)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_calls_per_step(monkeypatch, arch):
    """The calls of one ``kernel="pallas"`` training step
    (``ssm_train_calls``), with and without remat: the recompute's
    block_matmul and SSD forward calls go without it, the SSD backward's
    stay one a layer."""
    calls = {"bm": 0, "dw": 0, "fwd": 0, "bwd": 0}
    real_bm, real_f, real_b = (ops.block_matmul, SSD.ssd_intra_heads,
                               SSDB.ssd_intra_heads_bwd)

    def bm(x, w, *a, **kw):
        calls["bm"] += 1
        calls["dw"] += kw.get("x_t", False)
        return real_bm(x, w, *a, **kw)

    def fwd(*a):
        calls["fwd"] += 1
        return real_f(*a)

    def bwd(*a):
        calls["bwd"] += 1
        return real_b(*a)
    monkeypatch.setattr(ops, "block_matmul", bm)
    monkeypatch.setattr(SSD, "ssd_intra_heads", fwd)
    monkeypatch.setattr(SSDB, "ssd_intra_heads_bwd", bwd)
    cfg = get_config(arch).reduced().replace(kernel="pallas")
    want = ssm_train_calls(cfg)
    params = M.init(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    for remat in (True, False):
        for k in calls:
            calls[k] = 0
        step.value_and_grad(params, batch, cfg.replace(remat=remat),
                            jigsaw_for(cfg))
        gemms = want["forward"] + want["dx"] + want["dw"]
        assert calls == {
            "bm": gemms + (want["remat"] if remat else 0), "dw": want["dw"],
            "fwd": want["ssd_forward"] + (want["ssd_remat"] if remat else 0),
            "bwd": want["ssd_backward"]}, remat


def test_hybrid_period_of_four_trains_like_the_reference(safe_reference):
    """Jamba at ``attn_every=4, attn_offset=2, n_layers=4`` (a period of
    SSM + dense, SSM + MoE, attention + dense, SSM + MoE), under remat: the
    loss and every gradient leaf against the reference's (under the
    copy)."""
    over = dict(attn_every=4, attn_offset=2, n_layers=4)
    rcfg = ref_get_config(ARCHS[1]).reduced().replace(**over)
    cfg = get_config(ARCHS[1]).reduced().replace(**over)
    tree = params_to_numpy(M.init(cfg, seed=1, device="cpu"))
    batch = make_source(cfg, 2, seq_len=SEQ).full_batch(0, 1)
    rjcfg = RSH.jigsaw_for(rcfg)
    (_, rm), rg = jax.jit(lambda p, b: jax.value_and_grad(
        ref_step.loss_fn, has_aux=True)(p, b, rcfg, rjcfg))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    m, g = step.value_and_grad(params_from_numpy(tree, device="cpu"),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()},
                               cfg.replace(remat=True), jigsaw_for(cfg))
    for k in ("loss", "nll", "aux"):
        assert _rel(float(m[k]), float(rm[k])) <= METRIC_TOL, k
    for a, b in zip(jax.tree.leaves(params_to_numpy(g)),
                    jax.tree.leaves(jax.tree.map(np.asarray, rg))):
        assert _max_norm_err(a, b) <= GRAD_TOL


# ---------------------------------------------------------------------------
# TrainEngine and the train CLI
# ---------------------------------------------------------------------------

def _save_npz(path, tree):
    flat = {}
    ptree.map_with_path(
        lambda p, a: flat.__setitem__("/".join(map(str, p)), a), tree)
    np.savez(path, **flat)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_history_matches_reference_engine(arch, tmp_path,
                                              safe_reference):
    """``python -m repro_torch.launch.train --device cpu --arch <id>
    --steps 5 --seq-len 32 --log-every 1`` (in process, from the
    reference's weights through ``--init-params``) against the reference's
    ``TrainEngine`` (under the copy) on the same weights: loss, grad norm,
    lr, nll and aux at every step, and the keys of each record."""
    tree = _ref_init(arch)
    _save_npz(tmp_path / "init.npz", tree)
    reng = RTrainEngine(arch, reduced=True,
                        init_params=jax.tree.map(jnp.asarray, tree),
                        config=REngineConfig(steps=STEPS, batch=2,
                                             seq_len=SEQ, log_every=1,
                                             prefetch=0, telemetry=False,
                                             seed=0))
    want = reng.run()
    out = tmp_path / "m.jsonl"
    with pytest.raises(SystemExit) as done:
        train_cli.main(["--device", "cpu", "--arch", arch, "--steps",
                        str(STEPS), "--batch", "2", "--seq-len", str(SEQ),
                        "--log-every", "1", "--prefetch", "1",
                        "--no-telemetry", "--init-params",
                        str(tmp_path / "init.npz"), "--metrics-out",
                        str(out)])
    assert done.value.code == 0
    got = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["step"] == w["step"]
        for k in HIST_KEYS + ("nll", "aux"):
            assert np.isfinite(w[k]), (k, w)
            assert _rel(g[k], w[k]) <= METRIC_TOL, (k, g, w)


def test_engine_keeps_item_19_refusals():
    """Training the two families is open, on a 1-D model mesh too; a 2-D
    model mesh, and jamba's FSDP cut over a data mesh, still raise naming
    item 19."""
    for arch in ARCHS:
        with pytest.raises(NotImplementedError, match="item 19"):
            TrainEngine(arch, device="cpu", mesh_model=4, scheme="2d",
                        config=EngineConfig(steps=1, batch=2))
    cfg = get_config(ARCHS[1])
    assert cfg.shard_params_over_data
    with pytest.raises(NotImplementedError, match="item 19"):
        TrainEngine(ARCHS[1], device="cpu", mesh_data=2,
                    config=EngineConfig(steps=1, batch=2))


# ---------------------------------------------------------------------------
# (data 2, model 1) under gloo
# ---------------------------------------------------------------------------

DATA_RUNS = {"base": {}, "zero1": dict(zero1=True)}


def _rank_main(rank, init, out_dir):
    """One rank of a (data 2, model 1) mesh: ``DATA_RUNS`` of mamba2-130m
    reduced from the weights in init.npz; each history and the final
    parameters saved to rank<r>.npz."""
    import torch.distributed as dist
    from repro_torch.convert import params_from_npz
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    whole = params_from_npz(Path(out_dir) / "init.npz", device="cpu")
    res = {}
    for tag, kw in DATA_RUNS.items():
        eng = TrainEngine(ARCHS[0], init_params=whole, device="cpu",
                          mesh_data=2, config=EngineConfig(
                              steps=STEPS, batch=2, seq_len=SEQ,
                              log_every=1, prefetch=0, telemetry=False,
                              seed=0, **kw))
        hist = eng.run()
        for k in HIST_KEYS:
            res[f"{tag}/{k}"] = np.array([h[k] for h in hist])
        ptree.map_with_path(lambda p, v: res.__setitem__(
            f"{tag}/params/" + "/".join(map(str, p)), v.numpy()), eng.params)
        res[f"{tag}/opt_bytes"] = np.array(eng.opt_state_bytes())
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


def test_data_mesh_matches_one_device_and_zero1_is_bitwise(tmp_path):
    """Two gloo ranks of this file at (data 2, model 1), each reading its
    row of the batch: mamba2-130m's five-step history and final
    parameters bit for bit the one-device engine's with ``accum=2`` on
    one thread (the SSD term's backward sums each row alone, in a fixed
    order), ZeRO-1 bit for bit the run without, the ranks' parameters
    equal."""
    tree = _ref_init(ARCHS[0])
    _save_npz(tmp_path / "init.npz", tree)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    init = f"file://{tmp_path / 'store'}"
    ranks = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), init, str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        eng = TrainEngine(ARCHS[0], device="cpu",
                          init_params=params_from_numpy(tree, device="cpu"),
                          config=EngineConfig(
                              steps=STEPS, batch=2, seq_len=SEQ,
                              log_every=1, prefetch=0, telemetry=False,
                              seed=0, accum=2))
        halves = eng.run()
    finally:
        torch.set_num_threads(threads)
    try:
        outs = [p.communicate(timeout=300) for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    for p, (_, err) in zip(ranks, outs):
        assert p.returncode == 0, err[-3000:]
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for k in HIST_KEYS:
        np.testing.assert_array_equal(res[0][f"base/{k}"],
                                      [h[k] for h in halves], err_msg=k)
    ptree.map_with_path(lambda p, v: np.testing.assert_array_equal(
        res[0]["base/params/" + "/".join(map(str, p))], v.numpy()),
        eng.params)
    for r in res:
        for key in r:
            if key.startswith("base/") and not key.endswith("opt_bytes"):
                np.testing.assert_array_equal(
                    r[key.replace("base/", "zero1/")], r[key])
        assert 2 * r["zero1/opt_bytes"] <= r["base/opt_bytes"] + 64
    for key in res[0]:
        np.testing.assert_array_equal(res[0][key], res[1][key])


if __name__ == "__main__":
    _rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
