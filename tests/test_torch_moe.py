"""The port's mixture of experts and the moe family against the JAX
package's.

``models/layers.py::moe_apply`` (GShard top-k routing with per-group
capacity drops) on the reference's ``moe_init`` weights, carried through
numpy; then ``dbrx-132b`` and ``phi3.5-moe-42b-a6.6b`` reduced (d_model
256, 4 experts, top-2) through ``models/transformer.py``: the logits and
the aux loss, decode, the fused prefill and ``generate``.  All on the CPU,
where block_matmul is its plain version.

Tolerances:
  * ``moe_apply`` in f32: 1e-5 absolute and relative on the output and the
    aux loss (the same f32 operations; only the order of the f32 sums over
    d_model, d_ff and the tokens of a group differs), and the routes
    (``gate_idx``), the buffer positions and the drops exactly;
  * the bf16 router with exact ties: ``gate_idx``, positions and drops
    exactly (ties go to the lower expert index in both packages), the
    output within one bf16 step of its largest values (2^-7 relative;
    atol 2^-7): both sides round the same products to bf16 in another
    order;
  * the logits 1e-4, decode against the teacher-forced forward 5e-3 (the
    reference's ``tests/test_decode_consistency.py``, with its
    ``capacity_factor = n_experts`` so that no token is dropped), the
    fused against the token-wise prefill at the reference's bounds, as in
    ``tests/test_torch_transformer.py``.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.core.api import JigsawConfig as RefJigsawConfig
from repro.launch import shapes as RSH
from repro.models import layers as RL
from repro.models import registry as RM
from repro.serve import step as RS
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.api import JigsawConfig
from repro_torch.data.tokens import TokenDataConfig, TokenDataset
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import layers as L
from repro_torch.models import registry as M
from repro_torch.serve import step as S

OP_TOL = 1e-5
LOGIT_TOL = 1e-4
DECODE_TOL = 5e-3
BF16_STEP = 2.0 ** -7

ARCHS = ["dbrx-132b", "phi3.5-moe-42b-a6.6b"]
# the layer cases: d_model 32, d_ff 48, 8 experts; 74 tokens in groups of
# 16, so the last group is padded with 6 zero rows
D, FF, E, GROUP = 32, 48, 8, 16


def _moe_tree(seed=0, d=D, ff=FF, e=E, kind="swiglu"):
    return jax.tree.map(np.array, RL.moe_init(jax.random.PRNGKey(seed), d,
                                              ff, e, kind=kind))


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ref_route(rtree, x, top_k, capacity, group, rjcfg):
    """The reference's routing, its own lines on its own router: gate_idx,
    the position in the expert's buffer and the keep mask."""
    b, s, d = x.shape
    t = b * s
    gs = min(group, t)
    xt = jnp.pad(x.reshape(t, d), ((0, (-t) % gs), (0, 0)))
    xg = xt.reshape(-1, gs, d)
    logits = RL.linear_apply(rtree["router"], xg.astype(jnp.float32),
                             rjcfg.replace(scheme="none"))
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    onehot = jax.nn.one_hot(idx, probs.shape[-1], dtype=jnp.int32)
    flat = onehot.reshape(xg.shape[0], gs * top_k, -1)
    before = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    pos = jnp.sum(before * onehot, axis=-1)
    return (np.asarray(probs), np.asarray(idx), np.asarray(pos),
            np.asarray(pos < capacity))


def _route(tree, x, top_k, capacity, group, jcfg):
    b, s, d = x.shape
    t = b * s
    gs = min(group, t)
    xt = torch.cat([x.reshape(t, d), x.new_zeros(((-t) % gs, d))])
    out = L.moe_route(tree["router"], xt.reshape(-1, gs, d), top_k,
                      capacity, jcfg)
    return [a.numpy() if a.dtype != torch.bfloat16 else a.float().numpy()
            for a in out]


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.1, 1.25, float(E)])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_moe_apply_matches_reference(top_k, cf):
    """f32: the output and aux loss within 1e-5, the routes, positions and
    drops exactly; 74 tokens in groups of 16 (the last padded)."""
    tree = _moe_tree()
    x = _x((2, 37, D))
    want, waux = RL.moe_apply(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(x), top_k=top_k,
                              capacity_factor=cf, group_size=GROUP)
    tt = jax.tree.map(torch.from_numpy, tree)
    got, aux = L.moe_apply(tt, torch.from_numpy(x), top_k=top_k,
                           capacity_factor=cf, group_size=GROUP)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    _close(got, want, OP_TOL)
    _close(aux, waux, OP_TOL)
    capacity = max(1, int(cf * top_k * GROUP / E))
    _, ridx, rpos, rkeep = _ref_route(jax.tree.map(jnp.asarray, tree),
                                      jnp.asarray(x), top_k, capacity,
                                      GROUP, RefJigsawConfig())
    _, _, idx, pos, keep = _route(tt, torch.from_numpy(x), top_k, capacity,
                                  GROUP, JigsawConfig())
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(pos, rpos)
    np.testing.assert_array_equal(keep, rkeep)
    if cf == 0.1:
        assert not keep.all()           # this case drops
    if cf == float(E):
        assert keep.all()               # ample capacity keeps every slot


def _tied_tree():
    """8 experts whose router rows come in equal pairs (0 = 3, 2 = 6):
    their logits, and so their probabilities, tie exactly."""
    tree = _moe_tree(seed=4)
    w = tree["router"]["w"]
    w[3], w[6] = w[0], w[2]
    return tree


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_bf16_router_ties_resolve_as_reference(top_k):
    """The bf16 policy's router (operands cast to bf16, the softmax in
    bf16), where pairs of experts tie exactly and bf16 rounding makes
    more ties: the routes go to the lower index, as ``jax.lax.top_k``'s,
    so gate_idx, the positions and the drops are the reference's
    exactly."""
    tree = _tied_tree()
    x = _x((2, 37, D), seed=5)
    capacity = max(1, int(1.25 * top_k * GROUP / E))
    rjcfg = RefJigsawConfig(compute_dtype=jnp.bfloat16)
    jcfg = JigsawConfig(compute_dtype=torch.bfloat16)
    rx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).bfloat16()
    rprobs, ridx, rpos, rkeep = _ref_route(
        jax.tree.map(jnp.asarray, tree), rx, top_k, capacity, GROUP, rjcfg)
    probs, _, idx, pos, keep = _route(jax.tree.map(torch.from_numpy, tree),
                                      tx, top_k, capacity, GROUP, jcfg)
    # tokens with an exact tie among the chosen and the next: the pairs,
    # bf16 roundings and the zero pad rows
    srt = np.sort(probs, axis=-1)[..., ::-1][..., :top_k + 1]
    assert (srt[..., 1:] == srt[..., :-1]).any(axis=-1).sum() >= 10
    np.testing.assert_array_equal(probs, np.asarray(rprobs, np.float32))
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(pos, rpos)
    np.testing.assert_array_equal(keep, rkeep)
    assert not keep.all()
    want, waux = RL.moe_apply(jax.tree.map(jnp.asarray, tree), rx,
                              top_k=top_k, group_size=GROUP, cfg=rjcfg)
    got, aux = L.moe_apply(jax.tree.map(torch.from_numpy, tree), tx,
                           top_k=top_k, group_size=GROUP, cfg=jcfg)
    assert got.dtype == torch.float32       # bf16 x with f32 experts
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=BF16_STEP,
                               atol=BF16_STEP)
    np.testing.assert_allclose(float(aux), float(waux), rtol=BF16_STEP)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_moe_init_tree_and_gelu_experts_match_reference(kind):
    """The port's own init makes the reference's tree (keys, shapes,
    dtypes: an f32 router, bf16 experts); the GELU experts' output on the
    reference's weights within 1e-5."""
    mine = params_to_numpy(L.moe_init(
        torch.Generator().manual_seed(0), D, FF, E, kind=kind,
        dtype=torch.bfloat16, device="cpu"), bf16_dtype=jnp.bfloat16)
    theirs = jax.eval_shape(lambda: RL.moe_init(
        jax.random.PRNGKey(0), D, FF, E, kind=kind, dtype=jnp.bfloat16))
    flat_m, flat_r = (jax.tree_util.tree_flatten_with_path(t)[0]
                      for t in (mine, theirs))
    assert [p for p, _ in flat_m] == [p for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_m, flat_r):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path
    tree = _moe_tree(seed=2, kind=kind)
    x = _x((1, 20, D), seed=3)
    want, _ = RL.moe_apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
                           top_k=2, group_size=GROUP)
    got, _ = L.moe_apply(jax.tree.map(torch.from_numpy, tree),
                         torch.from_numpy(x), top_k=2, group_size=GROUP)
    _close(got, want, OP_TOL)


# the reference's tests/test_layers.py contracts, on the port

def test_moe_output_shape_and_aux():
    tree = _moe_tree(d=32, ff=64, e=4)
    x = torch.from_numpy(_x((2, 16, 32)))
    y, aux = L.moe_apply(jax.tree.map(torch.from_numpy, tree), x, top_k=2)
    assert y.shape == x.shape
    assert float(aux) >= 1.0 - 1e-3     # the load-balance loss is >= 1


def test_moe_capacity_drops_tokens():
    """With a tiny capacity more than 30 % of the rows come out zero."""
    tree = jax.tree.map(torch.from_numpy, _moe_tree(d=16, ff=32, e=4))
    x = torch.from_numpy(_x((1, 64, 16)))
    full, _ = L.moe_apply(tree, x, top_k=1, capacity_factor=8.0)
    tiny, _ = L.moe_apply(tree, x, top_k=1, capacity_factor=0.1)
    assert float((tiny == 0).all(dim=-1).float().mean()) > 0.3
    assert not torch.allclose(full, tiny)


def test_moe_single_expert_equals_dense():
    """One expert, top-1, ample capacity: the plain SwiGLU of that
    expert."""
    tree = jax.tree.map(torch.from_numpy, _moe_tree(d=16, ff=32, e=1))
    x = torch.from_numpy(_x((2, 8, 16)))
    y, _ = L.moe_apply(tree, x, top_k=1, capacity_factor=4.0)
    w = tree["experts"]
    h = torch.nn.functional.silu(x @ w["gate"][0].T) * (x @ w["up"][0].T)
    np.testing.assert_allclose(y.numpy(), (h @ w["down"][0].T).numpy(),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the moe family: dbrx-132b and phi3.5-moe-42b-a6.6b, reduced
# ---------------------------------------------------------------------------

def _jitter(tree, seed):
    """Norm scales moved off their init value (ones), so every term is
    exercised; the same numpy values go to both packages."""
    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key == "scale":
            return (node + 0.1 * rng.normal(size=node.shape)).astype(
                node.dtype)
        return node
    return walk(tree)


_MODELS = {}


def _model(arch, cf=None):
    """(port cfg, reference cfg, port params, reference params), cached;
    ``cf`` replaces the capacity factor (the weights are the same)."""
    if arch not in _MODELS:
        rcfg = ref_get_config(arch).reduced()
        tree = _jitter(jax.tree.map(np.asarray,
                                    RM.init(jax.random.PRNGKey(0), rcfg)), 1)
        _MODELS[arch] = (params_from_numpy(tree, device="cpu"),
                         jax.tree.map(jnp.asarray, tree))
    cfg, rcfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    if cf is not None:
        cfg, rcfg = (c.replace(capacity_factor=cf) for c in (cfg, rcfg))
    return (cfg, rcfg) + _MODELS[arch]


def _tokens(cfg, batch, seq, step=0):
    return TokenDataset(TokenDataConfig(cfg.vocab_size, seq)).sample_batch(
        step, batch)["tokens"]


_ref_decode = jax.jit(RM.decode_step, static_argnums=(3, 4))


def test_configs_match_reference():
    for arch in ARCHS:
        cfg, rcfg = get_config(arch), ref_get_config(arch)
        for mine, theirs in [(cfg, rcfg), (cfg.reduced(), rcfg.reduced())]:
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
            assert mine.param_count() == theirs.param_count()
    assert get_config("phi3.5-moe-42b-a6.6b").param_count() == 41_874_100_224


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_logits_and_aux_match_reference(arch, kernel):
    """The teacher-forced logits and the summed aux loss at the default
    capacity factor (1.25: tokens are dropped), 2 x 600 tokens, so the
    second row's tokens straddle a group boundary and the last group is
    padded."""
    cfg, rcfg, params, rparams = _model(arch)
    tokens = _tokens(cfg, 2, 600)
    logits, aux = M.apply(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                          jigsaw_for(cfg.replace(kernel=kernel)))
    want, waux = RM.apply(rparams, {"tokens": jnp.asarray(tokens)}, rcfg,
                          RSH.jigsaw_for(rcfg))
    assert tuple(logits.shape) == (2, 600, cfg.vocab_padded)
    assert aux.dtype == torch.float32 and float(aux) > 0
    _close(logits, want, LOGIT_TOL)
    _close(aux, waux, LOGIT_TOL)


def test_init_tree_matches_reference():
    """The port's own init, bf16: the reference's keys, shapes and
    dtypes (the f32 router and norms)."""
    for arch in ARCHS:
        over = dict(param_dtype="bfloat16")
        mine = params_to_numpy(M.init(get_config(arch).reduced().replace(
            **over), seed=0, device="cpu"), bf16_dtype=jnp.bfloat16)
        rcfg = ref_get_config(arch).reduced().replace(**over)
        theirs = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), rcfg))
        flat_m, flat_r = (jax.tree_util.tree_flatten_with_path(t)[0]
                          for t in (mine, theirs))
        assert [p for p, _ in flat_m] == [p for p, _ in flat_r], arch
        for (path, a), (_, b) in zip(flat_m, flat_r):
            assert (a.shape, a.dtype) == (b.shape, b.dtype), (arch, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forced(arch):
    """The reference's ``test_decode_matches_teacher_forced`` on the port,
    at its ``capacity_factor = n_experts``."""
    cfg, _, params, _ = _model(arch, cf=4.0)
    tokens = torch.from_numpy(_tokens(cfg, 2, 24, step=2))
    jcfg = jigsaw_for(cfg)
    want, _ = M.apply(params, {"tokens": tokens}, cfg, jcfg)
    cache = M.init_cache(cfg, 2, 26, dtype=torch.float32, device="cpu")
    got = []
    for t in range(tokens.shape[1]):
        logits, cache = M.decode_step(params, cache, tokens[:, t:t + 1], cfg,
                                      jcfg)
        got.append(logits[:, 0])
    _close(torch.stack(got, 1), want, DECODE_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_cache_match_reference(arch):
    """Decode steps against the reference's jitted decode step: the
    logits after every step and the KV cache at the end."""
    cfg, rcfg, params, rparams = _model(arch)
    tokens = _tokens(cfg, 3, 12, step=1)
    cache = M.init_cache(cfg, 3, 14, dtype=torch.float32, device="cpu")
    rcache = RM.init_cache(rcfg, 3, 14, dtype=jnp.float32)
    jcfg, rjcfg = jigsaw_for(cfg), RSH.jigsaw_for(rcfg)
    for t in range(tokens.shape[1]):
        logits, cache = M.decode_step(params, cache,
                                      torch.from_numpy(tokens[:, t:t + 1]),
                                      cfg, jcfg)
        rlogits, rcache = _ref_decode(rparams, rcache,
                                      jnp.asarray(tokens[:, t:t + 1]), rcfg,
                                      rjcfg)
        _close(logits, rlogits, LOGIT_TOL)
    assert sorted(cache) == sorted(rcache)
    for k in cache:
        _close(cache[k], rcache[k], LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_prefill_parity(arch):
    """The fused prefill against the token-wise one, at ``capacity_factor
    = n_experts`` (at 1.25 the fused prefill drops tokens that a decode
    step keeps, by design): the next tokens equal, the caches at the
    reference's bounds, ``generate``'s tokens either way."""
    cfg, _, params, _ = _model(arch, cf=4.0)
    jcfg = jigsaw_for(cfg)
    prompts = torch.from_numpy(_tokens(cfg, 2, 9, step=5))
    n_f, c_f = S.prefill(params, prompts, cfg, jcfg, 24,
                         cache_dtype=torch.float32, fused=True)
    n_t, c_t = S.prefill_tokenwise(params, prompts, cfg, jcfg, 24,
                                   cache_dtype=torch.float32)
    assert torch.equal(n_f, n_t)
    assert torch.equal(c_f["pos"], c_t["pos"])
    for k in ("k", "v"):
        assert torch.allclose(c_f[k], c_t[k], rtol=5e-3, atol=1e-4)
    assert torch.equal(
        S.generate(params, prompts, cfg, jcfg, steps=6, max_len=24,
                   fused=True),
        S.generate(params, prompts, cfg, jcfg, steps=6, max_len=24,
                   fused=False))


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch):
    """``generate`` eagerly on the CPU (the fused prefill at the default
    capacity factor, then decode steps, bf16 cache): the tokens agree with
    the reference's ``generate`` up to the first position where the
    reference's top-2 logit margin is within the logits' tolerance, and
    nowhere else may they differ."""
    cfg, rcfg, params, rparams = _model(arch)
    prompts = _tokens(cfg, 2, 16, step=3)
    steps = 8
    got = S.generate(params, torch.from_numpy(prompts), cfg, jigsaw_for(cfg),
                     steps=steps, max_len=32).numpy()
    want = np.asarray(RS.generate(rparams, jnp.asarray(prompts), rcfg,
                                  RSH.jigsaw_for(rcfg), steps=steps,
                                  max_len=32))
    assert got.shape == want.shape == (2, steps) and got.dtype == np.int32
    assert ((got >= 0) & (got < cfg.vocab_size)).all()
    # the reference's decode logits along its own continuation
    nxt, rcache = RS.prefill(rparams, jnp.asarray(prompts), rcfg,
                             RSH.jigsaw_for(rcfg), 32)
    margins = []
    for i in range(steps - 1):
        rlogits, rcache = _ref_decode(rparams, rcache,
                                      jnp.asarray(want[:, i:i + 1]), rcfg,
                                      RSH.jigsaw_for(rcfg))
        top2 = np.sort(np.asarray(rlogits)[:, 0, : cfg.vocab_size], -1)
        margins.append(top2[:, -1] - top2[:, -2])
    margins = np.stack(margins, 1)
    for r in range(2):
        differ = np.flatnonzero(got[r] != want[r])
        if differ.size:
            assert differ[0] > 0 and margins[r, differ[0] - 1] <= \
                LOGIT_TOL, (r, differ[0])
