"""The port's hybrid family (``jamba-1.5-large-398b``) against the JAX
package's.

Two reduced configs (d_model 256, 4 experts top-2, SSM 8 heads in 8
groups, state 32): the reduced period of 2 (slot 0 SSM + dense FFN, slot
1 attention + MoE), and ``attn_every=4, attn_offset=2, n_layers=8`` (two
periods of SSM + dense, SSM + MoE, attention + dense, SSM + MoE).  The
reference's weights (``repro.models.registry.init``) go to the port
through ``repro_torch.convert`` (the stacked ``"periods"`` become a list),
with every norm scale moved off its init value; all f32 on the CPU, where
block_matmul and the ssd kernel are their plain versions.

Tolerances: the logits and aux loss 1e-4 (``tests/test_torch_mamba.py``'s
and ``tests/test_torch_transformer.py``'s bound: f32 sums over d_model,
d_ff and the chunk in another order, through the layers); each decode
step's logits and every cache leaf against the reference's jitted decode
step 1e-4 absolute and relative; decode against the teacher-forced
forward 5e-3 (the reference's ``tests/test_decode_consistency.py``, at its
``capacity_factor = n_experts``); the weights through ``convert`` bit for
bit.  The graphed decode on the hybrid's nested cache is held in
``tests/test_torch_graphs.py``, which imports no jax, so that its card
half runs on a machine without the reference.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.launch import shapes as RSH
from repro.models import registry as RM
from repro.serve import step as RS
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.tokens import TokenDataConfig, TokenDataset
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import hybrid as H
from repro_torch.models import registry as M
from repro_torch.serve import step as S

ARCH = "jamba-1.5-large-398b"
LOGIT_TOL = 1e-4
DECODE_TOL = 5e-3
CONFIGS = {"period2": {},
           "period4": {"attn_every": 4, "attn_offset": 2, "n_layers": 8}}


def _jitter(tree, seed):
    """Norm scales moved off their init value, the same numpy values to
    both packages."""
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


def _model(kind, cf=None):
    """(port cfg, reference cfg, port params, reference params, reference
    numpy tree), the weights cached; ``cf`` replaces the capacity
    factor."""
    over = CONFIGS[kind]
    rcfg = ref_get_config(ARCH).reduced().replace(**over)
    if kind not in _MODELS:
        tree = _jitter(jax.tree.map(np.asarray,
                                    RM.init(jax.random.PRNGKey(0), rcfg)), 1)
        _MODELS[kind] = (params_from_numpy(tree, device="cpu"),
                         jax.tree.map(jnp.asarray, tree), tree)
    cfg = get_config(ARCH).reduced().replace(**over)
    if cf is not None:
        cfg, rcfg = (c.replace(capacity_factor=cf) for c in (cfg, rcfg))
    return (cfg, rcfg) + _MODELS[kind]


def _tokens(cfg, batch, seq, step=0):
    return TokenDataset(TokenDataConfig(cfg.vocab_size, seq)).sample_batch(
        step, batch)["tokens"]


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


_ref_decode = jax.jit(RM.decode_step, static_argnums=(3, 4))


def test_slot_layout():
    """The two configs' slots: every kind of (mixer, FFN) pair, as the
    reference's predicates place them."""
    kinds = {}
    for kind in CONFIGS:
        cfg = get_config(ARCH).reduced().replace(**CONFIGS[kind])
        kinds[kind] = [(H._slot_kind(cfg, j),
                        "moe" if cfg.is_moe_layer(j) else "ffn")
                       for j in range(cfg.attn_every)]
    assert kinds["period2"] == [("ssm", "ffn"), ("attn", "moe")]
    assert kinds["period4"] == [("ssm", "ffn"), ("ssm", "moe"),
                                ("attn", "ffn"), ("ssm", "moe")]


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_apply_logits_and_aux_match_reference(kind, kernel):
    """The teacher-forced logits and the summed aux loss at the default
    capacity factor (tokens dropped), S = 100: one whole SSD chunk of 64
    and a ragged one."""
    cfg, rcfg, params, rparams, _ = _model(kind)
    tokens = _tokens(cfg, 2, 100)
    logits, aux = M.apply(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                          jigsaw_for(cfg.replace(kernel=kernel)))
    want, waux = RM.apply(rparams, {"tokens": jnp.asarray(tokens)}, rcfg,
                          RSH.jigsaw_for(rcfg))
    assert tuple(logits.shape) == (2, 100, cfg.vocab_padded)
    assert aux.dtype == torch.float32 and float(aux) > 0
    _close(logits, want, LOGIT_TOL)
    _close(aux, waux, LOGIT_TOL)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_decode_steps_and_cache_match_reference(kind):
    """init_cache's layout (keys, shapes, dtypes) as the reference's; then
    decode steps against the reference's: every step's logits and every
    cache leaf (the attention slots' k and v, the SSM slots' conv window
    and state, pos) after every step."""
    cfg, rcfg, params, rparams, _ = _model(kind)
    seq, max_len = 10, 12
    tokens = _tokens(cfg, 2, seq, step=1)
    cache = M.init_cache(cfg, 2, max_len, dtype=torch.float32, device="cpu")
    rcache = RM.init_cache(rcfg, 2, max_len, dtype=jnp.float32)
    mine = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), cache))[0]
    theirs = jax.tree_util.tree_flatten_with_path(rcache)[0]
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    for (path, a), (_, b) in zip(mine, theirs):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path
    jcfg, rjcfg = jigsaw_for(cfg), RSH.jigsaw_for(rcfg)
    for t in range(seq):
        logits, out = M.decode_step(params, cache,
                                    torch.from_numpy(tokens[:, t:t + 1]),
                                    cfg, jcfg)
        rlogits, rcache = _ref_decode(rparams, rcache,
                                      jnp.asarray(tokens[:, t:t + 1]), rcfg,
                                      rjcfg)
        assert out is cache
        _close(logits, rlogits, LOGIT_TOL)
        got = jax.tree_util.tree_leaves(jax.tree.map(lambda v: v.numpy(),
                                                     cache))
        for a, b in zip(got, jax.tree_util.tree_leaves(rcache)):
            _close(a, b, LOGIT_TOL)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_decode_matches_teacher_forced(kind):
    """The reference's ``test_decode_matches_teacher_forced`` on the port,
    at its ``capacity_factor = n_experts``: S = 70, past one SSD chunk."""
    cfg, _, params, _, _ = _model(kind, cf=4.0)
    tokens = torch.from_numpy(_tokens(cfg, 2, 70, step=2))
    jcfg = jigsaw_for(cfg)
    want, _ = M.apply(params, {"tokens": tokens}, cfg, jcfg)
    cache = M.init_cache(cfg, 2, 72, dtype=torch.float32, device="cpu")
    got = []
    for t in range(tokens.shape[1]):
        logits, cache = M.decode_step(params, cache, tokens[:, t:t + 1], cfg,
                                      jcfg)
        got.append(logits[:, 0])
    _close(torch.stack(got, 1), want, DECODE_TOL)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_init_tree_and_convert_match_reference(kind):
    """The port's own init (bf16) makes the reference's tree: keys, shapes
    and dtypes; and the reference's weights go through
    ``params_from_numpy`` / ``params_to_numpy`` bit for bit, the periods
    a list of per-period slot dicts in between."""
    cfg, rcfg, params, _, tree = _model(kind)
    over = dict(param_dtype="bfloat16")
    mine = params_to_numpy(M.init(cfg.replace(**over), seed=0, device="cpu"),
                           bf16_dtype=jnp.bfloat16)
    theirs = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0),
                                            rcfg.replace(**over)))
    flat_m, flat_r = (jax.tree_util.tree_flatten_with_path(t)[0]
                      for t in (mine, theirs))
    assert [p for p, _ in flat_m] == [p for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_m, flat_r):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path
    n_periods = cfg.n_layers // cfg.attn_every
    assert isinstance(params["periods"], list)
    assert len(params["periods"]) == n_periods
    assert sorted(params["periods"][0]) == [f"slot{j}"
                                            for j in range(cfg.attn_every)]
    back = params_to_numpy(params)
    flat_b, flat_t = (jax.tree_util.tree_flatten_with_path(t)[0]
                      for t in (back, tree))
    assert [p for p, _ in flat_b] == [p for p, _ in flat_t]
    for (path, a), (_, b) in zip(flat_b, flat_t):
        assert a.dtype == b.dtype and np.array_equal(a, b), path


def test_depth_must_be_whole_periods():
    """The reference asserts a whole number of periods; the port raises."""
    cfg = get_config(ARCH).reduced().replace(n_layers=3)
    with pytest.raises(ValueError, match="multiple of the period"):
        M.init(cfg, device="cpu")
    with pytest.raises(ValueError, match="multiple of the period"):
        M.init_cache(cfg, 1, 4, device="cpu")


def test_prefill_is_token_wise():
    """The hybrid has no fused prefill (nor has the reference's):
    ``fused=True`` raises, the default prefills token by token."""
    cfg, _, params, _, _ = _model("period2")
    jcfg = jigsaw_for(cfg)
    prompts = torch.from_numpy(_tokens(cfg, 2, 5, step=4))
    with pytest.raises(NotImplementedError, match="fused prefill"):
        S.prefill(params, prompts, cfg, jcfg, 8, fused=True)
    nxt, cache = S.prefill(params, prompts, cfg, jcfg, 8)
    n_t, c_t = S.prefill_tokenwise(params, prompts, cfg, jcfg, 8)
    assert torch.equal(nxt, n_t)
    for a, b in zip(*(jax.tree_util.tree_leaves(c) for c in (cache, c_t))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert cache["pos"].tolist() == [5, 5]


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_generate_matches_reference(kind):
    """``generate`` eagerly on the CPU (the token-wise prefill, then decode
    steps, bf16 cache): the tokens agree with the reference's ``generate``
    up to the first position where the reference's top-2 logit margin is
    within the logits' tolerance, and nowhere else may they differ."""
    cfg, rcfg, params, rparams, _ = _model(kind)
    prompts = _tokens(cfg, 2, 12, step=3)
    steps, max_len = 6, 20
    got = S.generate(params, torch.from_numpy(prompts), cfg, jigsaw_for(cfg),
                     steps=steps, max_len=max_len).numpy()
    want = np.asarray(RS.generate(rparams, jnp.asarray(prompts), rcfg,
                                  RSH.jigsaw_for(rcfg), steps=steps,
                                  max_len=max_len))
    assert got.shape == want.shape == (2, steps) and got.dtype == np.int32
    assert ((got >= 0) & (got < cfg.vocab_size)).all()
    # the reference's logits at each generated token: its decode steps
    # along its own continuation, after its token-wise prefill
    rcache = RM.init_cache(rcfg, 2, max_len, dtype=jnp.bfloat16)
    rjcfg = RSH.jigsaw_for(rcfg)
    seq = np.concatenate([prompts, want[:, :-1]], axis=1)
    margins = []
    for t in range(seq.shape[1]):
        rlogits, rcache = _ref_decode(rparams, rcache,
                                      jnp.asarray(seq[:, t:t + 1]), rcfg,
                                      rjcfg)
        if t >= prompts.shape[1] - 1:
            top2 = np.sort(np.asarray(rlogits)[:, 0, : cfg.vocab_size], -1)
            margins.append(top2[:, -1] - top2[:, -2])
    margins = np.stack(margins, 1)
    for r in range(2):
        differ = np.flatnonzero(got[r] != want[r])
        if differ.size:
            assert margins[r, differ[0]] <= LOGIT_TOL, (r, differ[0])
