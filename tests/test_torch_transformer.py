"""The port's transformer family (dense and VLM) against the JAX package's.

The reference's weights (``repro.models.registry.init``, reduced configs:
d_model 256, 4 heads, 2 KV heads, vocab 1024; gemma3 at 8 layers so that
its stack holds one whole 5:1 local:global period and the 2-layer
leftover, where the reduced 2 layers have no global layer) are carried to
the port by ``repro_torch.convert`` through numpy, with every norm scale
and bias moved off its init value, and the same ``TokenDataset`` rows go
through both.  All f32 on the CPU, where block_matmul is its plain version.

Tolerances:
  * ``rope``, ``sdpa``, ``sdpa_chunked``, ``attention_apply`` and
    ``ffn_apply``: 1e-5 absolute and relative.  The same f32 operations
    as the reference's; only the order of the f32 sums (d_head, the keys,
    d_model) and the cos/sin/pow approximations differ, ~1e-7 relative.
  * the logits, whose largest are ~5: 1e-4 absolute and relative, each an
    f32 sum over d_model or d_ff in another order than XLA's, after a few
    layers (the same bound as ``tests/test_torch_mamba.py``).
  * decode against the teacher-forced forward: 5e-3, the reference's own
    (``tests/test_decode_consistency.py``); decode against the
    reference's decode step: the logits bound, 1e-4.
  * fused against token-wise prefill: the next tokens equal and the caches
    within rtol 5e-3 / atol 1e-4, the reference's own bounds
    (``tests/test_serve.py::test_fused_prefill_parity``).
  * the fused prefill's bf16 cache against the reference's: one bf16 step
    (2^-7 relative at most; atol 1e-4): the f32 k and v agree to ~1e-6, and
    a value at a rounding boundary may round to the neighbouring bf16
    value.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.registry import ARCH_IDS as REF_ARCH_IDS
from repro.configs.registry import get_config as ref_get_config
from repro.launch import shapes as RSH
from repro.models import layers as RL
from repro.models import registry as RM
from repro.serve import step as RS
from repro_torch.configs import (dbrx_132b, gemma3_27b, h2o_danube_1_8b,
                                 internlm2_1_8b, jamba_1_5_large_398b,
                                 phi3_5_moe_42b_a6_6b, pixtral_12b,
                                 stablelm_3b)
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.tokens import TokenDataConfig, TokenDataset
from repro_torch.kernels import block_matmul as BM
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import layers as L
from repro_torch.models import registry as M
from repro_torch.serve import step as S

OP_TOL = 1e-5
LOGIT_TOL = 1e-4
DECODE_TOL = 5e-3

PORTED = {"internlm2-1.8b": internlm2_1_8b, "h2o-danube-1.8b": h2o_danube_1_8b,
          "stablelm-3b": stablelm_3b, "gemma3-27b": gemma3_27b,
          "pixtral-12b": pixtral_12b, "dbrx-132b": dbrx_132b,
          "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b_a6_6b,
          "jamba-1.5-large-398b": jamba_1_5_large_398b}
# what the port still refuses of these ids, by id: the audio family on a
# model mesh (queue 1 item 19), and training the ssm and hybrid families (item 18)
REFUSED = ["whisper-small", "mamba2-130m", "jamba-1.5-large-398b"]

# the reduced configs the model tests run, by the cache each decodes on:
# (arch, overrides)
MODELS = {
    "uniform": ("internlm2-1.8b", {}),
    "rolling": ("h2o-danube-1.8b", {"sliding_window": 8}),
    "mha": ("stablelm-3b", {}),
    "period": ("gemma3-27b", {"n_layers": 8}),
    "vlm": ("pixtral-12b", {}),
    # every option of the attention layer at once: bias, soft cap, qk_norm
    "options": ("internlm2-1.8b", {"attn_bias": True, "attn_soft_cap": 5.0,
                                   "qk_norm": True}),
}


def _jitter(tree, seed):
    """Norm scales and biases moved off their init values (ones and
    zeros), so every term is exercised; the same numpy values go to both
    packages."""
    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key in ("scale", "b", "bias"):
            return (node + 0.1 * rng.normal(size=node.shape)).astype(
                node.dtype)
        return node
    return walk(tree)


_MODELS = {}


def _model(kind):
    """(port cfg, reference cfg, port params, reference params), cached."""
    if kind not in _MODELS:
        arch, over = MODELS[kind]
        rcfg = ref_get_config(arch).reduced().replace(**over)
        cfg = get_config(arch).reduced().replace(**over)
        tree = _jitter(jax.tree.map(np.asarray,
                                    RM.init(jax.random.PRNGKey(0), rcfg)), 1)
        _MODELS[kind] = (cfg, rcfg, params_from_numpy(tree, device="cpu"),
                         jax.tree.map(jnp.asarray, tree))
    return _MODELS[kind]


def _tokens(cfg, batch, seq, step=0):
    return TokenDataset(TokenDataConfig(cfg.vocab_size, seq)).sample_batch(
        step, batch)["tokens"]


def _embeds(cfg, batch, seed=3):
    return np.random.default_rng(seed).normal(
        size=(batch, cfg.n_patches, cfg.d_model)).astype(np.float32)


# the reference's decode step, compiled once per config
_ref_decode = jax.jit(RM.decode_step, static_argnums=(3, 4))


def _ref_logits(rparams, batch, rcfg):
    logits, _ = RM.apply(rparams,
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         rcfg, RSH.jigsaw_for(rcfg))
    return np.asarray(logits)


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(PORTED))
def test_config_matches_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert cfg is PORTED[arch].CONFIG
    for mine, theirs in [(cfg, rcfg), (cfg.reduced(), rcfg.reduced())]:
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_param_count_matches_reference(arch):
    """The reference's formula for every id, full and reduced (the ids
    the port refuses through a ModelConfig of the reference's fields)."""
    assert ARCH_IDS == REF_ARCH_IDS
    rcfg = ref_get_config(arch)
    for theirs in (rcfg, rcfg.reduced()):
        mine = ModelConfig(**dataclasses.asdict(theirs))
        assert mine.param_count() == theirs.param_count()
    if arch in PORTED:
        assert get_config(arch).param_count() == rcfg.param_count()
    assert get_config("h2o-danube-1.8b").param_count() == 1_831_201_280


@pytest.mark.parametrize("arch", REFUSED)
def test_unported_ids_still_raise(arch):
    """Every id is served (config, init), and what is still unported
    raises NotImplementedError naming its queue item: whisper-small (the
    audio family, which does not train on a model mesh) on one.  The ssm and hybrid families train: one
    ``loss_fn`` call on a token batch is finite."""
    from repro_torch.data.pipeline import make_source
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.launch.shapes import jigsaw_for
    from repro_torch.train.step import loss_fn
    cfg = get_config(arch).reduced()
    assert ModelConfig(**dataclasses.asdict(
        ref_get_config(arch).reduced())) == cfg
    params = M.init(cfg, device="cpu")
    assert params["embed"]["table"].shape[0] == cfg.vocab_padded
    if cfg.family in ("ssm", "hybrid"):
        batch = {k: torch.from_numpy(v) for k, v in make_source(
            cfg, 2, seq_len=16).full_batch(0, 1).items()}
        loss, _ = loss_fn(params, batch, cfg, jigsaw_for(cfg))
        assert bool(torch.isfinite(loss))
    else:
        with pytest.raises(NotImplementedError, match="item 19"):
            TrainEngine(arch, device="cpu", mesh_model=2,
                        config=EngineConfig(steps=1))


def test_init_tree_matches_reference():
    """The port's own init makes the reference's tree: the same keys,
    shapes and dtypes (bf16 weights, f32 norms), for each cache kind's
    config (tied and untied heads, qk_norm, gelu and swiglu FFNs)."""
    for kind in ("uniform", "rolling", "period", "vlm", "options"):
        arch, over = MODELS[kind]
        over = dict(over, param_dtype="bfloat16")
        mine = params_to_numpy(
            M.init(get_config(arch).reduced().replace(**over), seed=0,
                   device="cpu"), bf16_dtype=jnp.bfloat16)
        rcfg = ref_get_config(arch).reduced().replace(**over)
        theirs = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), rcfg))
        flat_m, flat_r = (jax.tree_util.tree_flatten_with_path(t)[0]
                          for t in (mine, theirs))
        assert [p for p, _ in flat_m] == [p for p, _ in flat_r], kind
        for (path, a), (_, b) in zip(flat_m, flat_r):
            assert (a.shape, a.dtype) == (b.shape, b.dtype), (kind, path)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = get_config("internlm2-1.8b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_cache(cfg, 2, 8)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [10000.0, 1e9])
@pytest.mark.parametrize("two_d", [False, True])
def test_rope_matches_reference(theta, two_d):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = (rng.integers(0, 5000, (2, 7)) if two_d
           else np.arange(7) + 4090).astype(np.int32)
    want = RL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert got.dtype == torch.float32
    _close(got, want, OP_TOL)
    bf = L.rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos), theta)
    assert bf.dtype == torch.bfloat16


def _qkv(b, sq, skv, h, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, hd)).astype(np.float32)
            for s in (sq, skv, skv)]


SDPA_CASES = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=5),
    "bidirectional": dict(causal=False),
    "soft_cap": dict(causal=True, soft_cap=2.0),
    "kv_mask_2d": dict(causal=True, window=6, kv_mask=True, two_d=True),
}


@pytest.mark.parametrize("case", sorted(SDPA_CASES))
def test_sdpa_matches_reference(case):
    kw = dict(SDPA_CASES[case])
    two_d, with_mask = kw.pop("two_d", False), kw.pop("kv_mask", False)
    b, sq, skv = 2, 9, 9
    q, k, v = _qkv(b, sq, skv, 3, 8)
    if two_d:
        # a decode-like step: one query per row against rolled slots
        q = q[:, :1]
        qp = np.array([[7], [3]], np.int32)
        kp = np.stack([np.roll(np.arange(skv) - 1, 2),
                       np.arange(skv) - 5]).astype(np.int32)
    else:
        qp = kp = np.arange(sq, dtype=np.int32)
    rkw, pkw = dict(kw), dict(kw)
    if with_mask:
        mask = (kp >= 0) & (kp <= qp)
        rkw["kv_mask"], pkw["kv_mask"] = jnp.asarray(mask), \
            torch.from_numpy(mask)
    want = RL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   q_pos=jnp.asarray(qp), kv_pos=jnp.asarray(kp), **rkw)
    got = L.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), q_pos=torch.from_numpy(qp),
                 kv_pos=torch.from_numpy(kp), **pkw)
    _close(got, want, OP_TOL)


def test_sdpa_scores_stay_f32_for_bf16_operands():
    """bf16 q and k: the scores are their exact f32 products (as the
    reference's preferred_element_type), so the output equals the f32
    attention of the same bf16 values up to the probabilities' and the
    output's bf16 roundings, and differs from attention whose scores are
    rounded to bf16."""
    q, k, v = (torch.from_numpy(a).bfloat16() * 4 for a in _qkv(1, 16, 16, 2,
                                                                  64))
    pos = torch.arange(16)
    got = L.sdpa(q, k, v, q_pos=pos, kv_pos=pos)
    want = L.sdpa(q.float(), k.float(), v.float(), q_pos=pos, kv_pos=pos)
    rq, rk, rv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v))
    ref = RL.sdpa(rq, rk, rv, q_pos=jnp.asarray(pos.numpy()),
                  kv_pos=jnp.asarray(pos.numpy()))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("sq,qc,kc,window", [(37, 8, 16, None),
                                              (32, 16, 8, 5),
                                              (20, 32, 64, 7)])
def test_sdpa_chunked_matches_reference_and_sdpa(sq, qc, kc, window):
    q, k, v = _qkv(2, sq, sq, 3, 8, seed=1)
    pos = np.arange(sq, dtype=np.int32)
    want = RL.sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
                           window=window, q_chunk=qc, kv_chunk=kc)
    tq, tk, tv, tp = map(torch.from_numpy, (q, k, v, pos))
    got = L.sdpa_chunked(tq, tk, tv, q_pos=tp, kv_pos=tp, window=window,
                         q_chunk=qc, kv_chunk=kc)
    _close(got, want, OP_TOL)
    _close(got, L.sdpa(tq, tk, tv, q_pos=tp, kv_pos=tp, window=window),
           OP_TOL)


def _attn_params(seed, bias):
    tree = jax.tree.map(np.array, RL.attention_init(
        jax.random.PRNGKey(seed), 32, 4, 2, 8, bias=bias))
    tree = _jitter(tree, seed)
    norm = {"q": {"scale": np.random.default_rng(seed).normal(
        size=(8,)).astype(np.float32)},
        "k": {"scale": np.random.default_rng(seed + 1).normal(
            size=(8,)).astype(np.float32)}}
    return tree, norm


ATTN_KW = dict(n_heads=4, n_kv_heads=2, d_head=8)


@pytest.mark.parametrize("variant", ["plain", "qk_norm_bias", "window",
                                     "q_chunk"])
def test_attention_apply_matches_reference(variant):
    """The prefill branch, with collect_kv (the post-RoPE k and v)."""
    tree, norm = _attn_params(2, bias=variant != "plain")
    x = np.random.default_rng(3).normal(size=(2, 11, 32)).astype(np.float32)
    kw = dict(ATTN_KW, collect_kv=True)
    if variant == "qk_norm_bias":
        kw["qk_norm"] = norm
    if variant == "window":
        kw["window"] = 4
    if variant == "q_chunk":
        kw["q_chunk"] = 4
    pos = np.arange(11, dtype=np.int32)

    def run(pkg, conv):
        kk = {k: (jax.tree.map(conv, v) if k == "qk_norm" else v)
              for k, v in kw.items()}
        return pkg.attention_apply(jax.tree.map(conv, tree), conv(x),
                                   positions=conv(pos), **kk)
    want, wkv = run(RL, jnp.asarray)
    got, gkv = run(L, torch.from_numpy)
    _close(got, want, OP_TOL)
    for key in ("k", "v"):
        _close(gkv[key], wkv[key], OP_TOL)


@pytest.mark.parametrize("rolling", [True, False])
def test_attention_apply_decode_matches_reference(rolling):
    """The decode branch on a 5-slot cache, rows at different positions:
    past the slots (the rolling write wraps; the clamped one stays at the
    last slot) and before them.  The cache is written in place."""
    tree, norm = _attn_params(5, bias=True)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 1, 32)).astype(np.float32)
    ck, cv = (rng.normal(size=(3, 5, 2, 8)).astype(np.float32)
              for _ in range(2))
    pos = np.array([7, 2, 4], np.int32)
    kw = dict(ATTN_KW, rolling=rolling, window=4 if rolling else None)

    want, wc = RL.attention_apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
        positions=jnp.asarray(pos[:, None]),
        qk_norm=jax.tree.map(jnp.asarray, norm),
        kv_cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv),
                  "pos": jnp.asarray(pos)}, **kw)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, gc = L.attention_apply(
        jax.tree.map(torch.from_numpy, tree), torch.from_numpy(x),
        positions=torch.from_numpy(pos[:, None]),
        qk_norm=jax.tree.map(torch.from_numpy, norm),
        kv_cache={"k": tk, "v": tv, "pos": torch.from_numpy(pos)}, **kw)
    _close(got, want, OP_TOL)
    assert gc["k"] is tk and gc["v"] is tv
    _close(tk, wc["k"], OP_TOL)
    _close(tv, wc["v"], OP_TOL)
    np.testing.assert_array_equal(gc["pos"].numpy(), np.asarray(wc["pos"]))


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_ffn_apply_matches_reference(kind, kernel):
    tree = jax.tree.map(np.array, RL.ffn_init(jax.random.PRNGKey(7), 32,
                                                48, kind=kind))
    x = np.random.default_rng(8).normal(size=(2, 5, 32)).astype(np.float32)
    want = RL.ffn_apply(jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    got = L.ffn_apply(jax.tree.map(torch.from_numpy, tree),
                      torch.from_numpy(x), jigsaw_for(
                          get_config("gemma3-27b").reduced().replace(
                              kernel=kernel)))
    _close(got, want, OP_TOL)


# ---------------------------------------------------------------------------
# the model: forward, decode, prefill, generation
# ---------------------------------------------------------------------------

def _batch(cfg, batch=2, seq=24, step=0):
    out = {"tokens": _tokens(cfg, batch, seq, step)}
    if cfg.family == "vlm":
        out["embeds"] = _embeds(cfg, batch)
    return out


@pytest.mark.parametrize("kernel", ["xla", "pallas"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_apply_logits_match_reference(kind, kernel):
    """The teacher-forced logits, the port's ``kernel`` against the
    reference's ``kernel="xla"``: S = 40 is past h2o's window (8) and
    gemma3's local window (32)."""
    cfg, rcfg, params, rparams = _model(kind)
    batch = _batch(cfg, seq=40)
    logits, aux = M.apply(params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, cfg,
                          jigsaw_for(cfg.replace(kernel=kernel)))
    n_pre = cfg.n_patches if cfg.family == "vlm" else 0
    assert tuple(logits.shape) == (2, n_pre + 40, cfg.vocab_padded)
    assert float(aux) == 0.0
    _close(logits, _ref_logits(rparams, batch, rcfg), LOGIT_TOL)


def test_sliding_window_takes_effect():
    """h2o with a window of 8: the logits past position 8 differ from the
    same weights' without a window, and the first 8 do not."""
    cfg, _, params, _ = _model("rolling")
    tokens = torch.from_numpy(_tokens(cfg, 2, 20))
    jcfg = jigsaw_for(cfg)
    win, _ = M.apply(params, {"tokens": tokens}, cfg, jcfg)
    full, _ = M.apply(params, {"tokens": tokens},
                      cfg.replace(sliding_window=None), jcfg)
    assert torch.equal(win[:, :8], full[:, :8])
    assert (win[:, 8:] - full[:, 8:]).abs().amax(dim=-1).min() > 1e-3


def test_pallas_forward_launches_nothing_on_the_cpu():
    cfg, _, params, _ = _model("uniform")
    before = BM.block_matmul.launches
    M.apply(params, {"tokens": torch.from_numpy(_tokens(cfg, 1, 8))}, cfg,
            jigsaw_for(cfg.replace(kernel="pallas")))
    assert BM.block_matmul.launches == before


def _decode_all(params, cfg, tokens, max_len, dtype=torch.float32):
    cache = M.init_cache(cfg, tokens.shape[0], max_len, dtype=dtype,
                         device="cpu")
    got = []
    for t in range(tokens.shape[1]):
        logits, cache = M.decode_step(params, cache, tokens[:, t:t + 1], cfg,
                                      jigsaw_for(cfg))
        got.append(logits[:, 0])
    return torch.stack(got, 1), cache


@pytest.mark.parametrize("kind", ["uniform", "rolling", "mha", "period",
                                  "options"])
def test_decode_matches_teacher_forced(kind):
    """The port's own decode consistency (the reference's
    ``test_decode_matches_teacher_forced``): token-wise logits equal the
    teacher-forced forward's at every position, past the windows."""
    cfg, _, params, _ = _model(kind)
    tokens = torch.from_numpy(_tokens(cfg, 2, 40, step=2))
    want, _ = M.apply(params, {"tokens": tokens}, cfg, jigsaw_for(cfg))
    got, _ = _decode_all(params, cfg, tokens, 44)
    _close(got, want, DECODE_TOL)


@pytest.mark.parametrize("kind", ["uniform", "rolling", "period", "options"])
def test_decode_steps_and_cache_match_reference(kind):
    """init_cache's layout, then decode steps against the reference's: the
    logits and every cache buffer after each step (the rolling cache
    wraps, the period cache's global layer and leftover both fill)."""
    cfg, rcfg, params, rparams = _model(kind)
    seq, max_len = 36, 38
    tokens = _tokens(cfg, 2, seq, step=1)
    cache = M.init_cache(cfg, 2, max_len, dtype=torch.float32, device="cpu")
    rcache = RM.init_cache(rcfg, 2, max_len, dtype=jnp.float32)
    assert sorted(cache) == sorted(rcache)
    for k in cache:
        assert tuple(cache[k].shape) == rcache[k].shape
        assert str(cache[k].dtype).removeprefix("torch.") == \
            str(rcache[k].dtype)
    jcfg, rjcfg = jigsaw_for(cfg), RSH.jigsaw_for(rcfg)
    for t in range(seq):
        logits, cache = M.decode_step(params, cache,
                                      torch.from_numpy(tokens[:, t:t + 1]),
                                      cfg, jcfg)
        rlogits, rcache = _ref_decode(rparams, rcache,
                                      jnp.asarray(tokens[:, t:t + 1]), rcfg,
                                      rjcfg)
        _close(logits, rlogits, LOGIT_TOL)
    for k in cache:
        _close(cache[k], rcache[k], LOGIT_TOL)


def test_decode_writes_the_cache_in_place():
    """Every buffer of the local:global cache is written where it lies, and
    the same dict comes back."""
    cfg, _, params, _ = _model("period")
    cache = M.init_cache(cfg, 2, 6, dtype=torch.float32, device="cpu")
    kept = dict(cache)
    out = cache
    for t in range(3):
        _, out = M.decode_step(params, out,
                               torch.full((2, 1), t, dtype=torch.int32), cfg,
                               jigsaw_for(cfg))
    assert out is cache
    for k, v in kept.items():
        assert cache[k] is v and bool(v.any()), k
    assert cache["pos"].tolist() == [3, 3]


def _prompts(cfg, seq, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, seq)).astype(np.int32)


@pytest.mark.parametrize("kind", ["mha", "rolling"])
def test_fused_prefill_parity(kind):
    """The reference's ``test_fused_prefill_parity`` on the port: fused
    against token-wise prefill, and generate's tokens either way."""
    cfg, _, params, _ = _model(kind)
    if kind == "rolling":
        cfg = cfg.replace(sliding_window=64)      # the reduced window
    jcfg = jigsaw_for(cfg)
    prompts = torch.from_numpy(_prompts(cfg, 9))
    n_f, c_f = S.prefill(params, prompts, cfg, jcfg, 24,
                         cache_dtype=torch.float32, fused=True)
    n_t, c_t = S.prefill_tokenwise(params, prompts, cfg, jcfg, 24,
                                   cache_dtype=torch.float32)
    assert torch.equal(n_f, n_t)
    assert torch.equal(c_f["pos"], c_t["pos"])
    for k in ("k", "v"):
        assert torch.allclose(c_f[k], c_t[k], rtol=5e-3, atol=1e-4)
    g_f = S.generate(params, prompts, cfg, jcfg, steps=6, max_len=24,
                     fused=True)
    g_t = S.generate(params, prompts, cfg, jcfg, steps=6, max_len=24,
                     fused=False)
    assert torch.equal(g_f, g_t)


def test_fused_prefill_rolling_overflow_parity():
    """A prompt longer than the rolling window: only the last 8 tokens
    survive, at the slots token-wise writes would have used; and the
    fused cache against the reference's."""
    cfg, rcfg, params, rparams = _model("rolling")
    jcfg = jigsaw_for(cfg)
    prompts = _prompts(cfg, 13, seed=1)
    n_f, c_f = S.prefill(params, torch.from_numpy(prompts), cfg, jcfg, 32,
                         cache_dtype=torch.float32, fused=True)
    n_t, c_t = S.prefill_tokenwise(params, torch.from_numpy(prompts), cfg,
                                   jcfg, 32, cache_dtype=torch.float32)
    assert c_f["k"].shape[2] == 8
    assert torch.equal(n_f, n_t)
    assert torch.allclose(c_f["k"], c_t["k"], rtol=5e-3, atol=1e-4)
    assert torch.allclose(c_f["v"], c_t["v"], rtol=5e-3, atol=1e-4)
    r_n, r_c = RS.prefill(rparams, jnp.asarray(prompts), rcfg,
                          RSH.jigsaw_for(rcfg), 32, cache_dtype=jnp.float32,
                          fused=True)
    np.testing.assert_array_equal(n_f.numpy(), np.asarray(r_n))
    for k in ("pos", "k", "v"):
        _close(c_f[k], r_c[k], LOGIT_TOL)


def test_period_prefill_fused_raises_and_falls_back():
    """gemma3's local:global stack has no fused prefill: ``fused=True``
    raises, ``fused=None`` prefills token by token (the token-wise result
    exactly), and so does ``generate``."""
    cfg, _, params, _ = _model("period")
    jcfg = jigsaw_for(cfg)
    prompts = torch.from_numpy(_prompts(cfg, 9, seed=2))
    with pytest.raises(NotImplementedError, match="local:global"):
        S.prefill(params, prompts, cfg, jcfg, 24, fused=True)
    nxt, cache = S.prefill(params, prompts, cfg, jcfg, 24)
    n_t, c_t = S.prefill_tokenwise(params, prompts, cfg, jcfg, 24)
    assert torch.equal(nxt, n_t)
    for k in cache:
        assert torch.equal(cache[k], c_t[k]), k
    with pytest.raises(NotImplementedError):
        S.generate(params, prompts, cfg, jcfg, steps=3, max_len=24,
                   fused=True)
    assert torch.equal(S.generate(params, prompts, cfg, jcfg, steps=3,
                                  max_len=24),
                       S.generate(params, prompts, cfg, jcfg, steps=3,
                                  max_len=24, fused=False))


def test_vlm_prefill_of_embeds_raises():
    cfg, _, params, _ = _model("vlm")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, seq=4).items()}
    with pytest.raises(NotImplementedError, match="text prompts"):
        M.prefill_cache(params, batch, cfg, jigsaw_for(cfg), 32)


def test_prefill_past_a_full_cache_raises():
    cfg, _, params, _ = _model("uniform")
    with pytest.raises(ValueError, match="max_len"):
        S.prefill(params, torch.from_numpy(_prompts(cfg, 9)), cfg,
                  jigsaw_for(cfg), 8, fused=True)


def test_generate_logits_follow_reference():
    """``generate`` on stablelm (fused prefill, bf16 cache), then the
    decode logits along its token stream against the reference's decode
    step on the same tokens; the fused prefill's next token and cache
    against the reference's."""
    cfg, rcfg, params, rparams = _model("mha")
    jcfg, rjcfg = jigsaw_for(cfg), RSH.jigsaw_for(rcfg)
    prompts = _tokens(cfg, 2, 8, step=4)
    steps = 6
    out = S.generate(params, torch.from_numpy(prompts), cfg, jcfg,
                     steps=steps, max_len=16)
    assert out.shape == (2, steps) and out.dtype == torch.int32
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())
    nxt, cache = S.prefill(params, torch.from_numpy(prompts), cfg, jcfg, 16)
    rnxt, rcache = RS.prefill(rparams, jnp.asarray(prompts), rcfg, rjcfg, 16)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(rnxt))
    for k in ("k", "v"):
        # the f32 k and v agree to ~1e-6; rounded to the bf16 cache, a
        # value at a rounding boundary may take the neighbouring bf16
        # value: one bf16 step (at most 2^-7 relative)
        np.testing.assert_allclose(cache[k].float().numpy(),
                                   np.asarray(rcache[k], np.float32),
                                   rtol=2 ** -7, atol=LOGIT_TOL)
    assert torch.equal(nxt, out[:, :1])
    for i in range(1, steps):
        tok = out[:, i - 1:i]
        logits, cache = M.decode_step(params, cache, tok, cfg, jcfg)
        rlogits, rcache = _ref_decode(rparams, rcache,
                                      jnp.asarray(tok.numpy()), rcfg, rjcfg)
        _close(logits, rlogits, LOGIT_TOL)
        want = torch.argmax(logits[:, -1:, : cfg.vocab_size], -1)
        assert torch.equal(want.to(torch.int32), out[:, i:i + 1])
