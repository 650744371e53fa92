"""The port's ssm family (``mamba2-130m``) against the JAX package's.

The reference's weights (``repro.models.registry.init``, reduced config: 2
layers, d_model 256, 8 SSM heads of 64, state 32, vocab 1024) are carried to
the port by ``repro_torch.convert`` through numpy, and the same token rows
(``TokenDataset``, bit-equal in both packages) go through both.  All f32 on
the CPU, where the port's SSD term is its plain version.  Tolerances: the
RMSNorm and the decode states 1e-5 (the f32 scan's,
``tests/test_torch_ssd.py``); a mixer's output and the logits, whose
largest are ~5, 1e-4 absolute and relative (each an f32 sum over d_inner
or d_model in another order than XLA's, after the scan); decode against
teacher-forced 5e-3, the reference's own
(``tests/test_decode_consistency.py``).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.data.tokens import TokenDataConfig as RefTokenDataConfig
from repro.data.tokens import TokenDataset as RefTokenDataset
from repro.launch import shapes as RSH
from repro.models import layers as RL
from repro.models import registry as RM
from repro.serve import step as RS
from repro_torch.configs import mamba2_130m
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.tokens import TokenDataConfig, TokenDataset
from repro_torch.kernels import block_matmul as BM
from repro_torch.kernels import ssd_chunk as SSD
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import layers as L
from repro_torch.models import mamba
from repro_torch.models import registry as M
from repro_torch.serve import step as S

STATE_TOL = 1e-5
LOGIT_TOL = 1e-4
DECODE_TOL = 5e-3


@pytest.fixture(scope="module")
def model():
    """(port cfg, reference cfg, port params, reference params)."""
    rcfg = ref_get_config("mamba2-130m").reduced()
    cfg = get_config("mamba2-130m").reduced()
    rparams = RM.init(jax.random.PRNGKey(0), rcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, rparams),
                               device="cpu")
    return cfg, rcfg, params, rparams


def _tokens(cfg, batch, seq, step=0):
    return TokenDataset(TokenDataConfig(cfg.vocab_size, seq)).sample_batch(
        step, batch)["tokens"]


# the reference's decode step, compiled once per config (eager, each step
# would trace anew)
_ref_decode = jax.jit(RM.decode_step, static_argnums=(3, 4))


def _ref_logits(rparams, tokens, rcfg):
    logits, _ = RM.apply(rparams, {"tokens": jnp.asarray(tokens)}, rcfg,
                         RSH.jigsaw_for(rcfg))
    return np.asarray(logits)


# ---------------------------------------------------------------------------
# configs, data, weights
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    cfg, rcfg = get_config("mamba2-130m"), ref_get_config("mamba2-130m")
    assert cfg == mamba2_130m.CONFIG
    for mine, theirs in [(cfg, rcfg), (cfg.reduced(), rcfg.reduced())]:
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
    assert cfg.vocab_padded == 50432 and cfg.ssm_d_inner == 1536
    # the reference's count, which leaves out the 24 conv biases of 1792
    assert cfg.param_count() == 129_057_216


def test_lm_on_a_model_mesh_still_raises():
    """The audio family on a model mesh raises, naming its queue item
    (item 19; the dense and VLM families train there)."""
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    with pytest.raises(NotImplementedError, match="item 19"):
        TrainEngine("whisper-small", device="cpu", mesh_model=2,
                    config=EngineConfig(steps=1))


@pytest.mark.parametrize("vocab,seq,seed,step,batch", [
    (1024, 64, 0, 0, 3), (50280, 128, 5, 7, 2), (17, 33, 1, 2, 4)])
def test_token_rows_match_reference(vocab, seq, seed, step, batch):
    mine = TokenDataset(TokenDataConfig(vocab, seq, seed=seed))
    theirs = RefTokenDataset(RefTokenDataConfig(vocab, seq, seed=seed))
    got, want = mine.sample_batch(step, batch), theirs.sample_batch(step,
                                                                   batch)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_is_bit_exact(dtype):
    rcfg = ref_get_config("mamba2-130m").reduced().replace(param_dtype=dtype)
    tree = jax.tree.map(np.asarray, RM.init(jax.random.PRNGKey(1), rcfg))
    params = params_from_numpy(tree, device="cpu")
    assert isinstance(params["layers"], list)
    assert len(params["layers"]) == rcfg.n_layers
    assert params["embed"]["table"].dtype == getattr(torch, dtype)
    back = params_to_numpy(params, bf16_dtype=jnp.bfloat16)
    flat_t, flat_b = (jax.tree_util.tree_flatten_with_path(t)[0]
                      for t in (tree, back))
    assert [p for p, _ in flat_t] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_t, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_init_tree_matches_reference():
    """The port's own init makes the reference's tree: the same keys,
    shapes and dtypes (bf16 weights, f32 A_log, D, dt_bias and residual
    norms under the full config's legacy dtypes)."""
    cfg = get_config("mamba2-130m").reduced().replace(param_dtype="bfloat16")
    rcfg = ref_get_config("mamba2-130m").reduced().replace(
        param_dtype="bfloat16")
    mine = params_to_numpy(M.init(cfg, seed=0, device="cpu"),
                           bf16_dtype=jnp.bfloat16)
    theirs = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), rcfg))
    flat_m, flat_r = (jax.tree_util.tree_flatten_with_path(t)[0]
                      for t in (mine, theirs))
    assert [p for p, _ in flat_m] == [p for p, _ in flat_r]
    for (path, a), (_, b) in zip(flat_m, flat_r):
        assert (a.shape, a.dtype) == (b.shape, b.dtype), path


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = get_config("mamba2-130m").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.init_cache(cfg, 2, 8)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 40)).astype(np.float32)
    scale = rng.normal(size=(40,)).astype(np.float32)
    got = L.rmsnorm_apply({"scale": torch.from_numpy(scale)},
                          torch.from_numpy(x)).numpy()
    want = RL.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=STATE_TOL,
                               atol=STATE_TOL)


def _mixer_kw(cfg):
    return dict(d_state=cfg.ssm_state, n_heads=cfg.ssm_heads,
                head_dim=cfg.ssm_head_dim, n_groups=cfg.ssm_groups,
                conv_kernel=cfg.ssm_conv, chunk=cfg.ssm_chunk)


@pytest.mark.parametrize("seq", [128, 100])
@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_mamba2_apply_prefill_matches_reference(model, seq, kernel):
    cfg, rcfg, params, rparams = model
    x = np.random.default_rng(5).normal(size=(2, seq, cfg.d_model)).astype(
        np.float32)
    rp = jax.tree.map(lambda a: a[0], rparams["layers"]["mixer"])
    want, _ = RL.mamba2_apply(rp, jnp.asarray(x), cfg=RSH.jigsaw_for(rcfg),
                              **_mixer_kw(rcfg))
    got, state = L.mamba2_apply(params["layers"][0]["mixer"],
                                torch.from_numpy(x),
                                cfg=jigsaw_for(cfg).replace(kernel=kernel),
                                **_mixer_kw(cfg))
    assert state is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)


def test_mamba2_apply_decode_matches_reference(model):
    """One token against a non-zero state: the output and both new
    states."""
    cfg, rcfg, params, rparams = model
    rng = np.random.default_rng(6)
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    x = rng.normal(size=(3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(3, cfg.ssm_conv - 1, conv_dim)).astype(np.float32)
    ssm = rng.normal(size=(3, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state)).astype(np.float32)
    rp = jax.tree.map(lambda a: a[1], rparams["layers"]["mixer"])
    want, wstate = RL.mamba2_apply(
        rp, jnp.asarray(x), cfg=RSH.jigsaw_for(rcfg),
        state={"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)},
        **_mixer_kw(rcfg))
    got, gstate = L.mamba2_apply(
        params["layers"][1]["mixer"], torch.from_numpy(x),
        cfg=jigsaw_for(cfg),
        state={"conv": torch.from_numpy(conv), "ssm": torch.from_numpy(ssm)},
        **_mixer_kw(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for k in ("conv", "ssm"):
        assert gstate[k].dtype == torch.float32
        np.testing.assert_allclose(gstate[k].numpy(), np.asarray(wstate[k]),
                                   rtol=STATE_TOL, atol=STATE_TOL)


# ---------------------------------------------------------------------------
# the model: forward, decode, generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [128, 100])
@pytest.mark.parametrize("kernel", ["xla", "pallas"])
def test_apply_logits_match_reference(model, seq, kernel):
    cfg, rcfg, params, rparams = model
    tokens = _tokens(cfg, 2, seq)
    logits, aux = M.apply(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                          jigsaw_for(cfg).replace(kernel=kernel))
    assert logits.shape == (2, seq, cfg.vocab_padded) and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(),
                               _ref_logits(rparams, tokens, rcfg),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_pallas_forward_launches_nothing_on_the_cpu(model):
    cfg, _, params, _ = model
    before = (SSD.ssd_intra_chunk.launches, BM.block_matmul.launches)
    M.apply(params, {"tokens": torch.from_numpy(_tokens(cfg, 1, 64))}, cfg,
            jigsaw_for(cfg).replace(kernel="pallas"))
    assert (SSD.ssd_intra_chunk.launches, BM.block_matmul.launches) == before


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_steps_and_cache_match_reference(model, cache_dtype):
    """init_cache's state, then twelve decode steps: the logits and the
    conv and SSM states after each.  With a bf16 cache and f32 activations
    the reference's conv window promotes to f32 at the first step; the
    port's ``init_cache`` makes it f32 at once (the dtype the step writes,
    so the step writes in place), and equal to the reference's after
    every step."""
    cfg, rcfg, params, rparams = model
    tokens = _tokens(cfg, 2, 12, step=1)
    cache = M.init_cache(cfg, 2, 14, dtype=getattr(torch, cache_dtype),
                         device="cpu")
    rcache = RM.init_cache(rcfg, 2, 14, dtype=getattr(jnp, cache_dtype))
    for k in ("pos", "conv", "ssm"):
        assert tuple(cache[k].shape) == rcache[k].shape
        want = "float32" if k == "conv" else str(rcache[k].dtype)
        assert str(cache[k].dtype).removeprefix("torch.") == want
        assert not cache[k].any()
    jcfg, rjcfg = jigsaw_for(cfg), RSH.jigsaw_for(rcfg)
    for t in range(12):
        logits, cache = M.decode_step(params, cache,
                                      torch.from_numpy(tokens[:, t:t + 1]),
                                      cfg, jcfg)
        rlogits, rcache = _ref_decode(rparams, rcache,
                                      jnp.asarray(tokens[:, t:t + 1]), rcfg,
                                      rjcfg)
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        for k in ("conv", "ssm"):
            assert str(cache[k].dtype).removeprefix("torch.") == \
                str(rcache[k].dtype)
            np.testing.assert_allclose(cache[k].float().numpy(),
                                       np.asarray(rcache[k], np.float32),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(rcache["pos"]))


def test_decode_matches_teacher_forced(model):
    """The port's own decode consistency, as the reference's
    ``test_decode_matches_teacher_forced``: token-wise logits equal the
    teacher-forced forward's at every position."""
    cfg, _, params, _ = model
    tokens = torch.from_numpy(_tokens(cfg, 2, 12, step=2))
    jcfg = jigsaw_for(cfg)
    want, _ = M.apply(params, {"tokens": tokens}, cfg, jcfg)
    cache = M.init_cache(cfg, 2, 14, dtype=torch.float32, device="cpu")
    got = []
    for t in range(12):
        logits, cache = M.decode_step(params, cache, tokens[:, t:t + 1], cfg,
                                      jcfg)
        got.append(logits[:, 0])
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def test_generate_matches_reference(model):
    """Greedy generation (token-wise prefill, then decode steps, bf16
    cache): the tokens agree with the reference's up to the first position
    where the reference's top-2 logit margin is within the tolerance, and
    nowhere else may they differ."""
    cfg, rcfg, params, rparams = model
    prompts = _tokens(cfg, 2, 16, step=3)
    steps = 8
    got = S.generate(params, torch.from_numpy(prompts), cfg, jigsaw_for(cfg),
                     steps=steps, max_len=32).numpy()
    want = np.asarray(RS.generate(rparams, jnp.asarray(prompts), rcfg,
                                  RSH.jigsaw_for(rcfg), steps=steps,
                                  max_len=32))
    assert got.shape == want.shape == (2, steps) and got.dtype == np.int32
    assert ((got >= 0) & (got < cfg.vocab_size)).all()
    # the reference's logits along its own continuation
    seq = np.concatenate([prompts, want], axis=1)
    logits = _ref_logits(rparams, seq, rcfg)[:, prompts.shape[1] - 1:-1,
                                             : cfg.vocab_size]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    for r in range(2):
        differ = np.flatnonzero(got[r] != want[r])
        if differ.size:
            assert margin[r, differ[0]] <= LOGIT_TOL, (r, differ[0])


def test_generate_logits_follow_reference(model):
    """The decode step's logits along a greedy continuation, step by step
    against the reference's (bf16 cache, as ``generate`` uses)."""
    cfg, rcfg, params, rparams = model
    prompts = _tokens(cfg, 2, 8, step=4)
    nxt, cache = S.prefill(params, torch.from_numpy(prompts), cfg,
                           jigsaw_for(cfg), 16)
    rnxt, rcache = RS.prefill(rparams, jnp.asarray(prompts), rcfg,
                              RSH.jigsaw_for(rcfg), 16)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(rnxt))
    for _ in range(4):
        logits, cache = M.decode_step(params, cache, nxt, cfg,
                                      jigsaw_for(cfg))
        rlogits, rcache = _ref_decode(rparams, rcache, jnp.asarray(
            nxt.numpy()), rcfg, RSH.jigsaw_for(rcfg))
        np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        nxt = torch.argmax(logits[:, -1:, : cfg.vocab_size], -1).to(
            torch.int32)


def test_prefill_has_no_fused_path():
    cfg = get_config("mamba2-130m").reduced()
    with pytest.raises(NotImplementedError, match="fused prefill"):
        M.prefill_cache(None, {}, cfg, jigsaw_for(cfg), 8)
    with pytest.raises(NotImplementedError, match="fused prefill"):
        S.prefill(None, torch.zeros((1, 2), dtype=torch.int32), cfg,
                  jigsaw_for(cfg), 8, fused=True)


def test_module_decode_promotes_bf16_conv_cache(model):
    """With f32 activations a bf16 cache's conv window is f32 (the
    reference's concatenate promotes it at the first step; ``init_cache``
    makes it so at once), and the step writes the conv window and the SSM
    state in place; a narrower window than the step writes raises."""
    cfg, _, params, _ = model
    cache = mamba.init_cache(cfg, 1, 4, device="cpu")
    conv, ssm = cache["conv"], cache["ssm"]
    assert conv.dtype == torch.float32
    _, cache = mamba.decode_step(params, cache,
                                 torch.zeros((1, 1), dtype=torch.int32), cfg)
    assert cache["conv"] is conv and conv.any()
    assert cache["ssm"] is ssm and ssm.any()
    assert int(cache["pos"][0]) == 1
    cache["conv"] = conv.to(torch.bfloat16)
    with pytest.raises(TypeError, match="init_cache"):
        mamba.decode_step(params, cache,
                          torch.zeros((1, 1), dtype=torch.int32), cfg)
