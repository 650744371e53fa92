"""The port's enc-dec family (``whisper-small``) and attention's cross and
bidirectional branches against the JAX package's.

The reference's weights (``repro.models.registry.init`` of the reduced
config: d_model 256, 4 heads, 2 KV heads, 2 encoder and 2 decoder layers,
64 frames, vocab 1024) are carried to the port by ``repro_torch.convert``
through numpy, with every norm scale and bias moved off its init value;
the same numpy frames and ``TokenDataset`` rows go through both.  All f32
on the CPU, where block_matmul is its plain version.

Tolerances (as ``tests/test_torch_transformer.py``):
  * ``attention_apply``'s new branches and ``sdpa_chunked`` at F != S:
    1e-5 absolute and relative (the same f32 operations; only the order of
    the f32 sums over d_head, the keys and d_model differs, ~1e-7
    relative);
  * the encoder's sinusoids: two f32 ulps of the largest angle (see the
    test);
  * the old branches: bit for bit the layer as it was written before the
    branches were added (``_old_attention``, the same calls in the same
    order);
  * ``encode`` and the logits (the largest ~5): 1e-4, each an f32 sum over
    d_model or d_ff in another order than XLA's, through four layers;
  * decode against the teacher-forced forward: 5e-3, the reference's own
    (``tests/test_decode_consistency.py``); against the reference's decode
    step: the logits bound;
  * ``generate``: the tokens equal.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.launch import shapes as RSH
from repro.models import encdec as RE
from repro.models import layers as RL
from repro.models import registry as RM
from repro.serve import step as RS
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import tree as ptree
from repro_torch.data.tokens import TokenDataConfig, TokenDataset
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import registry as M
from repro_torch.serve import step as S
from test_torch_graphs import StandInGraph

OP_TOL = 1e-5
LOGIT_TOL = 1e-4
DECODE_TOL = 5e-3
ARCH = "whisper-small"


def _jitter(tree, seed):
    """Norm scales and biases moved off their init values (ones and
    zeros); the same numpy values go to both packages."""
    rng = np.random.default_rng(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if key in ("scale", "b", "bias"):
            return (node + 0.1 * rng.normal(size=node.shape)).astype(
                node.dtype)
        return node
    return walk(tree)


_MODEL = {}


def _model():
    """(port cfg, reference cfg, port params, reference params), cached."""
    if not _MODEL:
        rcfg = ref_get_config(ARCH).reduced()
        cfg = get_config(ARCH).reduced()
        tree = _jitter(jax.tree.map(np.asarray,
                                    RM.init(jax.random.PRNGKey(0), rcfg)), 1)
        _MODEL["m"] = (cfg, rcfg, params_from_numpy(tree, device="cpu"),
                       jax.tree.map(jnp.asarray, tree))
    return _MODEL["m"]


def _frames(cfg, batch, seed=2):
    return np.random.default_rng(seed).normal(
        size=(batch, cfg.n_frames, cfg.d_model)).astype(np.float32)


def _tokens(cfg, batch, seq, step=0):
    return TokenDataset(TokenDataConfig(cfg.vocab_size, seq)).sample_batch(
        step, batch)["tokens"]


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# config, init, convert
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    want = ref_get_config(ARCH)
    got = get_config(ARCH)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count() == 241_294_080
    assert got.reduced().param_count() == want.reduced().param_count()
    assert M.module_for(got) is E


def test_init_tree_matches_reference_at_full_size():
    """The port's own init makes the reference's tree at the published
    size (the reference's through ``jax.eval_shape``): the same keys, each
    layer list the reference's stacked leading dim, the same shapes and
    dtypes (bf16 weights, f32 norms)."""
    cfg = get_config(ARCH)
    want = jax.eval_shape(lambda k: RM.init(k, ref_get_config(ARCH)),
                          jax.random.PRNGKey(0))
    params = M.init(cfg, seed=0, device="cpu")
    assert len(params["enc_layers"]) == cfg.n_enc_layers == 12
    assert len(params["dec_layers"]) == cfg.n_layers == 12

    def spec(*ts):
        lead = (len(ts),) if len(ts) > 1 else ()
        return lead + tuple(ts[0].shape), str(ts[0].dtype).split(".")[-1]
    got = {k: ptree.map(spec, *v) if isinstance(v, list)
           else ptree.map(spec, v) for k, v in params.items()}
    assert got == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                               want)
    assert got["dec_layers"]["cross"]["wq"]["w"] == ((12, 768, 768),
                                                     "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_is_bit_exact(dtype):
    rcfg = ref_get_config(ARCH).reduced().replace(param_dtype=dtype)
    tree = jax.tree.map(np.asarray, RM.init(jax.random.PRNGKey(1), rcfg))
    params = params_from_numpy(tree, device="cpu")
    assert isinstance(params["enc_layers"], list)
    assert isinstance(params["dec_layers"], list)
    back = params_to_numpy(params, bf16_dtype=tree["embed"]["table"].dtype)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# attention's new branches; the old ones unchanged
# ---------------------------------------------------------------------------

def _attn_params(seed, d=64, h=4, hkv=2, hd=16, bias=True):
    return jax.tree.map(np.asarray, RL.attention_init(
        jax.random.PRNGKey(seed), d, h, hkv, hd, dtype=jnp.float32,
        bias=bias))


def _port(tree):
    return ptree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("q_chunk", [0, 4])
@pytest.mark.parametrize("cross", [True, False])
def test_attention_cross_and_bidirectional_match_reference(q_chunk, cross):
    """Cross-attention (64 frames of keys against 12 tokens of queries)
    and bidirectional self-attention, through ``sdpa`` (q_chunk 0) and
    ``sdpa_chunked`` (q_chunk 4, kv_chunk 1024: one ragged kv chunk),
    against the reference's ``attention_apply``.  Unmasked, the ragged
    chunk's zero-padded keys take part in the reference's softmax (only a
    causal or window mask hides them); the port does the same."""
    rng = np.random.default_rng(5)
    tree = _attn_params(3)
    x = rng.normal(size=(2, 12, 64)).astype(np.float32)
    enc = rng.normal(size=(2, 64, 64)).astype(np.float32)
    kw = dict(n_heads=4, n_kv_heads=2, d_head=16, causal=False,
              rope_theta=None, q_chunk=q_chunk)
    want, _ = RL.attention_apply(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x),
        positions=jnp.arange(12), x_kv=jnp.asarray(enc) if cross else None,
        **kw)
    got, _ = L.attention_apply(
        _port(tree), torch.from_numpy(x), positions=torch.arange(12),
        x_kv=torch.from_numpy(enc) if cross else None, **kw)
    _close(got, want, OP_TOL)


def test_sdpa_chunked_at_other_kv_length_matches_sdpa_and_reference():
    """``sdpa_chunked`` with 64 keys against 12 queries (q_chunk 4,
    kv_chunk 16: four kv chunks), unmasked and causal, against the port's
    ``sdpa`` and the reference's ``sdpa_chunked``."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    v = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)
    qp, kp = np.arange(40, 52), np.arange(64)
    t = {n: torch.from_numpy(a) for n, a in
         dict(q=q, k=k, v=v, qp=qp, kp=kp).items()}
    for causal in (False, True):
        got = L.sdpa_chunked(t["q"], t["k"], t["v"], q_pos=t["qp"],
                             kv_pos=t["kp"], causal=causal, q_chunk=4,
                             kv_chunk=16)
        plain = L.sdpa(t["q"], t["k"], t["v"], q_pos=t["qp"],
                       kv_pos=t["kp"], causal=causal)
        want = RL.sdpa_chunked(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), q_pos=jnp.asarray(qp),
                               kv_pos=jnp.asarray(kp), causal=causal,
                               q_chunk=4, kv_chunk=16)
        _close(got, plain, OP_TOL)
        _close(got, want, OP_TOL)


def _old_attention(params, x, *, n_heads, n_kv_heads, d_head, positions,
                   window=None, rope_theta=10000.0, soft_cap=None,
                   qk_norm=None, q_chunk=0):
    """The training / prefill branch of ``attention_apply`` as it was
    before ``causal`` and ``x_kv`` (the same calls in the same order)."""
    from repro_torch.core.api import linear_apply
    b, s, _ = x.shape
    q = linear_apply(params["wq"], x).reshape(b, s, n_heads, d_head)
    k = linear_apply(params["wk"], x).reshape(b, s, n_kv_heads, d_head)
    v = linear_apply(params["wv"], x).reshape(b, s, n_kv_heads, d_head)
    if qk_norm is not None:
        q = L.rmsnorm_apply(qk_norm["q"], q)
        k = L.rmsnorm_apply(qk_norm["k"], k)
    if rope_theta is not None:
        q = L.rope(q, positions, rope_theta)
        k = L.rope(k, positions, rope_theta)
    n_rep = n_heads // n_kv_heads
    kk, vv = L._repeat_kv(k, n_rep), L._repeat_kv(v, n_rep)
    if q_chunk and positions.ndim == 1 and soft_cap is None:
        out = L.sdpa_chunked(q, kk, vv, q_pos=positions, kv_pos=positions,
                             window=window, q_chunk=q_chunk)
    else:
        out = L.sdpa(q, kk, vv, q_pos=positions, kv_pos=positions,
                     window=window, soft_cap=soft_cap)
    out = out.reshape(b, s, n_heads * d_head)
    return linear_apply(params["wo"], out)


@pytest.mark.parametrize("opts", [
    dict(), dict(q_chunk=4), dict(window=5), dict(window=5, q_chunk=4),
    dict(soft_cap=5.0, qk_norm=True), dict(rope_theta=None)])
def test_causal_self_attention_is_bitwise_unchanged(opts):
    """Every existing caller's call (``causal`` and ``x_kv`` left at their
    defaults) gives bit for bit what the layer gave before they existed."""
    opts = dict(opts)
    rng = np.random.default_rng(11)
    params = _port(_attn_params(4))
    if opts.pop("qk_norm", False):
        opts["qk_norm"] = {n: {"scale": torch.from_numpy(
            1 + 0.1 * rng.normal(size=16).astype(np.float32))}
            for n in ("q", "k")}
    x = torch.from_numpy(rng.normal(size=(2, 12, 64)).astype(np.float32))
    kw = dict(n_heads=4, n_kv_heads=2, d_head=16,
              positions=torch.arange(12), **opts)
    got, _ = L.attention_apply(params, x, **kw)
    assert torch.equal(got, _old_attention(params, x, **kw))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_sinusoids_match_reference():
    """The angles are ``position * inv`` in f32, where ``inv`` comes from
    each library's f32 ``exp``: one ulp apart there moves an angle near
    1,500 by up to one f32 ulp of 1,500 (2^-13), and its sine and cosine
    by as much.  Held to two such ulps."""
    got, want = E.sinusoids(1500, 768), np.asarray(RE.sinusoids(1500, 768))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 * 2 ** -13)


def test_encode_and_logits_match_reference():
    cfg, rcfg, params, rparams = _model()
    frames = _frames(cfg, 2)
    tokens = _tokens(cfg, 2, 12)
    want_enc = RE.encode(rparams, jnp.asarray(frames), rcfg,
                         RSH.jigsaw_for(rcfg))
    got_enc = E.encode(params, torch.from_numpy(frames), cfg,
                       jigsaw_for(cfg))
    _close(got_enc, want_enc, LOGIT_TOL)
    batch = {"frames": frames, "tokens": tokens}
    want, waux = RM.apply(rparams, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                          rcfg, RSH.jigsaw_for(rcfg))
    got, aux = M.apply(params, {k: torch.from_numpy(v)
                                for k, v in batch.items()},
                       cfg, jigsaw_for(cfg))
    assert got.shape == (2, 12, cfg.vocab_padded)
    _close(got, want, LOGIT_TOL)
    assert float(aux) == float(waux) == 0.0


def test_positions_past_the_table_wrap_as_reference():
    """A decoder sequence longer than the 4,096-row position table reads
    it at ``position % 4096``, as the reference: the positions one table
    apart are the same rows."""
    cfg, _, params, rparams = _model()
    pos = torch.tensor([0, 5, 4095, 4096, 4101, 9000])
    got = E._dec_pos(params, pos, torch.float32)
    want = np.asarray(rparams["dec_pos"])[pos.numpy() % 4096]
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_matches_teacher_forced_and_reference_decode():
    """The reference's ``test_decode_matches_teacher_forced`` contract for
    ``whisper-small``: token by token on a cache whose "enc" holds the
    encoder's states, against the teacher-forced logits (5e-3), and every
    step against the reference's decode step (1e-4), the caches too."""
    cfg, rcfg, params, rparams = _model()
    jcfg, rjcfg = jigsaw_for(cfg), RSH.jigsaw_for(rcfg)
    frames = _frames(cfg, 2)
    tokens = _tokens(cfg, 2, 12, step=1)
    teacher, _ = M.apply(params, {"frames": torch.from_numpy(frames),
                                  "tokens": torch.from_numpy(tokens)},
                         cfg, jcfg)
    cache = M.init_cache(cfg, 2, 14, dtype=torch.float32, device="cpu")
    cache["enc"].copy_(E.encode(params, torch.from_numpy(frames), cfg,
                                jcfg))
    rcache = RM.init_cache(rcfg, 2, 14, dtype=jnp.float32)
    rcache["enc"] = RE.encode(rparams, jnp.asarray(frames), rcfg,
                              rjcfg).astype(jnp.float32)
    step = jax.jit(RM.decode_step, static_argnums=(3, 4))
    got = []
    for t in range(12):
        tok = tokens[:, t:t + 1]
        logits, cache = M.decode_step(params, cache, torch.from_numpy(tok),
                                      cfg, jcfg)
        rlogits, rcache = step(rparams, rcache, jnp.asarray(tok), rcfg,
                               rjcfg)
        _close(logits, rlogits, LOGIT_TOL)
        got.append(logits[:, 0])
    _close(torch.stack(got, dim=1), teacher.detach().numpy(), DECODE_TOL)
    for k in ("k", "v", "enc"):
        _close(cache[k], rcache[k], LOGIT_TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(rcache["pos"]))


def test_generate_with_frames_matches_reference():
    """``generate(..., extra_batch={"frames"})`` eagerly on the CPU: token
    for token the reference's, from 4-token prompts; ``fused=True``
    raises, as the reference's, and ``fused=None`` goes token-wise."""
    cfg, rcfg, params, rparams = _model()
    frames = _frames(cfg, 2, seed=4)
    prompts = _tokens(cfg, 2, 4, step=2)
    want = RS.generate(rparams, jnp.asarray(prompts), rcfg,
                       RSH.jigsaw_for(rcfg), steps=8, max_len=16,
                       extra_batch={"frames": jnp.asarray(frames)})
    extra = {"frames": torch.from_numpy(frames)}
    got = S.generate(params, torch.from_numpy(prompts), cfg,
                     jigsaw_for(cfg), steps=8, max_len=16,
                     extra_batch=extra)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(NotImplementedError, match="enc-dec"):
        S.prefill(params, torch.from_numpy(prompts), cfg, jigsaw_for(cfg),
                  16, extra_batch=extra, fused=True)
    # without frames the encoder's states stay zeros, as in the reference
    nxt, cache = S.prefill(params, torch.from_numpy(prompts), cfg,
                           jigsaw_for(cfg), 16)
    assert not cache["enc"].any() and int(cache["pos"][0]) == 4


def test_graphed_generate_on_stand_in_loads_the_encoder_states(monkeypatch):
    """The graphed path (the stand-in graph of ``test_torch_graphs.py``,
    the device check lifted): the captured step's static cache gets the
    encoder's states before the prompt replays, so its tokens are the
    eager loop's bit for bit, and differ from a run on other frames."""
    monkeypatch.setattr(S, "CountedGraph", StandInGraph)
    monkeypatch.setattr(S, "_check_cuda", lambda t, msg: None)
    S.clear_graphs()
    cfg = get_config(ARCH).reduced()
    jcfg = jigsaw_for(cfg)
    params = M.init(cfg, seed=3, device="cpu")
    prompts = torch.tensor([[1, 5, 9, 2], [4, 4, 8, 0]], dtype=torch.int32)
    frames = torch.from_numpy(_frames(cfg, 2, seed=6) * 3)
    kw = dict(steps=6, max_len=16, extra_batch={"frames": frames})
    want = S.generate(params, prompts, cfg, jcfg, graph=False, **kw)
    got = S.generate(params, prompts, cfg, jcfg, graph=True, **kw)
    assert torch.equal(got, want)
    (g,) = S._GRAPHS.values()
    assert g.graph.graph.replays == 5 + prompts.shape[1]
    assert torch.equal(g.cache["enc"], E.encode(params, frames, cfg, jcfg)
                       .to(g.cache["enc"].dtype))
    S.clear_graphs()


def test_pallas_calls_per_forward_and_step(monkeypatch):
    """Under ``kernel="pallas"`` every linear is a block_matmul call: the
    forward makes 6 an encoder layer (q, k, v, o, fc1 with its GELU, fc2),
    10 a decoder layer (the cross-attention's four too) and the head; a
    decode step 10 a decoder layer and the head (the encoder ran once,
    before the prompt).  Counted on the CPU at the wrapper's call site."""
    from repro_torch.kernels import ops
    calls = []
    real = ops.block_matmul

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(ops, "block_matmul", counting)
    cfg = get_config(ARCH).reduced().replace(kernel="pallas")
    jcfg = jigsaw_for(cfg)
    params = M.init(cfg, seed=0, device="cpu")
    frames = torch.from_numpy(_frames(cfg, 2))
    tokens = torch.from_numpy(_tokens(cfg, 2, 6))
    with torch.no_grad():
        M.apply(params, {"frames": frames, "tokens": tokens}, cfg, jcfg)
        assert len(calls) == 6 * cfg.n_enc_layers + 10 * cfg.n_layers + 1
        cache = M.init_cache(cfg, 2, 8, dtype=torch.float32, device="cpu")
        calls.clear()
        M.decode_step(params, cache, tokens[:, :1], cfg, jcfg)
        assert len(calls) == 10 * cfg.n_layers + 1
