"""CUDA graphs of the port's serving steps, and the counters they keep.

* ``kernels/graphs.py::CountedGraph``'s counter arithmetic with a stand-in
  graph on the CPU: a capture leaves every kernel's launch counters as
  they were (nothing ran), each replay adds what the capture recorded.
* The same plumbing end to end on the CPU, with the stand-in graph in
  place of ``torch.cuda.CUDAGraph`` (its "replay" runs the captured
  function again): the forecast engine's per-bucket graphs and
  ``serve.step``'s captured decode step give the eager engine's and
  decode loop's outputs bit for bit, with no capture after ``warmup()``.
* ``generate``'s graphed path on the CPU with the stand-in graph, for the
  ssm family (its token-wise prefill replays the captured step), the
  transformer family's uniform, rolling and local:global caches (the
  fused prefill, or the token-wise one where it raises), the moe family's
  and the hybrid's nested per-slot cache: the tokens of the eager loop
  bit for bit, one capture per cache layout; ``cache_layout``'s key of a
  flat cache as it was, and of a nested one by path.
* ``models/mamba.py::init_cache`` makes the conv window in the dtype the
  decode step writes, and the eager decode's logits and tokens are those
  of the step before that change (the window promoted at the first step).
* On the card (marked ``cuda``; skips here): graphed against eager for
  both steps, for the transformer's decode on each kind of KV cache, for
  the hybrid's nested cache and for whisper's (the encoder's states
  loaded into the static cache), bit for bit, the launches counted by
  replay.
"""
import collections
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import tree as ptree
from repro_torch.kernels import block_matmul as BM
from repro_torch.kernels import graphs as G
from repro_torch.kernels import ssd_chunk as SSD
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import layers as L
from repro_torch.models import mamba
from repro_torch.models import registry as M
from repro_torch.serve import engine as E
from repro_torch.serve import step as S


class Rerun:
    """A stand-in for ``torch.cuda.CUDAGraph``: replay runs the captured
    function again and writes its result where the capture's went."""

    def __init__(self):
        self.fn = self.out = None
        self.replays = 0

    def replay(self):
        self.replays += 1
        got = self.fn()
        if got is not self.out:
            self.out.copy_(got)


class StandInGraph(G.CountedGraph):
    """CountedGraph on the CPU: the capture runs ``fn`` once (no stream
    capture), the stand-in's replay runs it again."""

    def __init__(self):
        super().__init__(graph=Rerun())

    @contextmanager
    def _capturing(self, pool):
        yield

    def capture(self, fn, pool=None):
        out = super().capture(fn, pool)
        self.graph.fn, self.graph.out = fn, out
        return out


@pytest.fixture
def counters():
    """Every wrapper's counters saved and restored around a test."""
    kept = G.snapshot()
    yield
    G.apply(kept, add=False)


def _launch(n, layout=(False, False), route="sm90", ssd=0):
    """What n launches of block_matmul (and ``ssd`` of the ssd kernel)
    add to their counters."""
    BM.block_matmul.launches += n
    BM.block_matmul.layout_launches[layout] += n
    BM.block_matmul.route_launches[route] += n
    SSD.ssd_intra_chunk.launches += ssd
    SSD.ssd_intra_chunk.route_launches["heads.tma"] += ssd


def test_counted_graph_counter_arithmetic(counters):
    BM.block_matmul.launches = 5
    BM.block_matmul.layout_launches.clear()
    BM.block_matmul.route_launches.clear()
    BM.block_matmul.route_launches["f32"] = 2
    layouts, routes = (BM.block_matmul.layout_launches,
                       BM.block_matmul.route_launches)
    g = StandInGraph()
    out = g.capture(lambda: (_launch(14), _launch(3, (True, True), "wmma",
                                                  ssd=2))[0])
    assert out is None
    # the capture ran nothing: every counter as it was, the same objects
    assert BM.block_matmul.launches == 5
    assert BM.block_matmul.layout_launches is layouts and not layouts
    assert BM.block_matmul.route_launches is routes
    assert dict(routes) == {"f32": 2}
    assert g.launches_of() == 17 and g.launches_of("ssd_intra_chunk") == 2
    ssd0 = SSD.ssd_intra_chunk.launches
    for _ in range(3):
        # the stand-in's replay runs the function (as a launch would run),
        # which a real replay never calls: take its own counts back out
        before = G.snapshot()
        g.graph.fn = lambda: None
        g.replay()
        assert G.delta(G.snapshot(), before)[("block_matmul", "launches")] \
            == 17
    assert BM.block_matmul.launches == 5 + 3 * 17
    assert layouts == collections.Counter({(False, False): 42,
                                           (True, True): 9})
    assert routes == collections.Counter({"f32": 2, "sm90": 42, "wmma": 9})
    assert SSD.ssd_intra_chunk.launches == ssd0 + 6
    with pytest.raises(RuntimeError, match="already captured"):
        g.capture(lambda: None)
    with pytest.raises(RuntimeError, match="before capture"):
        StandInGraph().replay()


def test_counted_graph_failed_capture_restores_counters(counters):
    before = G.snapshot()

    def boom():
        _launch(4)
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    g = StandInGraph()
    with pytest.raises(RuntimeError, match="capturing"):
        g.capture(boom)
    assert G.snapshot() == before and not g.captured


def _tiny_engine(**kw):
    ref = get_config("weathermixer-1b").reduced().replace(
        wm_lat=16, wm_lon=32, wm_channels=4, d_model=64, wm_d_tok=64,
        wm_d_ch=64, kernel="pallas")
    return E.ForecastEngine("weathermixer-1b", reduced=False,
                            config_override=ref, device="cpu", **kw)


def _serve(eng, fields):
    """The smoke run's plan: one request alone for a step, six joining."""
    plan = [(i % 3, (i + 2) % 3 + 1) for i in range(7)]
    reqs = [eng.submit(fields[plan[0][0]], plan[0][1])]
    assert eng.step_once() == "step"
    reqs += [eng.submit(fields[s], lead) for s, lead in plan[1:]]
    eng.drain()
    return reqs


def test_engine_graphs_on_stand_in_equal_eager(monkeypatch, counters):
    """The engine's graph path with the stand-in graph: one graph per
    bucket at warmup, every step a replay, the outputs the eager engine's
    bit for bit, no setup or capture after warmup."""
    monkeypatch.setattr(E, "CountedGraph", StandInGraph)
    config = E.ServeConfig(buckets=(1, 2, 4))
    graphed = _tiny_engine(config=config)
    graphed.graphs = True                 # what CUDA sets; here the stand-in
    eager = _tiny_engine(config=config.replace(graphs=False),
                         params=graphed.params)
    assert not eager.graphs
    warm = graphed.warmup()
    assert warm == 3 + 3                  # buffers, then graphs
    assert sorted(graphed._graphs) == [1, 2, 4]
    eager.warmup()
    fields = np.random.default_rng(3).normal(
        size=(3, *graphed.field_shape)).astype(np.float32)
    got, want = _serve(graphed, fields), _serve(eager, fields)
    assert graphed.stats["compiles"] == warm
    replays = sum(g.graph.replays for g in graphed._graphs.values())
    assert replays == graphed.stats["device_steps"] \
        == eager.stats["device_steps"]
    assert graphed.sched.counters["grown"] >= 1
    for a, b in zip(got, want):
        assert sorted(a.outputs) == sorted(b.outputs)
        for lead in a.outputs:
            np.testing.assert_array_equal(a.outputs[lead], b.outputs[lead])
    with pytest.raises(RuntimeError, match="not warmed up"):
        graphed._buffer(8)


def test_engine_captures_a_bucket_at_first_use_before_warmup(monkeypatch):
    """Without ``warmup()`` a bucket's first step runs eagerly and its
    graph is captured after it (the stand-in's capture runs the step
    once more, so only the count is checked here)."""
    monkeypatch.setattr(E, "CountedGraph", StandInGraph)
    eng = _tiny_engine(config=E.ServeConfig(buckets=(1,)))
    eng.graphs = True
    eng.submit(np.zeros(eng.field_shape, np.float32), 2)
    eng.drain()
    assert sorted(eng._graphs) == [1] and eng.stats["compiles"] == 2
    assert eng._graphs[1].graph.replays == 1


def _mamba(seed=0):
    cfg = get_config("mamba2-130m").reduced()
    return cfg, jigsaw_for(cfg), M.init(cfg, seed=seed, device="cpu")


def test_init_cache_allocates_the_conv_window_in_the_step_dtype():
    cfg, jcfg, params = _mamba()
    assert cfg.param_dtype == "float32"
    assert mamba.conv_dtype(cfg, torch.bfloat16) == torch.float32
    cache = M.init_cache(cfg, 2, 8, dtype=torch.bfloat16, device="cpu")
    assert cache["conv"].dtype == torch.float32
    assert cache["ssm"].dtype == torch.float32
    bf = cfg.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    assert mamba.conv_dtype(bf, torch.bfloat16) == torch.bfloat16
    assert mamba.conv_dtype(bf, torch.float32) == torch.float32
    pol = bf.replace(precision="fp32", param_dtype="float32",
                     compute_dtype="float32")
    assert mamba.conv_dtype(pol, torch.bfloat16) == torch.float32
    conv, ssm = cache["conv"], cache["ssm"]
    for t in range(3):
        _, cache = M.decode_step(params, cache,
                                 torch.full((2, 1), t, dtype=torch.int32),
                                 cfg, jcfg)
    assert cache["conv"] is conv and cache["ssm"] is ssm


def _old_decode_step(params, cache, tokens, cfg, jcfg):
    """The decode step as it was before ``init_cache`` allocated the
    window in the step's dtype: the window replaced by a wider tensor
    where it promotes."""
    x = L.embed_apply(params["embed"], tokens)
    conv, ssm = cache["conv"], cache["ssm"]
    for i, lp in enumerate(params["layers"]):
        x, ns = mamba._mixer(lp, x, cfg, jcfg,
                             state={"conv": conv[i], "ssm": ssm[i]})
        if ns["conv"].dtype != conv.dtype:
            conv = conv.to(ns["conv"].dtype)
        conv[i].copy_(ns["conv"])
        ssm[i].copy_(ns["ssm"])
    x = L.rmsnorm_apply(params["final_norm"], x)
    logits = L.unembed_apply(params["embed"], x, jcfg)
    cache["conv"] = conv
    cache["pos"] += 1
    return logits, cache


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
def test_eager_decode_unchanged_by_the_cache_dtype(cache_dtype):
    """Twelve greedy decode steps from a bf16 (and an f32) cache: logits
    and tokens bit for bit those of the step before the change, whose
    cache started in ``cache_dtype`` and promoted at the first step."""
    cfg, jcfg, params = _mamba(seed=1)
    b = 2
    old = mamba.init_cache(cfg, b, 0, dtype=cache_dtype, device="cpu")
    old["conv"] = old["conv"].to(cache_dtype)
    new = mamba.init_cache(cfg, b, 0, dtype=cache_dtype, device="cpu")
    tok_old = tok_new = torch.tensor([[3], [7]], dtype=torch.int32)
    with torch.no_grad():
        for _ in range(12):
            lo, old = _old_decode_step(params, old, tok_old, cfg, jcfg)
            ln, new = mamba.decode_step(params, new, tok_new, cfg, jcfg)
            assert torch.equal(lo, ln)
            tok_old = torch.argmax(lo[:, -1:, : cfg.vocab_size], -1).to(
                torch.int32)
            tok_new = torch.argmax(ln[:, -1:, : cfg.vocab_size], -1).to(
                torch.int32)
            assert torch.equal(tok_old, tok_new)
    for k in ("conv", "ssm", "pos"):
        assert torch.equal(old[k], new[k])


def test_graphed_decode_on_stand_in_equals_eager(monkeypatch, counters):
    """``serve.step``'s captured decode step with the stand-in graph, on
    the CPU: its static token and cache buffers, loaded from a cache and
    replayed through a token-wise prefill and the decode steps, give the
    eager loop's tokens bit for bit; the same weights reuse it, other
    weights capture anew."""
    monkeypatch.setattr(S, "CountedGraph", StandInGraph)
    cfg, jcfg, params = _mamba(seed=2)
    prompts = torch.tensor([[1, 5, 9, 2], [4, 4, 8, 0]], dtype=torch.int32)
    want = S.generate(params, prompts, cfg, jcfg, steps=6, max_len=12,
                      graph=False)
    cache = M.init_cache(cfg, 2, 12, dtype=torch.bfloat16, device="cpu")
    g = S.GraphedStep(params, cfg, jcfg, cache)
    g.load(cache)
    with torch.no_grad():
        for t in range(prompts.shape[1]):
            g.tokens_in.copy_(prompts[:, t:t + 1])
            nxt = g.replay()
        got = [nxt.clone()]
        for _ in range(5):
            g.tokens_in.copy_(got[-1])
            got.append(g.replay().clone())
    assert torch.equal(torch.cat(got, 1), want)
    assert g.graph.graph.replays == prompts.shape[1] + 5
    with pytest.raises(ValueError, match="on cuda"):
        S.generate(params, prompts, cfg, jcfg, steps=2, max_len=8,
                   graph=True)
    with pytest.raises(ValueError, match="cache on cuda"):
        S.graph_serve_step(params, cfg, jcfg, cache)


# (family's config, overrides, fused prefill): the ssm family, and the
# transformer's uniform, rolling and local:global caches (8 layers: one
# whole 5:1 period, its global layer, and the 2-layer leftover)
GEN_CASES = {"ssm": ("mamba2-130m", {}, False),
             "uniform": ("internlm2-1.8b", {}, True),
             "rolling": ("h2o-danube-1.8b", {"sliding_window": 6}, True),
             "period": ("gemma3-27b", {"n_layers": 8, "local_window": 5},
                        False),
             # the moe family (a KV cache; MoE layers routing the batch's
             # tokens with capacity n_experts in decode), and the hybrid's
             # nested cache (two periods of SSM + dense, SSM + MoE,
             # attention + dense, SSM + MoE)
             "moe": ("phi3.5-moe-42b-a6.6b", {}, True),
             "hybrid": ("jamba-1.5-large-398b",
                        {"attn_every": 4, "attn_offset": 2, "n_layers": 8},
                        False)}


def _lm(case, seed=0):
    arch, over, fused = GEN_CASES[case]
    cfg = get_config(arch).reduced().replace(**over)
    return cfg, jigsaw_for(cfg), M.init(cfg, seed=seed, device="cpu"), fused


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_graphed_generate_on_stand_in_equals_eager(monkeypatch, counters,
                                                   case):
    """``generate``'s graphed path (the stand-in graph, the device check
    lifted) against the eager loop: the same tokens bit for bit, for the
    ssm family's state (a token-wise prefill, every prompt step a replay;
    as before the transformer family's caches) and each KV cache (the
    fused prefill, then replays; local:global stacks token-wise); a
    second call with the same weights and layout reuses the capture."""
    monkeypatch.setattr(S, "CountedGraph", StandInGraph)
    monkeypatch.setattr(S, "_check_cuda", lambda t, msg: None)
    S.clear_graphs()
    cfg, jcfg, params, fused = _lm(case, seed=3)
    prompts = torch.tensor([[1, 5, 9, 2, 7, 3, 3, 8, 1],
                            [4, 4, 8, 0, 6, 2, 9, 9, 5]], dtype=torch.int32)
    steps, max_len = 6, 16
    want = S.generate(params, prompts, cfg, jcfg, steps=steps,
                      max_len=max_len, graph=False)
    got = S.generate(params, prompts, cfg, jcfg, steps=steps,
                     max_len=max_len, graph=True)
    assert torch.equal(got, want)
    assert len(S._GRAPHS) == 1
    (g,) = S._GRAPHS.values()
    replays = steps - 1 + (0 if fused else prompts.shape[1])
    assert g.graph.graph.replays == replays
    again = S.generate(params, prompts, cfg, jcfg, steps=steps,
                       max_len=max_len, graph=True)
    assert torch.equal(again, want) and list(S._GRAPHS.values()) == [g]
    assert g.graph.graph.replays == 2 * replays
    S.clear_graphs()


def test_graph_key_follows_the_cache_layout(monkeypatch):
    """One capture per cache layout: a KV cache of another max_len or
    dtype captures anew; the ssm state of these configs does not (O(1) in
    max_len, and its conv window is in the f32 the step writes for either
    cache dtype); the static cache is shaped and typed as the one given."""
    monkeypatch.setattr(S, "CountedGraph", StandInGraph)
    monkeypatch.setattr(S, "_check_cuda", lambda t, msg: None)
    S.clear_graphs()
    for case, n_graphs in (("period", 3), ("ssm", 1)):
        cfg, jcfg, params, _ = _lm(case)
        for max_len, dtype in ((8, torch.bfloat16), (12, torch.bfloat16),
                               (12, torch.float32)):
            cache = M.init_cache(cfg, 2, max_len, dtype=dtype, device="cpu")
            g = S.graph_serve_step(params, cfg, jcfg, cache)
            assert sorted(g.cache) == sorted(cache)
            for k, v in cache.items():
                assert (g.cache[k].shape, g.cache[k].dtype) == (v.shape,
                                                                v.dtype)
                assert g.cache[k] is not v and torch.equal(g.cache[k], v)
        assert len(S._GRAPHS) == n_graphs, case
        S.clear_graphs()


def test_cache_layout_key_of_a_flat_cache_is_unchanged():
    """A flat cache's layout key is (key, shape, dtype) per leaf, as it
    was before nested caches; a nested cache's names are paths of keys."""
    flat = {"pos": torch.zeros(2, dtype=torch.int32),
            "k": torch.zeros((3, 2, 4, 1, 8)),
            "v": torch.zeros((3, 2, 4, 1, 8), dtype=torch.bfloat16)}
    assert S.cache_layout(flat) == tuple(
        (k, tuple(v.shape), v.dtype) for k, v in flat.items())
    nested = {"pos": flat["pos"], "slots": {"slot0": {"k": flat["k"]},
                                            "slot1": {"v": flat["v"]}}}
    assert S.cache_layout(nested) == (
        ("pos", (2,), torch.int32),
        (("slots", "slot0", "k"), (3, 2, 4, 1, 8), torch.float32),
        (("slots", "slot1", "v"), (3, 2, 4, 1, 8), torch.bfloat16))


def test_nested_cache_graph_key_and_load(monkeypatch):
    """The hybrid's nested cache: one capture per layout (its attention
    slots' buffers follow max_len and the dtype), a static cache of the
    same tree, zeros until ``load`` copies the given one in leaf by
    leaf."""
    monkeypatch.setattr(S, "CountedGraph", StandInGraph)
    monkeypatch.setattr(S, "_check_cuda", lambda t, msg: None)
    S.clear_graphs()
    cfg, jcfg, params, _ = _lm("hybrid")
    for max_len, dtype in ((8, torch.bfloat16), (12, torch.bfloat16),
                           (12, torch.float32), (12, torch.float32)):
        cache = M.init_cache(cfg, 2, max_len, dtype=dtype, device="cpu")
        for i, leaf in enumerate(ptree.leaves(cache)):
            leaf.fill_(i % 3)
        g = S.graph_serve_step(params, cfg, jcfg, cache)
        mine = ptree.leaves_with_path(g.cache)
        assert [p for p, _ in mine] == [p for p, _ in
                                        ptree.leaves_with_path(cache)]
        for (_, a), b in zip(mine, ptree.leaves(cache)):
            assert a is not b and torch.equal(a, b)
            assert (a.shape, a.dtype) == (b.shape, b.dtype)
    assert len(S._GRAPHS) == 3
    S.clear_graphs()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_graphed_forecast_and_decode_on_card(cuda):
    """On the card: the engine's per-bucket graphs against the eager
    engine, and ``generate``'s captured decode against the eager loop,
    bit for bit, the launches counted by replay (2 + 4 L a forecast step,
    4 L + 1 a decode step)."""
    cfg = get_config("weathermixer-1b").reduced().replace(
        kernel="pallas", precision="bf16", param_dtype="bfloat16",
        compute_dtype="bfloat16")
    config = E.ServeConfig(buckets=(1, 2, 4))
    graphed = E.ForecastEngine("weathermixer-1b", reduced=False,
                               config_override=cfg, config=config)
    eager = E.ForecastEngine("weathermixer-1b", reduced=False,
                             config_override=cfg, params=graphed.params,
                             config=config.replace(graphs=False))
    warm = graphed.warmup()
    eager.warmup()
    per_step = 2 + 4 * cfg.n_layers       # encoder, decoder, 4 a block
    assert all(g.launches_of() == per_step
               for g in graphed._graphs.values())
    fields = np.random.default_rng(3).normal(
        size=(3, *graphed.field_shape)).astype(np.float32)
    BM.block_matmul.launches = 0
    got = _serve(graphed, fields)
    assert BM.block_matmul.launches == \
        per_step * graphed.stats["device_steps"]
    assert graphed.stats["compiles"] == warm
    want = _serve(eager, fields)
    for a, b in zip(got, want):
        for lead in a.outputs:
            np.testing.assert_array_equal(a.outputs[lead], b.outputs[lead])

    mcfg = get_config("mamba2-130m").reduced().replace(kernel="pallas")
    mj = jigsaw_for(mcfg)
    params = M.init(mcfg, seed=0, device="cuda")
    prompts = torch.randint(0, mcfg.vocab_size, (4, 8), dtype=torch.int32,
                            device="cuda")
    S.graph_serve_step(params, mcfg, mj, M.init_cache(
        mcfg, 4, 16, dtype=torch.bfloat16, device="cuda"))
    BM.block_matmul.launches = 0
    out = S.generate(params, prompts, mcfg, mj, steps=6, max_len=16)
    assert BM.block_matmul.launches == (8 + 5) * (4 * mcfg.n_layers + 1)
    assert torch.equal(out, S.generate(params, prompts, mcfg, mj, steps=6,
                                       max_len=16, graph=False))
    S.clear_graphs()


@pytest.mark.cuda
def test_graphed_transformer_decode_on_card(cuda):
    """On the card, ``kernel="pallas"``: the transformer's captured decode
    step on each kind of KV cache (the fused prefill, or token by token
    through the graph on the local:global stack) against the eager loop,
    bit for bit, with 7 L + 1 block_matmul launches a step (q, k, v, o,
    gate, up, down; the head) counted by replay, 6 L + 1 for gemma3's gelu
    FFN."""
    prompts = torch.randint(0, 1000, (4, 9), dtype=torch.int32,
                            device="cuda")
    for case in ("uniform", "rolling", "period"):
        arch, over, fused = GEN_CASES[case]
        cfg = get_config(arch).reduced().replace(kernel="pallas", **over)
        jcfg = jigsaw_for(cfg)
        params = M.init(cfg, seed=0, device="cuda")
        per_step = (6 if cfg.ffn_kind == "gelu" else 7) * cfg.n_layers + 1
        BM.block_matmul.launches = 0
        out = S.generate(params, prompts, cfg, jcfg, steps=6, max_len=16)
        n_replays = 5 + (0 if fused else prompts.shape[1])
        # the fused prefill's forward launches per_step too, and the
        # capture's eager warm-up step
        want = n_replays * per_step + per_step * (1 + fused)
        assert BM.block_matmul.launches == want, case
        assert torch.equal(out, S.generate(params, prompts, cfg, jcfg,
                                           steps=6, max_len=16,
                                           graph=False)), case
        S.clear_graphs()


@pytest.mark.cuda
def test_graphed_hybrid_decode_on_card(cuda):
    """On the card, ``kernel="pallas"``: ``generate`` through the captured
    decode step on the hybrid's nested cache (a token-wise prefill, every
    prompt step a replay) against the eager loop, bit for bit, one
    capture; block_matmul launches a step counted by replay (4 a slot for
    its mixer, 3 for a dense FFN, 1 for a MoE's router; the head), no ssd
    launch in decode."""
    arch, over, _ = GEN_CASES["hybrid"]
    cfg = get_config(arch).reduced().replace(kernel="pallas", **over)
    jcfg = jigsaw_for(cfg)
    params = M.init(cfg, seed=0, device="cuda")
    prompts = torch.randint(0, 1000, (2, 7), dtype=torch.int32,
                            device="cuda")
    S.clear_graphs()
    S.graph_serve_step(params, cfg, jcfg, M.init_cache(
        cfg, 2, 16, dtype=torch.bfloat16, device="cuda"))
    per_step = sum(4 + (1 if cfg.is_moe_layer(j) else 3)
                   for j in range(cfg.attn_every)) * (
        cfg.n_layers // cfg.attn_every) + 1
    BM.block_matmul.launches = SSD.ssd_intra_chunk.launches = 0
    out = S.generate(params, prompts, cfg, jcfg, steps=6, max_len=16)
    assert BM.block_matmul.launches == (7 + 5) * per_step
    assert SSD.ssd_intra_chunk.launches == 0
    assert len(S._GRAPHS) == 1
    assert torch.equal(out, S.generate(params, prompts, cfg, jcfg, steps=6,
                                       max_len=16, graph=False))
    S.clear_graphs()


@pytest.mark.cuda
def test_graphed_audio_generate_on_card(cuda):
    """On the card, ``kernel="pallas"``: ``generate`` with frames through
    the captured decode step against the eager loop, bit for bit, with 10
    L + 1 block_matmul launches a step counted by replay."""
    cfg = get_config("whisper-small").reduced().replace(kernel="pallas")
    jcfg = jigsaw_for(cfg)
    params = M.init(cfg, seed=0, device="cuda")
    prompts = torch.randint(0, 1000, (4, 4), dtype=torch.int32,
                            device="cuda")
    frames = torch.randn(4, cfg.n_frames, cfg.d_model, device="cuda")
    kw = dict(steps=6, max_len=16, extra_batch={"frames": frames})
    out = S.generate(params, prompts, cfg, jcfg, **kw)
    BM.block_matmul.launches = 0
    again = S.generate(params, prompts, cfg, jcfg, **kw)
    per_step = 10 * cfg.n_layers + 1
    enc = 6 * cfg.n_enc_layers
    assert BM.block_matmul.launches == enc + (4 + 5) * per_step
    assert torch.equal(out, again)
    assert torch.equal(out, S.generate(params, prompts, cfg, jcfg,
                                       graph=False, **kw))
    S.clear_graphs()
