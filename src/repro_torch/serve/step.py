"""Language-model serving: prefill and greedy decode steps (the port of
``repro/serve/step.py``).

``make_serve_step`` builds the single-token decode step; ``generate`` runs
the prompt through ``prefill`` and then ``steps - 1`` decode steps.
``graph_serve_step`` is the counterpart of the reference's
``jit_serve_step``: one captured CUDA graph of the decode step per (cfg,
jcfg, cache layout) and weights, whose static buffers are the token in,
the token out and a cache shaped as the one it is given (the KV cache of
the transformer family, uniform, rolling or local:global, the ssm
family's state, or the hybrid's nested per-slot buffers: any tree of
tensors; ``kernels/graphs.py::CountedGraph``: the kernels' launch
counters count its replays).  On the card ``generate`` replays it for
every decode step (``graph=None``); ``graph=False`` keeps the eager loop,
the comparison.  The prompt goes through the family's fused prefill (one
teacher-forced forward that fills the cache:
``models/transformer.py::prefill_cache``) where it has one, and token by
token through the same decode step where the fused prefill raises
NotImplementedError (the ssm and hybrid families, local:global stacks:
as in the reference); on the card those steps are replays too.  The
enc-dec family (audio) takes its encoder's input as ``extra_batch=
{"frames": [B, n_frames, D]}``: the encoder runs once and its states go
into the fresh cache's "enc" (cast to the cache dtype) before the first
prompt token, on the captured step's static cache too; its prefill is
token-wise, as the reference's.  Each step writes
the model's cache in place (``decode_step``), which stands in for the
reference's buffer donation, and keeps the output tokens on the device
until one concatenate at the end.  Nothing here needs autograd:
``generate`` runs under ``torch.no_grad``.  Everything runs where the
prompts and the parameters lie: on the card unless the caller made them on
the CPU.

On a 1-D Jigsaw model mesh (``jcfg.scheme="1d"``, ``jcfg.mesh`` the rank's
``Mesh1D`` of (data n, model p)) every rank holds its shard of the weights
(``convert.shard_params_1d`` under ``registry.param_rule(cfg, "1d")``) and
its block of the cache (``registry.init_cache``: the reference's
``cache_specs``), and ``prefill`` and ``generate`` take the whole prompt
batch: each rank runs its data rank's rows (all of them where n does not
divide the batch) and the frames' block of D.  The greedy argmax runs
over the vocab-cut logits [B, 1, V/p] (``greedy``): every rank of the
model group picks the same token, and ``generate`` returns the whole
batch's tokens on every rank.  A mesh decode runs eagerly: the ring
kernels' stream synchronisation and gloo barrier before each launch
(``kernels/ring.py``, ``kernels/fused_ring.py``), and the features'
hops through the ring workspace, are host work that a CUDA graph cannot
capture, so ``graph=None`` takes the eager loop there and ``graph=True``
raises ValueError.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core import tree as ptree
from repro_torch.core.api import JigsawConfig
from repro_torch.core.sharding import DATA_AXIS, MODEL_AXIS, sanitize_spec
from repro_torch.kernels import fused_ring
from repro_torch.kernels.graphs import CountedGraph
from repro_torch.models import layers as L
from repro_torch.models import registry as M


def greedy(logits: torch.Tensor, cfg: ModelConfig,
           jcfg: JigsawConfig) -> torch.Tensor:
    """The next token [B, 1] int32 from the logits of the last position:
    the vocab padding (ids >= ``cfg.vocab_size``) masked off, then the
    first maximum, as ``jnp.argmax``.  Under ``scheme="1d"`` the logits
    are the rank's vocab block [B, S, V/p]: each rank takes its block's
    first maximum, the (value, global id) pairs of the tp group are
    gathered (``fused_ring.gather_features``) and the first rank holding
    the largest value wins, so a tie goes to the lowest global id and
    every rank returns the same token."""
    last = logits[:, -1:]
    mesh = L.mesh_1d(jcfg)
    if mesh is None or mesh.p == 1:
        return torch.argmax(last[..., :cfg.vocab_size],
                            dim=-1).to(torch.int32)
    vl = last.shape[-1]
    ids = torch.arange(mesh.r * vl, (mesh.r + 1) * vl, device=last.device)
    vals = last.float().masked_fill(ids >= cfg.vocab_size, -torch.inf)
    idx = torch.argmax(vals, dim=-1, keepdim=True)
    pair = torch.cat([vals.gather(-1, idx), (idx + mesh.r * vl).float()], -1)
    pairs = fused_ring.gather_features(pair, mesh.tp_group, mesh.p, mesh.r,
                                       "greedy")
    pairs = pairs.reshape(*pairs.shape[:-1], mesh.p, 2)
    best = torch.argmax(pairs[..., 0], dim=-1, keepdim=True)
    return pairs[..., 1].gather(-1, best)[..., 0].to(torch.int32)


def make_serve_step(cfg: ModelConfig, jcfg: JigsawConfig):
    """Returns serve_step(params, cache, tokens [B, 1]) ->
    (next_tokens [B, 1] int32, cache): greedy, with the vocab padding
    masked off before the argmax (which takes the first maximum, as
    ``jnp.argmax``; over the vocab-cut logits on a model mesh:
    ``greedy``)."""

    def serve_step(params, cache, tokens):
        logits, cache = M.decode_step(params, cache, tokens, cfg, jcfg)
        return greedy(logits, cfg, jcfg), cache

    return serve_step


def _frames_block(extra_batch: Optional[dict],
                  jcfg: JigsawConfig) -> Optional[dict]:
    """The rank's block of the whole batch's ``extra_batch`` on a model
    mesh: its rows of the frames [B, F, D] and its block of D."""
    mesh = L.mesh_1d(jcfg)
    if extra_batch is None or mesh is None:
        return extra_batch
    spec = ((DATA_AXIS,), None, MODEL_AXIS)
    return {k: mesh.block(v, sanitize_spec(v.shape, spec, mesh))
            for k, v in extra_batch.items()}


def start_cache(params, prompts: torch.Tensor, cfg: ModelConfig,
                jcfg: JigsawConfig, max_len: int, cache_dtype=torch.bfloat16,
                extra_batch: Optional[dict] = None):
    """A fresh cache on the prompts' device for their batch, with the
    prompt's ``extra_batch`` loaded by the family (``M.start_cache``: the
    audio family's encoder states of its "frames" in "enc", cast to the
    cache dtype).  On a model mesh the rank's block of the cache, and of
    the frames (the whole batch's given)."""
    cache = M.init_cache(cfg, prompts.shape[0], max_len, dtype=cache_dtype,
                         device=prompts.device, jcfg=jcfg)
    if extra_batch is not None:
        with torch.no_grad():
            M.start_cache(params, cache,
                          _frames_block(extra_batch, jcfg),
                          cfg, jcfg)
    return cache


def prefill_tokenwise(params, prompts: torch.Tensor, cfg: ModelConfig,
                      jcfg: JigsawConfig, max_len: int,
                      cache_dtype=torch.bfloat16,
                      extra_batch: Optional[dict] = None):
    """Token-by-token prefill through the decode step: a fresh cache
    (``start_cache``), then one step per prompt position.  Returns the
    token after the prompt [B, 1] and the cache (on a model mesh, of the
    rank's rows)."""
    s = prompts.shape[1]
    cache = start_cache(params, prompts, cfg, jcfg, max_len, cache_dtype,
                        extra_batch)
    prompts = L.rows_block(prompts, L.mesh_1d(jcfg))
    step = make_serve_step(cfg, jcfg)
    last = prompts[:, :1]
    for t in range(s):
        last, cache = step(params, cache, prompts[:, t:t + 1])
    return last, cache


def _tokenwise_only(cfg: ModelConfig, extra_batch: Optional[dict],
                    fused: Optional[bool]) -> bool:
    """A prompt with ``extra_batch`` (the enc-dec family's input), and a
    family with no fused prefill, prefill token by token (as the
    reference); ``fused=True`` raises for them."""
    if extra_batch is not None:
        if fused:
            raise NotImplementedError("fused prefill: no enc-dec support")
        return True
    if not M.has_fused_prefill(cfg):
        if fused:
            raise NotImplementedError(
                f"{cfg.arch_id} ({cfg.family}) has no fused prefill")
        return True
    return fused is False


def prefill(params, prompts: torch.Tensor, cfg: ModelConfig,
            jcfg: JigsawConfig, max_len: int, cache_dtype=torch.bfloat16,
            extra_batch: Optional[dict] = None,
            fused: Optional[bool] = None):
    """Fill a fresh cache from the prompt.  ``fused=None`` takes the family's
    fused prefill where it has one and goes token-wise otherwise; True
    forces the fused one (and raises where there is none: the audio family
    and ``extra_batch`` among them); False forces the token-wise path.
    Returns the token after the prompt [B, 1] and the cache: on a model
    mesh, of the rank's rows of the whole batch ``prompts``."""
    if _tokenwise_only(cfg, extra_batch, fused):
        return prefill_tokenwise(params, prompts, cfg, jcfg, max_len,
                                 cache_dtype, extra_batch)
    try:
        logits, cache = M.prefill_cache(params, {"tokens": prompts}, cfg,
                                        jcfg, max_len, dtype=cache_dtype)
    except NotImplementedError:
        if fused:
            raise
        return prefill_tokenwise(params, prompts, cfg, jcfg, max_len,
                                 cache_dtype)
    return greedy(logits, cfg, jcfg), cache


class GraphedStep:
    """One decode step captured in a CUDA graph on static buffers:
    ``tokens_in`` [B, 1] int32, ``tokens_out`` [B, 1] int32 and ``cache``
    (a tree of zeros shaped and typed as the ``cache`` given, flat or
    nested, which the step writes in place).  ``load`` copies a cache of
    that layout in; each ``replay`` reads ``tokens_in`` and ``cache`` and
    writes the next tokens and the cache."""

    def __init__(self, params, cfg: ModelConfig, jcfg: JigsawConfig,
                 cache: Dict[str, Any]):
        # the graph reads these tensors where they lie: hold them
        self.params = params
        self.ptrs = _leaf_ptrs(params)
        self.cache = ptree.map(torch.zeros_like, cache)
        device = cache["pos"].device
        self.tokens_in = torch.zeros((cache["pos"].shape[0], 1),
                                     dtype=torch.int32, device=device)
        step = make_serve_step(cfg, jcfg)

        def body():
            nxt, _ = step(params, self.cache, self.tokens_in)
            return nxt

        with torch.no_grad():
            body()                  # eager once: attributes set, pool primed
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.graph = CountedGraph()
        self.tokens_out = self.graph.capture(body)

    def load(self, cache: Dict[str, Any]) -> None:
        """Copy ``cache`` (the layout it was captured on) into the static
        one, leaf by leaf."""
        ptree.map(lambda dst, src: dst.copy_(src), self.cache, cache)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        return self.tokens_out


_GRAPHS: Dict[tuple, GraphedStep] = {}


def _leaf_ptrs(params) -> tuple:
    return tuple(t.data_ptr() for t in ptree.leaves(params))


def cache_layout(cache: Dict[str, Any]) -> tuple:
    """A cache's layout: (name, shape, dtype) of every leaf, where the name
    is a flat cache's key and a nested cache's path of keys."""
    return tuple((path[0] if len(path) == 1 else path, tuple(v.shape),
                  v.dtype) for path, v in ptree.leaves_with_path(cache))


def _check_cuda(t: torch.Tensor, msg: str) -> None:
    """The graphed paths run on the card: ValueError(msg) elsewhere."""
    if t.device.type != "cuda":
        raise ValueError(f"{msg}, not {t.device}")


def graph_serve_step(params, cfg: ModelConfig, jcfg: JigsawConfig,
                     cache: Dict[str, Any]) -> GraphedStep:
    """The captured decode step for ``cache``'s layout, with ``cache``
    loaded into its static cache.  One per (cfg, jcfg, cache layout,
    device), captured at first use, where the layout is every leaf's name
    (a nested cache's path), shape and dtype (``cache_layout``): the
    batch, the cache dtype and, where it shapes the cache, max_len.  Weights other than those it was captured with (other
    tensors) capture it anew in its place.  The steps hold their weights:
    ``clear_graphs()`` lets them go.  A capture that fails raises."""
    pos = cache["pos"]
    _check_cuda(pos, "graph_serve_step needs a cache on cuda")
    key = (cfg, jcfg, cache_layout(cache), pos.device)
    g = _GRAPHS.get(key)
    if g is None or g.ptrs != _leaf_ptrs(params):
        _GRAPHS.pop(key, None)
        g = _GRAPHS[key] = GraphedStep(params, cfg, jcfg, cache)
    g.load(cache)
    return g


def clear_graphs() -> None:
    """Drop every captured decode step (and its hold on the weights)."""
    _GRAPHS.clear()


@torch.no_grad()
def generate(params, prompts: torch.Tensor, cfg: ModelConfig,
             jcfg: JigsawConfig, *, steps: int, max_len: int,
             extra_batch: Optional[dict] = None,
             fused: Optional[bool] = None,
             graph: Optional[bool] = None) -> torch.Tensor:
    """Greedy generation: prefill, then ``steps - 1`` decode steps.
    Returns the ``steps`` new tokens [B, steps] (int32) on the prompts'
    device.  ``extra_batch``: the audio family's {"frames"}.  ``graph``
    (None: on CUDA off a model mesh) replays ``graph_serve_step``'s
    captured step for every decode step and every step of a token-wise
    prefill; False runs them eagerly; True on the CPU or on a model mesh
    raises.  On a model mesh the prompts (and frames) are the whole
    batch's, each rank runs its rows, and every rank returns the whole
    batch's tokens (gathered over the data axis)."""
    mesh = L.mesh_1d(jcfg)
    on_mesh = mesh is not None and mesh.p * mesh.data_size > 1
    if graph and on_mesh:
        raise ValueError("generate(graph=True): a decode step on a mesh "
                         "runs eagerly (its collectives synchronise the "
                         "host)")
    if graph is None:
        graph = prompts.is_cuda and not on_mesh
    if not graph:
        nxt, cache = prefill(params, prompts, cfg, jcfg, max_len,
                             extra_batch=extra_batch, fused=fused)
        step = make_serve_step(cfg, jcfg)
        out = [nxt]
        for _ in range(steps - 1):
            nxt, cache = step(params, cache, nxt)
            out.append(nxt)
        out = torch.cat(out, dim=1)
        if on_mesh and L.rows_block(prompts, mesh).shape[0] < len(prompts):
            out = comm.all_gather(out, mesh.data_group, 0)
        return out
    _check_cuda(prompts, "generate(graph=True) needs prompts on cuda")
    b, s = prompts.shape
    out = torch.empty((b, steps), dtype=torch.int32, device=prompts.device)
    cache = None
    if not _tokenwise_only(cfg, extra_batch, fused):
        try:
            nxt, cache = prefill(params, prompts, cfg, jcfg, max_len,
                                 fused=True)
        except NotImplementedError:
            if fused:
                raise
    if cache is not None:
        g = graph_serve_step(params, cfg, jcfg, cache)
    else:
        # token-wise prefill, through the captured step: the fresh cache
        # (with the encoder's states) is loaded into its static one
        g = graph_serve_step(params, cfg, jcfg, start_cache(
            params, prompts, cfg, jcfg, max_len, extra_batch=extra_batch))
        for t in range(s):
            g.tokens_in.copy_(prompts[:, t:t + 1])
            nxt = g.replay()
    out[:, :1].copy_(nxt)
    for i in range(1, steps):
        g.tokens_in.copy_(out[:, i - 1:i])
        out[:, i:i + 1].copy_(g.replay())
    return out
