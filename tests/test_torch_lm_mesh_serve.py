"""Serving the language models on a 1-D Jigsaw model mesh in the port,
against the JAX package's serving on its 1-D mesh (its ``param_specs``
layout for the weights, its ``cache_specs`` for the decode cache, GSPMD
placing every collective).

The reference's weights (``repro.models.registry.init`` of the reduced
configs: d_model 256, 4 heads on 2 kv heads, vocab 1,024; gemma3 at 6
layers, so that its global layer follows five local ones) are carried to
the port through numpy; the prompts, the frames and nothing else come
from a numpy seed.  The reference runs on four host-emulated devices, one
subprocess per mesh (this file run as a script with ``--reference``):
under ``jax.set_mesh`` its fused prefill (dense and moe) or its decode
steps over the prompt (the others, as its ``serve/step.py``) with an f32
cache placed by ``cache_specs`` (sanitized), then 6 greedy decode steps,
whose tokens the port is teacher-forced on, and (on (data 1, model 2),
``GEN_MESH``) the greedy generation of its ``generate`` (a bf16 cache)
with the prefill and ``jit_serve_step`` under ``jax.jit``: its
``generate`` runs the fused prefill eagerly, and eagerly on a mesh of 4
the cache's 2 kv heads do not broadcast onto the model axis (a
ValueError of jax's sharding), which ``jax.jit`` places.
The port's ranks are gloo processes, this file run as a script with
``--rank`` (one launched group per mesh: (data 1, model 2), where the
reduced configs' 2 kv heads are cut one a rank, (data 1, model 4), where
the sequence is cut, or left whole where 4 does not divide it, and (data
2, model 2), the prompt's rows cut over data), ``impl="ring_fused"``.  On
the CPU ``ring_fused`` runs its kernels' plain versions and the features'
gathers are the library's.

Tolerances, as the forwards of ``tests/test_torch_lm_mesh.py`` and
``tests/test_torch_lm_mesh_zoo.py``: the logits (gathered over the vocab)
and the caches (gathered by ``convert.gather_cache_1d``, f32) within 1e-5
relative and absolute for the dense, moe and audio families and 1e-4 for
the ssm and hybrid families, against the reference on its mesh and the
port on one device; greedy tokens equal; ``ring_chunked`` bit for bit
``ring_fused``.
"""
import os
import subprocess
import sys
import time
import types
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.convert import (gather_cache_1d, params_from_npz,
                                 shard_cache_1d, shard_params_1d)
from repro_torch.core import tree as ptree
from repro_torch.core.sharding import RULES_1D, Mesh1D, entry_axes
from repro_torch.launch import specs
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import layers as L
from repro_torch.models import registry as M
from repro_torch.serve import step as S

ROOT = Path(__file__).resolve().parents[1]
H2O, GEMMA, MOE, SSM, HYBRID, AUDIO = (
    "h2o-danube-1.8b", "gemma3-27b", "phi3.5-moe-42b-a6.6b", "mamba2-130m",
    "jamba-1.5-large-398b", "whisper-small")
# each arch's config cut, cache length and prompt length: h2o's prompt of
# 70 rolls its 64-slot window; gemma3's 50 slots are whole at p = 4 and
# its local layers' 32 cut; phi3.5's 30 are whole at p = 4
CASES = {H2O: ({}, 80, 70), GEMMA: ({"n_layers": 6}, 50, 8),
         MOE: ({}, 30, 12), SSM: ({}, 32, 8), HYBRID: ({}, 24, 8),
         AUDIO: ({}, 16, 6)}
# (data, model) of each launched mesh, and the archs it serves
MESHES = {"m2": (1, 2), "m4": (1, 4), "d2m2": (2, 2)}
SERVED = {"m2": tuple(CASES), "m4": tuple(CASES), "d2m2": (H2O,)}
RUNS = [(k, a) for k in MESHES for a in SERVED[k]]
# the reference's runs of a mesh, split over processes that run at once;
# the parts of "m2" also make and save the weights of their archs
PARTS = {"m2": ((H2O, GEMMA, MOE), (SSM, HYBRID, AUDIO)),
         "m4": ((H2O, GEMMA, MOE), (SSM, HYBRID, AUDIO)), "d2m2": ((H2O,),)}
# ring_chunked run beside ring_fused, decode for decode
CHUNKED = (H2O, SSM)
BATCH, STEPS, GEN = 2, 6, 4
# the mesh of the reference's generate that every mesh's generate is held
# to (greedy tokens do not depend on the mesh but at near-ties; one bf16
# run of the reference's per arch keeps its compiles within the budget)
GEN_MESH = "m2"
SSD_FAMILIES = ("ssm", "hybrid")
SPEC_ARCHS = ("internlm2-1.8b", H2O, "stablelm-3b", GEMMA, "pixtral-12b",
              "dbrx-132b", MOE, SSM, HYBRID, AUDIO)


def _port_cfg(arch, **kw):
    return get_config(arch).reduced().replace(**CASES[arch][0], **kw)


def _ref_cfg(arch, **kw):
    # the reference's modules are imported where they are used: the port's
    # rank processes (this file run with --rank) import no jax
    from repro.configs.registry import get_config as ref_get_config
    return ref_get_config(arch).reduced().replace(**CASES[arch][0], **kw)


def _tol(arch):
    return 1e-4 if _port_cfg(arch).family in SSD_FAMILIES else 1e-5


def _weights_path(wdir, arch):
    return Path(wdir) / f"{arch}.npz"


def _save_weights(wdir, arch):
    """The reference's weights of ``arch`` (its ``registry.init``, under
    ``jax.jit``), saved flat under "/"-joined keys."""
    import jax
    from repro.models import registry as RM
    cfg = _ref_cfg(arch)
    tree = jax.jit(lambda key: RM.init(key, cfg))(jax.random.PRNGKey(0))
    partial = _weights_path(wdir, arch).with_suffix(".part.npz")
    np.savez(partial, **_flat(jax.tree.map(np.asarray, tree)))
    os.replace(partial, _weights_path(wdir, arch))


def _saved_weights(wdir, arch):
    """The reference's weights of ``arch`` as ``_save_weights`` saved them,
    as numpy arrays (waiting for the file)."""
    with _wait_for(_weights_path(wdir, arch)) as f:
        return _unflat({k: f[k] for k in f.files})


def _flat(tree):
    out = {}
    ptree.map_with_path(
        lambda path, a: out.__setitem__("/".join(map(str, path)), a), tree)
    return out


def _unflat(flat):
    tree: dict = {}
    for key, a in flat.items():
        *outer, leaf = key.split("/")
        node = tree
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def _axes(spec):
    """A spec's axes dim by dim (the reference's PartitionSpec writes a
    one-axis tuple entry as the axis)."""
    return tuple(entry_axes(e) for e in spec)


def _inputs(arch):
    """The whole batch's prompt tokens [B, S] and, for whisper, frames."""
    cfg = _port_cfg(arch)
    rng = np.random.default_rng(5)
    out = {"prompts": rng.integers(0, cfg.vocab_size,
                                   (BATCH, CASES[arch][2])).astype(np.int32)}
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            size=(BATCH, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _fused(arch):
    return _port_cfg(arch).family in ("dense", "moe") and \
        _port_cfg(arch).local_global_ratio == 0


def _tokens_path(wdir, key, arch):
    return Path(wdir) / f"tokens_{key}_{arch}.npy"


def _wait_for(path, load=np.load, timeout=300):
    """``load(path)`` once another process has written the file."""
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no {path}")
        time.sleep(0.05)
    return load(path)


# ---------------------------------------------------------------------------
# the reference (a subprocess per mesh) and the port's ranks
# ---------------------------------------------------------------------------

def _reference_main(key, part, wdir):
    """The reference's serving of the archs of ``PARTS[key][part]`` on its
    (data, model) mesh (on "m2" their weights made and saved first): the
    f32 prefill (logits, the cache), 6 greedy decode steps (their tokens
    written at once for the port's ranks), and on ``GEN_MESH`` the bf16
    greedy generation of its ``generate``'s prefill and
    ``jit_serve_step``; saved to reference_<key>_<part>.npz."""
    import jax
    import jax.numpy as jnp
    from repro.core.sharding import RULES_1D as REF_RULES_1D
    from repro.launch import shapes as RSH
    from repro.launch import specs as ref_specs
    from repro.launch.mesh import make_host_mesh
    from repro.models import encdec as RE
    from repro.models import registry as RM
    from repro.serve import step as RSS
    data, p = MESHES[key]
    archs = PARTS[key][part]
    if key == "m2":
        for arch in archs:
            _save_weights(wdir, arch)
    out = {}
    for arch in archs:
        cfg = _ref_cfg(arch, scheme="1d", impl="rs")
        jcfg = RSH.jigsaw_for(cfg)
        max_len = CASES[arch][1]
        inp = {k: jnp.asarray(v) for k, v in _inputs(arch).items()}
        prompts, s = inp["prompts"], inp["prompts"].shape[1]
        mesh = make_host_mesh(model=p, data=data)
        with jax.set_mesh(mesh):
            params = jax.tree.map(jnp.asarray, _saved_weights(wdir, arch))
            pspecs = ref_specs.sanitize_tree(params, ref_specs.param_specs(
                params, cfg, REF_RULES_1D, mesh), mesh)
            params = jax.device_put(params,
                                    ref_specs.to_shardings(pspecs, mesh))

            def place(cache):
                cs = ref_specs.sanitize_tree(cache, ref_specs.cache_specs(
                    cache, cfg, REF_RULES_1D, mesh), mesh)
                return jax.device_put(cache,
                                      ref_specs.to_shardings(cs, mesh))

            step = jax.jit(lambda pr, c, t: RM.decode_step(pr, c, t, cfg,
                                                           jcfg))
            if _fused(arch):
                logits, cache = jax.jit(lambda pr, t: RM.prefill_cache(
                    pr, {"tokens": t}, cfg, jcfg, max_len,
                    dtype=jnp.float32))(params, prompts)
                cache = place(cache)
            else:
                cache = RM.init_cache(cfg, BATCH, max_len, jnp.float32)
                if "frames" in inp:
                    cache["enc"] = RE.encode(params, inp["frames"], cfg,
                                             jcfg).astype(jnp.float32)
                cache = place(cache)
                for t in range(s):
                    logits, cache = step(params, cache, prompts[:, t:t + 1])
            out[f"{arch}/prefill"] = np.asarray(logits)
            for k, v in _flat(jax.tree.map(np.asarray, cache)).items():
                out[f"{arch}/cache/{k}"] = v
            tok = jnp.argmax(logits[:, -1:, :cfg.vocab_size],
                             axis=-1).astype(jnp.int32)
            toks = [np.asarray(tok)]
            for i in range(STEPS):
                logits, cache = step(params, cache, tok)
                out[f"{arch}/step{i}"] = np.asarray(logits)
                tok = jnp.argmax(logits[:, -1:, :cfg.vocab_size],
                                 axis=-1).astype(jnp.int32)
                toks.append(np.asarray(tok))
            toks = np.concatenate(toks, 1)
            partial = _tokens_path(wdir, key, arch).with_suffix(".part.npy")
            np.save(partial, toks)
            os.replace(partial, _tokens_path(wdir, key, arch))
            out[f"{arch}/tokens"] = toks
            if key != GEN_MESH:
                continue
            # generate: its prefill (bf16 cache), then jit_serve_step
            extra = {"frames": inp["frames"]} if "frames" in inp else None
            if _fused(arch):
                nxt, cache = jax.jit(lambda pr, t: RSS.prefill(
                    pr, t, cfg, jcfg, max_len))(params, prompts)
            else:
                cache = RM.init_cache(cfg, BATCH, max_len, jnp.bfloat16)
                if extra is not None:
                    cache["enc"] = RE.encode(params, extra["frames"], cfg,
                                             jcfg).astype(jnp.bfloat16)
                serve = RSS.jit_serve_step(cfg, jcfg)
                for t in range(s):
                    nxt, cache = serve(params, cache, prompts[:, t:t + 1])
            serve = RSS.jit_serve_step(cfg, jcfg)
            gen = [nxt]
            for _ in range(GEN - 1):
                nxt, cache = serve(params, cache, nxt)
                gen.append(nxt)
            out[f"{arch}/generate"] = np.asarray(jnp.concatenate(gen, 1))
    np.savez(Path(wdir) / f"reference_{key}_{part}.npz", **out)


def _gather_logits(y, mesh):
    from repro_torch.core import comm
    return torch.cat(comm.all_gather_list(y.contiguous(), mesh.tp_group),
                     -1)


def _rank_main(rank, key, init, wdir):
    """One rank of the port's mesh ``key``: for each arch of
    ``SERVED[key]``, from its shard of the weights, the f32 prefill
    (``prefill_cache`` for the dense and moe archs, decode steps over the
    prompt for the others: the logits gathered over the vocab, the whole
    cache gathered from every rank's block), 6 decode steps teacher-forced
    on the reference's tokens (and again under ``ring_chunked`` for
    ``CHUNKED``), and ``generate``; saved to <key>_rank<r>.npz."""
    import torch.distributed as dist
    from repro_torch.core import comm
    from repro_torch.launch.mesh import make_ring_mesh
    torch.set_num_threads(1)
    data, p = MESHES[key]
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=data * p)
    mesh = make_ring_mesh(p, data, device="cpu")
    wdir = Path(wdir)
    res = {}
    for arch in SERVED[key]:
        cfg = _port_cfg(arch, scheme="1d", impl="ring_fused")
        jcfg = jigsaw_for(cfg).replace(mesh=mesh)
        max_len = CASES[arch][1]
        whole = _wait_for(_weights_path(wdir, arch),
                          lambda f: params_from_npz(f, device="cpu"))
        params = shard_params_1d(whole, mesh.r, p,
                                 spec=M.param_rule(cfg, "1d"))
        inp = {k: torch.from_numpy(v) for k, v in _inputs(arch).items()}
        prompts = inp["prompts"]
        extra = {"frames": inp["frames"]} if "frames" in inp else None
        rows = L.rows_block(prompts, mesh)
        with torch.no_grad():
            if _fused(arch):
                logits, cache = M.prefill_cache(
                    params, {"tokens": prompts}, cfg, jcfg, max_len,
                    dtype=torch.float32)
            else:
                cache = S.start_cache(params, prompts, cfg, jcfg, max_len,
                                      torch.float32, extra)
                for t in range(prompts.shape[1]):
                    logits, cache = M.decode_step(params, cache,
                                                  rows[:, t:t + 1], cfg, jcfg)
            res[f"{arch}/prefill"] = _gather_logits(logits, mesh).numpy()
            blocks = [ptree.unflatten(cache, leaves) for leaves in zip(*(
                comm.all_gather_list(t.contiguous(), dist.group.WORLD)
                for t in ptree.leaves(cache)))]
            for k, v in _flat(gather_cache_1d(blocks, cfg, mesh,
                                              cache.specs)).items():
                res[f"{arch}/cache/{k}"] = v.numpy()
            teacher = L.rows_block(torch.from_numpy(_wait_for(
                _tokens_path(wdir, key, arch))), mesh)
            runs = [("ring_fused", cache)]
            if arch in CHUNKED:
                runs.append(("ring_chunked", L.CacheBlock(
                    ptree.map(torch.clone, cache), cache.specs)))
            for impl, c in runs:
                j = jcfg.replace(impl=impl)
                for i in range(STEPS):
                    y, c = M.decode_step(params, c, teacher[:, i:i + 1], cfg,
                                         j)
                    res[f"{arch}/{impl}/step{i}"] = _gather_logits(
                        y, mesh).numpy()
        res[f"{arch}/generate"] = S.generate(
            params, prompts, cfg, jcfg, steps=GEN, max_len=max_len,
            extra_batch=extra).numpy()
    np.savez(wdir / f"{key}_rank{rank}.npz",
             **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()


class Launched:
    """The reference's subprocesses (``PARTS``: its mesh's devices
    emulated) and one group of the port's rank processes per mesh,
    started together; their results are read when a test first needs
    them."""

    def __init__(self, tmp):
        self.tmp = tmp
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        script = str(Path(__file__).resolve())
        self.refs = {key: [self._start(
            [script, "--reference", key, str(i), str(tmp)],
            dict(env, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                 f"--xla_force_host_platform_device_count={data * p}"),
            f"reference_{key}_{i}")
            for i in range(len(PARTS[key]))]
            for key, (data, p) in MESHES.items()}
        self.ranks = {key: [self._start(
            [script, "--rank", str(r), key,
             f"file://{tmp / f'store_{key}'}", str(tmp)], env,
            f"{key}_rank{r}") for r in range(data * p)]
            for key, (data, p) in MESHES.items()}
        self.done = {}

    def _start(self, args, env, name):
        """A subprocess whose output goes to files (a pipe left unread
        would stall it), with the name of its stderr file."""
        err = self.tmp / f"{name}.err"
        with open(self.tmp / f"{name}.out", "w") as o, open(err, "w") as e:
            proc = subprocess.Popen([sys.executable] + args, env=env,
                                    stdout=o, stderr=e)
        proc.err_path = err
        return proc

    @staticmethod
    def _wait(procs, what, timeout=600):
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                p.kill()
        for p in procs:
            assert p.returncode == 0, \
                f"{what} failed:\n{p.err_path.read_text()[-3000:]}"

    def rank_results(self, key):
        if ("ranks", key) not in self.done:
            self._wait(self.ranks[key], f"a rank of {key}")
            data, p = MESHES[key]
            self.done["ranks", key] = [
                dict(np.load(self.tmp / f"{key}_rank{r}.npz"))
                for r in range(data * p)]
        return self.done["ranks", key]

    def reference(self, key):
        if ("ref", key) not in self.done:
            self._wait(self.refs[key], f"the reference on {key}")
            self.done["ref", key] = {
                k: v for i in range(len(PARTS[key])) for k, v in np.load(
                    self.tmp / f"reference_{key}_{i}.npz").items()}
        return self.done["ref", key]

    def close(self):
        for p in [q for qs in (*self.ranks.values(), *self.refs.values())
                  for q in qs]:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    # started before the file's first test, so that the tests that need
    # no subprocess run while the subprocesses work
    runs = Launched(tmp_path_factory.mktemp("lm_mesh_serve"))
    yield runs
    runs.close()


@lru_cache(maxsize=None)
def _one_device(tmp, key, arch):
    """The port on one device, on the whole weights: the f32 prefill's
    logits and 6 decode steps teacher-forced on the reference's tokens of
    ``key`` (in ``tmp``, read after the reference's run)."""
    cfg = _port_cfg(arch)
    jcfg = jigsaw_for(cfg)
    max_len = CASES[arch][1]
    params = params_from_npz(_weights_path(tmp, arch), device="cpu")
    inp = {k: torch.from_numpy(v) for k, v in _inputs(arch).items()}
    prompts = inp["prompts"]
    with torch.no_grad():
        if _fused(arch):
            logits, cache = M.prefill_cache(params, {"tokens": prompts}, cfg,
                                            jcfg, max_len,
                                            dtype=torch.float32)
        else:
            extra = {"frames": inp["frames"]} if "frames" in inp else None
            cache = S.start_cache(params, prompts, cfg, jcfg, max_len,
                                  torch.float32, extra)
            for t in range(prompts.shape[1]):
                logits, cache = M.decode_step(params, cache,
                                              prompts[:, t:t + 1], cfg, jcfg)
        out = {"prefill": logits.numpy()}
        teacher = torch.from_numpy(np.load(_tokens_path(tmp, key, arch)))
        for i in range(STEPS):
            y, cache = M.decode_step(params, cache, teacher[:, i:i + 1], cfg,
                                     jcfg)
            out[f"step{i}"] = y.numpy()
    return out


def _rows(key, a):
    """Data rank d's rows of the whole batch ``a`` (every row where the
    data extent does not divide the batch)."""
    data, _ = MESHES[key]
    return [a[d * len(a) // data:(d + 1) * len(a) // data]
            if len(a) % data == 0 else a for d in range(data)]


def _results(launched, key, arch):
    ref = launched.reference(key)
    return ref, launched.rank_results(key), _one_device(launched.tmp, key,
                                                        arch)


# ---------------------------------------------------------------------------
# the cache's layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_cache_specs_match_reference(arch):
    """``cache_specs`` (sanitized) of the cache of the full and the
    reduced config is the reference's ``cache_specs`` + ``sanitize_tree``
    leaf for leaf at p = 2, 4 and 16 and data 1 and 2 (the reference's
    mesh shapes, no process group), in the auto, heads and seq modes; the
    blocks ``init_cache(mesh=)`` makes have the shapes of those specs and
    carry them, and ``shard_cache_1d`` / ``gather_cache_1d`` round-trip a
    whole cache bit for bit.  The auto mode is "seq" at p = 16 for every
    config with 8 kv heads and at p = 4 for the reduced ones."""
    import jax
    from repro.configs.registry import get_config as ref_get_config
    from repro.core.sharding import RULES_1D as REF_RULES_1D
    from repro.launch import specs as ref_specs
    from repro.models import registry as RM
    rng = np.random.default_rng(0)
    for full in (True, False):
        for mode in ("auto", "heads", "seq"):
            cfg = get_config(arch) if full else get_config(arch).reduced()
            cfg = cfg.replace(kv_shard=mode)
            rcfg = (ref_get_config(arch) if full
                    else ref_get_config(arch).reduced()).replace(
                        kv_shard=mode)
            shapes = jax.eval_shape(lambda: RM.init_cache(rcfg, 2, 48))
            whole = M.init_cache(cfg, 2, 48, device="meta")
            for p in (2, 4, 16):
                for data in (1, 2):
                    fake = types.SimpleNamespace(
                        shape={"data": data, "model": p})
                    want = _flat(ref_specs.sanitize_tree(
                        shapes, ref_specs.cache_specs(
                            shapes, rcfg, REF_RULES_1D, fake), fake))
                    got = _flat(specs.sanitize_tree(whole, specs.cache_specs(
                        whole, cfg, RULES_1D, fake), fake))
                    assert set(got) == set(want)
                    for k, spec in want.items():
                        assert _axes(got[k]) == _axes(spec), \
                            (k, p, data, mode)
                        if (mode, p, full, cfg.n_kv_heads) == (
                                "auto", 16, True, 8) and \
                                k.split("/")[-1] in L.KV_LEAVES:
                            assert got[k][-3] == "model", k
                    mesh = Mesh1D(p=p, r=p - 1, data_size=data,
                                  data_index=data - 1)
                    block = M.module_for(cfg).init_cache(
                        cfg, 2, 48, torch.float32, device="meta", mesh=mesh)
                    assert _flat(block.specs) == got
                    for k, t in _flat(block).items():
                        shape = _flat(whole)[k].shape
                        assert t.shape == mesh.block(torch.empty(
                            shape, device="meta"), got[k]).shape, k
            if not full and mode == "auto":
                cache = ptree.map(lambda t: torch.from_numpy(rng.normal(
                    size=t.shape).astype(np.float32)),
                    M.init_cache(cfg, 2, 48, torch.float32, device="meta"))
                for p, data in ((2, 1), (4, 1), (2, 2)):
                    blocks = [shard_cache_1d(cache, cfg, Mesh1D(
                        p=p, r=r % p, data_size=data, data_index=r // p))
                        for r in range(p * data)]
                    back = gather_cache_1d(blocks, cfg,
                                           Mesh1D(p=p, data_size=data))
                    for k, a in _flat(cache).items():
                        assert torch.equal(_flat(back)[k], a), (k, p, data)
    if get_config(arch).reduced().n_kv_heads == 2:
        assert L.kv_mode(get_config(arch).reduced(), 4) == "seq"


# ---------------------------------------------------------------------------
# prefill, decode steps and generate against the reference
# ---------------------------------------------------------------------------

def _assert_close(got, want, tol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("key,arch", RUNS)
def test_prefill_matches_reference(launched, key, arch):
    """The prefill's logits of every rank (gathered over the vocab; each
    data rank's rows) against the reference's on its mesh and the port's
    one-device prefill; the whole cache gathered from the ranks' blocks
    (``gather_cache_1d``) against the reference's, leaf for leaf."""
    ref, ranks, none = _results(launched, key, arch)
    tol = _tol(arch)
    data, p = MESHES[key]
    want = _rows(key, ref[f"{arch}/prefill"])
    one = _rows(key, none["prefill"])
    for rank, res in enumerate(ranks):
        got = res[f"{arch}/prefill"]
        _assert_close(got, want[rank // p], tol, f"{arch} prefill r{rank}")
        _assert_close(got, one[rank // p], tol, f"{arch} vs one device")
    leaves = {k[len(arch) + 7:]: v for k, v in ref.items()
              if k.startswith(f"{arch}/cache/")}
    assert leaves
    for k, v in leaves.items():
        _assert_close(ranks[0][f"{arch}/cache/{k}"], v, tol,
                      f"{arch} cache {k}")


@pytest.mark.parametrize("key,arch", RUNS)
def test_decode_matches_reference(launched, key, arch):
    """6 decode steps teacher-forced on the reference's greedy tokens:
    every step's logits on every rank against the reference's decode step
    on its mesh and the port's one-device step; ``ring_chunked`` bit for
    bit ``ring_fused``; the reference's greedy tokens the argmax of the
    mesh's logits."""
    ref, ranks, none = _results(launched, key, arch)
    tol = _tol(arch)
    vocab = _port_cfg(arch).vocab_size
    _, p = MESHES[key]
    toks = _rows(key, ref[f"{arch}/tokens"])
    for i in range(STEPS):
        want = _rows(key, ref[f"{arch}/step{i}"])
        one = _rows(key, none[f"step{i}"])
        for rank, res in enumerate(ranks):
            got = res[f"{arch}/ring_fused/step{i}"]
            _assert_close(got, want[rank // p], tol, f"{arch} step {i}")
            _assert_close(got, one[rank // p], tol, f"{arch} step {i} one")
            top = np.argmax(got[:, -1, :vocab], -1)
            assert np.array_equal(top, toks[rank // p][:, i + 1]), \
                (i, _gap(got[:, -1, :vocab]))
            if arch in CHUNKED:
                assert np.array_equal(res[f"{arch}/ring_chunked/step{i}"],
                                      got), (arch, i)


def _gap(logits):
    """The top-2 gap of each row's logits (reported with a differing
    greedy token)."""
    top = np.sort(logits, -1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("key,arch", RUNS)
def test_generate_matches_reference(launched, key, arch):
    """``generate`` on the mesh (the whole prompt batch in, bf16 cache,
    the eager loop) returns the reference's greedy tokens (its generate on
    its (data 1, model 2) mesh, ``GEN_MESH``), the whole batch's on every
    rank."""
    _, ranks, _ = _results(launched, key, arch)
    want = launched.reference(GEN_MESH)[f"{arch}/generate"]
    for rank, res in enumerate(ranks):
        got = res[f"{arch}/generate"]
        assert got.dtype == np.int32 and got.shape == want.shape
        diff = np.argwhere(got != want)
        assert not len(diff), (f"rank {rank}: first differing (row, step) "
                               f"{diff[0].tolist()}")


# ---------------------------------------------------------------------------
# the ring kernel's plans at a decode step's rows
# ---------------------------------------------------------------------------

# the ring linears of a decode step at one rank of two (label, d, m):
# h2o-danube-1.8b's and mamba2-130m's, as chip_smoke.py's
# LM_SERVE_RING_SHAPES (mamba's in_dt: chunks of 12 columns)
DECODE_RING = [("h2o.wq_wo", 2560, 2560), ("h2o.wk_wv", 2560, 640),
               ("h2o.gate_up", 2560, 6912), ("h2o.down", 6912, 2560),
               ("mamba.in_z", 768, 1536), ("mamba.in_xbc", 768, 1792),
               ("mamba.in_dt", 768, 24), ("mamba.out_proj", 1536, 768)]


@pytest.mark.parametrize("rows", [1, 4, 8])
@pytest.mark.parametrize("label,d,m", DECODE_RING)
def test_ring_fwd_plans_at_decode_rows(label, d, m, rows):
    """The bf16 forward step's operands at a decode step's M = 1-8 rows
    (two ranks): x [rows, d/2] and w_j [m/4, d/2] read K-major in [128][64]
    boxes that pass the rows' end (TMA fills them with zeros; the store
    keeps rows < R), x's rows at their own width (a multiple of 8
    elements: no padding), and the Hopper loop's one row of output tiles;
    on CPU tensors the step is its plain version, the ring of the rank's
    chunk products."""
    from repro_torch.kernels import ref, ring as RING
    dl, mc = d // 2, m // 2
    ops = RING.tma_operands_ring_fwd(rows, dl, mc)
    assert ops["x"].shape == (rows, dl) and not ops["x"].padded
    assert ops["x"].boxes == ops["w_j"].boxes == ((64, 128),)
    assert RING.sm90_tiles(rows, mc) == -(-mc // 256)
    gen = torch.Generator().manual_seed(rows)
    xs = [torch.randn(rows, dl, generator=gen).to(torch.bfloat16)
          for _ in range(2)]
    ws = [torch.randn(m, dl, generator=gen).to(torch.bfloat16)
          for _ in range(2)]
    got = RING.ring_fwd_all(xs, ws)
    want = ref.ring_fwd_all_ref(xs, ws, torch.float32)
    for a, b in zip(got, want):
        assert a.shape == (rows, mc) and torch.equal(a, b)


# ---------------------------------------------------------------------------
# what serving on a mesh refuses
# ---------------------------------------------------------------------------

def test_headdim_and_graphs_on_a_mesh_raise():
    """``kv_shard="headdim"`` on a model mesh raises NotImplementedError
    naming item 19.5 (init_cache, decode_step, prefill), before any
    collective; ``generate(graph=True)`` on a mesh raises ValueError; a
    decode step on a mesh given a plain dict (no layout) raises
    ValueError."""
    cfg = _port_cfg(H2O, scheme="1d", kv_shard="headdim")
    jcfg = jigsaw_for(cfg).replace(mesh=Mesh1D(p=2))
    with pytest.raises(NotImplementedError, match="item 19.5"):
        M.init_cache(cfg, 2, 16, device="cpu", jcfg=jcfg)
    with pytest.raises(NotImplementedError, match="item 19.5"):
        M.decode_step({}, {}, torch.zeros(2, 1, dtype=torch.int32), cfg,
                      jcfg)
    with pytest.raises(NotImplementedError, match="item 19.5"):
        M.prefill_cache({}, {"tokens": torch.zeros(2, 4, dtype=torch.int32)},
                        cfg, jcfg, 16)
    M.init_cache(cfg.replace(kv_shard="auto"), 2, 16, device="cpu",
                 jcfg=jcfg)
    with pytest.raises(ValueError, match="eagerly"):
        S.generate({}, torch.zeros(2, 4, dtype=torch.int32),
                   cfg.replace(kv_shard="auto"), jcfg, steps=2, max_len=16,
                   graph=True)
    with pytest.raises(ValueError, match="CacheBlock"):
        L.kv_layout({"k": None}, ("k",), Mesh1D(p=2))


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference_main(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    else:
        _rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
