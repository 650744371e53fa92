"""Checkpoints of the language models on a 1-D Jigsaw model mesh in the
port: each rank writes its blocks by the sanitized 1-D layout
(``transformer.param_spec_1d``), exact resume on the same mesh, elastic
restores onto other meshes, the reference's checkpoints both ways, the
training CLI's checkpoint flags and ``--supervise`` under a SIGTERM, and
the serving restore onto a model mesh.

The port's ranks are gloo processes, this file run as a script with
``--rank`` (one launched group per mesh, joined through ``file://``
stores), reduced configs from seed 0, f32 (the configs' own dtypes):

* (data 1, model 2): each family (h2o-danube-1.8b, pixtral-12b,
  phi3.5-moe-42b-a6.6b, mamba2-130m, jamba-1.5-large-398b,
  whisper-small) trains four steps with ``ckpt_every=2`` (the async
  writer: ``ck_<arch>-2`` after step 2, and the final ``ck_<arch>``), its
  blocks dumped at the save; a fresh engine resumes from ``ck_<arch>-2``
  and runs step 3.  Then one device's checkpoint and the reference's are
  restored onto the mesh, and h2o's and mamba2-130m's ``ck-2`` is served
  (``restore_serving_params(mesh=, specs=)``, then ``generate``);
* (data 1, model 4) and (data 2, model 2) with ZeRO-1: h2o's and jamba's
  ``ck-2`` restored (elastic), then saved again from the new mesh; on
  (data 2, model 2) also a data-only engine (model 1, data 4) restores it.
  Every engine of the ranks runs its config without the FSDP hybrid
  (jamba's config asks for it; on more than one data rank a language
  model refuses it, item 19.3; the layout on one data rank is the same).

The reference runs on two host-emulated devices in a subprocess
(``--reference``, its SSD term swapped in process for the zoo test's
``SAFE_SSD``): its (data 1, model 2) ``TrainEngine`` saves h2o after one
step and jamba at init, then resumes the port's ``ck-2`` of each and runs
step 3.  The training CLI runs under ``torch.distributed.run`` (``--ckpt
--ckpt-every 2``, then ``--resume``), and once with ``--supervise``, rank
1 alone signalled after step 1 (its chaos env, set by a
``sitecustomize`` on the supervised world's path).

Tolerances: the port's histories, leaves, blocks and tokens bit for bit;
the reference's resumed step 1e-4 relative (its sums run in another
order, as ``test_torch_checkpoint_mesh.py``).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (load_manifest, restore_serving_params,
                                    restore_tree)
from repro_torch.checkpoint import manifest as MF
from repro_torch.checkpoint.sharded import snapshot
from repro_torch.configs.registry import get_config
from repro_torch.convert import (gather_params_1d, params_from_numpy,
                                 shard_params_1d)
from repro_torch.core import tree as ptree
from repro_torch.core.sharding import Mesh1D
from repro_torch.launch import resilience
from repro_torch.launch.engine import EngineConfig, TrainEngine
from repro_torch.models.transformer import param_spec_1d as LM_SPEC

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
HIST_KEYS = ("loss", "grad_norm", "lr")
FAMILIES = ("h2o-danube-1.8b", "jamba-1.5-large-398b", "pixtral-12b",
            "phi3.5-moe-42b-a6.6b", "mamba2-130m", "whisper-small")
ELASTIC = ("h2o-danube-1.8b", "jamba-1.5-large-398b")
SERVED = ("h2o-danube-1.8b", "mamba2-130m")
# (data, model) of each launched mesh
MESHES = {"m2": (1, 2), "m4": (1, 4), "d2m2": (2, 2)}
STEPS, EVERY = 4, 2
COMMON = dict(steps=STEPS, batch=4, seq_len=16, log_every=1, prefetch=0,
              seed=0)
GEN_PROMPT, GEN_STEPS = (4, 2), 4
CLI_ARCH = "h2o-danube-1.8b"
TIMEOUT = 300


def _flat(tree):
    """{"a/b/0/c": leaf} of a tree of tensors, ints or arrays."""
    out = {}
    ptree.map_with_path(
        lambda path, a: out.__setitem__("/".join(map(str, path)), a), tree)
    return out


def _np(v):
    return (v.detach().clone().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v))


def _same(a, b):
    a, b = _np(a), _np(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _wait_for(path, timeout=TIMEOUT):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)


def _config(**kw):
    return EngineConfig(**dict(COMMON, telemetry=False, **kw))


def _prompts(arch):
    v = get_config(arch).reduced().vocab_size
    return torch.from_numpy(np.random.default_rng(5).integers(
        0, v, GEN_PROMPT).astype(np.int32))


# ---------------------------------------------------------------------------
# the reference (subprocess) and the port's ranks
# ---------------------------------------------------------------------------

def _reference_main(path, wdir):
    """The reference's (data 1, model 2) checkpoints of h2o (after one
    step) and jamba (at init), then its resume of the port's ``ck-2`` of
    each: step 3's loss, grad norm and lr."""
    import test_torch_lm_mesh_zoo as Z
    from repro.launch.engine import EngineConfig as REngineConfig
    from repro.launch.engine import TrainEngine as RTrainEngine
    Z._install_safe_ssd()
    wdir = Path(wdir)

    def engine(arch, **kw):
        return RTrainEngine(arch, reduced=True, mesh_model=2, mesh_data=1,
                            scheme="1d", impl="rs", kernel="xla",
                            config=REngineConfig(**dict(
                                COMMON, telemetry=False, **kw)))
    out = {}
    engine(ELASTIC[0], steps=1, ckpt=str(wdir / f"refck_{ELASTIC[0]}")).run()
    eng = engine(ELASTIC[1], steps=1)
    eng.save(str(wdir / f"refck_{ELASTIC[1]}"), block=True)
    eng.wait_checkpoints()
    for arch in ELASTIC:
        ck = wdir / f"ck_{arch}-{EVERY}"
        _wait_for(ck / "manifest.json")
        eng = engine(arch, resume=str(ck))
        out[f"{arch}/at"] = np.array(eng.step_idx)
        hist = eng.run()
        for k in HIST_KEYS:
            out[f"{arch}/{k}"] = np.array([h[k] for h in hist])
    np.savez(path, **out)


def _dump(res, tag, eng, opt=True):
    """This rank's blocks of ``eng``'s params and optimizer state (a copy:
    the steps update them in place)."""
    for k, v in _flat(eng.params).items():
        res[f"{tag}/params/{k}"] = _np(v)
    if opt:
        for k, v in _flat(eng.opt_state).items():
            res[f"{tag}/opt/{k}"] = _np(v)
    if eng.zero1 is not None:
        for k, d in _flat(eng.zero1.dims).items():
            res[f"{tag}/zero1/{k}"] = np.array(-1 if d is None else d)


def _history(res, tag, hist):
    res[f"{tag}/steps"] = np.array([h["step"] for h in hist])
    for k in HIST_KEYS:
        res[f"{tag}/{k}"] = np.array([h[k] for h in hist])


def _serve(res, arch, eng, blocks, path):
    """``ck-2`` restored as this rank's blocks for serving, then greedy
    tokens from it and from the blocks the engine held at the save."""
    from repro_torch.serve.step import generate
    params, man = restore_serving_params(
        path, arch=arch, like=eng.params, mesh=eng.mesh,
        specs=eng.param_specs)
    res[f"serve/{arch}/step"] = np.array(man.step)
    res[f"serve/{arch}/same"] = np.array(all(
        _same(params_l, blocks_l) for params_l, blocks_l in
        zip(ptree.leaves(params), ptree.leaves(blocks))))
    prompts = _prompts(arch)
    for tag, p in (("restored", params), ("memory", blocks)):
        with torch.no_grad():
            res[f"serve/{arch}/{tag}"] = generate(
                p, prompts, eng.cfg, eng.jcfg, steps=GEN_STEPS,
                max_len=GEN_PROMPT[1] + GEN_STEPS, graph=False).numpy()


def _rank_main(rank, key, init, wdir):
    """One rank of the mesh ``key``; results to <key>_rank<r>.npz."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    data, p = MESHES[key]
    wdir = Path(wdir)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=data * p)
    res = {}

    def engine(arch, model=p, mdata=data, **kw):
        # jamba's config asks for the FSDP hybrid, which a language model
        # on more than one data rank refuses (item 19.3): its layout
        # without it
        cfg = get_config(arch).replace(shard_params_over_data=False)
        return TrainEngine(arch, mesh_model=model, mesh_data=mdata,
                           device="cpu", config_override=cfg,
                           config=_config(**kw))

    if key == "m2":
        for arch in FAMILIES:
            eng = engine(arch, ckpt=str(wdir / f"ck_{arch}"),
                         ckpt_every=EVERY)
            save, at_save = eng.save, {}

            def hooked(path, *a, eng=eng, save=save, at_save=at_save,
                       arch=arch, **kw):
                periodic = path.endswith(f"-{EVERY}")
                if periodic:
                    _dump(res, f"{arch}/at_save", eng, opt=False)
                    at_save["params"] = ptree.map(torch.clone, eng.params)
                save(path, *a, **kw)
                if periodic:
                    res[f"{arch}/bytes"] = np.array(
                        eng.last_save.bytes_per_rank[rank])
            eng.save = hooked
            _history(res, f"{arch}/full", eng.run())
            _dump(res, f"{arch}/full", eng)
            dist.barrier()          # rank 0's writer merged the manifests
            if arch in SERVED:
                _serve(res, arch, eng, at_save["params"],
                       str(wdir / f"ck_{arch}-{EVERY}"))
            eng.close()
            eng = engine(arch, resume=str(wdir / f"ck_{arch}-{EVERY}"))
            res[f"{arch}/resume_at"] = np.array(
                [eng.step_idx, eng.pipeline.cursor, eng.opt_state["step"]])
            _history(res, f"{arch}/resumed", eng.run())
            _dump(res, f"{arch}/resumed", eng)
            eng.close()
        # one device's checkpoint and the reference's onto the mesh
        for arch in ELASTIC:
            for tag, ck, kw in (("one", f"one_{arch}", {}),
                                ("ref", f"refck_{arch}", {"steps": 1})):
                _wait_for(wdir / ck / "manifest.json")
                eng = engine(arch, resume=str(wdir / ck), **kw)
                res[f"{tag}/{arch}/at"] = np.array(
                    [eng.step_idx, eng.opt_state["step"]])
                _dump(res, f"{tag}/{arch}", eng)
                eng.close()
    else:
        # elastic: ck-2 of (data 1, model 2) on this mesh, then saved
        # again from it
        for arch in ELASTIC:
            ck = wdir / f"ck_{arch}-{EVERY}"
            _wait_for(ck / "manifest.json")
            eng = engine(arch, zero1=data > 1, resume=str(ck))
            res[f"{arch}/at"] = np.array(
                [eng.step_idx, eng.pipeline.cursor, eng.opt_state["step"]])
            _dump(res, f"{arch}/restored", eng)
            eng.save(str(wdir / f"re_{key}_{arch}"), block=True)
            res[f"{arch}/bytes"] = np.array(
                eng.last_save.bytes_per_rank[rank])
            eng.close()
        if key == "d2m2":
            # a data-only mesh: the whole model on each of four ranks
            eng = engine(ELASTIC[0], model=1, mdata=4, zero1=True,
                         resume=str(wdir / f"ck_{ELASTIC[0]}-{EVERY}"))
            res["data_only/at"] = np.array([eng.step_idx,
                                            eng.opt_state["step"]])
            _dump(res, "data_only", eng)
            eng.close()
    res["coord"] = np.array([rank // p, rank % p])
    np.savez(wdir / f"{key}_rank{rank}.npz", **res)
    dist.destroy_process_group()


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    env.pop(resilience.PREEMPT_ENV, None)
    env.pop("WORLD_SIZE", None)
    env.update(kw)
    return env


def _cli_args(tag, *args):
    return ["--arch", CLI_ARCH, "--mesh-model", "2", "--device", "cpu",
            "--steps", str(STEPS), "--batch", "4", "--seq-len", "16",
            "--log-every", "1", "--prefetch", "0", "--metrics-out",
            f"{tag}.jsonl", *args]


def _torchrun(tmp, tag, *args):
    """The training CLI on two gloo ranks under torch.distributed.run."""
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         *_cli_args(tag, *args)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=tmp)


def _supervised(tmp):
    """``--supervise`` on two ranks (it launches the world itself); a
    ``sitecustomize`` on the path arms rank 1's chaos hook alone, so that
    rank takes the SIGTERM after step 1 (the relaunch resumes past it)."""
    site = tmp / "rank1_preempt"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import os\n"
        "if os.environ.get('RANK') == '1':\n"
        f"    os.environ.setdefault({resilience.PREEMPT_ENV!r}, '1')\n")
    env = _env()
    env["PYTHONPATH"] += os.pathsep + str(site)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train",
         *_cli_args("sup", "--ckpt", "sup/ck", "--supervise")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=tmp)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    finally:
        proc.kill()
    return proc.returncode, out, err


def _read_jsonl(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()
            if line.strip()]


class Launched:
    """The reference's subprocess, one group of the port's rank processes
    per mesh of ``MESHES`` and the CLI runs, started together; their
    results are read when a test first needs them."""

    def __init__(self, tmp):
        self.tmp = tmp
        script = str(Path(__file__).resolve())
        self.ranks = {key: [subprocess.Popen(
            [sys.executable, script, "--rank", str(r), key,
             f"file://{tmp / f'store_{key}'}", str(tmp)], env=_env(),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(data * p)] for key, (data, p) in MESHES.items()}
        self.ref_path = tmp / "reference.npz"
        self.ref = subprocess.Popen(
            [sys.executable, script, "--reference", str(self.ref_path),
             str(tmp)],
            env=_env(JAX_PLATFORMS="cpu",
                     XLA_FLAGS="--xla_force_host_platform_device_count=2"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.cli = _torchrun(tmp, "cli", "--ckpt", "cli", "--ckpt-every",
                             str(EVERY))
        self.sup = _supervised(tmp)
        self._done = {}

    @staticmethod
    def _wait(procs, what):
        try:
            outs = [p.communicate(timeout=TIMEOUT) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, f"{what} failed:\n{err[-3000:]}"

    def rank_results(self, key):
        if key not in self._done:
            self._wait(self.ranks[key], f"a rank of {key}")
            data, p = MESHES[key]
            self._done[key] = [dict(np.load(self.tmp / f"{key}_rank{r}.npz"))
                               for r in range(data * p)]
        return self._done[key]

    def reference(self):
        if "ref" not in self._done:
            self._wait([self.ref], "the reference")
            self._done["ref"] = dict(np.load(self.ref_path))
        return self._done["ref"]

    def cli_history(self):
        if "cli" not in self._done:
            code, _, err = _finish(self.cli)
            assert code == 0, err[-3000:]
            self._done["cli"] = _read_jsonl(self.tmp / "cli.jsonl")
        return self._done["cli"]

    def close(self):
        procs = [q for qs in self.ranks.values() for q in qs]
        for p in procs + [self.ref, self.cli, self.sup]:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh_ckpt")
    torch.set_num_threads(1)
    # one device's checkpoints (after one step) for the ranks to restore
    for arch in ELASTIC:
        eng = TrainEngine(arch, device="cpu", config=_config())
        eng.dispatch(eng.pipeline.get(0))
        eng.save(str(tmp / f"one_{arch}"), block=True)
    runs = Launched(tmp)
    yield runs
    runs.close()


def _blocks(res, tag):
    """A rank's dumped tree ``tag`` ("params" or "opt"), flat."""
    pre = f"{tag}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _whole(path, group="params"):
    return _flat(restore_tree(str(path), group))


def _tree_like(template, flat):
    """A tree shaped as ``template`` with the leaves of a flat dump."""
    return ptree.map_with_path(
        lambda path, _: torch.from_numpy(flat["/".join(map(str, path))]),
        template)


def _shards_of(tree, ranks, p, data=1):
    """``shard_params_1d`` of a whole tree for each rank, flat."""
    return [_flat(shard_params_1d(tree, int(r["coord"][1]), p,
                                  int(r["coord"][0]), data, spec=LM_SPEC))
            for r in ranks]


def _bytes_by_writer(path, n):
    """Each rank's bytes in a checkpoint's manifest, after checking that
    the shards of every leaf tile it exactly (their volumes sum to the
    leaf's, and a whole restore finds no hole) and that a leaf the layout
    leaves whole is written once, by rank 0."""
    man = load_manifest(str(path))
    out = [0] * n
    for g in man.groups.values():
        for key, e in g.items():
            vols = [int(np.prod([b - a for a, b in s.bounds]))
                    for s in e.shards]
            assert sum(vols) == int(np.prod(e.shape)), key
            if not any(MF.spec_from_json(e.spec)):
                assert [s.device for s in e.shards] == [0], key
            for s, v in zip(e.shards, vols):
                out[s.device] += v * MF.dtype_entry(e.dtype)[1].itemsize
    return out


# ---------------------------------------------------------------------------
# exact resume and the one-device view of the mesh's save
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_exact_resume_every_family(launched, arch):
    """Four steps on (data 1, model 2) with ``ckpt_every=2`` (the async
    writer); a fresh engine resumed from ``ck-2`` starts at step 3, cursor
    3, Adam step 3, and its step 3 (loss, grad norm, lr) and every leaf of
    its params and optimizer state equal the uninterrupted run's, bit for
    bit, on both ranks."""
    for res in launched.rank_results("m2"):
        assert list(res[f"{arch}/full/steps"]) == list(range(STEPS))
        assert list(res[f"{arch}/resume_at"]) == [EVERY + 1] * 3
        assert list(res[f"{arch}/resumed/steps"]) == [EVERY + 1]
        for k in HIST_KEYS:
            assert np.array_equal(res[f"{arch}/resumed/{k}"],
                                  res[f"{arch}/full/{k}"][EVERY + 1:]), k
        full = {k: v for k, v in res.items()
                if k.startswith(f"{arch}/full/p") or
                k.startswith(f"{arch}/full/o")}
        assert len(full) > 10
        for k, v in full.items():
            got = res[k.replace("/full/", "/resumed/")]
            assert _same(got, v), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_save_restores_on_one_device(launched, arch):
    """``ck-2``'s params restored whole on one device are
    ``gather_params_1d`` of the ranks' blocks at the save, bit for bit,
    and so are those of a one-device ``TrainEngine(resume=)`` (the save's
    ``scheme`` "1d" does not refuse an engine whose scheme is "none")."""
    ranks = launched.rank_results("m2")
    path = launched.tmp / f"ck_{arch}-{EVERY}"
    template = restore_tree(str(path), "params")
    blocks = [_tree_like(template, _blocks(r, f"{arch}/at_save/params"))
              for r in ranks]
    want = _flat(gather_params_1d(blocks, 2, spec=LM_SPEC))
    got = _flat(template)
    assert got.keys() == want.keys()
    assert all(_same(got[k], want[k]) for k in want)
    assert load_manifest(str(path)).extra["scheme"] == "1d"
    one = TrainEngine(arch, device="cpu", config=_config(resume=str(path)))
    assert one.step_idx == EVERY + 1 and one.cfg.scheme == "none"
    mine = _flat(one.params)
    assert all(_same(mine[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# elastic restores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ELASTIC)
@pytest.mark.parametrize("key", ["m4", "d2m2"])
def test_elastic_restore_onto_other_meshes(launched, arch, key):
    """``ck-2`` of (data 1, model 2) on (data 1, model 4) and on (data 2,
    model 2) with ZeRO-1: each rank's params and moments are
    ``shard_params_1d`` of the whole restore, the moments then ZeRO-1's
    slice along the dim it cuts, bit for bit; step, cursor and Adam step
    3."""
    data, p = MESHES[key]
    path = launched.tmp / f"ck_{arch}-{EVERY}"
    whole = restore_tree(str(path), "params")
    opt = restore_tree(str(path), "opt_state")
    ranks = launched.rank_results(key)
    for group in ("params", "mu", "nu"):
        src = whole if group == "params" else opt[group]
        for res, want in zip(ranks, _shards_of(src, ranks, p, data)):
            assert list(res[f"{arch}/at"]) == [EVERY + 1] * 3
            tag = "params" if group == "params" else f"opt/{group}"
            got = _blocks(res, f"{arch}/restored/{tag}")
            assert got.keys() == want.keys(), group
            d = int(res["coord"][0])
            for k, v in want.items():
                dim = (-1 if group == "params" else
                       int(res.get(f"{arch}/restored/zero1/{k}", -1)))
                if dim >= 0:
                    n = v.shape[dim] // data
                    v = v.narrow(dim, d * n, n)
                assert _same(got[k], v), (group, k)
    if key == "d2m2":
        assert any(int(v) >= 0 for k, v in ranks[0].items()
                   if k.startswith(f"{arch}/restored/zero1/"))


@pytest.mark.parametrize("arch", ELASTIC)
@pytest.mark.parametrize("key", ["m2", "m4", "d2m2"])
def test_each_byte_is_written_once(launched, arch, key):
    """The ranks of each mesh write every leaf's bytes exactly once between
    them (the leaves every rank holds whole by rank 0, none twice, none
    never), each rank the bytes of its own shards; the save made after the
    elastic restore is ``ck-2`` again, bit for bit."""
    data, p = MESHES[key]
    path = launched.tmp / (f"ck_{arch}-{EVERY}" if key == "m2"
                           else f"re_{key}_{arch}")
    per = [int(r[f"{arch}/bytes"]) for r in launched.rank_results(key)]
    assert per == _bytes_by_writer(path, data * p)
    assert min(per) > 0
    if key != "m2":
        for g in ("params", "opt_state"):
            a, b = _whole(path, g), _whole(
                launched.tmp / f"ck_{arch}-{EVERY}", g)
            assert a.keys() == b.keys()
            assert all(_same(a[k], b[k]) for k in a), g


@pytest.mark.parametrize("arch", ELASTIC)
def test_one_device_checkpoint_onto_model_2(launched, arch):
    """A one-device checkpoint (after one step) restored on (data 1, model
    2): every block is ``shard_params_1d`` of the whole tree, the moments
    too, bit for bit; and ``ck-2`` on a data-only mesh of four ranks with
    ZeRO-1 holds the whole params on each."""
    path = launched.tmp / f"one_{arch}"
    ranks = launched.rank_results("m2")
    whole = restore_tree(str(path), "params")
    mu = restore_tree(str(path), "opt_state")["mu"]
    for res, wp, wm in zip(ranks, _shards_of(whole, ranks, 2),
                           _shards_of(mu, ranks, 2)):
        assert list(res[f"one/{arch}/at"]) == [1, 1]
        got = _blocks(res, f"one/{arch}/params")
        assert got.keys() == wp.keys()
        assert all(_same(got[k], wp[k]) for k in wp)
        got = _blocks(res, f"one/{arch}/opt/mu")
        assert all(_same(got[k], wm[k]) for k in wm)
    if arch == ELASTIC[0]:
        ck = _whole(launched.tmp / f"ck_{arch}-{EVERY}")
        for res in launched.rank_results("d2m2"):
            assert list(res["data_only/at"]) == [EVERY + 1] * 2
            got = _blocks(res, "data_only/params")
            assert got.keys() == ck.keys()
            assert all(_same(got[k], ck[k]) for k in ck)


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ELASTIC)
def test_reference_mesh_checkpoint_restores_in_port(launched, arch):
    """The reference's (data 1, model 2) checkpoint (two emulated
    devices) restores on the port's (data 1, model 2): each rank's params
    and moments are ``shard_params_1d`` of the whole tree as the
    reference's ``restore_tree`` reads it, bit for bit."""
    from repro.checkpoint import sharded as ref_sharded
    ranks = launched.rank_results("m2")
    path = str(launched.tmp / f"refck_{arch}")
    ref = {g: ref_sharded.restore_tree(path, g)
           for g in ("params", "opt_state")}
    whole = params_from_numpy(ref["params"], device="cpu")
    mu = params_from_numpy(ref["opt_state"]["mu"], device="cpu")
    step = int(ref["opt_state"]["step"])
    for res, wp, wm in zip(ranks, _shards_of(whole, ranks, 2),
                           _shards_of(mu, ranks, 2)):
        assert list(res[f"ref/{arch}/at"]) == [load_manifest(path).step,
                                               step]
        got = _blocks(res, f"ref/{arch}/params")
        assert got.keys() == wp.keys()
        assert all(_same(got[k], wp[k]) for k in wp)
        got = _blocks(res, f"ref/{arch}/opt/mu")
        assert all(_same(got[k], wm[k]) for k in wm)


@pytest.mark.parametrize("arch", ELASTIC)
def test_port_mesh_checkpoint_resumes_in_reference(launched, arch):
    """The port's ``ck-2`` of (data 1, model 2), resumed by the
    reference's ``TrainEngine`` on its (data 1, model 2) mesh: it starts at
    step 3, and its step 3 is within 1e-4 relative of the port's."""
    ref = launched.reference()
    port = launched.rank_results("m2")[0]
    assert int(ref[f"{arch}/at"]) == EVERY + 1
    for k in HIST_KEYS:
        got, want = ref[f"{arch}/{k}"], port[f"{arch}/full/{k}"][EVERY + 1:]
        assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-4, k


# ---------------------------------------------------------------------------
# the CLI, the supervisor, serving
# ---------------------------------------------------------------------------

def test_cli_ckpt_and_resume_under_torchrun(launched):
    """``launch/train.py --arch h2o-danube-1.8b --mesh-model 2 --ckpt cli
    --ckpt-every 2`` on two gloo ranks, then ``--resume cli-2``: the
    resumed run's step 3 is the first run's bit for bit."""
    first = launched.cli_history()
    assert [r["step"] for r in first] == list(range(STEPS))
    assert (launched.tmp / "cli" / "manifest.json").exists()
    code, _, err = _finish(_torchrun(launched.tmp, "cli_resumed",
                                     "--resume", f"cli-{EVERY}"))
    assert code == 0, err[-3000:]
    again = _read_jsonl(launched.tmp / "cli_resumed.jsonl")
    assert [r["step"] for r in again] == [EVERY + 1]
    assert all(again[0][k] == first[-1][k] for k in HIST_KEYS)


def test_cli_supervise_survives_a_sigterm_to_rank_1(launched):
    """``--supervise`` on two ranks, rank 1 alone taking a SIGTERM after
    step 1: both ranks stop after that step and take the final save
    ``ck-1``, the supervisor relaunches the world from it, and the
    appended history is the uninterrupted CLI run's bit for bit."""
    code, out, err = _finish(launched.sup)
    assert code == 0, err[-3000:]
    assert out.count("[supervisor] resumable exit (75)") == 1
    assert "origin rank 1" in out
    ck = launched.tmp / "sup" / "ck-1"
    assert load_manifest(str(ck)).step == 2
    hist = _read_jsonl(launched.tmp / "sup.jsonl")
    want = launched.cli_history()
    assert [h["step"] for h in hist] == list(range(STEPS))
    assert [[h[k] for k in HIST_KEYS] for h in hist] == \
        [[h[k] for k in HIST_KEYS] for h in want]


@pytest.mark.parametrize("arch", SERVED)
def test_serving_restore_onto_model_mesh_feeds_generate(launched, arch):
    """``restore_serving_params(ck-2, mesh=, specs=)`` on each rank of
    (data 1, model 2) gives the blocks the engine held at the save, bit for
    bit, and ``generate`` from them the same greedy tokens as from those
    blocks in memory, on both ranks."""
    ranks = launched.rank_results("m2")
    for res in ranks:
        assert int(res[f"serve/{arch}/step"]) == EVERY + 1
        assert bool(res[f"serve/{arch}/same"])
        assert res[f"serve/{arch}/restored"].shape == GEN_PROMPT[:1] + (
            GEN_STEPS,)
        assert np.array_equal(res[f"serve/{arch}/restored"],
                              res[f"serve/{arch}/memory"])
        assert np.array_equal(res[f"serve/{arch}/restored"],
                              ranks[0][f"serve/{arch}/restored"])


def test_serving_restore_reads_blocks_and_checks_global_shapes(launched):
    """In one process, each rank's place on (data 1, model 2) as a plain
    ``Mesh1D``: the serving restore of ``ck-2`` is ``shard_params_1d`` of
    the whole params, its dtype cast to ``like``'s; a ``like`` whose
    global shapes are another config's raises ValueError naming the leaf,
    before any read."""
    arch = ELASTIC[0]
    path = str(launched.tmp / f"ck_{arch}-{EVERY}")
    whole = restore_tree(path, "params")
    for r in range(2):
        mesh = Mesh1D(p=2, r=r)
        like = shard_params_1d(whole, r, 2, spec=LM_SPEC)
        pspecs = ptree.map_with_path(
            lambda path_, a: LM_SPEC(path_, a.ndim), whole)
        from repro_torch.launch.specs import sanitize_tree
        pspecs = sanitize_tree(whole, pspecs, mesh)
        got, man = restore_serving_params(path, arch=arch, like=like,
                                          mesh=mesh, specs=pspecs)
        assert man.step == EVERY + 1
        for a, b in zip(ptree.leaves(got), ptree.leaves(like)):
            assert _same(a, b)
        half = ptree.map(lambda t: t.to(torch.bfloat16), like)
        got, _ = restore_serving_params(path, like=half, mesh=mesh,
                                        specs=pspecs)
        assert all(a.dtype == torch.bfloat16 for a in ptree.leaves(got))
        bad = dict(like, embed={"table": like["embed"]["table"][:, :8]})
        with pytest.raises(ValueError, match="embed/table.*global shape"):
            restore_serving_params(path, like=bad, mesh=mesh, specs=pspecs)


def test_layer_lists_must_share_one_spec():
    """A layer list whose layers name different specs for one key cannot
    be saved stacked: the save raises ValueError naming the key, where
    taking the first layer's spec would write wrong bounds."""
    mesh = Mesh1D(p=2, r=0)
    params = {"layers": [{"w": torch.zeros(4, 4)}, {"w": torch.zeros(4, 4)}]}
    specs = {"layers": [{"w": (None, "model")}, {"w": ("model", None)}]}
    with pytest.raises(ValueError, match="layers/w"):
        snapshot({"params": params}, mesh=mesh, specs={"params": specs})
    specs["layers"][1]["w"] = (None, "model")
    snap = snapshot({"params": params}, mesh=mesh, specs={"params": specs})
    assert snap.manifest.groups["params"]["layers/w"].shape == (2, 4, 8)


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        sys.path.insert(0, str(HERE))
        _reference_main(sys.argv[2], sys.argv[3])
    else:
        _rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
