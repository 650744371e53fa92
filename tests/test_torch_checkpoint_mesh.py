"""The port's sharded checkpoints on meshes of gloo ranks, and against the
JAX package's meshes.

Four ranks of this file run as scripts (``--rank``, a ``file://`` store
per phase in the test's temporary directory), the reduced weathermixer-1b
from seed 0, fp32:

* (data 2, p 2) 1-D ``ring_fused`` with ZeRO-1: six steps without
  checkpoints, then six with the async writer saving ``ck1d-3`` (step 4)
  and the final ``ck1d``, then a fresh engine resumed from ``ck1d-3``
  (the reference's ``scenario_resume_exact``);
* a 2x2 (``scheme="2d"``) run of two steps saving ``ck2d``;
* ranks 0 and 1 alone, (data 1, p 2) without ZeRO-1, resumed from
  ``ck1d-3`` (elastic: a smaller mesh, another optimizer layout);
* all four again, (data 2, p 2) with ZeRO-1, resumed from the reference's
  checkpoint of its (data 2, model 4) ZeRO-1 mesh.

The reference runs on eight host-emulated devices in a subprocess
(``--reference``): two steps on (data 2, model 4) with ZeRO-1 saving
``refck``, then its ``TrainEngine(resume=)`` of the port's ``ck1d-3`` on
(data 2, model 2) with ZeRO-1.  The training CLI runs twice under
``torch.distributed.run`` (two ranks, ``--ckpt`` then ``--resume``).

Tolerances: the port's resumed histories and every restored block bit for
bit; the reference's resumed history 1e-4 relative (its sums run in
another order, as ``test_torch_data_parallel.py``).
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

from repro.checkpoint import sharded as ref_sharded
from repro_torch.checkpoint import load_manifest, restore_tree
from repro_torch.checkpoint import manifest as MF
from repro_torch.configs.registry import get_config
from repro_torch.convert import (gather_params_2d, params_from_numpy,
                                 params_to_numpy, param_bounds,
                                 shard_params_1d, shard_params_2d)
from repro_torch.core import tree as ptree
from repro_torch.core.sharding import Mesh, Mesh1D
from repro_torch.launch.engine import EngineConfig, TrainEngine
from repro_torch.models import registry as M
from repro_torch.models.transformer import param_spec_1d as LM_SPEC
from repro_torch.serve.engine import ForecastEngine, ServeConfig
from test_torch_cannon import Launched

ROOT = Path(__file__).resolve().parents[1]
HIST_KEYS = ("loss", "grad_norm", "lr")
STEPS = 6
ONE_D = dict(scheme="1d", impl="ring_fused")


def _flat(tree):
    """{"a/b/0/c": leaf} of a tree of tensors, ints or arrays."""
    out = {}
    ptree.map_with_path(
        lambda path, a: out.__setitem__("/".join(map(str, path)), a), tree)
    return out


def _config(**kw):
    return EngineConfig(steps=kw.pop("steps", STEPS), batch=2, log_every=1,
                        prefetch=0, telemetry=False, seed=0, **kw)


def _wait_for(path, timeout=600):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.1)


# ---------------------------------------------------------------------------
# the reference (subprocess) and the port's ranks
# ---------------------------------------------------------------------------

def _reference_main(path):
    from repro.launch.engine import EngineConfig as REngineConfig
    from repro.launch.engine import TrainEngine as RTrainEngine
    tmp = Path(path).parent

    def config(**kw):
        return REngineConfig(batch=2, log_every=1, prefetch=0,
                             telemetry=False, zero1=True, seed=0, **kw)

    RTrainEngine("weathermixer-1b", mesh_model=4, mesh_data=2, kernel="xla",
                 config=config(steps=2, ckpt=str(tmp / "refck")),
                 **ONE_D).run()
    _wait_for(tmp / "ck1d-3" / "manifest.json")
    eng = RTrainEngine("weathermixer-1b", mesh_model=2, mesh_data=2,
                       kernel="xla", **ONE_D,
                       config=config(steps=STEPS,
                                     resume=str(tmp / "ck1d-3")))
    out = {"resume_at": np.array([eng.step_idx, eng.pipeline.cursor])}
    hist = eng.run()
    for k in HIST_KEYS:
        out[k] = np.array([h[k] for h in hist])
    np.savez(path, **out)


def _dump(res, tag, eng):
    for k, v in _flat(eng.params).items():
        res[f"{tag}/params/{k}"] = v.numpy()
    for k, v in _flat(eng.opt_state["mu"]).items():
        res[f"{tag}/mu/{k}"] = v.numpy()
    if eng.zero1 is not None:
        for k, d in _flat(eng.zero1.dims).items():
            res[f"{tag}/zero1/{k}"] = np.array(-1 if d is None else d)


def _rank_main(rank, init, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = Path(out_dir)
    res = {}

    def engine1d(mesh_data=2, zero1=True, **kw):
        return TrainEngine("weathermixer-1b", mesh_model=2,
                           mesh_data=mesh_data, device="cpu",
                           config=_config(zero1=zero1, **kw), **ONE_D)

    def history(tag, hist):
        for k in HIST_KEYS:
            res[f"{tag}/{k}"] = np.array([h[k] for h in hist])

    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=4)
    # (data 2, p 2), ZeRO-1: without checkpoints, then with the async
    # writer saving ck1d-3 and ck1d, then resumed from ck1d-3
    eng = engine1d()
    history("plain", eng.run())
    res["ij"] = np.array([eng.mesh.data_index, eng.mesh.r])
    eng.close()
    eng = engine1d(ckpt=str(out / "ck1d"), ckpt_every=3)
    history("ckpt", eng.run())
    res["bytes_1d"] = np.array(eng.last_save.bytes_per_rank[rank])
    eng.close()
    dist.barrier()              # rank 0's writer has merged the manifest
    eng = engine1d(resume=str(out / "ck1d-3"))
    res["resume_at"] = np.array([eng.step_idx, eng.pipeline.cursor,
                                 eng.opt_state["step"]])
    history("resumed", eng.run())
    eng.close()
    # 2x2: two steps, a final save
    eng = TrainEngine("weathermixer-1b", mesh_model=4, scheme="2d",
                      device="cpu", config=_config(steps=2,
                                                   ckpt=str(out / "ck2d")))
    eng.run()
    res["rank_2d"] = np.array(eng.mesh.rank)
    res["bytes_2d"] = np.array(eng.last_save.bytes_per_rank[rank])
    _dump(res, "2d", eng)
    eng.close()
    dist.barrier()
    dist.destroy_process_group()
    # elastic: ranks 0 and 1 alone, (data 1, p 2), no ZeRO-1
    if rank < 2:
        dist.init_process_group("gloo", init_method=f"file://{out}/store_b",
                                rank=rank, world_size=2)
        eng = engine1d(mesh_data=1, zero1=False,
                       resume=str(out / "ck1d-3"))
        res["b/r"] = np.array(eng.mesh.r)
        res["b/step"] = np.array(eng.step_idx)
        _dump(res, "b", eng)
        eng.close()
        dist.destroy_process_group()
    # the reference's (data 2, model 4) ZeRO-1 checkpoint on (data 2, p 2)
    _wait_for(out / "refck" / "manifest.json")
    dist.init_process_group("gloo", init_method=f"file://{out}/store_c",
                            rank=rank, world_size=4)
    eng = engine1d(steps=2, resume=str(out / "refck"))
    res["c/step"] = np.array([eng.step_idx, eng.opt_state["step"]])
    _dump(res, "c", eng)
    eng.close()
    dist.destroy_process_group()
    np.savez(out / f"rank{rank}.npz", **res)


def _cli(tmp, tag, *args):
    """The training CLI on two gloo ranks (data 1, p 2)."""
    out = tmp / f"{tag}.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--steps", "4", "--log-every", "1",
         "--prefetch", "0", "--mesh-model", "2", "--scheme", "1d",
         "--impl", "ring_fused", "--batch", "2", "--metrics-out", str(out),
         *args],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=tmp)
    proc.out = out
    return proc


def _history(proc):
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return [json.loads(line) for line in proc.out.read_text().splitlines()]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt_mesh")
    runs = Launched(tmp, __file__, ranks=4, devices=8)
    runs.cli = _cli(tmp, "cli_full", "--ckpt", "cli", "--ckpt-every", "2",
                    "--sync-save")
    yield runs
    runs.close()
    if runs.cli.poll() is None:
        runs.cli.kill()
        runs.cli.wait()


@pytest.fixture(scope="module")
def ranks(launched):
    return launched.rank_results()


@pytest.fixture(scope="module")
def reference(launched):
    return launched.reference()


def _total_bytes(path):
    """The bytes of every leaf of a checkpoint, each counted once."""
    man = load_manifest(str(path))
    return sum(int(np.prod(e.shape)) * MF.dtype_entry(e.dtype)[1].itemsize
               for g in man.groups.values() for e in g.values())


def _same(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_resume_exact_on_data_mesh_with_zero1_async(ranks):
    """(data 2, p 2) with ZeRO-1 and the async writer: the checkpointing
    run's history is the plain run's, and a run interrupted at ``ck1d-3``
    (step 4) and resumed gives its last two steps bit for bit."""
    for res in ranks.values():
        assert list(res["resume_at"]) == [4, 4, 4]
        for k in HIST_KEYS:
            assert np.array_equal(res[f"ckpt/{k}"], res[f"plain/{k}"]), k
            assert np.array_equal(res[f"resumed/{k}"], res[f"plain/{k}"][4:])


@pytest.mark.parametrize("tag,path", [("1d", "ck1d"), ("2d", "ck2d")])
def test_each_byte_is_written_once(launched, ranks, tag, path):
    """Each rank writes at most 2 total / n bytes, and the ranks' bytes
    sum to the leaves' bytes exactly once (no gather, no replica
    written twice)."""
    total = _total_bytes(launched.tmp / path)
    per = [int(r[f"bytes_{tag}"]) for r in ranks.values()]
    assert sum(per) == total
    assert max(per) <= 2 * total / 4


def test_2x2_checkpoint_restores_on_one_device(launched, ranks):
    """The 2x2 save, restored whole on one device, is ``gather_params_2d``
    of the ranks' shards bit for bit (params and moments); the
    reference's ``restore_tree`` reads the same bits; serving it gives
    the forecast of the gathered params handed in whole, bit for bit."""
    path = str(launched.tmp / "ck2d")
    by_rank = sorted(ranks.values(), key=lambda r: int(r["rank_2d"]))
    whole = restore_tree(path, "params")
    opt = restore_tree(path, "opt_state")
    assert opt["step"].item() == 2
    for group, got in (("params", whole), ("mu", opt["mu"])):
        shards = [{k[len(f"2d/{group}/"):]: torch.from_numpy(v)
                   for k, v in r.items() if k.startswith(f"2d/{group}/")}
                  for r in by_rank]
        trees = [ptree.map_with_path(
            lambda p, _, s=s: s["/".join(map(str, p))], got)
            for s in shards]
        want = gather_params_2d(trees, 2)
        for a, b in zip(ptree.leaves(got), ptree.leaves(want)):
            assert _same(a, b), group
    ref = _flat(params_from_numpy(ref_sharded.restore_tree(path, "params"),
                                  device="cpu"))
    mine = _flat(whole)
    assert ref.keys() == mine.keys()
    assert all(_same(ref[k], mine[k]) for k in mine)
    eng = ForecastEngine("weathermixer-1b", ckpt=path, device="cpu",
                         config=ServeConfig(buckets=(1,)))
    handed = ForecastEngine("weathermixer-1b", params=whole, device="cpu",
                            config=ServeConfig(buckets=(1,)))
    assert eng.restored_step == 2
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, *eng.field_shape)).astype(np.float32))
    assert torch.equal(eng._forecast(x), handed._forecast(x))


def test_elastic_restore_to_smaller_meshes(launched, ranks):
    """``ck1d-3`` of (data 2, p 2) with ZeRO-1, restored on (data 1, p 2)
    without it: each rank's params and whole moments are
    ``shard_params_1d`` of the one-device restore, bit for bit; on one
    device ``TrainEngine(resume=)`` holds the whole restore."""
    path = str(launched.tmp / "ck1d-3")
    whole = restore_tree(path, "params")
    mu = restore_tree(path, "opt_state")["mu"]
    for res in ranks.values():
        if "b/r" not in res:
            continue
        r = int(res["b/r"])
        assert int(res["b/step"]) == 4
        for group, tree in (("params", whole), ("mu", mu)):
            for k, v in _flat(shard_params_1d(tree, r, 2)).items():
                assert _same(v, res[f"b/{group}/{k}"]), (group, k)
    one = TrainEngine("weathermixer-1b", device="cpu",
                      config=_config(zero1=True, resume=path))
    assert one.step_idx == 4 and one.opt_state["step"] == 4
    for a, b in zip(ptree.leaves(one.params), ptree.leaves(whole)):
        assert _same(a, b)


def test_reference_zero1_checkpoint_restores_in_port(launched, ranks):
    """The reference's (data 2, model 4) ZeRO-1 checkpoint (eight
    emulated devices) restores in the port on one device bit for bit as
    the reference reads it, and on (data 2, p 2) with ZeRO-1 each rank
    holds its blocks of it: ``shard_params_1d``, then ZeRO-1's slice of
    the moments along the dim it cuts."""
    path = str(launched.tmp / "refck")
    ref = {g: ref_sharded.restore_tree(path, g)
           for g in ("params", "opt_state")}
    whole = params_from_numpy(ref["params"], device="cpu")
    mu = params_from_numpy(ref["opt_state"]["mu"], device="cpu")
    one = TrainEngine("weathermixer-1b", device="cpu",
                      config=_config(steps=2, resume=path))
    assert one.step_idx == 2 and one.opt_state["step"] == \
        int(ref["opt_state"]["step"]) == 2
    for got, want in ((one.params, whole), (one.opt_state["mu"], mu)):
        got, want = _flat(got), _flat(want)
        assert got.keys() == want.keys()
        assert all(_same(got[k], want[k]) for k in got)
    for (d, r), res in ranks.items():
        assert list(res["c/step"]) == [2, 2]
        for k, v in _flat(shard_params_1d(whole, r, 2, d, 2)).items():
            assert _same(v, res[f"c/params/{k}"]), k
        for k, v in _flat(shard_params_1d(mu, r, 2, d, 2)).items():
            dim = int(res[f"c/zero1/{k}"])
            if dim >= 0:
                n = v.shape[dim] // 2
                v = v.narrow(dim, d * n, n)
            assert _same(v, res[f"c/mu/{k}"]), k


def test_port_mesh_checkpoint_resumes_in_reference(launched, ranks,
                                                   reference):
    """The port's (data 2, p 2) ZeRO-1 ``ck1d-3`` read by the reference's
    ``restore_tree`` bit for bit as the port reads it, and resumed by the
    reference's ``TrainEngine`` on (data 2, model 2) with ZeRO-1: steps 4
    and 5 within 1e-4 relative of the port's."""
    path = str(launched.tmp / "ck1d-3")
    for g in ("params", "opt_state"):
        mine = _flat(restore_tree(path, g))
        theirs = ref_sharded.restore_tree(path, g)
        port_of_ref = _flat(params_from_numpy(theirs, device="cpu")
                            if g == "params" else
                            {k: (torch.from_numpy(np.asarray(v))
                                 if k == "step" else
                                 params_from_numpy(v, device="cpu"))
                             for k, v in theirs.items()})
        assert mine.keys() == port_of_ref.keys()
        assert all(_same(mine[k], port_of_ref[k]) for k in mine)
    assert list(reference["resume_at"]) == [4, 4]
    port = next(iter(ranks.values()))
    for k in HIST_KEYS:
        got, want = reference[k], port[f"plain/{k}"][4:]
        assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-4, k


def test_train_cli_ckpt_and_resume_under_torchrun(launched):
    """``launch/train.py --ckpt cli --ckpt-every 2 --sync-save`` on two
    gloo ranks, then ``--resume cli-2``: the resumed run's step 3 is the
    first run's bit for bit, and rank 0 alone wrote each history."""
    first = _history(launched.cli)
    assert (launched.tmp / "cli-2" / "manifest.json").exists()
    assert (launched.tmp / "cli" / "manifest.json").exists()
    again = _history(_cli(launched.tmp, "cli_resumed", "--resume", "cli-2"))
    assert [r["step"] for r in first] == [0, 1, 2, 3]
    assert [r["step"] for r in again] == [3]
    assert all(again[0][k] == first[3][k] for k in HIST_KEYS)


# a language model of each family (reduced), under its 1-D layout
LM_BOUNDS = ("h2o-danube-1.8b", "pixtral-12b", "phi3.5-moe-42b-a6.6b",
             "mamba2-130m", "jamba-1.5-large-398b", "whisper-small")


def _lm_trees(arch):
    """The reduced model's whole parameters in the port's per-layer
    layout and in the reference's stacked one (numpy)."""
    tree = M.init(get_config(arch).reduced(), seed=0, device="cpu")
    return [tree, params_to_numpy(tree)]


@pytest.mark.parametrize("scheme", ["1d", "2d", "1d_fsdp"] + [
    f"lm_{a}" for a in LM_BOUNDS])
def test_param_bounds_invert_the_shard_functions(scheme):
    """``convert.param_bounds`` of every leaf and rank is the block that
    ``shard_params_1d`` / ``_2d`` cut, on the reference's stacked layout
    and the port's per-layer one: the mixer's layouts on (data 2, p 2) and
    2x2, and each language-model family's 1-D layout
    (``transformer.param_spec_1d``: the vocab-cut table and head, the
    experts' E, ``conv_w``, ``dec_pos``) on (data 1, p 4), its leaves the
    layout leaves whole among them."""
    rng = np.random.default_rng(0)
    trees = [{"encoder": {"w": rng.normal(size=(8, 6)),
                          "b": rng.normal(size=(8,))},
              "blocks": {"tok_fc1": {"w": rng.normal(size=(3, 8, 4)),
                                     "b": rng.normal(size=(3, 8))},
                         "ch_norm": {"scale": rng.normal(size=(3, 4))}},
              "blend": rng.normal(size=(4,))}]
    spec = None
    if scheme.startswith("lm_"):
        trees, spec = _lm_trees(scheme[3:]), LM_SPEC
    for tree in trees:
        if scheme == "2d":
            meshes = [Mesh(q=2, i=i, j=j) for i in range(2)
                      for j in range(2)]
            shards = [shard_params_2d(tree, m.i, m.j, 2) for m in meshes]
        elif spec is not None:
            meshes = [Mesh1D(p=4, r=r) for r in range(4)]
            shards = [shard_params_1d(tree, m.r, 4, spec=spec)
                      for m in meshes]
        else:
            fsdp = scheme == "1d_fsdp"
            meshes = [Mesh1D(p=2, r=r, data_size=2, data_index=d)
                      for d in range(2) for r in range(2)]
            shards = [shard_params_1d(tree, m.r, 2, m.data_index, 2, fsdp)
                      for m in meshes]
        cut = []
        for m, shard in zip(meshes, shards):
            def check(path, a, m=m, shard=shard):
                b = param_bounds(path, a.shape, m,
                                 fsdp=scheme == "1d_fsdp", spec=spec)
                want = shard
                for k in path:
                    want = want[k]
                got = a[tuple(slice(*x) for x in b)]
                if isinstance(got, torch.Tensor):
                    assert torch.equal(got, want), path
                else:
                    assert np.array_equal(got, want), path
                cut.append(tuple(b) != tuple((0, n) for n in a.shape))
            ptree.map_with_path(check, tree)
        assert any(cut) and not all(cut)


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference_main(sys.argv[2])
    else:
        _rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
