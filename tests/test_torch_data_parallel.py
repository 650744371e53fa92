"""The port's data-parallel axis against the JAX package's: Jigsaw model
groups replicated over ``data``, each data rank reading its rows of the
batch, gradients summed over ``data``, ZeRO-1 and the 1-D FSDP hybrid.

Weights come from the reference's ``init`` of the reduced config (carried
over as numpy through an npz), batches from the shared synthetic weather
data.  The reference runs on eight host-emulated devices in a subprocess
(this file run as a script with ``--reference``): ``TrainEngine`` on its
(data 2, 2x2) and (data 2, model 2) meshes, the latter also with
``shard_params_over_data``.  The port runs as gloo processes: the training
CLI under ``torch.distributed.run --standalone`` (eight ranks at (data 2,
2x2), four at (data 2, p 2), two at (data 1, p 2)), and four ranks of this
file run as a script with ``--rank`` (``file://`` store in the test's
temporary directory) for the engine's ZeRO-1 and FSDP runs.  All of them
start together in one module-scope fixture.  The specs, the shards and the
reads are held in process.

Tolerances: five-step loss, grad-norm and lr histories 1e-4 relative
against the reference (as the data-1 histories); a batch of one over two
data ranks 1e-6 relative against the data-1 history (the same sums but the
loss's and the gradients' extra data reduction); ZeRO-1, the FSDP hybrid
and two runs of one seed bit for bit.
"""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.core.sharding import RULES_1D as REF_RULES_1D
from repro.core.sharding import RULES_2D as REF_RULES_2D
from repro.launch import specs as ref_specs
from repro.models import weathermixer as RW
from repro_torch.configs.registry import get_config
from repro_torch.convert import (gather_params_1d, params_from_npz,
                                 shard_params_1d, shard_params_2d)
from repro_torch.core import tree as ptree
from repro_torch.core.jigsaw import fsdp_cut
from repro_torch.core.sharding import (RULES_1D, RULES_2D, Mesh, Mesh1D,
                                       sanitize_spec)
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch import specs
from repro_torch.models import weathermixer as W
from test_torch_cannon import Launched

ROOT = Path(__file__).resolve().parents[1]
HIST_KEYS = ("loss", "grad_norm", "lr")
STEPS = 5
# the reference's runs and the port's engine runs on (data 2, model 2)
RANKS = 4
ONE_D = dict(mesh_model=2, mesh_data=2, scheme="1d", impl="ring_fused")
ENGINE_RUNS = {"base": {}, "zero1": dict(zero1=True),
               "fsdp": dict(fsdp=True), "fsdp_zero1": dict(fsdp=True,
                                                           zero1=True),
               "batch1": dict(batch=1)}


def _cfg(fsdp=False):
    """The reduced weathermixer-1b (as ``TrainEngine(reduced=True)`` makes
    it), with the FSDP hybrid's flag."""
    return ref_get_config("weathermixer-1b").reduced().replace(
        shard_params_over_data=fsdp)


def _weights():
    return jax.tree.map(np.asarray, RW.init(jax.random.PRNGKey(0), _cfg()))


def _flat(tree):
    """{"a/b/c": leaf} of a tree of tensors or arrays."""
    out = {}
    ptree.map_with_path(
        lambda path, a: out.__setitem__("/".join(map(str, path)), a), tree)
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))


# ---------------------------------------------------------------------------
# the reference (subprocess), the port's engine ranks and its CLI runs
# ---------------------------------------------------------------------------

def _reference_main(path):
    """The reference's TrainEngine, five steps from the fixture's weights
    (``kernel="xla"``) on (data 2, 2x2), on (data 2, model 2) with
    ``impl="ring_fused"``, and the latter with the FSDP hybrid."""
    from repro.launch.engine import EngineConfig as REngineConfig
    from repro.launch.engine import TrainEngine as RTrainEngine
    tree: dict = {}
    with np.load(Path(path).with_name("init.npz")) as f:
        for key in f.files:
            *outer, leaf = key.split("/")
            node = tree
            for k in outer:
                node = node.setdefault(k, {})
            node[leaf] = jnp.asarray(f[key])
    out = {}
    runs = {"2d": dict(mesh_model=4, scheme="2d"),
            "1d": dict(mesh_model=2, scheme="1d", impl="ring_fused"),
            "fsdp": dict(mesh_model=2, scheme="1d", impl="ring_fused")}
    for tag, kw in runs.items():
        eng = RTrainEngine(
            "weathermixer-1b", reduced=False, mesh_data=2, kernel="xla",
            config_override=_cfg(fsdp=tag == "fsdp"), init_params=tree,
            config=REngineConfig(steps=STEPS, batch=2, log_every=1,
                                 prefetch=0, telemetry=False, seed=0), **kw)
        hist = eng.run()
        for k in HIST_KEYS:
            out[f"{tag}/{k}"] = [h[k] for h in hist]
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


def _rank_main(rank, init, out_dir):
    """One rank of the port's (data 2, model 2) mesh: the engine's runs of
    ``ENGINE_RUNS`` from the fixture's weights, each with its history, its
    parameter shards and optimizer state, and the moment of
    ``blocks.0.ch_fc1.w``; saved to rank<r>.npz."""
    import torch.distributed as dist
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=RANKS)
    whole = params_from_npz(Path(out_dir) / "init.npz", device="cpu")
    res = {}
    for tag, kw in ENGINE_RUNS.items():
        kw = dict(kw)
        cfg = get_config("weathermixer-1b").reduced().replace(
            shard_params_over_data=kw.pop("fsdp", False))
        eng = TrainEngine(
            "weathermixer-1b", reduced=False, config_override=cfg,
            init_params=whole, device="cpu", **ONE_D,
            config=EngineConfig(steps=STEPS, batch=kw.pop("batch", 2),
                                log_every=1, prefetch=0, telemetry=False,
                                seed=0, **kw))
        hist = eng.run()
        m = eng.mesh
        res["ij"] = np.array([m.data_index, m.r])
        res["rank"] = np.array([m.rank, dist.get_rank()])
        for k in HIST_KEYS:
            res[f"{tag}/{k}"] = np.array([h[k] for h in hist])
        for path, v in _flat(eng.params).items():
            res[f"{tag}/params/{path}"] = v.numpy()
        res[f"{tag}/opt_bytes"] = np.array(eng.opt_state_bytes())
        # the state of the leaves ZeRO-1 keeps whole
        dims = (ptree.leaves(eng.zero1.dims) if eng.zero1 is not None
                else [None] * len(ptree.leaves(eng.params)))
        res[f"{tag}/residue_bytes"] = np.array(sum(
            t.numel() * t.element_size()
            for k in ("mu", "nu", "master") if k in eng.opt_state
            for t, dim in zip(ptree.leaves(eng.opt_state[k]), dims)
            if dim is None))
        res[f"{tag}/mu_ch_fc1"] = np.array(
            eng.opt_state["mu"]["blocks"][0]["ch_fc1"]["w"].shape)
        res[f"{tag}/read"] = np.array(
            eng.pipeline.stats.rank_bytes["fields"][m.rank])
        eng.close()
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


def _cli(tmp, tag, nproc, *args):
    """The training CLI on ``nproc`` gloo ranks from the fixture's weights,
    five steps; started, not waited for."""
    out = tmp / f"{tag}.jsonl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), "-m", "repro_torch.launch.train",
         "--device", "cpu", "--steps", str(STEPS), "--log-every", "1",
         "--prefetch", "0", "--init-params", str(tmp / "init.npz"),
         "--metrics-out", str(out), *args],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=tmp)
    proc.out = out
    return proc


CLI_RUNS = {
    "2d_a": (8, "--mesh-model", "4", "--mesh-data", "2", "--scheme", "2d",
             "--batch", "2"),
    "1d": (4, "--mesh-model", "2", "--mesh-data", "2", "--scheme", "1d",
           "--impl", "ring_fused", "--batch", "2"),
    "1d_data1_batch1": (2, "--mesh-model", "2", "--scheme", "1d", "--impl",
                        "ring_fused", "--batch", "1")}


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("data_parallel")
    np.savez(tmp / "init.npz", **_flat(_weights()))
    runs = Launched(tmp, __file__, ranks=RANKS, devices=8)
    runs.cli = {tag: _cli(tmp, tag, *a) for tag, a in CLI_RUNS.items()}
    yield runs
    runs.close()
    for p in runs.cli.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def _history(proc):
    """The CLI run's metrics file, once it has exited 0."""
    try:
        _, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    return [json.loads(line) for line in proc.out.read_text().splitlines()]


@pytest.fixture(scope="module")
def ranks(launched):
    return launched.rank_results()


@pytest.fixture(scope="module")
def reference(launched):
    return launched.reference()


def _check_history(got, ref, tag):
    assert [r["step"] for r in got] == list(range(STEPS))
    for k in HIST_KEYS:
        assert _rel([r[k] for r in got], ref[f"{tag}/{k}"]) <= 1e-4, (
            k, got, ref[f"{tag}/{k}"])


# ---------------------------------------------------------------------------
# the histories against the reference's meshes of the same shape
# ---------------------------------------------------------------------------

def test_cli_2d_data_mesh_matches_reference_and_repeats(launched,
                                                        reference):
    """``launch/train.py --mesh-model 4 --mesh-data 2 --scheme 2d`` on
    eight gloo ranks: five steps of loss, grad norm and lr within 1e-4 of
    the reference's TrainEngine on its (data 2, 2x2) mesh from the same
    weights and seed; a second run gives the same history bit for bit, and
    only rank 0 (data index 0) writes it."""
    first = _history(launched.cli["2d_a"])
    _check_history(first, reference, "2d")
    again = _history(_cli(launched.tmp, "2d_b", *CLI_RUNS["2d_a"]))
    assert [{k: r[k] for k in HIST_KEYS} for r in first] == \
        [{k: r[k] for k in HIST_KEYS} for r in again]


def test_cli_1d_data_mesh_matches_reference_and_repeats(launched, reference,
                                                        ranks):
    """``--mesh-model 2 --mesh-data 2 --scheme 1d --impl ring_fused`` on
    four ranks: within 1e-4 of the reference's (data 2, model 2) history;
    the engine's run of the same seed on four other processes gives it bit
    for bit, and only rank 0 writes it."""
    got = _history(launched.cli["1d"])
    _check_history(got, reference, "1d")
    for res in ranks.values():
        for k in HIST_KEYS:
            assert np.array_equal(res[f"base/{k}"], [r[k] for r in got]), k


def test_mesh_numbers_ranks_with_data_outermost(ranks):
    """Rank d * p + r sits at data index d and model index r."""
    assert sorted(ranks) == [(d, r) for d in range(2) for r in range(2)]
    for (d, r), res in ranks.items():
        assert list(res["rank"]) == [d * 2 + r] * 2


# ---------------------------------------------------------------------------
# ZeRO-1 and the FSDP hybrid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["zero1", "fsdp_zero1"])
def test_zero1_is_bitwise_the_replicated_run(ranks, tag):
    """ZeRO-1 (the reference's ``scenario_zero1_engine``): the history and
    the final parameters bit for bit those of the run without it, each
    rank's optimizer-state bytes at most half of them plus the leaves it
    keeps whole (the residue), and the moment of ``blocks.ch_fc1.w`` cut
    over data (half its out dim)."""
    base = tag.replace("_zero1", "") if tag != "zero1" else "base"
    for res in ranks.values():
        for k in HIST_KEYS:
            assert np.array_equal(res[f"{tag}/{k}"], res[f"{base}/{k}"]), k
        for key in res:
            if key.startswith(f"{base}/params/"):
                assert np.array_equal(
                    res[key], res[key.replace(base, tag, 1)]), key
        assert res[f"{tag}/opt_bytes"] <= \
            res[f"{base}/opt_bytes"] / 2 + res[f"{tag}/residue_bytes"]
        assert res[f"{tag}/opt_bytes"] < res[f"{base}/opt_bytes"]
        full = res[f"{base}/mu_ch_fc1"]
        if tag == "zero1":
            assert list(res[f"{tag}/mu_ch_fc1"]) == [full[0] // 2, full[1]]


def test_fsdp_matches_reference_and_is_bitwise_the_replicated_run(
        ranks, reference):
    """The FSDP hybrid (the reference's ``scenario_jigsaw_1d_fsdp`` in an
    engine): within 1e-4 of the reference's run with
    ``shard_params_over_data``, and bit for bit the port's run without it:
    the history, and the whole parameters gathered from the shards of
    either layout.  Each rank holds half of each weight's out dim."""
    first = next(iter(ranks.values()))
    got = [dict(zip(HIST_KEYS, v)) for v in
           zip(*(first[f"fsdp/{k}"] for k in HIST_KEYS))]
    _check_history([dict(r, step=i) for i, r in enumerate(got)], reference,
                   "fsdp")

    def whole(tag, fsdp):
        shards = []
        for d in range(2):
            for r in range(2):
                res = ranks[(d, r)]
                tree = {}
                for key, v in res.items():
                    if key.startswith(f"{tag}/params/"):
                        tree[key[len(tag) + 8:]] = v
                shards.append(_unflat(tree))
        return gather_params_1d(shards, 2, data=2, fsdp=fsdp)

    for res in ranks.values():
        for k in HIST_KEYS:
            assert np.array_equal(res[f"fsdp/{k}"], res[f"base/{k}"]), k
        a, b = res["fsdp/params/encoder/w"], res["base/params/encoder/w"]
        assert a.shape == (b.shape[0] // 2, b.shape[1])
    want, got = _flat(whole("base", False)), _flat(whole("fsdp", True))
    assert want.keys() == got.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def _unflat(flat):
    """The port's tree from {"a/0/c": leaf} (list indices as digits)."""
    tree: dict = {}
    for key, v in flat.items():
        *outer, leaf = key.split("/")
        node = tree
        for k in outer:
            node = node.setdefault(k, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}
    return lists(tree)


# ---------------------------------------------------------------------------
# the reads
# ---------------------------------------------------------------------------

def test_batch_of_one_stays_whole_and_matches_data_1(launched, ranks):
    """A batch of 1 over two data ranks stays whole on each (the
    reference's ``sanitize_spec``): every rank reads 1/p of its bytes, and
    the history is the (data 1, p 2) CLI run's within 1e-6."""
    want = _history(launched.cli["1d_data1_batch1"])
    cfg = _cfg()
    whole = 4 * cfg.wm_lat * cfg.wm_lon * cfg.wm_channels
    for res in ranks.values():      # the bytes of five batches' reads
        assert res["batch1/read"] == STEPS * whole // 2
        assert res["base/read"] == STEPS * 2 * whole // 4
        for k in HIST_KEYS:
            assert _rel(res[f"batch1/{k}"], [r[k] for r in want]) <= 1e-6, k


def _meshes(kind):
    """Every rank's place on a (data 2, ...) mesh, with no process group
    (reads and shards need none)."""
    if kind == "2x2":
        return [Mesh(q=2, i=i, j=j, data_size=2, data_index=d)
                for d in range(2) for i in range(2) for j in range(2)]
    if kind == "1x1":
        return [Mesh(data_size=2, data_index=d) for d in range(2)]
    return [Mesh1D(p=2, r=r, data_size=2, data_index=d)
            for d in range(2) for r in range(2)]


@pytest.mark.parametrize("kind", ["2x2", "1x1", "p2"])
def test_each_rank_reads_its_rows_and_block(kind):
    """Per rank the sharded pipeline reads 1/(data x model) of the batch's
    bytes, bit for bit its rows and block of the whole batch (what
    ``sync-full`` hands the model to cut), keyed by its global rank."""
    meshes = _meshes(kind)
    cfg = get_config("weathermixer-1b").reduced().replace(
        scheme="1d" if kind == "p2" else "2d")
    from repro_torch.launch.shapes import jigsaw_for
    full = make_pipeline(cfg, batch_size=2, mode="sync-full", prefetch=0,
                         device="cpu").get(3, 1)
    for mesh in meshes:
        pipe = make_pipeline(cfg, batch_size=2, prefetch=0, device="cpu",
                             mesh=mesh)
        got = pipe.get(3, 1)
        jcfg = jigsaw_for(cfg).replace(mesh=mesh)
        for k in full:
            want = W.field_block(full[k], cfg, jcfg)
            assert want.shape[0] == 1 and torch.equal(got[k], want), k
        assert pipe.stats.rank_bytes["fields"] == {
            mesh.rank: full["fields"].numel() * 4 // len(meshes)}


# ---------------------------------------------------------------------------
# specs, shards and ZeRO-1's cut, in process
# ---------------------------------------------------------------------------

def _norm(spec):
    """A spec as plain tuples, one-axis tuples as the axis (JAX's
    PartitionSpec reads them so)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _same(port, ref):
    """Two spec trees equal entry for entry."""
    a, b = _flat(port), _flat(jax.tree.map(
        tuple, ref, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                 PartitionSpec)))
    assert a.keys() == b.keys()
    for k in a:
        assert _norm(a[k]) == _norm(b[k]), (k, a[k], b[k])


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("layout", ["1d", "2d"])
def test_specs_equal_the_reference(layout, fsdp, size):
    """``param_specs``, ``sanitize_tree``, ``opt_specs(zero1_axis="data")``
    (masters too) and ``batch_specs`` equal the reference's entry for
    entry, on the reference's own parameter tree (``jax.eval_shape`` of
    its init: blocks stacked), at (data 2, model 4) under 1-D and (data 2,
    2, 2) under 2-D."""
    ref_cfg = ref_get_config("weathermixer-1b")
    if size == "reduced":
        ref_cfg = ref_cfg.reduced()
    ref_cfg = ref_cfg.replace(shard_params_over_data=fsdp, scheme=layout)
    cfg = get_config("weathermixer-1b")
    if size == "reduced":
        cfg = cfg.reduced()
    cfg = cfg.replace(shard_params_over_data=fsdp, scheme=layout)
    shapes = jax.eval_shape(lambda k: RW.init(k, ref_cfg),
                            jax.random.PRNGKey(0))
    mesh = types.SimpleNamespace(shape=(
        {"data": 2, "model": 4} if layout == "1d"
        else {"data": 2, "mdom": 2, "mtp": 2}))
    rules, ref_rules = ((RULES_1D, REF_RULES_1D) if layout == "1d"
                        else (RULES_2D, REF_RULES_2D))
    ps = specs.param_specs(shapes, cfg, rules)
    ref_ps = ref_specs.param_specs(shapes, ref_cfg, ref_rules, mesh)
    _same(ps, ref_ps)
    ps = specs.sanitize_tree(shapes, ps, mesh)
    ref_ps = ref_specs.sanitize_tree(shapes, ref_ps, mesh)
    _same(ps, ref_ps)
    _same(specs.opt_specs(shapes, ps, "data", mesh, master=True),
          ref_specs.opt_specs(shapes, ref_ps, zero1_axis="data", mesh=mesh,
                              master=True))
    _same(specs.batch_specs(cfg, rules),
          ref_specs.batch_specs(ref_cfg, ref_rules))


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("layout", ["1d", "2d"])
def test_param_specs_are_the_shards(layout, fsdp):
    """The sanitized ``param_specs`` of the port's whole parameters cut,
    on every rank of a (data 2, ...) mesh, exactly the blocks
    ``convert.shard_params_1d`` / ``_2d`` cut (the engine's layout, which
    the reference pins by these specs); the FSDP hybrid cuts each 1-D
    weight's out dim over data, and ``gather_params_1d`` puts it back."""
    cfg = get_config("weathermixer-1b").reduced().replace(
        shard_params_over_data=fsdp, scheme=layout)
    whole = W.init(cfg, seed=0, device="cpu")
    meshes = _meshes("p2" if layout == "1d" else "2x2")
    ps = specs.sanitize_tree(whole, specs.param_specs(
        whole, cfg, meshes[0].rules), meshes[0])
    shards = []
    for m in meshes:
        want = (shard_params_1d(whole, m.r, m.p, m.data_index, m.data_size,
                                fsdp) if layout == "1d"
                else shard_params_2d(whole, m.i, m.j, m.q))
        got = ptree.map(lambda a, sp: m.block(a, sp), whole, ps)
        assert all(torch.equal(a, b) for a, b in zip(ptree.leaves(got),
                                                     ptree.leaves(want)))
        shards.append(want)
    w = shards[0]["blocks"][0]["ch_fc1"]["w"]
    full = whole["blocks"][0]["ch_fc1"]["w"]
    cut = 2 if fsdp and layout == "1d" else 1
    q = 2
    assert w.shape == ((full.shape[0] // cut, full.shape[1] // q)
                       if layout == "1d"
                       else (full.shape[0] // q, full.shape[1] // q))
    if layout == "1d":
        back = gather_params_1d(shards, 2, data=2, fsdp=fsdp)
        assert all(torch.equal(a, b) for a, b in zip(ptree.leaves(back),
                                                     ptree.leaves(whole)))


def test_fsdp_keeps_a_weight_whole_where_data_does_not_divide():
    """Three data ranks: a weight whose out dim they do not divide stays
    whole on each (the reference's ``fsdp_ok``, ``sanitize_spec``), the
    others are cut, and the gather undoes both."""
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.normal(size=(6, 4)), "b": rng.normal(size=6)},
            "c": {"w": rng.normal(size=(4, 4)), "b": rng.normal(size=4)}}
    shards = [shard_params_1d(tree, r, 2, d, 3, fsdp=True)
              for d in range(3) for r in range(2)]
    assert shards[0]["a"]["w"].shape == (2, 2)
    assert shards[0]["c"]["w"].shape == (4, 2)
    mesh = Mesh1D(p=2, data_size=3)
    assert fsdp_cut(6, mesh) and not fsdp_cut(4, mesh)
    assert sanitize_spec((4, 4), ("data", "model"), Mesh1D(
        p=2, data_size=3)) == (None, "model")
    back = gather_params_1d(shards, 2, data=3, fsdp=True)
    assert all(np.array_equal(back[k][n], tree[k][n])
               for k in tree for n in ("w", "b"))


@pytest.mark.parametrize("layout", ["1d", "2d"])
def test_zero1_cuts_every_divisible_leaf(layout):
    """ZeRO-1's cut (``zero1_dims``): at (data 2, p 2) every weight on its
    out dim (the first dim the model axis leaves whole); at (data 2, 1x1)
    the 2-D weights too, since an axis of extent 1 cuts nothing; the
    LayerNorm leaves and blend on their one dim; the biases' one dim is on
    the model axis under 1-D, so they stay whole there."""
    cfg = get_config("weathermixer-1b").reduced().replace(scheme=layout)
    whole = W.init(cfg, seed=0, device="cpu")
    mesh = _meshes("p2" if layout == "1d" else "1x1")[0]
    ps = specs.sanitize_tree(whole, specs.param_specs(whole, cfg,
                                                      mesh.rules), mesh)
    dims = _flat(specs.zero1_dims(whole, ps, mesh))
    for key, dim in dims.items():
        name = key.split("/")[-1]
        if name == "w":
            assert dim == 0, key
        elif name == "b" and layout == "1d":
            assert dim is None, key
        else:
            assert dim == 0, key


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference_main(sys.argv[2])
    else:
        _rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
