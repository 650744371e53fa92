"""The dense and VLM language models on a 1-D Jigsaw model mesh in the port,
against the JAX package's 1-D mesh (its ``param_specs`` layout, with GSPMD
placing every collective between the linears).

The reference's weights (``repro.models.registry.init`` of the reduced
configs: d_model 256, 2 layers, 4 heads of 64 over 2 kv heads, d_ff 512,
vocab 1,024; gemma3 at 6 layers, so that a global layer follows its five
local ones) are carried to the port through numpy, and the batches come
from a numpy seed or the token batch source both packages share.  The
reference runs on four host-emulated devices in one subprocess (this file
run as a script with ``--reference``): its forwards under ``jax.set_mesh``
of a (data 1, model p) mesh, as ``tests/dist_scenarios.py::
scenario_transformer_1d``, and its ``TrainEngine(mesh_model=...,
scheme="1d", impl=...)`` and CLI entry point ``repro.launch.train.train``.
The port's ranks are gloo processes, this file run as a script with
``--rank`` (one launched group per mesh: (data 1, model 2), (data 1,
model 4) and (data 2, model 2)), or the training CLI under
``torch.distributed.run``.  On the CPU ``ring_fused`` runs its kernels'
plain versions and the head's all-gather is the library's.

Tolerances:
  * the forward's logits, gathered over the vocab on every rank, 1e-5
    relative and absolute against the reference's 1-D forward and the
    port's one-device forward (sums in another order: the norms' row sums
    over the ranks, each linear's partial products);
  * one train step against the port's one-device step: the loss rtol 1e-4,
    the updated parameters rtol 1e-3 / atol 1e-4 (the reference's
    ``scenario_train_step_mesh`` limits, under its own learning-rate
    schedule: ``make_train_step``'s default), and every leaf's gradient
    within 1e-5 of the leaf's largest magnitude (measured ~2e-6); the
    replicated leaves (the norms' scales) bit for bit on every rank;
  * five-step ``TrainEngine`` and CLI histories (loss, grad norm, lr):
    1e-4 relative to the reference's, as the one-device histories.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.core.sharding import RULES_1D as REF_RULES_1D
from repro.launch import shapes as RSH
from repro.launch import specs as ref_specs
from repro.models import registry as RM
from repro.telemetry import accounting as RACC
from repro_torch import telemetry
from repro_torch.configs.registry import get_config
from repro_torch.convert import (gather_params_1d, param_bounds,
                                 params_from_npz, params_from_numpy,
                                 shard_params_1d)
from repro_torch.core import tree as ptree
from repro_torch.core.sharding import RULES_1D, RULES_2D, Mesh1D
from repro_torch.launch import specs
from repro_torch.launch.engine import EngineConfig, TrainEngine
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import registry as M
from repro_torch.models.transformer import param_spec_1d as LM_SPEC
from repro_torch.optim import adam
from repro_torch.train import step

ROOT = Path(__file__).resolve().parents[1]
HIST_KEYS = ("loss", "grad_norm", "lr")
# (data, model) of each launched mesh
MESHES = {"m2": (1, 2), "m4": (1, 4), "d2m2": (2, 2)}
# the forwards: (arch, model ranks); internlm2 at p = 4 gathers its two
# kv heads, h2o has an untied head and a window, gemma3 the qk-norm, the
# GELU FFN and local:global layers, pixtral the VLM's embeds
FORWARDS = [("internlm2-1.8b", 2), ("internlm2-1.8b", 4),
            ("h2o-danube-1.8b", 2), ("gemma3-27b", 2), ("pixtral-12b", 2)]
LAYERS = {"gemma3-27b": 6}
FWD_BATCH, FWD_SEQ = 2, 72          # past h2o's window of 64, gemma3's 32
STEP_ARCH, STEP_BATCH, STEP_SEQ = "stablelm-3b", 8, 16   # the scenario's
HIST_ARCH = "internlm2-1.8b"
IMPLS = ("rs", "ring_chunked", "ring_fused")
COMMON = dict(steps=5, batch=4, seq_len=32, log_every=1, prefetch=0,
              seed=0)
ARCHS = sorted({a for a, _ in FORWARDS} | {STEP_ARCH, HIST_ARCH})


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))


def _ref_cfg(arch):
    cfg = ref_get_config(arch).reduced()
    return cfg.replace(n_layers=LAYERS[arch]) if arch in LAYERS else cfg


def _port_cfg(arch, **kw):
    cfg = get_config(arch).reduced()
    if arch in LAYERS:
        cfg = cfg.replace(n_layers=LAYERS[arch])
    return cfg.replace(**kw)


def _ref_weights(arch):
    return jax.tree.map(np.asarray,
                        RM.init(jax.random.PRNGKey(0), _ref_cfg(arch)))


def _flat(tree):
    out = {}
    ptree.map_with_path(
        lambda path, a: out.__setitem__("/".join(map(str, path)), a), tree)
    return out


def _fwd_batch(arch):
    cfg = _port_cfg(arch)
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (FWD_BATCH, FWD_SEQ)).astype(np.int32)}
    if cfg.family == "vlm":
        out["embeds"] = rng.normal(
            size=(FWD_BATCH, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _step_batch():
    cfg = _port_cfg(STEP_ARCH)
    rng = np.random.default_rng(11)
    return {k: rng.integers(0, cfg.vocab_size, (STEP_BATCH, STEP_SEQ))
            .astype(np.int32) for k in ("tokens", "labels")}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ---------------------------------------------------------------------------
# the reference (one subprocess) and the port's ranks (gloo processes)
# ---------------------------------------------------------------------------

def _reference_main(path, wdir):
    """The reference on its 1-D meshes: each forward under ``jax.set_mesh``,
    five-step TrainEngine runs of each impl at (data 1, model 2), rs with
    ZeRO-1 at (data 2, model 2), and the CLI's ``train`` at (data 1, model
    2) with its defaults (impl rs)."""
    from repro.launch.engine import EngineConfig as REngineConfig
    from repro.launch.engine import TrainEngine as RTrainEngine
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train import train as ref_train
    out = {}
    for arch, p in FORWARDS:
        cfg = _ref_cfg(arch).replace(scheme="1d", impl="rs")
        params = jax.tree.map(jnp.asarray, _ref_weights(arch))
        batch = {k: jnp.asarray(v) for k, v in _fwd_batch(arch).items()}
        with jax.set_mesh(make_host_mesh(model=p, data=1)):
            y, _ = jax.jit(lambda pr, b: RM.apply(
                pr, b, cfg, RSH.jigsaw_for(cfg)))(params, batch)
        out[f"fwd/{arch}/p{p}"] = np.asarray(y)

    def init():
        return jax.tree.map(jnp.asarray, _ref_weights(HIST_ARCH))

    runs = [(impl, 1, impl, False) for impl in IMPLS]
    runs.append(("rs_zero1", 2, "rs", True))
    for key, data, impl, zero1 in runs:
        eng = RTrainEngine(HIST_ARCH, reduced=True, mesh_model=2,
                           mesh_data=data, scheme="1d", impl=impl,
                           kernel="xla", init_params=init(),
                           config=REngineConfig(zero1=zero1, **COMMON))
        hist = eng.run()
        for k in HIST_KEYS:
            out[f"{key}/{k}"] = [h[k] for h in hist]
    hist, _ = ref_train(HIST_ARCH, mesh_model=2, scheme="1d",
                        init_params=init(), **COMMON)
    for k in HIST_KEYS:
        out[f"cli/{k}"] = [h[k] for h in hist]
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


def _rank_main(rank, key, init, wdir):
    """One rank of the port's mesh ``key``: the forwards of its model
    extent (the logits gathered over the vocab), one train step of
    STEP_ARCH on its shards and its data rank's rows (the gradients too),
    and on (data 1, model 2) five-step TrainEngine runs of each impl (then
    the rs run's save) and on (data 2, model 2) the rs run with
    ZeRO-1; saved to <key>_rank<r>.npz."""
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
    for arch, fp in FORWARDS:
        if fp != p or data != 1:
            continue
        cfg = _port_cfg(arch, scheme="1d", impl="ring_fused")
        whole = params_from_npz(wdir / f"{arch}.npz", device="cpu")
        batch = _torch_batch(_fwd_batch(arch))
        if "embeds" in batch:
            batch["embeds"] = mesh.block(batch["embeds"],
                                         (None, None, "model"))
        with torch.no_grad():
            y, _ = M.apply(shard_params_1d(whole, mesh.r, p, spec=LM_SPEC),
                           batch, cfg, jigsaw_for(cfg).replace(mesh=mesh))
        res[f"fwd/{arch}"] = torch.cat(
            comm.all_gather_list(y.contiguous(), mesh.tp_group), -1).numpy()

    cfg = _port_cfg(STEP_ARCH, scheme="1d")
    jcfg = jigsaw_for(cfg).replace(mesh=mesh)
    whole = params_from_npz(wdir / f"{STEP_ARCH}.npz", device="cpu")
    batch = {k: mesh.block(v, (("data",), None))
             for k, v in _torch_batch(_step_batch()).items()}
    params = shard_params_1d(whole, mesh.r, p, spec=LM_SPEC)
    _, grads = step.value_and_grad(params, batch, cfg, jcfg)
    params, _, metrics = step.make_train_step(cfg, jcfg)(
        params, adam.init(params, adam.AdamConfig()), batch)
    res["step/loss"] = metrics["loss"].numpy()
    res["step/grad_norm"] = metrics["grad_norm"].numpy()
    for k, v in _flat(params).items():
        res[f"step/params/{k}"] = v.numpy()
    for k, v in _flat(grads).items():
        res[f"step/grads/{k}"] = v.numpy()

    runs = ([(impl, impl, False) for impl in IMPLS] if key == "m2"
            else [("rs_zero1", "rs", True)] if key == "d2m2" else [])
    init_params = params_from_npz(wdir / f"{HIST_ARCH}.npz", device="cpu")
    for name, impl, zero1 in runs:
        eng = TrainEngine(HIST_ARCH, reduced=True, mesh_model=p,
                          mesh_data=data, impl=impl, device="cpu",
                          init_params=init_params,
                          config=EngineConfig(zero1=zero1, telemetry=False,
                                              **COMMON))
        hist = eng.run()
        for k in HIST_KEYS:
            res[f"{name}/{k}"] = np.array([h[k] for h in hist])
        if name == "rs":
            res["jcfg"] = np.array([eng.cfg.scheme, eng.jcfg.impl])
            eng.save(str(wdir / f"ck_{key}"))
            eng.wait_checkpoints()
            for k, v in _flat(eng.params).items():
                res[f"save/params/{k}"] = v.numpy()
        eng.close()
    np.savez(wdir / f"{key}_rank{rank}.npz",
             **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()


class Launched:
    """The reference's subprocess (four emulated devices) and one group of
    the port's rank processes per mesh of ``MESHES``, started together;
    their results are read when a test first needs them."""

    def __init__(self, tmp):
        self.tmp = tmp
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        script = str(Path(__file__).resolve())
        self.ranks = {key: [subprocess.Popen(
            [sys.executable, script, "--rank", str(r), key,
             f"file://{tmp / f'store_{key}'}", str(tmp)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(data * p)] for key, (data, p) in MESHES.items()}
        self.ref_path = tmp / "reference.npz"
        self.ref = subprocess.Popen(
            [sys.executable, script, "--reference", str(self.ref_path),
             str(tmp)],
            env=dict(env, JAX_PLATFORMS="cpu",
                     XLA_FLAGS="--xla_force_host_platform_device_count=4"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    @staticmethod
    def _wait(procs, what, timeout=600):
        try:
            outs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for p, (_, err) in zip(procs, outs):
            assert p.returncode == 0, f"{what} failed:\n{err[-3000:]}"

    def rank_results(self, key):
        self._wait(self.ranks[key], f"a rank of {key}")
        data, p = MESHES[key]
        return [dict(np.load(self.tmp / f"{key}_rank{r}.npz"))
                for r in range(data * p)]

    def reference(self):
        self._wait([self.ref], "the reference")
        return dict(np.load(self.ref_path))

    def close(self):
        for p in [q for qs in self.ranks.values() for q in qs] + [self.ref]:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_mesh")
    for arch in ARCHS:
        np.savez(tmp / f"{arch}.npz", **_flat(_ref_weights(arch)))
    runs = Launched(tmp)
    yield runs
    runs.close()


@pytest.fixture(scope="module")
def reference(launched):
    return launched.reference()


# ---------------------------------------------------------------------------
# specs and the carry-over of weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "h2o-danube-1.8b",
                                  "stablelm-3b", "gemma3-27b",
                                  "pixtral-12b"])
def test_param_specs_match_reference(arch):
    """``param_specs`` of the reduced tree (the reference's stacked layers
    and the port's per-layer list) is the reference's 1-D ``param_specs``
    entry for entry: every ``w`` on its contracting dim, the untied head's
    and the table's vocab on ``model``, the norms' scales whole; and the
    shards cut by it gather back bit for bit at p = 2 and 4, each at the
    bounds ``param_bounds`` gives."""
    rcfg = _ref_cfg(arch)
    shapes = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), rcfg))
    want = ref_specs.param_specs(shapes, rcfg, REF_RULES_1D, None)
    whole = _ref_weights(arch)
    cfg = _port_cfg(arch)
    got = specs.param_specs(whole, cfg, RULES_1D)
    flat_want = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    flat_got = _flat(got)
    assert len(flat_want) == len(flat_got)
    for kp, spec in flat_want:
        key = "/".join(k.key for k in kp)
        assert flat_got[key] == tuple(spec), key
    port = params_from_numpy(whole, device="cpu")
    per_layer = _flat(specs.param_specs(port, cfg, RULES_1D))
    for key, spec in per_layer.items():
        parts = key.split("/")
        stacked = "/".join(parts[:1] + parts[2:]) if parts[0] == "layers" \
            else key
        assert (None,) + spec == flat_got[stacked] or spec == \
            flat_got[stacked], key
    for p in (2, 4):
        shards = [shard_params_1d(whole, r, p, spec=LM_SPEC)
                  for r in range(p)]
        back = gather_params_1d(shards, p, spec=LM_SPEC)
        for (k, a), b in zip(_flat(back).items(), _flat(whole).values()):
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        for r, shard in enumerate(shards):
            mesh = Mesh1D(p=p, r=r)
            for k, a in _flat(shard).items():
                path = tuple(k.split("/"))
                bounds = param_bounds(path, _flat(whole)[k].shape, mesh,
                                      spec=LM_SPEC)
                cut = _flat(whole)[k][tuple(slice(*b) for b in bounds)]
                assert np.array_equal(a, cut), (k, p, r)


def test_param_specs_of_other_families_and_2d():
    """The moe, ssm, hybrid and audio families take the same 1-D rule as
    the dense ones (``tests/test_torch_lm_mesh_zoo.py`` holds their trees
    to the reference's), with no FSDP data entry where the config cuts over
    data; a dense LM under 2-D rules keeps whole leaves (no language model
    runs on a 2-D model mesh: ``check_lm_mesh`` refuses it); the FSDP cut
    of a language model over two data ranks raises naming item 19."""
    params = {"embed": {"table": np.zeros((8, 4))},
              "layers": [{"w": np.zeros((4, 4))}]}
    for arch in ("phi3.5-moe-42b-a6.6b", "mamba2-130m", "whisper-small"):
        cfg = get_config(arch).reduced()
        assert specs.param_specs(params, cfg, RULES_1D) == {
            "embed": {"table": ("model", None)},
            "layers": [{"w": (None, "model")}]}
    cfg = get_config("internlm2-1.8b").reduced()
    assert specs.param_specs(params, cfg.replace(
        shard_params_over_data=True), RULES_1D) == specs.param_specs(
            params, cfg, RULES_1D)
    params = {"embed": {"table": np.zeros((8, 4))}}
    assert specs.param_specs(params, cfg, RULES_2D) == {
        "embed": {"table": (None, None)}}
    with pytest.raises(NotImplementedError, match="item 19"):
        specs.check_lm_mesh(cfg, 4, scheme="2d")
    with pytest.raises(NotImplementedError, match="item 19"):
        specs.check_lm_mesh(cfg.replace(shard_params_over_data=True), 2,
                            fsdp=True)


def test_cost_model_of_a_dense_lm_on_a_model_mesh_matches_reference():
    """``build_cost_model`` of a dense LM at n_model 2 (and with two data
    ranks) equals the reference's field for field, ``approx_comm`` among
    them, given the reference's TPU constants."""
    from repro.launch import analysis as RA
    for arch in ("internlm2-1.8b", "h2o-danube-1.8b", "pixtral-12b"):
        for n_data in (1, 2):
            cfg = get_config(arch).replace(scheme="1d")
            rcfg = ref_get_config(arch).replace(scheme="1d")
            got = telemetry.build_cost_model(
                cfg, n_model=2, n_data=n_data, batch=2, seq_len=1024,
                peak=RA.PEAK_FLOPS_BF16, link=RA.ICI_BW).as_meta()
            got["ici_bw"] = got.pop("link_bw")     # the reference's name
            want = RACC.build_cost_model(rcfg, n_model=2, n_data=n_data,
                                         batch=2, seq_len=1024).as_meta()
            assert want["approx_comm"]
            assert got == want, arch


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,p", FORWARDS)
def test_forward_matches_reference_and_one_device(launched, reference, arch,
                                                  p):
    """The logits of p ranks, gathered over the vocab on every rank,
    against the reference's 1-D forward on its (data 1, model p) mesh and
    the port's one-device forward."""
    cfg = _port_cfg(arch)
    with torch.no_grad():
        none, _ = M.apply(params_from_numpy(_ref_weights(arch), device="cpu"),
                          _torch_batch(_fwd_batch(arch)), cfg,
                          jigsaw_for(cfg))
    want = reference[f"fwd/{arch}/p{p}"]
    np.testing.assert_allclose(none.numpy(), want, rtol=1e-5, atol=1e-5)
    for res in launched.rank_results("m2" if p == 2 else "m4"):
        got = res[f"fwd/{arch}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, none.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# one train step, five-step histories, the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", list(MESHES))
def test_train_step_matches_one_device(launched, key):
    """One step of stablelm-3b (the reference scenario's arch, batch and
    schedule) on the mesh's shards against the port's one-device step on
    the whole parameters: loss and grad norm, every gradient leaf and
    every updated leaf; the norms' scales the same bits on every rank."""
    ranks = launched.rank_results(key)
    data, p = MESHES[key]
    cfg = _port_cfg(STEP_ARCH)
    whole = params_from_numpy(_ref_weights(STEP_ARCH), device="cpu")
    batch = _torch_batch(_step_batch())
    _, grads = step.value_and_grad(whole, batch, cfg, jigsaw_for(cfg))
    want_p, _, want_m = step.make_train_step(cfg, jigsaw_for(cfg))(
        whole, adam.init(whole, adam.AdamConfig()), batch)
    for res in ranks:
        assert _rel(res["step/loss"], float(want_m["loss"])) <= 1e-4
        assert _rel(res["step/grad_norm"],
                    float(want_m["grad_norm"])) <= 1e-4
    for rank, res in enumerate(ranks):
        r = rank % p
        for path, g in _flat(shard_params_1d(grads, r, p,
                                             spec=LM_SPEC)).items():
            got = res[f"step/grads/{path}"]
            err = np.abs(got - g.numpy()).max()
            assert err <= 1e-5 * np.abs(g.numpy()).max(), (path, err)
        for path, w in _flat(shard_params_1d(want_p, r, p,
                                             spec=LM_SPEC)).items():
            got = res[f"step/params/{path}"]
            np.testing.assert_allclose(got, w.numpy(), rtol=1e-3, atol=1e-4,
                                       err_msg=path)
            if path.split("/")[-1] == "scale":
                for peer in ranks:
                    assert np.array_equal(peer[f"step/params/{path}"], got)


@pytest.mark.parametrize("key,run", [("m2", impl) for impl in IMPLS]
                         + [("d2m2", "rs_zero1")])
def test_history_matches_reference(launched, reference, key, run):
    """Five TrainEngine steps of internlm2-1.8b on the mesh against the
    reference's TrainEngine on its mesh, the same weights, seed and impl
    (and ZeRO-1): loss, grad norm and lr within 1e-4 relative, the same on
    every rank; the engine's scheme is 1-D."""
    ranks = launched.rank_results(key)
    for res in ranks:
        for k in HIST_KEYS:
            assert _rel(res[f"{run}/{k}"], reference[f"{run}/{k}"]) <= 1e-4
            assert np.array_equal(res[f"{run}/{k}"], ranks[0][f"{run}/{k}"])
    if run == "rs":
        assert all(res["jcfg"].tolist() == ["1d", "rs"] for res in ranks)


def test_cli_two_ranks_matches_reference(launched, reference):
    """``launch/train.py --arch internlm2-1.8b --mesh-model 2 --device
    cpu`` on two gloo ranks (the scheme 1-D, the config's impl rs), from
    the reference's weights: five steps of loss, grad norm and lr within
    1e-4 of the reference CLI's ``train`` on its (data 1, model 2) mesh;
    rank 0 alone writes them."""
    tmp = launched.tmp
    out = tmp / "cli.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", HIST_ARCH, "--mesh-model", "2", "--device", "cpu",
         "--steps", "5", "--batch", "4", "--seq-len", "32", "--log-every",
         "1", "--prefetch", "0", "--init-params",
         str(tmp / f"{HIST_ARCH}.npz"), "--metrics-out", str(out)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300, cwd=tmp)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["step"] for r in got] == list(range(5))
    for k in HIST_KEYS:
        assert _rel([r[k] for r in got], reference[f"cli/{k}"]) <= 1e-4, \
            (k, got)


# ---------------------------------------------------------------------------
# the mesh's checkpoint, and what still raises
# ---------------------------------------------------------------------------

def test_save_on_a_model_mesh_restores(launched):
    """``TrainEngine.save`` of a language model on a model mesh (the rs
    run's, after five steps) writes each rank's blocks: restored whole on
    one device, the params are ``gather_params_1d`` of the ranks' blocks
    bit for bit (``tests/test_torch_lm_mesh_ckpt.py`` holds the resumes)."""
    from repro_torch.checkpoint import restore_tree
    ranks = launched.rank_results("m2")
    blocks = [{k[len("save/params/"):]: torch.from_numpy(v)
               for k, v in res.items() if k.startswith("save/params/")}
              for res in ranks]
    got = _flat(restore_tree(str(launched.tmp / "ck_m2"), "params"))
    trees = [ptree.map_with_path(
        lambda path, _, b=b: b["/".join(map(str, path))],
        restore_tree(str(launched.tmp / "ck_m2"), "params"))
        for b in blocks]
    want = _flat(gather_params_1d(trees, 2, spec=LM_SPEC))
    assert got.keys() == want.keys() and len(got) > 10
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "dbrx-132b",
                                  "mamba2-130m", "jamba-1.5-large-398b",
                                  "whisper-small"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_other_families_on_a_model_mesh_raise(arch, device):
    """The moe, ssm, hybrid and audio families train on a 1-D model mesh
    (``tests/test_torch_lm_mesh_zoo.py``); on a 2-D model mesh, and with
    the FSDP hybrid's cut over two data ranks, they raise
    NotImplementedError naming item 19, before any process group is
    joined, on either device."""
    with pytest.raises(NotImplementedError, match="item 19"):
        TrainEngine(arch, device=device, mesh_model=4, scheme="2d",
                    config=EngineConfig(steps=1, batch=2))
    cfg = get_config(arch).replace(shard_params_over_data=True)
    with pytest.raises(NotImplementedError, match="item 19"):
        TrainEngine(arch, device=device, mesh_model=2, mesh_data=2,
                    config_override=cfg,
                    config=EngineConfig(steps=1, batch=2))


def test_fsdp_cut_and_2d_of_a_dense_lm_raise():
    """The FSDP hybrid's cut of a dense LM over data, and a dense LM on a
    2-D model mesh, raise naming item 19 before any process group."""
    cfg = get_config("internlm2-1.8b")
    with pytest.raises(NotImplementedError, match="item 19"):
        TrainEngine("internlm2-1.8b", device="cpu", mesh_model=2,
                    mesh_data=2,
                    config_override=cfg.replace(shard_params_over_data=True),
                    config=EngineConfig(steps=1, batch=2))
    with pytest.raises(NotImplementedError, match="item 19"):
        TrainEngine("internlm2-1.8b", device="cpu", mesh_model=4,
                    scheme="2d", config=EngineConfig(steps=1, batch=2))


@pytest.mark.parametrize("field,value", [("n_heads", 6), ("d_model", 250),
                                         ("d_ff", 510)])
def test_indivisible_dims_raise(field, value):
    """A head count, width or FFN width that the model extent does not
    divide raises ValueError (the reference pads such dims through GSPMD;
    the port's blocks are exact), and so does a vocabulary whose padded
    size it does not divide; divisible dims pass."""
    cfg = get_config("internlm2-1.8b").reduced()
    specs.check_lm_mesh(cfg, 4)
    with pytest.raises(ValueError, match=field):
        specs.check_lm_mesh(cfg.replace(**{field: value}), 4)
    with pytest.raises(ValueError, match="'vocab_padded': 1024}"):
        specs.check_lm_mesh(cfg.replace(n_heads=6, d_model=384, d_ff=768),
                            3)
    with pytest.raises(ValueError, match="n_heads"):
        TrainEngine("internlm2-1.8b", device="cpu", mesh_model=3,
                    config=EngineConfig(steps=1, batch=2))


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference_main(sys.argv[2], sys.argv[3])
    else:
        _rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
