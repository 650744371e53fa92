"""The port's 1-D Jigsaw WeatherMixer and its training on four ranks against
the JAX package's on its (data=1, model=4) mesh.

Weights come from the reference's ``init`` (carried over as numpy),
batches from a numpy seed or the shared synthetic weather data, on the
reduced config (grid 32x64, 8 channels, patch 4, d = d_tok = d_ch = 128:
T = 128 tokens and a patch dim of 128, every dim divisible by 4).  The
reference runs on four host-emulated devices in a subprocess (this file
run as a script with ``--reference``); the port's four ranks are gloo
processes, either this file run as a script with ``--rank`` (``file://``
store in the test's temporary directory) or the training CLI under
``torch.distributed.run --standalone``.  On the CPU ``ring_fused`` runs
its kernels' plain versions.

Tolerances: the forward 1e-5 (sums in another order); one training step
against the port's scheme="none" step: loss rtol 1e-4, parameters rtol
1e-3 / atol 1e-4 (the 2-D path's bounds, the reference's
``scenario_train_step_mesh`` limits); five-step loss, grad-norm and lr
histories 1e-4 relative (as the one-device histories).  Replicated
parameters are held bit for bit across ranks.
"""
import dataclasses
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
from repro.launch import shapes as ref_shapes
from repro.models import weathermixer as RW
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, shard_params_1d
from repro_torch.core import tree as ptree
from repro_torch.kernels import fused_ring
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import weathermixer as W
from repro_torch.optim import adam
from repro_torch.train import step
from test_torch_ring import Launched

ROOT = Path(__file__).resolve().parents[1]
P = 4
HIST_KEYS = ("loss", "grad_norm", "lr")
IMPLS = ("ring_chunked", "ring_fused", "rs")
COMMON = dict(batch=2, log_every=1, prefetch=0, telemetry=False, seed=0,
              pipeline="sync-full")


def _cfg(**kw):
    """The reduced weathermixer-1b (as ``TrainEngine(reduced=True)`` makes
    it), with ``kw``."""
    return ref_get_config("weathermixer-1b").reduced().replace(**kw)


def _port_cfg(ref_cfg):
    return get_config("weathermixer-1b").replace(
        **{f.name: getattr(ref_cfg, f.name)
           for f in dataclasses.fields(ref_cfg)})


def _weights():
    return jax.tree.map(np.asarray, RW.init(jax.random.PRNGKey(0), _cfg()))


def _batch(cfg, seed=5, n=2):
    rng = np.random.default_rng(seed)
    shape = (n, cfg.wm_lat, cfg.wm_lon, cfg.wm_channels)
    return {k: rng.normal(size=shape).astype(np.float32)
            for k in ("fields", "target")}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))


def _flat(tree):
    """{"a/b/c": leaf} of a tree of tensors or arrays."""
    out = {}
    ptree.map_with_path(
        lambda path, a: out.__setitem__("/".join(map(str, path)), a), tree)
    return out


# ---------------------------------------------------------------------------
# the reference (subprocess) and the port's ranks (gloo processes)
# ---------------------------------------------------------------------------

def _reference_main(path):
    """The reference on its four-device 1-D mesh: the model's forward, and
    five-step TrainEngine runs of each impl (kernel="xla") from the same
    weights."""
    from repro.launch.engine import EngineConfig as REngineConfig
    from repro.launch.engine import TrainEngine as RTrainEngine
    from repro.launch.mesh import make_host_mesh
    out = {}
    cfg = _cfg(scheme="1d")
    with jax.set_mesh(make_host_mesh(model=P, data=1)):
        params = jax.tree.map(jnp.asarray, _weights())
        fields = jnp.asarray(_batch(cfg)["fields"])
        y, _ = jax.jit(lambda p, f: RW.apply(p, {"fields": f}, cfg,
                                             ref_shapes.jigsaw_for(cfg)))(
            params, fields)
        out["fwd"] = np.asarray(y)
    for impl in IMPLS:
        eng = RTrainEngine("weathermixer-1b", reduced=True, mesh_model=P,
                           scheme="1d", impl=impl, kernel="xla",
                           init_params=jax.tree.map(jnp.asarray, _weights()),
                           config=REngineConfig(steps=5, **COMMON))
        hist = eng.run()
        for k in HIST_KEYS:
            out[f"{impl}/{k}"] = [h[k] for h in hist]
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


def _rank_main(rank, p, init, out_dir):
    """One rank of the port's four-rank 1-D mesh: the model's forward (the
    whole field gathered), one training step on its shards, five-step
    TrainEngine runs of each impl, and the ring calls of a step; saved to
    p<p>_rank<r>.npz."""
    import torch.distributed as dist
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.launch.mesh import make_ring_mesh
    from repro_torch.models import registry as M
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=p)
    mesh = make_ring_mesh(p, device="cpu")
    cfg = _port_cfg(_cfg(scheme="1d"))
    jcfg = jigsaw_for(cfg).replace(mesh=mesh)
    whole = params_from_numpy(_weights(), device="cpu")
    params = shard_params_1d(whole, rank, p)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    res = {}
    with torch.no_grad():
        res["fwd"] = W.forecast_step(params, batch["fields"], cfg, jcfg,
                                     gather=True).numpy()
    train_step = step.make_train_step(cfg, jcfg, lr_fn=lambda s: 1e-3)
    params, _, metrics = train_step(params, adam.init(params,
                                                      adam.AdamConfig()),
                                    batch)
    res["step/loss"] = metrics["loss"].numpy()
    res["step/grad_norm"] = metrics["grad_norm"].numpy()
    for k, v in _flat(params).items():
        res[f"step/params/{k}"] = v.numpy()
    for impl in IMPLS:
        eng = TrainEngine("weathermixer-1b", reduced=True, mesh_model=p,
                          scheme="1d", impl=impl, init_params=whole,
                          device="cpu", config=EngineConfig(steps=5,
                                                            **COMMON))
        hist = eng.run()
        eng.close()
        for k in HIST_KEYS:
            res[f"{impl}/{k}"] = np.array([h[k] for h in hist])
    # the ring calls of one sample-step (3 blocks, remat), counted at the
    # dispatch that launches p kernels on the card
    calls = {"fwd": 0, "bwd": 0}

    def counting(key, real):
        def f(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)
        return f
    fused_ring.ring_forward = counting("fwd", fused_ring.ring_forward)
    fused_ring.ring_backward = counting("bwd", fused_ring.ring_backward)
    cfg3 = cfg.replace(n_layers=3, remat=True, impl="ring_fused")
    jcfg3 = jigsaw_for(cfg3).replace(mesh=mesh)
    p3 = shard_params_1d(M.init(cfg3, seed=0, device="cpu"), rank, p)
    for r in (1, 2):
        calls.update(fwd=0, bwd=0)
        step.value_and_grad(p3, batch, cfg3, jcfg3, r)
        res[f"calls/{r}"] = np.array([calls["fwd"], calls["bwd"]])
    np.savez(Path(out_dir) / f"p{p}_rank{rank}.npz",
             **{k: np.asarray(v) for k, v in res.items()})
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train1d")
    np.savez(tmp / "init.npz", **_flat(_weights()))
    runs = Launched(tmp, __file__, ps=(P,))
    yield runs
    runs.close()


@pytest.fixture(scope="module")
def ranks(launched):
    return launched.rank_results(P)


@pytest.fixture(scope="module")
def reference(launched):
    return launched.reference()


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _none_forward():
    cfg = _port_cfg(_cfg())
    with torch.no_grad():
        out, _ = W.apply(params_from_numpy(_weights(), device="cpu"),
                         {"fields": torch.from_numpy(_batch(cfg)["fields"])},
                         cfg, jigsaw_for(cfg))
    return out.numpy()


def test_forward_one_rank_matches_none_model():
    """scheme="1d" on a one-rank mesh (no process group): the rank's block
    is the whole field, equal to the scheme="none" forward."""
    cfg = _port_cfg(_cfg(scheme="1d"))
    jcfg = jigsaw_for(cfg)
    assert jcfg.scheme == "1d" and jcfg.mesh is None
    with torch.no_grad():
        block, _ = W.apply(params_from_numpy(_weights(), device="cpu"),
                           {"fields": torch.from_numpy(_batch(cfg)["fields"])},
                           cfg, jcfg)
    assert block.shape == (2, W.n_tokens(cfg), W.patch_dim(cfg))
    got = W.gather_field(block, cfg, jcfg)
    np.testing.assert_allclose(got.numpy(), _none_forward(), rtol=1e-5,
                               atol=1e-5)


def test_forward_matches_reference_and_none_model(ranks, reference):
    """Four ranks' forward, gathered on every rank, against the reference's
    1-D mesh and the port's scheme="none" model."""
    none = _none_forward()
    for res in ranks:
        np.testing.assert_allclose(res["fwd"], reference["fwd"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(res["fwd"], none, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_train_step_matches_none_step(ranks):
    """One step on the four ranks' shards against the port's one-device
    step on the whole parameters (same weights, batch, Adam, lr); the
    replicated leaves (LayerNorm, blend) are bit-equal on every rank."""
    cfg = _port_cfg(_cfg())
    params = params_from_numpy(_weights(), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    want_p, _, want_m = step.make_train_step(cfg, jigsaw_for(cfg),
                                             lr_fn=lambda s: 1e-3)(
        params, adam.init(params, adam.AdamConfig()), batch)
    for res in ranks:
        assert _rel(res["step/loss"], float(want_m["loss"])) <= 1e-4
        assert _rel(res["step/grad_norm"],
                    float(want_m["grad_norm"])) <= 1e-4
    for r, res in enumerate(ranks):
        for path, want in _flat(shard_params_1d(want_p, r, P)).items():
            got = res[f"step/params/{path}"]
            np.testing.assert_allclose(got, want.numpy(), rtol=1e-3,
                                       atol=1e-4, err_msg=path)
            if path.split("/")[-1] in ("scale", "bias", "blend"):
                for peer in ranks:
                    assert np.array_equal(peer[f"step/params/{path}"], got)


@pytest.mark.parametrize("impl", IMPLS)
def test_history_matches_reference(ranks, reference, impl):
    """Five TrainEngine steps on four ranks against the reference's
    TrainEngine(scheme="1d") on its four-device mesh, same weights, seed
    and impl: loss, grad norm and lr within 1e-4 relative, the same on
    every rank."""
    for res in ranks:
        for k in HIST_KEYS:
            assert _rel(res[f"{impl}/{k}"], reference[f"{impl}/{k}"]) <= 1e-4
            assert np.array_equal(res[f"{impl}/{k}"], ranks[0][f"{impl}/{k}"])


def test_ring_calls_per_step(ranks):
    """A ring_fused training sample-step at 3 blocks with remat: 2 + 24 r
    forward ring calls (encoder and decoder once; the four mixing linears
    of each block in the forward and in the checkpoint's rerun) and 2 + 12 r
    backward ones; on the card each is p launches."""
    for res in ranks:
        for r in (1, 2):
            assert res[f"calls/{r}"].tolist() == [2 + 24 * r, 2 + 12 * r]


@pytest.mark.parametrize("fails", [False, True])
def test_train_closes_collectively_only_on_a_clean_exit(monkeypatch, fails):
    """``launch/train.py::train`` releases the ring's workspaces with the
    collective close after a clean run, and with the local one when a step
    raised (the peers may wait in another collective), re-raising the
    error."""
    from repro_torch.launch import train as train_mod
    closes = []

    class Engine:
        params = None

        def __init__(self, *a, **kw):
            pass

        def run(self):
            if fails:
                raise RuntimeError("a step failed")
            return []

        def close(self, collective=True):
            closes.append(collective)

    monkeypatch.setattr(train_mod, "TrainEngine", Engine)
    if fails:
        with pytest.raises(RuntimeError, match="a step failed"):
            train_mod.train("weathermixer-1b", device="cpu")
    else:
        assert train_mod.train("weathermixer-1b", device="cpu") == ([], None)
    assert closes == [not fails]


# ---------------------------------------------------------------------------
# the training CLI under torch.distributed.run
# ---------------------------------------------------------------------------

def test_cli_four_ranks_matches_reference(launched, reference):
    """``launch/train.py --mesh-model 4 --scheme 1d --impl ring_fused`` on
    four gloo ranks (``kernel="pallas"``: the kernels' plain versions on the
    CPU), from the reference's weights: five steps of loss, grad norm and
    lr within 1e-4 of the reference's ring_fused run; rank 0 alone writes
    them."""
    tmp = launched.tmp
    out = tmp / "cli.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(P), "-m", "repro_torch.launch.train",
         "--mesh-model", str(P), "--scheme", "1d", "--impl", "ring_fused",
         "--pipeline", "sync-full", "--device", "cpu", "--kernel", "pallas",
         "--steps", "5", "--batch", "2", "--log-every", "1", "--prefetch",
         "0", "--init-params", str(tmp / "init.npz"), "--metrics-out",
         str(out)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300, cwd=tmp)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["step"] for r in got] == list(range(5))
    for k in HIST_KEYS:
        assert _rel([r[k] for r in got], reference[f"ring_fused/{k}"]) \
            <= 1e-4, (k, got)


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference_main(sys.argv[2])
    else:
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
