"""The port's 2-D Jigsaw WeatherMixer and its training on a 2x2 mesh
against the JAX package's.

Weights come from the reference's ``init`` (carried over as numpy),
batches from a numpy seed or the shared synthetic weather data.  The
reference's 2x2 mesh runs on four host-emulated devices in a subprocess
(this file run as a script with ``--reference``), Pallas in interpret
mode except for the bf16 run; the port's is four processes under gloo,
either this file run as a script with ``--rank`` (``file://`` store in the
test's temporary directory) or the training CLI under
``torch.distributed.run --standalone`` (which takes a free port).  The
port's runs use ``kernel="pallas"``: on the CPU, the kernels' plain
versions through the same autograd Functions as on the card.

Tolerances: forward f32 1e-5 (sums in another order); one training step
against the port's scheme="none" step: loss rtol 1e-4, parameters rtol
1e-3 / atol 1e-4 (the reference's ``scenario_train_step_mesh`` limits);
five-step loss, grad-norm and lr histories 1e-4 relative (as the
one-device histories); the ``bf16`` policy 5e-2 (the reference's bf16
loss-parity bound).  Replicated parameters and two runs of one seed are
held bit for bit.
"""
import collections
import contextlib
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
from repro.train import loss as ref_loss
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, shard_params_2d
from repro_torch.core import tree as ptree
from repro_torch.core.sharding import Mesh
from repro_torch.kernels import fused_ring, ops
from repro_torch.launch.engine import EngineConfig, TrainEngine
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import weathermixer as W
from repro_torch.optim import adam
from repro_torch.train import loss as losses
from repro_torch.train import step
from test_torch_cannon import Launched

ROOT = Path(__file__).resolve().parents[1]
Q = 2
HIST_KEYS = ("loss", "grad_norm", "lr")
BF16_STEPS = 3


def _tiny(**kw):
    """A mixer of T = 32 tokens, patch dim 64, d = 64 (2x2 blocks of 16
    tokens and 32 features)."""
    return ref_get_config("weathermixer-1b").reduced().replace(
        **dict(dict(wm_lat=16, wm_lon=32, wm_channels=4, d_model=64,
                    wm_d_tok=64, wm_d_ch=64, n_layers=2, remat=True,
                    kernel="pallas"), **kw))


def _port_cfg(ref_cfg):
    return get_config("weathermixer-1b").replace(
        **{f.name: getattr(ref_cfg, f.name)
           for f in dataclasses.fields(ref_cfg)})


def _weights():
    return jax.tree.map(np.asarray, RW.init(jax.random.PRNGKey(0), _tiny()))


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
    """The reference on its 2x2 mesh: the tiny model's forward, a bf16
    training run of it (``kernel="xla"``: the 5e-2 bound is far above what
    the engine changes, and interpret-mode Pallas would double the run),
    and a five-step fp32 run of the reduced config (the CLI's, Pallas in
    interpret mode) with the weights it started from."""
    from repro.launch.engine import EngineConfig as REngineConfig
    from repro.launch.engine import TrainEngine as RTrainEngine
    from repro.launch.mesh import make_host_mesh
    out = {}
    cfg = _tiny(scheme="2d")
    with jax.set_mesh(make_host_mesh(model=4, data=1, two_d=True)):
        params = jax.tree.map(jnp.asarray, _weights())
        fields = jnp.asarray(_batch(cfg)["fields"])
        y, _ = jax.jit(lambda p, f: RW.apply(p, {"fields": f}, cfg,
                                             ref_shapes.jigsaw_for(cfg)))(
            params, fields)
        out["fwd"] = np.asarray(y)
    common = dict(batch=2, log_every=1, prefetch=0, telemetry=False, seed=0,
                  pipeline="sync-full")
    bf = RTrainEngine("weathermixer-1b", reduced=False, mesh_model=4,
                      scheme="2d", kernel="xla", config_override=_tiny(),
                      config=REngineConfig(steps=BF16_STEPS,
                                           precision="bf16", **common))
    out["bf16/loss"] = [h["loss"] for h in bf.run()]
    eng = RTrainEngine("weathermixer-1b", reduced=True, mesh_model=4,
                       scheme="2d", kernel="pallas",
                       config=REngineConfig(steps=5, **common))
    init = _flat(jax.tree.map(np.asarray, eng.params))
    np.savez(Path(path).with_name("init.npz"), **init)
    hist = eng.run()
    for k in HIST_KEYS:
        out[f"hist/{k}"] = [h[k] for h in hist]
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


def _rank_main(rank, init, out_dir):
    """One rank of the port's 2x2 mesh: the tiny model's forward (the whole
    field gathered), one training step on its shards, and a bf16 run of
    the training engine; saved to rank<r>.npz."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=Q * Q)
    mesh = make_host_mesh(Q * Q, device="cpu")
    cfg = _port_cfg(_tiny(scheme="2d"))
    jcfg = jigsaw_for(cfg).replace(mesh=mesh)
    whole = params_from_numpy(_weights(), device="cpu")
    params = shard_params_2d(whole, mesh.i, mesh.j, Q)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    res = {"ij": np.array([mesh.i, mesh.j])}
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
    eng = TrainEngine(
        "weathermixer-1b", reduced=False, mesh_model=Q * Q, scheme="2d",
        config_override=_port_cfg(_tiny()), init_params=whole, device="cpu",
        config=EngineConfig(steps=BF16_STEPS, batch=2, log_every=1,
                            prefetch=0, telemetry=False, seed=0,
                            precision="bf16", pipeline="sync-full"))
    with _recording_dx() as seen:
        res["bf16/loss"] = np.array([h["loss"] for h in eng.run()])
    res["bf16/dx_seen"] = np.array(seen, dtype=bool).reshape(-1, 3)
    res.update(_count_calls(mesh))
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


def _count_calls(mesh):
    """The kernel wrappers' calls in one 2x2 forward and backward (3
    blocks, remat) at r = 1 and 2, counted at their call sites: fused
    Cannon forwards (``cannon_path``: one per call), wx by layout,
    block_matmul."""
    calls = collections.Counter()

    def counting(mod, name, key):
        real = getattr(mod, name)

        def f(*a, **kw):
            calls[key(kw) if callable(key) else key] += 1
            return real(*a, **kw)
        return mod, name, real, f
    patches = [counting(fused_ring, "cannon_path", "fused"),
               counting(fused_ring, "wx", lambda kw: ("wx_dx" if
                                                      kw.get("w_t")
                                                      else "wx_fwd")),
               counting(fused_ring, "block_matmul", "bm"),
               counting(ops, "block_matmul", "bm")]
    cfg = _port_cfg(_tiny(n_layers=3, remat=True, scheme="2d"))
    jcfg = jigsaw_for(cfg).replace(mesh=mesh)
    params = shard_params_2d(params_from_numpy(
        jax.tree.map(np.asarray, RW.init(jax.random.PRNGKey(0),
                                         _tiny(n_layers=3))), device="cpu"),
        mesh.i, mesh.j, Q)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = {}
    try:
        for mod, name, _, f in patches:
            setattr(mod, name, f)
        for r in (1, 2):
            calls.clear()
            step.value_and_grad(params, batch, cfg, jcfg, r)
            out[f"calls/{r}"] = np.array([calls[k] for k in
                                          ("fused", "wx_fwd", "wx_dx",
                                           "bm")])
    finally:
        for mod, name, real, _ in patches:
            setattr(mod, name, real)
    return out


@contextlib.contextmanager
def _recording_dx():
    """fused_ring.wx, recording for each dx call (w read across its rows)
    whether w is bf16, the cotangent f32, and the cotangent bf16-exact:
    what lets wx's dx route contract one split term."""
    seen = []
    real = fused_ring.wx

    def recording(w, x, a=None, **kw):
        if kw.get("w_t"):
            seen.append([w.dtype == torch.bfloat16, x.dtype == torch.float32,
                         bool(torch.equal(x, x.to(torch.bfloat16).float()))])
        return real(w, x, a, **kw)
    fused_ring.wx = recording
    try:
        yield seen
    finally:
        fused_ring.wx = real


def _env(**kw):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), **kw)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    runs = Launched(tmp_path_factory.mktemp("train2d"), __file__)
    yield runs
    runs.close()


@pytest.fixture(scope="module")
def ranks(launched):
    return launched.rank_results()


@pytest.fixture(scope="module")
def reference(launched):
    return launched.reference(), launched.ref_path.with_name("init.npz")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def test_forward_1x1_matches_reference_mesh():
    """scheme="2d" on the 1x1 mesh (no process group) against the
    reference's 2-D forward on its 1x1 mesh, in process."""
    from repro.launch.mesh import make_host_mesh
    cfg = _tiny(scheme="2d")
    params, batch = _weights(), _batch(cfg)
    with jax.set_mesh(make_host_mesh(model=1, data=1, two_d=True)):
        want, _ = RW.apply(jax.tree.map(jnp.asarray, params),
                           {"fields": jnp.asarray(batch["fields"])}, cfg,
                           ref_shapes.jigsaw_for(cfg))
    pcfg = _port_cfg(cfg)
    jcfg = jigsaw_for(pcfg)
    assert jcfg.scheme == "2d" and jcfg.mesh is None
    with torch.no_grad():
        block, _ = W.apply(params_from_numpy(params, device="cpu"),
                           {"fields": torch.from_numpy(batch["fields"])},
                           pcfg, jcfg)
    assert block.shape == (2, W.n_tokens(pcfg), W.patch_dim(pcfg))
    got = W.gather_field(block, pcfg, jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_forward_2x2_matches_reference(ranks, reference):
    ref, _ = reference
    for res in ranks.values():     # every rank gathers the whole field
        np.testing.assert_allclose(res["fwd"], ref["fwd"], rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the loss on blocks, and one training step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [1, 2])
def test_block_losses_sum_to_reference_weighted_mse(q):
    """Each rank's weighted squared error of its block in patch space,
    summed over the ranks and divided by the field's element count, is the
    reference's weighted_mse of the whole field (69 channels: level
    weights on)."""
    cfg = _port_cfg(_tiny().replace(wm_lat=8, wm_lon=16, wm_channels=69))
    b = _batch(cfg, seed=9)
    want = ref_loss.weighted_mse(
        jnp.asarray(b["fields"]), jnp.asarray(b["target"]),
        ref_loss.latitude_weights(8), ref_loss.pressure_level_weights(69))
    lat_w, chan_w = losses.latitude_weights(8), losses.pressure_level_weights(
        69)
    total = 0.0
    for i in range(q):
        for j in range(q):
            jcfg = jigsaw_for(cfg.replace(scheme="2d")).replace(
                mesh=Mesh(q=q, i=i, j=j))
            pred, tgt = (W.field_block(torch.from_numpy(b[k]), cfg, jcfg)
                         for k in ("fields", "target"))
            tl, pl = pred.shape[-2:]
            lat_b, chan_b = losses.block_weights(
                lat_w, chan_w, lon=16, patch=cfg.wm_patch, channels=69,
                rows=range(i * tl, (i + 1) * tl),
                cols=range(j * pl, (j + 1) * pl))
            total += float(losses.weighted_sse(pred, tgt, lat_b, chan_b))
    np.testing.assert_allclose(total / b["fields"].size, float(want),
                               rtol=1e-5)


def test_train_step_2x2_matches_none_step(ranks):
    """One step on the 2x2 shards against the port's one-device step on the
    whole parameters (same weights, batch, Adam, lr); replicated leaves are
    bit-equal on every rank that holds them."""
    cfg = _port_cfg(_tiny())
    params = params_from_numpy(_weights(), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    want_p, _, want_m = step.make_train_step(cfg, jigsaw_for(cfg),
                                             lr_fn=lambda s: 1e-3)(
        params, adam.init(params, adam.AdamConfig()), batch)
    for res in ranks.values():
        assert _rel(res["step/loss"], float(want_m["loss"])) <= 1e-4
        assert _rel(res["step/grad_norm"],
                    float(want_m["grad_norm"])) <= 1e-4
    for (i, j), res in ranks.items():
        for path, want in _flat(shard_params_2d(want_p, i, j, Q)).items():
            np.testing.assert_allclose(res[f"step/params/{path}"],
                                       want.numpy(), rtol=1e-3, atol=1e-4,
                                       err_msg=path)
            name = path.split("/")[-1]
            if name == "w":
                continue
            # a replicated leaf: equal on every rank that shares it (the
            # ranks of its replica axes: both for LayerNorm and blend, the
            # other one than its block's for a bias)
            keep = {"b": 0 if "/tok_fc" in path else 1}.get(name)
            for ij, peer in ranks.items():
                if keep is None or ij[keep] == (i, j)[keep]:
                    assert np.array_equal(peer[f"step/params/{path}"],
                                          res[f"step/params/{path}"]), path


def test_bf16_policy_2x2_within_reference_bound(ranks, reference):
    ref, _ = reference
    for res in ranks.values():
        got = res["bf16/loss"]
        assert len(got) == BF16_STEPS
        assert _rel(got, ref["bf16/loss"]) <= 5e-2, (got, ref["bf16/loss"])


# ---------------------------------------------------------------------------
# the training CLI under torch.distributed.run
# ---------------------------------------------------------------------------

def _cli_history(tmp, init_npz, tag):
    out = tmp / f"{tag}.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--mesh-model", "4", "--scheme", "2d", "--pipeline", "sync-full",
         "--device", "cpu", "--kernel", "pallas", "--steps", "5",
         "--batch", "2", "--log-every", "1", "--prefetch", "0",
         "--init-params", str(init_npz), "--metrics-out", str(out)],
        env=_env(OMP_NUM_THREADS="1"), capture_output=True, text=True,
        timeout=300, cwd=tmp)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(line) for line in out.read_text().splitlines()]


def test_cli_2x2_history_matches_reference_and_repeats(reference,
                                                       tmp_path):
    """``launch/train.py --mesh-model 4 --scheme 2d`` on four gloo ranks:
    five steps of loss, grad norm and lr against the reference's
    TrainEngine on its 2x2 mesh from the same weights and seed (Pallas in
    interpret mode); a second run gives the same history bit for bit, and
    only rank 0 writes it."""
    ref, init_npz = reference
    runs = [_cli_history(tmp_path, init_npz, tag) for tag in ("a", "b")]
    for got in runs:
        assert [r["step"] for r in got] == list(range(5))
        for k in HIST_KEYS:
            assert _rel([r[k] for r in got], ref[f"hist/{k}"]) <= 1e-4, (
                k, got, ref[f"hist/{k}"])
    assert [{k: r[k] for k in HIST_KEYS} for r in runs[0]] == \
        [{k: r[k] for k in HIST_KEYS} for r in runs[1]]


# ---------------------------------------------------------------------------
# the engine's guards, and the launches of a 2-D step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(mesh_model=4, mesh_data=2, scheme="2d"), "item 8"),
    (dict(mesh_model=4, scheme="none"), "GSPMD")])
def test_engine_mesh_paths_not_ported_raise(kw, match):
    pipeline = "sync-full" if kw.get("scheme") == "none" else "sharded"
    with pytest.raises(NotImplementedError, match=match):
        TrainEngine("weathermixer-1b", device="cpu",
                    config=EngineConfig(steps=1, pipeline=pipeline), **kw)


@pytest.mark.parametrize("rollout", [1, 2])
def test_2x2_kernel_calls_per_rank(ranks, rollout):
    """One 2x2 forward and backward (3 blocks, remat), per rank, counted
    on the CPU at the call sites: 12 r fused Cannon calls (two token-mix
    linears a block, forward and the checkpoint's rerun), each q = 2
    launches of the Cannon kernel on the card, 24 r; the fused VJP's
    recompute 12 r wx forward-layout launches (on the CPU the fused forward
    runs its q wx steps too) and 12 r dx; block_matmul 10 + 60 r (the
    q = 1 counts, each Cannon product now q steps)."""
    for res in ranks.values():
        fused, wx_fwd, wx_dx, bm = res[f"calls/{rollout}"]
        assert fused * Q == 24 * rollout
        assert wx_fwd - fused * Q == 12 * rollout
        assert wx_dx == 12 * rollout
        assert bm == 10 + 60 * rollout


@pytest.mark.parametrize("rollout,remat", [(1, True), (2, True),
                                           (1, False)])
def test_2d_kernel_calls_per_step(monkeypatch, rollout, remat):
    """A 2-D step at q = 1 (3 blocks): the token mix runs 18 r wx launches
    with remat (6 r forward, 6 r in the checkpoint's rerun, 6 r dx) and
    12 r without; block_matmul 5 + 30 r (channel mix forward, rerun, dx and
    dw, 24 r; the token mix's dw, 6 r; encoder forward and dw, decoder
    forward, dx and dw) and 5 + 24 r without remat.  Counted on the CPU at
    the wrappers' call sites."""
    calls = {"wx": 0, "bm": 0}

    def counting(key, real):
        def f(*a, **kw):
            calls[key] += 1
            return real(*a, **kw)
        return f
    monkeypatch.setattr(ops, "block_matmul",
                        counting("bm", ops.block_matmul))
    monkeypatch.setattr(fused_ring, "block_matmul",
                        counting("bm", fused_ring.block_matmul))
    monkeypatch.setattr(fused_ring, "wx", counting("wx", fused_ring.wx))
    cfg = _port_cfg(_tiny(n_layers=3, remat=remat, scheme="2d"))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    params = params_from_numpy(
        jax.tree.map(np.asarray, RW.init(jax.random.PRNGKey(0),
                                         _tiny(n_layers=3))), device="cpu")
    step.value_and_grad(params, batch, cfg, jigsaw_for(cfg), rollout)
    wx_per = 18 if remat else 12
    bm_per = 30 if remat else 24
    assert calls == {"wx": wx_per * rollout, "bm": 5 + bm_per * rollout}


def test_2d_dx_cotangent_is_bf16_exact_at_q1():
    """Under the bf16 policy the cotangent that reaches every wx dx of a
    2-D step at q = 1 is the f32 image of a bf16 one (the Cannon product
    is cast to bf16 before anything reads it, and the step loop passes
    da = dy through), against a bf16 w: the condition under which wx's dx
    route contracts one split term (``WX.dx_terms`` on the card)."""
    eng = TrainEngine("weathermixer-1b", reduced=False, device="cpu",
                      config_override=_port_cfg(_tiny(n_layers=3)),
                      config=EngineConfig(steps=1, batch=2, prefetch=0,
                                          precision="bf16", telemetry=False))
    batch = eng.pipeline.get(0, 1)
    with _recording_dx() as seen:
        step.value_and_grad(eng.params, batch, eng.cfg.replace(scheme="2d"),
                            eng.jcfg.replace(scheme="2d"), 1)
    assert len(seen) == 6 and all(all(s) for s in seen), seen


def test_2x2_dx_cotangent_is_bf16_exact(ranks):
    """The same on the 2x2 mesh: every dx of the bf16 training run's
    steps (the fused Cannon's VJP, the step loop recomputed: 2 blocks, two
    token-mix linears, q = 2 steps each, 8 a step) on every rank takes a
    bf16 w and a bf16-exact f32 cotangent."""
    for res in ranks.values():
        seen = res["bf16/dx_seen"]
        assert len(seen) == 8 * BF16_STEPS and seen.all(), seen


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference_main(sys.argv[2])
    else:
        _rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
