"""The port's one-device training path against the JAX package's.

Weights come from the reference's ``init`` (carried over with
``repro_torch.convert``), batches from the same synthetic weather data, and
the inputs of the op-level tests from a numpy seed.  Tolerances: f32 2e-5
per op (``tests/test_kernels.py``), 1e-4 relative on five-step histories
(the two sides sum in different orders, and Adam's first steps divide by
small second moments); the ``bf16`` policy 5e-2 (the reference's bf16
loss-parity bound).  The reference runs ``kernel="xla"`` for the histories
and one step at ``kernel="pallas"`` (Pallas in interpret mode); the port's
``kernel="pallas"`` takes the plain version of the kernel on the CPU,
through the same ``autograd.Function`` as on the card.
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
from repro.data.pipeline import make_pipeline as ref_make_pipeline
from repro.launch import shapes as ref_shapes
from repro.launch.engine import EngineConfig as REngineConfig
from repro.launch.engine import TrainEngine as RTrainEngine
from repro.models import weathermixer as RW
from repro.optim import adam as ref_adam
from repro.optim import schedule as ref_sched
from repro.train import loss as ref_loss
from repro.train import step as ref_step
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import tree as ptree
from repro_torch.data.pipeline import InputPipeline, make_pipeline
from repro_torch.kernels import block_matmul as BM
from repro_torch.kernels import ops
from repro_torch.launch.engine import EngineConfig, TrainEngine
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import registry as M
from repro_torch.optim import adam, schedule
from repro_torch.train import loss, step

ROOT = Path(__file__).resolve().parents[1]
HIST_KEYS = ("loss", "grad_norm", "lr")


def _tiny(**kw):
    """A mixer of T = 32 tokens, d = 64 (tests/test_serve.py's)."""
    return ref_get_config("weathermixer-1b").reduced().replace(
        wm_lat=16, wm_lon=32, wm_channels=4, d_model=64, wm_d_tok=64,
        wm_d_ch=64, **kw)


def _port_cfg(ref_cfg):
    return get_config("weathermixer-1b").replace(
        **{f.name: getattr(ref_cfg, f.name)
           for f in dataclasses.fields(ref_cfg)})


def _ref_init(cfg, seed=0):
    return jax.tree.map(np.asarray, RW.init(jax.random.PRNGKey(seed), cfg))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))


# ---------------------------------------------------------------------------
# loss, schedule, Adam
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [30, 69])
def test_weighted_mse_matches_reference(channels):
    rng = np.random.default_rng(channels)
    pred = rng.normal(size=(2, 12, 16, channels)).astype(np.float32)
    tgt = rng.normal(size=(2, 12, 16, channels)).astype(np.float32)
    r_lat, r_ch = (np.asarray(ref_loss.latitude_weights(12)),
                   np.asarray(ref_loss.pressure_level_weights(channels)))
    lat, ch = loss.latitude_weights(12), loss.pressure_level_weights(channels)
    assert np.array_equal(lat.numpy(), r_lat)
    assert np.array_equal(ch.numpy(), r_ch)
    want = ref_loss.weighted_mse(jnp.asarray(pred), jnp.asarray(tgt),
                                 jnp.asarray(r_lat), jnp.asarray(r_ch))
    got = loss.weighted_mse(torch.from_numpy(pred), torch.from_numpy(tgt),
                            lat, ch)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5)


def test_loss_fn_at_69_channels_has_level_weights_on():
    """C >= 69 switches the pressure-level weights on (the full width's
    variable set), in both packages."""
    cfg = ref_get_config("weathermixer-1b").reduced().replace(
        wm_lat=8, wm_lon=16, wm_channels=69, wm_patch=4, d_model=32,
        wm_d_tok=32, wm_d_ch=32)
    rng = np.random.default_rng(3)
    batch = {k: rng.normal(size=(2, 8, 16, 69)).astype(np.float32)
             for k in ("fields", "target")}
    params = _ref_init(cfg)
    want, _ = ref_step.loss_fn(jax.tree.map(jnp.asarray, params),
                               jax.tree.map(jnp.asarray, batch), cfg,
                               ref_shapes.jigsaw_for(cfg))
    pcfg = _port_cfg(cfg)
    got, metrics = step.loss_fn(params_from_numpy(params, device="cpu"),
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                                pcfg, jigsaw_for(pcfg))
    assert float(metrics["mse"]) == float(got)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-5)
    tparams = params_from_numpy(params, device="cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pred, _ = M.apply(tparams, tbatch, pcfg, jigsaw_for(pcfg))
    lat = loss.latitude_weights(8)
    assert float(got) == float(loss.weighted_mse(
        pred, tbatch["target"], lat, loss.pressure_level_weights(69)))
    assert float(got) != float(loss.weighted_mse(pred, tbatch["target"],
                                                 lat))


@pytest.mark.parametrize("step_i", [0, 1, 5, 9, 10, 11, 40, 99, 100, 150])
def test_warmup_cosine_matches_reference(step_i):
    kw = dict(base_lr=1e-3, warmup_steps=10, total_steps=100, min_lr=1e-4)
    want = float(ref_sched.warmup_cosine(step_i, **kw))
    assert schedule.warmup_cosine(step_i, **kw) == pytest.approx(want,
                                                                 rel=1e-6)


def _adam_tree(rng, scale):
    return {"a": {"w": (scale * rng.normal(size=(6, 5))).astype(np.float32),
                  "b": (scale * rng.normal(size=(5,))).astype(np.float32)},
            "c": (scale * rng.normal(size=(7,))).astype(np.float32)}


@pytest.mark.parametrize("masters", [False, True])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])  # clip off / on
def test_adam_matches_reference(masters, grad_scale):
    rng = np.random.default_rng(4)
    params = _adam_tree(rng, 1.0)
    grads = [_adam_tree(rng, grad_scale) for _ in range(3)]
    cfg = adam.AdamConfig(master_weights=masters, weight_decay=0.01)
    rcfg = ref_adam.AdamConfig(master_weights=masters, weight_decay=0.01)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ref_adam.init(rp, rcfg)
    tp = ptree.map(torch.from_numpy, params)
    ts = adam.init(tp, cfg)
    if masters:  # f32 masters never alias the (f32) params
        for p, m in zip(ptree.leaves(tp), ptree.leaves(ts["master"])):
            assert m.data_ptr() != p.data_ptr() and torch.equal(m, p)
    for g in grads:
        lr = 1e-2
        rp, rs = ref_adam.update(rp, jax.tree.map(jnp.asarray, g), rs,
                                 jnp.float32(lr), rcfg)
        norm = adam.global_norm(ptree.map(torch.from_numpy, g))
        np.testing.assert_allclose(
            float(norm), float(ref_adam.global_norm(g)), rtol=2e-6)
        tp, ts = adam.update(tp, ptree.map(torch.from_numpy, g), ts, lr, cfg,
                             norm=norm)
    assert ts["step"] == int(rs["step"]) == 3
    def close(a, b, atol):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=atol)
    for key in ("mu", "nu") + (("master",) if masters else ()):
        ptree.map(lambda a, b: close(a, b, 1e-7), ts[key], rs[key])
    ptree.map(lambda a, b: close(a, b, 2e-7), tp, rp)


def test_clip_casts_back_to_grad_dtype():
    g = {"w": torch.full((4,), 3.0, dtype=torch.bfloat16)}
    clipped, norm = adam.clip_by_global_norm(g, 1.0)
    assert float(norm) == 6.0
    assert clipped["w"].dtype == torch.bfloat16
    assert torch.equal(clipped["w"],
                       (g["w"].float() / 6.0).to(torch.bfloat16))


# ---------------------------------------------------------------------------
# five-step histories against the reference's TrainEngine
# ---------------------------------------------------------------------------

def _histories(cfg, *, kernel="pallas", ref_kernel="xla", steps=5, batch=2,
               rollout=1, accum=1, precision=None):
    ecfg = dict(steps=steps, batch=batch, rollout=rollout, accum=accum,
                precision=precision, log_every=1, prefetch=0,
                telemetry=False, seed=0)
    params = _ref_init(cfg)
    reng = RTrainEngine("weathermixer-1b", reduced=False, kernel=ref_kernel,
                        config_override=cfg,
                        init_params=jax.tree.map(jnp.asarray, params),
                        config=REngineConfig(**ecfg))
    want = reng.run()
    eng = TrainEngine("weathermixer-1b", reduced=False, kernel=kernel,
                      config_override=_port_cfg(cfg), device="cpu",
                      init_params=params_from_numpy(params, device="cpu"),
                      config=EngineConfig(**ecfg))
    assert list(eng.r_sched) == list(reng.r_sched)
    return eng.run(), want


@pytest.mark.parametrize("kernel,accum,rollout,remat", [
    ("pallas", 1, 1, False), ("xla", 1, 1, False), ("pallas", 2, 1, True),
    ("pallas", 1, 2, True), ("pallas", 1, 2, False)])
def test_history_matches_reference(kernel, accum, rollout, remat):
    got, want = _histories(_tiny(remat=remat), kernel=kernel, accum=accum,
                           rollout=rollout, batch=2 * accum)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["step"] == w["step"]
        for k in HIST_KEYS:
            assert _rel(g[k], w[k]) <= 1e-4, (k, g, w)


def test_first_step_matches_reference_pallas_interpret():
    got, want = _histories(_tiny(remat=True), ref_kernel="pallas", steps=1)
    for k in HIST_KEYS:
        assert _rel(got[0][k], want[0][k]) <= 1e-4, (k, got, want)


def test_bf16_history_within_reference_bound():
    got, want = _histories(_tiny(remat=True), precision="bf16", rollout=2,
                           steps=3)
    for g, w in zip(got, want):
        assert _rel(g["lr"], w["lr"]) <= 1e-6
        for k in ("loss", "grad_norm"):
            assert _rel(g[k], w[k]) <= 5e-2, (k, g, w)


def test_remat_changes_no_bit_and_runs_repeat_bitwise():
    """Checkpointing recomputes the same kernels on the same inputs, and
    two runs of one seed give the same history, bit for bit."""
    pcfg = _port_cfg(_tiny())
    ecfg = EngineConfig(steps=3, batch=2, rollout=2, log_every=1,
                        prefetch=2, telemetry=False, precision="bf16")
    runs = [TrainEngine("weathermixer-1b", reduced=False, device="cpu",
                        kernel="pallas", config_override=pcfg.replace(
                            remat=remat), config=ecfg).run()
            for remat in (True, True, False)]
    assert runs[0] == [dict(r, wall_s=runs[0][i]["wall_s"])
                       for i, r in enumerate(runs[1])]
    for a, b in zip(runs[0], runs[2]):
        assert all(a[k] == b[k] for k in HIST_KEYS)


# ---------------------------------------------------------------------------
# launches per step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rollout,accum,remat", [(1, 1, True), (2, 1, True),
                                                 (1, 2, True), (2, 1, False)])
def test_kernel_calls_per_step(monkeypatch, rollout, accum, remat):
    """5 + 54 r GEMMs per microbatch with 3 blocks and remat: forward
    2 + 12 r, remat recompute 12 r, dw 2 + 12 r, dx 1 + 12 r (the
    encoder's input is data), GELU pre-activation recompute 6 r; without
    remat 5 + 42 r.  Counted on the CPU at the wrapper's call site."""
    calls = []
    real = ops.block_matmul

    def counting(*a, **kw):
        calls.append(kw.get("x_t", False))
        return real(*a, **kw)
    monkeypatch.setattr(ops, "block_matmul", counting)
    pcfg = _port_cfg(_tiny(n_layers=3, remat=remat))
    eng = TrainEngine("weathermixer-1b", reduced=False, device="cpu",
                      kernel="pallas", config_override=pcfg,
                      config=EngineConfig(steps=1, batch=2 * accum,
                                          accum=accum, rollout=rollout,
                                          precision="bf16",
                                          telemetry=False, prefetch=0))
    batch = eng.pipeline.get(0, rollout)
    eng.dispatch(batch, rollout)
    per = 5 + (54 if remat else 42) * rollout
    assert len(calls) == per * accum
    assert sum(calls) == (2 + 12 * rollout) * accum      # the dw launches


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def test_pipeline_batches_bit_equal_reference_and_modes_agree():
    cfg = _tiny()
    rp = ref_make_pipeline(cfg, batch_size=3, prefetch=0)
    sharded, full = (make_pipeline(_port_cfg(cfg), batch_size=3, mode=m,
                                   prefetch=0, device="cpu")
                     for m in ("sharded", "sync-full"))
    for s, h in ((0, 1), (4, 2), (7, 3)):
        want = rp.host_batch(s, h)
        for pipe in (sharded, full):
            got = pipe.get(s, h)
            for k in ("fields", "target"):
                assert np.array_equal(got[k].numpy(), want[k])


def test_pipeline_prefetch_and_cursor_round_trip():
    cfg = _port_cfg(_tiny())
    horizons = [1, 2, 1, 3, 2]
    pre = make_pipeline(cfg, batch_size=2, prefetch=2, device="cpu")
    sync = make_pipeline(cfg, batch_size=2, prefetch=0, device="cpu")
    a = list(pre.iterate(horizons))
    b = list(sync.iterate(horizons))
    assert pre.cursor == sync.cursor == 5 and pre._thread is None
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    resumed = make_pipeline(cfg, batch_size=2, prefetch=2, device="cpu")
    resumed.set_state(make_pipeline(cfg, batch_size=2, device="cpu").state()
                      | {"cursor": 3})
    assert resumed.state() == {"cursor": 3}
    rest = list(resumed.iterate(horizons[3:]))
    for x, y in zip(rest, a[3:]):
        assert all(torch.equal(x[k], y[k]) for k in x)
    # stop() cancels a worker the consumer walked away from
    it = pre.iterate(horizons)
    next(it)
    assert pre._thread is not None and pre.stop()
    assert pre._thread is None
    with pytest.raises(ValueError):
        InputPipeline(pre.source, mode="bogus", device="cpu")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def test_entry_points_raise_without_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainEngine("weathermixer-1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pipeline(_port_cfg(_tiny()), batch_size=1)


def test_cli_trains_on_cpu_and_writes_reference_keys(tmp_path):
    out = tmp_path / "m.jsonl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "3", "--batch", "2", "--rollout", "2", "--log-every",
         "1", "--eval-every", "2", "--kernel", "pallas", "--precision",
         "bf16", "--metrics-out", str(out)],
        capture_output=True, text=True, env=env, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    train_recs = [r for r in recs if not r.get("eval")]
    evals = [r for r in recs if r.get("eval")]
    assert [r["step"] for r in train_recs] == [0, 1, 2]
    assert set(train_recs[0]) == {"loss", "mse", "lr", "grad_norm", "step",
                                  "wall_s"}
    assert set(evals[0]) == {"val_loss", "val_mse", "step", "eval"}
    assert all(np.isfinite(r["loss"]) for r in train_recs)


def test_engine_writes_json_history_and_trace(tmp_path):
    """``metrics_format="json"`` writes the whole history once; ``trace``
    exports the spans (``data_wait`` / ``step`` / ``dispatch`` and the
    prefetch worker's ``pipeline.produce``) and the per-step records."""
    out, trace = tmp_path / "m.json", tmp_path / "t.json"
    eng = TrainEngine("weathermixer-1b", reduced=False, device="cpu",
                      config_override=_port_cfg(_tiny()),
                      config=EngineConfig(steps=2, batch=2, log_every=1,
                                          metrics_out=str(out),
                                          metrics_format="json",
                                          trace=str(trace)))
    hist = eng.run()
    assert json.loads(out.read_text()) == hist
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"data_wait", "step", "dispatch", "pipeline.produce"} <= names
    steps = [json.loads(line) for line in
             (tmp_path / "t.jsonl").read_text().splitlines()]
    assert [r["step"] for r in steps if "data_wait_s" in r] == [0, 1]
