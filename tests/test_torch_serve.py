"""The port's serving engine and launcher, on the CPU.

* The engine's scheduler contracts: zero new setups after ``warmup()``,
  lead fan-out, continuous batching in fewer steps than drain, mid-rollout
  admission equal to solo rollouts.
* The slice as a whole against the JAX package: the same weights (carried
  over by ``convert.py``) and the same requests through the reference's
  ``ForecastEngine`` and the port's give the same forecasts (fp32 1e-5).
* The port's copy of the scheduler makes the reference's decisions.
* Entry points run on CUDA unless the caller asks for the CPU.
"""
import numpy as np
import pytest

import jax
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.models import weathermixer as RW
from repro.serve.engine import ForecastEngine as RefEngine
from repro.serve.engine import ServeConfig as RefServeConfig
from repro.serve import scheduler as ref_scheduler
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.serve import scheduler
from repro_torch.serve.engine import ForecastEngine, ServeConfig


def _tiny_cfg(kernel="pallas"):
    return ref_get_config("weathermixer-1b").reduced().replace(
        wm_lat=16, wm_lon=32, wm_channels=4, d_model=64, wm_d_tok=64,
        wm_d_ch=64, kernel=kernel)


def tiny_engine(**kw):
    """The port's twin of tests/test_serve.py::tiny_engine, on the CPU,
    with the kernel path selected (its plain version runs on the CPU)."""
    from repro_torch.configs.registry import get_config
    ref = _tiny_cfg()
    cfg = get_config("weathermixer-1b").replace(
        **{k: getattr(ref, k) for k in ref.__dataclass_fields__})
    config = kw.pop("config", ServeConfig(buckets=(1, 2, 4)))
    return ForecastEngine("weathermixer-1b", reduced=False,
                          config_override=cfg, config=config, device="cpu",
                          **kw)


def _fields(n, eng, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, *eng.field_shape)).astype(np.float32)


def test_engine_zero_new_setups_after_warmup():
    eng = tiny_engine()
    warm = eng.warmup()               # one state buffer per bucket
    assert warm == 3
    fs = _fields(7, eng)
    rs = [eng.submit(fs[0], 3)]
    assert eng.step_once() == "step"  # bucket 1 in flight, then growth
    rs += [eng.submit(fs[i], (i % 3) + 1) for i in range(1, 7)]
    eng.drain()
    assert all(r.done() for r in rs)
    assert eng.stats["compiles"] == warm
    assert eng.sched.counters["formed"] >= 1
    assert eng.sched.counters["grown"] >= 1


def test_engine_midflight_admission_vs_solo():
    """Bitwise on the card (chip_smoke.py); here the plain version runs on
    the CPU's matmul, which need not be batch-invariant: 1e-5."""
    eng = tiny_engine()
    eng.warmup()
    fs = _fields(5, eng, seed=1)
    first = eng.submit(fs[0], 4)
    assert eng.step_once() == "step"
    late = [eng.submit(fs[i], i) for i in (1, 2, 3)]
    eng.drain()
    assert first.done() and all(r.done() for r in late)

    def solo(f, lead):                # one sample at a time, bucket 1
        state = torch.from_numpy(f)[None].clone()
        for _ in range(lead):
            state = eng._forecast(state)
        return state[0].numpy()

    np.testing.assert_allclose(first.result(), solo(fs[0], 4), rtol=0,
                               atol=1e-5)
    for i, r in zip((1, 2, 3), late):
        np.testing.assert_allclose(r.result(), solo(fs[i], i), rtol=0,
                                   atol=1e-5)


def test_engine_fanout_outputs_are_one_rollout():
    eng = tiny_engine()
    eng.warmup()
    r = eng.submit(_fields(1, eng)[0], (1, 2, 4))
    eng.drain()
    assert sorted(r.outputs) == [1, 2, 4]
    assert r.done() and r.latency() >= 0 and r.queue_delay() >= 0
    state = torch.from_numpy(r.fields)[None].clone()
    for lead in (1, 2, 3, 4):
        state = eng._forecast(state)
        if lead in r.outputs:
            assert np.array_equal(r.output(lead), state[0].numpy())
    # delivered outputs are copies, not views of the live state buffer
    assert not np.shares_memory(r.output(1), r.output(2))


def test_engine_continuous_beats_drain_in_steps():
    leads = [1, 4, 1, 4, 1, 4, 1, 4]
    steps = {}
    for mode in ("continuous", "drain"):
        eng = tiny_engine(config=ServeConfig(buckets=(1, 2, 4), mode=mode))
        eng.warmup()
        fs = _fields(len(leads), eng, seed=2)
        rs = [eng.submit(fs[i], leads[i]) for i in range(len(leads))]
        eng.drain()
        assert all(r.done() for r in rs)
        steps[mode] = eng.stats["device_steps"]
    assert steps["continuous"] < steps["drain"], steps


def test_engine_summary_and_validation():
    eng = tiny_engine()
    eng.warmup()
    rs = eng.serve(_fields(3, eng), [1, 2, 1])
    s = eng.summary(rs)
    assert s["requests"] == 3 and s["deliveries"] == 3
    assert s["p50_s"] >= 0 and s["compiles"] == 3
    with pytest.raises(ValueError):
        eng.submit(np.zeros((3, 3, 3), np.float32))
    with pytest.raises(ValueError):
        eng.submit(_fields(1, eng)[0], 0)


def test_engine_matches_reference_engine():
    """The slice end to end: same weights, same requests, same leads through
    the reference's ForecastEngine (xla) and the port's (kernel path)."""
    cfg = _tiny_cfg(kernel="xla")
    params = jax.tree.map(np.asarray, RW.init(jax.random.PRNGKey(7), cfg))
    rng = np.random.default_rng(8)
    params["blend"] = rng.normal(size=params["blend"].shape).astype(
        np.float32)
    ref = RefEngine("weathermixer-1b", reduced=False, config_override=cfg,
                    params=jax.tree.map(jax.numpy.asarray, params),
                    config=RefServeConfig(buckets=(1, 2, 4)))
    eng = tiny_engine(params=params_from_numpy(params, device="cpu"))
    fs = _fields(5, eng, seed=9)
    leads = [1, 3, 2, (1, 2), 1]
    want = ref.serve(fs, leads)
    got = eng.serve(fs, leads)
    for w, g in zip(want, got):
        assert sorted(w.outputs) == sorted(g.outputs)
        for lead in w.outputs:
            np.testing.assert_allclose(g.output(lead),
                                       np.asarray(w.output(lead)),
                                       rtol=1e-5, atol=1e-5)


def test_scheduler_copy_makes_reference_decisions():
    """Random arrivals through both schedulers: identical ticks/peels."""

    def run(mod, seed=11):
        rng = np.random.default_rng(seed)
        s = mod.MicrobatchScheduler((1, 2, 4), clock=lambda: 0.0)
        log = []
        for _ in range(40):
            for _ in range(rng.integers(0, 3)):
                leads = rng.integers(1, 5, size=rng.integers(1, 3))
                s.submit(mod.ForecastResult(
                    None, tuple(sorted(set(leads.tolist()))), submit_t=0.0))
            t = s.tick()
            log.append((t.form, t.grow, [i for i, _ in t.admit], t.step))
            if t.step:
                peels, fin = s.advance()
                log.append(([(i, ld) for i, _, ld in peels],
                            [i for i, _ in fin]))
        return log, s.counters

    assert run(scheduler) == run(ref_scheduler)


def test_engine_raises_without_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ForecastEngine("weathermixer-1b")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_serve.main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"blocks": {}})
    ForecastEngine("weathermixer-1b", device="cpu")


def test_launcher_serves_on_cpu(capsys):
    results, eng, wall = launch_serve.serve(
        "weathermixer-1b", requests=3, leads=(1, 2), buckets=(1, 2, 4),
        precision="bf16", device="cpu", config_override=_tiny_cfg())
    assert all(r.done() for r in results) and wall > 0
    assert all(np.isfinite(r.result()).all() for r in results)
    assert eng.stats["compiles"] == eng.stats["warm_compiles"]
    assert "req/s" in capsys.readouterr().out
