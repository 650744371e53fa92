"""The port's WeatherMixer forecast step against the JAX package's.

Weights come from the reference's own ``init`` and are carried over with
``repro_torch.convert``; fields are made from a numpy seed.  The reference
runs as its tests run it on the CPU: ``kernel="pallas"`` in interpret mode,
and ``kernel="xla"``.  Tolerances: legacy fp32 1e-5 (the two sides sum in
different orders), the ``bf16`` policy 3e-2 (as ``tests/test_kernels.py``:
a different summation order can flip the rounding of a bf16 value).
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest

import jax
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.configs import weathermixer_1b as ref_wm_cfg
from repro.core import precision as ref_precision
from repro.launch import shapes as ref_shapes
from repro.models import layers as ref_layers
from repro.models import weathermixer as RW
from repro_torch.configs import weathermixer_1b as wm_cfg
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import precision
from repro_torch.kernels import ops
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import layers
from repro_torch.models import weathermixer as W


def _tiny(**kw):
    """The tiny mixer of tests/test_serve.py (T = 32 tokens, d = 64)."""
    return ref_get_config("weathermixer-1b").reduced().replace(
        wm_lat=16, wm_lon=32, wm_channels=4, d_model=64, wm_d_tok=64,
        wm_d_ch=64, **kw)


def _port_cfg(ref_cfg):
    return get_config("weathermixer-1b").replace(
        **{f.name: getattr(ref_cfg, f.name)
           for f in dataclasses.fields(ref_cfg)})


def _fields(cfg, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, cfg.wm_lat, cfg.wm_lon,
                            cfg.wm_channels)).astype(np.float32)


def _ref_params(cfg, seed=0, perturb=True):
    """Reference weights as numpy, with biases, norms and blend moved off
    their init values so every term of the step is exercised."""
    p = jax.tree.map(np.asarray, RW.init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed + 100)

    def jitter(path, a):
        name = jax.tree_util.keystr(path)
        if perturb and ("'b'" in name or "'bias'" in name
                        or "'scale'" in name or "'blend'" in name):
            return (a.astype(np.float32)
                    + 0.1 * rng.normal(size=a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(jitter, p)


def _ref_step(params, fields, cfg, kernel):
    cfg = cfg.replace(kernel=kernel)
    return np.asarray(RW.forecast_step(
        jax.tree.map(jax.numpy.asarray, params), jax.numpy.asarray(fields),
        cfg, ref_shapes.jigsaw_for(cfg)))


def _port_step(params, fields, cfg, kernel="pallas"):
    pcfg = _port_cfg(cfg).replace(kernel=kernel)
    return W.forecast_step(params_from_numpy(params, device="cpu"),
                           torch.from_numpy(fields), pcfg,
                           jigsaw_for(pcfg)).numpy()


# ---------------------------------------------------------------------------
# configs and policies
# ---------------------------------------------------------------------------

def test_configs_match_reference():
    pairs = [(wm_cfg.CONFIG, ref_wm_cfg.CONFIG),
             (wm_cfg.CONFIG.reduced(), ref_wm_cfg.CONFIG.reduced())]
    pairs += [(wm_cfg.ZOO[i], ref_wm_cfg.ZOO[i]) for i in ref_wm_cfg.ZOO]
    for mine, theirs in pairs:
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_count() == theirs.param_count()
    assert wm_cfg.CONFIG.param_count() == 999_429_398


def test_registry_raises_for_unported_families():
    """Every family's config is served; what is still unported raises
    naming its ROADMAP item (training the ssm family), and an unknown id
    is a KeyError."""
    assert get_config("weathermixer-1b") == wm_cfg.CONFIG
    assert get_config("whisper-small").family == "audio"
    from repro_torch.train.step import check_trainable
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_trainable(get_config("mamba2-130m"))
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("preset", ["fp32", "bf16", "bf16_pure", None])
def test_precision_policies_match_reference(preset):
    cfg, rcfg = wm_cfg.CONFIG, ref_wm_cfg.CONFIG
    if preset:
        cfg = precision.apply_policy(cfg, preset)
        rcfg = ref_precision.apply_policy(rcfg, preset)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    mine, theirs = precision.policy_of(cfg), ref_precision.policy_of(rcfg)
    name = lambda d: None if d is None else np.dtype(d).name  # noqa: E731
    for f in ("param_dtype", "compute_dtype", "accum_dtype", "moment_dtype"):
        got = getattr(mine, f)
        assert (None if got is None else precision.name_of(got)) \
            == name(getattr(theirs, f)), f
    assert (mine.name, mine.master_weights) == \
        (theirs.name, theirs.master_weights)


# ---------------------------------------------------------------------------
# layout, norms, weights
# ---------------------------------------------------------------------------

def test_patchify_unpatchify_bit_equal():
    cfg = _tiny()
    x = _fields(cfg, n=3, seed=2)
    want = np.asarray(RW.patchify(jax.numpy.asarray(x), cfg.wm_patch))
    got = W.patchify(torch.from_numpy(x), cfg.wm_patch).numpy()
    assert np.array_equal(got, want)
    back = W.unpatchify(torch.from_numpy(got), cfg.wm_lat, cfg.wm_lon,
                        cfg.wm_patch, cfg.wm_channels).numpy()
    assert np.array_equal(back, x)
    assert np.array_equal(back, np.asarray(RW.unpatchify(
        jax.numpy.asarray(want), cfg.wm_lat, cfg.wm_lon, cfg.wm_patch,
        cfg.wm_channels)))


def test_layernorm_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    want = np.asarray(ref_layers.layernorm_apply(
        jax.tree.map(jax.numpy.asarray, p), jax.numpy.asarray(x)))
    got = layers.layernorm_apply({k: torch.from_numpy(v)
                                  for k, v in p.items()},
                                 torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_converter_round_trip_bit_equal(param_dtype):
    cfg = _tiny(param_dtype=param_dtype)
    theirs = _ref_params(cfg)
    mine = params_from_numpy(theirs, device="cpu")
    assert len(mine["blocks"]) == cfg.n_layers
    assert mine["blocks"][0]["tok_fc1"]["w"].dtype == getattr(torch,
                                                              param_dtype)
    back = params_to_numpy(mine, bf16_dtype=ml_dtypes.bfloat16)

    def same(a, b):
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a.view(np.uint8), b.view(np.uint8)))

    assert all(jax.tree.leaves(jax.tree.map(same, theirs, back)))
    # without a bf16 dtype the bits come back as uint16
    raw = params_to_numpy(mine)["encoder"]["w"]
    assert raw.dtype == (np.uint16 if param_dtype == "bfloat16"
                         else np.float32)


def test_init_matches_reference_structure():
    cfg = _tiny(param_dtype="bfloat16")
    mine = W.init(_port_cfg(cfg), seed=0, device="cpu")
    theirs = params_from_numpy(jax.tree.map(
        np.asarray, RW.init(jax.random.PRNGKey(0), cfg)), device="cpu")
    flat = lambda p: {  # noqa: E731
        k: (tuple(v.shape), v.dtype) for k, v in
        jax.tree_util.tree_flatten_with_path(p)[0]}
    assert flat(mine) == flat(theirs)
    for bp in mine["blocks"]:
        assert torch.all(bp["tok_fc1"]["b"] == 0)
        assert torch.all(bp["ch_norm"]["scale"] == 1)
        w = bp["tok_fc1"]["w"].float()
        d_in = w.shape[1]
        assert abs(w.std().item() * np.sqrt(d_in) - 1) < 0.1
    assert torch.all(mine["blend"] == 0)


def test_init_raises_without_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        W.init(_port_cfg(_tiny()), seed=0)
    W.init(_port_cfg(_tiny()), seed=0, device="cpu")


# ---------------------------------------------------------------------------
# the forecast step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref_kernel", ["pallas", "xla"])
def test_forecast_step_legacy_fp32(ref_kernel):
    cfg = _tiny()
    params, x = _ref_params(cfg), _fields(cfg)
    want = _ref_step(params, x, cfg, ref_kernel)
    got = _port_step(params, x, cfg)
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_port_step(params, x, cfg, "xla"), want,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ref_kernel", ["pallas", "xla"])
def test_forecast_step_bf16_policy(ref_kernel):
    """The bf16 policy's step against the reference's, held to twice the
    reference's own distance from the exact step.

    Port and reference run the same step with the same bf16 cast points
    (bf16 weights; each GEMM's f32 sum, bias and activation rounded once
    to bf16; the blend in f32).  They differ only in the summation order
    inside each GEMM, which moves a rounded activation by one bf16 ulp
    where its f32 sum lies next to a rounding boundary.  So each lies as
    far from the exact step e (the same bf16 weights and fields with no
    bf16 rounding: the reference under the fp32 policy) as the step's
    roundings put it, |got - e| ~ |want - e|, and by the triangle
    inequality max|got - want| <= 2 max|want - e|.  Here the activations
    reach 7.1, where one bf16 ulp is 2^-5: max|want - e| is 0.025 (xla)
    and 0.018 (pallas), max|got - want| 0.030 and 0.017, max|got - e|
    0.018.  The fixed bound this replaces (3e-2 + 3e-2 |want|, the
    repository's bf16 GEMM tolerance) sat near one such ulp times the
    blend's 1 - lambda ~ 0.5 plus one upstream flip, and was reached to
    0.835."""
    cfg = ref_precision.apply_policy(_tiny(), "bf16")
    params, x = _ref_params(cfg, seed=1), _fields(cfg, seed=1)
    want = _ref_step(params, x, cfg, ref_kernel)
    exact = _ref_step(params, x, ref_precision.apply_policy(_tiny(), "fp32"),
                      "xla")
    got = _port_step(params, x, cfg)
    assert got.dtype == np.float32
    rounding = float(np.abs(want - exact).max())
    assert 0 < rounding < 0.1
    assert float(np.abs(got - want).max()) <= 2 * rounding


def test_forecast_step_legacy_bf16_weights_f32_activations():
    """The full config's own dtypes: bf16 params, no compute dtype, so the
    GEMMs run in f32 with the weights cast up (ops.matmul)."""
    cfg = _tiny(param_dtype="bfloat16", compute_dtype="bfloat16")
    params, x = _ref_params(cfg, seed=2), _fields(cfg, seed=2)
    want = _ref_step(params, x, cfg, "xla")
    np.testing.assert_allclose(_port_step(params, x, cfg), want, rtol=1e-5,
                               atol=1e-5)


def test_rollout_three_steps():
    cfg = _tiny()
    params, x = _ref_params(cfg, seed=3), _fields(cfg, n=1, seed=3)
    rcfg = cfg.replace(kernel="xla")
    want, _ = RW.apply(jax.tree.map(jax.numpy.asarray, params),
                       {"fields": jax.numpy.asarray(x)}, rcfg,
                       ref_shapes.jigsaw_for(rcfg), rollout=3)
    pcfg = _port_cfg(cfg).replace(kernel="pallas")
    got, aux = W.apply(params_from_numpy(params, device="cpu"),
                       {"fields": torch.from_numpy(x)}, pcfg,
                       jigsaw_for(pcfg), rollout=3)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_forecast_step_routes_every_gemm_through_the_kernel(monkeypatch):
    """2 + 4 * n_layers block_matmul calls per step: encoder, four per
    block, decoder (14 at the full config's 3 blocks)."""
    calls = []
    real = ops.block_matmul

    def counting(x, w, b=None, epilogue="none"):
        calls.append((tuple(x.shape), tuple(w.shape), epilogue))
        return real(x, w, b, epilogue)

    monkeypatch.setattr(ops, "block_matmul", counting)
    cfg = _tiny()
    _port_step(_ref_params(cfg), _fields(cfg), cfg)
    assert len(calls) == 2 + 4 * cfg.n_layers
    t, d = W.n_tokens(cfg), cfg.d_model
    assert calls[1] == ((2 * d, t), (cfg.wm_d_tok, t), "gelu")   # tok_fc1
    assert calls[3] == ((2 * t, d), (cfg.wm_d_ch, d), "gelu")    # ch_fc1
