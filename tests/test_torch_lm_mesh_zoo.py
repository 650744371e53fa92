"""The moe, ssm, hybrid and audio language models on a 1-D Jigsaw model mesh
in the port, against the JAX package's 1-D mesh (its ``param_specs``
layout, with GSPMD placing every collective between the linears): the
MoE's experts cut over the ranks (expert parallelism), Mamba-2's heads on
the ranks, whisper's encoder and cross attention on the rank's heads.

The reference's weights (``repro.models.registry.init`` of the reduced
configs: d_model 256, 2 layers, vocab 1,024; phi3.5 and dbrx 4 experts
top-2, mamba2-130m 8 SSM heads of 64 in one group, jamba one period of an
SSM slot (8 heads in 8 groups) and an attention slot with the MoE,
whisper 2 + 2 layers over 64 frames) are carried to the port through
numpy, and the batches come from a numpy seed or the token batch source
both packages share.  The reference runs on four host-emulated devices in
one subprocess (this file run as a script with ``--reference``): its
forwards under ``jax.set_mesh`` of a (data 1, model p) mesh, and its
``TrainEngine(mesh_model=..., scheme="1d", impl=...)`` and CLI entry point
``repro.launch.train.train``.  The reference's Mamba-2 gradient is NaN at
the models' decays (its ``_ssd_chunked`` masks after the exponential), so
that subprocess swaps in ``SAFE_SSD``, a copy built from the reference's
own source with the mask before the exponential (its forward asserted bit
for bit against the original's there), as ``tests/test_torch_ssm_train.py``
does; nothing of the reference's files is edited.  The port's ranks are
gloo processes, this file run as a script with ``--rank`` (one launched
group per mesh: (data 1, model 2), (data 1, model 4) and (data 2, model
2)), or the training CLI under ``torch.distributed.run``.  On the CPU
``ring_fused`` runs its kernels' plain versions and the features'
all-gathers and reduce-scatters are the library's.

Tolerances:
  * the forward's logits, gathered over the vocab on every rank, against
    the reference's 1-D forward and the port's one-device forward: 1e-5
    relative and absolute for the moe and audio families (as the dense
    ones, ``tests/test_torch_lm_mesh.py``), and for the ssm and hybrid
    families their own one-device bound against the reference, 1e-4
    (``tests/test_torch_mamba.py``, ``tests/test_torch_hybrid.py``
    LOGIT_TOL; measured 2.4e-5 at p = 2 and 6.2e-5 at p = 4: the SSD's
    decays amplify the reordered sums of the cut linears and norms); the
    MoE's routes (``gate_idx``, ``keep``) equal the one-device run's;
  * one train step against the port's one-device step (with two data
    ranks, the one-device step with ``accum=2``: the MoE groups a data
    rank's tokens, as the data-only mesh does): the loss and grad norm
    1e-4 relative, the updated parameters rtol 1e-3 / atol 1e-4 under
    ``make_train_step``'s default schedule, every gradient leaf within
    1e-5 of the leaf's largest magnitude (the ssm and hybrid families'
    SSD bound, 2e-4, ``tests/test_torch_ssm_train.py``; measured 1.3e-5 at
    A_log) plus 1e-8, the f32 noise of a gradient that is zero in exact
    arithmetic (whisper's k bias: a shift of every key by the bias moves
    each query's scores by a constant, which the softmax ignores; ~1e-10
    measured); the leaves every rank holds whole the same bits on every
    rank after the update;
  * the aux loss counted once: phi3.5's router gradient with the NLL
    masked out (aux alone) against the one-device step's, 1e-5 of its max
    (p times that without the fix);
  * five-step ``TrainEngine`` and CLI histories (loss, grad norm, lr):
    1e-4 relative to the reference's, as the one-device histories.
"""
import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import repro.models.layers as RL
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
from repro_torch.core.sharding import RULES_1D, Mesh1D
from repro_torch.launch import specs
from repro_torch.launch.engine import EngineConfig, TrainEngine
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import layers as L
from repro_torch.models import registry as M
from repro_torch.models.transformer import param_spec_1d as LM_SPEC
from repro_torch.optim import adam
from repro_torch.train import step

ROOT = Path(__file__).resolve().parents[1]
HIST_KEYS = ("loss", "grad_norm", "lr")
MOE, SSM, HYBRID, AUDIO = ("phi3.5-moe-42b-a6.6b", "mamba2-130m",
                           "jamba-1.5-large-398b", "whisper-small")
# (data, model) of each launched mesh
MESHES = {"m2": (1, 2), "m4": (1, 4), "d2m2": (2, 2)}
# the forwards: (arch, model ranks); phi3.5 at p = 4 holds one expert a
# rank, mamba2-130m's conv channels fall across head bounds at both, jamba
# holds 4 of its 8 groups a rank, whisper at p = 4 gathers its 2 kv heads
FORWARDS = [(MOE, 2), (MOE, 4), (SSM, 2), (SSM, 4), (HYBRID, 2),
            (AUDIO, 2), (AUDIO, 4)]
FWD_BATCH, FWD_SEQ = 2, 72
# one train step: each family at (data 1, model 2), phi3.5 and mamba2-130m
# also at (data 2, model 2)
STEPS = {"m2": (MOE, SSM, HYBRID, AUDIO), "m4": (), "d2m2": (MOE, SSM)}
STEP_BATCH, STEP_SEQ = 8, 16
# five-step histories: (mesh, run name, arch, impl, zero1)
HISTORIES = [("m2", "moe_ring_fused", MOE, "ring_fused", False),
             ("m2", "ssm_rs", SSM, "rs", False),
             ("d2m2", "ssm_rs_zero1", SSM, "rs", True)]
COMMON = dict(steps=5, batch=4, seq_len=32, log_every=1, prefetch=0,
              seed=0)
ARCHS = (MOE, SSM, HYBRID, AUDIO)
SPEC_ARCHS = (MOE, "dbrx-132b", SSM, HYBRID, AUDIO)
SSD_FAMILIES = ("ssm", "hybrid")
LEAF_TOL = {"ssm": 2e-4, "hybrid": 2e-4}     # else 1e-5
ZERO_GRAD_FLOOR = 1e-8
# leaves every rank holds whole
WHOLE = ("scale", "bias", "A_log", "D", "dt_bias", "conv_b")

UNSAFE = "L = jnp.where(li[None, None, :, :, None], jnp.exp(seg), 0.0)"
SAFE = "L = jnp.exp(jnp.where(li[None, None, :, :, None], seg, -jnp.inf))"


def _safe_ssd_chunked():
    """The reference's ``_ssd_chunked`` with its one masking line put
    before the exponential, compiled from its own source in a copy of its
    module's namespace (the module itself is untouched)."""
    src = textwrap.dedent(inspect.getsource(RL._ssd_chunked))
    assert src.count(UNSAFE) == 1, "the reference's mask line changed"
    ns = dict(vars(RL))
    exec(compile(src.replace(UNSAFE, SAFE), "<safe _ssd_chunked>", "exec"),
         ns)
    return ns["_ssd_chunked"]


def _install_safe_ssd():
    """``SAFE_SSD`` in place of ``repro.models.layers._ssd_chunked`` (which
    ``mamba2_apply`` reads), after checking its forward bit for bit
    against the original's at mamba2-130m's decays (A to -16, chunk 64)."""
    safe, orig = _safe_ssd_chunked(), RL._ssd_chunked
    rng = np.random.default_rng(3)
    b, s, h, p, g, n = 1, 128, 4, 8, 1, 8
    ins = (rng.normal(size=(b, s, h, p)),
           np.logaddexp(rng.normal(size=(b, s, h)), 0.0),
           -np.linspace(1.0, 16.0, h), 0.3 * rng.normal(size=(b, s, g, n)),
           0.3 * rng.normal(size=(b, s, g, n)))
    ins = [jnp.asarray(a, jnp.float32) for a in ins]
    for a, c in zip(jax.jit(lambda *t: orig(*t, 64))(*ins),
                    jax.jit(lambda *t: safe(*t, 64))(*ins)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
    RL._ssd_chunked = safe


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))


def _port_cfg(arch, **kw):
    return get_config(arch).reduced().replace(**kw)


def _ref_weights(arch):
    return jax.tree.map(np.asarray, RM.init(jax.random.PRNGKey(0),
                                            ref_get_config(arch).reduced()))


def _flat(tree):
    out = {}
    ptree.map_with_path(
        lambda path, a: out.__setitem__("/".join(map(str, path)), a), tree)
    return out


def _batch(arch, b, s, seed, labels=False):
    cfg = _port_cfg(arch)
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab_size,
                                     (b, s)).astype(np.int32)
    if cfg.family == "audio":
        out["frames"] = rng.normal(
            size=(b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _fwd_batch(arch):
    return _batch(arch, FWD_BATCH, FWD_SEQ, 7)


def _step_batch(arch):
    return _batch(arch, STEP_BATCH, STEP_SEQ, 11, labels=True)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _block(mesh, batch):
    """A rank's block of a batch: its data rank's rows, and of whisper's
    frames its block of D."""
    out = {k: mesh.block(v, (("data",), None)) for k, v in batch.items()
           if k != "frames"}
    if "frames" in batch:
        out["frames"] = mesh.block(batch["frames"],
                                   (("data",), None, "model"))
    return out


class _Routes:
    """Every ``moe_route`` call's gate_idx, keep and probs, recorded while
    the context is open (``moe_apply`` calls it through the module)."""

    def __init__(self):
        self.rec = []

    def __enter__(self):
        self.real = L.moe_route

        def recording(*args, **kw):
            out = self.real(*args, **kw)
            self.rec.append((out[2], out[4], out[0]))
            return out
        L.moe_route = recording
        return self

    def __exit__(self, *exc):
        L.moe_route = self.real


# ---------------------------------------------------------------------------
# the reference (one subprocess) and the port's ranks (gloo processes)
# ---------------------------------------------------------------------------

def _reference_main(path, wdir):
    """The reference on its 1-D meshes, under ``SAFE_SSD``: each forward
    under ``jax.set_mesh``, the five-step TrainEngine runs of
    ``HISTORIES``, and the CLI's ``train`` of mamba2-130m at (data 1,
    model 2) with its defaults (impl rs)."""
    from repro.launch.engine import EngineConfig as REngineConfig
    from repro.launch.engine import TrainEngine as RTrainEngine
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train import train as ref_train
    _install_safe_ssd()
    out = {}
    for arch, p in FORWARDS:
        cfg = ref_get_config(arch).reduced().replace(scheme="1d", impl="rs")
        params = jax.tree.map(jnp.asarray, _ref_weights(arch))
        batch = {k: jnp.asarray(v) for k, v in _fwd_batch(arch).items()}
        with jax.set_mesh(make_host_mesh(model=p, data=1)):
            y, _ = jax.jit(lambda pr, b: RM.apply(
                pr, b, cfg, RSH.jigsaw_for(cfg)))(params, batch)
        out[f"fwd/{arch}/p{p}"] = np.asarray(y)

    def init(arch):
        return jax.tree.map(jnp.asarray, _ref_weights(arch))

    for key, name, arch, impl, zero1 in HISTORIES:
        data, p = MESHES[key]
        eng = RTrainEngine(arch, reduced=True, mesh_model=p,
                           mesh_data=data, scheme="1d", impl=impl,
                           kernel="xla", init_params=init(arch),
                           config=REngineConfig(zero1=zero1, **COMMON))
        hist = eng.run()
        for k in HIST_KEYS:
            out[f"{name}/{k}"] = [h[k] for h in hist]
    hist, _ = ref_train(SSM, mesh_model=2, scheme="1d",
                        init_params=init(SSM), **COMMON)
    for k in HIST_KEYS:
        out[f"cli/{k}"] = [h[k] for h in hist]
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


def _rank_main(rank, key, init, wdir):
    """One rank of the port's mesh ``key``: the forwards of its model
    extent (the logits gathered over the vocab; the MoE's routes), one
    train step of each arch of ``STEPS[key]`` on its shards and its data
    rank's rows (the gradients too; phi3.5's with the NLL masked out on
    (data 1, model 2)), and the five-step TrainEngine runs of
    ``HISTORIES`` on its mesh (then a save, and the params it holds);
    saved to <key>_rank<r>.npz."""
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

    def whole(arch):
        return params_from_npz(wdir / f"{arch}.npz", device="cpu")

    for arch, fp in FORWARDS:
        if fp != p or data != 1:
            continue
        cfg = _port_cfg(arch, scheme="1d", impl="ring_fused")
        with torch.no_grad(), _Routes() as routes:
            y, aux = M.apply(shard_params_1d(whole(arch), mesh.r, p,
                                             spec=LM_SPEC),
                             _block(mesh, _torch_batch(_fwd_batch(arch))),
                             cfg, jigsaw_for(cfg).replace(mesh=mesh))
        res[f"fwd/{arch}"] = torch.cat(
            comm.all_gather_list(y.contiguous(), mesh.tp_group), -1).numpy()
        res[f"fwd/{arch}/aux"] = aux.numpy()
        for i, (idx, keep, _) in enumerate(routes.rec):
            res[f"fwd/{arch}/gate_idx{i}"] = idx.numpy()
            res[f"fwd/{arch}/keep{i}"] = keep.numpy()

    for arch in STEPS[key]:
        cfg = _port_cfg(arch, scheme="1d")
        jcfg = jigsaw_for(cfg).replace(mesh=mesh)
        batch = _block(mesh, _torch_batch(_step_batch(arch)))
        params = shard_params_1d(whole(arch), mesh.r, p, spec=LM_SPEC)
        if arch == MOE and key == "m2":
            masked = dict(batch, mask=torch.zeros_like(batch["labels"]))
            _, grads = step.value_and_grad(params, masked, cfg, jcfg)
            for i, lp in enumerate(grads["layers"]):
                res[f"aux_only/router{i}"] = lp["moe"]["router"]["w"].numpy()
        _, grads = step.value_and_grad(params, batch, cfg, jcfg)
        params, _, metrics = step.make_train_step(cfg, jcfg)(
            params, adam.init(params, adam.AdamConfig()), batch)
        for k in ("loss", "grad_norm"):
            res[f"step/{arch}/{k}"] = metrics[k].numpy()
        for k, v in _flat(params).items():
            res[f"step/{arch}/params/{k}"] = v.numpy()
        for k, v in _flat(grads).items():
            res[f"step/{arch}/grads/{k}"] = v.numpy()

    for hkey, name, arch, impl, zero1 in HISTORIES:
        if hkey != key:
            continue
        eng = TrainEngine(arch, reduced=True, mesh_model=p, mesh_data=data,
                          impl=impl, device="cpu", init_params=whole(arch),
                          config=EngineConfig(zero1=zero1, telemetry=False,
                                              **COMMON))
        hist = eng.run()
        for k in HIST_KEYS:
            res[f"{name}/{k}"] = np.array([h[k] for h in hist])
        res[f"{name}/jcfg"] = np.array([eng.cfg.scheme, eng.jcfg.impl])
        eng.save(str(wdir / f"ck_{key}_{name}"))
        eng.wait_checkpoints()
        for k, v in _flat(eng.params).items():
            res[f"{name}/params/{k}"] = v.numpy()
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
    tmp = tmp_path_factory.mktemp("lm_mesh_zoo")
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

@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_param_specs_match_reference(arch):
    """``param_specs`` of the reduced tree (the reference's stacked layers
    or periods) is the reference's 1-D ``param_specs`` entry for entry:
    the router, the norms, ``A_log``, ``D``, ``dt_bias`` and ``conv_b``
    whole, the expert stacks on their expert dim, ``conv_w`` and
    ``dec_pos`` on their last dim; the shards cut by it gather back bit
    for bit at p = 2 and 4 (jamba's 8 groups at 2), each at the bounds
    ``param_bounds`` gives."""
    rcfg = ref_get_config(arch).reduced()
    shapes = jax.eval_shape(lambda: RM.init(jax.random.PRNGKey(0), rcfg))
    want = ref_specs.param_specs(shapes, rcfg, REF_RULES_1D, None)
    whole = _ref_weights(arch)
    got = _flat(specs.param_specs(whole, _port_cfg(arch), RULES_1D))
    flat_want = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    assert len(flat_want) == len(got)
    for kp, spec in flat_want:
        key = "/".join(k.key for k in kp)
        assert got[key] == tuple(spec), key
    for p in (2, 4):
        shards = [shard_params_1d(whole, r, p, spec=LM_SPEC)
                  for r in range(p)]
        back = gather_params_1d(shards, p, spec=LM_SPEC)
        for (k, a), b in zip(_flat(back).items(), _flat(whole).values()):
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        for r, shard in enumerate(shards):
            mesh = Mesh1D(p=p, r=r)
            for k, a in _flat(shard).items():
                bounds = param_bounds(tuple(k.split("/")),
                                      _flat(whole)[k].shape, mesh,
                                      spec=LM_SPEC)
                cut = _flat(whole)[k][tuple(slice(*b) for b in bounds)]
                assert np.array_equal(a, cut), (k, p, r)


@pytest.mark.parametrize("arch", [MOE, SSM])
def test_cost_model_on_a_model_mesh_matches_reference(arch):
    """``build_cost_model`` of phi3.5 and mamba2-130m at n_model 2 (and
    with two data ranks) equals the reference's field for field,
    ``approx_comm`` among them, given the reference's TPU constants."""
    from repro.launch import analysis as RA
    for n_data in (1, 2):
        got = telemetry.build_cost_model(
            get_config(arch).replace(scheme="1d"), n_model=2, n_data=n_data,
            batch=2, seq_len=1024, peak=RA.PEAK_FLOPS_BF16,
            link=RA.ICI_BW).as_meta()
        got["ici_bw"] = got.pop("link_bw")     # the reference's name
        want = RACC.build_cost_model(
            ref_get_config(arch).replace(scheme="1d"), n_model=2,
            n_data=n_data, batch=2, seq_len=1024).as_meta()
        assert got == want, (arch, n_data)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def _one_device_forward(arch):
    cfg = _port_cfg(arch)
    with torch.no_grad(), _Routes() as routes:
        y, aux = M.apply(params_from_numpy(_ref_weights(arch), device="cpu"),
                         _torch_batch(_fwd_batch(arch)), cfg,
                         jigsaw_for(cfg))
    return y.numpy(), float(aux), routes.rec


@pytest.mark.parametrize("arch,p", FORWARDS)
def test_forward_matches_reference_and_one_device(launched, reference, arch,
                                                  p):
    """The logits of p ranks, gathered over the vocab on every rank,
    against the reference's 1-D forward on its (data 1, model p) mesh and
    the port's one-device forward; the MoE's aux and its routes (each
    layer's gate_idx and keep) those of the one-device run, a differing
    route reported with its probability margin."""
    tol = 1e-4 if _port_cfg(arch).family in SSD_FAMILIES else 1e-5
    none, aux, routes = _one_device_forward(arch)
    want = reference[f"fwd/{arch}/p{p}"]
    np.testing.assert_allclose(none, want, rtol=tol, atol=tol)
    for res in launched.rank_results("m2" if p == 2 else "m4"):
        got = res[f"fwd/{arch}"]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        np.testing.assert_allclose(got, none, rtol=tol, atol=tol)
        assert _rel(res[f"fwd/{arch}/aux"], aux) <= 1e-5
        for i, (idx, keep, probs) in enumerate(routes):
            gi = res[f"fwd/{arch}/gate_idx{i}"]
            diff = np.argwhere(gi != idx.numpy())
            margins = [float(abs(probs[g, t, gi[g, t, k]]
                                 - probs[g, t, idx[g, t, k]]))
                       for g, t, k in diff]
            assert not len(diff), (f"layer {i}: {len(diff)} routes differ, "
                                   f"probability margins {margins}")
            assert np.array_equal(res[f"fwd/{arch}/keep{i}"], keep.numpy())


# ---------------------------------------------------------------------------
# one train step, the aux control, five-step histories, the CLI
# ---------------------------------------------------------------------------

def _one_device_step(arch, data, mask=False):
    """The port's one-device step of ``arch`` on the step batch, with
    ``accum=data`` (each data rank's rows one microbatch): (gradients,
    updated params, metrics); ``mask`` zeroes the NLL's mask."""
    cfg = _port_cfg(arch)
    whole = params_from_numpy(_ref_weights(arch), device="cpu")
    batch = _torch_batch(_step_batch(arch))
    if mask:
        batch["mask"] = torch.zeros_like(batch["labels"])
        return step.value_and_grad(whole, batch, cfg, jigsaw_for(cfg))[1]
    mb = STEP_BATCH // data
    grads = None
    for i in range(data):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        _, g = step.value_and_grad(whole, micro, cfg, jigsaw_for(cfg))
        grads = g if grads is None else ptree.map(torch.add, grads, g)
    grads = ptree.map(lambda g: g / data, grads)
    params, _, metrics = step.make_train_step(cfg, jigsaw_for(cfg),
                                              accum=data)(
        whole, adam.init(whole, adam.AdamConfig()), batch)
    return grads, params, metrics


@pytest.mark.parametrize("key,arch", [(k, a) for k in MESHES
                                      for a in STEPS[k]])
def test_train_step_matches_one_device(launched, key, arch):
    """One step on the mesh's shards against the port's one-device step
    on the whole parameters: loss and grad norm, every gradient leaf and
    every updated leaf; the leaves every rank holds whole (the router, the
    norms, A_log, D, dt_bias, conv_b) the same bits on every rank."""
    ranks = launched.rank_results(key)
    data, p = MESHES[key]
    grads, want_p, want_m = _one_device_step(arch, data)
    tol = LEAF_TOL.get(_port_cfg(arch).family, 1e-5)
    for res in ranks:
        for k in ("loss", "grad_norm"):
            assert _rel(res[f"step/{arch}/{k}"], float(want_m[k])) <= 1e-4
    for rank, res in enumerate(ranks):
        r = rank % p
        for path, g in _flat(shard_params_1d(grads, r, p,
                                             spec=LM_SPEC)).items():
            got = res[f"step/{arch}/grads/{path}"]
            err = np.abs(got - g.numpy()).max()
            assert err <= tol * np.abs(g.numpy()).max() + ZERO_GRAD_FLOOR, \
                (path, err)
        for path, w in _flat(shard_params_1d(want_p, r, p,
                                             spec=LM_SPEC)).items():
            got = res[f"step/{arch}/params/{path}"]
            np.testing.assert_allclose(got, w.numpy(), rtol=1e-3, atol=1e-4,
                                       err_msg=path)
            parts = path.split("/")
            if parts[-1] in WHOLE or parts[-2:-1] == ["router"]:
                for peer in ranks:
                    assert np.array_equal(
                        peer[f"step/{arch}/params/{path}"], got), path


def test_aux_gradient_counted_once(launched):
    """phi3.5's router gradient with the NLL masked out (the objective is
    the aux loss alone) on (data 1, model 2) against the one-device
    step's: every rank computes the same whole aux from the same router,
    and the objective takes it over the model extent, so the gradient
    summed over the ranks counts it once (p times without that)."""
    want = _one_device_step(MOE, 1, mask=True)
    for res in launched.rank_results("m2"):
        for i, lp in enumerate(want["layers"]):
            g = lp["moe"]["router"]["w"].numpy()
            assert np.abs(g).max() > 0
            err = np.abs(res[f"aux_only/router{i}"] - g).max()
            assert err <= 1e-5 * np.abs(g).max(), (i, err)


@pytest.mark.parametrize("key,run", [(k, n) for k, n, *_ in HISTORIES])
def test_history_matches_reference(launched, reference, key, run):
    """Five TrainEngine steps on the mesh against the reference's
    TrainEngine on its mesh, the same weights, seed and impl (and ZeRO-1):
    loss, grad norm and lr within 1e-4 relative, the same on every rank;
    the engine's scheme is 1-D; a save on the model mesh after the five
    steps, restored whole on one device, is ``gather_params_1d`` of the
    ranks' params bit for bit (``tests/test_torch_lm_mesh_ckpt.py`` holds
    the resumes)."""
    from repro_torch.checkpoint import restore_tree
    ranks = launched.rank_results(key)
    impl = next(i for k, n, _, i, _ in HISTORIES if n == run)
    for res in ranks:
        for k in HIST_KEYS:
            assert _rel(res[f"{run}/{k}"], reference[f"{run}/{k}"]) <= 1e-4
            assert np.array_equal(res[f"{run}/{k}"], ranks[0][f"{run}/{k}"])
        assert res[f"{run}/jcfg"].tolist() == ["1d", impl]
    data, p = MESHES[key]
    whole = restore_tree(str(launched.tmp / f"ck_{key}_{run}"), "params")
    pre = f"{run}/params/"
    shards = [ptree.map_with_path(
        lambda path, _, r=r: torch.from_numpy(
            r[pre + "/".join(map(str, path))]), whole) for r in ranks]
    want = _flat(gather_params_1d(shards, p, data, spec=LM_SPEC))
    got = _flat(whole)
    assert got.keys() == want.keys() and len(got) > 10
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


def test_cli_two_ranks_matches_reference(launched, reference):
    """``launch/train.py --arch mamba2-130m --mesh-model 2 --device cpu``
    on two gloo ranks (the scheme 1-D, the config's impl rs), from the
    reference's weights: five steps of loss, grad norm and lr within 1e-4
    of the reference CLI's ``train`` on its (data 1, model 2) mesh (under
    ``SAFE_SSD``); rank 0 alone writes them."""
    tmp = launched.tmp
    out = tmp / "cli.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", SSM, "--mesh-model", "2", "--device", "cpu",
         "--steps", "5", "--batch", "4", "--seq-len", "32", "--log-every",
         "1", "--prefetch", "0", "--init-params", str(tmp / f"{SSM}.npz"),
         "--metrics-out", str(out)],
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
# what still raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_cut_and_2d_mesh_raise(arch):
    """The FSDP hybrid's cut over two data ranks, and a 2-D model mesh,
    raise NotImplementedError naming item 19 before any process group is
    joined."""
    cfg = get_config(arch).replace(shard_params_over_data=True)
    with pytest.raises(NotImplementedError, match="item 19"):
        TrainEngine(arch, device="cpu", mesh_model=2, mesh_data=2,
                    config_override=cfg,
                    config=EngineConfig(steps=1, batch=2))
    with pytest.raises(NotImplementedError, match="item 19"):
        TrainEngine(arch, device="cpu", mesh_model=4, scheme="2d",
                    config=EngineConfig(steps=1, batch=2))


@pytest.mark.parametrize("arch,field,value", [
    (MOE, "n_experts", 6), ("dbrx-132b", "n_experts", 6),
    (SSM, "ssm_heads", 6), (HYBRID, "ssm_groups", 6)])
def test_indivisible_dims_raise(arch, field, value):
    """A model extent that does not divide the experts, the Mamba-2 heads
    or their groups (above 1) raises ValueError naming the dim; the
    reduced configs pass at p = 2 and 4 (jamba's 8 groups at 2), and so
    does a single group at any extent that divides the heads.  Mamba-2
    itself refuses groups that p neither divides nor equals 1."""
    cfg = get_config(arch).reduced()
    specs.check_lm_mesh(cfg, 2)
    with pytest.raises(ValueError, match=field):
        specs.check_lm_mesh(cfg.replace(**{field: value}), 4)
    mamba = get_config(SSM).reduced()
    specs.check_lm_mesh(mamba, 8)
    with pytest.raises(ValueError, match="groups"):
        L.mamba2_apply(None, torch.zeros(1, 4, 8), d_state=4, n_heads=4,
                       head_dim=2, n_groups=2, mesh=Mesh1D(p=4))


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference_main(sys.argv[2], sys.argv[3])
    else:
        _rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
