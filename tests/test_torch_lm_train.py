"""Language-model training in the port (the dense, VLM, moe and audio
families) against the JAX package's.

The reference's weights (``repro.models.registry.init`` of the reduced
configs: d_model 256, 2 layers, vocab 1024; 4 experts, top-2 for the moe
family; 2 encoder and 2 decoder layers, 64 frames for whisper) are carried
to the port through numpy (``repro_torch.convert``; an npz for the train
CLI's ``--init-params``), and both packages draw the same batches: the
``TokenDataset`` rows and the f32 ``embeds`` / ``frames`` of the token
batch source.  All f32 on the CPU, where block_matmul is its plain
version.

Tolerances:
  * ``lm_cross_entropy``: 1e-6 relative (a logsumexp over 1,024 or 1,100
    f32 logits in another order);
  * one train step (loss, grad norm, every updated leaf) and the
    five-step histories: 1e-4 relative on the metrics, as the mixer's
    histories (``tests/test_torch_train.py``: the two sides sum in other
    orders, and Adam's first steps divide by small second moments), and
    every leaf of the updated parameters within 1e-6 absolute (measured
    ~1e-7: an Adam step of lr 1e-3 moves each by at most ~lr / 1000 off
    the sign of a gradient near 0);
  * remat on against off: bit for bit (the same kernels recomputed on the
    same inputs);
  * ``accum=2`` against the full batch: 1e-5 relative on loss and grad
    norm, 1e-6 absolute on the leaves (the mean of two half-batch means
    and gradients, in f32);
  * a data mesh of two ranks (gloo) against one device: 1e-6 relative on
    loss and grad norm (the two ranks' NLL sums and gradients added once
    more; measured ~1e-7), and ZeRO-1 bit for bit the run without;
  * save and resume: bit for bit the uninterrupted run.
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
from repro.checkpoint.io import restore as ref_restore
from repro.core.sharding import RULES_1D as REF_RULES_1D
from repro.data import pipeline as ref_pipeline
from repro.data.tokens import TokenDataConfig as RefTokenDataConfig
from repro.data.tokens import TokenDataset as RefTokenDataset
from repro.launch import shapes as RSH
from repro.launch import specs as ref_specs
from repro.launch.engine import EngineConfig as REngineConfig
from repro.launch.engine import TrainEngine as RTrainEngine
from repro.models import registry as RM
from repro.optim import adam as ref_adam
from repro.train import loss as ref_loss
from repro.train import step as ref_step
from repro_torch import checkpoint as ckpt
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import precision
from repro_torch.core import tree as ptree
from repro_torch.core.sharding import RULES_1D, Mesh1D
from repro_torch.data.pipeline import (TokenBatchSource, make_pipeline,
                                       make_source)
from repro_torch.data.tokens import TokenDataConfig, TokenDataset
from repro_torch.kernels import ops
from repro_torch.launch import specs
from repro_torch.launch import train as train_cli
from repro_torch.launch.engine import EngineConfig, TrainEngine
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.models import registry as M
from repro_torch.optim import adam
from repro_torch.train import loss, step

ROOT = Path(__file__).resolve().parents[1]
HIST_KEYS = ("loss", "grad_norm", "lr")
STEP_ARCHS = ["internlm2-1.8b", "pixtral-12b", "dbrx-132b", "whisper-small"]
CLI_ARCHS = ["internlm2-1.8b", "pixtral-12b", "phi3.5-moe-42b-a6.6b",
             "whisper-small"]
SEQ = 32
STEPS = 5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))


def _ref_init(arch, seed=0):
    return jax.tree.map(np.asarray, RM.init(jax.random.PRNGKey(seed),
                                            ref_get_config(arch).reduced()))


def _flat(tree):
    out = {}
    ptree.map_with_path(
        lambda path, a: out.__setitem__("/".join(map(str, path)), a), tree)
    return out


def _save_npz(path, tree):
    np.savez(path, **_flat(tree))


def _leaves_close(got, want, atol):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vp,masked", [(1024, False), (1024, True),
                                       (1100, False), (1100, True)])
def test_lm_cross_entropy_matches_reference(vp, masked):
    """Without and with a mask (one row all masked, so the count's floor
    of 1 is not what divides), and with padded vocab ids (vp 1100 > 1024:
    their -1e30 keeps them out of the logsumexp)."""
    rng = np.random.default_rng(1)
    logits = (3 * rng.normal(size=(3, 7, vp))).astype(np.float32)
    labels = rng.integers(0, 1024, (3, 7)).astype(np.int32)
    mask = None
    if masked:
        mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
        mask[1] = 0
    want = ref_loss.lm_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), 1024,
        mask=None if mask is None else jnp.asarray(mask))
    got = loss.lm_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), 1024,
        mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    assert _rel(float(got), float(want)) <= 1e-6
    zero = loss.lm_cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels), 1024,
                                 mask=torch.zeros(3, 7))
    assert float(zero) == 0.0


# ---------------------------------------------------------------------------
# one step, remat, accumulation
# ---------------------------------------------------------------------------

def _batch(arch, batch=2, seq=SEQ, step_i=0):
    return make_source(get_config(arch).reduced(), batch,
                       seq_len=seq).full_batch(step_i, 1)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_one_train_step_matches_reference(arch):
    """The reference's ``make_train_step`` and the port's on the same
    weights and batch: the loss, its nll and aux parts, the grad norm and
    every updated leaf; the batch keys each family's source makes (the
    VLM's embeds, whisper's frames) are the reference's bit for bit."""
    rcfg = ref_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    tree = _ref_init(arch)
    rbatch = ref_pipeline.make_source(rcfg, 2, seq_len=SEQ).full_batch(0, 1)
    batch = _batch(arch)
    assert set(batch) == set(rbatch)
    for k in batch:
        np.testing.assert_array_equal(batch[k], rbatch[k])
    rparams = jax.tree.map(jnp.asarray, tree)
    rnew, ropt, rm = jax.jit(ref_step.make_train_step(
        rcfg, RSH.jigsaw_for(rcfg), ref_adam.AdamConfig()))(
        rparams, ref_adam.init(rparams, ref_adam.AdamConfig()),
        {k: jnp.asarray(v) for k, v in rbatch.items()})
    params = params_from_numpy(tree, device="cpu")
    new, opt, m = step.make_train_step(cfg, jigsaw_for(cfg),
                                       adam.AdamConfig())(
        params, adam.init(params, adam.AdamConfig()),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(m) == set(rm)
    for k in ("loss", "nll", "aux", "grad_norm", "lr"):
        assert _rel(float(m[k]), float(rm[k])) <= 1e-4, (k, m[k], rm[k])
    assert (float(m["aux"]) > 0) == (cfg.family == "moe")
    assert int(opt["step"]) == 1
    _leaves_close(params_to_numpy(new), jax.tree.map(np.asarray, rnew), 1e-6)


def _grads(arch, **over):
    cfg = get_config(arch).reduced().replace(kernel="pallas", **over)
    params = params_from_numpy(_ref_init(arch), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    return step.value_and_grad(params, batch, cfg, jigsaw_for(cfg))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "dbrx-132b",
                                  "whisper-small"])
def test_remat_is_bitwise_the_step_without(arch):
    """``cfg.remat`` checkpoints each layer (the encoder's and the
    decoder's too); the recompute runs the same kernels on the same
    inputs, and the MoE routes the same: metrics and gradients bit for
    bit."""
    m0, g0 = _grads(arch, remat=False)
    m1, g1 = _grads(arch, remat=True)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for a, b in zip(ptree.leaves(g0), ptree.leaves(g1)):
        assert torch.equal(a, b)


def lm_train_calls(cfg):
    """block_matmul calls of one remat training step under
    ``kernel="pallas"``, by kind: the forward, the remat recompute (every
    layer's, not the head's), dx, dw (every linear's: each input needs its
    gradient, the first through the embedding or a norm's parameters) and
    the GELU pre-activation recomputes of the FFNs' first linear."""
    if cfg.family == "audio":
        per = 6 * cfg.n_enc_layers + 10 * cfg.n_layers
        gelu = cfg.n_enc_layers + cfg.n_layers
    else:
        # q, k, v, o and the SwiGLU FFN's three linears, or the router
        per = (5 if cfg.n_experts else 7) * cfg.n_layers
        gelu = 0
    return dict(forward=per + 1, remat=per, dx=per + 1, dw=per + 1,
                gelu=gelu)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "phi3.5-moe-42b-a6.6b",
                                  "whisper-small"])
def test_remat_calls_per_step(monkeypatch, arch):
    """block_matmul calls of one ``kernel="pallas"`` training step
    (``lm_train_calls``): the dense family's 7 linears a layer and the
    head, the moe family's attention and f32 router, whisper's encoder
    and decoder layers (with the GELU recomputes); the dw calls take the
    transposed x and the f32 ones are the router's; without remat the
    recompute's calls go."""
    calls = []
    real = ops.block_matmul

    def counting(x, w, *a, **kw):
        calls.append((kw.get("x_t", False), x.dtype == torch.float32))
        return real(x, w, *a, **kw)
    monkeypatch.setattr(ops, "block_matmul", counting)
    # the configs' own dtypes (bf16 weights, the f32 router); whisper under
    # the bf16 policy, whose casts keep its f32 frames' encoder states
    # from promoting the decoder's GEMMs to f32
    cfg = get_config(arch).reduced().replace(
        kernel="pallas", param_dtype="bfloat16", compute_dtype="bfloat16")
    if cfg.family == "audio":
        cfg = precision.apply_policy(cfg, "bf16")
    want = lm_train_calls(cfg)
    params = M.init(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(arch).items()}
    for remat in (True, False):
        calls.clear()
        step.value_and_grad(params, batch, cfg.replace(remat=remat),
                            jigsaw_for(cfg))
        assert len(calls) == sum(want.values()) - (0 if remat else
                                                   want["remat"]), remat
        assert sum(t for t, _ in calls) == want["dw"]
        routers = cfg.n_layers if cfg.n_experts else 0
        assert sum(f for _, f in calls) == routers * (4 if remat else 3)


def test_accum_two_matches_the_full_batch():
    """``accum=2`` splits the rows into two microbatches of equal size:
    the mean of their losses and gradients is the full batch's."""
    cfg = get_config("internlm2-1.8b").reduced()
    tree = _ref_init("internlm2-1.8b")
    batch = {k: torch.from_numpy(v)
             for k, v in _batch("internlm2-1.8b", batch=4).items()}
    out = []
    for accum in (1, 2):
        params = params_from_numpy(tree, device="cpu")
        new, _, m = step.make_train_step(cfg, jigsaw_for(cfg),
                                         adam.AdamConfig(), accum=accum)(
            params, adam.init(params, adam.AdamConfig()), batch)
        out.append((params_to_numpy(new), m))
    (p1, m1), (p2, m2) = out
    for k in ("loss", "nll", "grad_norm"):
        assert _rel(float(m2[k]), float(m1[k])) <= 1e-5, k
    _leaves_close(p2, p1, 1e-6)


# ---------------------------------------------------------------------------
# the data: token rows, the batch source, specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [slice(0, 2), slice(2, 5), slice(3, 4)])
def test_sample_shard_is_a_slice_of_the_batch(rows):
    mine = TokenDataset(TokenDataConfig(1024, 40, seed=3))
    theirs = RefTokenDataset(RefTokenDataConfig(1024, 40, seed=3))
    whole = mine.sample_batch(7, 5)
    got = mine.sample_shard(7, 5, row_slice=rows)
    want = theirs.sample_shard(7, 5, row_slice=rows)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k], whole[k][rows])
        np.testing.assert_array_equal(got[k], want[k])
    assert mine.io_bytes_per_rank(6, 2) == theirs.io_bytes_per_rank(6, 2) \
        == 2 * 4 * 6 * 40 // 2


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "pixtral-12b",
                                  "whisper-small"])
def test_token_source_rows_per_data_rank(arch):
    """``make_source`` by family: the reference's keys and whole batches
    bit for bit; on a (data 2, model 1) mesh each rank's reads (sharded)
    and its cut of the whole batch (sync-full) are its rows of it, and the
    pipeline counts half the bytes a rank."""
    cfg = get_config(arch).reduced()
    src = make_source(cfg, 4, seq_len=16)
    assert isinstance(src, TokenBatchSource)
    want = ref_pipeline.make_source(ref_get_config(arch).reduced(), 4,
                                    seq_len=16).full_batch(3, 1)
    whole = src.full_batch(3, 1)
    assert src.keys == tuple(want) == tuple(whole)
    for k in want:
        np.testing.assert_array_equal(whole[k], want[k])
    bspecs = specs.block_specs(cfg, RULES_1D)
    for d in range(2):
        mesh = Mesh1D(p=1, data_size=2, data_index=d)
        rows = slice(2 * d, 2 * d + 2)
        for mode in ("sharded", "sync-full"):
            pipe = make_pipeline(cfg, batch_size=4, seq_len=16, mode=mode,
                                 prefetch=0, device="cpu", mesh=mesh)
            got = pipe.get(3)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(),
                                              want[k][rows], err_msg=k)
            if mode == "sharded":
                assert pipe.stats.rank_bytes["tokens"][d] == \
                    pipe.io_bytes_per_rank(2) // 2
        plan = src.plan(bspecs["tokens"], mesh)
        np.testing.assert_array_equal(
            src.read_key("labels", 3, 1, plan), want["labels"][rows])


def test_lm_specs_match_reference():
    """``batch_specs`` of each LM family the reference's entry for entry;
    ``param_specs`` of a dense LM the 1-D layout (the table's vocab and a
    weight's contracting dim on ``model``), with no FSDP data entry where
    the config cuts over data; that cut over two data ranks raises,
    naming its queue item."""
    def norm(spec):
        """One-axis tuples as the axis (JAX's PartitionSpec reads them
        so)."""
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in spec)
    for arch in ("internlm2-1.8b", "pixtral-12b", "whisper-small",
                 "dbrx-132b"):
        want = ref_specs.batch_specs(ref_get_config(arch), REF_RULES_1D)
        got = specs.batch_specs(get_config(arch), RULES_1D)
        assert set(got) == set(want)
        for k in want:
            assert norm(got[k]) == norm(tuple(want[k])), k
    cfg = get_config("internlm2-1.8b").reduced()
    params = {"embed": {"table": np.zeros((8, 4))},
              "layers": [{"w": np.zeros((4, 4))}]}
    assert specs.param_specs(params, cfg, RULES_1D) == {
        "embed": {"table": ("model", None)},
        "layers": [{"w": (None, "model")}]}
    fsdp = cfg.replace(shard_params_over_data=True)
    assert specs.param_specs(params, fsdp, RULES_1D) == specs.param_specs(
        params, cfg, RULES_1D)
    with pytest.raises(NotImplementedError, match="item 19"):
        specs.check_lm_mesh(fsdp, 2, fsdp=True)


# ---------------------------------------------------------------------------
# TrainEngine and the train CLI
# ---------------------------------------------------------------------------

def _ref_history(arch, tree, **kw):
    eng = RTrainEngine(arch, reduced=True,
                       init_params=jax.tree.map(jnp.asarray, tree),
                       config=REngineConfig(steps=STEPS, batch=2,
                                            seq_len=SEQ, log_every=1,
                                            prefetch=0, telemetry=False,
                                            seed=0, **kw))
    return eng.run(), eng


@pytest.mark.parametrize("arch", CLI_ARCHS)
def test_cli_history_matches_reference_engine(arch, tmp_path):
    """``python -m repro_torch.launch.train --device cpu --arch <id>
    --steps 5 --seq-len 32 --log-every 1`` (in process, from the
    reference's weights through ``--init-params``) against the reference's
    ``TrainEngine`` on the same weights: loss, grad norm and lr at every
    step, the nll and aux parts, the keys of each record; and the final
    parameters."""
    tree = _ref_init(arch)
    _save_npz(tmp_path / "init.npz", tree)
    want, reng = _ref_history(arch, tree)
    out = tmp_path / "m.jsonl"
    with pytest.raises(SystemExit) as done:
        train_cli.main(["--device", "cpu", "--arch", arch, "--steps",
                        str(STEPS), "--batch", "2", "--seq-len", str(SEQ),
                        "--log-every", "1", "--prefetch", "1",
                        "--no-telemetry", "--init-params",
                        str(tmp_path / "init.npz"), "--metrics-out",
                        str(out)])
    assert done.value.code == 0
    got = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["step"] == w["step"]
        for k in HIST_KEYS + ("nll", "aux"):
            assert _rel(g[k], w[k]) <= 1e-4, (k, g, w)


def test_engine_records_carry_mfu_and_the_seq_len(tmp_path):
    """Every step record carries the cost model's ``mfu`` for the batch of
    ``seq_len`` tokens, and the FLOPs are the reference's model's."""
    eng = TrainEngine("internlm2-1.8b", device="cpu",
                      config=EngineConfig(steps=2, batch=2, seq_len=SEQ,
                                          log_every=1, prefetch=0))
    eng.run()
    recs = eng.tracer.step_records()
    assert len(recs) == 2 and all(r["mfu"] > 0 for r in recs)
    reng = RTrainEngine("internlm2-1.8b", reduced=True,
                        config=REngineConfig(steps=2, batch=2, seq_len=SEQ,
                                             telemetry=False))
    assert eng.cost_model.flops_per_step == reng.cost_model.flops_per_step
    assert eng.tracer._meta["seq_len"] == SEQ


def test_save_then_resume_equals_the_uninterrupted_run(tmp_path):
    """whisper-small (its enc_layers and dec_layers) through ``--ckpt``
    and ``--resume``: the resumed run's steps and final parameters and
    optimizer state bit for bit the uninterrupted run's; on disk every
    layer list is one stacked leaf, as the reference saves it, and the
    reference's restore reads the checkpoint."""
    arch = "whisper-small"

    def engine(**kw):
        return TrainEngine(arch, device="cpu", config=EngineConfig(
            steps=4, batch=2, seq_len=16, log_every=1, prefetch=0,
            telemetry=False, **kw))
    full = engine(ckpt=str(tmp_path / "ck"), ckpt_every=1)
    hist = full.run()
    resumed = engine(resume=str(tmp_path / "ck-1"))
    assert resumed.step_idx == 2
    rest = resumed.run()
    for a, b in zip(rest, hist[2:]):
        for k in HIST_KEYS:
            assert a[k] == b[k], k
    for group in ("params", "opt_state"):
        for a, b in zip(ptree.leaves(getattr(resumed, group)),
                        ptree.leaves(getattr(full, group))):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)
    man = ckpt.load_manifest(str(tmp_path / "ck"))
    entries = man.groups["params"]
    cfg = get_config(arch).reduced()
    assert entries["dec_layers/cross/wq/w"].shape[0] == cfg.n_layers
    assert entries["enc_layers/ffn/fc1/b"].shape[0] == cfg.n_enc_layers
    like = _ref_init(arch)
    rparams, _, rstep = ref_restore(str(tmp_path / "ck"), like_params=like)
    assert rstep == 4
    for a, b in zip(jax.tree.leaves(rparams),
                    jax.tree.leaves(params_to_numpy(full.params))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_lm_on_a_model_mesh_raises():
    """A language model (moe, audio) on a 2-D model mesh, which no
    language model trains on, raises before any process group is joined,
    naming its queue item, on either device (every family trains on a 1-D
    model mesh: ``tests/test_torch_lm_mesh_zoo.py``)."""
    for arch in ("phi3.5-moe-42b-a6.6b", "whisper-small"):
        for device in ("cpu", "cuda"):
            with pytest.raises(NotImplementedError, match="item 19"):
                TrainEngine(arch, device=device, mesh_model=4, scheme="2d",
                            config=EngineConfig(steps=1, batch=2))


# ---------------------------------------------------------------------------
# (data 2, model 1) under gloo
# ---------------------------------------------------------------------------

DATA_RUNS = {"base": {}, "zero1": dict(zero1=True),
             "sync": dict(pipeline="sync-full")}


def _rank_main(rank, init, out_dir):
    """One rank of a (data 2, model 1) mesh: ``DATA_RUNS`` of internlm2
    reduced from the weights in init.npz, each history and the final
    parameters saved to rank<r>.npz."""
    import torch.distributed as dist
    from repro_torch.convert import params_from_npz
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    whole = params_from_npz(Path(out_dir) / "init.npz", device="cpu")
    res = {}
    for tag, kw in DATA_RUNS.items():
        eng = TrainEngine("internlm2-1.8b", init_params=whole, device="cpu",
                          mesh_data=2, config=EngineConfig(
                              steps=STEPS, batch=2, seq_len=SEQ,
                              log_every=1, prefetch=0, telemetry=False,
                              seed=0, **kw))
        hist = eng.run()
        res["coord"] = np.array([eng.mesh.data_index, eng.mesh.rank])
        for k in HIST_KEYS:
            res[f"{tag}/{k}"] = np.array([h[k] for h in hist])
        for path, v in _flat(eng.params).items():
            res[f"{tag}/params/{path}"] = v.numpy()
        res[f"{tag}/opt_bytes"] = np.array(eng.opt_state_bytes())
        res[f"{tag}/read"] = np.array(
            eng.pipeline.stats.rank_bytes.get("tokens", {}).get(rank, -1))
    np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    dist.destroy_process_group()


def test_data_mesh_matches_one_device_and_zero1_is_bitwise(tmp_path):
    """Two gloo ranks of this file at (data 2, model 1), each reading its
    row of the batch: the five-step history and the final parameters bit
    for bit the one-device engine's with ``accum=2`` on the same weights
    (the same two rows, each row's gradient summed in f32 once: a rank's
    NLL part over the whole token count is exactly half a row's mean, a
    power of two), and the history within 1e-6 of the one-device run of
    the whole batch at once (whose GEMMs sum both rows in one pass);
    ZeRO-1 (half the optimizer state a rank) and
    ``pipeline="sync-full"`` bit for bit the base run, and the ranks'
    parameters equal."""
    tree = _ref_init("internlm2-1.8b")
    _save_npz(tmp_path / "init.npz", tree)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    init = f"file://{tmp_path / 'store'}"
    ranks = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), init, str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    def one_device(accum):
        eng = TrainEngine("internlm2-1.8b", device="cpu",
                          init_params=params_from_numpy(tree, device="cpu"),
                          config=EngineConfig(
                              steps=STEPS, batch=2, seq_len=SEQ,
                              log_every=1, prefetch=0, telemetry=False,
                              seed=0, accum=accum))
        return eng.run(), _flat(eng.params)
    want, _ = one_device(1)
    # one thread, as the ranks: the CPU GEMMs' sums follow the thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        halves, halves_params = one_device(2)
    finally:
        torch.set_num_threads(threads)
    try:
        outs = [p.communicate(timeout=300) for p in ranks]
    finally:
        for p in ranks:
            p.kill()
    for p, (_, err) in zip(ranks, outs):
        assert p.returncode == 0, err[-3000:]
    res = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    assert [list(r["coord"]) for r in res] == [[0, 0], [1, 1]]
    for k in HIST_KEYS:
        assert _rel(res[0][f"base/{k}"], [h[k] for h in want]) <= 1e-6, k
        np.testing.assert_array_equal(res[0][f"base/{k}"],
                                      [h[k] for h in halves], err_msg=k)
    for path, v in halves_params.items():
        np.testing.assert_array_equal(res[0][f"base/params/{path}"],
                                      v.numpy(), err_msg=path)
    for r in res:
        for tag in ("zero1", "sync"):
            for key in r:
                if key.startswith("base/") and not key.endswith(
                        ("opt_bytes", "read")):
                    np.testing.assert_array_equal(
                        r[key.replace("base/", f"{tag}/")], r[key])
        assert 2 * r["zero1/opt_bytes"] <= r["base/opt_bytes"] + 64
        # one row of int32 tokens a step
        assert r["base/read"] == STEPS * 4 * SEQ
    for key in res[0]:
        if "/params/" in key:
            np.testing.assert_array_equal(res[0][key], res[1][key])


if __name__ == "__main__":
    _rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
