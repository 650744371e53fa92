"""The port's resilience layer (``repro_torch/launch/resilience.py`` and
the engine's preemption hooks) against the reference's
``tests/test_resilience.py``, case for case, on the reduced
weathermixer-1b on the CPU.

* The PreemptionHandler's signal choreography, the Supervisor's relaunch
  loop, ``strip_args``, engine preempt -> final synchronous save -> exact
  resume, preemption without a checkpoint, the pipeline's shutdown, and
  ``--supervise`` end to end in a subprocess.
* Held against the reference: ``strip_args`` on generated argv lists; one
  scripted sequence of exit codes under one ``random.seed`` gives both
  Supervisors the same attempts, resumes and backoffs; the reference's
  ``latest_checkpoint`` picks the port's preemption save, and the
  reference's ``TrainEngine`` resumed from it gives the port's
  uninterrupted steps within 1e-4 (another summation order, as
  ``test_torch_checkpoint_mesh.py``).
* Meshes of gloo ranks, started together when a test first needs them:
  two ranks of the training CLI where only rank 1 is signalled (both stop
  after the same step, both exit 75, the resumed history bit for bit the
  uninterrupted one's); ``--supervise`` on two ranks through the world
  launcher; and the elastic case of the reference's
  ``scenario_elastic_reshard_resume``: eight ranks of this file on
  (data 2, model 4) with ZeRO-1 save at step 4, four of them resume on
  (data 2, model 2) within the reference's rtol 1e-3 / atol 1e-4.
"""
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.checkpoint import load_manifest, sharded
from repro_torch.checkpoint import manifest as MF
from repro_torch.configs.registry import get_config
from repro_torch.core import tree as ptree
from repro_torch.data.pipeline import make_pipeline
from repro_torch.launch import resilience
from repro_torch.launch.engine import EngineConfig, TrainEngine

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SRC = str(ROOT / "src")
HIST_KEYS = ("loss", "lr", "grad_norm")
TIMEOUT = 300           # each subprocess


def _env(**kw):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop(resilience.PREEMPT_ENV, None)
    env.pop("WORLD_SIZE", None)
    env.update(kw)
    return env


def _hist(recs):
    return [tuple(h[k] for k in HIST_KEYS) for h in recs]


def _read_jsonl(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()
            if line.strip()]


# -- PreemptionHandler -------------------------------------------------

def test_handler_catches_sigterm_and_restores_previous():
    prev = signal.getsignal(signal.SIGTERM)
    h = resilience.PreemptionHandler().install()
    try:
        assert h.installed and not h.should_stop
        os.kill(os.getpid(), signal.SIGTERM)
        assert h.should_stop and h.received == signal.SIGTERM
    finally:
        h.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev
    assert not h.installed


def test_handler_catches_sigusr1():
    with resilience.PreemptionHandler() as h:
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h.should_stop and h.received == signal.SIGUSR1


def test_handler_chaos_hook_delivers_real_signal():
    """poll(step) at the armed step goes through the REAL signal path
    (os.kill on itself), not just a flag."""
    with resilience.PreemptionHandler(preempt_at_step=2) as h:
        assert not h.poll(0)
        assert not h.poll(1)
        assert h.poll(2)
        assert h.received == signal.SIGTERM
        assert h.poll(3)                      # latched


def test_handler_reads_chaos_env(monkeypatch):
    monkeypatch.setenv(resilience.PREEMPT_ENV, "5")
    assert resilience.PreemptionHandler().preempt_at_step == 5
    assert resilience.PreemptionHandler(
        preempt_at_step=1).preempt_at_step == 1
    monkeypatch.delenv(resilience.PREEMPT_ENV)
    assert resilience.PreemptionHandler().preempt_at_step is None


def test_handler_non_main_thread_degrades_to_inert():
    out = {}

    def worker():
        with pytest.warns(UserWarning, match="main thread"):
            h = resilience.PreemptionHandler().install()
        out["installed"] = h.installed
        out["poll"] = h.poll(0)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert out == {"installed": False, "poll": False}


# -- Supervisor --------------------------------------------------------

def test_supervisor_resumable_exit_restarts_immediately():
    rcs = iter([resilience.RESUMABLE_EXIT_CODE, 0])
    sleeps = []
    sup = resilience.Supervisor(
        lambda resume, attempt: ["train", str(attempt)],
        run_cmd=lambda argv: next(rcs), sleep_fn=sleeps.append)
    assert sup.run() == 0
    assert sup.attempts == [resilience.RESUMABLE_EXIT_CODE, 0]
    assert sleeps == []


def test_supervisor_crash_backoff_is_exponential():
    rcs = iter([1, 1, 1, 0])
    sleeps = []
    sup = resilience.Supervisor(
        lambda resume, attempt: ["train"], max_restarts=5, backoff=1.0,
        run_cmd=lambda argv: next(rcs), sleep_fn=sleeps.append)
    assert sup.run() == 0
    assert len(sleeps) == 3
    assert 1.0 <= sleeps[0] <= 1.25
    assert 2.0 <= sleeps[1] <= 2.5
    assert 4.0 <= sleeps[2] <= 5.0


def test_supervisor_gives_up_after_max_restarts():
    sup = resilience.Supervisor(
        lambda resume, attempt: ["train"], max_restarts=2, backoff=0.0,
        run_cmd=lambda argv: 1, sleep_fn=lambda s: None)
    assert sup.run() == 1
    assert sup.attempts == [1, 1, 1]


def test_supervisor_rediscovers_latest_checkpoint(tmp_path):
    """The resume point is rediscovered before EVERY launch: the
    checkpoint the first (preempted) child wrote is what the second child
    resumes from."""
    launched = []

    def run_cmd(argv):
        launched.append(argv)
        if len(launched) == 1:
            sharded.save_checkpoint(
                str(tmp_path / "ck-3"),
                {"g": {"x": torch.arange(2.0, dtype=torch.float64)}}, step=3)
            return resilience.RESUMABLE_EXIT_CODE
        return 0

    sup = resilience.Supervisor(
        lambda resume, attempt: ["train"] + (["--resume", resume]
                                             if resume else []),
        ckpt_root=str(tmp_path), prefix="ck", run_cmd=run_cmd)
    assert sup.run() == 0
    assert sup.resumes == [None, str(tmp_path / "ck-3")]
    assert launched[1][-2:] == ["--resume", str(tmp_path / "ck-3")]


def test_supervisor_skips_torn_checkpoints(tmp_path):
    torn = tmp_path / "ck-9"
    torn.mkdir()
    (torn / "shard-d00000.npz").write_bytes(b"partial")   # no manifest
    sharded.save_checkpoint(str(tmp_path / "ck-2"),
                            {"g": {"x": torch.arange(2.0)}}, step=2)
    sup = resilience.Supervisor(lambda r, a: ["train"],
                                ckpt_root=str(tmp_path), prefix="ck",
                                run_cmd=lambda argv: 0)
    sup.run()
    assert sup.resumes == [str(tmp_path / "ck-2")]


@pytest.mark.parametrize("codes,max_restarts", [
    ([1, 75, 2, 75, 1, 0], 6), ([75, 3, 3, 3], 2), ([9, 9, 75, 0], 5)])
def test_supervisor_matches_reference(tmp_path, codes, max_restarts):
    """One scripted sequence of exit codes under one ``random.seed``: the
    port's and the reference's Supervisors make the same attempts, resume
    from the same checkpoints (each child saves ``ck-<attempt>``, in the
    port's format) and back off for the same seconds."""
    from repro.launch import resilience as ref_resilience

    def run(mod, root):
        it = iter(codes)
        n = []

        def run_cmd(argv):
            n.append(argv)
            sharded.save_checkpoint(str(root / f"ck-{len(n)}"),
                                    {"g": {"x": torch.arange(3.0)}},
                                    step=len(n))
            return next(it)
        random.seed(1234)
        sup = mod.Supervisor(
            lambda r, a: ["train", str(a)] + ([r] if r else []),
            ckpt_root=str(root), prefix="ck", max_restarts=max_restarts,
            backoff=0.5, max_backoff=3.0, run_cmd=run_cmd,
            sleep_fn=lambda s: None)
        rc = sup.run()
        return rc, sup.attempts, [r and Path(r).name for r in sup.resumes], \
            sup.backoffs
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    assert run(resilience, tmp_path / "a") == \
        run(ref_resilience, tmp_path / "b")


def test_world_exit_code():
    r = resilience.RESUMABLE_EXIT_CODE
    assert resilience.world_exit_code([0, 0]) == 0
    assert resilience.world_exit_code([r, r, r]) == r
    assert resilience.world_exit_code([r, 0]) == 1      # ranks disagree
    assert resilience.world_exit_code([r, -9, 3]) == -9
    assert resilience.world_exit_code([0, 2]) == 2


def test_run_world_terminates_survivors_of_a_crash(tmp_path):
    """A rank that crashes ends the world: the survivors are terminated
    and the crash's code is the world's; each rank sees its place."""
    script = tmp_path / "rank.py"
    script.write_text(
        "import os, sys, time\n"
        "r = int(os.environ['RANK'])\n"
        "out = os.environ['OUT']\n"
        "open(f'{out}/tmp{r}', 'w').write(' '.join(\n"
        "    os.environ[k] for k in ('RANK', 'LOCAL_RANK', 'WORLD_SIZE',\n"
        "    'LOCAL_WORLD_SIZE', 'MASTER_ADDR')))\n"
        "os.replace(f'{out}/tmp{r}', f'{out}/r{r}')\n"
        "if r == 1:\n"
        "    while not all(os.path.exists(f'{out}/r{k}') for k in (0, 2)):\n"
        "        time.sleep(0.05)\n"
        "    sys.exit(7)\n"
        "time.sleep(60)\n")
    t0 = time.monotonic()
    rc = resilience.run_world([sys.executable, str(script)], 3,
                              env=_env(OUT=str(tmp_path)))
    assert rc == 7 and time.monotonic() - t0 < 50
    assert [(tmp_path / f"r{r}").read_text() for r in range(3)] == \
        [f"{r} {r} 3 3 127.0.0.1" for r in range(3)]
    ok = tmp_path / "ok.py"
    ok.write_text("import sys\nsys.exit(75)\n")
    assert resilience.run_world([sys.executable, str(ok)], 2,
                                env=_env()) == 75


def test_strip_args():
    argv = ["--arch", "a", "--supervise", "--max-restarts", "5",
            "--resume=old", "--steps", "3"]
    assert resilience.strip_args(
        argv, flags=("--supervise",), valued=("--max-restarts",
                                              "--resume")) == \
        ["--arch", "a", "--steps", "3"]


@settings(max_examples=50, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1))
def test_strip_args_matches_reference(seed):
    """Generated argv lists: flags, valued options in both forms, values
    that look like options, repeats."""
    rng = random.Random(seed)
    words = ["--supervise", "--max-restarts", "--resume", "--steps", "3",
             "--resume=x", "--max-restarts=2", "ck", "--supervise=1",
             "--zero1", "-", "", "--resumex", "--max-restarts-"]
    argv = [rng.choice(words) for _ in range(rng.randint(0, 12))]
    from repro.launch import resilience as ref_resilience
    kw = dict(flags=("--supervise",), valued=("--max-restarts", "--resume"))
    assert resilience.strip_args(argv, **kw) == \
        ref_resilience.strip_args(argv, **kw)


# -- engine preempt -> final save -> resume (one device) ----------------

def _engine(**kw):
    return TrainEngine("weathermixer-1b", device="cpu", config=EngineConfig(
        steps=4, batch=2, log_every=1, prefetch=0, telemetry=False, **kw))


def test_engine_preempt_finalize_and_exact_resume(tmp_path):
    from repro.checkpoint import sharded as ref_sharded
    path = str(tmp_path / "ck")
    mfile = str(tmp_path / "m.jsonl")
    h_full = _engine().run()

    prev = signal.getsignal(signal.SIGTERM)
    eng = _engine(ckpt=path, preempt_at_step=1, metrics_out=mfile)
    with pytest.raises(resilience.Preempted) as ei:
        eng.run()
    assert signal.getsignal(signal.SIGTERM) == prev   # handler restored
    assert ei.value.step == 2                 # the in-flight step finished
    assert ei.value.checkpoint == path + "-1"
    assert ei.value.signum == signal.SIGTERM
    assert sharded.checkpoint_complete(path + "-1")
    assert eng.preempt_stats["step"] == 1
    assert eng.preempt_stats["final_save_s"] > 0
    assert [h["step"] for h in _read_jsonl(mfile)] == [0, 1]
    # the reference discovers the port's preemption save
    assert ref_sharded.latest_checkpoint(str(tmp_path), prefix="ck") == \
        path + "-1"

    resumed = _engine(resume=path + "-1")
    assert resumed.step_idx == 2 and resumed.pipeline.cursor == 2
    h_res = resumed.run()
    assert _hist(h_res) == _hist(h_full[2:])


def test_reference_resumes_port_preemption_save(tmp_path):
    """The reference's TrainEngine resumed from the port's preemption
    checkpoint gives the port's uninterrupted steps 2 and 3 within 1e-4."""
    from repro.launch.engine import EngineConfig as REngineConfig
    from repro.launch.engine import TrainEngine as RTrainEngine
    path = str(tmp_path / "ck")
    h_full = _engine().run()
    with pytest.raises(resilience.Preempted):
        _engine(ckpt=path, preempt_at_step=1).run()
    reng = RTrainEngine("weathermixer-1b", kernel="xla",
                        config=REngineConfig(
                            steps=4, batch=2, log_every=1, prefetch=0,
                            telemetry=False, resume=path + "-1"))
    assert reng.step_idx == 2
    h_ref = reng.run()
    assert [h["step"] for h in h_ref] == [2, 3]
    for g, w in zip(h_full[2:], h_ref):
        for k in HIST_KEYS:
            assert abs(g[k] - w[k]) <= 1e-4 * abs(w[k]), (k, g, w)


def test_engine_preempt_without_ckpt_still_exits_orderly():
    eng = _engine(preempt_at_step=0)
    with pytest.raises(resilience.Preempted) as ei:
        eng.run()
    assert ei.value.checkpoint is None and ei.value.step == 1
    assert eng.preempt_stats == {"step": 0, "final_save_s": None}


def test_engine_preempt_after_periodic_save_takes_no_second(tmp_path):
    """A signal after a step the periodic cadence saved: that save is the
    preemption checkpoint (no second write)."""
    path = str(tmp_path / "ck")
    eng = _engine(ckpt=path, ckpt_every=2, preempt_at_step=2)
    with pytest.raises(resilience.Preempted) as ei:
        eng.run()
    assert ei.value.checkpoint == path + "-2"
    assert eng.preempt_stats == {"step": 2, "final_save_s": None}
    assert eng._writer.saves == 1 and sharded.checkpoint_complete(path + "-2")


def test_engine_preempt_after_failed_periodic_save_saves_again(tmp_path):
    """The periodic async write of the signalled step fails (its shards
    land, its manifest does not): the final save writes that step again,
    whole, and the run resumes from it bit for bit."""
    path = str(tmp_path / "ck")
    h_full = _engine().run()
    eng = _engine(ckpt=path, ckpt_every=2, preempt_at_step=2)
    real = sharded.write_snapshot
    failed = []

    def torn(snap, p, **kw):
        real(snap, p, **kw)
        if not failed:
            failed.append(p)
            os.remove(os.path.join(p, MF.MANIFEST_NAME))
            raise OSError("EIO before the manifest")

    eng._writer._write_fn = torn
    eng._writer.retries = 1
    with pytest.raises(resilience.Preempted) as ei:
        eng.run()
    assert failed == [path + "-2"]
    assert ei.value.checkpoint == path + "-2"
    assert eng.preempt_stats["final_save_s"] > 0
    assert eng._writer.saves == 2 and eng._ckpt_history == [path + "-2"]
    assert sharded.checkpoint_complete(path + "-2")
    resumed = _engine(resume=path + "-2")
    assert resumed.step_idx == 3
    assert _hist(resumed.run()) == _hist(h_full[3:])


# -- pipeline shutdown ---------------------------------------------------

def _pipe(prefetch):
    return make_pipeline(get_config("weathermixer-1b").reduced(),
                         batch_size=2, prefetch=prefetch, device="cpu")


def test_pipeline_stop_cancels_mid_prefetch():
    pipe = _pipe(2)
    it = pipe.iterate([1] * 200)
    next(it)                                  # worker is prefetching ahead
    assert pipe._thread is not None and pipe._thread.daemon
    t0 = time.time()
    assert pipe.stop(timeout=5.0)
    assert time.time() - t0 < 5.0
    assert pipe._thread is None
    assert pipe.stop()                        # idempotent no-op


def test_pipeline_stop_noop_without_prefetch():
    pipe = _pipe(0)
    list(pipe.iterate([1, 1]))
    assert pipe.stop()


def test_pipeline_iterate_still_exact_after_stop_resume():
    """stop() mid-stream and a fresh iterate from the cursor reproduce the
    uninterrupted stream (the cursor is the whole state)."""
    want = [_pipe(0).get(i, 1) for i in range(4)]
    pipe = _pipe(2)
    it = pipe.iterate([1] * 4)
    got = [next(it), next(it)]
    pipe.stop()
    got += list(pipe.iterate([1] * 2))        # continues from cursor=2
    for g, w in zip(got, want):
        for k in w:
            assert torch.equal(g[k], w[k])


# -- CLI: --supervise end to end ------------------------------------------

def _train_cmd(*args):
    return [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--batch", "2", "--log-every", "1", *args]


def test_cli_supervise_preempt_and_resume(tmp_path):
    """Child 0 self-SIGTERMs after step 0 (chaos env) and exits 75 with a
    durable checkpoint; the supervisor relaunches with --resume; child 1
    finishes; the overall code is 0 and the history is the uninterrupted
    one's bit for bit."""
    plain = subprocess.run(
        _train_cmd("--steps", "2", "--metrics-out", str(tmp_path / "p.jsonl")),
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT)
    assert plain.returncode == 0, plain.stderr[-3000:]
    res = subprocess.run(
        _train_cmd("--steps", "2", "--ckpt", str(tmp_path / "ck"),
                   "--metrics-out", str(tmp_path / "m.jsonl"),
                   "--supervise", "--max-restarts", "2"),
        env=_env(**{resilience.PREEMPT_ENV: "0"}), capture_output=True,
        text=True, timeout=TIMEOUT)
    assert res.returncode == 0, (
        f"\nstdout:\n{res.stdout[-3000:]}\nstderr:\n{res.stderr[-3000:]}")
    assert "resumable exit" in res.stdout     # supervisor saw code 75
    assert "[preempt]" in res.stdout          # child ran the final save
    assert sharded.latest_checkpoint(str(tmp_path), prefix="ck") == \
        str(tmp_path / "ck")                  # final save outranks ck-0
    assert _hist(_read_jsonl(tmp_path / "m.jsonl")) == \
        _hist(_read_jsonl(tmp_path / "p.jsonl"))


@pytest.mark.parametrize("args,env,msg", [
    ((), {}, "--supervise requires --ckpt"),
    (("--ckpt", "ck"), {"WORLD_SIZE": "2"}, "not under torch.distributed"),
])
def test_cli_supervise_refusals(tmp_path, args, env, msg):
    res = subprocess.run(_train_cmd("--steps", "1", "--supervise", *args),
                         env=_env(**env), capture_output=True, text=True,
                         timeout=TIMEOUT, cwd=tmp_path)
    assert res.returncode != 0
    assert msg in res.stderr


# -- meshes: the training CLI's ranks and this file's ranks ---------------

MESH_ARGS = ("--mesh-model", "2", "--scheme", "1d", "--impl", "ring_fused",
             "--prefetch", "0", "--steps", "4")


class World:
    """Two ranks of the training CLI on a fresh rendezvous port, with
    per-rank extra environment."""

    def __init__(self, tmp, tag, *args, rank_env=({}, {})):
        port = resilience.free_port()
        self.tmp, self.tag = tmp, tag
        self.procs = [subprocess.Popen(
            _train_cmd(*MESH_ARGS, "--metrics-out", str(tmp / f"{tag}.jsonl"),
                       *args),
            env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                     LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), **rank_env[r]),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=tmp) for r in range(2)]

    def wait(self):
        try:
            outs = [p.communicate(timeout=TIMEOUT) for p in self.procs]
        finally:
            for p in self.procs:
                p.kill()
        return [p.returncode for p in self.procs], outs

    def history(self):
        return _read_jsonl(self.tmp / f"{self.tag}.jsonl")


def _elastic_main(rank, out_dir):
    """Rank ``rank`` of the elastic case: eight ranks on (data 2, model 4)
    with ZeRO-1 save ``ck-3`` (step 4) and ``ck``; ranks 0-3 then resume
    from ``ck-3`` on (data 2, model 2) and save once more."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = Path(out_dir)
    res = {}

    def engine(model, **kw):
        return TrainEngine("weathermixer-1b", mesh_model=model, mesh_data=2,
                           scheme="1d", device="cpu", config=EngineConfig(
                               steps=6, batch=4, zero1=True, log_every=1,
                               prefetch=0, telemetry=False, **kw))

    dist.init_process_group("gloo", init_method=f"file://{out}/store8",
                            rank=rank, world_size=8)
    big = engine(4, ckpt=str(out / "ck"), ckpt_every=3)
    res["big"] = np.array(_hist(big.run()))
    big.close()
    dist.barrier()              # rank 0's writer has merged the manifests
    dist.destroy_process_group()
    if rank < 4:
        dist.init_process_group("gloo", init_method=f"file://{out}/store4",
                                rank=rank, world_size=4)
        small = engine(2, resume=str(out / "ck-3"))
        res["at"] = np.array([small.step_idx, small.pipeline.cursor,
                              small.opt_state["step"]])
        # ZeRO-1 on the new mesh: each cut leaf's moments are this data
        # rank's half of the rank's parameter shard
        cut = []
        ptree.map(lambda p, mu, d: cut.append(
            d is None or mu.shape[d] * 2 == p.shape[d]),
            small.params, small.opt_state["mu"], small.zero1.dims)
        res["cut"] = np.array([sum(1 for d in ptree.leaves(small.zero1.dims)
                                   if d is not None), all(cut)])
        res["small"] = np.array(_hist(small.run()))
        small.save(str(out / "resharded"), block=True)
        res["bytes"] = np.array(small.last_save.bytes_per_rank[rank])
        small.close()
        dist.destroy_process_group()
    np.savez(out / f"rank{rank}.npz", **res)


class Launched:
    """Every mesh case of the module, started together."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.plain = World(tmp, "plain")
        self.one = World(tmp, "one", "--ckpt", "one/ck", "--trace",
                         "one.trace.json",
                         rank_env=({}, {resilience.PREEMPT_ENV: "1"}))
        self.sup = subprocess.Popen(
            _train_cmd(*MESH_ARGS, "--metrics-out", str(tmp / "sup.jsonl"),
                       "--ckpt", "sup/ck", "--supervise"),
            env=_env(**{resilience.PREEMPT_ENV: "1"}), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=tmp)
        # this file's ranks: conftest first (src on the path, and the
        # hypothesis stand-in where the package is missing)
        self.elastic = [subprocess.Popen(
            [sys.executable, "-c", "import conftest, test_torch_resilience "
             f"as t; t._elastic_main({r}, {str(tmp)!r})"],
            env=_env(PYTHONPATH=SRC + os.pathsep + str(HERE)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(8)]
        self._done = {}

    def get(self, name, fn):
        if name not in self._done:
            self._done[name] = fn()
        return self._done[name]

    def close(self):
        procs = (self.plain.procs + self.one.procs + [self.sup]
                 + self.elastic)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    runs = Launched(tmp_path_factory.mktemp("resilience_mesh"))
    yield runs
    runs.close()


def _plain(mesh):
    def run():
        codes, outs = mesh.plain.wait()
        assert codes == [0, 0], outs[0][1][-3000:]
        return mesh.plain.history()
    return mesh.get("plain", run)


def test_mesh_one_signalled_rank_stops_both(mesh):
    """SIGTERM to rank 1 alone (its chaos env): both ranks stop after
    step 1 and exit 75, the trace names the agreed step and the origin
    rank, ``ck-1`` is complete, and the run resumed from it gives the
    uninterrupted history bit for bit."""
    codes, outs = mesh.one.wait()
    assert codes == [75, 75], outs[0][1][-3000:] + outs[1][1][-3000:]
    for out, _ in outs:
        assert "[train] preempted at step 2 (checkpoint='one/ck-1'" in out
    assert "origin rank 1" in outs[0][0]
    ck = mesh.tmp / "one" / "ck-1"
    assert sharded.checkpoint_complete(str(ck))
    assert load_manifest(str(ck)).step == 2
    events = json.loads((mesh.tmp / "one.trace.json").read_text())
    sig = [e for e in events["traceEvents"] if e["name"] == "preempt.signal"]
    assert len(sig) == 1 and sig[0]["args"]["step"] == 1 \
        and sig[0]["args"]["origin_rank"] == 1 \
        and sig[0]["args"]["signum"] is None     # rank 0 was not signalled
    assert [h["step"] for h in mesh.one.history()] == [0, 1]
    resumed = World(mesh.tmp, "one_resumed", "--resume", "one/ck-1")
    codes, outs = resumed.wait()
    assert codes == [0, 0], outs[0][1][-3000:]
    assert _hist(mesh.one.history() + resumed.history()) == \
        _hist(_plain(mesh))


def test_mesh_supervise_launches_its_world(mesh):
    """``--supervise`` on two ranks: the world launcher's first world
    exits 75 after step 1, the second resumes from ``ck-1`` and finishes;
    the appended history is the uninterrupted one's bit for bit."""
    try:
        out, err = mesh.sup.communicate(timeout=TIMEOUT)
    finally:
        mesh.sup.kill()
    assert mesh.sup.returncode == 0, err[-3000:]
    assert out.count("[supervisor] resumable exit (75)") == 1
    assert sharded.latest_checkpoint(str(mesh.tmp / "sup"), prefix="ck") \
        == str(mesh.tmp / "sup" / "ck")
    assert sharded.checkpoint_complete(str(mesh.tmp / "sup" / "ck-1"))
    assert _hist(_read_jsonl(mesh.tmp / "sup.jsonl")) == _hist(_plain(mesh))


def _elastic(mesh):
    def run():
        try:
            outs = [p.communicate(timeout=TIMEOUT) for p in mesh.elastic]
        finally:
            for p in mesh.elastic:
                p.kill()
        for p, (_, err) in zip(mesh.elastic, outs):
            assert p.returncode == 0, err[-3000:]
        return [dict(np.load(mesh.tmp / f"rank{r}.npz")) for r in range(8)]
    return mesh.get("elastic", run)


def test_elastic_resume_8_to_4_ranks(mesh):
    """The reference's ``scenario_elastic_reshard_resume``: the eight-rank
    ZeRO-1 run's ``ck-3`` resumes on four ranks at step 4 and cursor 4,
    its moments cut over the new data axis; its two steps are within rtol
    1e-3 / atol 1e-4 of the eight-rank run's steps 4-5 (the reduction
    order differs across mesh extents)."""
    res = _elastic(mesh)
    assert sharded.checkpoint_complete(str(mesh.tmp / "ck-3"))
    assert sharded.latest_checkpoint(str(mesh.tmp), prefix="ck") == \
        str(mesh.tmp / "ck")
    big = res[0]["big"]
    for r in range(4):
        assert list(res[r]["at"]) == [4, 4, 4]
        n_cut, all_cut = res[r]["cut"]
        assert n_cut > 0 and all_cut
        small = res[r]["small"]
        assert small.shape == (2, 3)
        assert np.allclose(small[:, 0], big[4:, 0], rtol=1e-3, atol=1e-4)
        assert np.array_equal(small[:, 1], big[4:, 1])       # lr


def test_elastic_save_spreads_over_the_survivors(mesh):
    """A save from the four resumed ranks: every rank writes, the largest
    at most 2 x total / 4, every leaf's bytes exactly once."""
    res = _elastic(mesh)
    per = [int(res[r]["bytes"]) for r in range(4)]
    man = load_manifest(str(mesh.tmp / "resharded"))
    total = sum(int(np.prod(e.shape)) * MF.dtype_entry(e.dtype)[1].itemsize
                for g in man.groups.values() for e in g.values())
    assert sum(per) == total
    assert all(b > 0 for b in per) and max(per) <= 2 * total // 4

