"""Data-parallel forecast serving (``ForecastEngine(mesh_data=n)``) on
gloo ranks, against the JAX package's engine, on the CPU.

After the reference's ``scenario_serving_restore``: the reference trains
the reduced weathermixer-1b on a (model 4 x data 2) 1-D mesh of eight
host-emulated devices for two steps and saves it, fp32 and under the bf16
policy, in a subprocess (``--reference``), then serves five requests
(buckets 2 and 4, leads [1, 2, 3, 2, 1]) from the fp32 checkpoint on
data-only meshes of 1, 2 and 4 devices, and the bf16 checkpoint on 4 at
bf16 and cast to fp32.  Four ranks of this file (``--rank``, a
``file://`` store per mesh) serve the same checkpoints with the port's
engine at ``mesh_data`` 1, 2 and 4 (bucket 2 is whole on every rank at 4:
the data size does not divide it), and the engine's grow path from seed
weights (buckets 1, 2, 4: a request alone, then three joining it, the rows
moving between ranks).

Tolerances: across data sizes and against the reference 1e-5 (fp32; the
plain matmul of the CPU need not be batch-invariant, as
``test_torch_serve.py``; the card holds the data sizes bit for bit,
``chip_smoke.py``'s ``serve_data``); bf16 against fp32 0.1 (the
reference's own).
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import serve as launch_serve
from repro_torch.launch.specs import state_spec
from repro_torch.serve.engine import ForecastEngine, ServeConfig
from test_torch_cannon import Launched

ROOT = Path(__file__).resolve().parents[1]
WM = "weathermixer-1b"
LEADS = [1, 2, 3, 2, 1]
SIZES = (1, 2, 4)
TOL = 1e-5


def _wait_for(path, timeout=600):
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.1)


# ---------------------------------------------------------------------------
# the reference (subprocess) and the port's ranks
# ---------------------------------------------------------------------------

def _reference_main(path):
    from repro.data.weather import WeatherDataConfig, WeatherDataset
    from repro.launch.engine import EngineConfig, TrainEngine
    from repro.serve.engine import ForecastEngine as RefEngine
    from repro.serve.engine import ServeConfig as RefServeConfig
    tmp = Path(path).parent
    for prec in (None, "bf16"):
        tag = prec or "fp32"
        eng = TrainEngine(WM, mesh_model=4, mesh_data=2, scheme="1d",
                          config=EngineConfig(steps=2, batch=4,
                                              precision=prec, log_every=10,
                                              telemetry=False))
        eng.run()
        eng.save(str(tmp / f"ck-{tag}"), block=True)
    cfg = RefEngine(WM).cfg
    ds = WeatherDataset(WeatherDataConfig(
        lat=cfg.wm_lat, lon=cfg.wm_lon, channels=cfg.wm_channels, seed=3))
    fields = np.asarray(ds.sample_batch(0, 5)["fields"])
    np.save(tmp / "fields.tmp.npy", fields)
    os.replace(tmp / "fields.tmp.npy", tmp / "fields.npy")
    out = {}
    for nd in SIZES:
        se = RefEngine(WM, ckpt=str(tmp / "ck-fp32"), mesh_data=nd,
                       config=RefServeConfig(buckets=(2, 4)))
        out[f"fp32/{nd}"] = np.stack(
            [np.asarray(r.result()) for r in se.serve(fields, LEADS)])
    for prec in ("bf16", "fp32"):
        se = RefEngine(WM, ckpt=str(tmp / "ck-bf16"), mesh_data=4,
                       config=RefServeConfig(buckets=(2, 4),
                                             precision=prec))
        out[f"bf16ck/{prec}"] = np.stack(
            [np.asarray(r.result(), np.float32)
             for r in se.serve(fields, LEADS)])
    np.savez(path, **out)


def _serve(eng, fields, leads):
    """Rank 0 serves and returns the final outputs; the others follow."""
    if eng.rank == 0:
        reqs = eng.serve(fields, leads)
        eng.close()
        return np.stack([np.asarray(r.result(), np.float32) for r in reqs])
    eng.serve_worker()
    return None


def _grow(eng, fields):
    """A request alone for a step, then three joining it: buckets 1 -> 2
    -> 4 (rows moving between ranks where the split changes)."""
    if eng.rank != 0:
        eng.serve_worker()
        return None
    reqs = [eng.submit(fields[0], 4)]
    assert eng.step_once() == "step"
    reqs += [eng.submit(fields[i], 4) for i in (1, 2, 3)]
    eng.drain()
    eng.close()
    assert eng.sched.counters["grown"] == 2
    return np.stack([r.result() for r in reqs])


def _rank_main(rank, init, out_dir):
    import torch.distributed as dist
    from repro_torch.core import comm
    torch.set_num_threads(1)
    out = Path(out_dir)
    res = {"ij": np.array([rank])}
    for tag in ("fp32", "bf16"):
        _wait_for(out / f"ck-{tag}" / "manifest.json")
    _wait_for(out / "fields.npy")
    fields = np.load(out / "fields.npy")
    for n in SIZES:
        if rank >= n:
            continue
        if n > 1:
            dist.init_process_group("gloo", init_method=f"file://{out}/"
                                    f"store{n}", rank=rank, world_size=n)
        eng = ForecastEngine(WM, ckpt=str(out / "ck-fp32"), mesh_data=n,
                             device="cpu",
                             config=ServeConfig(buckets=(2, 4)))
        warm = eng.warmup()
        res[f"restored_step/{n}"] = np.array(eng.restored_step)
        if rank == 1:
            try:
                eng.submit(fields[0], 1)
            except RuntimeError:
                res["submit_raises"] = np.array(True)
        got = _serve(eng, fields, LEADS)
        if got is not None:
            res[f"fp32/{n}"] = got
        res[f"setups_after_warmup/{n}"] = np.array(
            eng.stats["compiles"] - warm)
        res[f"device_steps/{n}"] = np.array(eng.stats["device_steps"])
        comm.through_host.clear()
        eng = ForecastEngine(WM, mesh_data=n, device="cpu",
                             config=ServeConfig(buckets=(1, 2, 4), seed=5))
        eng.warmup()
        got = _grow(eng, fields)
        if got is not None:
            res[f"grow/{n}"] = got
        res[f"grow_moves/{n}"] = np.array(comm.through_host["grow/serve"])
        if n > 1:
            dist.destroy_process_group()
    # the bf16 checkpoint on four ranks, served at bf16 and cast to fp32
    dist.init_process_group("gloo", init_method=f"file://{out}/store_bf16",
                            rank=rank, world_size=4)
    for prec in ("bf16", "fp32"):
        eng = ForecastEngine(WM, ckpt=str(out / "ck-bf16"), mesh_data=4,
                             device="cpu", config=ServeConfig(
                                 buckets=(2, 4), precision=prec))
        res[f"bf16ck/{prec}/dtype"] = np.array(
            str(eng.params["encoder"]["w"].dtype))
        eng.warmup()
        got = _serve(eng, fields, LEADS)
        if got is not None:
            res[f"bf16ck/{prec}"] = got
    dist.destroy_process_group()
    np.savez(out / f"rank{rank}.npz", **res)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    runs = Launched(tmp_path_factory.mktemp("serve_data"), __file__,
                    ranks=4, devices=8)
    yield runs
    runs.close()


@pytest.fixture(scope="module")
def ranks(launched):
    return {k[0]: v for k, v in launched.rank_results().items()}


@pytest.fixture(scope="module")
def reference(launched):
    return launched.reference()


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_outputs_agree_across_data_sizes(ranks):
    one = ranks[0]["fp32/1"]
    assert one.shape[0] == len(LEADS) and np.isfinite(one).all()
    for n in (2, 4):
        np.testing.assert_allclose(ranks[0][f"fp32/{n}"], one, rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("n", SIZES)
def test_matches_reference_engine_on_its_checkpoint(ranks, reference, n):
    """The reference's (model 4 x data 2) checkpoint served by both
    packages' engines on a data mesh of n."""
    assert int(ranks[0][f"restored_step/{n}"]) == 2
    np.testing.assert_allclose(ranks[0][f"fp32/{n}"],
                               reference[f"fp32/{n}"], rtol=TOL, atol=TOL)


def test_bf16_checkpoint_served_at_bf16_and_fp32(ranks, reference):
    r0 = ranks[0]
    assert str(r0["bf16ck/bf16/dtype"]) == "torch.bfloat16"
    assert str(r0["bf16ck/fp32/dtype"]) == "torch.float32"
    np.testing.assert_allclose(r0["bf16ck/bf16"], r0["bf16ck/fp32"],
                               rtol=0.1, atol=0.1)
    np.testing.assert_allclose(r0["bf16ck/fp32"], reference["bf16ck/fp32"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(r0["bf16ck/bf16"], reference["bf16ck/bf16"],
                               rtol=0.1, atol=0.1)


def test_no_setups_after_warmup_on_any_rank(ranks):
    for rank, res in ranks.items():
        for n in SIZES:
            if rank < n:
                assert int(res[f"setups_after_warmup/{n}"]) == 0
                # every rank ran every step of rank 0's schedule
                assert int(res[f"device_steps/{n}"]) == \
                    int(ranks[0][f"device_steps/{n}"])


def test_submit_on_rank_1_raises(ranks):
    assert bool(ranks[1]["submit_raises"])


def test_grow_moves_rows_between_ranks(ranks):
    """Buckets 1 -> 2 -> 4: at two ranks the 2 -> 4 grow sends rank 1's
    row to rank 0 (each side counts it); at four, buckets 1 and 2 are
    whole everywhere and 4 is cut, so no row moves.  The outputs agree
    with one rank's."""
    one = ranks[0]["grow/1"]
    for n in (2, 4):
        np.testing.assert_allclose(ranks[0][f"grow/{n}"], one, rtol=TOL,
                                   atol=TOL)
    assert [int(ranks[r]["grow_moves/2"]) for r in (0, 1)] == [1, 1]
    assert all(int(ranks[r]["grow_moves/4"]) == 0 for r in range(4))


def test_state_spec_is_the_reference_sanitize_rule():
    from jax.sharding import PartitionSpec as P
    from repro.launch.specs import sanitize_spec as ref_sanitize

    class FakeMesh:
        def __init__(self, n):
            self.shape = {"data": n}

    for n in (1, 2, 3, 4):
        for b in range(1, 9):
            want = tuple(ref_sanitize((b, 16, 32, 8), P("data"),
                                      FakeMesh(n)))
            assert state_spec(b, FakeMesh(n)) == want


def test_mesh_data_needs_that_many_ranks(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        launch_serve.serve(WM, mesh_data=2, device="cpu", requests=1)
    with pytest.raises(RuntimeError, match="step_once runs on rank 0"):
        eng = ForecastEngine(WM, device="cpu")
        eng.rank = 1
        eng.step_once()


def test_cli_mesh_data_2_under_torchrun(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--mesh-data", "2", "--device", "cpu", "--requests", "6",
         "--leads", "1,2,3", "--buckets", "1,2,4"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        capture_output=True, text=True, cwd=tmp_path, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [x for x in proc.stdout.splitlines() if x.startswith("[serve]")]
    # rank 0 alone prints the report
    assert sum("requests in" in x for x in lines) == 1
    assert any("x2" in x and "graphs=False" in x for x in lines)
    assert any("6 requests" in x and "0 post-warmup" in x for x in lines)


if __name__ == "__main__":
    if sys.argv[1] == "--reference":
        _reference_main(sys.argv[2])
    else:
        _rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
