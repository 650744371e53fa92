"""The port's per-rank (sharded) reads: each rank of a 2-D or 1-D mesh reads
only its block of the batch (``data/pipeline.py``'s read plans).

The block must be bit-equal to what ``weathermixer.field_block`` cuts from
the whole batch, for every rank, including grids whose token band is not
whole patch rows (lat 20, lon 24, patch 4: 30 tokens, 15 per band of the
2x2 mesh) and patch dims whose cut is not whole in-patch rows; the bytes a
rank reads are 1/q**2 (1/p) of the batch's.  End to end, ``TrainEngine``
with ``pipeline="sharded"`` and ``"sync-full"`` gives identical five-step
histories on a 2x2 mesh and on two 1-D ranks: four (two) gloo processes,
this file run as a script with ``--rank``, joined through a ``file://``
store in the test's temporary directory.  Everything is compared bit for
bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.sharding import RULES_1D, RULES_2D, Mesh, Mesh1D
from repro_torch.data.pipeline import _boxes, make_pipeline
from repro_torch.data.weather import WeatherDataConfig, WeatherDataset
from repro_torch.launch.shapes import jigsaw_for
from repro_torch.launch.specs import batch_specs, block_specs
from repro_torch.models import weathermixer as W

ROOT = Path(__file__).resolve().parents[1]
HIST_KEYS = ("loss", "grad_norm", "lr")


def _cfg(lat=20, lon=24, channels=4, patch=4, scheme="2d"):
    return get_config("weathermixer-1b").reduced().replace(
        wm_lat=lat, wm_lon=lon, wm_channels=channels, wm_patch=patch,
        d_model=32, wm_d_tok=32, wm_d_ch=32, n_layers=1, scheme=scheme,
        kernel="pallas")


def _meshes(scheme, n):
    if scheme == "2d":
        q = int(round(n ** 0.5))
        return [Mesh(q=q, i=r // q, j=r % q) for r in range(n)]
    return [Mesh1D(p=n, r=r) for r in range(n)]


# ---------------------------------------------------------------------------
# the boxes of a flat range
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 6), (4, 4, 3), (3, 2, 5), (7,)])
def test_boxes_cover_the_range_in_order(shape):
    """Every [lo, hi) of a row-major array, as boxes: their elements, in
    row-major order within each box and box after box, are the range."""
    n = int(np.prod(shape))
    for lo in range(n):
        for hi in range(lo, n + 1):
            flat = []
            for box in _boxes(lo, hi, shape):
                grids = np.meshgrid(*[np.arange(a, b) for a, b in box],
                                    indexing="ij")
                flat += list(np.ravel_multi_index(grids, shape).reshape(-1))
            assert flat == list(range(lo, hi)), (lo, hi)


# ---------------------------------------------------------------------------
# a rank's block against field_block of the whole batch
# ---------------------------------------------------------------------------

# (lat, lon, channels, patch): whole patch rows per band (16 x 32, patch
# 4: 32 tokens); bands of 15 tokens, two and a half patch rows (20 x 24,
# patch 4: 30 tokens); a patch dim cut at 1.5 in-patch rows (6 x 6, patch
# 3, 2 channels: patch dim 18, 9 per rank of the 2x2 mesh or of two 1-D
# ranks)
GRIDS = [(16, 32, 4, 4), (20, 24, 4, 4), (6, 6, 2, 3)]
CASES = [(grid, scheme, n) for grid in GRIDS
         for scheme, n in (("2d", 1), ("2d", 4), ("1d", 2), ("1d", 4))
         if grid[3] ** 2 * grid[2] % (n if scheme == "1d" else 2) == 0]


@pytest.mark.parametrize("grid,scheme,n", CASES)
def test_sharded_block_is_field_block_bit_for_bit(grid, scheme, n):
    """Every rank's sharded block of fields and target is field_block of
    the whole batch, bit for bit; a rank reads 1/n of the batch's bytes per
    key (the modeled io_bytes_per_rank); the plan is built once."""
    lat, lon, chans, patch = grid
    cfg = _cfg(lat, lon, chans, patch, scheme)
    ds = WeatherDataset(WeatherDataConfig(lat=lat, lon=lon, channels=chans))
    whole = ds.sample_batch(3, 2, horizon=2)
    for mesh in _meshes(scheme, n):
        pipe = make_pipeline(cfg, batch_size=2, mode="sharded", prefetch=0,
                             device="cpu", mesh=mesh)
        jcfg = jigsaw_for(cfg).replace(mesh=mesh)
        for step in (3, 3):         # the second read is the memo's
            got = pipe.get(step, 2)
            for k in ("fields", "target"):
                want = W.field_block(torch.from_numpy(whole[k]), cfg, jcfg)
                assert got[k].shape == want.shape
                assert torch.equal(got[k], want), (mesh, k)
        per_rank = {k: v[pipe.rank] for k, v in
                    pipe.stats.rank_bytes.items()}
        assert per_rank == {k: 2 * whole[k].nbytes // n
                            for k in ("fields", "target")}
        assert per_rank["fields"] == 2 * pipe.io_bytes_per_rank(n)
        assert pipe.stats.plan_builds == 1 and pipe.stats.steps == 2


@pytest.mark.parametrize("mode", ["sharded", "sync-full"])
def test_one_device_reads_the_whole_batch(mode):
    """Without a mesh both modes hand over the whole batch, and a
    whole-batch read on a mesh is recorded against rank -1."""
    cfg = _cfg()
    ds = WeatherDataset(WeatherDataConfig(lat=20, lon=24, channels=4))
    want = ds.sample_batch(1, 2, horizon=1)
    got = make_pipeline(cfg, batch_size=2, mode=mode, prefetch=0,
                        device="cpu").get(1, 1)
    assert all(np.array_equal(got[k].numpy(), want[k]) for k in want)
    mesh = Mesh(q=2, i=1, j=0)
    pipe = make_pipeline(cfg, batch_size=2, mode="sync-full", prefetch=0,
                         device="cpu", mesh=mesh)
    assert pipe.get(1, 1)["fields"].shape == (2, 20, 24, 4)
    assert set(pipe.stats.rank_bytes["fields"]) == {-1}


def test_batch_specs_are_the_model_layout():
    """The spec of a rank's block of the patchified fields
    (``block_specs``) is the activations': the batch dim over the data
    axis, tokens over mdom and the patch dim over mtp (2-D), the patch dim
    over the model axis (1-D); ``batch_specs`` is the reference's over the
    grid.  A language model's blocks are its rows."""
    cfg = _cfg()
    data = ("data",)
    assert block_specs(cfg, RULES_2D) == {"fields": (data, "mdom", "mtp"),
                                          "target": (data, "mdom", "mtp")}
    assert block_specs(cfg, RULES_1D)["fields"] == (data, None, "model")
    assert batch_specs(cfg, RULES_2D)["fields"] == (data, None, "mdom",
                                                    "mtp")
    rows = (data, None)
    assert batch_specs(get_config("internlm2-1.8b"), RULES_2D) == \
        block_specs(get_config("internlm2-1.8b"), RULES_2D) == \
        {"tokens": rows, "labels": rows}


def test_indexed_reads_match_slices_of_the_batch():
    """sample_index: each box of index arrays (not slices) is the batch at
    those points, the noise drawn once for all boxes."""
    ds = WeatherDataset(WeatherDataConfig(lat=12, lon=16, channels=5,
                                          seed=4))
    whole = ds.sample_batch(2, 3, horizon=3)
    boxes = [(np.array([0, 1, 5, 11]), np.array([3, 4, 15]),
              np.array([4, 0])), (np.arange(12), np.arange(16), np.arange(5))]
    got = ds.sample_index(2, 3, boxes, horizon=3, rows=slice(1, 3))
    for (lat, lon, ch), g in zip(boxes, got):
        for k in ("fields", "target"):
            assert np.array_equal(g[k], whole[k][1:3][np.ix_(
                np.arange(2), lat, lon, ch)])


# ---------------------------------------------------------------------------
# sharded against sync-full histories, on gloo ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, n, scheme, init, out_dir):
    """One rank: five training steps of the 20 x 24 grid under each mode,
    from the same seed; histories and the bytes this rank read."""
    import torch.distributed as dist
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n)
    res = {}
    for mode in ("sharded", "sync-full"):
        eng = TrainEngine(
            "weathermixer-1b", reduced=False, mesh_model=n, scheme=scheme,
            impl="ring_fused" if scheme == "1d" else None,
            config_override=_cfg(scheme=scheme), device="cpu",
            config=EngineConfig(steps=5, batch=2, rollout=2, log_every=1,
                                prefetch=2 if mode == "sharded" else 0,
                                telemetry=False, seed=0, pipeline=mode))
        hist = eng.run()
        res[mode] = {"hist": [{k: h[k] for k in HIST_KEYS} for h in hist],
                     "bytes": {k: v for k, v in
                               eng.pipeline.stats.rank_bytes.items()},
                     "rank": eng.pipeline.rank}
        eng.close()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    dist.destroy_process_group()


@pytest.mark.parametrize("scheme,n", [("2d", 4), ("1d", 2)])
def test_sharded_and_sync_full_histories_identical(tmp_path, scheme, n):
    """pipeline="sharded" and "sync-full" train to the same five-step
    history bit for bit (rollouts up to 2, prefetch on for the sharded
    run); under sharded each rank reads 1/n of each key's bytes per step,
    under sync-full the whole batch."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), str(n), scheme,
         f"file://{tmp_path / 'store'}", str(tmp_path)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    res = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(n)]
    cfg = _cfg(scheme=scheme)
    whole = 5 * 2 * cfg.wm_lat * cfg.wm_lon * cfg.wm_channels * 4
    for r, x in enumerate(res):
        assert x["sharded"]["hist"] == x["sync-full"]["hist"] == \
            res[0]["sharded"]["hist"]
        assert len(x["sharded"]["hist"]) == 5
        rank = str(x["sharded"]["rank"])
        for k in ("fields", "target"):
            assert x["sharded"]["bytes"][k] == {rank: whole // n}
            assert x["sync-full"]["bytes"][k] == {"-1": whole}
    assert sorted(int(x["sharded"]["rank"]) for x in res) == list(range(n))


if __name__ == "__main__":
    _, _, rank, n, scheme, init, out = sys.argv
    _rank_main(int(rank), int(n), scheme, init, out)
