"""The port's sharded checkpoints (``repro_torch.checkpoint``) on one
process, and the on-disk format against the JAX package's.

* The reference's ``tests/test_checkpoint.py``, case for case where it
  concerns the checkpoint modules: the facade, bf16, the snapshot's copy
  (a tensor updated in place after the save, as the port's Adam does),
  leaf validation with key paths, the manifest, cross-shard reassembly,
  the async writer (overlap, in-flight guard, errors, retries, pruning),
  atomic writes, ``latest_checkpoint``, per-process index fragments, the
  engine's exact resume, keep-last-k GC, the best marker and the prune
  backlog.
* The format both ways, bit for bit (bf16 compared as bits): params and
  Adam state (mu, nu, master, step) under fp32 and bf16, written by the
  reference's ``save_checkpoint`` and read by the port's ``restore_tree``
  and the other way round; the npz members byte for byte and the
  manifests equal; bf16 on disk as ``|V2``.
* Engines across packages: a reference checkpoint served by the port's
  ``ForecastEngine(ckpt=)`` within 1e-5 of the reference's (fp32, as
  ``test_torch_serve.py``); a port checkpoint resumed by the reference's
  ``TrainEngine(resume=)`` within 1e-4 relative of the port's own history
  (as ``test_torch_train.py``).

Meshes (gloo ranks, the reference's (data 2, model 4)) are in
``test_torch_checkpoint_mesh.py``.
"""
import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.checkpoint import sharded as ref_sharded
from repro.configs.registry import get_config as ref_get_config
from repro.core import precision as ref_precision
from repro.models import weathermixer as RW
from repro.optim import adam as ref_adam
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.checkpoint import manifest as MF
from repro_torch.checkpoint import sharded
from repro_torch.checkpoint.writer import AsyncCheckpointWriter
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import tree as ptree
from repro_torch.launch.engine import EngineConfig, TrainEngine
from repro_torch.serve.engine import ForecastEngine, ServeConfig

HIST_KEYS = ("loss", "grad_norm", "lr")


def _params():
    return {"layer": {"w": torch.arange(12.0).reshape(3, 4),
                      "b": torch.zeros((4,), dtype=torch.float32)},
            "embed": {"table": torch.ones((4, 2))},
            "blend": torch.arange(3, dtype=torch.int32)}


def _bits(t):
    """A tensor's bits as numpy (bf16 as uint16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _ref_bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _same(a, b) -> bool:
    """Bit for bit, dtype included (tensors, arrays, ints)."""
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and \
            np.array_equal(_bits(a), _bits(b))
    return a == b


def _trees_equal(a, b) -> bool:
    la, lb = ptree.leaves(a), ptree.leaves(b)
    return len(la) == len(lb) and all(_same(x, y) for x, y in zip(la, lb))


def _engine(**kw):
    """The reduced weathermixer-1b on the CPU, four steps of r in {1, 2}."""
    return TrainEngine("weathermixer-1b", device="cpu", config=EngineConfig(
        steps=kw.pop("steps", 4), batch=2, log_every=kw.pop("log_every", 1),
        rollout=2, prefetch=0, **kw))


# -- facade ------------------------------------------------------------

def test_facade_roundtrip_layout_and_meta(tmp_path):
    from repro_torch.optim import adam
    params = _params()
    opt = adam.init(params, adam.AdamConfig())
    path = str(tmp_path / "ck")
    ckpt_io.save(path, params, opt, step=42, extra={"arch": "t"})
    # layout: manifest + one shard file for the single rank
    assert sorted(os.listdir(path)) == ["manifest.json", "shard-d00000.npz"]
    man = ckpt_io.load_manifest(path)
    assert man.step == 42 and man.extra["arch"] == "t"
    assert set(man.groups) == {"params", "opt_state"}
    p2, o2, step = ckpt_io.restore(path, like_params=params, like_opt=opt)
    assert step == 42 and o2["step"] == 0 and isinstance(o2["step"], int)
    assert _trees_equal(p2, params)         # int32 leaf survives
    groups, step, extra = sharded.restore_checkpoint(
        path, {"params": params, "opt_state": opt})
    assert step == 42 and extra == {"arch": "t"}
    assert _trees_equal(groups["params"], params)
    assert _trees_equal(groups["opt_state"], opt)


@pytest.mark.parametrize("reassemble", [False, True])
def test_bfloat16_roundtrip(tmp_path, reassemble):
    """bf16 survives the exact-match path and the slow path (a slice
    assembled across two shard files), as raw |V2 on disk."""
    full = torch.arange(16, dtype=torch.bfloat16).reshape(4, 4) / 3
    path = str(tmp_path / "ck")
    if not reassemble:
        ckpt_io.save(path, {"w": full, "s": torch.tensor(2.0)}, step=7)
        p2, _, step = ckpt_io.restore(path)
        assert step == 7 and _same(p2["w"], full)
        raw = np.load(os.path.join(path, "shard-d00000.npz"))["params/w#0"]
        assert raw.dtype == np.dtype("V2")
        return
    bits = _bits(full).view(np.dtype("V2"))
    shards = (MF.ShardEntry("shard-d00000.npz", "params/w#0",
                            ((0, 2), (0, 4)), 0),
              MF.ShardEntry("shard-d00001.npz", "params/w#0",
                            ((2, 4), (0, 4)), 1))
    entry = MF.LeafEntry((4, 4), "bfloat16", [None, None], shards)
    man = MF.Manifest(step=0, groups={"params": {"w": entry}})
    blobs = {"shard-d00000.npz": {"params/w#0": bits[:2]},
             "shard-d00001.npz": {"params/w#0": bits[2:]}}
    sharded.write_snapshot(sharded.Snapshot(man, blobs, {}), path)
    got = sharded._ShardReader(path).read(entry, ((1, 3), (0, 4)))
    assert np.array_equal(got, _bits(full)[1:3])
    assert _same(sharded._tensor(got, "bfloat16"), full[1:3])


@pytest.mark.parametrize("leaf", ["numpy", "tensor", "layers"])
def test_snapshot_copies_leaves(tmp_path, leaf):
    """The snapshot captures values at submit time even when the caller
    updates its leaves in place afterwards -- a CPU tensor's ``.numpy()``
    would alias, and the port's Adam updates with ``copy_``."""
    if leaf == "numpy":
        x = np.arange(6.0)
        tree = {"x": x}
    elif leaf == "tensor":
        x = torch.arange(6.0)
        tree = {"x": x}
    else:
        x = torch.arange(6.0)
        tree = {"blocks": [{"x": x}, {"x": torch.zeros(6)}]}
    snap = sharded.snapshot({"params": tree}, step=0)
    x *= 100.0
    path = str(tmp_path / "ck")
    sharded.write_snapshot(snap, path)
    got, _, _ = ckpt_io.restore(path)
    got = got["x"] if leaf != "layers" else got["blocks"][0]["x"]
    assert np.array_equal(np.asarray(got), np.arange(6.0))


@pytest.mark.parametrize("bad,match", [
    ("shape", r"params\[/layer/w\].*shape"),
    ("dtype", r"params\[/blend\].*dtype"),
    ("keys", "key mismatch")])
def test_restore_validates_with_keypath(tmp_path, bad, match):
    path = str(tmp_path / "ck")
    ckpt_io.save(path, _params(), step=1)
    like = _params()
    if bad == "shape":
        like["layer"]["w"] = torch.zeros((3, 5))
    elif bad == "dtype":
        like["blend"] = like["blend"].float()
    else:
        like = {"w": torch.zeros((3, 3))}
    with pytest.raises(ValueError, match=match):
        ckpt_io.restore(path, like_params=like)


def test_restore_missing_manifest(tmp_path):
    with pytest.raises(FileNotFoundError, match="manifest"):
        ckpt_io.restore(str(tmp_path / "nope"))


# -- manifest ----------------------------------------------------------

def test_spec_serde_roundtrip():
    for spec in [(), (None, "model"), (("data", "model"), None),
                 ("data", None, "mtp")]:
        assert MF.spec_from_json(MF.spec_to_json(spec)) == spec


def test_manifest_rejects_foreign_format(tmp_path):
    path = str(tmp_path / "ck")
    os.makedirs(path)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"format": "not-a-ckpt"}, f)
    with pytest.raises(ValueError, match="format"):
        ckpt_io.load_manifest(path)


def test_dtype_table_names_every_torch_dtype_the_trees_hold():
    """The manifest's dtype names without ml_dtypes: each torch dtype of
    a parameter or optimizer tree maps to a name and back, and bf16's
    bits are held in uint16."""
    for t in (torch.float32, torch.bfloat16, torch.int32, torch.float16):
        name = MF.dtype_name(t)
        assert MF.dtype_entry(name)[0] is t
        assert np.dtype(MF.dtype_entry(name)[1]).itemsize == t.itemsize
    assert MF.dtype_name(torch.bfloat16) == "bfloat16"
    with pytest.raises(ValueError, match="complex"):
        MF.dtype_entry("complex64")


# -- cross-shard reassembly (the resharding kernel of restore) ---------

def _two_shard_checkpoint(path):
    """Hand-built checkpoint: leaf (4, 4) saved as two row shards, the
    layout a 2-way mesh writes."""
    full = np.arange(16, dtype=np.float32).reshape(4, 4)
    shards = (MF.ShardEntry("shard-d00000.npz", "params/w#0",
                            ((0, 2), (0, 4)), 0),
              MF.ShardEntry("shard-d00001.npz", "params/w#0",
                            ((2, 4), (0, 4)), 1))
    entry = MF.LeafEntry((4, 4), "float32", [None, None], shards)
    man = MF.Manifest(step=0, groups={"params": {"w": entry}})
    blobs = {"shard-d00000.npz": {"params/w#0": full[:2]},
             "shard-d00001.npz": {"params/w#0": full[2:]}}
    sharded.write_snapshot(sharded.Snapshot(man, blobs, {}), path)
    return full, entry


def test_reader_reassembles_cross_shard_slices(tmp_path):
    path = str(tmp_path / "ck")
    full, entry = _two_shard_checkpoint(path)
    rd = sharded._ShardReader(path)
    # a slice crossing the shard boundary (what a resharded mesh asks for)
    assert np.array_equal(rd.read(entry, ((1, 3), (1, 4))), full[1:3, 1:4])
    # exact shard fast path and full read
    assert np.array_equal(rd.read(entry, ((0, 2), (0, 4))), full[:2])
    assert np.array_equal(rd.read(entry, ((0, 4), (0, 4))), full)


@pytest.mark.parametrize("fault", ["lost_shard", "overlap", "missing_file"])
def test_reader_detects_holes(tmp_path, fault):
    """Coverage is a boolean mask, not a volume sum: a lost shard, or two
    overlapping shards that leave a hole, raise instead of returning
    np.empty garbage; a missing shard file names itself."""
    path = str(tmp_path / "ck")
    full, entry = _two_shard_checkpoint(path)
    if fault == "lost_shard":
        entry = MF.LeafEntry(entry.shape, entry.dtype, entry.spec,
                             entry.shards[:1])
    elif fault == "overlap":
        entry = MF.LeafEntry(entry.shape, entry.dtype, entry.spec,
                             (entry.shards[0], entry.shards[0]))
    else:
        os.remove(os.path.join(path, "shard-d00001.npz"))
    rd = sharded._ShardReader(path)
    err = FileNotFoundError if fault == "missing_file" else ValueError
    with pytest.raises(err, match="shard" if err is FileNotFoundError
                       else "cover"):
        rd.read(entry, ((0, 4), (0, 4)))


# -- async writer ------------------------------------------------------

class _SlowWriter:
    """Instrumented write_fn: records concurrency and completion, and
    holds the write open for ``delay`` seconds."""

    def __init__(self, delay=0.0):
        self.delay = delay
        self.active = 0
        self.max_active = 0
        self.done = []
        self._lock = threading.Lock()

    def __call__(self, snap, path):
        with self._lock:
            self.active += 1
            self.max_active = max(self.max_active, self.active)
        time.sleep(self.delay)
        sharded.write_snapshot(snap, path)
        with self._lock:
            self.active -= 1
            self.done.append(path)


def test_async_writer_overlaps_and_snapshots(tmp_path):
    """The save (a) returns while the write is still in flight and (b)
    captures the values at submit time, immune to a later in-place
    update."""
    slow = _SlowWriter(delay=0.5)
    w = AsyncCheckpointWriter(write_fn=slow)
    params = {"w": torch.arange(8.0)}
    path = str(tmp_path / "ck")
    w.save(path, {"params": params}, step=3)
    assert w.in_flight                       # returned before the write
    params["w"].mul_(2.0)                    # "one train step", in place
    assert w.in_flight
    w.wait()
    assert not w.in_flight and slow.done == [path]
    got, _, step = ckpt_io.restore(path)
    assert step == 3
    assert np.array_equal(got["w"].numpy(), np.arange(8.0))


def test_async_writer_in_flight_guard(tmp_path):
    """At most one write in flight: a second save waits for the first,
    and both land completely."""
    slow = _SlowWriter(delay=0.2)
    w = AsyncCheckpointWriter(write_fn=slow)
    p1, p2 = str(tmp_path / "a"), str(tmp_path / "b")
    w.save(p1, {"params": {"x": torch.zeros(4)}}, step=1)
    w.save(p2, {"params": {"x": torch.ones(4)}}, step=2)   # guard: waits
    w.wait()
    assert slow.max_active == 1
    assert slow.done == [p1, p2]
    assert ckpt_io.restore(p1)[2] == 1 and ckpt_io.restore(p2)[2] == 2


def test_async_writer_raises_write_errors_at_wait(tmp_path):
    def boom(snap, path):
        raise IOError("disk full")
    w = AsyncCheckpointWriter(write_fn=boom)
    w.save(str(tmp_path / "ck"), {"params": {"x": torch.zeros(2)}})
    with pytest.raises(IOError, match="disk full"):
        w.wait()
    w.wait()                                  # error consumed; reusable


@pytest.mark.parametrize("case", ["transient", "exhausted", "bug"])
def test_writer_retries_only_transient_oserrors(tmp_path, case):
    """Jittered retries on OSError up to the budget; any other error is a
    bug and surfaces after one attempt."""
    calls = []

    def write(snap, path):
        calls.append(path)
        if case == "bug":
            raise ValueError("not weather, a bug")
        if case == "exhausted" or len(calls) < 3:
            raise OSError("EIO: nfs blip")
        sharded.write_snapshot(snap, path)

    w = AsyncCheckpointWriter(write_fn=write, retries=3,
                              retry_backoff=0.01)
    path = str(tmp_path / "ck")
    w.save(path, {"params": {"x": torch.arange(4.0)}}, step=9)
    if case == "transient":
        w.wait()                              # the 3rd attempt won
        assert len(calls) == 3 and ckpt_io.restore(path)[2] == 9
        return
    with pytest.raises(ValueError if case == "bug" else OSError):
        w.wait()
    assert len(calls) == (1 if case == "bug" else 3)


def test_writer_prunes_only_after_write(tmp_path):
    """AsyncCheckpointWriter.save(prune=...) deletes the old dirs only
    once the new checkpoint is durable (manifest present)."""
    old = tmp_path / "old"
    old.mkdir()
    (old / "x").write_text("stale")
    seen = {}

    def slow_write(snap, path):
        seen["old_alive_during_write"] = old.exists()
        sharded.write_snapshot(snap, path)

    w = AsyncCheckpointWriter(write_fn=slow_write)
    w.save(str(tmp_path / "new"), {"g": {"a": torch.arange(4)}},
           prune=[str(old)])
    w.wait()
    assert seen["old_alive_during_write"]    # not pruned before
    assert not old.exists()                  # pruned after
    assert os.path.exists(tmp_path / "new" / "manifest.json")


def test_writer_spans(tmp_path):
    """The writer reports ``ckpt.write`` on its own thread."""
    from repro_torch import telemetry
    tr = telemetry.Tracer()
    prev = telemetry.set_tracer(tr)
    try:
        w = AsyncCheckpointWriter()
        w.save(str(tmp_path / "ck"), {"params": {"x": torch.zeros(3)}})
        w.wait()
    finally:
        telemetry.set_tracer(prev)
    ev = [e for e in tr.chrome_events() if e.get("name") == "ckpt.write"]
    assert len(ev) == 1 and ev[0]["tid"] != threading.get_ident()


# -- crash-safe shard writes -------------------------------------------

def test_shard_writes_are_atomic(tmp_path, monkeypatch):
    """A process killed mid-npz-write never leaves a truncated shard at
    the final name: the payload goes to ``.tmp`` and is renamed."""
    params = {"w": torch.arange(8.0)}
    path = str(tmp_path / "ck")
    real_replace = os.replace

    def no_replace(src, dst):
        raise OSError("killed before rename")

    monkeypatch.setattr(os, "replace", no_replace)
    with pytest.raises(OSError, match="killed"):
        sharded.save_checkpoint(path, {"params": params})
    monkeypatch.setattr(os, "replace", real_replace)
    names = sorted(os.listdir(path))
    assert all(n.endswith(".tmp") for n in names), names
    assert not sharded.checkpoint_complete(path)
    sharded.save_checkpoint(path, {"params": params})
    names = sorted(os.listdir(path))
    assert not any(n.endswith(".tmp") for n in names), names
    assert sharded.checkpoint_complete(path)


def test_manifest_written_last(tmp_path, monkeypatch):
    """Every shard file a manifest references exists by the time the
    manifest does."""
    order = []
    real = sharded._write_npz_atomic
    real_save = MF.Manifest.save

    def spy(fname, members):
        order.append(os.path.basename(fname))
        real(fname, members)

    def spy_save(self, path):
        order.append("manifest.json")
        real_save(self, path)

    monkeypatch.setattr(sharded, "_write_npz_atomic", spy)
    monkeypatch.setattr(MF.Manifest, "save", spy_save)
    snap = sharded.snapshot({"params": {"w": torch.arange(4.0)}})
    sharded.write_snapshot(snap, str(tmp_path / "ck"))
    assert order == ["shard-d00000.npz", "manifest.json"]


# -- latest_checkpoint discovery ---------------------------------------

def _mini_ckpt(path, step):
    sharded.save_checkpoint(str(path),
                            {"params": {"w": torch.arange(4.0)}}, step=step)


def test_latest_checkpoint_picks_newest_complete(tmp_path):
    assert sharded.latest_checkpoint(str(tmp_path)) is None  # cold start
    _mini_ckpt(tmp_path / "ck-2", 2)
    _mini_ckpt(tmp_path / "ck-5", 5)
    assert sharded.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ck-5")
    # by manifest STEP, not directory name ordering
    _mini_ckpt(tmp_path / "ck-10", 3)
    assert sharded.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ck-5")


def test_latest_checkpoint_skips_torn_saves(tmp_path):
    _mini_ckpt(tmp_path / "ck-1", 1)
    torn = tmp_path / "ck-7"                 # shards, no manifest
    torn.mkdir()
    (torn / "shard-d00000.npz").write_bytes(b"partial")
    _mini_ckpt(tmp_path / "ck-9", 9)         # manifest, a shard gone
    os.remove(tmp_path / "ck-9" / "shard-d00000.npz")
    pod = tmp_path / "ck-11"                 # orphaned index fragment
    pod.mkdir()
    MF.Manifest(step=11, groups={}).save_index(str(pod), 1, 2)
    assert sharded.latest_checkpoint(str(tmp_path)) == str(tmp_path / "ck-1")
    for p in (torn, tmp_path / "ck-9", pod):
        assert not sharded.checkpoint_complete(str(p))


def test_latest_checkpoint_prefix_filter(tmp_path):
    _mini_ckpt(tmp_path / "ck-3", 3)
    _mini_ckpt(tmp_path / "other-8", 8)
    _mini_ckpt(tmp_path / "ckextra", 9)      # not ck or ck-*: excluded
    assert sharded.latest_checkpoint(str(tmp_path), prefix="ck") == \
        str(tmp_path / "ck-3")
    assert sharded.latest_checkpoint(str(tmp_path), prefix="other") == \
        str(tmp_path / "other-8")
    _mini_ckpt(tmp_path / "solo", 1)         # root itself can be one
    assert sharded.latest_checkpoint(str(tmp_path / "solo")) == \
        str(tmp_path / "solo")


# -- per-process index merge -------------------------------------------

def _fragment(step, fname, rows, full):
    shard = MF.ShardEntry(fname, "params/w#0", (rows, (0, 4)), 0)
    entry = MF.LeafEntry((4, 4), "float32", [None, None], (shard,))
    man = MF.Manifest(step=step, groups={"params": {"w": entry}})
    return sharded.Snapshot(man, {fname: {"params/w#0":
                                          full[rows[0]:rows[1]]}}, {})


def test_pod_save_merges_index_fragments(tmp_path):
    full = np.arange(16, dtype=np.float32).reshape(4, 4)
    path = str(tmp_path / "ck")
    f0 = _fragment(4, "shard-d00000.npz", (0, 2), full)
    f1 = _fragment(4, "shard-d00001.npz", (2, 4), full)
    # process 1 first: index fragment lands, manifest does not
    sharded.write_snapshot(f1, path, process_index=1, process_count=2)
    assert os.path.exists(os.path.join(path, MF.index_name(1)))
    assert not sharded.checkpoint_complete(path)
    # process 0: writes, waits for all fragments, merges, finalizes
    sharded.write_snapshot(f0, path, process_index=0, process_count=2)
    assert sharded.checkpoint_complete(path)
    man = ckpt_io.load_manifest(path)
    assert man.step == 4 and len(man.groups["params"]["w"].shards) == 2
    got = sharded.restore_tree(path, "params")
    assert np.array_equal(got["w"].numpy(), full)


def test_pod_finalize_times_out_on_missing_rank(tmp_path):
    full = np.arange(16, dtype=np.float32).reshape(4, 4)
    path = str(tmp_path / "ck")
    os.makedirs(path)
    _fragment(2, "shard-d00000.npz", (0, 2), full).manifest.save_index(
        path, 0, 3)
    with pytest.raises(TimeoutError, match="index-p00001"):
        sharded.finalize_checkpoint(path, 3, timeout=0.2, poll=0.02)
    assert not os.path.exists(os.path.join(path, MF.MANIFEST_NAME))


def test_merge_manifests_rejects_torn_pod_save():
    full = np.arange(16, dtype=np.float32).reshape(4, 4)
    f0 = _fragment(2, "shard-d00000.npz", (0, 2), full)
    f1 = _fragment(3, "shard-d00001.npz", (2, 4), full)   # step skew
    with pytest.raises(ValueError, match="torn pod save"):
        MF.merge_manifests([f0.manifest, f1.manifest])


def test_partition_snapshot_writes_each_rank_once(tmp_path):
    """A snapshot split by writing rank restores whole."""
    full = np.arange(16, dtype=np.float32).reshape(4, 4)
    f0 = _fragment(1, "shard-d00000.npz", (0, 2), full)
    f1 = _fragment(1, "shard-d00001.npz", (2, 4), full)
    e = MF.LeafEntry((4, 4), "float32", [None, None],
                     (f0.manifest.groups["params"]["w"].shards[0],
                      dataclasses.replace(
                          f1.manifest.groups["params"]["w"].shards[0],
                          device=1)))
    both = sharded.Snapshot(MF.Manifest(step=1, groups={"params": {"w": e}}),
                            {**f0.blobs, **f1.blobs}, {0: 32, 1: 32})
    parts = sharded.partition_snapshot(both, {0: 0, 1: 1})
    path = str(tmp_path / "ck")
    for pi in (1, 0):
        sharded.write_snapshot(parts[pi], path, process_index=pi,
                               process_count=2)
    assert parts[0].total_bytes == parts[1].total_bytes == 32
    got = sharded.restore_tree(path, "params")
    assert np.array_equal(got["w"].numpy(), full)


# -- pipeline cursor ---------------------------------------------------

def test_pipeline_cursor_tracks_and_restores():
    from repro_torch.data.pipeline import make_pipeline
    cfg = get_config("weathermixer-1b").reduced()
    pipe = make_pipeline(cfg, batch_size=2, prefetch=0, device="cpu")
    list(pipe.iterate([1, 1, 1]))
    assert pipe.state() == {"cursor": 3}
    fresh = make_pipeline(cfg, batch_size=2, prefetch=0, device="cpu")
    fresh.set_state({"cursor": 3})
    nxt = next(iter(fresh.iterate([2])))
    want = pipe.get(3, 2)
    assert all(torch.equal(nxt[k], want[k]) for k in want)


# -- engine: exact resume, GC, best marker, backlog --------------------

def test_engine_exact_resume(tmp_path):
    """A run checkpointed at loop index 2 (step 3, the async writer in
    the loop) and resumed gives the uninterrupted run's step 3 bit for
    bit, and ends with the same params and optimizer state as the
    interrupted run's final checkpoint."""
    path = str(tmp_path / "ck")
    h_full = _engine().run()
    run = _engine(ckpt=path, ckpt_every=2)
    h_ck = run.run()
    assert [{k: h[k] for k in HIST_KEYS} for h in h_ck] == \
        [{k: h[k] for k in HIST_KEYS} for h in h_full]
    resumed = _engine(resume=path + "-2")
    assert resumed.step_idx == 3 and resumed.pipeline.state() == \
        {"cursor": 3} and resumed.opt_state["step"] == 3
    h_res = resumed.run()
    assert len(h_res) == 1 and all(h_res[0][k] == h_full[3][k]
                                   for k in HIST_KEYS)
    assert _trees_equal(resumed.params, run.params)
    assert _trees_equal(resumed.opt_state, run.opt_state)
    final = sharded.restore_tree(path, "params", like=run.params)
    assert _trees_equal(final, run.params)


@pytest.mark.parametrize("field,kw", [("seed", dict(seed=1)),
                                      ("steps", dict(steps=3)),
                                      ("precision",
                                       dict(precision="bf16"))])
def test_engine_resume_rejects_mismatch(tmp_path, field, kw):
    path = str(tmp_path / "ck")
    _engine(steps=2, ckpt=path).run()
    kw.setdefault("steps", 2)
    with pytest.raises(ValueError, match=field):
        _engine(resume=path, **kw)


def test_keep_last_k_ckpt_gc_and_latest(tmp_path):
    """keep_ckpts=2: only the newest 2 periodic dirs survive; the final
    checkpoint is never GC'd, and ``latest_checkpoint`` ranks what is
    left."""
    path = str(tmp_path / "ck")
    eng = _engine(steps=7, log_every=10, ckpt=path, ckpt_every=1,
                  keep_ckpts=2, async_save=False)
    eng.run()
    have = sorted(p.name for p in tmp_path.iterdir())
    assert "ck-5" in have and "ck-6" in have and "ck" in have
    assert not any(f"ck-{i}" in have for i in range(1, 5)), have
    assert ckpt_io.load_manifest(str(tmp_path / "ck-6")).step == 7
    assert sharded.latest_checkpoint(str(tmp_path), prefix="ck") == path
    import shutil
    shutil.rmtree(path)
    assert sharded.latest_checkpoint(str(tmp_path), prefix="ck") == \
        path + "-6"


def test_ckpt_gc_spares_best_marker_target(tmp_path):
    path = str(tmp_path / "ck")
    eng = _engine(steps=8, log_every=10, ckpt=path, ckpt_every=2,
                  keep_ckpts=1, eval_every=3, eval_batches=1,
                  async_save=False)
    eng.run()
    assert eng.best_ckpt is not None and os.path.exists(eng.best_ckpt)
    marker = json.load(open(path + "-best.json"))
    assert marker["path"] == eng.best_ckpt
    assert marker["val_loss"] == pytest.approx(eng.best_val)


def test_final_save_survives_stale_write_error_and_prunes(tmp_path):
    """A failed async periodic write neither aborts the next save nor
    orphans its GC prune list: the engine absorbs the stale error at
    save(), re-queues the backlog, re-raises at wait_checkpoints()."""
    path = str(tmp_path / "ck")
    eng = _engine(steps=4, log_every=10, ckpt=path, ckpt_every=1,
                  keep_ckpts=1)
    real = sharded.write_snapshot
    calls = []

    def flaky(snap, p, **kw):
        calls.append(p)
        if len(calls) == 3:
            raise OSError("transient EIO")
        return real(snap, p, **kw)

    eng._writer._write_fn = flaky
    eng._writer.retries = 1
    with pytest.raises(OSError, match="EIO"):
        eng.run()
    eng.wait_checkpoints()                    # error consumed exactly once
    assert sharded.checkpoint_complete(path)
    survivors = {n for n in os.listdir(tmp_path) if n.startswith("ck-")
                 and sharded.checkpoint_complete(str(tmp_path / n))}
    assert "ck-1" not in survivors and "ck-2" not in survivors, survivors
    assert sharded.latest_checkpoint(str(tmp_path), prefix="ck") == path


def test_prune_backlog_persisted_and_restored(tmp_path):
    stale = tmp_path / "ck-0"
    stale.mkdir()
    path = str(tmp_path / "ck")
    eng = _engine(steps=2, ckpt=path, async_save=False)
    eng._prune_backlog = [str(stale)]
    eng.run()
    man = ckpt_io.load_manifest(path)
    assert not stale.exists()
    assert man.extra["prune_backlog"] == [str(stale)]
    assert _engine(steps=2, resume=path)._prune_backlog == []


def test_engine_spans_and_extra(tmp_path):
    """The loop pays ``ckpt_submit`` once a save; the manifest's extra has
    the reference's keys."""
    path = str(tmp_path / "ck")
    eng = _engine(steps=3, ckpt=path, ckpt_every=1)
    eng.run()
    names = [e["name"] for e in eng.tracer.chrome_events()]
    assert names.count("ckpt_submit") == 3 and names.count("ckpt.write") == 3
    extra = ckpt_io.load_manifest(path).extra
    assert set(extra) == {"arch", "reduced", "seed", "steps", "rollout",
                          "scheme", "precision", "pipeline", "best",
                          "ckpt_history", "prune_backlog"}
    assert extra["pipeline"] == {"cursor": 3} and extra["scheme"] == "none"


# -- the format against the JAX package --------------------------------

def _tiny_ref_cfg(policy=None):
    cfg = ref_get_config("weathermixer-1b").reduced().replace(
        wm_lat=16, wm_lon=32, wm_channels=4, d_model=64, wm_d_tok=64,
        wm_d_ch=64)
    return ref_precision.apply_policy(cfg, policy) if policy else cfg


def _ref_groups(policy):
    """Reference params and Adam state (moments and masters filled from a
    numpy seed, step 7), as the reference's engine holds them."""
    cfg = _tiny_ref_cfg(policy)
    params = RW.init(jax.random.PRNGKey(0), cfg)
    opt = ref_adam.init(params, ref_adam.AdamConfig(
        master_weights=policy == "bf16"))
    rng = np.random.default_rng(1)
    opt = {k: (jnp.int32(7) if k == "step" else jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), v))
        for k, v in opt.items()}
    return {"params": params, "opt_state": opt}


def _port_groups(ref):
    """The same groups in the port's layout."""
    np_tree = jax.tree.map(np.asarray, ref)
    opt = {k: (int(v) if k == "step" else params_from_numpy(v, device="cpu"))
           for k, v in np_tree["opt_state"].items()}
    return {"params": params_from_numpy(np_tree["params"], device="cpu"),
            "opt_state": opt}


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_reference_checkpoint_restores_in_port_bitwise(tmp_path, policy):
    ref = _ref_groups(policy)
    path = str(tmp_path / "ck")
    ref_sharded.save_checkpoint(path, ref, step=5, extra={"arch": "t"})
    want = _port_groups(ref)
    for group in ("params", "opt_state"):
        got = sharded.restore_tree(path, group, like=want[group])
        assert _trees_equal(got, want[group]), group
    assert isinstance(got["step"], int) and got["step"] == 7
    if policy == "bf16":
        assert got["master"]["blocks"][0]["tok_fc1"]["w"].dtype == \
            torch.float32
        assert want["params"]["blocks"][0]["tok_fc1"]["w"].dtype == \
            torch.bfloat16


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_port_checkpoint_restores_in_reference_bitwise(tmp_path, policy):
    """The port's save read by the reference's ``restore_tree(like=)``
    (which validates every leaf's shape and dtype), bit for bit; and
    the same tree written by both packages gives the same npz members
    byte for byte and equal manifests."""
    ref = _ref_groups(policy)
    port = _port_groups(ref)
    p_path, r_path = str(tmp_path / "port"), str(tmp_path / "ref")
    snap = sharded.save_checkpoint(p_path, port, step=5)
    ref_sharded.save_checkpoint(r_path, ref, step=5)
    for group in ("params", "opt_state"):
        got = ref_sharded.restore_tree(p_path, group, like=ref[group])
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref[group])):
            assert a.dtype == np.asarray(b).dtype
            assert np.array_equal(_ref_bits(a), _ref_bits(b))
    pz = np.load(os.path.join(p_path, "shard-d00000.npz"))
    rz = np.load(os.path.join(r_path, "shard-d00000.npz"))
    assert sorted(pz.files) == sorted(rz.files)
    for k in rz.files:
        assert pz[k].dtype.str == rz[k].dtype.str, k
        assert pz[k].tobytes() == rz[k].tobytes(), k
    pm = json.load(open(os.path.join(p_path, "manifest.json")))
    rm = json.load(open(os.path.join(r_path, "manifest.json")))
    assert pm == rm
    assert snap.total_bytes == sum(rz[k].nbytes for k in rz.files)


def test_bf16_is_stored_as_raw_v2_not_uint16(tmp_path):
    """Regression: bf16 written as uint16 would send the reference's
    reader down its ``astype`` branch, turning the bit patterns (numbers
    0...65535) into bf16 values.  The port writes |V2, and the reference
    reads it back bit for bit; the uint16 file it would misread."""
    w = (torch.arange(8, dtype=torch.float32) / 7).to(torch.bfloat16)
    path = str(tmp_path / "ck")
    sharded.save_checkpoint(path, {"params": {"w": w}})
    raw = np.load(os.path.join(path, "shard-d00000.npz"))["params/w#0"]
    assert raw.dtype == np.dtype("V2") and raw.dtype.str == "|V2"
    like = {"w": jnp.zeros((8,), jnp.bfloat16)}
    got = ref_sharded.restore_tree(path, "params", like=like)["w"]
    assert np.array_equal(_ref_bits(got), _bits(w))
    # the faulty layout, for contrast: uint16 bits misread as numbers
    bad = sharded.Snapshot(
        MF.Manifest(step=0, groups={"params": {"w": MF.LeafEntry(
            (8,), "bfloat16", [], (MF.ShardEntry(
                "shard-d00000.npz", "params/w#0", ((0, 8),), 0),))}}),
        {"shard-d00000.npz": {"params/w#0": _bits(w)}}, {})
    sharded.write_snapshot(bad, str(tmp_path / "bad"))
    misread = ref_sharded.restore_tree(str(tmp_path / "bad"), "params")["w"]
    assert not np.array_equal(_ref_bits(misread), _bits(w))


def _tiny_port_cfg():
    ref = _tiny_ref_cfg()
    return get_config("weathermixer-1b").replace(
        **{f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})


def test_reference_checkpoint_served_by_port(tmp_path):
    """A checkpoint of the reference's TrainEngine (two steps, fp32)
    served by the port's ``ForecastEngine(ckpt=)``: the same step, and a
    lead-1 forecast within 1e-5 of the reference's
    ``ForecastEngine(ckpt=)`` on the same fields; the reference's serving
    restore reads the port's save of the same params likewise."""
    from repro.launch.engine import EngineConfig as REngineConfig
    from repro.launch.engine import TrainEngine as RTrainEngine
    from repro.models import registry as RM
    from repro.serve.engine import ForecastEngine as RForecastEngine
    from repro.serve.engine import ServeConfig as RServeConfig
    path = str(tmp_path / "ck")
    rcfg = _tiny_ref_cfg()
    RTrainEngine("weathermixer-1b", reduced=False, config_override=rcfg,
                 config=REngineConfig(steps=2, batch=2, log_every=1,
                                      prefetch=0, telemetry=False,
                                      ckpt=path)).run()
    ref = RForecastEngine("weathermixer-1b", reduced=False, ckpt=path,
                          config_override=rcfg,
                          config=RServeConfig(buckets=(1,)))
    port = ForecastEngine("weathermixer-1b", reduced=False, ckpt=path,
                          config_override=_tiny_port_cfg(), device="cpu",
                          config=ServeConfig(buckets=(1,)))
    assert port.restored_step == ref.restored_step == 2
    fields = np.random.default_rng(0).normal(
        size=(1, *port.field_shape)).astype(np.float32)
    want = np.asarray(RM.forecast_step(ref.params, jnp.asarray(fields),
                                       ref.cfg, ref.jcfg))
    got = port._forecast(torch.from_numpy(fields)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the other way: the port's save of these params, served by the
    # reference, gives the port's forecast
    p_path = str(tmp_path / "port")
    sharded.save_checkpoint(p_path, {"params": port.params}, step=2,
                            extra={"arch": "weathermixer-1b"})
    back = RForecastEngine("weathermixer-1b", reduced=False, ckpt=p_path,
                           config_override=rcfg,
                           config=RServeConfig(buckets=(1,)))
    again = np.asarray(RM.forecast_step(back.params, jnp.asarray(fields),
                                        back.cfg, back.jcfg))
    np.testing.assert_allclose(again, want, rtol=1e-5, atol=1e-5)
    from repro_torch.checkpoint import restore_serving_params
    with pytest.raises(ValueError, match="arch"):
        restore_serving_params(path, arch="wm-zoo-1t")
    with pytest.raises(ValueError, match="shape"):
        ForecastEngine("weathermixer-1b", ckpt=path, device="cpu")


def test_port_checkpoint_resumed_by_reference_engine(tmp_path):
    """The port's TrainEngine checkpointed at step 3 of 4 (loop index 2),
    resumed by the reference's ``TrainEngine(resume=)``: its step 3 within
    1e-4 relative of the port's uninterrupted history (the two packages
    sum in different orders); and the reference's checkpoint of the
    reference's run resumed by the port's engine likewise."""
    from repro.launch.engine import EngineConfig as REngineConfig
    from repro.launch.engine import TrainEngine as RTrainEngine
    path = str(tmp_path / "ck")
    h_port = _engine(ckpt=path, ckpt_every=2).run()

    def ref_engine(**kw):
        return RTrainEngine("weathermixer-1b", config=REngineConfig(
            steps=4, batch=2, log_every=1, rollout=2, prefetch=0,
            telemetry=False, **kw))

    resumed = ref_engine(resume=path + "-2")
    assert resumed.step_idx == 3 and resumed.pipeline.cursor == 3
    h_ref = resumed.run()
    assert len(h_ref) == 1
    for k in HIST_KEYS:
        rel = abs(h_ref[0][k] - h_port[3][k]) / abs(h_port[3][k])
        assert rel <= 1e-4, (k, h_ref[0][k], h_port[3][k])
    r_path = str(tmp_path / "ref")
    h_ref_full = ref_engine(ckpt=r_path, ckpt_every=2).run()
    back = _engine(resume=r_path + "-2")
    assert back.step_idx == 3
    h_back = back.run()
    for k in HIST_KEYS:
        rel = abs(h_back[0][k] - h_ref_full[3][k]) / abs(h_ref_full[3][k])
        assert rel <= 1e-4, (k, h_back[0][k], h_ref_full[3][k])


def test_entry_points_need_cuda_unless_asked_for_cpu(tmp_path):
    """Without a card the engines raise unless given ``device="cpu"``,
    the checkpoint path included."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default works")
    path = str(tmp_path / "ck")
    _engine(steps=1, ckpt=path).run()
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainEngine("weathermixer-1b", config=EngineConfig(
            steps=1, batch=2, resume=path))
    with pytest.raises(RuntimeError, match="CUDA"):
        ForecastEngine("weathermixer-1b", ckpt=path)
