"""The port's step cost model against the JAX package's, on the CPU.

* ``launch/analysis.py``'s FLOP and byte model equals the reference's
  exactly (``weathermixer-1b`` full and reduced, ``mamba2-130m`` full and
  reduced, every step kind).
* ``core/jigsaw.py``'s comm volumes and ring schedules equal the
  reference's for p in {2, 4, 8} and q in {2, 4}, bf16 and f32 wires.
* ``telemetry.build_cost_model`` and ``fig7_point`` equal the reference's
  field for field when handed the reference's TPU constants (the port's
  defaults are the H100's: ``launch/analysis.py``).
* The reference's accounting identities (``tests/test_telemetry.py``'s
  cost-model and ``trace_report`` tests) at the H100's constants.
* ``TrainEngine``'s step records: on one device and on a 2x2 mesh of gloo
  ranks (the training CLI under ``torch.distributed.run``), every record
  carries a finite ``mfu`` in (0, 1], ``achieved_tflops`` and
  ``comm_fraction``, consistent with ``cost_model.metrics(dur_s)``, and
  ``trace_report --check`` passes on the exported JSONL.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.configs.registry import get_config as ref_get_config
from repro.core import jigsaw as RJ
from repro.launch import analysis as RA
from repro.telemetry import accounting as RACC
from repro_torch import telemetry
from repro_torch.configs.registry import get_config
from repro_torch.core import jigsaw as J
from repro_torch.launch import analysis as A
from repro_torch.launch import trace_report
from repro_torch.launch.engine import EngineConfig, TrainEngine
from repro_torch.telemetry import Tracer

ROOT = Path(__file__).resolve().parents[1]
WM = "weathermixer-1b"


def _cfgs(arch):
    """(port, reference) configs: full and reduced."""
    port, ref = get_config(arch), ref_get_config(arch)
    return [(port, ref), (port.reduced(), ref.reduced())]


CASES = [(arch, i) for arch in (WM, "mamba2-130m") for i in range(2)]


@pytest.mark.parametrize("arch,i", CASES)
def test_flop_and_byte_model_equals_reference(arch, i):
    cfg, rcfg = _cfgs(arch)[i]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    for batch, seq in ((1, 1), (2, 128), (8, 4096)):
        assert A.flops_forward(cfg, batch, seq) == \
            RA.flops_forward(rcfg, batch, seq)
        for kind in ("train", "prefill", "decode"):
            assert A.flops_step(cfg, kind, batch, seq) == \
                RA.flops_step(rcfg, kind, batch, seq)
            for pb, cb, ob in ((2e9, 0.0, 0.0), (1.3e9, 5e7, 8e9)):
                assert A.hbm_bytes_step(cfg, kind, batch, seq, pb, cb, ob) \
                    == RA.hbm_bytes_step(rcfg, kind, batch, seq, pb, cb, ob)
        assert A.model_flops_train(cfg, batch * seq) == \
            RA.model_flops_train(rcfg, batch * seq)
        assert A.model_flops_decode(cfg, batch) == \
            RA.model_flops_decode(rcfg, batch)
    assert A._dense_matmul_params(cfg) == RA._dense_matmul_params(rcfg)


def test_h100_constants():
    """Datasheet figures of the H100 SXM5 80 GB at 700 W, not the
    reference's TPU v5e values."""
    assert (A.PEAK_FLOPS_BF16, A.PEAK_FLOPS_F32, A.HBM_BW, A.NVLINK_BW) \
        == (989.4e12, 66.9e12, 3.35e12, 450e9)
    assert A.peak_flops("bfloat16") == A.PEAK_FLOPS_BF16
    assert A.peak_flops("float32") == A.PEAK_FLOPS_F32
    with pytest.raises(ValueError, match="no peak"):
        A.peak_flops("float16")
    assert RA.PEAK_FLOPS_BF16 != A.PEAK_FLOPS_BF16


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("p", [2, 4, 8])
def test_comm_volumes_and_schedules_equal_reference(p, dtype_bytes):
    tokens, m, d = 16380, 4320, 4320
    assert dataclasses.asdict(J.comm_volume_jigsaw_1d(
        tokens, m, p, dtype_bytes)) == dataclasses.asdict(
        RJ.comm_volume_jigsaw_1d(tokens, m, p, dtype_bytes))
    assert dataclasses.asdict(J.comm_volume_megatron_pair(
        tokens, d, p, dtype_bytes)) == dataclasses.asdict(
        RJ.comm_volume_megatron_pair(tokens, d, p, dtype_bytes))
    for impl in ("ring", "ring_chunked", "ring_fused", None):
        for chunked in (True, False):
            got = J.comm_schedule_jigsaw_1d(tokens, m, d // p, p,
                                            dtype_bytes, chunked, impl)
            want = RJ.comm_schedule_jigsaw_1d(tokens, m, d // p, p,
                                              dtype_bytes, chunked, impl)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            assert got.overlap_ratio(50e9, 197e12) == \
                want.overlap_ratio(50e9, 197e12)
    with pytest.raises(ValueError, match="unknown impl"):
        J.comm_schedule_jigsaw_1d(tokens, m, d, p, impl="gspmd")
    for q in (2, 4):
        assert dataclasses.asdict(J.comm_volume_jigsaw_2d(
            tokens, m, q, dtype_bytes)) == dataclasses.asdict(
            RJ.comm_volume_jigsaw_2d(tokens, m, q, dtype_bytes))


def _as_reference(d):
    """The port's StepCostModel fields under the reference's names."""
    d = dict(d)
    d["ici_bw"] = d.pop("link_bw")
    return d


MESHES = [(1, 1, "1d", "rs"), (2, 1, "1d", "ring_fused"),
          (4, 2, "1d", "ring_chunked"), (8, 1, "1d", "ring"),
          (4, 1, "2d", "rs"), (16, 2, "2d", "rs"), (2, 2, "2d", "rs")]


@pytest.mark.parametrize("precision", [None, "bf16", "fp32"])
@pytest.mark.parametrize("n_model,n_data,scheme,impl", MESHES)
def test_build_cost_model_equals_reference(n_model, n_data, scheme, impl,
                                           precision):
    from repro.core import precision as RP
    from repro_torch.core import precision as P
    for cfg, rcfg in _cfgs(WM) + [_cfgs("mamba2-130m")[0]]:
        cfg = cfg.replace(scheme=scheme, impl=impl)
        rcfg = rcfg.replace(scheme=scheme, impl=impl)
        if precision:
            cfg = P.apply_policy(cfg, precision)
            rcfg = RP.apply_policy(rcfg, precision)
        for batch in (1, 4):
            got = telemetry.build_cost_model(
                cfg, n_model=n_model, n_data=n_data, batch=batch,
                seq_len=256, peak=RA.PEAK_FLOPS_BF16, link=RA.ICI_BW)
            want = RACC.build_cost_model(
                rcfg, n_model=n_model, n_data=n_data, batch=batch,
                seq_len=256)
            assert _as_reference(got.as_meta()) == want.as_meta()
            for t in (1e-3, 0.37, 12.0):
                for r in (1, 3):
                    assert got.metrics(t, r) == want.metrics(t, r)


def test_cost_model_peak_follows_the_gemm_dtype():
    """The peak of the dtype the step's GEMMs run in: the policy's compute
    dtype; under the legacy policy f32 for the mixer (f32 activations),
    the stored weights' dtype for a language model (its embedding's)."""
    from repro_torch.core import precision as P
    cfg = get_config(WM)
    assert telemetry.gemm_peak(cfg) == A.PEAK_FLOPS_F32
    lm = get_config("phi3.5-moe-42b-a6.6b")
    assert telemetry.gemm_peak(lm) == A.PEAK_FLOPS_BF16
    assert telemetry.gemm_peak(lm.reduced()) == A.PEAK_FLOPS_F32
    for name, peak in (("bf16", A.PEAK_FLOPS_BF16),
                       ("bf16_pure", A.PEAK_FLOPS_BF16),
                       ("fp32", A.PEAK_FLOPS_F32)):
        cm = telemetry.build_cost_model(P.apply_policy(cfg, name))
        assert cm.peak_flops == peak and cm.link_bw == A.NVLINK_BW


@pytest.mark.parametrize("way,impl", [(1, None), (2, None), (4, None),
                                      (2, "ring_chunked"),
                                      (2, "ring_fused"), (4, "ring_fused")])
def test_fig7_point_equals_reference(way, impl):
    for cfg, rcfg in _cfgs(WM):
        assert telemetry.fig7_point(cfg, way, impl, peak=RA.PEAK_FLOPS_BF16,
                                    link=RA.ICI_BW) == \
            RACC.fig7_point(rcfg, way, impl)


def test_fig7_point_at_h100_constants():
    """The reference's scaling checks at the card's constants: way 1 runs
    at peak, the chunked 2-way ring hides its collective, and a wider
    Jigsaw shortens the step."""
    cfg = get_config(WM)
    p1 = telemetry.fig7_point(cfg, 1)
    assert p1["t_coll_s"] == 0.0
    assert p1["t_comp_s"] == pytest.approx(
        3 * sum(A.flops_forward(cfg, 1, 0).values()) / A.PEAK_FLOPS_BF16)
    p2, p4 = telemetry.fig7_point(cfg, 2), telemetry.fig7_point(cfg, 4)
    assert p2["t_coll_s"] == pytest.approx(
        3 * J.comm_volume_jigsaw_1d(16380, cfg.wm_d_ch, 2).bytes_per_device
        * 2 * cfg.n_layers / A.NVLINK_BW)
    assert p4["t_step_s"] <= p2["t_step_s"] <= p1["t_step_s"]
    assert telemetry.fig7_point(cfg, 2, "ring_chunked")["peak_frac"] >= \
        p2["peak_frac"]


def test_cost_model_mfu_8way():
    """The accounting identities the step records are built from (the
    reference's ``test_cost_model_mfu_8way``, at the card's peaks)."""
    from repro_torch.core import precision as P
    cfg = P.apply_policy(get_config(WM), "bf16")
    cm = telemetry.build_cost_model(cfg, n_model=8, n_data=1, batch=1)
    assert cm.n_devices == 8 and cm.flops_per_step > 0
    assert cm.comm_bytes_per_device > 0 and cm.hops == 7
    m = cm.metrics(cm.t_compute_s)
    assert m["mfu"] == pytest.approx(1.0)
    assert m["achieved_tflops"] == pytest.approx(A.PEAK_FLOPS_BF16 / 1e12)
    assert cm.metrics(2 * cm.t_compute_s)["mfu"] == pytest.approx(0.5)
    assert cm.metrics(2 * cm.t_compute_s, rollout=2)["mfu"] == \
        pytest.approx(1.0)
    t = 10 * cm.t_collective_s
    assert cm.metrics(t)["comm_fraction"] == pytest.approx(0.1)
    assert cm.metrics(0.5 * cm.t_collective_s)["comm_fraction"] == 1.0
    assert cm.metrics(0.0) == {"mfu": 0.0, "achieved_tflops": 0.0,
                               "comm_fraction": 0.0}


def test_cost_model_comm_matches_fig7_collective_term():
    cfg = get_config(WM).replace(scheme="1d")
    cm = telemetry.build_cost_model(cfg, n_model=2, n_data=1, batch=1)
    assert cm.t_collective_s == pytest.approx(
        telemetry.fig7_point(cfg, 2)["t_coll_s"], rel=1e-12)


def test_cost_model_meta_roundtrips_through_report():
    cfg = get_config(WM).reduced()
    cm = telemetry.build_cost_model(cfg, n_model=4, n_data=2, batch=8)
    tr = Tracer()
    tr.set_meta(arch=WM, cost_model=cm.as_meta())
    for i in range(3):
        tr.step_record(step=i, rollout=1, dur_s=0.01, data_wait_s=0.001,
                       **cm.metrics(0.01))
    meta, steps, *_ = trace_report.split_records(tr.jsonl_records())
    assert trace_report.check(meta, steps) == []
    att = trace_report.attribution(meta, steps)
    assert att["data"] == pytest.approx(0.1, rel=1e-6)
    total = att["data"] + att["compute"] + att["collective"] + att["other"]
    assert 0.0 < total <= 3.0 + 1e-9
    assert "bound" in trace_report.verdict(att)


def test_trace_report_check_catches_bad_records():
    assert trace_report.check({}, []) == [
        "no meta header record", "no step records"]
    bad = [{"step": 0, "dur_s": 0.1, "mfu": float("nan"),
            "comm_fraction": 0.2, "achieved_tflops": 1.0}]
    fails = trace_report.check({"arch": "x"}, bad)
    assert any("mfu" in f and "not finite" in f for f in fails)
    bad2 = [{"step": 1, "dur_s": 0.1, "mfu": 1.5, "comm_fraction": 0.2,
             "achieved_tflops": 1.0}]
    assert any("outside" in f
               for f in trace_report.check({"arch": "x"}, bad2))
    missing = [{"step": 2, "dur_s": 0.1, "comm_fraction": 0.2,
                "achieved_tflops": 1.0}]
    assert trace_report.check({"arch": "x"}, missing) == [
        "step 2: missing mfu"]


def test_trace_report_matches_reference_module():
    """The port's report is the reference's: the same verdict and the same
    failures on the same records."""
    from repro.launch import trace_report as RTR
    recs = [{"kind": "meta", "arch": WM, "cost_model": {
        "t_compute_s": 0.02, "t_collective_s": 0.005}}] + [
        {"kind": "step", "step": i, "rollout": 1 + i % 2, "dur_s": 0.1,
         "data_wait_s": 0.03, "mfu": 0.2, "comm_fraction": 0.05,
         "achieved_tflops": 3.0} for i in range(4)]
    m, s, *_ = trace_report.split_records(recs)
    rm, rs, *_ = RTR.split_records(recs)
    assert trace_report.attribution(m, s) == RTR.attribution(rm, rs)
    assert trace_report.verdict(trace_report.attribution(m, s)) == \
        RTR.verdict(RTR.attribution(rm, rs))
    assert trace_report.check(m, s) == RTR.check(rm, rs) == []


def _check_records(recs, cm):
    assert recs
    for r in recs:
        for k in ("mfu", "achieved_tflops", "comm_fraction"):
            assert math.isfinite(r[k])
        assert 0 < r["mfu"] <= 1 and r["achieved_tflops"] > 0
        assert 0 <= r["comm_fraction"] <= 1
        want = cm.metrics(r["dur_s"], rollout=r["rollout"])
        for k, v in want.items():
            assert r[k] == pytest.approx(v, rel=1e-12)


def test_train_engine_step_records_carry_mfu(tmp_path):
    """One device, reduced, rollout up to 2: the records' derived fields
    are the cost model's metrics of their own durations, the meta header
    carries the cost model, and ``trace_report --check`` passes."""
    trace = tmp_path / "run.trace.json"
    eng = TrainEngine(WM, device="cpu", config=EngineConfig(
        steps=4, batch=2, rollout=2, log_every=1, prefetch=0,
        trace=str(trace)))
    eng.run()
    cm = eng.cost_model
    assert cm.peak_flops == A.PEAK_FLOPS_F32    # reduced: legacy f32
    assert cm.flops_per_step == A.flops_step(eng.cfg, "train", 2, 128)
    recs = eng.tracer.step_records()
    _check_records(recs, cm)
    assert all(r["through_host_bytes"] == 0 for r in recs)
    jsonl = tmp_path / "run.trace.jsonl"
    meta, steps, *_ = trace_report.split_records(
        trace_report.load_records(str(jsonl)))
    assert meta["cost_model"] == json.loads(json.dumps(cm.as_meta()))
    assert trace_report.main([str(jsonl), "--check"]) == 0
    assert "bound" in trace_report.verdict(trace_report.attribution(
        meta, steps))


def test_train_cli_2x2_step_records_and_trace_check(tmp_path):
    """Four gloo ranks (the training CLI under ``torch.distributed.run``,
    2-D Jigsaw on a 2x2 mesh): rank 0's trace JSONL has a meta header with
    the 2-D cost model and records that ``trace_report --check`` passes;
    the report renders."""
    trace = tmp_path / "mesh.trace.json"
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--mesh-model", "4", "--scheme", "2d",
         "--steps", "3", "--batch", "2", "--log-every", "1",
         "--prefetch", "0", "--trace", str(trace)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        capture_output=True, text=True, cwd=tmp_path, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jsonl = str(tmp_path / "mesh.trace.jsonl")
    meta, steps, *_ = trace_report.split_records(
        trace_report.load_records(jsonl))
    cm = meta["cost_model"]
    assert (cm["scheme"], cm["n_model"], cm["n_data"], cm["hops"]) == \
        ("2d", 4, 1, 2)
    assert cm["comm_bytes_per_device"] > 0 and len(steps) == 3
    got = telemetry.StepCostModel(**{
        k: v for k, v in cm.items()
        if k not in ("t_compute_s", "t_collective_s", "n_devices")})
    _check_records(steps, got)
    check = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.trace_report", jsonl,
         "--check"], env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert check.returncode == 0 and "[trace-check] OK: 3 step records" \
        in check.stdout
    report = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.trace_report", jsonl],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert report.returncode == 0
    assert "roofline attribution" in report.stdout and \
        "-bound" in report.stdout


def test_measured_comm_bytes_reads_comm_counters():
    from repro_torch.core import comm
    kept = dict(comm.through_host_bytes)
    try:
        base = telemetry.measured_comm_bytes()
        comm.through_host_bytes["all_reduce/gloo"] += 1000
        comm.through_host_bytes["send_recv/comm"] += 24
        assert telemetry.measured_comm_bytes() - base == 1024
    finally:
        comm.through_host_bytes.clear()
        comm.through_host_bytes.update(kept)
    assert np.isfinite(base)
