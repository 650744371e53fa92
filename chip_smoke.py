#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

from the root of a checkout.  It builds the port's kernels from the sources
in ``src/repro_torch/kernels/csrc`` and drives the port's main paths at
``weathermixer-1b``'s full published width, through the entry points a user
calls: forecast serving, and one-GPU training.  Phases, each printed as a
JSON line:

  1. the card (``nvidia-smi``) and the kernel build;
  2. the block_matmul kernel against its plain PyTorch version on the card:
     small ragged shapes in f32 and bf16 with every epilogue, then the six
     GEMM shapes of a weathermixer-1b forecast step (bucket 1) in bf16 and
     tok_fc1 in f32, each timed beside the plain version, one PyTorch
     library call computing the same function (never used by the port) and
     the card's bound;
  3. full-width serving under the bf16 policy: requests admitted before and
     during a rollout, outputs finite, one lead-1 forecast against the plain
     forecast step, every request bitwise equal to its solo bucket-1
     rollout, 14 kernel launches per device step;
  4. the legacy path (the config's own dtypes: bf16 weights, f32
     activations, f32 kernel) for one step against the plain version;
  5. the backward GEMMs of the six shapes (bucket 1): dx = dz @ w and
     dw = dz.T @ x through the kernel's transposed-operand variants,
     against the plain version, each timed beside the plain version, the
     library's product and the bound; dw of tok_fc1 in f32 too;
  6. full-width training (``TrainEngine``, bf16 policy, batch 2, rollout
     up to 2): the first step's loss, grad norm and per-leaf gradients
     against the same step with ``kernel="xla"``; then the run, with
     5 + 54 r kernel launches per step of rollout r, finite losses, peak
     memory under 80 GB; then a second run of the same seed, whose loss
     and grad-norm history must equal the first's bit for bit;
  7. the ``kernels`` line, the card's name and power limit, and the last
     line ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line.  Without CUDA, or
run outside a checkout, it exits non-zero and prints no result.

Tolerances (|kernel - plain| <= atol + rtol * |plain|, elementwise):
  * bf16 GEMMs 3e-2 / 3e-2: the output is rounded to bf16 (2^-8 relative)
    and a different summation order flips some roundings (the bf16
    tolerance of the repository's kernel tests);
  * f32 GEMMs 1e-4 / 1e-4: exact f32 FMA, but K runs to 16,380 in an order
    other than cuBLAS's (~sqrt(K) * 2^-24 relative);
  * whole forecast step, max|a - b| / max|b|: bf16 policy 5e-2 (the plain
    step rounds each GEMM to bf16 before its bias and activation, the
    kernel after, through 3 blocks of bf16 residual stream); legacy f32
    1e-4;
  * first training step against ``kernel="xla"``: loss and grad norm
    relative, each gradient leaf max|a - b| / max|b|, all 5e-2 (the
    reference's bf16 loss-parity bound; the same rounding difference as
    the forecast step, through the backward too).
The plain versions run with ``torch.backends.cuda.matmul.allow_tf32 =
False``, so their f32 products are full f32.
"""
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12                                   # HBM3, bytes/s
GEMM_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
STEP_TOL = {"bf16": 5e-2, "legacy": 1e-4}
TRAIN_TOL = 5e-2
TRAIN_STEPS = 3           # seed 0's rollout schedule: r = 1, 2, 2
TRAIN_BATCH = 2
TRAIN_ROLLOUT = 2
PEAK_MEM_LIMIT = 80e9


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gemm_bound_ms(m, n, k, dtype_name, bias):
    """Least time on the card: FLOPs over the peak rate for the operand
    type, or bytes (each input read once, the output written once) over
    the memory rate, whichever is larger."""
    es = 4 if dtype_name == "float32" else 2
    flops = 2.0 * m * n * k
    nbytes = es * (m * k + n * k + m * n + (n if bias else 0))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def gemm_errors(y, r, dtype_name):
    tol = GEMM_TOL[dtype_name]
    y, r = y.float(), r.float()
    err = (y - r).abs()
    ok = bool((err <= tol + tol * r.abs()).all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

# weathermixer-1b at batch 1: d = 4320, T = 16380 tokens, patch dim 4416.
# (label, M, K, N, epilogue, dtype name, launches per forecast step,
#  launches per training sample-step at rollout 1: forward, the remat
#  recompute and, for the GELU layers, the pre-activation recompute)
_D, _T, _PD = 4320, 16380, 4416
SHAPES = [("encoder", _T, _PD, _D, "none", "bfloat16", 1, 1),
          ("tok_fc1", _D, _T, 8640, "gelu", "bfloat16", 3, 9),
          ("tok_fc2", _D, 8640, _T, "none", "bfloat16", 3, 6),
          ("ch_fc1", _T, _D, 4320, "gelu", "bfloat16", 3, 9),
          ("ch_fc2", _T, 4320, _D, "none", "bfloat16", 3, 6),
          ("decoder", _T, _D, _PD, "none", "bfloat16", 1, 1),
          ("tok_fc1_f32", _D, _T, 8640, "gelu", "float32", 0, 0)]

def kernel_phase(torch, BM, ref):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)

    def inputs(m, k, n, dtype, bias):
        x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(n, k, generator=gen, device="cuda")
             / k ** 0.5).to(dtype)
        b = ((0.1 * torch.randn(n, generator=gen, device="cuda")).to(dtype)
             if bias else None)
        return x, w, b

    worst = 0.0
    n_small = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for m, k, n in [(1, 1, 1), (7, 13, 5), (300, 700, 130),
                        (129, 97, 257), (200, 16380, 72)]:
            for epi in ("none", "gelu", "silu"):
                for bias in (True, False):
                    x, w, b = inputs(m, k, n, dtype, bias)
                    y = BM.block_matmul(x, w, b, epi)
                    torch.cuda.synchronize()
                    err, ok = gemm_errors(y, ref.block_matmul_ref(x, w, b,
                                                                  epi), name)
                    check(ok, f"small {name} {(m, k, n)} {epi} bias={bias}:"
                              f" max err {err:.3e}")
                    worst = max(worst, err)
                    n_small += 1
    emit(phase="kernel_small", cases=n_small, max_abs_err=worst, ok=True)

    rows = []
    for label, m, k, n, epi, name, per_step, per_train in SHAPES:
        dtype = getattr(torch, name)
        x, w, b = inputs(m, k, n, dtype, True)
        y = BM.block_matmul(x, w, b, epi)
        torch.cuda.synchronize()
        err, ok = gemm_errors(y, ref.block_matmul_ref(x, w, b, epi), name)
        check(ok, f"{label} {(m, k, n)} {name}: max err {err:.3e}")
        worst = max(worst, err)
        if epi == "gelu":
            def library():
                return F.gelu(F.linear(x, w, b), approximate="tanh")
        else:
            def library():
                return F.linear(x, w, b)
        bound, bound_by = gemm_bound_ms(m, n, k, name, True)
        row = dict(shape=label, m=m, n=n, k=k, dtype=name, epilogue=epi,
                   per_step=per_step, per_train_step=per_train,
                   vec_bytes=BM.vec_bytes(x, w) if name == "bfloat16" else 4,
                   max_abs_err=err, tol=GEMM_TOL[name],
                   kernel_ms=cuda_ms(lambda: BM.block_matmul(x, w, b, epi)),
                   library_ms=cuda_ms(library),
                   plain_ms=cuda_ms(lambda: ref.block_matmul_ref(x, w, b,
                                                                 epi), 3),
                   bound_ms=bound, bound_by=bound_by)
        row["tflops"] = 2e-9 * m * n * k / row["kernel_ms"]
        emit(phase="kernel_shape", **row)
        rows.append(row)
        del x, w, b, y
        torch.cuda.empty_cache()
    return rows, worst


# ---------------------------------------------------------------------------
# phases 3 and 4: the served model
# ---------------------------------------------------------------------------

def perturb_(params, torch, seed=1):
    """Move biases, LayerNorm parameters and the blend off their init
    values (in place), so the epilogue's bias path and the blend matter."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def walk(node, key=None):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        elif key in ("b", "bias", "scale", "blend"):
            noise = 0.1 * torch.randn(node.shape, generator=gen,
                                      device=node.device)
            node.add_(noise.to(node.dtype))

    walk(params)


def rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def serve_phase(torch, BM):
    from repro_torch.data.weather import WeatherDataConfig, WeatherDataset
    from repro_torch.models import registry as M
    from repro_torch.serve.engine import ForecastEngine, ServeConfig

    t0 = time.perf_counter()
    eng = ForecastEngine("weathermixer-1b", reduced=False, device="cuda",
                         config=ServeConfig(buckets=(1, 2, 4),
                                            precision="bf16", seed=0))
    perturb_(eng.params, torch)
    cfg = eng.cfg
    ds = WeatherDataset(WeatherDataConfig(lat=cfg.wm_lat, lon=cfg.wm_lon,
                                          channels=cfg.wm_channels, seed=0))
    n_samples = 3
    with ThreadPoolExecutor(n_samples) as pool:
        fields = list(pool.map(lambda i: ds.sample_fields(i, 1)[0],
                               range(n_samples)))
    setup_s = time.perf_counter() - t0
    warm = eng.warmup()
    emit(phase="serve_setup", params=cfg.param_count(),
         param_dtype=cfg.param_dtype, field_shape=list(eng.field_shape),
         setup_s=setup_s, warmup_s=eng.stats["warmup_s"],
         warm_setups=warm)

    # -- the main path: counts to 0 just before, read just after -----------
    # (sample, lead): samples cycle 0,1,2 and leads 3,1,2; the first runs
    # alone for one step, the rest join it mid-rollout
    plan = [(i % n_samples, (i + 2) % 3 + 1) for i in range(7)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    BM.block_matmul.launches = 0
    t_start = time.perf_counter()
    reqs = [eng.submit(fields[plan[0][0]], plan[0][1])]
    check(eng.step_once() == "step", "first step did not run")
    reqs += [eng.submit(fields[s], lead) for s, lead in plan[1:]]
    eng.drain()
    wall = time.perf_counter() - t_start
    launches = BM.block_matmul.launches
    steps = eng.stats["device_steps"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # ----------------------------------------------------------------------

    check(all(r.done() for r in reqs), "not every request was delivered")
    check(launches == 14 * steps,
          f"{launches} kernel launches for {steps} device steps (want 14 "
          "per step)")
    check(eng.stats["compiles"] == warm, "serving set something up after "
          "warmup")
    check(eng.sched.counters["grown"] >= 1, "no request joined mid-rollout")
    for r in reqs:
        for lead, out in r.outputs.items():
            check(out.shape == eng.field_shape and bool(
                torch.isfinite(torch.from_numpy(out)).all()),
                f"request {r.rid} lead {lead}: bad output")

    # every request (all but the first admitted mid-rollout, the first
    # carried through two grows) against its solo bucket-1 rollout, bitwise
    def solo(f, lead):
        state = torch.from_numpy(f)[None].to("cuda")
        for _ in range(lead):
            state = eng._forecast(state)
        return state[0].cpu().numpy()

    import numpy as np
    mismatched = [r.rid for r in reqs
                  if not np.array_equal(r.result(), solo(r.fields,
                                                         r.max_lead))]
    check(not mismatched, f"mid-rollout requests {mismatched} differ from "
          "their solo rollouts")

    # one lead-1 forecast against the plain forecast step (kernel="xla")
    lead1 = next(r for r in reqs if 1 in r.outputs)
    x = torch.from_numpy(lead1.fields)[None].to("cuda")
    with torch.no_grad():
        plain = M.forecast_step(eng.params, x, cfg,
                                eng.jcfg.replace(kernel="xla"))[0]
    step_err = rel_err(torch.from_numpy(lead1.output(1)).cuda(), plain)
    check(step_err <= STEP_TOL["bf16"],
          f"bf16 forecast step vs plain: {step_err:.3e}")

    # device time of one step at each bucket
    step_ms = {}
    for b in (1, 2, 4):
        state = torch.from_numpy(np.stack([fields[i % n_samples]
                                           for i in range(b)])).cuda()
        step_ms[b] = cuda_ms(lambda: eng._forecast(state), 2)
    s = eng.summary(reqs)
    emit(phase="serve", requests=len(reqs), device_steps=steps,
         kernel_launches=launches, launches_per_step=launches / steps,
         wall_s=wall, req_per_s=len(reqs) / wall,
         p50_s=s["p50_s"], p95_s=s["p95_s"], formed=s["formed"],
         grown=s["grown"], compiles_after_warmup=s["compiles"] - warm,
         step_span_mean_s=eng.tracer.span_summary()["serve.step"]["mean_s"],
         step_ms_by_bucket=step_ms,
         ms_per_request_step_bucket4=step_ms[4] / 4,
         bound_ms_per_request_step=1e3 * gemm_flops_per_request(cfg)
         / PEAK_FLOPS["bfloat16"],
         peak_mem_gb=peak_gb, midrollout_bitwise=True,
         step_vs_plain_rel_err=step_err, step_tol=STEP_TOL["bf16"])
    return eng, fields, launches


def gemm_flops_per_request(cfg):
    """2*M*N*K summed over the GEMMs of one forecast step, one request."""
    t = (cfg.wm_lat // cfg.wm_patch) * (cfg.wm_lon // cfg.wm_patch)
    d, pd = cfg.d_model, cfg.wm_patch ** 2 * cfg.wm_channels
    per_block = 2 * (d * cfg.wm_d_tok * t) + 2 * (t * cfg.wm_d_ch * d)
    return 2.0 * (2 * t * pd * d + cfg.n_layers * per_block)


def legacy_phase(torch, BM, eng, fields):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.shapes import jigsaw_for
    from repro_torch.models import registry as M

    cfg = get_config("weathermixer-1b").replace(scheme="none", impl="rs")
    jcfg = jigsaw_for(cfg)
    check(jcfg.compute_dtype is None and cfg.param_dtype == "bfloat16",
          "legacy config is not bf16 weights / f32 activations")
    x = torch.from_numpy(fields[0])[None].to("cuda")
    BM.block_matmul.launches = 0
    with torch.no_grad():
        out = M.forecast_step(eng.params, x, cfg, jcfg)
        torch.cuda.synchronize()
        launches = BM.block_matmul.launches
        plain = M.forecast_step(eng.params, x, cfg,
                                jcfg.replace(kernel="xla"))
    check(launches == 14, f"legacy step launched the kernel {launches} "
          "times (want 14)")
    check(bool(torch.isfinite(out).all()), "legacy step: non-finite output")
    err = rel_err(out, plain)
    check(err <= STEP_TOL["legacy"], f"legacy f32 step vs plain: {err:.3e}")
    emit(phase="legacy_f32", launches=launches, out_dtype=str(out.dtype),
         step_vs_plain_rel_err=err, step_tol=STEP_TOL["legacy"])


# ---------------------------------------------------------------------------
# phase 5: the backward GEMMs against their plain versions
# ---------------------------------------------------------------------------

# launches of dx and of dw per training sample-step at rollout 1 (the
# encoder's input is data: no dx)
BWD_COUNTS = {"encoder": (0, 1), "tok_fc1": (3, 3), "tok_fc2": (3, 3),
              "ch_fc1": (3, 3), "ch_fc2": (3, 3), "decoder": (1, 1),
              "tok_fc1_f32": (0, 0)}


def kernel_bwd_phase(torch, BM, ref):
    """dx = dz @ w (w read as w.T) and dw = dz.T @ x (dz and x read across
    their rows) for each forward shape; dw only for the f32 row."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    rows, worst = [], 0.0
    for label, m, k, n, _, name, *_ in SHAPES:
        dtype = getattr(torch, name)
        x = (torch.randn(m, k, generator=gen, device="cuda")
             / m ** 0.5).to(dtype)
        w = (torch.randn(n, k, generator=gen, device="cuda")
             / k ** 0.5).to(dtype)
        dz = torch.randn(m, n, generator=gen, device="cuda").to(dtype)
        n_dx, n_dw = BWD_COUNTS[label]
        cases = [("dw", dz, x, True, (n, k, m), n_dw,
                  lambda: torch.matmul(dz.t(), x))]
        if name == "bfloat16":
            cases.insert(0, ("dx", dz, w, False, (m, k, n), n_dx,
                             lambda: torch.matmul(dz, w)))
        for kind, a, b, x_t, (om, on, ok_), count, library in cases:
            def kernel(a=a, b=b, x_t=x_t):
                return BM.block_matmul(a, b, x_t=x_t, w_t=True)

            def plain(a=a, b=b, x_t=x_t):
                return ref.block_matmul_ref(a, b, x_t=x_t, w_t=True)
            y = kernel()
            torch.cuda.synchronize()
            err, ok = gemm_errors(y, plain(), name)
            check(ok, f"{label}.{kind} {(om, on, ok_)} {name}: max err "
                      f"{err:.3e}")
            worst = max(worst, err)
            bound, bound_by = gemm_bound_ms(om, on, ok_, name, False)
            row = dict(shape=f"{label}.{kind}", m=om, n=on, k=ok_,
                       dtype=name, x_t=x_t, w_t=True, per_train_step=count,
                       vec_bytes=(BM.vec_bytes(a, b) if name == "bfloat16"
                                  else 4),
                       max_abs_err=err, tol=GEMM_TOL[name],
                       kernel_ms=cuda_ms(kernel), library_ms=cuda_ms(library),
                       plain_ms=cuda_ms(plain, 3), bound_ms=bound,
                       bound_by=bound_by)
            row["tflops"] = 2e-9 * om * on * ok_ / row["kernel_ms"]
            emit(phase="kernel_bwd_shape", **row)
            rows.append(row)
            del y
        del x, w, dz
        torch.cuda.empty_cache()
    return rows, worst


# ---------------------------------------------------------------------------
# phase 6: full-width training
# ---------------------------------------------------------------------------

def train_flops_per_sample(cfg, rollout):
    """2*M*N*K over the 5 + 54 r GEMM launches of one training sample-step
    (3 blocks, remat): forward, remat recompute, dw and dx (the encoder's
    input needs none) of every linear, and the pre-activation recompute of
    the two GELU linears of each block."""
    t = (cfg.wm_lat // cfg.wm_patch) * (cfg.wm_lon // cfg.wm_patch)
    d, pd = cfg.d_model, cfg.wm_patch ** 2 * cfg.wm_channels
    enc = 2.0 * t * pd * d                   # encoder = decoder
    tok = 2.0 * d * cfg.wm_d_tok * t         # tok_fc1 = tok_fc2
    ch = 2.0 * t * cfg.wm_d_ch * d           # ch_fc1 = ch_fc2
    block = 2 * tok + 2 * ch
    return 5 * enc + rollout * cfg.n_layers * (4 * block + tok + ch)


def train_phase(torch, BM):
    import math
    from repro_torch.core import tree as ptree
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.optim.adam import global_norm
    from repro_torch.train.step import value_and_grad

    # lr: the paper's base rate (optim/schedule.py's default)
    ecfg = EngineConfig(steps=TRAIN_STEPS, batch=TRAIN_BATCH,
                        rollout=TRAIN_ROLLOUT, precision="bf16", lr=1e-4,
                        log_every=1, seed=0)

    def engine():
        return TrainEngine("weathermixer-1b", reduced=False, device="cuda",
                           config=ecfg)

    t0 = time.perf_counter()
    eng = engine()
    setup_s = time.perf_counter() - t0
    cfg = eng.cfg
    check(cfg.remat and cfg.kernel == "pallas" and cfg.n_layers == 3,
          f"unexpected training config: remat={cfg.remat} "
          f"kernel={cfg.kernel} n_layers={cfg.n_layers}")

    # the first step against kernel="xla" on the same batch and weights
    r0 = int(eng.r_sched[0])
    t0 = time.perf_counter()
    batch0 = eng.pipeline.get(0, r0)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    mk, gk = value_and_grad(eng.params, batch0, cfg, eng.jcfg, r0)
    mx, gx = value_and_grad(eng.params, batch0, cfg,
                            eng.jcfg.replace(kernel="xla"), r0)
    lk, lx = float(mk["loss"]), float(mx["loss"])
    nk, nx = float(global_norm(gk)), float(global_norm(gx))
    leaf_err = max(float((a.float() - b.float()).abs().max()
                         / b.float().abs().max().clamp_min(1e-30))
                   for a, b in zip(ptree.leaves(gk), ptree.leaves(gx)))
    first = dict(rollout=r0, loss=lk, loss_xla=lx,
                 loss_rel_err=abs(lk - lx) / abs(lx), grad_norm=nk,
                 grad_norm_xla=nx, grad_norm_rel_err=abs(nk - nx) / nx,
                 max_leaf_rel_err=leaf_err, tol=TRAIN_TOL)
    check(first["loss_rel_err"] <= TRAIN_TOL
          and first["grad_norm_rel_err"] <= TRAIN_TOL
          and leaf_err <= TRAIN_TOL,
          f"first training step vs kernel='xla': {first}")
    del gk, gx
    torch.cuda.empty_cache()

    # -- the main path: counts to 0 just before, read just after -----------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    BM.block_matmul.launches = 0
    BM.block_matmul.layout_launches.clear()
    t0 = time.perf_counter()
    hist = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = BM.block_matmul.launches
    by_layout = dict(BM.block_matmul.layout_launches)
    peak = torch.cuda.max_memory_allocated()
    # ----------------------------------------------------------------------

    sched = [int(r) for r in eng.r_sched]
    want = sum(5 + 54 * r for r in sched) * ecfg.accum
    check(launches == want, f"{launches} kernel launches in training steps "
          f"with rollouts {sched} (want {want}: 5 + 54 r per step)")
    # forward + remat + GELU recompute 2 + 30 r, dx 1 + 12 r, dw 2 + 12 r
    layouts = {"x,w": by_layout.get((False, False), 0),
               "x,w.T (dx)": by_layout.get((False, True), 0),
               "x.T,w.T (dw)": by_layout.get((True, True), 0)}
    want_layouts = {"x,w": sum(2 + 30 * r for r in sched) * ecfg.accum,
                    "x,w.T (dx)": sum(1 + 12 * r for r in sched) * ecfg.accum,
                    "x.T,w.T (dw)": sum(2 + 12 * r for r in sched)
                    * ecfg.accum}
    check(layouts == want_layouts and sum(by_layout.values()) == launches,
          f"training launches by operand layout {by_layout}, want "
          f"{want_layouts}")
    check(peak < PEAK_MEM_LIMIT, f"training peak memory {peak / 1e9:.2f} GB")
    check(len(hist) == TRAIN_STEPS
          and all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                  for h in hist), f"bad training history {hist}")
    recs = eng.tracer.step_records()
    wait_s = sum(r["data_wait_s"] for r in recs)
    step_ms = {}
    for r in sorted(set(sched)):
        got = [1e3 * (x["dur_s"] - x["data_wait_s"]) for x in recs
               if x["rollout"] == r]
        step_ms[r] = sum(got) / len(got)
    # device time of one step at each rollout length (CUDA events; these
    # updates come after the run and are not part of it)
    device_ms = {r: cuda_ms(lambda r=r: eng.dispatch(batch0, r), 1)
                 for r in range(1, TRAIN_ROLLOUT + 1)}
    # of which forward + backward (the rest: grad norm, clip, Adam)
    fwd_bwd_ms = {r: cuda_ms(lambda r=r: value_and_grad(
        eng.params, batch0, cfg, eng.jcfg, r), 1)
        for r in range(1, TRAIN_ROLLOUT + 1)}
    bound_ms = {r: 1e3 * train_flops_per_sample(cfg, r)
                / PEAK_FLOPS["bfloat16"] for r in device_ms}
    stats = dict(
        params=cfg.param_count(), batch=TRAIN_BATCH, steps=TRAIN_STEPS,
        rollout_schedule=sched, setup_s=setup_s, batch_host_s=batch_s,
        first_step_vs_xla=first, wall_s=wall, kernel_launches=launches,
        launches_per_step=[5 + 54 * r for r in sched],
        launches_by_layout=layouts,
        loss=[h["loss"] for h in hist],
        grad_norm=[h["grad_norm"] for h in hist],
        lr=[h["lr"] for h in hist],
        step_ms_by_rollout=step_ms, device_step_ms_by_rollout=device_ms,
        device_fwd_bwd_ms_by_rollout=fwd_bwd_ms,
        device_ms_per_sample_step={r: v / TRAIN_BATCH
                                   for r, v in device_ms.items()},
        bound_ms_per_sample_step=bound_ms,
        data_wait_s=wait_s,
        data_wait_share=wait_s / sum(r["dur_s"] for r in recs),
        peak_mem_gb=peak / 1e9)
    emit(phase="train", **stats)
    del eng, batch0
    torch.cuda.empty_cache()

    # the same seed again: the history must repeat bit for bit
    hist2 = engine().run()
    same = ([(h["loss"], h["grad_norm"]) for h in hist]
            == [(h["loss"], h["grad_norm"]) for h in hist2])
    check(same, f"two runs of one seed differ: {hist} vs {hist2}")
    emit(phase="train_repeat", bitwise_equal=True,
         loss=[h["loss"] for h in hist2])
    torch.cuda.empty_cache()
    return launches, stats


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs a "
              "GPU", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import block_matmul as BM
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit(phase="device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=False)
    t0 = time.perf_counter()
    built = BM.build()
    emit(phase="build", built=built, seconds=time.perf_counter() - t0,
         library=BM.build_info["library"])

    rows, worst = kernel_phase(torch, BM, ref)
    eng, fields, serve_launches = serve_phase(torch, BM)
    legacy_phase(torch, BM, eng, fields)
    del eng, fields
    torch.cuda.empty_cache()
    bwd_rows, bwd_worst = kernel_bwd_phase(torch, BM, ref)
    train_launches, train = train_phase(torch, BM)

    step = [r for r in rows if r["per_step"]]

    def per_step(key):
        return sum(r[key] * r["per_step"] for r in step)

    def per_train_step(key):
        return sum(r[key] * r["per_train_step"] for r in rows + bwd_rows)

    emit(kernels=[{
        "name": "block_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_matmul.cu",
        "replaces": "src/repro/kernels/block_matmul.py:37",
        "launches": serve_launches + train_launches,
        "launches_by_path": {"serve": serve_launches,
                             "train": train_launches},
        "train_launches_by_layout": train["launches_by_layout"],
        "max_abs_err": max(worst, bwd_worst),
        # times: the 14 GEMMs of one bf16 forecast step at bucket 1
        "ms": per_step("kernel_ms"),
        "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in step) else "bytes"),
        "library_ms": per_step("library_ms"),
        # the 59 GEMMs of one training sample-step at rollout 1 (batch 1):
        # forward, remat and GELU recomputes, dx and dw
        "train_ms": per_train_step("kernel_ms"),
        "train_plain_ms": per_train_step("plain_ms"),
        "train_bound_ms": per_train_step("bound_ms"),
        "train_library_ms": per_train_step("library_ms"),
        "shapes": rows,
        "shapes_bwd": bwd_rows,
    }])
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
