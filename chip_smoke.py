#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

from the root of a checkout.  It builds the port's kernels from the sources
in ``src/repro_torch/kernels/csrc`` and drives the port's main paths at
``weathermixer-1b``'s and ``mamba2-130m``'s full published widths, through
the entry points a user calls: the Mamba-2 forward and greedy generation,
forecast serving, one-GPU training, the 2-D Jigsaw (Cannon) training step
at q = 1 and on a 2x2 mesh of four ranks sharing the card, and the 1-D
Jigsaw (ring) training step on two ranks sharing the card.  Phases, each
printed as a JSON line:

  1. the card (``nvidia-smi``) and the kernel builds (block_matmul.cu,
     wx.cu, ring.cu, cannon.cu and ssd_chunk.cu, one nvcc each, started
     together);
  2. the block_matmul kernel against its plain PyTorch version on the card:
     small ragged shapes in f32 and bf16 with every epilogue, then the six
     GEMM shapes of a weathermixer-1b forecast step (bucket 1) in bf16 and
     tok_fc1 in f32, and the five GEMM shapes of a mamba2-130m forward
     (8,192 rows) and of its decode step (4 rows) in bf16, each timed
     beside the plain version, one PyTorch library call computing the same
     function (never used by the port) and the card's bound; each row with
     its route (the Hopper loop, or the WMMA loop where M or N is under
     64), load paths, registers, spills, shared bytes, tiles, waves and
     the per-call padding's time, and every Hopper-loop result held bit for
     bit against the WMMA loop's on the same operands (timed too);
  2b. the ssd_chunk kernel (``ssd_shape``) against its plain version: small
     ragged chunks in f32 and bf16 and a chunk whose decay overflows exp
     above the diagonal (the output must be finite), then mamba2-130m's
     groups at sequence 2048 (batch 1) and 4096 (batch 2) in f32, timed
     beside the plain version, the closest library composition (bmm,
     where, * dt, bmm) and the bound;
  2c. ``mamba_forward``: the full-width mamba2-130m forward (24 layers,
     random bf16 weights from seed 0) at sequence 4096 and batch 2 on
     ``TokenDataset`` rows, 24 ssd and 97 block_matmul launches, logits
     finite, its time and tokens/s; then, on the same weights in f32, the
     forward against the same with the plain SSD term and with
     ``kernel="xla"``, and the bf16 logits against the f32 ones;
  2d. ``mamba_generate``: ``serve.step.generate`` at batch 4 (64-token
     prompts, 32 new tokens; token-wise prefill, then decode steps), no ssd
     launch and 97 block_matmul launches per step, tokens in range, the
     token-wise logits at every prompt position against the teacher-forced
     forward (judged in f32, printed in bf16), the time of a decode step;
  3. full-width serving under the bf16 policy: requests admitted before and
     during a rollout, outputs finite, one lead-1 forecast against the plain
     forecast step, every request bitwise equal to its solo bucket-1
     rollout, 14 kernel launches per device step;
  4. the legacy path (the config's own dtypes: bf16 weights, f32
     activations, f32 kernel) for one step against the plain version;
  5. the backward GEMMs of the six shapes (bucket 1): dx = dz @ w and
     dw = dz.T @ x through the kernel's transposed-operand variants,
     against the plain version, each timed beside the plain version, the
     library's product and the bound, with the rows of phase 2; dw of
     tok_fc1 in f32 too;
  6. the wx kernel (the transposed-Cannon step of the 2-D token mix) at
     the full-width token-mix shapes of q = 1 and of a 2x2 rank, batch 1
     and 2: the forward in bf16 with a non-zero f32 accumulator, and dx
     from the bf16 w (read across its rows) and an f32 dy, once bf16-exact
     (one split term, the 2-D path's) and once not (three terms), each
     against its plain version, dx also against a float64 oracle and the
     term count the card recorded, timed beside the plain version, the
     closest PyTorch library call, the bound and, for dx, the f32 FMA
     kernel that took it before and the split pass;
  7. the ring step kernels (``ring_shape``) at the six full-width 1-D
     linear shapes for p = 2 and 4 ranks held in one process (rank r
     writes rank r+1's slot; the order of the launches is the barrier), in
     bf16, and tok_fc1 in f32: the forward against the ring of
     block_matmul's products and its plain version, the backward's dw
     against block_matmul's dw of the gathered cotangent and its dx
     accumulator against the plain one and, in bf16, bit for bit against
     the wx step loop; rank 0's launches timed (the backward also with dx
     off) beside the plain steps, cuBLAS chunk products with the adds, and
     the bound, each row with every operand's load path, the kernels'
     registers, local and shared bytes, and the backward's tiles and waves;
  8. the Cannon kernel (``cannon_shape``) at the two full-width token-mix
     shapes of a 2x2 rank, batch 1 and 2 in bf16, and tok_fc1 in f32, the
     four ranks held in one process (rank (i, j) writes the slots of
     (i, j-1) and (i-1, j); the order of the launches is the barrier):
     every rank bit for bit the step loop (one wx launch per step) and
     within the wx tolerance of the plain Cannon; rank 0's q launches timed
     beside the plain steps, torch.baddbmm per step and the bound, each
     row with the operands' load paths, the kernel's registers, local and
     shared bytes, tiles and waves; then q = 3 at a small size;
  9. full-width training (``TrainEngine``, bf16 policy, batch 2, rollout
     up to 2): the first step's loss, grad norm and per-leaf gradients
     against the same step with ``kernel="xla"``; on the same weights and
     batch, one 2-D (``scheme="2d"``, the 1x1 mesh) forward and backward,
     with its 18 r wx and 5 + 30 r block_matmul launches, every dx launch
     at one split term, held against the ``scheme="none"`` step
     (``train_2d``); one 1-D (``scheme="1d"``,
     ``impl="ring_fused"``) forward and backward on two ranks, this file
     re-run as two processes (``--train-1d-rank``) that share the card
     under gloo and reach each other's ring slots through CUDA IPC, with
     (2 + 24 r) p ring_fwd and (2 + 12 r) p ring_bwd launches per rank and
     no block_matmul, held against the same none step and, bit for bit in
     its loss, against ``impl="ring_chunked"`` (``train_1d``); one 2-D
     forward and backward on a 2x2 mesh, this file re-run as four
     processes (``--train-2d-rank``) sharing the card under gloo, each
     reading only its block of the batch (``pipeline="sharded"``, 1/4 of
     the bytes, bit for bit ``field_block`` of the whole batch) and
     reaching its predecessors' Cannon slots through CUDA IPC, with 24 r
     cannon, 12 r + 12 r wx (every dx at one split term) and 10 + 60 r
     block_matmul launches per rank, held against the none step and, bit for bit in loss and grad norm,
     against the step with ``fused_cannon_t`` forced to the step loop
     (``train_2d_mesh``); then the run, with 5 + 54 r
     kernel launches per step of rollout r, finite losses, peak memory
     under 80 GB; then a second run of the same seed, whose loss and
     grad-norm history must equal the first's bit for bit;
  10. the ``kernels`` line, the card's name and power limit, and the last
     line ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line.  Without CUDA, or
run outside a checkout, it exits non-zero and prints no result.

Tolerances (|kernel - plain| <= atol + rtol * |plain|, elementwise):
  * bf16 GEMMs 3e-2 / 3e-2: the output is rounded to bf16 (2^-8 relative)
    and a different summation order flips some roundings (the bf16
    tolerance of the repository's kernel tests);
  * f32 GEMMs 1e-4 / 1e-4: exact f32 FMA, but K runs to 16,380 in an order
    other than cuBLAS's (~sqrt(K) * 2^-24 relative);
  * wx: the bf16 forward 1e-3 / 1e-3 (its f32 output is not rounded and
    bf16 products are exact in f32, so the error is the summation order's:
    1.2e-4 at most at these shapes, where a bf16 rounding of the
    accumulator, a or the output would show up to 1.6e-2), dx 1e-4 / 1e-4
    (every product of the bf16 w and a split term of dy is exact in f32)
    and 1e-4 max-normalised against a float64 oracle (``WX_DX_F64_TOL``);
  * block_matmul's Hopper loop: bit for bit its WMMA loop;
  * whole forecast step, max|a - b| / max|b|: bf16 policy 5e-2 (the plain
    step rounds each GEMM to bf16 before its bias and activation, the
    kernel after, through 3 blocks of bf16 residual stream); legacy f32
    1e-4;
  * first training step against ``kernel="xla"``, and the 2-D step
    against the ``scheme="none"`` step: loss and grad norm relative, each
    gradient leaf max|a - b| / max|b|, all 5e-2 (the reference's bf16
    loss-parity bound; the same rounding difference as the forecast step,
    through the backward too: the 2-D branch rounds each GEMM to bf16
    before its bias and GELU, the none path after);
  * ring forward: bit for bit the ring of block_matmul's products (the same
    K order, the same cast points); against the plain version bf16 3e-2 /
    3e-2 (every hop rounds to bf16), f32 1e-4 / 1e-4; ring backward: dw bit
    for bit block_matmul's, dx's f32 accumulator 1e-4 max-normalised
    against the plain one (another order over m) and, in bf16, bit for bit
    the wx step loop (the kernel it replaces ran the same WMMA loop and
    epilogue), dx that accumulator rounded;
  * the 1-D step against the none step: loss 1e-3 and grad norm 5e-3
    relative, the worst gradient leaf 5e-2 max-normalised (the 1-D path
    rounds each linear's partial sums to bf16 at every hop and adds the
    bias after the reduce); the 2x2 step the same bounds (each Cannon
    linear rounds its product to bf16 before its bias, as under q = 1);
  * the Cannon kernel: bit for bit the step loop (wx's main loop, K order
    and epilogue); against the plain Cannon the wx tolerances;
  * the ssd kernel: f32 2e-4 / 2e-4 (the reference's own kernel tolerance:
    sums of N = 128 and Q = 64 terms in another order), bf16 3e-2 / 3e-2
    (att and y rounded to bf16);
  * mamba2-130m logits, judged in f32 (the seed's weights up-cast, where
    only summation orders differ): max|a - b| / max|b| 1e-3 against the
    plain SSD term and against ``kernel="xla"``; token-wise decode against
    the teacher-forced forward 5e-3 / 5e-3 elementwise (the reference's
    own); the bf16 forward against the f32 one by mean|a - b| / mean|b|
    0.3, a gross-fault check only: the random-weight bf16 residual stream
    amplifies rounding through 24 layers (``MAMBA_BF16_TOL``).
The plain versions run with ``torch.backends.cuda.matmul.allow_tf32 =
False``, so their f32 products are full f32.
"""
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
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


def gemm_bound_ms(m, n, k, dtype_name, bias, batch=1, mn_bytes=None):
    """Least time on the card: FLOPs over the peak rate for the operand
    type, or bytes (each input read once, the output written once) over
    the memory rate, whichever is larger.  ``batch`` products share the
    [m, k] operand (wx's w); ``mn_bytes`` is what each of the batch's
    [m, n] elements moves: the output in the operand type unless given
    (wx: its f32 output, plus the f32 accumulator ``a`` it reads)."""
    es = 4 if dtype_name == "float32" else 2
    mn_bytes = es if mn_bytes is None else mn_bytes
    flops = 2.0 * batch * m * n * k
    nbytes = (es * (m * k + batch * n * k) + batch * m * n * mn_bytes
              + es * (n if bias else 0))
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def gemm_errors(y, r, dtype_name):
    tol = GEMM_TOL[dtype_name]
    y, r = y.float(), r.float()
    err = (y - r).abs()
    ok = bool((err <= tol + tol * r.abs()).all())
    return float(err.max()), ok


def sm_count(torch):
    return torch.cuda.get_device_properties(0).multi_processor_count


def bm_route_fields(torch, BM, SM90, x, w, m, n, k, epi, x_t, w_t):
    """What a block_matmul launch at this shape runs: its route, its
    kernel's registers, spills and shared bytes, its operands' load paths,
    its tiles and waves, and the device time of the per-call padding of
    operands whose rows TMA cannot take (0 where none is padded)."""
    path = BM.route(m, n, x.dtype)
    if path != "sm90":
        vb = BM.vec_bytes(x, w) if path == "wmma" else 4
        blocks = -(-m // 128) * -(-n // 128)
        return dict(route=path, loads=f"{vb} B",
                    kernel=BM.kernel_attrs(path, x_t, w_t, epi, vb),
                    tiles=blocks, grid=blocks, waves=blocks / sm_count(torch),
                    pad_ms=0.0)
    ops = SM90.tma_operands_block_matmul(m, n, k, x_t, w_t)
    tiles = SM90.sm90_tiles(m, n)
    grid = SM90.persistent_grid(tiles, False, sm_count(torch))
    padded = [t for t in (x, w) if SM90.pad_rows(t) is not t]
    return dict(route=path,
                loads={name: op.describe() for name, op in ops.items()},
                kernel=BM.kernel_attrs(path, x_t, w_t, epi),
                tiles=tiles, grid=grid, waves=tiles / grid,
                pad_ms=(cuda_ms(lambda: [SM90.pad_rows(t) for t in padded])
                        if padded else 0.0))


def check_routes_agree(torch, BM, y, args, kw, what):
    """A bf16 result of the Hopper loop against the WMMA loop's on the same
    operands, bit for bit (the same k16 steps in the same K order, the
    same epilogue); returns the WMMA launch's device time."""
    y_w = BM.block_matmul(*args, route_name="wmma", **kw)
    torch.cuda.synchronize()
    check(torch.equal(y, y_w), f"{what}: the Hopper loop's result is not "
          "bit for bit the WMMA loop's")
    return cuda_ms(lambda: BM.block_matmul(*args, route_name="wmma", **kw))


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

# mamba2-130m (d_model 768, d_inner 1536, conv_dim 1536 + 2 * 128, 24 heads,
# vocab 50,432), its forward at sequence 4096 and batch 2 (M = 8192 rows)
# and its decode step at batch 4 (M = 4): (label, M, K, N, launches per
# forward or decode step); no bias, no epilogue
MAMBA_SEQ, MAMBA_BATCH, MAMBA_LAYERS = 4096, 2, 24
GEN_BATCH, GEN_PROMPT, GEN_STEPS = 4, 64, 32
_MM = MAMBA_SEQ * MAMBA_BATCH
MAMBA_SHAPES = [(f"{tag}.{name}", m, k, n, per)
                for tag, m in (("fwd", _MM), ("decode", GEN_BATCH))
                for name, k, n, per in (("in_z", 768, 1536, MAMBA_LAYERS),
                                        ("in_xbc", 768, 1792, MAMBA_LAYERS),
                                        ("in_dt", 768, 24, MAMBA_LAYERS),
                                        ("out_proj", 1536, 768, MAMBA_LAYERS),
                                        ("head", 768, 50432, 1))]

def kernel_phase(torch, BM, SM90, ref):
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
    n_small = n_bitwise = 0
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
                    what = f"small {name} {(m, k, n)} {epi} bias={bias}"
                    check(ok, f"{what}: max err {err:.3e}")
                    if BM.route(m, n, dtype) == "sm90":
                        check_routes_agree(torch, BM, y, (x, w, b, epi), {},
                                           what)
                        n_bitwise += 1
                    worst = max(worst, err)
                    n_small += 1
    emit(phase="kernel_small", cases=n_small, max_abs_err=worst,
         bitwise_wmma_cases=n_bitwise, ok=True)

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
                   **bm_route_fields(torch, BM, SM90, x, w, m, n, k, epi,
                                     False, False),
                   max_abs_err=err, tol=GEMM_TOL[name],
                   kernel_ms=cuda_ms(lambda: BM.block_matmul(x, w, b, epi)),
                   library_ms=cuda_ms(library),
                   plain_ms=cuda_ms(lambda: ref.block_matmul_ref(x, w, b,
                                                                 epi), 3),
                   bound_ms=bound, bound_by=bound_by)
        if row["route"] == "sm90":
            row["wmma_ms"] = check_routes_agree(torch, BM, y, (x, w, b, epi),
                                                {}, label)
            row["bitwise_wmma"] = True
        row["tflops"] = 2e-9 * m * n * k / row["kernel_ms"]
        emit(phase="kernel_shape", **row)
        rows.append(row)
        del x, w, b, y
        torch.cuda.empty_cache()

    mamba_rows = []
    for label, m, k, n, per_path in MAMBA_SHAPES:
        x, w, _ = inputs(m, k, n, torch.bfloat16, False)
        y = BM.block_matmul(x, w)
        torch.cuda.synchronize()
        err, ok = gemm_errors(y, ref.block_matmul_ref(x, w), "bfloat16")
        check(ok, f"{label} {(m, k, n)}: max err {err:.3e}")
        worst = max(worst, err)
        bound, bound_by = gemm_bound_ms(m, n, k, "bfloat16", False)
        row = dict(shape=label, m=m, n=n, k=k, dtype="bfloat16",
                   epilogue="none", per_path=per_path,
                   **bm_route_fields(torch, BM, SM90, x, w, m, n, k, "none",
                                     False, False),
                   max_abs_err=err, tol=GEMM_TOL["bfloat16"],
                   kernel_ms=cuda_ms(lambda: BM.block_matmul(x, w), 10),
                   library_ms=cuda_ms(lambda: F.linear(x, w), 10),
                   plain_ms=cuda_ms(lambda: ref.block_matmul_ref(x, w), 3),
                   bound_ms=bound, bound_by=bound_by)
        if row["route"] == "sm90":
            row["wmma_ms"] = check_routes_agree(torch, BM, y, (x, w), {},
                                                label)
            row["bitwise_wmma"] = True
        row["tflops"] = 2e-9 * m * n * k / row["kernel_ms"]
        emit(phase="kernel_shape", **row)
        mamba_rows.append(row)
        del x, w, y
    torch.cuda.empty_cache()
    return rows, mamba_rows, worst


# ---------------------------------------------------------------------------
# phases 2b-2d: the ssm family (mamba2-130m): the ssd kernel, forward, generate
# ---------------------------------------------------------------------------

SSD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
SSD_Q, SSD_N, SSD_P, SSD_HEADS = 64, 128, 64, 24
# G = batch x chunks x heads of the two forwards
SSD_SHAPES = [("seq2048.b1", 2048 // SSD_Q * SSD_HEADS),
              ("seq4096.b2", 2 * MAMBA_SEQ // SSD_Q * SSD_HEADS)]
# mamba2-130m logits.  Judged in f32 (the seed's weights up-cast), where
# only the summation orders differ: max|a - b| / max|b| against the plain
# SSD term and against kernel="xla", and token-wise decode against the
# teacher-forced forward elementwise at the reference's own 5e-3
# (tests/test_decode_consistency.py).  The bf16 forward (the config's own
# dtypes) against the f32 one by mean|a - b| / mean|b|: a random-weight
# bf16 residual stream through 24 layers amplifies rounding (on the CPU, 1%
# of the linears' outputs moved by one bf16 step moves the logits by 15 % of
# their mean, and bf16 against f32 is 16-18 %), so only a gross fault
# (zeros, a wrong layout: ~100 %) is caught there.
MAMBA_F32_TOL = 1e-3
MAMBA_DECODE_TOL = 5e-3
MAMBA_BF16_TOL = 0.3


def ssd_inputs(torch, gen, g, q, n, p, dtype, decay=None):
    """c, b, x in ``dtype``; dt = softplus(N(0, 1)); dac the within-chunk
    cumsum of dt * A with the model's initial A = -linspace(1, 16, 24) by
    head (g % 24), or -decay.  Above the diagonal exp(dac_i - dac_j)
    overflows to inf for the faster heads at Q = 64."""
    c = (0.3 * torch.randn(g, q, n, generator=gen, device="cuda")).to(dtype)
    b = (0.3 * torch.randn(g, q, n, generator=gen, device="cuda")).to(dtype)
    x = torch.randn(g, q, p, generator=gen, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(g, q, generator=gen, device="cuda"))
    if decay is None:
        a = -torch.linspace(1.0, 16.0, SSD_HEADS, device="cuda").repeat(
            (g + SSD_HEADS - 1) // SSD_HEADS)[:g, None]
    else:
        a = torch.full((g, 1), -decay, device="cuda")
    return c, b, x, dt, torch.cumsum(dt * a, dim=1)


def ssd_bound_ms(g, q, n, p, dtype_name):
    """Each input read once (c, b, x in the operand type, dt and dac f32),
    y written once; the operations the causal half needs, 2 (N + P) per
    (i, j <= i) pair, at the operand type's peak."""
    es = 4 if dtype_name == "float32" else 2
    nbytes = g * (es * q * (2 * n + 2 * p) + 8 * q)
    ops = g * (n + p) * q * (q + 1)
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ssd_phase(torch, SSD, ref):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def errors(y, r, name):
        tol = SSD_TOL[name]
        y, r = y.float(), r.float()
        err = (y - r).abs()
        return float(err.max()), bool((err <= tol + tol * r.abs()).all())

    worst = 0.0
    n_small = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for q in (64, 37):
            for n in (32, 128):
                for p in (16, 64):
                    args = ssd_inputs(torch, gen, 6, q, n, p, dtype,
                                      decay=0.1)
                    y = SSD.ssd_intra_chunk(*args)
                    torch.cuda.synchronize()
                    err, ok = errors(y, ref.ssd_intra_ref(*args), name)
                    check(ok, f"ssd small {name} Q={q} N={n} P={p}: max err "
                              f"{err:.3e}")
                    worst = max(worst, err)
                    n_small += 1
        # dac decaying fast enough that exp overflows above the diagonal
        args = ssd_inputs(torch, gen, 4, 64, 128, 64, dtype, decay=16.0)
        dac = args[4]
        check(bool(torch.isinf(torch.exp(dac[:, :, None]
                                         - dac[:, None, :])).any()),
              "the overflow case does not overflow")
        y = SSD.ssd_intra_chunk(*args)
        torch.cuda.synchronize()
        err, ok = errors(y, ref.ssd_intra_ref(*args), name)
        check(ok and bool(torch.isfinite(y).all()),
              f"ssd overflow case {name}: max err {err:.3e}, finite "
              f"{bool(torch.isfinite(y).all())}")
        worst = max(worst, err)
        n_small += 1
    emit(phase="ssd_small", cases=n_small, max_abs_err=worst, ok=True)

    rows = []
    q, n, p = SSD_Q, SSD_N, SSD_P
    tri = torch.ones((q, q), dtype=torch.bool, device="cuda").tril()
    for label, g in SSD_SHAPES:
        c, b, x, dt, dac = args = ssd_inputs(torch, gen, g, q, n, p,
                                             torch.float32)
        y = SSD.ssd_intra_chunk(*args)
        torch.cuda.synchronize()
        err, ok = errors(y, ref.ssd_intra_ref(*args), "float32")
        check(ok and bool(torch.isfinite(y).all()),
              f"ssd {label} G={g}: max err {err:.3e}")
        worst = max(worst, err)

        def library():
            s = torch.bmm(c, b.transpose(1, 2))
            att = torch.where(tri, s * torch.exp(dac[:, :, None]
                                                 - dac[:, None, :]), 0.0)
            return torch.bmm(att * dt[:, None, :], x)
        bound, bound_by = ssd_bound_ms(g, q, n, p, "float32")
        row = dict(shape=label, g=g, q=q, n=n, p=p, dtype="float32",
                   max_abs_err=err, tol=SSD_TOL["float32"],
                   kernel_ms=cuda_ms(lambda: SSD.ssd_intra_chunk(*args), 20),
                   library_ms=cuda_ms(library, 10),
                   plain_ms=cuda_ms(lambda: ref.ssd_intra_ref(*args), 10),
                   bound_ms=bound, bound_by=bound_by)
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        emit(phase="ssd_shape", **row)
        rows.append(row)
        del c, b, x, dt, dac, args, y
    torch.cuda.empty_cache()
    return rows, worst


def zero_counts(kernels):
    for fn in kernels:
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches.clear()


def read_counts(kernels):
    return {fn.__name__: fn.launches for fn in kernels}


def read_routes(kernels):
    """block_matmul's launches by route since ``zero_counts``."""
    bm = next(fn for fn in kernels if fn.__name__ == "block_matmul")
    return dict(bm.route_launches)


# mamba2-130m's block_matmul routes: in_dt (N = 24) and, in the decode
# step, every GEMM (M = 4) run the WMMA loop; the rest the Hopper loop
MAMBA_FWD_ROUTES = {"sm90": 3 * MAMBA_LAYERS + 1, "wmma": MAMBA_LAYERS}


@contextmanager
def plain_ssd(ops, ref):
    """The model's forward with ``ref.ssd_intra_ref`` in place of the ssd
    kernel (``ops.ssd_intra``, which ``_ssd_chunked`` calls): the only
    difference from the kernel's forward."""
    saved, ops.ssd_intra = ops.ssd_intra, ref.ssd_intra_ref
    try:
        yield
    finally:
        ops.ssd_intra = saved


def mamba_setup(torch):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import JigsawConfig
    from repro_torch.models import registry as M
    cfg = get_config("mamba2-130m")
    # the reference's one-device engine runs scheme="none"
    jcfg = JigsawConfig(scheme="none", kernel="pallas")
    t0 = time.perf_counter()
    params = M.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    emit(phase="mamba_setup", params=cfg.param_count(),
         param_dtype=cfg.param_dtype, n_layers=cfg.n_layers,
         d_model=cfg.d_model, vocab_padded=cfg.vocab_padded,
         init_s=time.perf_counter() - t0)
    return cfg, jcfg, params


def token_rows(torch, cfg, seq, batch, step):
    from repro_torch.data.tokens import TokenDataConfig, TokenDataset
    rows = TokenDataset(TokenDataConfig(cfg.vocab_size, seq)).sample_batch(
        step, batch)["tokens"]
    return torch.from_numpy(rows).cuda()


def mean_rel(a, b):
    return float((a - b).abs().mean() / b.abs().mean())


def mamba_f32(torch, cfg, params):
    """The same weights in f32, and the config that runs them so (every
    GEMM then runs the kernel's exact f32 FMA variant)."""
    from repro_torch.core import tree as ptree
    return (cfg.replace(param_dtype="float32", compute_dtype="float32"),
            ptree.map(lambda t: t.float(), params))


def mamba_forward_phase(torch, kernels, ops, ref, cfg, jcfg, params):
    from repro_torch.models import registry as M
    batch = {"tokens": token_rows(torch, cfg, MAMBA_SEQ, MAMBA_BATCH, 0)}
    cfg32, params32 = mamba_f32(torch, cfg, params)
    with torch.no_grad():
        # -- the main path: counts to 0 just before, read just after -------
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(kernels)
        logits, _ = M.apply(params, batch, cfg, jcfg)
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        routes = read_routes(kernels)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # ------------------------------------------------------------------
        check(routes == MAMBA_FWD_ROUTES, f"mamba forward block_matmul "
              f"routes {routes}, want {MAMBA_FWD_ROUTES}")
        check(launches["ssd_intra_chunk"] == MAMBA_LAYERS
              and launches["block_matmul"] == 4 * MAMBA_LAYERS + 1,
              f"mamba forward launches {launches} (want {MAMBA_LAYERS} ssd, "
              f"{4 * MAMBA_LAYERS + 1} block_matmul)")
        check(tuple(logits.shape) == (MAMBA_BATCH, MAMBA_SEQ,
                                      cfg.vocab_padded)
              and bool(torch.isfinite(logits).all()),
              f"mamba logits {tuple(logits.shape)} not finite or misshapen")
        ms = cuda_ms(lambda: M.apply(params, batch, cfg, jcfg), 3)

        # f32: the kernel forward against the plain SSD term (the only
        # difference) and against kernel="xla"; bf16 against f32
        ref32, _ = M.apply(params32, batch, cfg32, jcfg)
        bf16_err = mean_rel(logits.float(), ref32)
        bf16_top1 = float((logits.float().argmax(-1)
                           == ref32.argmax(-1)).float().mean())
        del logits
        with plain_ssd(ops, ref):
            plain, _ = M.apply(params32, batch, cfg32, jcfg)
        ssd_err = rel_err(ref32, plain)
        del plain
        xla, _ = M.apply(params32, batch, cfg32, jcfg.replace(kernel="xla"))
        xla_err = rel_err(ref32, xla)
        del xla, ref32
        check(ssd_err <= MAMBA_F32_TOL,
              f"mamba f32 logits, ssd kernel vs plain: {ssd_err:.3e}")
        check(xla_err <= MAMBA_F32_TOL,
              f"mamba f32 logits, pallas vs xla: {xla_err:.3e}")
        check(bf16_err <= MAMBA_BF16_TOL,
              f"mamba bf16 logits vs f32: {bf16_err:.3e} of the mean")
        ms32 = cuda_ms(lambda: M.apply(params32, batch, cfg32, jcfg), 2)
    torch.cuda.empty_cache()
    tokens = MAMBA_SEQ * MAMBA_BATCH
    emit(phase="mamba_forward", seq=MAMBA_SEQ, batch=MAMBA_BATCH,
         launches=launches, block_matmul_routes=routes, ms_per_forward=ms,
         tokens_per_s=tokens / (ms / 1e3), peak_mem_gb=peak_gb,
         f32_ms_per_forward=ms32,
         f32_vs_plain_ssd=ssd_err, f32_vs_xla=xla_err, tol_f32=MAMBA_F32_TOL,
         bf16_vs_f32_mean=bf16_err, tol_bf16_mean=MAMBA_BF16_TOL,
         bf16_vs_f32_top1_agree=bf16_top1)
    return launches


def decode_logits(torch, M, params, prompts, cfg, jcfg, cache_dtype):
    """Token-wise logits at every prompt position, from a fresh cache."""
    cache = M.init_cache(cfg, prompts.shape[0], prompts.shape[1],
                         dtype=cache_dtype, device="cuda")
    got = []
    for t in range(prompts.shape[1]):
        logits, cache = M.decode_step(params, cache, prompts[:, t:t + 1],
                                      cfg, jcfg)
        got.append(logits[:, 0])
    return torch.stack(got, 1), cache


def mamba_generate_phase(torch, kernels, cfg, jcfg, params):
    from repro_torch.models import registry as M
    from repro_torch.serve import step as S
    prompts = token_rows(torch, cfg, GEN_PROMPT, GEN_BATCH, 1)
    max_len = GEN_PROMPT + GEN_STEPS
    # -- the main path: counts to 0 just before, read just after -----------
    torch.cuda.synchronize()
    zero_counts(kernels)
    t0 = time.perf_counter()
    out = S.generate(params, prompts, cfg, jcfg, steps=GEN_STEPS,
                     max_len=max_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(kernels)
    routes = read_routes(kernels)
    # ----------------------------------------------------------------------
    n_steps = GEN_PROMPT + GEN_STEPS - 1      # token-wise prefill + decode
    check(routes == {"wmma": launches["block_matmul"]},
          f"generate's block_matmul routes {routes}: M = {GEN_BATCH} takes "
          "the WMMA loop")
    check(launches["ssd_intra_chunk"] == 0,
          f"{launches['ssd_intra_chunk']} ssd launches on the decode path")
    check(launches["block_matmul"] == n_steps * (4 * MAMBA_LAYERS + 1),
          f"generate launches {launches} (want {4 * MAMBA_LAYERS + 1} "
          f"block_matmul per step, {n_steps} steps)")
    check(tuple(out.shape) == (GEN_BATCH, GEN_STEPS)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"generated tokens {tuple(out.shape)} out of range")
    cfg32, params32 = mamba_f32(torch, cfg, params)
    with torch.no_grad():
        # decode consistency: token-wise logits at every prompt position
        # against the teacher-forced forward (the kernel path), judged in
        # f32 and printed in bf16
        want32, _ = M.apply(params32, {"tokens": prompts}, cfg32, jcfg)
        got32, _ = decode_logits(torch, M, params32, prompts, cfg32, jcfg,
                                 torch.float32)
        err32 = (got32 - want32).abs()
        decode_ok = bool((err32 <= MAMBA_DECODE_TOL
                          + MAMBA_DECODE_TOL * want32.abs()).all())
        want, _ = M.apply(params, {"tokens": prompts}, cfg, jcfg)
        got, cache = decode_logits(torch, M, params, prompts, cfg, jcfg,
                                   torch.bfloat16)
        bf16_abs = float((got.float() - want.float()).abs().max())
        bf16_mean = mean_rel(got.float(), want.float())
        check(decode_ok, f"mamba f32 decode vs teacher-forced: max abs "
                         f"{float(err32.max()):.3e}")
        step = S.make_serve_step(cfg, jcfg)
        nxt = out[:, -1:]
        step_ms = cuda_ms(lambda: step(params, cache, nxt), 10)
    emit(phase="mamba_generate", batch=GEN_BATCH, prompt=GEN_PROMPT,
         new_tokens=GEN_STEPS, launches=launches, block_matmul_routes=routes,
         wall_s=wall,
         host_ms_per_step=1e3 * wall / n_steps,
         device_ms_per_decode_step=step_ms,
         f32_decode_max_abs_err=float(err32.max()), tol=MAMBA_DECODE_TOL,
         bf16_decode_max_abs_err=bf16_abs, bf16_decode_mean_rel=bf16_mean,
         first_tokens=out[0, :8].tolist())
    return launches


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


def kernel_bwd_phase(torch, BM, SM90, ref):
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
                       **bm_route_fields(torch, BM, SM90, a, b, om, on, ok_,
                                         "none", x_t, True),
                       max_abs_err=err, tol=GEMM_TOL[name],
                       kernel_ms=cuda_ms(kernel), library_ms=cuda_ms(library),
                       plain_ms=cuda_ms(plain, 3), bound_ms=bound,
                       bound_by=bound_by)
            if row["route"] == "sm90":
                row["wmma_ms"] = check_routes_agree(
                    torch, BM, y, (a, b), dict(x_t=x_t, w_t=True),
                    f"{label}.{kind}")
                row["bitwise_wmma"] = True
            row["tflops"] = 2e-9 * om * on * ok_ / row["kernel_ms"]
            emit(phase="kernel_bwd_shape", **row)
            rows.append(row)
            del y
        del x, w, dz
        torch.cuda.empty_cache()
    return rows, worst



# ---------------------------------------------------------------------------
# phase 6: the wx kernel against its plain version
# ---------------------------------------------------------------------------

# the token-mix Cannon steps at full width: (label, m, t, c) of w [m, t] @
# x [L, t, c], and the launches of one 2-D training sample-step at r = 1
# (3 blocks, remat): forward-layout launches (forward and rerun, one per
# Cannon step), dx launches.  q = 1 is this card's path; the 2x2 rank
# blocks are what each rank of a four-card mesh runs (q = 2 steps each).
WX_SHAPES = [("q1.tok_fc1", 8640, 16380, 4320, (6, 3)),
             ("q1.tok_fc2", 16380, 8640, 4320, (6, 3)),
             ("2x2.tok_fc1", 4320, 8190, 2160, (12, 6)),
             ("2x2.tok_fc2", 8190, 4320, 2160, (12, 6))]
# wx's output is f32 under both operand types, and bf16 products are exact
# in f32, so plain and kernel differ only in summation order (max 1.2e-4
# at these shapes): a kernel that rounds its accumulator, a or its output
# to bf16 (up to 1.6e-2 at |v| 4-8) must fail.  dx (bf16 w, f32 dy split
# into bf16 terms, every product exact in f32) 1e-4 likewise.
WX_TOL = {"bfloat16": 1e-3, "float32": 1e-4}
# dx against a float64 oracle, max|dx - oracle| / max|oracle|: f32
# accumulation of exact products over K <= 16,380 terms errs ~1e-5 of the
# max at most; a dx that dropped the second and third terms of an inexact
# dy would err by bf16's rounding of dy, ~1e-3 of the max
WX_DX_F64_TOL = 1e-4


def wx_bound_ms(ll, m, n, k, x_bytes, out_bytes, terms=1):
    """Least time of one wx launch: ``terms`` bf16 products [m, k] @ [k, n]
    per batch element over the bf16 peak, or the bytes (w in bf16 once, x
    at ``x_bytes`` an element, each [m, n] output element ``out_bytes``:
    written, plus the accumulator read where there is one) over the memory
    rate."""
    flops = 2.0 * terms * ll * m * n * k
    nbytes = 2 * m * k + x_bytes * ll * k * n + out_bytes * ll * m * n
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def wx_phase(torch, WX, SM90, ref):
    """Per shape and batch: the forward a + w @ x[l] in bf16 (the Cannon
    step) against ref.wx_ref; and dx = w.T @ dy[l] from the bf16 w (read
    across its rows) and an f32 dy, twice: dy the f32 image of a bf16
    cotangent (the 2-D path's: one term) and an inexact dy (three terms),
    each against ref.wx_ref, a float64 oracle and the term count the card
    recorded.  Timed beside the plain version, the library (torch.matmul(w,
    x) + a: cuBLAS bf16, rounded to bf16, then the f32 add; for dx
    torch.matmul(w.float().t(), dy), cuBLAS f32, TF32 off), the f32 FMA
    kernel that took dx before (``fma_ms``), the split pass alone and the
    per-call padding of w; each row names the operands' load paths, the
    kernel's registers, spills and shared bytes, its tiles and waves."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, worst = [], 0.0
    sms = sm_count(torch)
    for label, m, t, c, (n_fwd, n_dx) in WX_SHAPES:
        w = (torch.randn(m, t, generator=gen, device="cuda")
             / t ** 0.5).to(torch.bfloat16)
        w32 = w.float()
        pad_ms = (cuda_ms(lambda: SM90.pad_rows(w))
                  if SM90.pad_rows(w) is not w else 0.0)
        for ll in (1, 2):
            x = torch.randn(ll, t, c, generator=gen,
                            device="cuda").to(torch.bfloat16)
            a = torch.randn(ll, m, c, generator=gen, device="cuda")
            dy3 = torch.randn(ll, m, c, generator=gen, device="cuda")
            dy1 = dy3.to(torch.bfloat16).float()
            cases = [("fwd", None, (m, c, t), n_fwd,
                      lambda: WX.wx(w, x, a), lambda: ref.wx_ref(w, x, a),
                      lambda: torch.matmul(w, x) + a)]
            for terms, dy in ((1, dy1), (3, dy3)):
                cases.append((
                    "dx", terms, (t, c, m), n_dx if terms == 1 else 0,
                    lambda dy=dy: WX.wx(w, dy, None, w_t=True),
                    lambda dy=dy: ref.wx_ref(w, dy, None, w_t=True),
                    lambda dy=dy: torch.matmul(w32.t(), dy)))
            for kind, terms, (gm, gn, gk), count, kernel, plain, lib in cases:
                WX.reset_dx_terms()
                y = kernel()
                torch.cuda.synchronize()
                got_terms = WX.dx_terms()
                r = plain()
                tol = WX_TOL["float32" if kind == "dx" else "bfloat16"]
                what = f"wx {label}.{kind} L={ll}" + (
                    f" {terms} term(s)" if terms else "")
                err = float((y - r).abs().max())
                check(bool(((y - r).abs() <= tol + tol * r.abs()).all()),
                      f"{what}: max err {err:.3e}")
                worst = max(worst, err)
                del r
                row = dict(shape=f"{label}.{kind}", batch=ll, m=gm, n=gn,
                           k=gk, w_t=kind == "dx", per_train_step=count)
                if kind == "dx":
                    want = {1: int(terms == 1), 3: int(terms == 3)}
                    check(got_terms == want, f"{what}: the card's term "
                          f"counts {got_terms}, want {want}")
                    dy = dy1 if terms == 1 else dy3
                    oracle = torch.matmul(w.double().t(), dy.double())
                    f64_err = rel_err(y.double(), oracle)
                    del oracle
                    check(f64_err <= WX_DX_F64_TOL, f"{what}: against the "
                          f"float64 oracle {f64_err:.3e}")
                    bound, bound_by = wx_bound_ms(ll, gm, gn, gk, 4, 4,
                                                  terms)
                    row.update(dtype="bfloat16 w, float32 dy", terms=terms,
                               f64_rel_err=f64_err, f64_tol=WX_DX_F64_TOL,
                               split_ms=cuda_ms(lambda: WX.split_terms(dy)),
                               fma_ms=cuda_ms(lambda: WX.wx(
                                   w32, dy, None, w_t=True), 2))
                else:
                    bound, bound_by = wx_bound_ms(ll, gm, gn, gk, 2, 8)
                    row.update(dtype="bfloat16")
                del y
                ops = SM90.tma_operands_wx(ll, gm, gn, gk, kind == "dx")
                tiles = ll * SM90.sm90_tiles(gm, gn)
                grid = SM90.persistent_grid(tiles, False, sms)
                row.update(
                    route="sm90",
                    loads={name: op.describe() for name, op in ops.items()},
                    kernel=WX.kernel_attrs("sm90", kind == "dx"),
                    tiles=tiles, grid=grid, waves=tiles / grid,
                    pad_ms=pad_ms, max_abs_err=err, tol=tol,
                    kernel_ms=cuda_ms(kernel), library_ms=cuda_ms(lib),
                    plain_ms=cuda_ms(plain, 3), bound_ms=bound,
                    bound_by=bound_by)
                row["tflops"] = (2e-9 * (terms or 1) * ll * gm * gn * gk
                                 / row["kernel_ms"])
                emit(phase="wx_shape", **row)
                rows.append(row)
            del x, a, dy1, dy3
            torch.cuda.empty_cache()
        del w, w32
        torch.cuda.empty_cache()
    emit(phase="wx_split", kernel=WX.kernel_attrs("split"))
    return rows, worst

# ---------------------------------------------------------------------------
# phase 7: the ring step kernels against their plain versions
# ---------------------------------------------------------------------------

# the six 1-D linears of weathermixer-1b at batch 1: (label, rows, d, m) of
# x [rows, d] @ w [m, d].T, each rank holding d/p of x's and w's columns;
# forward ring calls per training sample-step at r = 1 (the forward and,
# for the mixing linears, the checkpoint's rerun) and backward calls
RING_SHAPES = [("encoder", _T, _PD, _D, 1, 1),
               ("tok_fc1", _D, _T, 8640, 6, 3),
               ("tok_fc2", _D, 8640, _T, 6, 3),
               ("ch_fc1", _T, _D, 4320, 6, 3),
               ("ch_fc2", _T, 4320, _D, 6, 3),
               ("decoder", _T, _D, _PD, 1, 1)]
RING_PS = (2, 4)
# the forward rounds to the wire dtype at every hop (bf16: a summation
# order other than the plain version's flips some roundings, the GEMM
# bound); dx's f32 accumulator differs from the plain one in order only
RING_TOL = {"bfloat16": 3e-2, "float32": 1e-4}
RING_DX_TOL = 1e-4


def ring_bound_ms(rows, d_l, m, p, dtype_name, bwd, dx=True):
    """Least time of one rank's p launches of a ring call: its GEMM work
    (the forward x [rows, d/p] @ w [m, d/p].T; the backward dw and, with
    ``dx``, dx: twice that) over the peak, or the bytes (x, w and the
    output read or written once, each of the p - 1 hops read and written
    once; the backward also dw and the f32 dx accumulator, read and
    written) over the memory rate."""
    es = 4 if dtype_name == "float32" else 2
    mc = m // p
    flops = 2.0 * rows * m * d_l * (1 + int(bwd and dx))
    hop = rows * mc * es
    nbytes = es * (rows * d_l + m * d_l) + 2 * (p - 1) * hop
    nbytes += (rows * mc * es + es * m * d_l + int(dx) * 8 * rows * d_l
               if bwd else rows * mc * es)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ring_phase(torch, BM, RING, WX, ref):
    """p ranks held in one process (rank r's destination is rank r+1's
    slot; the order of the launches on one stream is the barrier), at each
    full-width 1-D linear for p = 2 and 4 in bf16, and tok_fc1 at p = 2 in
    f32: the forward bit for bit against the ring of block_matmul's
    products and within RING_TOL of the plain version; dw bit for bit
    against block_matmul's dw of the gathered cotangent; dx's f32
    accumulator within RING_DX_TOL (max-normalised) of the plain one and,
    in bf16, bit for bit the wx step loop that the kernel replaces (acc =
    wx(cur_s, w_j[None], acc): the WMMA loop, the same epilogue); dx that
    accumulator rounded.  Then rank 0's p launches timed, forward and
    backward (the backward with its per-call padding of x, w and dy, and
    with dx off: dw alone), beside the plain steps, the library's
    (torch.matmul chunk products and the adds) and the bound; each row
    names every operand's load path, each kernel's registers, local and
    shared bytes, and the backward's tiles and waves.  On one card a hop is
    a store into device memory, not an NVLink write."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = [(p, shape, "bfloat16") for p in RING_PS for shape in RING_SHAPES]
    cases.append((2, RING_SHAPES[1], "float32"))
    rows_out, worst = [], {"fwd": 0.0, "bwd": 0.0}
    for p, (label, rows, d, m, n_fwd, n_bwd), name in cases:
        dtype = getattr(torch, name)
        dl, mc = d // p, m // p
        xs = [torch.randn(rows, dl, generator=gen, device="cuda").to(dtype)
              for _ in range(p)]
        ws = [(torch.randn(m, dl, generator=gen, device="cuda")
               / d ** 0.5).to(dtype) for _ in range(p)]
        dys = [torch.randn(rows, mc, generator=gen, device="cuda").to(dtype)
               for _ in range(p)]
        outs = RING.ring_fwd_all(xs, ws)
        torch.cuda.synchronize()
        parts = [BM.block_matmul(x, w) for x, w in zip(xs, ws)]
        ring = ref.ring_walk_all(lambda r, j: parts[r][:, j * mc:(j + 1)
                                                       * mc],
                                 p, dtype, torch.float32)
        check(all(torch.equal(a, b) for a, b in zip(outs, ring)),
              f"ring_fwd {label} p={p} {name}: not bit for bit the ring of "
              "block_matmul's products")
        del parts, ring
        plain = ref.ring_fwd_all_ref(xs, ws, torch.float32)
        tol = RING_TOL[name]
        fwd_err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(outs, plain))
        check(all(bool(((a.float() - b.float()).abs()
                        <= tol + tol * b.float().abs()).all())
                  for a, b in zip(outs, plain)),
              f"ring_fwd {label} p={p} {name} vs plain: {fwd_err:.3e}")
        del outs, plain
        dxs, dws, accs = RING.ring_bwd_all(xs, ws, dys)
        torch.cuda.synchronize()
        gathered = torch.cat(dys, dim=1)
        check(all(torch.equal(dw, BM.block_matmul(gathered, x, x_t=True,
                                                  w_t=True))
                  for dw, x in zip(dws, xs)),
              f"ring_bwd {label} p={p} {name}: dw not bit for bit "
              "block_matmul's")
        check(all(torch.equal(dx, a.to(dtype)) for dx, a in zip(dxs, accs)),
              f"ring_bwd {label} p={p} {name}: dx is not its accumulator "
              "rounded")
        del gathered, dxs, dws
        _, _, paccs = ref.ring_bwd_all_ref(xs, ws, dys)
        dx_err = max(rel_err(a, b) for a, b in zip(accs, paccs))
        dx_abs = max(float((a - b).abs().max())
                     for a, b in zip(accs, paccs))
        check(dx_err <= RING_DX_TOL,
              f"ring_bwd {label} p={p} {name}: dx accumulator vs plain "
              f"{dx_err:.3e}")
        del paccs
        if name == "bfloat16":
            for r in range(p):
                loop = None
                for s in range(p):
                    j = (r - s) % p
                    loop = WX.wx(dys[j], ws[r][j * mc:(j + 1) * mc][None],
                                 loop)
                check(torch.equal(accs[r], loop[0]),
                      f"ring_bwd {label} p={p} {name}: dx accumulator of "
                      f"rank {r} not bit for bit the wx step loop")
                del loop
        del accs
        torch.cuda.empty_cache()
        worst["fwd"] = max(worst["fwd"], fwd_err)
        worst["bwd"] = max(worst["bwd"], dx_abs)

        # rank 0's p launches of one ring call, as the ring runs them
        x, w, dy = xs[0], ws[0], dys[0]
        slots = [torch.empty(rows, mc, dtype=dtype, device="cuda")
                 for _ in range(2)]
        out = torch.empty(rows, mc, dtype=dtype, device="cuda")
        acc = torch.empty(rows, dl, dtype=torch.float32, device="cuda")
        dx = torch.empty(rows, dl, dtype=dtype, device="cuda")
        dw = torch.empty(m, dl, dtype=dtype, device="cuda")
        need_dx = label != "encoder"        # the encoder's input is data

        def fwd_kernel():
            for s in range(p):
                RING.ring_fwd(x, w, (-1 - s) % p,
                              None if s == 0 else slots[(s - 1) % 2],
                              out if s == p - 1 else slots[s % 2])

        def fwd_plain():
            y = None
            for s in range(p):
                j = (-1 - s) % p
                y = ref.ring_fwd_step_ref(x, w[j * mc:(j + 1) * mc], y,
                                          torch.float32)
            return y

        def fwd_library():
            y = None
            for s in range(p):
                j = (-1 - s) % p
                z = torch.matmul(x, w[j * mc:(j + 1) * mc].t())
                y = z if y is None else (y.float() + z.float()).to(dtype)
            return y

        bwd_slots = [RING.empty_rows_like(RING.pad_rows(dy))
                     for _ in range(2)]

        def bwd_kernel(with_dx=need_dx):
            # as fused_ring._card_backward: x, w and dy padded once per call
            xp, wp, dyp = (RING.pad_rows(t) for t in (x, w, dy))
            for s in range(p):
                RING.ring_bwd(xp, wp, (-s) % p,
                              dyp if s == 0 else bwd_slots[(s - 1) % 2],
                              bwd_slots[s % 2] if s < p - 1 else None, dw,
                              acc if with_dx else None,
                              dx if with_dx else None, first=s == 0,
                              last=s == p - 1)

        def bwd_plain():
            a = None
            for s in range(p):
                j = (-s) % p
                dw[j * mc:(j + 1) * mc], a = ref.ring_bwd_step_ref(
                    x, w[j * mc:(j + 1) * mc], dy, a)
            return a

        def bwd_library():
            for s in range(p):
                j = (-s) % p
                dw[j * mc:(j + 1) * mc] = torch.matmul(dy.t(), x)
                if need_dx:
                    z = torch.matmul(dy, w[j * mc:(j + 1) * mc]).float()
                    acc.copy_(z) if s == 0 else acc.add_(z)

        bf16 = name == "bfloat16"
        # the forward loads every operand at one width: the widest that
        # x and each launch's w_j allow; the backward reads through TMA
        vb = (min(RING._vec_bytes(x, w[j * mc:]) for j in range(p))
              if bf16 else 4)
        n_dw, n_dx = RING.ring_bwd_tiles(rows, dl, mc, need_dx)
        grid = RING.persistent_grid(n_dw + n_dx, p > 1, sm_count(torch))
        fwd_blocks = -(-rows // 128) * -(-mc // 128)
        row = dict(shape=label, p=p, rows=rows, d=d, m=m, dtype=name,
                   fwd_calls_per_train_step=n_fwd,
                   bwd_calls_per_train_step=n_bwd,
                   fwd_loads={"x": f"{vb} B", "w_j": f"{vb} B"},
                   bwd_loads=({k: op.describe() for k, op in
                               RING.tma_operands_ring_bwd(
                                   rows, dl, mc, need_dx).items()}
                              if bf16 else "4 B (f32 FMA tiles)"),
                   fwd_kernel=RING.kernel_attrs(2 if bf16 else 3, vb),
                   bwd_kernel=RING.kernel_attrs(0 if bf16 else 1),
                   fwd_blocks=fwd_blocks,
                   fwd_waves=fwd_blocks / sm_count(torch),
                   bwd_tiles={"dw": n_dw, "dx": n_dx}, bwd_grid=grid,
                   bwd_waves=(n_dw + n_dx) / grid,
                   fwd_max_abs_err=fwd_err, fwd_tol=tol,
                   dx_acc_rel_err=dx_err, dx_acc_max_abs_err=dx_abs,
                   dx_tol=RING_DX_TOL,
                   dx_acc_bitwise_wx_step_loop=bf16)
        for kind, kernel, plain_fn, lib in (
                ("fwd", fwd_kernel, fwd_plain, fwd_library),
                ("bwd", bwd_kernel, bwd_plain, bwd_library)):
            bound, bound_by = ring_bound_ms(rows, dl, m, p, name,
                                            kind == "bwd", need_dx)
            row.update({f"{kind}_kernel_ms": cuda_ms(kernel),
                        f"{kind}_plain_ms": cuda_ms(plain_fn, 3),
                        f"{kind}_library_ms": cuda_ms(lib),
                        f"{kind}_bound_ms": bound,
                        f"{kind}_bound_by": bound_by})
            work = 2e-9 * rows * m * dl * (1 + int(kind == "bwd"
                                                   and need_dx))
            row[f"{kind}_tflops"] = work / row[f"{kind}_kernel_ms"]
        if need_dx:
            row["bwd_dw_only_ms"] = cuda_ms(lambda: bwd_kernel(False))
        emit(phase="ring_shape", **row)
        rows_out.append(row)
        del xs, ws, dys, x, w, dy, slots, bwd_slots, out, acc, dx, dw
        torch.cuda.empty_cache()
    return rows_out, worst


# ---------------------------------------------------------------------------
# phase 8: the Cannon kernel against the step loop and its plain version
# ---------------------------------------------------------------------------

# the token-mix Cannon loops of a 2x2 rank at full width: (label, m, t, c)
# of w [m, t] @ x [L, t, c], and the loops per training sample-step at
# r = 1 (3 blocks: the forward and the checkpoint's rerun), q launches each
CANNON_Q = 2
CANNON_SHAPES = [("2x2.tok_fc1", 4320, 8190, 2160, 6),
                 ("2x2.tok_fc2", 8190, 4320, 2160, 6)]


def cannon_bound_ms(ll, m, t, c, q, dtype_name):
    """Least time of one rank's q launches of a Cannon loop: its q GEMMs
    over the peak, or the bytes (each step's w and x read, the f32
    accumulator written at the first step and read and written after, the
    q - 1 hops of w and x written) over the memory rate."""
    es = 4 if dtype_name == "float32" else 2
    flops = 2.0 * q * ll * m * t * c
    ops = es * (m * t + ll * t * c)
    nbytes = (q * ops + (q - 1) * ops + 4 * ll * m * c
              + (q - 1) * 8 * ll * m * c)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def cannon_phase(torch, CANNON, WX, RING, ref):
    """The q x q ranks of a mesh held in one process (rank r's step s writes
    its predecessors' slots s % 2, tensors here; the launch order on one
    stream is the barrier) at the two token-mix shapes of a 2x2 rank, batch
    1 and 2, bf16, and tok_fc1 in f32 at batch 1: every rank's result bit
    for bit the step loop (one wx launch per step, the blocks rotated the
    same way), and within WX_TOL of the plain Cannon; then rank 0's q
    launches timed (with the per-loop padding of w and x where their rows
    need it) beside the plain steps, the library's (torch.baddbmm per
    step, no hops) and the bound; each row names every operand's load
    path, the kernel's registers, local and shared bytes, and its tiles
    and waves.  Then q = 3 at a small size, both checks.  On one card a
    hop is a store into HBM, not an NVLink write."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    q = CANNON_Q
    cases = [(shape, ll, "bfloat16") for shape in CANNON_SHAPES
             for ll in (1, 2)]
    cases.append((CANNON_SHAPES[0], 1, "float32"))
    rows, worst = [], 0.0

    def blocks(q, ll, m, t, c, dtype):
        ws = [(torch.randn(m, t, generator=gen, device="cuda") / t ** 0.5
               ).to(dtype) for _ in range(q * q)]
        xs = [torch.randn(ll, t, c, generator=gen, device="cuda").to(dtype)
              for _ in range(q * q)]
        return ws, xs

    def checked(ws, xs, q, name, what):
        got = CANNON.cannon_fwd_all(ws, xs, q)
        torch.cuda.synchronize()
        loop = ref.cannon_walk_all(lambda w, x, a: WX.wx(w, x, a), ws, xs,
                                   q)
        check(all(torch.equal(a, b) for a, b in zip(got, loop)),
              f"cannon {what}: not bit for bit the step loop")
        del loop
        tol = WX_TOL[name]
        err = 0.0
        for a, b in zip(got, ref.cannon_ref(ws, xs, q)):
            check(bool(((a - b).abs() <= tol + tol * b.abs()).all()),
                  f"cannon {what} vs plain: max err "
                  f"{float((a - b).abs().max()):.3e}")
            err = max(err, float((a - b).abs().max()))
        return err

    for (label, m, t, c, calls), ll, name in cases:
        dtype = getattr(torch, name)
        ws, xs = blocks(q, ll, m, t, c, dtype)
        err = checked(ws, xs, q, name, f"{label} L={ll} {name}")
        worst = max(worst, err)
        # rank (0, 0)'s q launches of one loop: at step s it holds the
        # blocks of ranks (0, s) (w) and (s, 0) (x)
        w0, x0 = ws[0], xs[0]
        w_slots = [RING.empty_rows_like(RING.pad_rows(w0)) for _ in range(2)]
        x_slots = [RING.empty_rows_like(RING.pad_rows(x0)) for _ in range(2)]
        out = torch.empty(ll, m, c, device="cuda")
        steps = [(ws[s], xs[s * q]) for s in range(q)]

        def kernel():
            # as fused_ring._card_cannon: the blocks padded once per loop
            wp, xp = RING.pad_rows(w0), RING.pad_rows(x0)
            for s in range(q):
                last = s == q - 1
                CANNON.cannon_step(
                    wp if s == 0 else w_slots[(s - 1) % 2],
                    xp if s == 0 else x_slots[(s - 1) % 2], out,
                    first=s == 0, w_dest=None if last else w_slots[s % 2],
                    x_dest=None if last else x_slots[s % 2])

        def plain():
            acc = None
            for w, x in steps:
                acc = ref.wx_ref(w, x, acc)
            return acc

        def library():
            acc = torch.zeros(ll, m, c, dtype=dtype, device="cuda")
            for w, x in steps:
                acc = torch.baddbmm(acc, w.expand(ll, m, t), x)
            return acc

        bound, bound_by = cannon_bound_ms(ll, m, t, c, q, name)
        bf16 = name == "bfloat16"
        tiles = ll * RING.sm90_tiles(m, c)
        grid = RING.persistent_grid(tiles, True, sm_count(torch))
        row = dict(shape=label, q=q, batch=ll, m=m, t=t, c=c, dtype=name,
                   calls_per_train_step=calls,
                   loads=({k: op.describe() for k, op in
                           RING.tma_operands_cannon(ll, m, c, t).items()}
                          if bf16 else "4 B (f32 FMA tiles)"),
                   kernel=CANNON.kernel_attrs(f32=not bf16),
                   tiles=tiles if bf16 else None,
                   grid=grid if bf16 else None,
                   waves=tiles / grid if bf16 else None,
                   bitwise_step_loop=True, max_abs_err=err,
                   tol=WX_TOL[name], kernel_ms=cuda_ms(kernel),
                   plain_ms=cuda_ms(plain, 3), library_ms=cuda_ms(library),
                   bound_ms=bound, bound_by=bound_by,
                   bound_ms_per_launch=bound / q)
        row["tflops"] = 2e-9 * q * ll * m * t * c / row["kernel_ms"]
        emit(phase="cannon_shape", **row)
        rows.append(row)
        del ws, xs, w0, x0, w_slots, x_slots, out, steps
        torch.cuda.empty_cache()
    for name in ("bfloat16", "float32"):
        ws, xs = blocks(3, 2, 300, 129, 70, getattr(torch, name))
        err = checked(ws, xs, 3, name, f"q=3 {name}")
        worst = max(worst, err)
        emit(phase="cannon_q3", dtype=name, shape=[2, 300, 129, 70],
             bitwise_step_loop=True, max_abs_err=err, tol=WX_TOL[name])
    return rows, worst


# ---------------------------------------------------------------------------
# phase 9: full-width training
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


def train_2d_bound_ms_per_sample(cfg, rollout, q=1):
    """The least device time of one 2-D training sample-step (3 blocks,
    remat), per rank of a q x q mesh: per block and pass, the token mix's
    8 GEMMs (forward, rerun, dw and dx of both linears; at q > 1 two more,
    the fused Cannon's VJP recomputing the forward), the channel mix's 8
    (forward, rerun, dx, dw), and 5 encoder/decoder GEMMs, all over the
    bf16 peak: dx too, which on this path is one bf16 product (the
    cotangent is bf16-exact: wx's dx route contracts one split term); a
    rank does 1/q**2 of it."""
    t = (cfg.wm_lat // cfg.wm_patch) * (cfg.wm_lon // cfg.wm_patch)
    d, pd = cfg.d_model, cfg.wm_patch ** 2 * cfg.wm_channels
    enc = 2.0 * t * pd * d
    tok = 2.0 * d * cfg.wm_d_tok * t
    ch = 2.0 * t * cfg.wm_d_ch * d
    passes = rollout * cfg.n_layers
    flops = 5 * enc + passes * ((8 if q == 1 else 10) * tok + 8 * ch)
    return 1e3 * flops / PEAK_FLOPS["bfloat16"] / q ** 2


def fwd_bwd_ms(torch, params, batch, cfg, jcfg, rollout):
    """Device time of one forward (to the loss) and of its backward (CUDA
    events around each)."""
    from repro_torch.core import tree as ptree
    from repro_torch.train.step import loss_fn
    live = [p.detach().requires_grad_(True) for p in ptree.leaves(params)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    with torch.enable_grad():
        ev[0].record()
        loss, _ = loss_fn(ptree.unflatten(params, live), batch, cfg, jcfg,
                          rollout)
        ev[1].record()
        torch.autograd.grad(loss, live)
        ev[2].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])


def leaf_rel_err(torch, got, want):
    from repro_torch.core import tree as ptree
    return max(float((a.float() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30))
               for a, b in zip(ptree.leaves(got), ptree.leaves(want)))


def train_2d_phase(torch, BM, WX, eng, batch0, r0, none_metrics,
                   none_grads):
    """One 2-D forward and backward (scheme="2d" on the 1x1 mesh: each rank
    of a q x q mesh runs this code on its blocks, with rotations between
    the Cannon steps) on the train phase's weights and first batch, held
    against the scheme="none" step's loss, grad norm and gradients."""
    from repro_torch.optim.adam import global_norm
    from repro_torch.train.step import value_and_grad
    cfg2 = eng.cfg.replace(scheme="2d")
    jcfg2 = eng.jcfg.replace(scheme="2d")
    # -- the 2-D path: counts to 0 just before, read just after -------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    BM.block_matmul.launches = 0
    WX.wx.launches = 0
    WX.wx.layout_launches.clear()
    WX.reset_dx_terms()
    m2, g2 = value_and_grad(eng.params, batch0, cfg2, jcfg2, r0)
    torch.cuda.synchronize()
    bm_launches, wx_launches = BM.block_matmul.launches, WX.wx.launches
    wx_dx = WX.wx.layout_launches[True]
    dx_terms = WX.dx_terms()
    peak = torch.cuda.max_memory_allocated()
    # ----------------------------------------------------------------------
    check((bm_launches, wx_launches, wx_dx) == (5 + 30 * r0, 18 * r0, 6 * r0),
          f"2-D step at r={r0}: {bm_launches} block_matmul and "
          f"{wx_launches} wx launches ({wx_dx} dx); want {5 + 30 * r0}, "
          f"{18 * r0} ({6 * r0})")
    # the cotangent that reaches dx is a bf16 one cast up: every dx launch
    # contracts one split term
    check(dx_terms == {1: wx_dx, 3: 0}, f"2-D step: dx launches by term "
          f"count {dx_terms}, want all {wx_dx} at one term")
    l2, ln = float(m2["loss"]), float(none_metrics["loss"])
    n2, nn = float(global_norm(g2)), float(global_norm(none_grads))
    leaf_err = leaf_rel_err(torch, g2, none_grads)
    stats = dict(rollout=r0, loss=l2, loss_none=ln,
                 loss_rel_err=abs(l2 - ln) / abs(ln), grad_norm=n2,
                 grad_norm_none=nn, grad_norm_rel_err=abs(n2 - nn) / nn,
                 max_leaf_rel_err=leaf_err, tol=TRAIN_TOL,
                 block_matmul_launches=bm_launches, wx_launches=wx_launches,
                 wx_dx_launches=wx_dx, wx_dx_terms=dx_terms,
                 peak_mem_gb=peak / 1e9)
    check(stats["loss_rel_err"] <= TRAIN_TOL
          and stats["grad_norm_rel_err"] <= TRAIN_TOL
          and leaf_err <= TRAIN_TOL, f"2-D step vs scheme='none': {stats}")
    del g2
    torch.cuda.empty_cache()
    # device time of a forward and its backward, both schemes (after the
    # checked run, which warmed them up; not part of it)
    f2, b2 = fwd_bwd_ms(torch, eng.params, batch0, cfg2, jcfg2, r0)
    f0, b0 = fwd_bwd_ms(torch, eng.params, batch0, eng.cfg, eng.jcfg, r0)
    stats.update(device_fwd_ms=f2, device_bwd_ms=b2,
                 device_fwd_bwd_ms=f2 + b2, none_device_fwd_ms=f0,
                 none_device_bwd_ms=b0, none_device_fwd_bwd_ms=f0 + b0,
                 batch=TRAIN_BATCH,
                 device_fwd_bwd_ms_per_sample=(f2 + b2) / TRAIN_BATCH,
                 bound_ms_per_sample=train_2d_bound_ms_per_sample(eng.cfg,
                                                                  r0))
    emit(phase="train_2d", **stats)
    torch.cuda.empty_cache()
    return stats


TRAIN_1D_P = 2
# against the scheme="none" step on the same weights and batch: the 1-D
# path rounds each linear's partial sums to bf16 at every hop and adds the
# bias after the reduce (the none path fuses bias and GELU into one
# rounding), so it agrees to bf16's precision, not bit for bit
TRAIN_1D_TOL = {"loss": 1e-3, "grad_norm": 5e-3, "leaf": 5e-2}


def train_1d_bound_ms_per_sample(p):
    """The least device time of one 1-D training sample-step on the card
    (both ranks' work; 3 blocks, remat, r = 1): every ring call's GEMMs
    (2 + 24 forward calls, 2 + 12 backward ones of dw and, but for the
    encoder, dx) over the bf16 peak.  Each rank does 1/p of it."""
    flops = 0.0
    for label, rows, d, m, n_fwd, n_bwd in RING_SHAPES:
        gemm = 2.0 * rows * m * d
        flops += gemm * (n_fwd + n_bwd * (1 if label == "encoder" else 2))
    return 1e3 * flops / PEAK_FLOPS["bfloat16"]


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def train_1d_phase(torch, eng, batch0, r0, none_metrics, none_grads):
    """One 1-D (scheme="1d", impl="ring_fused") forward and backward on
    TRAIN_1D_P ranks, one process each, sharing this card (gloo between
    them; each rank's ring slots mapped into its predecessor by CUDA IPC),
    through the TrainEngine on the train phase's weights (the same seed)
    and first batch (handed over in a file), held against this process's
    scheme="none" step on them; then the same step under
    impl="ring_chunked", whose loss must be the same bits."""
    import shutil
    import tempfile
    from repro_torch.convert import shard_params_1d
    from repro_torch.core import tree as ptree
    from repro_torch.optim.adam import global_norm
    p = TRAIN_1D_P
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_1d_"))
    try:
        t0 = time.perf_counter()
        torch.save({k: v.cpu() for k, v in batch0.items()},
                   tmp / "batch.pt")
        for r in range(p):
            shard = shard_params_1d(none_grads, r, p)
            fingerprint = [float(t.double().sum()) for t in
                           ptree.leaves(shard_params_1d(eng.params, r, p))]
            torch.save({"grads": ptree.map(lambda t: t.cpu(), shard),
                        "fingerprint": fingerprint}, tmp / f"none{r}.pt")
            del shard
        (tmp / "meta.json").write_text(json.dumps(dict(rollout=r0)))
        torch.cuda.empty_cache()
        handoff_s = time.perf_counter() - t0
        res, wall = run_ranks("--train-1d-rank", tmp, p)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    want_fwd, want_bwd = (2 + 24 * r0) * p, (2 + 12 * r0) * p
    for r, x in enumerate(res):
        check((x["ring_fwd_launches"], x["ring_bwd_launches"],
               x["block_matmul_launches"]) == (want_fwd, want_bwd, 0),
              f"train_1d rank {r}: {x['ring_fwd_launches']} ring_fwd, "
              f"{x['ring_bwd_launches']} ring_bwd and "
              f"{x['block_matmul_launches']} block_matmul launches; want "
              f"{want_fwd}, {want_bwd} and 0")
    ln = float(none_metrics["loss"])
    nn = float(global_norm(none_grads))
    loss, norm = res[0]["loss"], res[0]["grad_norm"]
    check(all(x["loss"] == loss and x["grad_norm"] == norm for x in res),
          "train_1d: the ranks report different losses or norms")
    leaf = max(max(x["leaf_diff"][i] for x in res)
               / max(max(x["leaf_ref"][i] for x in res), 1e-30)
               for i in range(len(res[0]["leaf_diff"])))
    stats = dict(ranks=p, rollout=r0, impl="ring_fused", loss=loss,
                 loss_none=ln, loss_rel_err=abs(loss - ln) / abs(ln),
                 grad_norm=norm, grad_norm_none=nn,
                 grad_norm_rel_err=abs(norm - nn) / nn,
                 max_leaf_rel_err=leaf, tol=TRAIN_1D_TOL,
                 loss_ring_chunked=res[0]["loss_ring_chunked"],
                 ring_fwd_launches=[x["ring_fwd_launches"] for x in res],
                 ring_bwd_launches=[x["ring_bwd_launches"] for x in res],
                 peak_mem_gb=[x["peak_mem_gb"] for x in res],
                 ring_slots_gb=[x["ring_slots_gb"] for x in res],
                 collectives_through_host=[x["through_host"] for x in res],
                 gb_through_host=[x["through_host_gb"] for x in res],
                 device_fwd_ms=[x["fwd_ms"] for x in res],
                 device_bwd_ms=[x["bwd_ms"] for x in res],
                 batch=TRAIN_BATCH,
                 device_fwd_bwd_ms_per_sample=max(
                     x["fwd_ms"] + x["bwd_ms"] for x in res) / TRAIN_BATCH,
                 bound_ms_per_sample=train_1d_bound_ms_per_sample(p),
                 handoff_s=handoff_s, wall_s=wall,
                 setup_s=[x["setup_s"] for x in res])
    check(stats["loss_rel_err"] <= TRAIN_1D_TOL["loss"]
          and stats["grad_norm_rel_err"] <= TRAIN_1D_TOL["grad_norm"]
          and leaf <= TRAIN_1D_TOL["leaf"],
          f"1-D step vs scheme='none': {stats}")
    check(all(x["loss_ring_chunked"] == x["loss"] for x in res),
          f"train_1d: ring_chunked's loss {res[0]['loss_ring_chunked']!r} "
          f"is not ring_fused's {loss!r} bit for bit")
    emit(phase="train_1d", **stats)
    return stats


def train_1d_worker(rank, tmp):
    """One rank of ``train_1d_phase`` (this file run with
    ``--train-1d-rank``): the process group from the environment, the
    engine on the (data=1, model=TRAIN_1D_P) mesh, one forward and backward
    with its launches counted, the comparison against this rank's shard of
    the none step's gradients, the timed forward and backward, and the
    ring_chunked step; results to rank<r>.json."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.core import comm
    from repro_torch.core import tree as ptree
    from repro_torch.kernels import block_matmul as BM
    from repro_torch.kernels import ring as RING
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.optim.adam import global_norm
    from repro_torch.train.step import _norm_args, value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tmp)
    r0 = json.loads((tmp / "meta.json").read_text())["rollout"]
    t0 = time.perf_counter()
    eng = TrainEngine("weathermixer-1b", reduced=False,
                      mesh_model=TRAIN_1D_P, scheme="1d", impl="ring_fused",
                      device="cuda",
                      config=EngineConfig(steps=1, batch=TRAIN_BATCH,
                                          precision="bf16", lr=1e-4, seed=0,
                                          pipeline="sync-full", prefetch=0,
                                          telemetry=False))
    none = torch.load(tmp / f"none{rank}.pt")
    check([float(t.double().sum()) for t in ptree.leaves(eng.params)]
          == none["fingerprint"], "train_1d: the engine's weights are not "
          "the train phase's")
    batch = {k: v.to(eng.device) for k, v in
             torch.load(tmp / "batch.pt").items()}
    cfg, jcfg = eng.cfg, eng.jcfg
    check(cfg.remat and cfg.kernel == "pallas" and jcfg.impl == "ring_fused"
          and dist.get_backend() == "gloo", "unexpected 1-D config")
    setup_s = time.perf_counter() - t0

    # -- the 1-D path: counts to 0 just before, read just after -------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    RING.ring_fwd.launches = RING.ring_bwd.launches = 0
    BM.block_matmul.launches = 0
    comm.through_host.clear()
    comm.through_host_bytes.clear()
    metrics, grads = value_and_grad(eng.params, batch, cfg, jcfg, r0)
    torch.cuda.synchronize()
    res = dict(ring_fwd_launches=RING.ring_fwd.launches,
               ring_bwd_launches=RING.ring_bwd.launches,
               block_matmul_launches=BM.block_matmul.launches,
               through_host=dict(comm.through_host),
               through_host_gb=sum(comm.through_host_bytes.values()) / 1e9,
               # the ring's slots are raw cudaMallocs, outside torch's
               # allocator: their bytes are added to its peak
               ring_slots_gb=RING.workspace_bytes() / 1e9,
               peak_mem_gb=(torch.cuda.max_memory_allocated()
                            + RING.workspace_bytes()) / 1e9)
    # ----------------------------------------------------------------------
    res["loss"] = float(metrics["loss"])
    res["grad_norm"] = float(global_norm(grads, **_norm_args(eng.params, cfg,
                                                             jcfg)))
    res["leaf_diff"], res["leaf_ref"] = [], []
    for a, b in zip(ptree.leaves(grads), ptree.leaves(none["grads"])):
        b = b.to(a.device).float()
        res["leaf_diff"].append(float((a.float() - b).abs().max()))
        res["leaf_ref"].append(float(b.abs().max()))
    del grads, none
    torch.cuda.empty_cache()
    res["fwd_ms"], res["bwd_ms"] = fwd_bwd_ms(torch, eng.params, batch, cfg,
                                              jcfg, r0)
    mc, _ = value_and_grad(eng.params, batch, cfg,
                           jcfg.replace(impl="ring_chunked"), r0)
    res["loss_ring_chunked"] = float(mc["loss"])
    res["setup_s"] = setup_s
    (tmp / f"rank{rank}.json").write_text(json.dumps(res))
    eng.close()
    dist.destroy_process_group()
    return 0


TRAIN_2D_Q = 2


def _step_loop(wl, xl, *, model_group, **kw):
    """fused_cannon_t forced to the step loop (one wx launch per step,
    rotations through comm.rotate): the variant the 2x2 step must equal."""
    from repro_torch.kernels import fused_ring
    return fused_ring.cannon_t_loop(wl, xl, **kw)


def run_ranks(flag, tmp, n, timeout=600):
    """This file re-run as n rank processes (``flag r tmp``) sharing the
    card, joined through ``env://`` on a free port; returns their
    rank<r>.json results and the wall seconds."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n))
    procs = []
    try:
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), flag, str(r),
             str(tmp)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(n)]
        outs = [pr.communicate(timeout=timeout) for pr in procs]
        wall = time.perf_counter() - t0
        for r, (pr, (_, err)) in enumerate(zip(procs, outs)):
            check(pr.returncode == 0, f"{flag} {r} failed "
                  f"({pr.returncode}):\n{err[-4000:]}")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    return [json.loads((Path(tmp) / f"rank{r}.json").read_text())
            for r in range(n)], wall


def train_2d_mesh_phase(torch, eng, batch0, r0, none_metrics, none_grads):
    """One 2-D (scheme="2d") forward and backward on a 2x2 mesh of four
    rank processes sharing this card (gloo between them; each rank's
    Cannon slots mapped into its predecessors by CUDA IPC), through the
    TrainEngine with per-rank reads (pipeline="sharded") on the train
    phase's weights (the same seed) and first step's batch, held against
    this process's scheme="none" step and, bit for bit, against the same
    step with fused_cannon_t forced to the step loop."""
    import shutil
    import tempfile
    from repro_torch.convert import shard_params_2d
    from repro_torch.core import tree as ptree
    from repro_torch.optim.adam import global_norm
    q, n = TRAIN_2D_Q, TRAIN_2D_Q ** 2
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_2d_"))
    try:
        t0 = time.perf_counter()
        torch.save({k: v.cpu() for k, v in batch0.items()},
                   tmp / "batch.pt")
        for r in range(n):
            i, j = divmod(r, q)
            shard = shard_params_2d(none_grads, i, j, q)
            fingerprint = [float(t.double().sum()) for t in
                           ptree.leaves(shard_params_2d(eng.params, i, j,
                                                        q))]
            torch.save({"grads": ptree.map(lambda t: t.cpu(), shard),
                        "fingerprint": fingerprint}, tmp / f"none{r}.pt")
            del shard
        (tmp / "meta.json").write_text(json.dumps(dict(rollout=r0)))
        torch.cuda.empty_cache()
        handoff_s = time.perf_counter() - t0
        res, wall = run_ranks("--train-2d-rank", tmp, n)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    want = dict(cannon=24 * r0, wx_fwd=12 * r0, wx_dx=12 * r0,
                block_matmul=10 + 60 * r0, ring=0)
    for r, x in enumerate(res):
        check(x["launches"] == want, f"train_2d_mesh rank {r}: launches "
              f"{x['launches']}, want {want} (counted on the CPU)")
        check(x["dx_terms"] == {"1": want["wx_dx"], "3": 0},
              f"train_2d_mesh rank {r}: dx launches by term count "
              f"{x['dx_terms']}, want all {want['wx_dx']} at one term")
        check(x["block_equal"], f"train_2d_mesh rank {r}: its batch is not "
              "field_block of the whole batch")
        check(x["read_share"] == 1 / n, f"train_2d_mesh rank {r} read "
              f"{x['read_share']} of the batch's bytes, want 1/{n}")
        check(x["loss"] == x["loss_step_loop"]
              and x["grad_norm"] == x["grad_norm_step_loop"],
              f"train_2d_mesh rank {r}: loss {x['loss']!r} / norm "
              f"{x['grad_norm']!r} differ from the step loop's "
              f"{x['loss_step_loop']!r} / {x['grad_norm_step_loop']!r}")
    ln = float(none_metrics["loss"])
    nn = float(global_norm(none_grads))
    loss, norm = res[0]["loss"], res[0]["grad_norm"]
    check(all(x["loss"] == loss and x["grad_norm"] == norm for x in res),
          "train_2d_mesh: the ranks report different losses or norms")
    leaf = max(max(x["leaf_diff"][i] for x in res)
               / max(max(x["leaf_ref"][i] for x in res), 1e-30)
               for i in range(len(res[0]["leaf_diff"])))
    peaks = [x["peak_mem_gb"] for x in res]
    stats = dict(ranks=n, mesh=f"{q}x{q}", rollout=r0, pipeline="sharded",
                 loss=loss, loss_none=ln,
                 loss_rel_err=abs(loss - ln) / abs(ln), grad_norm=norm,
                 grad_norm_none=nn, grad_norm_rel_err=abs(norm - nn) / nn,
                 max_leaf_rel_err=leaf, tol=TRAIN_1D_TOL,
                 loss_step_loop=res[0]["loss_step_loop"],
                 grad_norm_step_loop=res[0]["grad_norm_step_loop"],
                 launches=[x["launches"] for x in res],
                 wx_dx_terms=[x["dx_terms"] for x in res],
                 read_bytes=[x["read_bytes"] for x in res],
                 read_share=[x["read_share"] for x in res],
                 read_s=[x["read_s"] for x in res],
                 peak_mem_gb=peaks, peak_mem_gb_sum=sum(peaks),
                 cannon_slots_gb=[x["cannon_slots_gb"] for x in res],
                 collectives_through_host=[x["through_host"] for x in res],
                 gb_through_host=[x["through_host_gb"] for x in res],
                 device_fwd_ms=[x["fwd_ms"] for x in res],
                 device_bwd_ms=[x["bwd_ms"] for x in res],
                 batch=TRAIN_BATCH,
                 device_fwd_bwd_ms_per_sample=max(
                     x["fwd_ms"] + x["bwd_ms"] for x in res) / TRAIN_BATCH,
                 bound_ms_per_sample=train_2d_bound_ms_per_sample(
                     eng.cfg, r0, q),
                 handoff_s=handoff_s, wall_s=wall,
                 setup_s=[x["setup_s"] for x in res])
    check(stats["loss_rel_err"] <= TRAIN_1D_TOL["loss"]
          and stats["grad_norm_rel_err"] <= TRAIN_1D_TOL["grad_norm"]
          and leaf <= TRAIN_1D_TOL["leaf"],
          f"2x2 step vs scheme='none': {stats}")
    check(sum(peaks) < PEAK_MEM_LIMIT, f"train_2d_mesh: the four ranks' "
          f"peaks sum to {sum(peaks):.2f} GB")
    emit(phase="train_2d_mesh", **stats)
    return stats


def train_2d_worker(rank, tmp):
    """One rank of ``train_2d_mesh_phase`` (this file run with
    ``--train-2d-rank``): the engine on the 2x2 mesh with per-rank reads,
    its block of the first batch held against field_block of the whole
    one, one forward and backward with its launches counted, the
    comparison against this rank's shard of the none step's gradients,
    the timed forward and backward, and the step-loop variant; results to
    rank<r>.json."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(SRC))
    from repro_torch.core import comm
    from repro_torch.core import tree as ptree
    from repro_torch.kernels import block_matmul as BM
    from repro_torch.kernels import cannon as CANNON
    from repro_torch.kernels import fused_ring
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import ring as RING
    from repro_torch.kernels import ssd_chunk as SSD
    from repro_torch.kernels import wx as WX
    from repro_torch.launch.engine import EngineConfig, TrainEngine
    from repro_torch.models import weathermixer as W
    from repro_torch.optim.adam import global_norm
    from repro_torch.train.step import _norm_args, value_and_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = Path(tmp)
    r0 = json.loads((tmp / "meta.json").read_text())["rollout"]
    t0 = time.perf_counter()
    eng = TrainEngine("weathermixer-1b", reduced=False,
                      mesh_model=TRAIN_2D_Q ** 2, scheme="2d",
                      device="cuda",
                      config=EngineConfig(steps=1, batch=TRAIN_BATCH,
                                          precision="bf16", lr=1e-4, seed=0,
                                          pipeline="sharded", prefetch=0,
                                          telemetry=False))
    none = torch.load(tmp / f"none{rank}.pt")
    check([float(t.double().sum()) for t in ptree.leaves(eng.params)]
          == none["fingerprint"], "train_2d_mesh: the engine's weights are "
          "not the train phase's")
    cfg, jcfg = eng.cfg, eng.jcfg
    check(cfg.remat and cfg.kernel == "pallas" and jcfg.mesh.q == TRAIN_2D_Q
          and dist.get_backend() == "gloo", "unexpected 2-D config")
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batch = eng.pipeline.get(0, r0)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    whole = torch.load(tmp / "batch.pt")
    block_equal = all(torch.equal(batch[k].cpu(),
                                  W.field_block(whole[k], cfg, jcfg))
                      for k in whole)
    read_bytes = {k: v[eng.pipeline.rank]
                  for k, v in eng.pipeline.stats.rank_bytes.items()}
    read_share = read_bytes["fields"] / (whole["fields"].numel() * 4)
    del whole

    # -- the 2x2 path: counts to 0 just before, read just after ------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in (CANNON.cannon_step, WX.wx, BM.block_matmul, RING.ring_fwd,
              RING.ring_bwd):
        f.launches = 0
    WX.wx.layout_launches.clear()
    WX.reset_dx_terms()
    comm.through_host.clear()
    comm.through_host_bytes.clear()
    metrics, grads = value_and_grad(eng.params, batch, cfg, jcfg, r0)
    torch.cuda.synchronize()
    res = dict(dx_terms=WX.dx_terms(),
               launches=dict(cannon=CANNON.cannon_step.launches,
                             wx_fwd=WX.wx.layout_launches[False],
                             wx_dx=WX.wx.layout_launches[True],
                             block_matmul=BM.block_matmul.launches,
                             ring=RING.ring_fwd.launches
                             + RING.ring_bwd.launches),
               through_host=dict(comm.through_host),
               through_host_gb=sum(comm.through_host_bytes.values()) / 1e9,
               # the Cannon's slots are raw cudaMallocs, outside torch's
               # allocator: their bytes are added to its peak
               cannon_slots_gb=RING.workspace_bytes() / 1e9,
               peak_mem_gb=(torch.cuda.max_memory_allocated()
                            + RING.workspace_bytes()) / 1e9)
    # ----------------------------------------------------------------------
    check(res["launches"]["wx_fwd"] + res["launches"]["wx_dx"]
          == WX.wx.launches, "wx launches outside the two layouts")
    # the slots are the fused Cannon's footprint at the token mix's largest
    # blocks (tok_fc1: w [d_tok/q, T/q], x [B, T/q, d/q])
    q = TRAIN_2D_Q
    slots = fused_ring.cannon_footprint_bytes(
        TRAIN_BATCH, cfg.wm_d_tok // q, W.n_tokens(cfg) // q,
        cfg.d_model // q, torch.bfloat16)
    check(RING.workspace_bytes() == slots, f"train_2d_mesh: "
          f"{RING.workspace_bytes()} bytes of slots, want {slots}")
    res.update(block_equal=block_equal, read_bytes=read_bytes,
               read_share=read_share, read_s=read_s, setup_s=setup_s)
    norm_args = _norm_args(eng.params, cfg, jcfg)
    res["loss"] = float(metrics["loss"])
    res["grad_norm"] = float(global_norm(grads, **norm_args))
    res["leaf_diff"], res["leaf_ref"] = [], []
    for a, b in zip(ptree.leaves(grads), ptree.leaves(none["grads"])):
        b = b.to(a.device).float()
        res["leaf_diff"].append(float((a.float() - b).abs().max()))
        res["leaf_ref"].append(float(b.abs().max()))
    del grads, none
    torch.cuda.empty_cache()
    res["fwd_ms"], res["bwd_ms"] = fwd_bwd_ms(torch, eng.params, batch, cfg,
                                              jcfg, r0)
    real = fused_ring.fused_cannon_t
    fused_ring.fused_cannon_t = _step_loop
    try:
        m2, g2 = value_and_grad(eng.params, batch, cfg, jcfg, r0)
    finally:
        fused_ring.fused_cannon_t = real
    res["loss_step_loop"] = float(m2["loss"])
    res["grad_norm_step_loop"] = float(global_norm(g2, **norm_args))
    del g2
    (tmp / f"rank{rank}.json").write_text(json.dumps(res))
    eng.close()
    dist.destroy_process_group()
    return 0


def train_phase(torch, BM, WX):
    import math
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
    leaf_err = leaf_rel_err(torch, gk, gx)
    first = dict(rollout=r0, loss=lk, loss_xla=lx,
                 loss_rel_err=abs(lk - lx) / abs(lx), grad_norm=nk,
                 grad_norm_xla=nx, grad_norm_rel_err=abs(nk - nx) / nx,
                 max_leaf_rel_err=leaf_err, tol=TRAIN_TOL)
    check(first["loss_rel_err"] <= TRAIN_TOL
          and first["grad_norm_rel_err"] <= TRAIN_TOL
          and leaf_err <= TRAIN_TOL,
          f"first training step vs kernel='xla': {first}")
    del gx
    torch.cuda.empty_cache()
    # the 2-D path on the same weights and batch, before the run moves them
    stats_2d = train_2d_phase(torch, BM, WX, eng, batch0, r0, mk, gk)
    stats_1d = train_1d_phase(torch, eng, batch0, r0, mk, gk)
    stats_2dm = train_2d_mesh_phase(torch, eng, batch0, r0, mk, gk)
    del gk
    torch.cuda.empty_cache()

    # -- the main path: counts to 0 just before, read just after -----------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    BM.block_matmul.launches = 0
    BM.block_matmul.layout_launches.clear()
    BM.block_matmul.route_launches.clear()
    t0 = time.perf_counter()
    hist = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = BM.block_matmul.launches
    by_layout = dict(BM.block_matmul.layout_launches)
    routes = dict(BM.block_matmul.route_launches)
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
    check(routes == {"sm90": launches}, f"training launches by route "
          f"{routes}: every GEMM of the step is at least 64 wide")
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
        launches_by_layout=layouts, launches_by_route=routes,
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
    return launches, stats, stats_2d, stats_1d, stats_2dm


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
    from repro_torch.kernels import cannon as CANNON
    from repro_torch.kernels import ref
    from repro_torch.kernels import ops as OPS
    from repro_torch.kernels import ring as RING
    from repro_torch.kernels import sm90 as SM90
    from repro_torch.kernels import ssd_chunk as SSD
    from repro_torch.kernels import wx as WX

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit(phase="device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=False)
    t0 = time.perf_counter()
    libs = (BM, WX, RING, CANNON, SSD)
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source,
        built = list(pool.map(lambda lib: lib.build(), libs))   # together
    emit(phase="build", built=built, seconds=time.perf_counter() - t0,
         nvcc_seconds=[lib.build_info.get("seconds") for lib in libs],
         libraries=[lib.build_info["library"] for lib in libs])

    rows, mamba_rows, worst = kernel_phase(torch, BM, SM90, ref)
    ssd_rows, ssd_worst = ssd_phase(torch, SSD, ref)
    counted = (BM.block_matmul, SSD.ssd_intra_chunk, WX.wx, RING.ring_fwd,
               RING.ring_bwd, CANNON.cannon_step)
    mcfg, mjcfg, mparams = mamba_setup(torch)
    fwd_launches = mamba_forward_phase(torch, counted, OPS, ref, mcfg, mjcfg,
                                       mparams)
    gen_launches = mamba_generate_phase(torch, counted, mcfg, mjcfg, mparams)
    del mparams
    torch.cuda.empty_cache()
    eng, fields, serve_launches = serve_phase(torch, BM)
    legacy_phase(torch, BM, eng, fields)
    del eng, fields
    torch.cuda.empty_cache()
    bwd_rows, bwd_worst = kernel_bwd_phase(torch, BM, SM90, ref)
    wx_rows, wx_worst = wx_phase(torch, WX, SM90, ref)
    ring_rows, ring_worst = ring_phase(torch, BM, RING, WX, ref)
    cannon_rows, cannon_worst = cannon_phase(torch, CANNON, WX, RING, ref)
    train_launches, train, t2, t1, t2m = train_phase(torch, BM, WX)
    mesh_launches = {k: [x[k] for x in t2m["launches"]]
                     for k in t2m["launches"][0]}

    step = [r for r in rows if r["per_step"]]

    # a row's key, or (wmma_ms of a row that runs the WMMA loop anyway) its
    # kernel time
    def get(r, key):
        return r.get(key, r["kernel_ms"])

    def per_step(key):
        return sum(get(r, key) * r["per_step"] for r in step)

    def per_train_step(key):
        return sum(get(r, key) * r["per_train_step"] for r in rows + bwd_rows)

    def per_wx_step(key):
        # the q = 1 rows at batch 1 (dx at one term, as the path runs it):
        # this card's path, per sample-step
        return sum(r.get(key, 0.0) * r["per_train_step"] for r in wx_rows
                   if r["batch"] == 1 and r["shape"].startswith("q1."))

    def per_ring_step(kind, key):
        # the p = 2 bf16 rows (batch 1): one rank of the 1-D step, per
        # training sample-step at r = 1
        return sum(r[f"{kind}_{key}"] * r[f"{kind}_calls_per_train_step"]
                   for r in ring_rows
                   if r["p"] == TRAIN_1D_P and r["dtype"] == "bfloat16")

    def per_cannon_step(key):
        # the bf16 rows at batch 1: one rank of the 2x2 step, per training
        # sample-step at r = 1
        return sum(r[key] * r["calls_per_train_step"] for r in cannon_rows
                   if r["batch"] == 1 and r["dtype"] == "bfloat16")

    def per_mamba(tag, key):
        # the block_matmul launches of one mamba2-130m forward (tag "fwd",
        # sequence 4096, batch 2) or one decode step (tag "decode", batch 4)
        return sum(get(r, key) * r["per_path"] for r in mamba_rows
                   if r["shape"].startswith(tag + "."))

    # the ssd launches of one mamba2-130m forward (sequence 4096, batch 2):
    # one per layer at G = 3072
    ssd_fwd = next(r for r in ssd_rows if r["shape"] == "seq4096.b2")

    def ring_entry(kind, line):
        launches = t1[f"ring_{kind}_launches"]
        return {
            "name": f"ring_{kind}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ring.cu",
            "replaces": f"src/repro/kernels/fused_ring.py:{line}",
            "launches": sum(launches),
            "launches_by_path": {"train_1d": launches},
            "max_abs_err": ring_worst[kind],
            # times: one rank's launches of a 1-D training sample-step at
            # p = 2, r = 1 (batch 1): forward 2 + 24 ring calls, backward
            # 2 + 12, each p launches; a hop is an HBM store on one card
            "ms": per_ring_step(kind, "kernel_ms"),
            "plain_ms": per_ring_step(kind, "plain_ms"),
            "bound_ms": per_ring_step(kind, "bound_ms"),
            "bound_by": ("operations" if all(
                r[f"{kind}_bound_by"] == "operations" for r in ring_rows)
                else "bytes"),
            # torch.matmul chunk products plus the adds
            "library_ms": per_ring_step(kind, "library_ms"),
        }

    emit(kernels=[{
        "name": "block_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_matmul.cu",
        "replaces": "src/repro/kernels/block_matmul.py:37",
        "launches": serve_launches + train_launches
        + t2["block_matmul_launches"] + sum(mesh_launches["block_matmul"])
        + fwd_launches["block_matmul"] + gen_launches["block_matmul"],
        "launches_by_path": {"serve": serve_launches,
                             "train": train_launches,
                             "train_2d": t2["block_matmul_launches"],
                             "train_2d_mesh": mesh_launches["block_matmul"],
                             "mamba_forward": fwd_launches["block_matmul"],
                             "mamba_generate": gen_launches["block_matmul"]},
        "train_launches_by_layout": train["launches_by_layout"],
        "train_launches_by_route": train["launches_by_route"],
        "max_abs_err": max(worst, bwd_worst),
        # times: the 14 GEMMs of one bf16 forecast step at bucket 1 (the
        # kernel's with its per-call padding, of which pad_ms; wmma_ms the
        # WMMA loop's on the same operands, bit for bit the same result)
        "ms": per_step("kernel_ms"),
        "pad_ms": per_step("pad_ms"),
        "wmma_ms": per_step("wmma_ms"),
        "plain_ms": per_step("plain_ms"),
        "bound_ms": per_step("bound_ms"),
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in step) else "bytes"),
        "library_ms": per_step("library_ms"),
        # the 59 GEMMs of one training sample-step at rollout 1 (batch 1):
        # forward, remat and GELU recomputes, dx and dw
        "train_ms": per_train_step("kernel_ms"),
        "train_pad_ms": per_train_step("pad_ms"),
        "train_wmma_ms": per_train_step("wmma_ms"),
        "train_plain_ms": per_train_step("plain_ms"),
        "train_bound_ms": per_train_step("bound_ms"),
        "train_library_ms": per_train_step("library_ms"),
        # the 97 GEMMs of one mamba2-130m forward (sequence 4096, batch 2)
        # and of one of its decode steps (batch 4)
        "mamba_forward_ms": per_mamba("fwd", "kernel_ms"),
        "mamba_forward_wmma_ms": per_mamba("fwd", "wmma_ms"),
        "mamba_forward_plain_ms": per_mamba("fwd", "plain_ms"),
        "mamba_forward_bound_ms": per_mamba("fwd", "bound_ms"),
        "mamba_forward_library_ms": per_mamba("fwd", "library_ms"),
        "mamba_decode_step_ms": per_mamba("decode", "kernel_ms"),
        "mamba_decode_step_bound_ms": per_mamba("decode", "bound_ms"),
        "mamba_decode_step_library_ms": per_mamba("decode", "library_ms"),
        "shapes": rows,
        "shapes_bwd": bwd_rows,
        "shapes_mamba": mamba_rows,
    }, {
        "name": "wx",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/wx.cu",
        "replaces": "src/repro/kernels/fused_ring.py:521",
        "launches": t2["wx_launches"] + sum(mesh_launches["wx_fwd"])
        + sum(mesh_launches["wx_dx"]),
        "launches_by_path": {
            "train_2d": t2["wx_launches"],
            "train_2d_mesh": [a + b for a, b in zip(mesh_launches["wx_fwd"],
                                                    mesh_launches["wx_dx"])]},
        "max_abs_err": wx_worst,
        "dx_terms_by_path": {"train_2d": t2["wx_dx_terms"],
                             "train_2d_mesh": t2m["wx_dx_terms"]},
        # times: the 18 wx launches of one 2-D training sample-step at q = 1
        # and r = 1 (batch 1): the 12 forward-layout launches (forward and
        # the checkpoint's rerun) and the 6 dx launches (one split term,
        # as the path runs them), each with its per-call padding of w (of
        # which pad_ms) and, dx, its split pass (split_ms); fma_dx_ms the
        # f32 FMA kernel that took dx before, on the same operands
        "ms": per_wx_step("kernel_ms"),
        "pad_ms": per_wx_step("pad_ms"),
        "split_ms": per_wx_step("split_ms"),
        "fma_dx_ms": per_wx_step("fma_ms"),
        "plain_ms": per_wx_step("plain_ms"),
        "bound_ms": per_wx_step("bound_ms"),
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in wx_rows) else "bytes"),
        # torch.matmul (+ the f32 add of the accumulator, forward rows;
        # f32 for dx)
        "library_ms": per_wx_step("library_ms"),
        "shapes": wx_rows,
    }, dict(ring_entry("fwd", 214), shapes=ring_rows),
        ring_entry("bwd", 314), {
        "name": "cannon",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cannon.cu",
        "replaces": "src/repro/kernels/fused_ring.py:650",
        "launches": sum(mesh_launches["cannon"]),
        "launches_by_path": {"train_2d_mesh": mesh_launches["cannon"]},
        "max_abs_err": cannon_worst,
        # times: one rank's 24 Cannon launches of a 2-D training
        # sample-step on the 2x2 mesh at r = 1 (batch 1): 12 loops of q = 2
        # steps, 6 of each token-mix linear (forward and the checkpoint's
        # rerun); a hop is an HBM store on one card
        "ms": per_cannon_step("kernel_ms"),
        "plain_ms": per_cannon_step("plain_ms"),
        "bound_ms": per_cannon_step("bound_ms"),
        "bound_by": ("operations" if all(r["bound_by"] == "operations"
                                         for r in cannon_rows) else "bytes"),
        # torch.baddbmm per step (no hops)
        "library_ms": per_cannon_step("library_ms"),
        "shapes": cannon_rows,
    }, {
        "name": "ssd_chunk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_chunk.py:25",
        "launches": fwd_launches["ssd_intra_chunk"]
        + gen_launches["ssd_intra_chunk"],
        "launches_by_path": {
            "mamba_forward": fwd_launches["ssd_intra_chunk"],
            "mamba_generate": gen_launches["ssd_intra_chunk"]},
        "max_abs_err": ssd_worst,
        # times: the 24 launches of one mamba2-130m forward (sequence 4096,
        # batch 2, G = 3072 groups each)
        "ms": MAMBA_LAYERS * ssd_fwd["kernel_ms"],
        "plain_ms": MAMBA_LAYERS * ssd_fwd["plain_ms"],
        "bound_ms": MAMBA_LAYERS * ssd_fwd["bound_ms"],
        "bound_by": ssd_fwd["bound_by"],
        # torch.bmm, torch.where, * dt, torch.bmm (TF32 off)
        "library_ms": MAMBA_LAYERS * ssd_fwd["library_ms"],
        "shapes": ssd_rows,
    }])
    print(card, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--train-1d-rank"]:
            sys.exit(train_1d_worker(int(sys.argv[2]), sys.argv[3]))
        if sys.argv[1:2] == ["--train-2d-rank"]:
            sys.exit(train_2d_worker(int(sys.argv[2]), sys.argv[3]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
