#!/usr/bin/env python3
"""Run kernel phases of one checkout's ``chip_smoke.py`` on the card, so
that two commits can be compared in one call on one card.

    python3 scripts/ab_phases.py ROOT PHASE [PHASE ...]
    python3 scripts/ab_phases.py --compare A.out B.out

ROOT is a checkout (this repository, or another commit unpacked with
``git archive`` into a git-ignored directory); PHASE is ``kernel_shape``,
``kernel_bwd_shape``, ``wx_shape``, ``ring_shape``, ``cannon_shape``,
``ssd_shape`` or ``mamba_forward`` (the full-width mamba2-130m forward of
the smoke run, its checks and times; no hashes: its f32 logits are held
to the plain SSD term's inside the phase).
The script imports ROOT's ``chip_smoke.py`` and ROOT's ``src/`` (its
kernels build from ROOT's sources into ROOT's ``build/kernels/``).  For
each phase it first hashes (SHA-256) the output of ROOT's kernels at
every shape of the phase from inputs made here from a fixed seed, the
same in every checkout: block_matmul's forward (bias and epilogue as the
smoke rows, the small shapes too, in bf16 and f32), its dx and dw (a
ragged f32 shape too), wx's forward with an f32 and a bf16 accumulator
and, in f32, its forward and dx, the forward ring's outputs of every
rank (bf16 at p = 2 and 4, tok_fc1 in f32), the f32 Cannon's, the ssd
kernel's [G, Q, N] entry in f32 and bf16 (the smoke's small ragged chunks,
an odd width, the overflow case, mamba2-130m's groups) and the model's
``_ssd_chunked`` y and final state (one mamba2-130m layer, and a ragged
sequence of two groups); one
line ``{"ab": ROOT, "phase": ..., "hash": {case: hex, ...}}``.  Then it runs the phase with its own checks, prints
its rows as chip_smoke.py does, and one line ``{"ab": ROOT, "phase": ...,
"ms": {row: kernel ms, ...}}``.  Run it for the two commits in turns (A,
B, B, A) and compare within the call; ``--compare`` prints, per phase,
the cases whose hashes differ between two such outputs.  Needs one CUDA
device; exits non-zero without one.
"""
import hashlib
import importlib.util
import inspect
import json
import sys
from pathlib import Path


def _digest(torch, y):
    return hashlib.sha256(y.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def _ssd_hashes(torch, gen, SSD, layers):
    """{case: hash} of the ssd kernel's [G, Q, N] entry and of the model's
    ``_ssd_chunked`` (whichever entry it calls in ROOT)."""
    out = {}
    for dt_ in (torch.float32, torch.bfloat16):
        name = str(dt_)[6:]
        cases = [(f"small{(6, q, n, p)}", 6, q, n, p, 0.1)
                 for q in (64, 37) for n in (32, 128) for p in (16, 64)]
        cases += [("odd(6, 37, 5, 3)", 6, 37, 5, 3, 0.1),
                  ("overflow(4, 64, 128, 64)", 4, 64, 128, 64, 16.0)]
        cases += [(label, g, 64, 128, 64, None) for label, g in SSD_SHAPES]
        for label, g, q, n, p, decay in cases:
            gen.manual_seed(7)
            c = (0.3 * torch.randn(g, q, n, generator=gen, device="cuda"))
            b = (0.3 * torch.randn(g, q, n, generator=gen, device="cuda"))
            x = torch.randn(g, q, p, generator=gen, device="cuda")
            dt = torch.nn.functional.softplus(
                torch.randn(g, q, generator=gen, device="cuda"))
            a = (torch.full((g, 1), -decay, device="cuda") if decay
                 else -torch.linspace(1.0, 16.0, 24, device="cuda").repeat(
                     g // 24)[:, None])
            dac = torch.cumsum(dt * a, dim=1)
            y = SSD.ssd_intra_chunk(c.to(dt_), b.to(dt_), x.to(dt_), dt, dac)
            out[f"{label} {name}"] = _digest(torch, y)
            del c, b, x, dt, dac, y
    for label, (bsz, s, h, p, g, n) in (("layer(2, 4096, 24, 64, 1, 128)",
                                         (2, 4096, 24, 64, 1, 128)),
                                        ("ragged(1, 1000, 8, 64, 2, 128)",
                                         (1, 1000, 8, 64, 2, 128))):
        gen.manual_seed(7)
        x = torch.randn(bsz, s, h, p, generator=gen, device="cuda")
        dt = torch.nn.functional.softplus(
            torch.randn(bsz, s, h, generator=gen, device="cuda"))
        a = -torch.linspace(1.0, 16.0, h, device="cuda")
        bm = 0.3 * torch.randn(bsz, s, g, n, generator=gen, device="cuda")
        cm = 0.3 * torch.randn(bsz, s, g, n, generator=gen, device="cuda")
        y, state = layers._ssd_chunked(x, dt, a, bm, cm, 64)
        out[f"_ssd_chunked {label} y"] = _digest(torch, y)
        out[f"_ssd_chunked {label} state"] = _digest(torch, state)
        del x, dt, bm, cm, y, state
    torch.cuda.empty_cache()
    return out


# mamba2-130m's groups of a forward (G = batch x chunks x heads), as
# chip_smoke.SSD_SHAPES
SSD_SHAPES = [("seq2048.b1", 2048 // 64 * 24), ("seq4096.b2", 2 * 4096 // 64
                                                 * 24)]


def _hashes(name, smoke, torch, BM, WX, RING, CANNON, SSD, layers):
    """{case: hash} of ROOT's kernel outputs at the phase's shapes, from
    inputs made from seed 7 per case (the same in every checkout)."""
    out = {}

    def gen():
        return torch.Generator(device="cuda").manual_seed(7)

    def randn(g, *shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=g, device="cuda")
                ).to(dtype)

    bf, f32 = torch.bfloat16, torch.float32
    if name == "kernel_shape":
        # the small shapes in both dtypes (K of 13 and 97: the f32 loop's
        # 4-byte loads), the smoke shapes (tok_fc1 in f32 with GELU too),
        # the Mamba-2 shapes
        cases = [(f"small{(m, k, n)}.{epi}{'.f32' if dt == f32 else ''}",
                  m, k, n, epi, dt)
                 for dt in (bf, f32)
                 for m, k, n in [(1, 1, 1), (7, 13, 5), (300, 700, 130),
                                 (129, 97, 257), (200, 16380, 72)]
                 for epi in ("none", "gelu", "silu")]
        cases += [(label, m, k, n, epi, getattr(torch, dt))
                  for label, m, k, n, epi, dt, *_ in smoke.SHAPES]
        cases += [(label, m, k, n, "none", bf)
                  for label, m, k, n, _ in smoke.MAMBA_SHAPES]
        for label, m, k, n, epi, dt in cases:
            g = gen()
            x, w = randn(g, m, k, dtype=dt), randn(g, n, k, scale=k ** -0.5,
                                                   dtype=dt)
            b = randn(g, n, scale=0.1, dtype=dt)
            out[label] = _digest(torch, BM.block_matmul(x, w, b, epi))
    elif name == "kernel_bwd_shape":
        # the smoke shapes' dx and dw (tok_fc1's in f32 too), and a ragged
        # f32 shape whose K and N are not multiples of 4
        cases = [(label, m, k, n, getattr(torch, dt))
                 for label, m, k, n, _, dt, *_ in smoke.SHAPES]
        cases.append(("ragged_f32", 129, 97, 257, f32))
        for label, m, k, n, dt in cases:
            g = gen()
            x, w = (randn(g, m, k, scale=m ** -0.5, dtype=dt),
                    randn(g, n, k, scale=k ** -0.5, dtype=dt))
            dz = randn(g, m, n, dtype=dt)
            out[f"{label}.dx"] = _digest(torch, BM.block_matmul(dz, w,
                                                                w_t=True))
            out[f"{label}.dw"] = _digest(torch, BM.block_matmul(
                dz, x, x_t=True, w_t=True))
    elif name == "wx_shape":
        for label, m, t, c, _ in smoke.WX_SHAPES:
            for ll in (1, 2):
                g = gen()
                w = randn(g, m, t, scale=t ** -0.5)
                x = randn(g, ll, t, c)
                a = randn(g, ll, m, c, dtype=f32)
                out[f"{label}.fwd L={ll}"] = _digest(torch, WX.wx(w, x, a))
                # the forward with a bf16 accumulator, as bf16_pure runs it
                out[f"{label}.fwd bf16 L={ll}"] = _digest(torch, WX.wx(
                    w, x, a.to(bf), out_dtype=bf))
            # f32 operands: the forward and dx (w read across its rows)
            g = gen()
            w = randn(g, m, t, scale=t ** -0.5, dtype=f32)
            x = randn(g, 1, t, c, dtype=f32)
            a = randn(g, 1, m, c, dtype=f32)
            dy = randn(g, 1, m, c, dtype=f32)
            out[f"{label}.fwd f32"] = _digest(torch, WX.wx(w, x, a))
            out[f"{label}.dx f32"] = _digest(torch, WX.wx(w, dy, None,
                                                          w_t=True))
            del w, x, a, dy
            torch.cuda.empty_cache()
    elif name == "ring_shape":
        # the forward ring's outputs of p ranks held in one process
        cases = [(p, shape, bf) for p in smoke.RING_PS
                 for shape in smoke.RING_SHAPES]
        cases.append((2, smoke.RING_SHAPES[1], f32))
        for p, (label, rows, d, m, *_), dt in cases:
            g = gen()
            xs = [randn(g, rows, d // p, dtype=dt) for _ in range(p)]
            ws = [randn(g, m, d // p, scale=d ** -0.5, dtype=dt)
                  for _ in range(p)]
            outs = RING.ring_fwd_all(xs, ws)
            for r, y in enumerate(outs):
                out[f"{label} p={p} {str(dt)[6:]} rank {r}"] = _digest(
                    torch, y)
            del xs, ws, outs
            torch.cuda.empty_cache()
    elif name == "ssd_shape":
        out = _ssd_hashes(torch, gen(), SSD, layers)
    elif name == "cannon_shape":
        # the f32 Cannon kernel of q x q ranks held in one process
        q = smoke.CANNON_Q
        for label, m, t, c, _ in smoke.CANNON_SHAPES:
            g = gen()
            ws = [randn(g, m, t, scale=t ** -0.5, dtype=f32)
                  for _ in range(q * q)]
            xs = [randn(g, 1, t, c, dtype=f32) for _ in range(q * q)]
            for r, y in enumerate(CANNON.cannon_fwd_all(ws, xs, q)):
                out[f"{label} f32 rank {r}"] = _digest(torch, y)
            del ws, xs
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return out


def _mamba_forward(smoke, torch, mods):
    """ROOT's mamba_forward phase (it prints its own line); returns its
    forward times."""
    from repro_torch.kernels import ops
    counted = (mods["BM"].block_matmul, mods["SSD"].ssd_intra_chunk,
               mods["WX"].wx, mods["RING"].ring_fwd, mods["RING"].ring_bwd,
               mods["CANNON"].cannon_step)
    lines, emit = [], smoke.emit

    def capture(**kw):
        lines.append(kw)
        emit(**kw)
    smoke.emit = capture
    try:
        cfg, jcfg, params = smoke.mamba_setup(torch)
        smoke.mamba_forward_phase(torch, counted, ops, mods["ref"], cfg, jcfg,
                                  params)
    finally:
        smoke.emit = emit
    row = next(d for d in lines if d.get("phase") == "mamba_forward")
    # the forward is bound by the host's launches, whose time varies with
    # the host's load: ten more forwards, each timed alone
    from repro_torch.models import registry as M
    batch = {"tokens": smoke.token_rows(torch, cfg, smoke.MAMBA_SEQ,
                                        smoke.MAMBA_BATCH, 0)}
    times = []
    with torch.no_grad():
        for _ in range(10):
            times.append(smoke.cuda_ms(lambda: M.apply(params, batch, cfg,
                                                       jcfg), 1))
    del params
    torch.cuda.empty_cache()
    times.sort()
    out = {k: row[k] for k in ("ms_per_forward", "f32_ms_per_forward")
           if k in row}
    out.update(min_ms=times[0], median_ms=(times[4] + times[5]) / 2)
    return out


def compare(path_a, path_b):
    """Print, per phase, the cases whose hashes differ between two outputs
    of this script; returns the number of differing cases."""
    def read(path):
        got = {}
        for line in Path(path).read_text().splitlines():
            if line.startswith('{"ab"') and '"hash"' in line:
                d = json.loads(line)
                got[d["phase"]] = d["hash"]
        return got
    a, b = read(path_a), read(path_b)
    bad = 0
    for phase in sorted(set(a) | set(b)):
        ha, hb = a.get(phase, {}), b.get(phase, {})
        diff = sorted(k for k in set(ha) | set(hb) if ha.get(k) != hb.get(k))
        bad += len(diff)
        print(json.dumps({"compare": phase, "cases": len(ha),
                          "equal": len(ha) - len(diff), "differ": diff}))
    return bad


def main(argv):
    if argv[:1] == ["--compare"] and len(argv) == 3:
        return 1 if compare(argv[1], argv[2]) else 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("ab_phases: needs a CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("ab_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import (block_matmul, cannon, ref, ring,
                                     ssd_chunk, wx)
    from repro_torch.models import layers
    torch.backends.cuda.matmul.allow_tf32 = False
    mods = {"torch": torch, "BM": block_matmul, "CANNON": cannon,
            "RING": ring, "WX": wx, "SSD": ssd_chunk, "ref": ref}
    try:
        from repro_torch.kernels import sm90
        mods["SM90"] = sm90
    except ImportError:           # a checkout from before kernels/sm90.py
        pass
    phases = {"kernel_shape": smoke.kernel_phase,
              "kernel_bwd_shape": smoke.kernel_bwd_phase,
              "wx_shape": smoke.wx_phase,
              "ring_shape": smoke.ring_phase,
              "cannon_shape": smoke.cannon_phase,
              "ssd_shape": smoke.ssd_phase}
    for name in argv[1:]:
        if name == "mamba_forward":
            print(json.dumps({"ab": str(root), "phase": name,
                              "ms": _mamba_forward(smoke, torch, mods)}),
                  flush=True)
            continue
        print(json.dumps({"ab": str(root), "phase": name,
                          "hash": _hashes(name, smoke, torch, block_matmul,
                                          wx, ring, cannon, ssd_chunk,
                                          layers)}), flush=True)
        fn = phases[name]
        got = fn(*(mods[p] for p in inspect.signature(fn).parameters))
        rows = got[0] + (got[1] if name == "kernel_shape" else [])
        ms = {}
        for r in rows:
            if "fwd_kernel_ms" in r:     # a ring row (p: its rank count)
                key = f"{r['shape']} p={r['p']} {r['dtype']}"
                ms[key] = {k: r[k] for k in ("fwd_kernel_ms",
                                             "bwd_kernel_ms")}
                continue
            key = f"{r['shape']} {r['dtype']}"
            if "batch" in r and "heads" not in r:
                key += f" L={r['batch']}"
            if r.get("terms"):
                key += f" terms={r['terms']}"
            ms[key] = r["kernel_ms"]
        print(json.dumps({"ab": str(root), "phase": name, "ms": ms}),
              flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception as e:       # a failed check in the phase, or a build
        print(f"ab_phases: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
