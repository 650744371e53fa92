#!/usr/bin/env python3
"""Run kernel phases of one checkout's ``chip_smoke.py`` on the card, so
that two commits can be compared in one call on one card.

    python3 scripts/ab_phases.py ROOT PHASE [PHASE ...]
    python3 scripts/ab_phases.py --compare A.out B.out

ROOT is a checkout (this repository, or another commit unpacked with
``git archive`` into a git-ignored directory); PHASE is ``kernel_shape``,
``kernel_bwd_shape``, ``wx_shape``, ``ring_shape`` or ``cannon_shape``.
The script imports ROOT's ``chip_smoke.py`` and ROOT's ``src/`` (its
kernels build from ROOT's sources into ROOT's ``build/kernels/``).  For
the first three phases it first hashes (SHA-256) the output of ROOT's
kernel at every shape of the phase from inputs made here from a fixed seed,
the same in every checkout: block_matmul's forward (bias and epilogue as
the smoke rows, the small shapes too), its dx and dw, wx's bf16 forward
with an f32 accumulator; one line ``{"ab": ROOT, "phase": ..., "hash":
{case: hex, ...}}``.  Then it runs the phase with its own checks, prints
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


def _hashes(name, smoke, torch, BM, WX):
    """{case: hash} of ROOT's kernel outputs at the phase's shapes, from
    inputs made from seed 7 per case (the same in every checkout)."""
    out = {}

    def gen():
        return torch.Generator(device="cuda").manual_seed(7)

    def randn(g, *shape, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(*shape, generator=g, device="cuda")
                ).to(dtype)

    bf = torch.bfloat16
    if name == "kernel_shape":
        cases = [(f"small{(m, k, n)}.{epi}", m, k, n, epi)
                 for m, k, n in [(1, 1, 1), (7, 13, 5), (300, 700, 130),
                                 (129, 97, 257), (200, 16380, 72)]
                 for epi in ("none", "gelu", "silu")]
        cases += [(label, m, k, n, epi) for label, m, k, n, epi, dt, *_
                  in smoke.SHAPES if dt == "bfloat16"]
        cases += [(label, m, k, n, "none")
                  for label, m, k, n, _ in smoke.MAMBA_SHAPES]
        for label, m, k, n, epi in cases:
            g = gen()
            x, w = randn(g, m, k), randn(g, n, k, scale=k ** -0.5)
            b = randn(g, n, scale=0.1)
            out[label] = _digest(torch, BM.block_matmul(x, w, b, epi))
    elif name == "kernel_bwd_shape":
        for label, m, k, n, _, dt, *_ in smoke.SHAPES:
            if dt != "bfloat16":
                continue
            g = gen()
            x, w = randn(g, m, k, scale=m ** -0.5), randn(g, n, k,
                                                          scale=k ** -0.5)
            dz = randn(g, m, n)
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
                a = randn(g, ll, m, c, dtype=torch.float32)
                out[f"{label}.fwd L={ll}"] = _digest(torch, WX.wx(w, x, a))
                # the forward with a bf16 accumulator, as bf16_pure runs it
                out[f"{label}.fwd bf16 L={ll}"] = _digest(torch, WX.wx(
                    w, x, a.to(bf), out_dtype=bf))
    torch.cuda.synchronize()
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
    from repro_torch.kernels import block_matmul, cannon, ref, ring, wx
    torch.backends.cuda.matmul.allow_tf32 = False
    mods = {"torch": torch, "BM": block_matmul, "CANNON": cannon,
            "RING": ring, "WX": wx, "ref": ref}
    try:
        from repro_torch.kernels import sm90
        mods["SM90"] = sm90
    except ImportError:           # a checkout from before kernels/sm90.py
        pass
    phases = {"kernel_shape": smoke.kernel_phase,
              "kernel_bwd_shape": smoke.kernel_bwd_phase,
              "wx_shape": smoke.wx_phase,
              "ring_shape": smoke.ring_phase,
              "cannon_shape": smoke.cannon_phase}
    for name in argv[1:]:
        if name in ("kernel_shape", "kernel_bwd_shape", "wx_shape"):
            print(json.dumps({"ab": str(root), "phase": name,
                              "hash": _hashes(name, smoke, torch,
                                              block_matmul, wx)}),
                  flush=True)
        fn = phases[name]
        got = fn(*(mods[p] for p in inspect.signature(fn).parameters))
        rows = got[0] + (got[1] if name == "kernel_shape" else [])
        ms = {}
        for r in rows:
            if "p" in r:
                key = f"{r['shape']} p={r['p']} {r['dtype']}"
                ms[key] = {k: r[k] for k in ("fwd_kernel_ms",
                                             "bwd_kernel_ms")}
                continue
            key = f"{r['shape']} {r['dtype']}"
            if "batch" in r:
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
