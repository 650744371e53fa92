#!/usr/bin/env python3
"""Run kernel phases of one checkout's ``chip_smoke.py`` on the card, so
that two commits can be compared in one call on one card.

    python3 scripts/ab_phases.py ROOT PHASE [PHASE ...]

ROOT is a checkout (this repository, or another commit unpacked with
``git archive`` into a git-ignored directory); PHASE is ``ring_shape`` or
``cannon_shape``.  The script imports ROOT's ``chip_smoke.py`` and ROOT's
``src/`` (its kernels build from ROOT's sources into ROOT's
``build/kernels/``), runs each phase with its own checks and prints its
rows as chip_smoke.py does, then one line
``{"ab": ROOT, "phase": ..., "ms": {row: kernel ms, ...}}`` per phase.
Run it for the two commits in turns (A, B, B, A) and compare within the
call.  Needs one CUDA device; exits non-zero without one.
"""
import importlib.util
import inspect
import json
import sys
from pathlib import Path


def main(argv):
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
    phases = {"ring_shape": smoke.ring_phase,
              "cannon_shape": smoke.cannon_phase}
    for name in argv[1:]:
        fn = phases[name]
        rows, _ = fn(*(mods[p] for p in inspect.signature(fn).parameters))
        ms = {}
        for r in rows:
            key = (f"{r['shape']} p={r['p']} {r['dtype']}" if "p" in r
                   else f"{r['shape']} L={r['batch']} {r['dtype']}")
            ms[key] = ({k: r[k] for k in ("fwd_kernel_ms", "bwd_kernel_ms")}
                       if "p" in r else r["kernel_ms"])
        print(json.dumps({"ab": str(root), "phase": name, "ms": ms}),
              flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception as e:       # a failed check in the phase, or a build
        print(f"ab_phases: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
