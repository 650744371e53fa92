#!/usr/bin/env python3
"""Run the language-model phases of ``chip_smoke.py`` alone on the card:
whisper-small's serving (``audio_forward``, ``audio_generate``), the
training phases (``lm_train``, ``audio_train``, ``moe_train`` and
``lm_1d``, h2o-danube-1.8b on two ranks of a 1-D model mesh) and the ring
step kernels' phase (``ring_shape``, h2o's per-rank shapes among them),
after one build of block_matmul, ring and wx (started together), with the
smoke's checks and JSON lines.

    python3 scripts/lm_phases.py [audio] [train] [ring]

(audio and train when none is named).  Needs one CUDA device; exits
non-zero without one, or when a check fails.
"""
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("lm_phases: CUDA is not available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as C
    from repro_torch.kernels import block_matmul as BM
    from repro_torch.kernels import ref
    from repro_torch.kernels import ring as RING
    from repro_torch.kernels import sm90 as SM90
    from repro_torch.kernels import wx as WX
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    which = set(argv) or {"audio", "train"}
    print(C.card_line(), flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:      # one nvcc per source, together
        list(pool.map(lambda lib: lib.build(), (BM, RING, WX)))
    C.emit(phase="build", seconds=time.perf_counter() - t0)
    try:
        if "ring" in which:
            C.ring_phase(torch, BM, RING, WX, ref)
        if "audio" in which:
            C.audio_phases(torch, BM, SM90, ref)
        if "train" in which:
            C.lm_train_phases(torch, BM, SM90, ref)
    except C.SmokeFailure as e:
        print(f"lm_phases: FAILED: {e}", file=sys.stderr)
        return 1
    C.emit(phase="done", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
