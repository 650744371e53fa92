#!/usr/bin/env python3
"""Run the language-model phases of ``chip_smoke.py`` alone on the card:
whisper-small's serving (``audio_forward``, ``audio_generate``), the
training phases (``mamba_train``, ``hybrid_train``, ``lm_train``,
``audio_train``, ``moe_train``, ``lm_1d``, h2o-danube-1.8b on two ranks of
a 1-D model mesh, and ``lm_1d_zoo``, mamba2-130m, phi3.5, whisper and
jamba there), serving on that mesh (``lm_1d_serve``: the six cases on
two ranks) and the ring step kernels' phase (``ring_shape``, the LMs'
per-rank shapes among them; ``serve_ring`` its decode shapes alone),
after one build of block_matmul, ring, wx and the two SSD kernels
(started together), with the smoke's checks and JSON lines.

    python3 scripts/lm_phases.py [audio] [train] [ring] [serve] [serve_ring]

(audio and train when none is named).  Needs one CUDA device; exits
non-zero without one, or when a check fails.
"""
import shutil
import sys
import tempfile
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
    from repro_torch.kernels import ssd_chunk as SSD
    from repro_torch.kernels import ssd_chunk_bwd as SSDB
    from repro_torch.kernels import wx as WX
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    which = set(argv) or {"audio", "train"}
    print(C.card_line(), flush=True)
    t0 = time.perf_counter()
    libs = (BM, RING, WX, SSD, SSDB)
    with ThreadPoolExecutor(len(libs)) as pool:  # one nvcc per source,
        list(pool.map(lambda lib: lib.build(), libs))   # together
    C.emit(phase="build", seconds=time.perf_counter() - t0)
    try:
        if "ring" in which or "serve_ring" in which:
            C.ring_phase(torch, BM, RING, WX, ref,
                         only_serve="ring" not in which)
        if "serve" in which:
            C.lm_1d_serve_phase(torch, BM, SM90, ref)
        if "audio" in which:
            C.audio_phases(torch, BM, SM90, ref)
        if "train" in which:
            # lm_1d_zoo's step-0 handoffs from the four one-device phases
            zoo = Path(tempfile.mkdtemp(prefix="lm_phases_zoo_"))
            try:
                C.ssm_train_phases(torch, BM, SSD, SSDB, ref, zoo)
                C.lm_train_phases(torch, BM, SM90, ref, zoo)
            finally:
                shutil.rmtree(zoo, ignore_errors=True)
    except C.SmokeFailure as e:
        print(f"lm_phases: FAILED: {e}", file=sys.stderr)
        return 1
    C.emit(phase="done", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
