#!/usr/bin/env python3
"""Where one full-width mamba2-130m layer's forward spends its time on the
card: a ``torch.profiler`` trace of the port's layer (RMSNorm, then the
Mamba-2 mixer) at sequence 4096 and batch 2, bf16 weights from seed 0,
``kernel="pallas"``, as ``chip_smoke.py``'s ``mamba_forward`` runs it.

    python3 scripts/profile_mamba_layer.py [--seq 4096] [--batch 2]

Needs one CUDA device; exits non-zero without one.  The layer's functions
are wrapped from outside (the model's code is not touched) in a pair of
CUDA events each: the four linears, the RMSNorms, softplus, the chunked
scan (``_ssd_chunked``) and in it the intra-chunk kernel; the rest of the
mixer (the causal conv, SiLU, the split, the casts, the gate) is the
layer's time less those.  A part's time is the stream's time between its
events (device work and any gap while the host launches it).  Then one
``torch.profiler`` trace of the same forwards: the device-busy time (the
sum of the kernels' device time), the idle share of the layer's time,
and the operators and kernels with the most device time (name, calls,
device and host ms).  Prints JSON lines, then the card's name and power
limit.  ``--trace PATH`` also writes the Chrome trace.
"""
import argparse
import json
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _dev_ms(evt, own):
    """Device milliseconds of a profiler row (its own, or with children),
    under either attribute name torch has used."""
    for name in (("self_device_time_total", "self_cuda_time_total") if own
                 else ("device_time_total", "cuda_time_total")):
        if hasattr(evt, name):
            return getattr(evt, name) / 1e3
    return 0.0


@contextmanager
def timed_parts(torch, L, ops, spans):
    """A CUDA event pair around every call of the layer's parts (patched
    module attributes, restored after), appended to ``spans[label]``."""
    patched = []

    def wrap(mod, name, label):
        real = getattr(mod, name)

        def fn(*a, **k):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = real(*a, **k)
            e1.record()
            spans.setdefault(label, []).append((e0, e1))
            return out
        setattr(mod, name, fn)
        patched.append((mod, name, real))
    wrap(L, "linear_apply", "linear")
    wrap(L, "rmsnorm_apply", "rmsnorm")
    wrap(L, "softplus", "softplus")
    wrap(L, "_ssd_chunked", "ssd_chunked")
    wrap(ops, "ssd_intra_heads", "ssd_intra_kernel")
    try:
        yield
    finally:
        for mod, name, real in reversed(patched):
            setattr(mod, name, real)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_mamba_layer: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    from repro_torch.core.api import JigsawConfig
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as M
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2-130m")
    jcfg = JigsawConfig(scheme="none", kernel="pallas")
    gen = torch.Generator(device="cuda").manual_seed(0)
    lp = M.layer_init(gen, cfg, "cuda")
    x = (torch.randn(args.batch, args.seq, cfg.d_model, generator=gen,
                     device="cuda")).to(lp["mixer"]["in_z"]["w"].dtype)

    def layer():
        return M._mixer(lp, x, cfg, jcfg)[0]

    with torch.no_grad():
        for _ in range(2):
            layer()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(args.reps):
            layer()
        b.record()
        torch.cuda.synchronize()
        wall_ms = a.elapsed_time(b) / args.reps
        spans = {}
        with timed_parts(torch, L, ops, spans):
            for _ in range(args.reps):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                layer()
                e1.record()
                spans.setdefault("layer", []).append((e0, e1))
        torch.cuda.synchronize()
        parts = {k: sum(x.elapsed_time(y) for x, y in v) / args.reps
                 for k, v in spans.items()}
        calls = {k: len(v) // args.reps for k, v in spans.items()}
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.reps):
                layer()
            torch.cuda.synchronize()
    if args.trace:
        prof.export_chrome_trace(args.trace)
    rows = prof.key_averages()
    reps = args.reps
    # kernels: rows with device time and no host time of their own
    kernels = [e for e in rows if _dev_ms(e, True) > 0
               and e.self_cpu_time_total == 0]
    busy = sum(_dev_ms(e, True) for e in kernels) / reps
    named = ("linear", "rmsnorm", "softplus", "ssd_chunked")
    print(json.dumps({
        "phase": "mamba_layer", "seq": args.seq, "batch": args.batch,
        "wall_ms": wall_ms, "device_busy_ms": busy,
        "idle_share": 1.0 - busy / wall_ms,
        "parts_ms": parts, "parts_calls": calls,
        "ssd_chunked_less_kernel_ms": parts.get("ssd_chunked", 0.0)
        - parts.get("ssd_intra_kernel", 0.0),
        "rest_of_mixer_ms": parts.get("layer", 0.0)
        - sum(parts.get(k, 0.0) for k in named)}), flush=True)
    ops_rows = sorted((e for e in rows if e.key.startswith("aten::")),
                      key=lambda e: -_dev_ms(e, False))
    for e in ops_rows[:15]:
        print(json.dumps({"op": e.key, "calls": e.count // reps,
                          "device_ms": _dev_ms(e, False) / reps,
                          "host_ms": e.cpu_time_total / 1e3 / reps}),
              flush=True)
    for e in sorted(kernels, key=lambda e: -_dev_ms(e, True))[:15]:
        print(json.dumps({"kernel": e.key[:100], "calls": e.count // reps,
                          "device_ms": _dev_ms(e, True) / reps}),
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
