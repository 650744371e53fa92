"""Compiling and loading the port's CUDA kernel libraries: ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``.

Each library is built from one ``csrc/*.cu`` source (plus the headers it
includes) into ``build/kernels/`` at the repository root, named by the
digest of those files, at first use: nothing is compiled when a module is
imported, and a library built once is reused by later processes.  Two
libraries build in parallel when their ``load`` calls come from two
threads (each runs its own ``nvcc``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's "
                           "kernels are built from csrc/ at first use")
    return found


class KernelLibrary:
    """One ``csrc`` source compiled into one shared library.

    ``bind(lib)`` declares the ``argtypes``/``restype`` of its C functions.
    ``info`` holds the build's seconds (when this process ran ``nvcc``) and
    the library path."""

    def __init__(self, name: str, source: str, headers: Sequence[str],
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / source
        self.headers = [CSRC / h for h in headers]
        self._bind = bind
        self._lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None
        self.info: dict = {}

    def load(self) -> bool:
        """Compile (if these sources have no library yet) and load.
        Returns True when this call ran ``nvcc``."""
        with self._lock:
            if self.lib is not None:
                return False
            h = hashlib.sha256()
            for f in [self.source, *self.headers]:
                h.update(f.read_bytes())
            lib_path = BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"
            built = not lib_path.exists()
            if built:
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"{self.name}: nvcc failed ({proc.returncode}):\n"
                        f"{proc.stdout}\n{proc.stderr}")
                os.replace(tmp, lib_path)
                self.info["seconds"] = time.perf_counter() - t0
            lib = ctypes.CDLL(str(lib_path))
            self._bind(lib)
            self.info["library"] = str(lib_path)
            self.lib = lib
            return built

    def error_string(self, rc: int) -> str:
        return getattr(self.lib, f"{self.name}_error_string")(rc).decode()
