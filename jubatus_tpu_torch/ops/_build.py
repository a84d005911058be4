"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each kernel source has a plain C interface and is built with ``nvcc`` at
first use into ``build/torch_kernels/`` under the checkout, then loaded
with ctypes. The library's name carries a hash of the source, so an edited
source is rebuilt; a build writes to a temporary name and renames, so two
processes building at once do not see half a library. ``build_stats``
counts the nvcc runs of this process and their wall milliseconds (the
runtime telemetry's ``kernel_build_*`` keys: the port's counterpart of a
compiler's compile counters).
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
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_stats_lock = threading.Lock()
_stats: Dict[str, float] = {"count": 0, "ms": 0.0}


def build_stats() -> Dict[str, float]:
    """nvcc builds run by this process: ``count`` and wall ``ms``."""
    with _stats_lock:
        return dict(_stats)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(source: Path) -> Tuple[ctypes.CDLL, str]:
    """Build ``source`` (once per content) and load it. Returns the library
    and what nvcc printed (empty when the library was already built)."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{source.stem}_{digest}.so"
    log = ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                              capture_output=True, text=True)
        with _stats_lock:
            _stats["count"] += 1
            _stats["ms"] += (time.perf_counter() - t0) * 1e3
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{log}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), log
