"""ctypes bindings to the native host libraries of ``native/`` (copy of
``jubatus_tpu/native/__init__.py``).

Python crosses into C++ through ctypes on plain C ABIs. A source of
``native/`` is compiled with ``g++`` at first use into
``build/torch_native/`` under the checkout (``ensure_built``); the source
is read in place, never edited. The library's name carries a hash of the
source, so an edited source is rebuilt, and a build writes to a name of
its own process and renames, so a process never loads a library another
is still writing. Unlike the JAX package, which serves the Python paths
when ``g++`` fails, a failed build raises ``NativeBuildError`` with the
compiler's output: the caller asked for the native path.

Surface:

- ``ensure_built(name)``: build ``native/<name>.cpp`` and return the
  library's path (the ingest parser, ``native/ingest.py``, builds
  ``fast_ingest`` through it);
- ``hash_names(names, mask)``: batch feature-name hashing in
  ``native/jt_native.cpp``, equal to ``FeatureHasher.index``; measured
  no faster than the zlib loop (the ctypes marshalling eats the win), so
  ``FeatureHasher.index_many`` takes it only under ``JUBATUS_TPU_NATIVE=1``;
- ``crc32(data)``: the zlib-compatible checksum;
- ``available()``: whether ``jt_native`` builds and loads, and is not
  switched off (``JUBATUS_TPU_NATIVE=0``);
- ``load_native_splitter(path, params)``: a converter's ``dynamic``
  string type whose ``path`` ends in ``.so`` names a shared object
  implementing the ``jt_splitter_*`` C ABI (see
  ``native/sample_ngram_splitter.cpp``): ``jt_splitter_create(keys,
  values, n)`` takes the type's parameters, ``jt_splitter_split(handle,
  text, len, begins, ends, cap)`` writes token byte ranges and returns
  their count, and ``jt_splitter_destroy(handle)`` frees it. The library
  is dlopen'd once per resolved path; the caller names a library that
  exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = _REPO_ROOT / "native"
BUILD_DIR = _REPO_ROOT / "build" / "torch_native"
#: the compiler and the JAX package's flags
CXX = "g++"
CXX_FLAGS = ("-O3", "-Wall", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lock = threading.Lock()
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """A native library failed to compile or to load."""


def _compile(src: Path, out: Path) -> None:
    """``g++`` ``src`` into ``out``: written under a name of this process,
    then renamed into place. Raises with the compiler's output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"{CXX} could not build {src}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"{CXX} failed on {src}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def ensure_built(name: str) -> Path:
    """Build ``native/<name>.cpp`` once per content; the library's path."""
    src = NATIVE_DIR / f"{name}.cpp"
    try:
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    except OSError as e:
        raise NativeBuildError(f"native source missing: {src}") from e
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    with _build_lock:
        if not out.exists():
            _compile(src, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build ``native/<name>.cpp`` if need be and dlopen it."""
    path = ensure_built(name)
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise NativeBuildError(f"cannot dlopen {path}: {e}") from e


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = load("jt_native")
        lib.jt_crc32.restype = ctypes.c_uint32
        lib.jt_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.jt_hash_names.restype = None
        lib.jt_hash_names.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_uint32,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
        return _lib


def _switched_off() -> bool:
    return os.environ.get("JUBATUS_TPU_NATIVE", "") in ("0", "false", "no")


def available() -> bool:
    if _switched_off():
        return False
    try:
        _load()
    except NativeBuildError:
        return False
    return True


def crc32(data: bytes) -> int:
    return int(_load().jt_crc32(data, len(data)))


def hash_names(names: List[str], mask: int) -> np.ndarray:
    """Batch of names → uint32 indices in [1, mask] (0 remapped to 1, as
    ``FeatureHasher.index``). The zlib loop when switched off."""
    if _switched_off():
        import zlib

        out = np.empty(len(names), dtype=np.uint32)
        for i, name in enumerate(names):
            h = zlib.crc32(name.encode("utf-8", "surrogateescape")) & mask
            out[i] = h if h else 1
        return out
    lib = _load()
    encoded = [n.encode("utf-8", "surrogateescape") for n in names]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    buf = b"".join(encoded)
    out = np.empty(len(encoded), dtype=np.uint32)
    lib.jt_hash_names(buf, offsets, len(encoded), ctypes.c_uint32(mask), out)
    return out


# -- native splitter plugins (jt_splitter_* ABI) -----------------------------

_splitter_libs: Dict[str, ctypes.CDLL] = {}


def load_native_splitter(path: str, params: Dict[str, str]
                         ) -> Callable[[str], List[str]]:
    """dlopen a .so implementing the jt_splitter ABI and wrap it as a
    ``text -> [tokens]`` callable."""
    from jubatus_tpu_torch.core.fv.converter import ConverterError

    resolved = os.path.abspath(path)
    with _lock:
        lib = _splitter_libs.get(resolved)
        if lib is None:
            if not os.path.exists(resolved):
                raise ConverterError(f"native splitter not found: {path!r}")
            try:
                lib = ctypes.CDLL(resolved)
            except OSError as e:
                raise ConverterError(f"cannot dlopen {path!r}: {e}")
            lib.jt_splitter_create.restype = ctypes.c_void_p
            lib.jt_splitter_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
            lib.jt_splitter_split.restype = ctypes.c_int64
            lib.jt_splitter_split.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64]
            lib.jt_splitter_destroy.restype = None
            lib.jt_splitter_destroy.argtypes = [ctypes.c_void_p]
            _splitter_libs[resolved] = lib

    items = [(k, v) for k, v in params.items()
             if k not in ("method", "path", "function")]
    keys = (ctypes.c_char_p * len(items))(*[k.encode() for k, _ in items])
    vals = (ctypes.c_char_p * len(items))(*[str(v).encode() for _, v in items])
    handle = lib.jt_splitter_create(keys, vals, len(items))
    if not handle:
        raise ConverterError(f"native splitter {path!r} rejected params")

    def split(text: str, _lib=lib, _h=handle) -> List[str]:
        data = text.encode("utf-8")
        cap = max(64, len(data) * 2)
        while True:
            begins = np.empty(cap, dtype=np.int64)
            ends = np.empty(cap, dtype=np.int64)
            n = _lib.jt_splitter_split(_h, data, len(data), begins, ends, cap)
            if n <= cap:
                break
            cap = int(n)
        return [data[begins[i]:ends[i]].decode("utf-8", "replace")
                for i in range(max(0, int(n)))]

    return split
