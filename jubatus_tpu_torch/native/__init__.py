"""The native splitter plugin loader (copy of ``load_native_splitter`` in
``jubatus_tpu/native/__init__.py``, trimmed to it).

A converter's ``dynamic`` string type whose ``path`` ends in ``.so`` names
a shared object implementing the ``jt_splitter_*`` C ABI (see
``native/sample_ngram_splitter.cpp``): ``jt_splitter_create(keys, values,
n)`` takes the type's parameters, ``jt_splitter_split(handle, text, len,
begins, ends, cap)`` writes token byte ranges and returns their count, and
``jt_splitter_destroy(handle)`` frees it. The library is dlopen'd with
ctypes once per resolved path. The port builds nothing here: the caller
names a library that exists.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Callable, Dict, List

import numpy as np

_lock = threading.Lock()
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
