"""fv_converter plugin loading (copy of ``jubatus_tpu/core/fv/plugins.py``;
≙ core so_factory + plugin/src/fv_converter).

The reference loads shared objects by path from server config and calls
their ``extern "C" create(const map<string,string>&)`` factory
(mecab_splitter.cpp:203-230); servers pass a so_factory into
make_fv_converter (classifier_serv.cpp:110). Here the same config shape —

    "string_types": {
      "mecab": {"method": "dynamic",
                "path": "mecab_splitter",
                "function": "create", "arg": "-d /usr/lib/mecab/..."}
    }

— loads a **Python module** by file path (or a bare name resolved against
the port's own ``jubatus_tpu_torch/plugins/`` directory, never the JAX
package's) and calls its
``create(params) -> splitter`` factory. A returned object may be a plain
callable ``text -> [tokens]`` or expose ``.split(text)`` (the reference's
word_splitter interface). ``.so`` paths load through the C ABI bridge in
``jubatus_tpu_torch.native`` (ctypes), keeping the native-plugin door open.

Loaded modules are cached by resolved path, like dlopen handle caching in
so_factory.
"""

from __future__ import annotations

import importlib.util
import os
import sys
import threading
from typing import Any, Callable, Dict, List

from jubatus_tpu_torch.core.fv.converter import ConverterError

#: built-in plugin directory (≙ the reference's installed plugin dir)
BUILTIN_PLUGIN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "plugins")

_cache: Dict[str, Any] = {}
_cache_lock = threading.Lock()


def resolve_path(path: str) -> str:
    """Bare names resolve against the built-in plugin dir; explicit paths
    pass through (the reference resolves bare .so names against its
    configured plugin directory)."""
    if os.path.sep not in path:
        name = path if path.endswith((".py", ".so")) else path + ".py"
        candidate = os.path.join(BUILTIN_PLUGIN_DIR, name)
        if os.path.exists(candidate):
            return candidate
    return path


def _load_module(path: str):
    resolved = os.path.abspath(resolve_path(path))
    with _cache_lock:
        mod = _cache.get(resolved)
        if mod is not None:
            return mod
        if not os.path.exists(resolved):
            raise ConverterError(f"plugin not found: {path!r} "
                                 f"(resolved {resolved!r})")
        # path hash in the module name: two plugins that share a basename
        # (e.g. plugins/a/tokenizer.py and plugins/b/tokenizer.py) must not
        # clobber each other's sys.modules entry; the prefix keeps the
        # port's entries apart from the JAX package's in one process
        import hashlib

        digest = hashlib.md5(resolved.encode()).hexdigest()[:8]
        modname = (f"jubatus_tpu_torch_plugin_"
                   f"{os.path.splitext(os.path.basename(resolved))[0]}_{digest}")
        spec = importlib.util.spec_from_file_location(modname, resolved)
        if spec is None or spec.loader is None:
            raise ConverterError(f"cannot load plugin {resolved!r}")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[modname] = mod
        try:
            spec.loader.exec_module(mod)
        except Exception as e:
            sys.modules.pop(modname, None)
            raise ConverterError(f"plugin {resolved!r} failed to import: {e}")
        _cache[resolved] = mod
        return mod


def _as_splitter(obj: Any) -> Callable[[str], List[str]]:
    if callable(obj) and not hasattr(obj, "split"):
        return obj
    if hasattr(obj, "split"):
        return obj.split
    raise ConverterError(
        f"plugin factory returned {type(obj)!r}; need a callable or an "
        "object with .split(text)")


def load_string_plugin(params: Dict[str, str]) -> Callable[[str], List[str]]:
    """``{"method": "dynamic", "path": ..., "function": ...}`` → splitter."""
    path = params.get("path", "")
    if not path:
        raise ConverterError('dynamic string type needs a "path"')
    if path.endswith(".so"):
        from jubatus_tpu_torch.native import load_native_splitter

        return load_native_splitter(path, params)
    mod = _load_module(path)
    fn_name = params.get("function", "create")
    factory = getattr(mod, fn_name, None)
    if factory is None:
        raise ConverterError(f"plugin {path!r} has no factory {fn_name!r}")
    return _as_splitter(factory(dict(params)))


def load_feature_plugin(params: Dict[str, str]) -> Callable:
    """Dynamic num/binary feature extractor: the factory returns a callable
    ``(key, value) -> iterable[(feature_name, weight)]`` or an object with
    ``.extract`` of that shape (the converter's num_type_fns protocol)."""
    path = params.get("path", "")
    if not path:
        raise ConverterError('dynamic feature type needs a "path"')
    mod = _load_module(path)
    factory = getattr(mod, params.get("function", "create"), None)
    if factory is None:
        raise ConverterError(f"plugin {path!r} has no factory")
    obj = factory(dict(params))
    return obj.extract if hasattr(obj, "extract") else obj


def clear_cache() -> None:
    with _cache_lock:
        _cache.clear()
