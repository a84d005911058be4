"""jubadump — convert saved model files to JSON (copy of
``jubatus_tpu/cmd/jubadump.py``; ≙ the reference's jubadump tool,
man/en/jubadump.1).

Reads the checkpoint envelope (framework/save_load.py — the reference's
48-byte header + system container + versioned user data) WITHOUT
constructing a driver, so any model file can be inspected offline. Both
packages write the same envelope, so the JSON is the JAX tool's byte for
byte:

    python -m jubatus_tpu_torch.cmd.jubadump -i /tmp/model.jubatus
    python -m jubatus_tpu_torch.cmd.jubadump -i model.jubatus --summary

A directory is a sharded checkpoint (framework/sharded_checkpoint.py): the
sidecar plus each array's global shape, dtype and partition spec, read
from the dcp metadata without reading array bytes. A directory the JAX
package wrote holds an orbax ``state/``: its sidecar is printed, then the
tool exits 1 with a one-line message naming the format. ``--mix-history``,
``--slow-log`` and ``--profile`` dump a live server's mix flight records,
slow-request ring and folded stack profile.
"""

from __future__ import annotations

import argparse
import json
import sys
import zlib
from typing import Any

import numpy as np

from jubatus_tpu_torch.framework.save_load import (
    _HEADER,
    FORMAT_VERSION,
    MAGIC,
    SaveLoadError,
)
from jubatus_tpu_torch.utils.serialization import unpack_obj

SUMMARY_ARRAY_LIMIT = 64  # arrays up to this many elements dump in full
#: files of an orbax checkpoint directory (the JAX package's state/)
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt")


class ForeignCheckpoint(ValueError):
    """A checkpoint directory this tool cannot read (the JAX package's
    orbax ``state/``); ``doc`` is what it could read: the sidecar."""

    def __init__(self, message: str, doc: dict) -> None:
        super().__init__(message)
        self.doc = doc


def _jsonable(obj: Any, summary: bool) -> Any:
    if isinstance(obj, np.ndarray):
        if summary and obj.size > SUMMARY_ARRAY_LIMIT:
            finite = obj[np.isfinite(obj)] if obj.dtype.kind == "f" else obj
            stats = {}
            if finite.size and obj.dtype.kind in "fiu":
                stats = {
                    "min": float(np.min(finite)),
                    "max": float(np.max(finite)),
                    "nonzero": int(np.count_nonzero(obj)),
                }
            return {"__array__": {"dtype": obj.dtype.str,
                                  "shape": list(obj.shape), **stats}}
        return obj.tolist()
    if isinstance(obj, bytes):
        try:
            return obj.decode("utf-8")
        except UnicodeDecodeError:
            return {"__bytes__": obj.hex()}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v, summary) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v, summary) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def _structured(system: Any) -> Any:
    """The sidecar's config as structured JSON, not an escaped string."""
    if isinstance(system, dict) and isinstance(system.get("config"), str):
        try:
            return dict(system, config=json.loads(system["config"]))
        except json.JSONDecodeError:
            pass
    return system


def dump_file(path: str, *, summary: bool = False,
              skip_user_data: bool = False) -> dict:
    """Parse + validate one model file into a JSON-ready dict. A directory
    is treated as a sharded checkpoint (framework/sharded_checkpoint.py):
    the system sidecar plus per-array shape/dtype/partition metadata —
    array bytes are never read (they may span a pod's worth of hosts)."""
    import os

    if os.path.isdir(path):
        from jubatus_tpu_torch.framework.sharded_checkpoint import (
            STATE_DIR, SYSTEM_FILE, _read_system, checkpoint_metadata)

        state = os.path.join(path, STATE_DIR)
        if not os.path.exists(os.path.join(state, ".metadata")) and any(
                os.path.exists(os.path.join(state, m))
                for m in _ORBAX_MARKERS):
            system = _read_system(os.path.join(path, SYSTEM_FILE))
            raise ForeignCheckpoint(
                f"{path}: state/ is an orbax checkpoint (the JAX "
                "package's); this tool reads dcp checkpoints — use "
                "jubatus_tpu.cmd.jubadump for it",
                _jsonable({"system": _structured(system)}, summary))
        out = checkpoint_metadata(path)
        out["system"] = _structured(out.get("system"))
        return _jsonable(out, summary)

    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < _HEADER.size:
        raise ValueError(f"{path}: truncated header ({len(raw)} bytes)")
    magic, fmt, vmaj, vmin, vmaint, crc, ssize, usize = \
        _HEADER.unpack_from(raw)
    if magic != MAGIC:
        raise ValueError(f"{path}: bad magic {magic!r} (not a model file)")
    body = raw[_HEADER.size:]
    crc_actual = zlib.crc32(body) & 0xFFFFFFFF
    out = {
        "header": {
            "format_version": fmt,
            "jubatus_version": f"{vmaj}.{vmin}.{vmaint}",
            "crc32": f"{crc:08x}",
            "crc32_ok": crc_actual == crc,
            "system_data_size": ssize,
            "user_data_size": usize,
        },
    }
    if fmt != FORMAT_VERSION:
        out["header"]["warning"] = f"unsupported format version {fmt}"
        return out
    if len(body) != ssize + usize:
        out["header"]["warning"] = (
            f"size mismatch: header says {ssize}+{usize}, file has {len(body)}")
        return out
    # corrupt bodies (the very case crc32_ok flags) must never lose the
    # header report to an unpack traceback
    try:
        system = unpack_obj(body[:ssize])
    except Exception as e:  # noqa: BLE001 — msgpack raises various types
        out["system_error"] = f"cannot decode system container: {e}"
        return out
    out["system"] = _jsonable(_structured(system), summary)
    if usize == 0:
        # sharded-checkpoint sidecars (system.jubatus) carry no user data;
        # the model lives in the state/ tree next to them
        out["user_data"] = None
    elif not skip_user_data:
        try:
            user_version, user_data = unpack_obj(body[ssize:ssize + usize])
        except Exception as e:  # noqa: BLE001
            out["user_data_error"] = f"cannot decode user data: {e}"
            return out
        out["user_data_version"] = user_version
        out["user_data"] = _jsonable(user_data, summary)
    return out


def _live_call(target: str, method: str, flag: str, name: str,
               *extra: Any, timeout: float = 10.0) -> Any:
    """One RPC against a live HOST:PORT target (the --mix-history /
    --slow-log live-dump paths share the parse + call shape)."""
    from jubatus_tpu_torch.rpc.client import RpcClient

    host, _, port = target.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"{flag} wants HOST:PORT, got {target!r}")
    with RpcClient(host, int(port), timeout=timeout) as c:
        return _jsonable(c.call(method, name, *extra), False)


def dump_mix_history(target: str, name: str = "",
                     timeout: float = 10.0) -> list:
    """Pull a live server's mix-round flight records (``get_mix_history``
    RPC — the bounded ring framework/mixer.py keeps per mixer)."""
    return _live_call(target, "get_mix_history", "--mix-history", name,
                      timeout=timeout)


def dump_slow_log(target: str, name: str = "",
                  timeout: float = 10.0) -> dict:
    """Pull a live server's slow-request ring — the tail-based capture of
    utils/slowlog.py, keyed by node name."""
    return _live_call(target, "get_slow_log", "--slow-log", name,
                      timeout=timeout)


def dump_profile(target: str, name: str = "", seconds: float = 0.0,
                 timeout: float = 10.0) -> dict:
    """Pull a live server's folded stack profile — the always-on sampler
    of utils/profiler.py (collapsed stacks + sampler stats +
    tail-triggered snapshots), keyed by node name. ``seconds`` bounds the
    window (0 = every retained bucket)."""
    return _live_call(target, "get_profile", "--profile", name,
                      float(seconds), timeout=timeout)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="jubadump",
        description="convert saved jubatus_tpu model files to JSON, or "
                    "dump a live server's mix-round flight records")
    p.add_argument("-i", "--input", metavar="FILE")
    p.add_argument("--summary", action="store_true",
                   help="digest large arrays instead of dumping them")
    p.add_argument("--no-user-data", action="store_true",
                   help="header + system container only")
    p.add_argument("--mix-history", metavar="HOST:PORT",
                   help="dump the mix flight recorder of a LIVE server "
                        "(get_mix_history RPC) instead of reading a file")
    p.add_argument("--slow-log", metavar="HOST:PORT", dest="slow_log",
                   help="dump the slow-request ring of a LIVE server "
                        "(get_slow_log RPC): tail-based capture of "
                        "requests at/above the --slowlog-quantile of "
                        "their own latency histogram")
    p.add_argument("--profile", metavar="HOST:PORT", dest="profile",
                   help="dump the folded stack profile of a LIVE server "
                        "(get_profile RPC): collapsed stacks "
                        "from the always-on sampler, sampler stats, and "
                        "tail-triggered snapshots")
    p.add_argument("--seconds", type=float, default=0.0,
                   help="[--profile] window to fold (seconds; 0 = every "
                        "retained bucket)")
    p.add_argument("-n", "--name", default="",
                   help="[--mix-history/--slow-log/--profile] cluster "
                        "name to pass the RPC")
    ns = p.parse_args(argv)
    if sum(map(bool, (ns.input, ns.mix_history, ns.slow_log,
                      ns.profile))) != 1:
        print("exactly one of -i FILE, --mix-history HOST:PORT, "
              "--slow-log HOST:PORT, or --profile HOST:PORT required",
              file=sys.stderr)
        return 1
    try:
        if ns.mix_history:
            out: Any = dump_mix_history(ns.mix_history, ns.name)
        elif ns.slow_log:
            out = dump_slow_log(ns.slow_log, ns.name)
        elif ns.profile:
            out = dump_profile(ns.profile, ns.name, ns.seconds)
        else:
            out = dump_file(ns.input, summary=ns.summary,
                            skip_user_data=ns.no_user_data)
    except ForeignCheckpoint as e:
        json.dump(e.doc, sys.stdout, indent=2)
        print()
        print(str(e), file=sys.stderr)
        return 1
    except (OSError, ValueError, SaveLoadError) as e:
        print(str(e), file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001 — RPC failures print, not raise
        print(f"live dump failed: {e}", file=sys.stderr)
        return 1
    json.dump(out, sys.stdout, indent=2)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
