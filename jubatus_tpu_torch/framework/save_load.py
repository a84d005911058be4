"""Model checkpoint envelope (copy of ``jubatus_tpu/framework/save_load.py``).

Reference format (framework/save_load.cpp:45-158, SURVEY.md §5
checkpoint/resume): a fixed 48-byte header — magic "jubatus", format version,
framework version, CRC32, section sizes — followed by a msgpack'd system data
container {version, timestamp, type, id, config} and the versioned user data
[user_data_version, driver.pack()]. Load validates magic, format version,
CRC32, engine type, and semantic config equality (save_load.cpp:160-286,
compare_config at 104-109).

Header layout (big-endian, 48 bytes):
  0  : 8  magic "jubatus\\0"
  8  : 4  format_version (u32) = 1
  12 : 4x3 version major/minor/maintenance (u32 each)
  24 : 4  crc32 of (system_data + user_data)
  28 : 8  system_data_size (u64)
  36 : 8  user_data_size (u64)
  44 : 4  reserved (zeros)
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Any, Optional, Tuple

from jubatus_tpu_torch.utils.serialization import pack_obj, unpack_obj
from jubatus_tpu_torch.version import COMPAT_JUBATUS_VERSION

MAGIC = b"jubatus\x00"
FORMAT_VERSION = 1
_HEADER = struct.Struct(">8sI3IIQQ4x")
assert _HEADER.size == 48


class SaveLoadError(RuntimeError):
    pass


def _semantic_config_equal(a: str, b: str) -> bool:
    """Reference compare_config: configs match if their parsed JSON is equal,
    not their raw text (save_load.cpp:104-109)."""
    try:
        return json.loads(a) == json.loads(b)
    except Exception:  # broad-ok — unparseable json: compare raw
        return a == b


def read_envelope(raw: bytes, where: str):
    """Validate the 48-byte header + CRC and split the body. Returns
    (system_bytes, user_bytes)."""
    if len(raw) < _HEADER.size:
        raise SaveLoadError(f"{where}: truncated header")
    magic, fmt, _, _, _, crc, ssize, usize = _HEADER.unpack_from(raw)
    if magic != MAGIC:
        raise SaveLoadError(f"{where}: bad magic {magic!r}")
    if fmt != FORMAT_VERSION:
        raise SaveLoadError(f"{where}: unsupported format version {fmt}")
    body = raw[_HEADER.size:]
    if len(body) != ssize + usize:
        raise SaveLoadError(
            f"{where}: size mismatch (header says {ssize}+{usize}, "
            f"got {len(body)})")
    if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
        raise SaveLoadError(f"{where}: CRC32 mismatch")
    return body[:ssize], body[ssize:ssize + usize]


def pack_envelope(system_data: bytes, user_data: bytes = b"") -> bytes:
    """Header + CRC + body as one in-memory blob — the same bytes
    write_envelope persists."""
    crc = zlib.crc32(system_data + user_data) & 0xFFFFFFFF
    header = _HEADER.pack(
        MAGIC,
        FORMAT_VERSION,
        *COMPAT_JUBATUS_VERSION,
        crc,
        len(system_data),
        len(user_data),
    )
    return header + system_data + user_data


def write_envelope(path: str, system_data: bytes,
                   user_data: bytes = b"") -> None:
    """Atomic envelope write: header + CRC, tmp + fsync + rename (the
    reference additionally flocks against concurrent saves,
    server_base.cpp:152-159)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(pack_envelope(system_data, user_data))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_model(
    path: str,
    driver,
    *,
    model_id: str = "",
    config: str = "",
) -> None:
    system = {
        "version": FORMAT_VERSION,
        "timestamp": int(time.time()),  # wall-clock
        "type": driver.TYPE,
        "id": model_id,
        "config": config,
    }
    write_envelope(
        path,
        pack_obj(system),
        pack_obj([driver.USER_DATA_VERSION, driver.pack()]),
    )


def load_model(
    path: str,
    driver,
    *,
    expected_config: Optional[str] = None,
) -> Tuple[dict, Any]:
    """Validate + load a checkpoint file into the driver.

    Returns (system_data, user_data_version). Raises SaveLoadError on any
    validation failure, mirroring the reference's checks."""
    with open(path, "rb") as f:
        raw = f.read()
    return load_model_bytes(raw, driver, where=path,
                            expected_config=expected_config)


def load_model_bytes(
    raw: bytes,
    driver,
    *,
    where: str = "<bytes>",
    expected_config: Optional[str] = None,
) -> Tuple[dict, Any]:
    """The byte-level half of load_model: same validation ladder (magic,
    CRC, type, semantic config, user-data version) over an in-memory
    envelope."""
    system_bytes, user_bytes = read_envelope(raw, where)
    path = where
    system = unpack_obj(system_bytes)
    if system["type"] != driver.TYPE:
        raise SaveLoadError(
            f"{path}: model type {system['type']!r} != server type {driver.TYPE!r}"
        )
    if expected_config is not None and not _semantic_config_equal(
        system.get("config", ""), expected_config
    ):
        raise SaveLoadError(f"{path}: saved config does not match server config")
    user_version, user_data = unpack_obj(user_bytes)
    if user_version != driver.USER_DATA_VERSION:
        raise SaveLoadError(
            f"{path}: user data version {user_version} != {driver.USER_DATA_VERSION}"
        )
    driver.unpack(user_data)
    return system, user_version
