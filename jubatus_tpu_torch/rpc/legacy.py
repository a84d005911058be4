"""Legacy (pre-str8/bin) msgpack codec — the old clients' view of the wire
(copy of ``jubatus_tpu/rpc/legacy.py``).

The reference's clients vendor a msgpack that predates the 2013
str8/bin/ext type additions (jubatus/client/common/client.hpp: the
client links jubatus_msgpack-rpc, whose unpacker rejects unknown type
bytes). A server that answers with str8 (0xd9) or bin (0xc4-0xc6) bytes
breaks every deployed jubatus client with any string >= 32 bytes (e.g.
get_config).

This module reproduces that old unpacker *faithfully, including the
rejection*: any post-2013 type byte raises ``LegacyFormatError``. The
server's legacy wire mode (``rpc.server.build_response(...,
legacy=True)``) packs with :func:`packb`, and :func:`scan_is_legacy`
tells the auto-detecting server whether a request came from an old
client.

Old-format mapping: str and bytes are both "raw" (fixraw/raw16/raw32) and
decode to ``bytes`` here — exactly what the old C++ client sees
(std::string of bytes).
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Optional, Tuple

import msgpack

#: type bytes that did not exist in pre-2013 msgpack: bin8/16/32
#: (0xc4-0xc6), ext8/16/32 (0xc7-0xc9), fixext1..16 (0xd4-0xd8),
#: str8 (0xd9); 0xc1 has never been assigned.
FORBIDDEN_TYPE_BYTES = frozenset(
    {0xC1} | set(range(0xC4, 0xCA)) | set(range(0xD4, 0xDA))
)


class LegacyFormatError(ValueError):
    """Wire bytes a legacy jubatus client cannot parse."""


def packb(obj: Any, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    """Encode ``obj`` in the pre-2013 format: str and bytes both go out as
    old raw (fixraw/raw16/raw32), never as str8 or bin. Surrogate-bearing
    strings (non-UTF-8 raw a legacy client sent, decoded with
    surrogateescape) re-encode to their original bytes."""
    return msgpack.packb(obj, default=default, use_bin_type=False,
                         unicode_errors="surrogateescape")


def unpackb(buf: bytes) -> Any:
    """Decode one msgpack object the way the old vendored library did."""
    obj, off = _decode(memoryview(buf), 0)
    if off != len(buf):
        raise LegacyFormatError(f"{len(buf) - off} trailing bytes")
    return obj


#: payload byte lengths of the fixed-width legacy scalar types
_SCALAR_WIDTH = {0xC0: 0, 0xC2: 0, 0xC3: 0, 0xCA: 4, 0xCB: 8, 0xCC: 1,
                 0xCD: 2, 0xCE: 4, 0xCF: 8, 0xD0: 1, 0xD1: 2, 0xD2: 4,
                 0xD3: 8}


def scan_is_legacy(buf: bytes, budget: int = 1 << 14) -> bool:
    """Walk ONE msgpack object's type bytes without building any values:
    True iff every type byte seen existed in pre-2013 msgpack (i.e. a
    vendored-msgpack client could have produced the buffer). This is the
    skip-style fingerprint the servers run per request while a connection
    is provisionally legacy — unpackb would construct a multi-megabyte
    object tree just to throw it away on bulk train calls.

    ``budget`` caps the walk at that many type bytes; on exhaustion the
    verdict is True ("no modern evidence so far") — sound, because a
    vendored client can never emit a modern byte ANYWHERE, so sampling a
    prefix can only delay a modern client's upgrade to a later (usually
    small) request, never mislabel a legacy one. Keeps the per-request
    cost on bulk ingest O(budget), not O(elements)."""
    b = memoryview(buf)
    n = len(b)
    i = 0
    remaining = 1  # objects still to skip
    while remaining:
        budget -= 1
        if budget < 0:
            return True  # prefix shows no modern byte; cost cap reached
        if i >= n:
            return False  # truncated: not a well-formed legacy object
        t = b[i]
        i += 1
        remaining -= 1
        if t <= 0x7F or t >= 0xE0:
            continue
        if 0x80 <= t <= 0x8F:          # fixmap
            remaining += (t & 0x0F) * 2
        elif 0x90 <= t <= 0x9F:        # fixarray
            remaining += t & 0x0F
        elif 0xA0 <= t <= 0xBF:        # fixraw
            i += t & 0x1F
        elif t in _SCALAR_WIDTH:
            i += _SCALAR_WIDTH[t]
        elif t == 0xDA or t == 0xDB:   # raw16/32
            w = 2 if t == 0xDA else 4
            if i + w > n:
                return False
            i += w + int.from_bytes(b[i:i + w], "big")
        elif t in (0xDC, 0xDD, 0xDE, 0xDF):  # array16/32, map16/32
            w = 2 if t in (0xDC, 0xDE) else 4
            if i + w > n:
                return False
            count = int.from_bytes(b[i:i + w], "big")
            if count > n - i:  # cannot possibly fit: hostile/corrupt
                return False
            i += w
            remaining += count * (2 if t in (0xDE, 0xDF) else 1)
        else:
            return False  # post-2013 type byte (or reserved)
    return i == n


def _unpack(fmt: str, b: memoryview, i: int):
    """struct.unpack_from with the truncation contract this module
    documents: short input is LegacyFormatError, never struct.error
    (the streaming framing loop in clients keys on 'truncated')."""
    if i + struct.calcsize(fmt) > len(b):
        raise LegacyFormatError("truncated input")
    return struct.unpack_from(fmt, b, i)[0]


def _raw(b: memoryview, i: int, n: int) -> Tuple[bytes, int]:
    if i + n > len(b):
        raise LegacyFormatError("truncated raw")
    return bytes(b[i:i + n]), i + n


def _arr(b: memoryview, i: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, i = _decode(b, i)
        out.append(v)
    return out, i


def _map(b: memoryview, i: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, i = _decode(b, i)
        v, i = _decode(b, i)
        out[k] = v
    return out, i


def _decode(b: memoryview, i: int) -> Tuple[Any, int]:
    if i >= len(b):
        raise LegacyFormatError("truncated input")
    t = b[i]
    i += 1
    if t <= 0x7F:                      # positive fixint
        return t, i
    if t >= 0xE0:                      # negative fixint
        return t - 0x100, i
    if 0x80 <= t <= 0x8F:              # fixmap
        return _map(b, i, t & 0x0F)
    if 0x90 <= t <= 0x9F:              # fixarray
        return _arr(b, i, t & 0x0F)
    if 0xA0 <= t <= 0xBF:              # fixraw
        return _raw(b, i, t & 0x1F)
    if t in FORBIDDEN_TYPE_BYTES:
        raise LegacyFormatError(
            f"type byte 0x{t:02x} does not exist in legacy msgpack")
    if t == 0xC0:
        return None, i
    if t == 0xC2:
        return False, i
    if t == 0xC3:
        return True, i
    if t == 0xCA:
        return _unpack(">f", b, i), i + 4
    if t == 0xCB:
        return _unpack(">d", b, i), i + 8
    if t == 0xCC:
        if i >= len(b):
            raise LegacyFormatError("truncated input")
        return b[i], i + 1
    if t == 0xCD:
        return _unpack(">H", b, i), i + 2
    if t == 0xCE:
        return _unpack(">I", b, i), i + 4
    if t == 0xCF:
        return _unpack(">Q", b, i), i + 8
    if t == 0xD0:
        return _unpack(">b", b, i), i + 1
    if t == 0xD1:
        return _unpack(">h", b, i), i + 2
    if t == 0xD2:
        return _unpack(">i", b, i), i + 4
    if t == 0xD3:
        return _unpack(">q", b, i), i + 8
    if t == 0xDA:                      # raw16
        n = _unpack(">H", b, i)
        return _raw(b, i + 2, n)
    if t == 0xDB:                      # raw32
        n = _unpack(">I", b, i)
        return _raw(b, i + 4, n)
    if t == 0xDC:                      # array16
        n = _unpack(">H", b, i)
        return _arr(b, i + 2, n)
    if t == 0xDD:                      # array32
        n = _unpack(">I", b, i)
        return _arr(b, i + 4, n)
    if t == 0xDE:                      # map16
        n = _unpack(">H", b, i)
        return _map(b, i + 2, n)
    if t == 0xDF:                      # map32
        n = _unpack(">I", b, i)
        return _map(b, i + 4, n)
    raise LegacyFormatError(f"unhandled type byte 0x{t:02x}")
