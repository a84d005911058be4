"""Principal propagation — who a request is FOR (copy of
``jubatus_tpu/rpc/principal.py``).

A **principal** is the tenant id a request is billed to. Clients stamp
it once at the edge; every hop it fans into (client → proxy → server →
peer) inherits it. The usage ledger (``utils/usage.py``) bills
CPU-seconds, queue and flush time, rows and bytes to it at dispatch, in
either package's servers. Traffic that never names one folds into ``(untagged)``; the
system's own work folds into ``(system)``.

Mechanics mirror the trace and deadline planes exactly:

- **in-process**: a thread-local string. ``use(p)`` opens a scope;
  ``swap`` is the primitive for dispatch pools (threads are reused — a
  leaked principal would bill the NEXT request to the wrong tenant).
- **on the wire**: the envelope's OPTIONAL 7th element carries the
  principal as a string. Absent principal + absent deadline + absent
  trace keeps the envelope at 4 elements — old peers never see a shape
  they don't know; earlier absent slots nil-pad (msgpack ``\\xc0``).
- the RPC server adopts it in dispatch exactly like the trace and
  deadline elements.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, Optional

_tls = threading.local()

#: the ledger row untagged traffic folds into — requests whose envelope
#: carried no principal (old clients, curl, internal tooling)
UNTAGGED = "(untagged)"
#: the ledger row the system's own work folds into — mix, telemetry,
#: store, migration: traffic no tenant sent
SYSTEM = "(system)"
#: clamp for wire values: a principal longer than this is truncated
#: rather than trusted — tenant ids are short identifiers, and a
#: megabyte "principal" must not become a ledger key
MAX_WIRE_CHARS = 128


def current() -> Optional[str]:
    """This thread's principal, or None when untagged."""
    return getattr(_tls, "principal", None)


def swap(principal: Optional[str]) -> Optional[str]:
    """Install a principal; returns the previous one (restore in a
    finally — dispatch pool threads are reused)."""
    prev = getattr(_tls, "principal", None)
    _tls.principal = principal
    return prev


@contextlib.contextmanager
def use(principal: Optional[str]) -> Iterator[None]:
    """Scope a principal (None = explicitly untagged)."""
    prev = swap(principal)
    try:
        yield
    finally:
        swap(prev)


def to_wire() -> Optional[str]:
    """The current principal as the envelope's 7th element, or None when
    none is set (the envelope then stays 4/5/6 elements — old peers
    never see a shape they don't know)."""
    p = current()
    if p is None:
        return None
    p = str(p)
    return p[:MAX_WIRE_CHARS] if p else None


def adopt_wire(value: Any) -> Optional[str]:
    """A wire principal value -> in-process principal; None for absent/
    garbage values (a malformed principal must degrade to 'untagged',
    never kill the dispatch)."""
    if value is None:
        return None
    if isinstance(value, bytes):
        # "replace" never raises: undecodable bytes become U+FFFD and
        # the request still bills to a (mangled) principal, not a crash
        value = value.decode("utf-8", "replace")
    if not isinstance(value, str) or not value:
        return None
    return value[:MAX_WIRE_CHARS]
