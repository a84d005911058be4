"""Deadline propagation — the request plane's time budget (copy of
``jubatus_tpu/rpc/deadline.py``).

A caller sets a deadline for a whole operation; every hop it fans into
(client → proxy → server → peer) inherits the REMAINING budget instead of
its own flat timeout, and servers reject work whose budget is already
gone at dispatch (``DeadlineExceeded``, counted as
``rpc.deadline_rejected``) rather than computing an answer nobody is
waiting for. This is the piece the reference never had: its per-session
timeouts compound across hops (client 10 s over a proxy whose backend
call gets 10 s *again*), so a slow backend burns 2x the caller's patience.

Mechanics mirror the trace context (utils/tracing.py) exactly:

- **in-process**: a thread-local ABSOLUTE monotonic deadline
  (``time.monotonic()`` domain — wall-clock is not usable across NTP
  steps). ``deadline_after(seconds)`` opens a scope; nested scopes can
  only tighten (min), never extend.
- **on the wire**: the envelope's OPTIONAL 6th element carries the
  REMAINING budget in seconds (a float — relative, like gRPC's
  grpc-timeout, because hosts share no clock). The receiver re-anchors it
  against its own monotonic clock; transit latency is therefore not
  charged, which errs toward doing work rather than dropping it.
- the RPC server adopts it in dispatch exactly like the trace element.

``swap`` is the primitive for dispatch pools (threads are reused — a
leaked deadline would time out the NEXT request); ``use`` / ``after`` are
the context-manager forms.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Iterator, Optional

_tls = threading.local()

#: clamp for wire values: a deadline further out than this (or NaN/inf,
#: or from a confused clock) is treated as "effectively none" rather than
#: scheduling work years ahead
MAX_WIRE_SECONDS = 3600.0


def current() -> Optional[float]:
    """This thread's absolute monotonic deadline, or None."""
    return getattr(_tls, "deadline", None)


def remaining() -> Optional[float]:
    """Seconds left in the budget (may be <= 0), or None when unlimited."""
    d = getattr(_tls, "deadline", None)
    return None if d is None else d - time.monotonic()


def expired() -> bool:
    d = getattr(_tls, "deadline", None)
    return d is not None and time.monotonic() >= d


def swap(deadline: Optional[float]) -> Optional[float]:
    """Install an absolute monotonic deadline; returns the previous one
    (restore in a finally — dispatch pool threads are reused)."""
    prev = getattr(_tls, "deadline", None)
    _tls.deadline = deadline
    return prev


@contextlib.contextmanager
def use(deadline: Optional[float]) -> Iterator[None]:
    """Scope an ABSOLUTE deadline (None = explicitly unlimited)."""
    prev = swap(deadline)
    try:
        yield
    finally:
        swap(prev)


@contextlib.contextmanager
def deadline_after(seconds: float) -> Iterator[None]:
    """Scope a deadline ``seconds`` from now; nested scopes only tighten
    (the enclosing budget still binds — min, never max)."""
    mine = time.monotonic() + float(seconds)
    prev = current()
    if prev is not None:
        mine = min(mine, prev)
    with use(mine):
        yield


def to_wire() -> Optional[float]:
    """The remaining budget as the envelope's 6th element, or None when
    no deadline is active (the envelope then stays 4/5 elements — old
    peers never see a shape they don't know)."""
    rem = remaining()
    return None if rem is None else max(0.0, float(rem))


def adopt_wire(rem: Any) -> Optional[float]:
    """A wire remaining-seconds value -> absolute monotonic deadline on
    THIS host's clock; None for absent/garbage values (a malformed
    deadline must degrade to 'no deadline', never kill the dispatch)."""
    try:
        rem = float(rem)
    except (TypeError, ValueError):
        return None
    if not (0.0 <= rem <= MAX_WIRE_SECONDS):  # NaN fails this too
        if rem > MAX_WIRE_SECONDS:
            rem = MAX_WIRE_SECONDS
        elif rem < 0.0:
            rem = 0.0
        else:
            return None
    return time.monotonic() + rem
