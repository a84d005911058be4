"""RPC error taxonomy (trimmed copy of ``jubatus_tpu/rpc/errors.py``).

The on-wire integer codes of the msgpack-rpc C++ implementation for
method-not-found (1) and argument errors (2), so reference clients see the
errors they expect, and the JAX package's extension codes of the elastic
membership plane: a server that refused a call before applying it because
it is draining (4) or because the caller's ring view is from another
membership epoch (5). Any other failure travels as its message string. The
fan-out client (``RpcMClient``) reports each host's failure as a
``HostError``; ``is_retryable`` tells transport failures, which count
against a host's circuit breaker, from application errors.
"""

from __future__ import annotations

from typing import Any

#: on-wire error codes (msgpack-rpc convention, used by the reference servers)
NO_METHOD_ERROR = 1
ARGUMENT_ERROR = 2
#: extension codes (3, a missed deadline, is the JAX package's and is not
#: ported): the server refused the call BEFORE applying it. Both are safe
#: to re-route and tell the caller to refresh its member/ring view first.
NODE_DRAINING_ERROR = 4
EPOCH_MISMATCH_ERROR = 5


class RpcError(RuntimeError):
    """Base of all RPC failures. ``retryable``: True when the failure is
    a transport-level loss where the server may never have seen (or
    finished) the request."""

    retryable = False


class RpcMethodNotFound(RpcError):
    def __init__(self, method: str = "") -> None:
        super().__init__(f"method not found: {method}")
        self.method = method


class RpcTypeError(RpcError):
    """Argument arity/type mismatch."""


class RpcCallError(RpcError):
    """Server raised while executing the method."""


class RpcIoError(RpcError):
    """Connection failed / reset mid-call."""

    retryable = True


class RpcTimeoutError(RpcError):
    """Call exceeded the client timeout."""

    retryable = True


class BreakerOpen(RpcError):
    """A circuit breaker refused the call without touching the backend
    (rpc/breaker.py)."""

    retryable = True

    def __init__(self, target: str = "") -> None:
        super().__init__(f"circuit breaker open for {target}")
        self.target = target


class NodeDraining(RpcError):
    """The target refused an effectful call at dispatch because it is
    draining. The call was NEVER applied, so re-routing it to another
    replica is safe even for effectful methods: retryable, with a
    membership refresh first."""

    retryable = True

    def __init__(self, detail: str = "") -> None:
        super().__init__(detail or "node draining")


class EpochMismatch(RpcError):
    """Caller and callee disagree on the membership epoch: the caller's
    ring view is stale (or the callee's is). Rejected BEFORE any state
    change: refresh the ring and re-route. Retryable for the same
    reason as NodeDraining."""

    retryable = True

    def __init__(self, detail: str = "", expected: int = 0,
                 got: int = 0) -> None:
        super().__init__(
            detail or f"membership epoch mismatch (mine {expected}, "
                      f"caller {got})")
        self.expected = expected
        self.got = got


class RpcNoClient(RpcError):
    """No host reachable for a fan-out call (≙ rpc_no_client)."""


class HostError(RpcError):
    """One host's failure inside a fan-out (≙ rpc_error{host, port, exc})."""

    def __init__(self, host: str, port: int, cause: BaseException) -> None:
        super().__init__(f"{host}:{port}: {cause}")
        self.host = host
        self.port = port
        self.cause = cause


def is_retryable(exc: BaseException) -> bool:
    """Transport-level failure where a retry can succeed. Injected faults
    (utils/faults.py) count: they stand in for the IO errors they model."""
    if isinstance(exc, RpcError):
        return exc.retryable
    from jubatus_tpu_torch.utils import faults

    return isinstance(exc, (faults.FaultInjected, OSError))


def error_to_wire(exc: BaseException) -> Any:
    """Server-side: map an exception to the response 'error' field."""
    if isinstance(exc, RpcMethodNotFound):
        return NO_METHOD_ERROR
    if isinstance(exc, (RpcTypeError, TypeError)):
        return ARGUMENT_ERROR
    if isinstance(exc, NodeDraining):
        return NODE_DRAINING_ERROR
    if isinstance(exc, EpochMismatch):
        return EPOCH_MISMATCH_ERROR
    return str(exc)


def wire_to_error(err: Any, method: str = "") -> RpcError:
    """Client-side: map the response 'error' field to a typed exception."""
    if err == NO_METHOD_ERROR:
        return RpcMethodNotFound(method)
    if err == ARGUMENT_ERROR:
        return RpcTypeError(f"argument error calling {method}")
    if err == NODE_DRAINING_ERROR:
        return NodeDraining(f"{method}: node draining")
    if err == EPOCH_MISMATCH_ERROR:
        return EpochMismatch(f"{method}: membership epoch mismatch")
    return RpcCallError(f"{method}: {err!r}")
