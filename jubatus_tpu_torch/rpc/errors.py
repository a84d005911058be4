"""RPC error taxonomy (trimmed copy of ``jubatus_tpu/rpc/errors.py``).

The on-wire integer codes of the msgpack-rpc C++ implementation for
method-not-found (1) and argument errors (2), so reference clients see the
errors they expect; any other failure travels as its message string. The
fan-out client (``RpcMClient``) reports each host's failure as a
``HostError``; ``is_retryable`` tells transport failures, which count
against a host's circuit breaker, from application errors.
"""

from __future__ import annotations

from typing import Any

#: on-wire error codes (msgpack-rpc convention, used by the reference servers)
NO_METHOD_ERROR = 1
ARGUMENT_ERROR = 2


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
    return str(exc)


def wire_to_error(err: Any, method: str = "") -> RpcError:
    """Client-side: map the response 'error' field to a typed exception."""
    if err == NO_METHOD_ERROR:
        return RpcMethodNotFound(method)
    if err == ARGUMENT_ERROR:
        return RpcTypeError(f"argument error calling {method}")
    return RpcCallError(f"{method}: {err!r}")
