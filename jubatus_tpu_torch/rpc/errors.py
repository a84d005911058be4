"""RPC error taxonomy (copy of ``jubatus_tpu/rpc/errors.py``;
≙ mprpc/rpc_error.hpp + mprpc/exception.hpp).

The reference maps msgpack-rpc failures to typed exceptions
(rpc_mclient.hpp:36-93 JUBATUS_MSGPACKRPC_EXCEPTION_DEFAULT_HANDLER); we keep
the same taxonomy so server/proxy code can branch on failure class, and the
same on-wire integer codes as the msgpack-rpc C++ implementation for
method-not-found (1) and argument errors (2) so reference clients see the
errors they expect.

Beyond the reference, every class carries a **retryable** axis: transport
failures where the request may simply be re-issued (`RpcIoError`,
`RpcTimeoutError`) are retryable — but only for IDEMPOTENT methods (the
idempotency tables live in framework/idl.py, the retry machinery in
rpc/retry.py); application errors from a healthy server and expired
deadlines are not. ``DeadlineExceeded`` gets its own on-wire code (3 — an
extension; legacy peers see an unknown code and map it to a generic call
error) so deadline rejections survive a proxy hop as themselves.
"""

from __future__ import annotations

from typing import Any, List

#: on-wire error codes (msgpack-rpc convention, used by the reference servers)
NO_METHOD_ERROR = 1
ARGUMENT_ERROR = 2
#: extension code: the server refused/abandoned the call because its
#: deadline had already expired (rpc/deadline.py)
DEADLINE_EXCEEDED_ERROR = 3
#: extension codes (elastic membership): the server refused the
#: call BEFORE applying it — because it is draining (4) or because the
#: caller's ring view is from another membership epoch (5). Both are
#: safe to re-route (nothing was applied) and both tell the caller to
#: refresh its member/ring view first. Legacy peers see an unknown code
#: and map it to a generic call error.
NODE_DRAINING_ERROR = 4
EPOCH_MISMATCH_ERROR = 5


class RpcError(RuntimeError):
    """Base of all RPC failures (≙ mprpc/exception.hpp rpc_error).

    ``retryable``: True when the failure is a transport-level loss where
    the server may never have seen (or finished) the request — re-issuing
    it can succeed and, for idempotent methods, is safe.
    """

    retryable = False


class RpcMethodNotFound(RpcError):
    def __init__(self, method: str = "") -> None:
        super().__init__(f"method not found: {method}")
        self.method = method


class RpcTypeError(RpcError):
    """Argument arity/type mismatch (≙ rpc_type_error)."""


class RpcCallError(RpcError):
    """Server raised while executing the method (≙ rpc_call_error)."""


class RpcIoError(RpcError):
    """Connection failed / reset mid-call (≙ rpc_io_error)."""

    retryable = True


class RpcTimeoutError(RpcError):
    """Call exceeded the client timeout (≙ rpc_timeout_error)."""

    retryable = True


class DeadlineExceeded(RpcError):
    """The call's propagated deadline expired (client pre-flight, server
    dispatch rejection, or proxy fan-out budget exhaustion). NOT
    retryable: the budget is gone — retrying would spend work the caller
    can no longer use."""


class BreakerOpen(RpcError):
    """A circuit breaker refused the call without touching the backend
    (rpc/breaker.py). Retryable against a DIFFERENT backend — the proxy's
    failover path treats it like an instantaneous IO failure."""

    retryable = True

    def __init__(self, target: str = "") -> None:
        super().__init__(f"circuit breaker open for {target}")
        self.target = target


class NodeDraining(RpcError):
    """The target refused an effectful call at dispatch because it is
    draining (elastic membership). The call was NEVER applied,
    so re-routing it to another replica is safe even for effectful
    methods — retryable, with a membership refresh first."""

    retryable = True

    def __init__(self, detail: str = "") -> None:
        super().__init__(detail or "node draining")


class EpochMismatch(RpcError):
    """Caller and callee disagree on the membership epoch — the caller's
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


class RpcNoResult(RpcError):
    """Fan-out completed but produced no usable result (≙ rpc_no_result)."""


class RpcNoClient(RpcError):
    """No host reachable for a fan-out call (≙ rpc_no_client)."""


class HostError(RpcError):
    """One host's failure inside a fan-out (≙ rpc_error{host, port, exc})."""

    def __init__(self, host: str, port: int, cause: BaseException) -> None:
        super().__init__(f"{host}:{port}: {cause}")
        self.host = host
        self.port = port
        self.cause = cause


class MultiRpcError(RpcError):
    """Aggregate of per-host failures (≙ error_multi_rpc)."""

    def __init__(self, errors: List[HostError]) -> None:
        super().__init__("; ".join(str(e) for e in errors) or "all hosts failed")
        self.errors = errors


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
    if isinstance(exc, DeadlineExceeded):
        return DEADLINE_EXCEEDED_ERROR
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
    if err == DEADLINE_EXCEEDED_ERROR:
        return DeadlineExceeded(f"{method}: deadline exceeded at server")
    if err == NODE_DRAINING_ERROR:
        return NodeDraining(f"{method}: node draining")
    if err == EPOCH_MISMATCH_ERROR:
        return EpochMismatch(f"{method}: membership epoch mismatch")
    return RpcCallError(f"{method}: {err!r}")
