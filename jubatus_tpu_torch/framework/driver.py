"""Driver base class (copy of ``jubatus_tpu/framework/driver.py``).

A driver owns one engine's model state + fv_converter and exposes the
engine's business API, the mixable protocol (``get_mixables``), pack/unpack
for checkpoints, and clear. ``Mixable`` is a local protocol here, in place of
``jubatus_tpu.parallel.mix.Mixable``.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Any, Dict, Protocol

from jubatus_tpu_torch import device_scope


class Mixable(Protocol):
    """One mixable piece of model state: a diff out, a fold, a diff in."""

    def get_diff(self) -> Any: ...

    @staticmethod
    def mix(lhs: Any, rhs: Any) -> Any: ...

    def put_diff(self, diff: Any) -> bool: ...


def locked(fn):
    """Method decorator: hold the driver's model lock (one reentrant lock,
    as in the JAX package). A query's device work completes before its
    result leaves the lock: results are read back to the host inside."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self.lock:
            return fn(self, *args, **kwargs)

    return wrapper


def on_driver(driver) -> contextlib.ExitStack:
    """The driver's model lock, entered on the driver's device: the mixer,
    the RPC workers, the tick thread and the migration threads call in
    from outside the thread that built the driver."""
    stack = contextlib.ExitStack()
    stack.enter_context(device_scope(driver.device))
    stack.enter_context(driver.lock)
    return stack


class DriverBase:
    #: engine type name, e.g. "nearest_neighbor"
    TYPE: str = "base"
    #: version of ``pack()``'s layout, checked on load
    #: (framework/save_load.py); the JAX package's drivers write 1 too
    USER_DATA_VERSION: int = 1

    def __init__(self) -> None:
        self.update_count = 0
        #: model lock: drivers hold it in their public methods
        self.lock = threading.RLock()

    # -- mix plane ----------------------------------------------------------
    def get_mixables(self) -> Dict[str, Mixable]:
        return {}

    # -- persistence --------------------------------------------------------
    def pack(self) -> Any:
        raise NotImplementedError

    def unpack(self, obj: Any) -> None:
        raise NotImplementedError

    def clear(self) -> None:
        raise NotImplementedError

    # -- bookkeeping ---------------------------------------------------------
    def event_model_updated(self, n: int = 1) -> None:
        """Bump the update counter (the mixer watches it)."""
        self.update_count += n

    def get_status(self) -> Dict[str, Any]:
        return {"type": self.TYPE, "update_count": self.update_count}
