"""Coordination / cluster membership (copy of ``jubatus_tpu/coord/``,
trimmed; ≙ jubatus/server/common/, SURVEY.md §2.1).

The reference coordinates replicas through ZooKeeper behind a
`lock_service` ABC (common/lock_service.hpp:33-118). The same seam — a small
`Coordinator` interface for ephemeral membership, config storage, locks,
and id minting — with the JAX package's two built-in backends:

- `MemoryCoordinator` — in-process, for tests and single-process clusters;
- `FileCoordinator` — a shared directory for multi-process single-host
  (and NFS-backed multi-host) clusters, in the JAX package's layout, so JAX
  and port servers on one directory form one fleet.

The coordination service (``tcp://``) and ZooKeeper (``zk://``) sessions
are not ported: those locators raise ``NotYetPorted``.
"""

from jubatus_tpu_torch import NotYetPorted
from jubatus_tpu_torch.coord.base import (  # noqa: F401
    Coordinator,
    CoordinatorError,
    NodeInfo,
)
from jubatus_tpu_torch.coord.file import FileCoordinator
from jubatus_tpu_torch.coord.memory import MemoryCoordinator


def create_coordinator(spec: str) -> Coordinator:
    """Build a coordinator from a locator string (≙ create_lock_service).

    "memory" / "memory://"        → process-local MemoryCoordinator
    "/path" / "file:///path"      → FileCoordinator on that directory
    "tcp://…", "host:port", "zk://…" → not yet ported
    """
    if spec in ("memory", "memory://"):
        return MemoryCoordinator.shared()
    if spec.startswith("file://"):
        return FileCoordinator(spec[len("file://"):])
    if spec.startswith("/") or spec.startswith("."):
        return FileCoordinator(spec)
    if spec.startswith(("tcp://", "zk://")) or (
            ":" in spec and spec.rpartition(":")[2].isdigit()):
        raise NotYetPorted(
            f"coordinator {spec!r}: the coordination service and ZooKeeper "
            "sessions are not yet ported (use a directory or file://)")
    raise CoordinatorError(f"unsupported coordinator spec {spec!r}")
