"""Coordination / cluster membership (copy of ``jubatus_tpu/coord/``,
trimmed; ≙ jubatus/server/common/, SURVEY.md §2.1).

The reference coordinates replicas through ZooKeeper behind a
`lock_service` ABC (common/lock_service.hpp:33-118). The same seam — a small
`Coordinator` interface for ephemeral membership, config storage, locks,
and id minting — with the JAX package's backends, in its layout, so JAX and
port servers on one coordinator form one fleet:

- `MemoryCoordinator` — in-process, for tests and single-process clusters;
- `FileCoordinator` — a shared directory for multi-process single-host
  (and NFS-backed multi-host) clusters;
- `RemoteCoordinator` — a session on the coordination service
  (``jubacoordd``, coord/server.py, or the JAX package's), for clusters
  with no shared filesystem.

ZooKeeper sessions (``zk://``) are not ported: that locator raises
``NotYetPorted``.
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

    "memory" / "memory://"         → process-local MemoryCoordinator
    "/path" / "file:///path"       → FileCoordinator on that directory
    "tcp://host:port", "host:port" → RemoteCoordinator session on the
                                     coordination service (coord/server.py)
    "zk://…"                       → not yet ported
    """
    if spec in ("memory", "memory://"):
        return MemoryCoordinator.shared()
    if spec.startswith("zk://"):
        raise NotYetPorted(
            f"coordinator {spec!r}: ZooKeeper sessions (coord/zk.py) are not "
            "yet ported (use tcp://host:port, a directory or file://)")
    if spec.startswith("file://"):
        return FileCoordinator(spec[len("file://"):])
    if spec.startswith("/") or spec.startswith("."):
        return FileCoordinator(spec)
    if spec.startswith("tcp://") or (":" in spec and
                                     spec.rpartition(":")[2].isdigit()):
        from jubatus_tpu_torch.coord.remote import RemoteCoordinator

        return RemoteCoordinator.from_locator(spec)
    raise CoordinatorError(f"unsupported coordinator spec {spec!r}")
