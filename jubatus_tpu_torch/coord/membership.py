"""Cluster registry path schema (copy of ``jubatus_tpu/coord/membership.py``,
trimmed to what an engine server, its mixer, the proxy and the ops CLIs
use; ≙
common/membership.{hpp,cpp}).

Same tree as the reference (membership.hpp:32-36, membership.cpp:59-66),
and the same as the JAX package's, so servers of both packages on one
coordinator see each other:

    /jubatus/actors/<type>/<name>/nodes/<ip>_<port>     all booted servers
    /jubatus/actors/<type>/<name>/actives/<ip>_<port>   mix-current servers
    /jubatus/actors/<type>/<name>/master_lock           per-round mix master
    /jubatus/actors/<type>/<name>/id_generator          cluster id counter
    /jubatus/config/<type>/<name>                       engine JSON config
    /jubatus/supervisors/<ip>_<port>                    jubavisor daemons
    /jubatus/jubaproxies/<ip>_<port>                    routing proxies
    /jubatus/autoscalers/<ip>_<port>                    autoscaler loops

Beyond the reference — elastic membership:

    .../membership_epoch        monotone counter node (create_id bumps)
    .../membership_epoch_value  readable mirror of the last minted epoch
    .../draining/<ip>_<port>    members mid-drain (quorum excludes them)

Every ACTUAL actives change (a create that created, a remove that
removed) mints a new **membership epoch** through the coordinator's
atomic counter. The mirror node makes the epoch READABLE without bumping
it; consumers treat ANY difference as "refresh", never as an ordering.
A draining member of either package marks itself there, so it leaves a
mixed fleet's quorum as it leaves a one-package fleet's.
"""

from __future__ import annotations

import logging
from typing import List

from jubatus_tpu_torch.coord.base import Coordinator, NodeInfo
from jubatus_tpu_torch.utils import events

log = logging.getLogger(__name__)

JUBATUS_BASE = "/jubatus"
ACTOR_BASE = f"{JUBATUS_BASE}/actors"
CONFIG_BASE = f"{JUBATUS_BASE}/config"
SUPERVISOR_BASE = f"{JUBATUS_BASE}/supervisors"
PROXY_BASE = f"{JUBATUS_BASE}/jubaproxies"
AUTOSCALER_BASE = f"{JUBATUS_BASE}/autoscalers"


def actor_path(engine: str, name: str) -> str:
    return f"{ACTOR_BASE}/{engine}/{name}"


def config_path(engine: str, name: str) -> str:
    return f"{CONFIG_BASE}/{engine}/{name}"


def register_actor(
    coord: Coordinator, engine: str, name: str, host: str, port: int
) -> str:
    """Ephemeral registration under nodes/ (membership.cpp:68-112).
    Returns the node path so the caller can arm a suicide watcher."""
    path = f"{actor_path(engine, name)}/nodes/{NodeInfo(host, port).name}"
    coord.create(path, ephemeral=True)
    return path


def register_active(
    coord: Coordinator, engine: str, name: str, host: str, port: int
) -> str:
    """Join the actives list (membership.cpp:115-145) — the mixer drives
    transitions on put_diff success/failure. An ACTUAL join (the node was
    not already active) mints a new membership epoch — re-registration
    after every healthy put_diff does not."""
    path = f"{actor_path(engine, name)}/actives/{NodeInfo(host, port).name}"
    if coord.create(path, ephemeral=True):
        bump_epoch(coord, engine, name)
    return path


def unregister_active(
    coord: Coordinator, engine: str, name: str, host: str, port: int
) -> bool:
    removed = coord.remove(
        f"{actor_path(engine, name)}/actives/{NodeInfo(host, port).name}"
    )
    if removed:
        bump_epoch(coord, engine, name)
    return removed


# -- membership epoch ---------------------------------------------------------

def epoch_path(engine: str, name: str) -> str:
    return f"{actor_path(engine, name)}/membership_epoch"


def bump_epoch(coord: Coordinator, engine: str, name: str) -> int:
    """Mint the next membership epoch (coordinator-atomic counter) and
    mirror it into the readable value node. Returns the minted epoch.
    Failures are survivable — the epoch is a freshness signal, not a
    correctness gate (consumers refresh on ANY mismatch)."""
    path = epoch_path(engine, name)
    try:
        epoch = coord.create_id(path)
    except Exception:  # broad-ok — a coord hiccup must not kill a join
        log.warning("membership epoch bump failed for %s/%s", engine, name,
                    exc_info=True)
        return 0
    try:
        coord.set(f"{path}_value", str(epoch).encode())
    except Exception:  # broad-ok — mirror is best-effort
        log.debug("epoch mirror write failed", exc_info=True)
    events.emit("membership", "epoch_bump", epoch=epoch,
                cluster=f"{engine}/{name}")
    return epoch


def get_epoch(coord: Coordinator, engine: str, name: str) -> int:
    """Last published membership epoch (0 before the first join/leave)."""
    try:
        raw = coord.read(f"{epoch_path(engine, name)}_value")
    except Exception:  # broad-ok — treated as "unknown", epoch 0
        return 0
    if not raw:
        return 0
    try:
        return int(raw.decode())
    except (ValueError, UnicodeDecodeError):
        return 0


def draining_path(engine: str, name: str) -> str:
    return f"{actor_path(engine, name)}/draining"


def mark_draining(coord: Coordinator, engine: str, name: str,
                  host: str, port: int) -> str:
    """Announce a member is draining: still booted (nodes/), no longer
    routable or quorum-countable. Ephemeral — a drain that dies with its
    process clears itself."""
    path = f"{draining_path(engine, name)}/{NodeInfo(host, port).name}"
    coord.create(path, ephemeral=True)
    return path


def clear_draining(coord: Coordinator, engine: str, name: str,
                   host: str, port: int) -> bool:
    return coord.remove(
        f"{draining_path(engine, name)}/{NodeInfo(host, port).name}")


def get_draining(coord: Coordinator, engine: str, name: str) -> List[NodeInfo]:
    return _nodes_under(coord, draining_path(engine, name))


def _nodes_under(coord: Coordinator, path: str) -> List[NodeInfo]:
    out = []
    for child in coord.list(path):
        try:
            out.append(NodeInfo.from_name(child))
        except (ValueError, IndexError):
            continue
    return out


def get_all_nodes(coord: Coordinator, engine: str, name: str) -> List[NodeInfo]:
    """All booted members (membership get_all_nodes)."""
    return _nodes_under(coord, f"{actor_path(engine, name)}/nodes")


def get_all_actives(coord: Coordinator, engine: str, name: str) -> List[NodeInfo]:
    return _nodes_under(coord, f"{actor_path(engine, name)}/actives")


def register_proxy(coord: Coordinator, host: str, port: int) -> str:
    path = f"{PROXY_BASE}/{NodeInfo(host, port).name}"
    coord.create(path, ephemeral=True)
    return path


def register_supervisor(coord: Coordinator, host: str, port: int) -> str:
    path = f"{SUPERVISOR_BASE}/{NodeInfo(host, port).name}"
    coord.create(path, ephemeral=True)
    return path


def register_autoscaler(coord: Coordinator, host: str, port: int) -> str:
    """Ephemeral autoscaler registration — dies with the control loop, so
    a crashed autoscaler never shadows a new one."""
    path = f"{AUTOSCALER_BASE}/{NodeInfo(host, port).name}"
    coord.create(path, ephemeral=True)
    return path


def get_autoscalers(coord: Coordinator) -> List[NodeInfo]:
    return _nodes_under(coord, AUTOSCALER_BASE)
