"""State-migration data plane (copy of ``jubatus_tpu/framework/migration.py``).

CHT-routed engines (recommender / nearest_neighbor / …) place rows on
ring successors; a membership change moves ranges between owners. This
module is the machinery that moves the ROWS with them:

- ``serve_range`` — the SOURCE side of the ``migrate_range`` RPC: walk my
  row store in sorted-id order from a cursor and return the rows the
  requesting member owns under the CURRENT ring, bounded by a byte
  budget per chunk. Pure read — the puller owns the cursor, so a
  re-issued chunk fetch re-reads the same rows (idempotent).
- ``RangePuller`` — the DESTINATION side: a chunked, double-buffered
  pull. The next chunk's ``migrate_range`` RPC is in flight on a reader
  thread while the current chunk applies through ``put_rows`` — the same
  ship/apply overlap as the JAX package's collective transfer engine,
  over RPC, with that engine's 8 MiB chunk budget
  (``DEFAULT_CHUNK_BYTES``; the collective plane itself is not ported).
  Sources that die mid-stream fail over to the remaining sources: with
  CHT replication >= 2 every row the dead source held exclusively for us
  is also on its ring successor, which is in the source list.
- ``DrainController`` — the departing member's state machine:
  ``active → draining → handoff → drained``. Draining flips the RPC
  dispatch gate (new EFFECTFUL calls are rejected with the retryable
  ``NodeDraining`` BEFORE any state change, so proxies re-route;
  in-flight work finishes), handoff pushes every local row to its new
  ring owners in byte-bounded ``put_rows`` chunks, drained unregisters.

Epoch protocol: every ``migrate_range`` carries the caller's membership
epoch; the source rejects a mismatch with the retryable
``EpochMismatch`` — the puller refreshes its ring/epoch view and
resumes from its cursor. No chunk is ever applied under a ring the two
sides disagree about.
"""

from __future__ import annotations

import bisect
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from jubatus_tpu_torch.coord.base import NodeInfo
from jubatus_tpu_torch.coord.cht import CHT
from jubatus_tpu_torch.framework.driver import on_driver
from jubatus_tpu_torch.rpc.errors import EpochMismatch, RpcError
from jubatus_tpu_torch.utils import faults

log = logging.getLogger(__name__)

#: chunk byte budget: the JAX package's mix data plane chunk plan
#: (``parallel/collective.py`` DEFAULT_CHUNK_MB = 8), the same order of
#: magnitude of transfer over the same wire
DEFAULT_CHUNK_BYTES = 8 << 20

#: CHT successor count rows are replicated onto (the engines' #@cht(2))
REPLICATION = 2


def row_owned_by(ring: CHT, row_id: str, member_name: str,
                 n: int = REPLICATION) -> bool:
    """Is ``member_name`` one of the ``n`` ring successors of the row?"""
    return any(m.name == member_name for m in ring.find(row_id, n))


def _row_bytes(row: Sequence[Any]) -> int:
    """Cheap size estimate for the chunk budget: id + 12 B per (idx,
    val) pair + the stored datum blob when present."""
    rid, ii, _vv = row[0], row[1], row[2]
    datum = row[3] if len(row) > 3 else None
    size = len(rid) + 12 * len(ii) + 16
    if isinstance(datum, (bytes, bytearray, str)):
        size += len(datum)
    elif datum is not None:
        size += 64
    return size


#: ids whose ownership the source walk checks, and whose rows it reads,
#: per step (one get_rows call)
WALK_BLOCK = 512


def _sorted_ids(driver: Any) -> List[str]:
    """The driver's row ids, sorted; cached on the driver while its rows
    are unchanged (drivers with a ``rows_version`` stamp), so a pull's
    chunks after the first do not sort every id again."""
    version = getattr(driver, "rows_version", None)
    cached = getattr(driver, "_migration_sorted_ids", None)
    if version is not None and cached is not None and cached[0] == version:
        return cached[1]
    ids = sorted(driver.row_ids())
    if version is not None:
        driver._migration_sorted_ids = (version, ids)
    return ids


def serve_range(driver: Any, ring: CHT, target: str, cursor: str,
                limit_bytes: int = DEFAULT_CHUNK_BYTES,
                n: int = REPLICATION) -> Dict[str, Any]:
    """One source-side chunk: rows after ``cursor`` (sorted id order)
    that ``target`` owns under ``ring``, up to ``limit_bytes``. Returns
    ``{"rows": [...], "cursor": next, "done": bool}``; ``cursor`` is the
    LAST id included, so resume is exact even if ids are inserted
    concurrently (sorted-order walk).

    The chunks and cursors are the JAX package's for the same rows and
    ring; the walk gets there faster: it starts at the cursor by
    bisection instead of scanning from the first id, reuses the sorted
    ids while the rows are unchanged, and reads the owned rows
    ``WALK_BLOCK`` ids at a time. The walk is host-metadata only:
    ``row_ids``/``get_rows`` read the row store's host arenas
    (core/row_store.py), never the device signature table."""
    if not hasattr(driver, "get_rows") or not hasattr(driver, "row_ids"):
        return {"rows": [], "cursor": "", "done": True}
    limit_bytes = max(1, int(limit_bytes))
    ids = _sorted_ids(driver)
    out: List[Any] = []
    size = 0
    last = str(cursor or "")
    pos = bisect.bisect_right(ids, last) if last else 0
    while pos < len(ids):
        block = [rid for rid in ids[pos:pos + WALK_BLOCK]
                 if row_owned_by(ring, rid, target, n)]
        pos += WALK_BLOCK
        # rows removed since the ids were read are skipped by get_rows
        for row in (driver.get_rows(block) if block else ()):
            out.append(row)
            last = row[0]
            size += _row_bytes(row)
            if size >= limit_bytes:
                return {"rows": out, "cursor": last, "done": False}
    return {"rows": out, "cursor": "", "done": True}


class MigrationStats:
    """Counters for one node's migration plane, mirrored into the
    tracing registry (``migration.rows_moved`` / ``migration.bytes``
    counters, ``migration.active`` gauge)."""

    def __init__(self, registry: Any = None) -> None:
        self.registry = registry
        self._lock = threading.Lock()
        self.rows_moved = 0
        self.bytes_moved = 0
        self.chunks = 0
        self.failovers = 0
        self.pulls = 0
        self.active = 0
        self.last_error = ""

    def note_chunk(self, rows: int, nbytes: int) -> None:
        with self._lock:
            self.rows_moved += rows
            self.bytes_moved += nbytes
            self.chunks += 1
        if self.registry is not None:
            if rows:
                self.registry.count("migration.rows_moved", rows)
            if nbytes:
                self.registry.count("migration.bytes", nbytes)

    def note_failover(self) -> None:
        with self._lock:
            self.failovers += 1
        if self.registry is not None:
            self.registry.count("migration.failovers")

    def set_active(self, active: bool) -> None:
        with self._lock:
            self.active += 1 if active else -1
            self.active = max(0, self.active)
            if active:
                self.pulls += 1
            val = self.active
        if self.registry is not None:
            self.registry.gauge("migration.active", float(val))

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"rows_moved": self.rows_moved,
                    "bytes": self.bytes_moved,
                    "chunks": self.chunks,
                    "failovers": self.failovers,
                    "pulls": self.pulls,
                    "active": self.active,
                    "last_error": self.last_error}


class RangePuller:
    """Destination side of a migration: pull my owned ranges from a list
    of source members, chunked and double-buffered (chunk N+1's RPC is
    in flight while chunk N applies locally).

    ``client_factory(node)`` must return an object with
    ``call(method, *args)`` (an rpc.client.RpcClient works); the puller
    closes nothing — callers own connection lifecycle."""

    def __init__(self, cluster: str, target: str,
                 apply_rows: Callable[[List[Any]], int],
                 client_factory: Callable[[NodeInfo], Any],
                 stats: Optional[MigrationStats] = None,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 epoch_of: Optional[Callable[[], int]] = None) -> None:
        self.cluster = cluster
        self.target = target
        self.apply_rows = apply_rows
        self.client_factory = client_factory
        self.stats = stats or MigrationStats()
        self.chunk_bytes = int(chunk_bytes)
        #: current-epoch reader: re-queried after an EpochMismatch so the
        #: pull resumes under the refreshed ring
        self.epoch_of = epoch_of or (lambda: 0)

    def _fetch(self, cli: Any, epoch: int, cursor: str) -> Dict[str, Any]:
        # chaos site (utils/faults.py): delay models a slow source,
        # error a mid-stream death — both exercise the puller's
        # failover/resume ladder deterministically
        if faults.is_armed():
            faults.fire("migration.pull")
        doc = cli.call("migrate_range", self.cluster, int(epoch),
                       self.target, cursor, self.chunk_bytes)
        if not isinstance(doc, dict):
            raise RpcError(f"malformed migrate_range reply: {type(doc)}")
        return {(k.decode() if isinstance(k, bytes) else k): v
                for k, v in doc.items()}

    def _pull_source(self, node: NodeInfo) -> Tuple[int, int]:
        """Drain one source; returns (rows, bytes). Double-buffered: the
        next chunk is fetched on the reader executor while the current
        one applies."""
        cli = self.client_factory(node)
        rows_total = bytes_total = 0
        cursor = ""
        epoch = int(self.epoch_of())
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="migrate-read") as ex:
            try:
                nxt = self._fetch(cli, epoch, cursor)
            except EpochMismatch:
                epoch = int(self.epoch_of())
                nxt = self._fetch(cli, epoch, cursor)
            while True:
                rows = nxt.get("rows") or []
                cursor = nxt.get("cursor") or ""
                done = bool(nxt.get("done"))
                fut = None
                if not done:
                    # ship/apply overlap: next chunk crosses the wire
                    # while this one lands in the row store
                    fut = ex.submit(self._fetch, cli, epoch, cursor)
                if rows:
                    applied = int(self.apply_rows(rows))
                    nbytes = sum(_row_bytes(r) for r in rows)
                    rows_total += applied
                    bytes_total += nbytes
                    self.stats.note_chunk(applied, nbytes)
                if done:
                    return rows_total, bytes_total
                try:
                    nxt = fut.result()
                except EpochMismatch:
                    # ring moved under us: adopt the new epoch and
                    # resume from the cursor (rows are overwrite-
                    # idempotent, so a replayed boundary row is safe)
                    epoch = int(self.epoch_of())
                    log.info("migrate_range epoch refresh (now %d), "
                             "resuming from %r", epoch, cursor)
                    nxt = self._fetch(cli, epoch, cursor)

    def pull(self, sources: Sequence[NodeInfo]) -> Dict[str, Any]:
        """Pull my owned ranges from every source (skipping myself).
        A source that dies mid-stream is abandoned and counted as a
        failover — its rows are also on its ring successor, which is in
        the source list (replication >= 2), so coverage holds."""
        t0 = time.monotonic()
        self.stats.set_active(True)
        rows = nbytes = 0
        failed: List[str] = []
        try:
            for node in sources:
                if node.name == self.target:
                    continue
                try:
                    r, b = self._pull_source(node)
                except Exception as e:  # broad-ok — failover is the plan
                    log.warning("migration pull from %s failed: %s",
                                node.name, e)
                    self.stats.note_failover()
                    self.stats.last_error = f"{node.name}: {e}"
                    failed.append(node.name)
                    continue
                rows += r
                nbytes += b
        finally:
            self.stats.set_active(False)
        secs = max(time.monotonic() - t0, 1e-9)
        return {"rows": rows, "bytes": nbytes, "seconds": round(secs, 3),
                "mb_per_sec": round(nbytes / 2 ** 20 / secs, 3),
                "sources_failed": failed}


class DrainController:
    """Departing-member state machine. One instance per EngineServer;
    ``run`` drives ``active → draining → handoff → drained`` on a
    background thread (the ``drain`` RPC returns immediately with the
    current state).

    - **draining**: unregister from actives + mark the coordinator's
      draining/ node (quorum stops counting us, proxies stop routing new
      CHT/random traffic our way), flip the dispatch gate so new
      effectful calls are rejected with ``NodeDraining`` (retryable —
      they re-route), wait for in-flight work (RPC workers + coalescer
      queues) to finish.
    - **handoff**: push every local row to its new ring owners
      (byte-bounded ``put_rows`` chunks).
    - **drained**: clear the draining marker; optionally remove the
      nodes/ registration, which fires the suicide watcher and stops
      the server (``stop_after``).
    """

    STATES = ("active", "draining", "handoff", "drained")

    def __init__(self, server: Any, grace_sec: float = 1.0,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> None:
        self.server = server
        self.grace_sec = float(grace_sec)
        self.chunk_bytes = int(chunk_bytes)
        self.state = "active"  # no-event — initial state, not a transition
        self.rows_handed_off = 0
        self.bytes_handed_off = 0
        self.error = ""
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # -- gate -----------------------------------------------------------------
    def _install_gate(self) -> None:
        from jubatus_tpu_torch.framework.idl import idempotent_methods
        from jubatus_tpu_torch.rpc.errors import NodeDraining

        allowed = set(idempotent_methods(self.server.engine))
        # drain's own control surface must keep answering
        allowed.update({"drain", "get_status", "get_metrics"})
        trace = self.server.trace

        def gate(method: str) -> None:
            if method in allowed:
                return
            trace.count("rpc.drain_rejected")
            raise NodeDraining(f"{method}: node draining")

        self.server.rpc.dispatch_gate = gate

    def _set_state(self, state: str) -> None:
        with self._lock:
            self.state = state
        trace = self.server.trace
        trace.gauge("drain.state", float(self.STATES.index(state)))
        # event plane: every drain phase edge on the timeline
        trace.events.emit("drain", state,
                          rows_handed_off=self.rows_handed_off or None)
        log.info("drain: %s", state)

    def _wait_inflight(self) -> None:
        """In-flight work finishes on its own (the gate only rejects NEW
        dispatches); wait for the coalescer queues to empty, bounded by
        the grace period."""
        deadline = time.monotonic() + max(self.grace_sec, 0.0)
        while time.monotonic() < deadline:
            busy = False
            for co in self.server.coalescers.values():
                if getattr(co, "_pending_items", None):
                    busy = True
                    break
            if not busy:
                # one short beat for dispatches between gate and queue
                time.sleep(min(0.1, self.grace_sec))
                return
            time.sleep(0.05)

    # -- handoff --------------------------------------------------------------
    def _handoff(self) -> None:
        srv = self.server
        driver = srv.driver
        if not (hasattr(driver, "get_rows") and hasattr(driver, "row_ids")):
            return  # replicated engines carry no CHT-owned rows
        from jubatus_tpu_torch.coord import membership

        me = srv.self_nodeinfo()
        actives = [m for m in membership.get_all_actives(
            srv.coord, srv.engine, srv.args.name) if m.name != me.name]
        if not actives:
            log.warning("drain: no remaining actives — rows stay local")
            return
        ring = CHT(actives,
                   epoch=membership.get_epoch(srv.coord, srv.engine,
                                              srv.args.name))
        with on_driver(driver):
            ids = sorted(driver.row_ids())
        # group rows by new owner, ship in byte-bounded chunks
        by_owner: Dict[str, Tuple[NodeInfo, List[Any], int]] = {}
        stats = srv.migration

        def flush(owner_key: str) -> None:
            node, rows, size = by_owner.pop(owner_key)
            if not rows:
                return
            try:
                srv.peer_client(node).call("put_rows", srv.args.name, rows)
                self.rows_handed_off += len(rows)
                self.bytes_handed_off += size
                stats.note_chunk(len(rows), size)
            except Exception as e:  # broad-ok — best-effort per owner
                log.warning("drain handoff to %s failed: %s", node.name, e)
                srv.drop_peer_client(node)
                stats.note_failover()
                self.error = f"{node.name}: {e}"

        # rows are read WALK_BLOCK ids per lock hold (the JAX package
        # takes the lock per row); the chunks flushed are the same
        for lo in range(0, len(ids), WALK_BLOCK):
            with on_driver(driver):
                rows = driver.get_rows(ids[lo:lo + WALK_BLOCK])
            for row in rows:
                size = _row_bytes(row)
                for owner in ring.find(row[0], REPLICATION):
                    entry = by_owner.get(owner.name)
                    if entry is None:
                        entry = by_owner[owner.name] = (owner, [], 0)
                    node, rows_acc, acc = entry
                    rows_acc.append(row)
                    by_owner[owner.name] = (node, rows_acc, acc + size)
                    if acc + size >= self.chunk_bytes:
                        flush(owner.name)
        for key in list(by_owner):
            flush(key)

    # -- the state machine ----------------------------------------------------
    def start(self, stop_after: bool = False) -> str:
        """Kick the drain off (idempotent — a second call reports the
        current state)."""
        with self._lock:
            if self._thread is not None:
                return self.state
            self._thread = threading.Thread(
                target=self._run, args=(bool(stop_after),),
                daemon=True, name="drain")
        self._thread.start()
        return "draining"

    def _run(self, stop_after: bool) -> None:
        srv = self.server
        from jubatus_tpu_torch.coord import membership

        try:
            self._set_state("draining")
            me = srv.self_nodeinfo()
            if srv.coord is not None:
                try:
                    membership.mark_draining(
                        srv.coord, srv.engine, srv.args.name,
                        me.host, me.port)
                    membership.unregister_active(
                        srv.coord, srv.engine, srv.args.name,
                        me.host, me.port)
                except Exception:  # broad-ok — drain must proceed
                    log.warning("drain: coordinator update failed",
                                exc_info=True)
            # a draining member must not re-promote itself on the next
            # healthy put_diff
            if srv.mixer is not None:
                srv.mixer.on_active = None
            self._install_gate()
            self._wait_inflight()
            self._set_state("handoff")
            self._handoff()
            self._set_state("drained")
            if srv.coord is not None:
                try:
                    membership.clear_draining(
                        srv.coord, srv.engine, srv.args.name,
                        me.host, me.port)
                except Exception:  # broad-ok
                    log.debug("drain: clear marker failed", exc_info=True)
                if stop_after:
                    # removing our nodes/ entry fires the suicide
                    # watcher — the clean unregister-then-exit path
                    try:
                        srv.coord.remove(
                            f"{membership.actor_path(srv.engine, srv.args.name)}"
                            f"/nodes/{me.name}")
                    except Exception:  # broad-ok
                        log.debug("drain: node unregister failed",
                                  exc_info=True)
        except Exception as e:  # broad-ok — surface via drain_status
            self.error = str(e)
            log.exception("drain failed")

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self.state,
                    "rows_handed_off": self.rows_handed_off,
                    "bytes_handed_off": self.bytes_handed_off,
                    "error": self.error}
