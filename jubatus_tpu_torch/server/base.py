"""EngineServer (lean counterpart of ``jubatus_tpu/server/base.py``).

Owns one driver on an explicit device and the RPC server, and answers the
engine's IDL methods plus the built-ins get_config, get_status, save, load
and do_mix. Models are saved in the JAX package's file format
(framework/save_load.py) under ``<datadir>/<ip>_<port>_<type>_<id>.jubatus``,
so a file saved by either package's server loads in the other's; ``-m``
loads one at start.

Given a coordinator (``-z``: a directory, ``file://``, or the
coordination service at ``tcp://host:port``), the server registers its
membership, mixes with its fleet through the mixer ``--mixer`` names
(framework/push_mixer.py ``create_mixer``: the RPC linear mixer, the
asynchronous plane with ``--mix-async``, the collective mixer over the
process world ``--jax-processes`` joins, a push strategy, or none), which
serves the ``mix_*`` RPCs, mints anomaly's and graph's ids through the
coordinator and places each new row or node on its CHT(2) owners
(server/service.py ``_replicated_write``), and keeps burst's keyword
assignment on the CHT of the booted members. The fleet may hold JAX
servers too: the coordinator layout, the mix wire and the model files are
the JAX package's. A routing proxy (server/proxy.py) may stand in front of
the fleet.

The durability and elastic planes, as in the JAX server:

- **elastic membership** (framework/migration.py): ``get_epoch``,
  ``migrate_range`` (the source side of a row pull), ``put_rows``,
  ``get_row_count``, ``rebalance`` (the joiner's pull, run in the
  background at start unless ``--no-auto-rebalance``), ``drain`` and
  ``drain_status`` (refuse new effectful calls, hand rows to their new
  ring owners, leave);
- **model snapshots and rollback** (framework/model_guard.py): a ring of
  last-good snapshots taken every ``--model-snapshot-interval`` seconds
  or by ``take_snapshot``; ``rollback`` restores the newest, and under
  ``--mix-guard quarantine`` a put_diff that refuses a non-finite total
  rolls back on its own;
- **the model store** (framework/model_store.py, ``--store-dir``): full
  and diff records uploaded every ``--store-interval`` seconds, a warm
  boot from the freshest record before the server joins its fleet,
  ``store_restore`` (a point-in-time restore that reshards rows onto the
  current ring), ``get_store_status``, and ``store:<key>`` model ids in
  ``save`` and ``load``.

The snapshot and upload hooks run on one small tick thread that waits on
the server's stop event. Each of these planes packs or loads the model
under the driver's lock on the driver's device, where the JAX server
holds its lock. Not carried over: the incident bundles a rollback
triggers (the event is emitted), and the observability planes;
``health.status`` / ``health.reasons`` in get_status carry the mix
plane's part of the JAX server's degraded reasons.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from jubatus_tpu_torch import __version__, device_scope
from jubatus_tpu_torch.coord import Coordinator, create_coordinator, membership
from jubatus_tpu_torch.coord.base import NodeInfo
from jubatus_tpu_torch.coord.idgen import IdGenerator
from jubatus_tpu_torch.framework.driver import on_driver
from jubatus_tpu_torch.framework.migration import (DEFAULT_CHUNK_BYTES,
                                                   DrainController,
                                                   MigrationStats,
                                                   RangePuller, serve_range)
from jubatus_tpu_torch.framework.model_guard import ModelSnapshotRing
from jubatus_tpu_torch.framework.push_mixer import (PushCommunication,
                                                    create_mixer)
from jubatus_tpu_torch.framework.save_load import (SaveLoadError, load_model,
                                                   load_model_bytes,
                                                   read_envelope, save_model)
from jubatus_tpu_torch.ops import online_scan, sig_scan
from jubatus_tpu_torch.parallel.mesh import local_shard_mesh
from jubatus_tpu_torch.rpc.client import RpcClient
from jubatus_tpu_torch.rpc.errors import EpochMismatch
from jubatus_tpu_torch.rpc.server import RpcServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.server.factory import create_driver
from jubatus_tpu_torch.utils import faults
from jubatus_tpu_torch.utils.serialization import unpack_obj
from jubatus_tpu_torch.utils.tracing import Registry

log = logging.getLogger(__name__)

#: longest wait of the tick thread between two looks at its hooks
TICK_MAX_SEC = 10.0


class EngineServer:
    def __init__(self, engine: str, config: Any,
                 args: Optional[ServerArgs] = None, device=None,
                 coord: Optional[Coordinator] = None, mesh=None) -> None:
        """``mesh``: a ``ShardMesh`` to shard the model over (the instance
        engines' rows, the linear engines' feature columns), for callers
        in process (tests, the chip smoke: logical shards on one device);
        otherwise ``--shard-devices N`` builds one from the first N local
        devices."""
        self.engine = engine
        self.args = args or ServerArgs(engine=engine)
        device = device if device is not None else self.args.device
        if mesh is None and self.args.shard_devices > 1:
            mesh = local_shard_mesh(self.args.shard_devices, device)
        # --fault: arm boot-time fault-injection rules (process-global, as
        # the chaos plane models the process, not one server object)
        if self.args.fault:
            faults.arm(*self.args.fault)
            log.warning("fault injection armed from --fault: %s",
                        ", ".join(self.args.fault))
        if isinstance(config, dict):
            config = json.dumps(config)
        self.config_json: str = config
        self.driver = create_driver(
            engine, json.loads(config), device=device, mesh=mesh,
            shard_features=self.args.shard_features, ann=self.args.ann,
            ann_cells=self.args.ann_cells, ann_nprobe=self.args.ann_nprobe)
        self.start_time = time.time()  # wall-clock
        self.last_saved = 0.0
        self.last_loaded = 0.0
        #: this server's metrics (rpc and mix spans, counters, gauges,
        #: events); the RPC server records its dispatch spans here
        self.trace = Registry()
        self.rpc = RpcServer(trace=self.trace)
        #: method -> its microbatch coalescer (server/service.py)
        self.coalescers: Dict[str, Any] = {}
        self._stopped = threading.Event()
        self._stop_once = threading.Lock()  # first stop() wins; rest no-op
        #: pooled peer clients (migration handoff, row pulls)
        self._peers: Dict[str, RpcClient] = {}
        self._peer_lock = threading.Lock()
        #: watch-invalidated CHT snapshot and membership epoch
        self._cht_cache = None
        self._cht_expiry = 0.0
        self._cht_watched = False
        self._cht_lock = threading.Lock()
        self._epoch_cache: Optional[int] = None

        # elastic membership: migration counters + the drain state machine
        self.migration = MigrationStats(registry=self.trace)
        self.drain_ctl = DrainController(self, grace_sec=self.args.drain_grace)
        #: the background join-time pull, once started
        self.join_thread: Optional[threading.Thread] = None
        # model-integrity plane: bounded ring of last-good snapshots
        self.snapshots = ModelSnapshotRing()
        self._last_snapshot = 0.0
        self.rollbacks = 0
        # durable model plane: the shared store, its uploader (made at
        # start(), once the bound port names this node), warm-boot record
        self.store = None
        self.store_uploader = None
        self.warmboot: Dict[str, Any] = {}
        self._last_store_upload = 0.0
        if self.args.store_dir:
            from jubatus_tpu_torch.framework.model_store import (
                LocalDirBackend, ModelStore)

            self.store = ModelStore(
                LocalDirBackend(self.args.store_dir),
                cluster=self.args.name or "standalone", engine=engine,
                counter=self.trace.count)

        # distributed wiring (server_helper ctor path, server_helper.cpp:48-78)
        self.coord = coord
        self.mixer: Optional[Any] = None
        if not self.args.is_standalone or coord is not None:
            if self.coord is None:
                self.coord = create_coordinator(self.args.coordinator)
            comm = PushCommunication(
                self.coord, engine, self.args.name,
                timeout=self.args.interconnect_timeout)
            self.mixer = create_mixer(
                self.args.mixer, self.driver, comm,
                self_node=NodeInfo(self.args.eth, self.args.rpc_port),
                interval_sec=self.args.interval_sec,
                interval_count=self.args.interval_count,
                quorum_fraction=self.args.mix_quorum,
                mix_async=self.args.mix_async,
                mix_staleness_bound=self.args.mix_staleness_bound,
                mix_guard=self.args.mix_guard,
                mix_norm_bound=self.args.mix_norm_bound,
                mix_compress=self.args.mix_compress,
                mix_bf16=self.args.mix_bf16,
                mix_topology=self.args.mix_topology)
            self.mixer.set_trace_registry(self.trace)
            # a put_diff refusing a non-finite folded total rolls back
            if hasattr(self.mixer, "on_poisoned_total"):
                self.mixer.on_poisoned_total = self._auto_rollback
            # cluster-unique id minting for the engines that mint ids
            # (≙ global_id_generator_zk: anomaly add, graph create_node/edge)
            if hasattr(self.driver, "set_id_generator"):
                self.driver.set_id_generator(IdGenerator(
                    self.coord,
                    f"{membership.actor_path(engine, self.args.name)}"
                    "/id_generator"))
            # count updates into the mixer (server_base.cpp:214-219)
            driver_event = self.driver.event_model_updated

            def chained(n: int = 1) -> None:
                driver_event(n)
                self.mixer.updated(n)

            self.driver.event_model_updated = chained  # type: ignore[assignment]

    @classmethod
    def from_args(cls, args: ServerArgs,
                  coord: Optional[Coordinator] = None) -> "EngineServer":
        """Build from flags (run_server, server_util.hpp:139-176): the
        config from ``-f``, or in distributed mode from the coordinator;
        then the ``-m`` model file, if any."""
        if args.configpath:
            with open(args.configpath) as f:
                config = f.read()
        elif not args.is_standalone:
            if coord is None:
                coord = create_coordinator(args.coordinator)
            raw = coord.read(membership.config_path(args.engine, args.name))
            if raw is None:
                raise RuntimeError(
                    f"no config registered for {args.engine}/{args.name}")
            config = raw.decode()
        else:
            raise RuntimeError("standalone mode requires -f/--configpath")
        srv = cls(args.engine, config, args, coord=coord)
        if args.model_file:
            srv.load_file(args.model_file)
        return srv

    def self_nodeinfo(self) -> NodeInfo:
        return NodeInfo(self.args.eth, self.rpc.port or self.args.rpc_port)

    # -- peer RPC -----------------------------------------------------------------
    def peer_client(self, node: NodeInfo) -> RpcClient:
        """Pooled RPC client to a cluster peer."""
        with self._peer_lock:
            cli = self._peers.get(node.name)
            if cli is None:
                cli = RpcClient(node.host, node.port,
                                self.args.interconnect_timeout)
                self._peers[node.name] = cli
            return cli

    def drop_peer_client(self, node: NodeInfo) -> None:
        with self._peer_lock:
            cli = self._peers.pop(node.name, None)
        if cli is not None:
            cli.close()

    def _close_peers(self) -> None:
        with self._peer_lock:
            peers = list(self._peers.values())
            self._peers.clear()
        for cli in peers:
            cli.close()

    def cluster_cht(self):
        """CHT over the current actives (cht.cpp:107-143); None in
        standalone mode. Cached: the ring is a pure function of
        membership, so it rebuilds only when the actives watch fires (or
        on a 2 s expiry for coordinators whose watches are best-effort)."""
        if self.coord is None:
            return None
        from jubatus_tpu_torch.coord.cht import CHT

        now = time.monotonic()
        with self._cht_lock:
            if self._cht_cache is not None and now < self._cht_expiry:
                return self._cht_cache
        cht = CHT.from_coordinator(self.coord, self.engine, self.args.name)
        with self._cht_lock:
            self._cht_cache = cht
            # the ring's epoch is the fresh one: a rebuild refreshes the
            # cached epoch too, so the 2 s expiry bounds its staleness
            # even when no watch fired (the JAX server keeps its cached
            # epoch until the watch fires)
            self._epoch_cache = cht.epoch
            self._cht_expiry = now + 2.0
            if not self._cht_watched:
                self._cht_watched = True
                path = membership.actor_path(
                    self.engine, self.args.name) + "/actives"
                try:
                    self.coord.watch_children(
                        path, lambda _p: self._invalidate_cht())
                except NotImplementedError:
                    pass
        return cht

    def _invalidate_cht(self) -> None:
        with self._cht_lock:
            self._cht_cache = None
            self._epoch_cache = None

    # -- elastic membership -------------------------------------------------------
    def membership_epoch(self) -> int:
        """Current membership epoch, cached beside the CHT snapshot (both
        invalidate on the same actives watch). Standalone: 0."""
        if self.coord is None:
            return 0
        with self._cht_lock:
            cached = self._epoch_cache
        if cached is not None:
            return cached
        epoch = membership.get_epoch(self.coord, self.engine, self.args.name)
        with self._cht_lock:
            self._epoch_cache = epoch
        self.trace.gauge("cluster.epoch", float(epoch))
        return epoch

    def get_epoch(self, _name: str = "") -> int:
        # the CHT cache expiry (2 s) bounds staleness (a rebuild refreshes
        # the epoch); a watch-driven invalidation makes it immediate
        self.cluster_cht()
        return self.membership_epoch()

    def migrate_range(self, _name: str, epoch: int, target: str,
                      cursor: str = "", limit: int = 0) -> Dict[str, Any]:
        """SOURCE side of the migration plane: rows after ``cursor`` that
        ``target`` owns under the current ring. The caller's epoch must
        match mine — a mismatch is the retryable ``EpochMismatch`` that
        makes the puller refresh its ring (framework/migration.py)."""
        mine = self.get_epoch()
        if int(epoch) != mine:
            raise EpochMismatch(expected=mine, got=int(epoch))
        target = _text(target)
        cursor = _text(cursor)
        ring = self.cluster_cht()
        if ring is None:
            return {"rows": [], "cursor": "", "done": True, "epoch": mine}
        if target not in {m.name for m in ring.members}:
            # the joiner may register between my watch ticks: extend the
            # ring view rather than reject (same members → same ring)
            from jubatus_tpu_torch.coord.cht import CHT

            try:
                node = NodeInfo.from_name(target)
            except (ValueError, IndexError):
                return {"rows": [], "cursor": "", "done": True,
                        "epoch": mine}
            ring = CHT(list(ring.members) + [node], epoch=ring.epoch)
        with on_driver(self.driver):
            doc = serve_range(self.driver, ring, target, cursor,
                              int(limit) or DEFAULT_CHUNK_BYTES)
        doc["epoch"] = mine
        return doc

    def put_rows(self, _name: str, rows: Any) -> int:
        """Apply migrated rows (already-hashed vectors — no reconvert).
        Drivers without row hooks accept nothing (0)."""
        if not hasattr(self.driver, "put_rows"):
            return 0
        with on_driver(self.driver):
            return int(self.driver.put_rows(rows or []))

    def get_row_count(self, _name: str = "") -> int:
        if hasattr(self.driver, "row_ids"):
            with on_driver(self.driver):
                return len(self.driver.row_ids())
        return 0

    def drain(self, _name: str = "", stop_after: bool = False) -> Dict[str, Any]:
        """Begin the drain state machine (framework/migration.py): reject
        new effectful work (retryable ``NodeDraining``), finish in-flight,
        hand rows to their new owners, unregister. Idempotent; returns
        the current state doc."""
        if self.coord is None:
            return {"state": "active", "error": "standalone: nothing to drain"}
        self.drain_ctl.start(stop_after=bool(stop_after))
        return self.drain_status()

    def drain_status(self, _name: str = "") -> Dict[str, Any]:
        doc = self.drain_ctl.status()
        doc["epoch"] = self.membership_epoch()
        return doc

    def rebalance(self, _name: str = "") -> Dict[str, Any]:
        """Pull every row this member owns under the CURRENT ring from the
        other actives — the joining member's half of the migration plane.
        Safe to re-run: rows apply as overwrites."""
        empty = {"rows": 0, "bytes": 0, "seconds": 0.0,
                 "mb_per_sec": 0.0, "sources_failed": []}
        if self.coord is None or not hasattr(self.driver, "put_rows"):
            return empty
        me = self.self_nodeinfo()
        sources = [m for m in membership.get_all_actives(
            self.coord, self.engine, self.args.name) if m.name != me.name]
        if not sources:
            return empty

        def apply_rows(rows) -> int:
            with on_driver(self.driver):
                return int(self.driver.put_rows(rows))

        puller = RangePuller(
            self.args.name, me.name, apply_rows,
            client_factory=self.peer_client, stats=self.migration,
            epoch_of=lambda: self.get_epoch())
        return puller.pull(sources)

    def _join_migration(self) -> None:
        """Background join-time pull: a freshly registered replica
        streams its owned ranges from the current owners. Best-effort —
        a failed pull leaves the replica serving what the mix plane
        replicates; ``rebalance`` repairs."""
        try:
            out = self.rebalance(self.args.name)
            if out.get("rows"):
                log.info("join migration: pulled %d rows (%.2f MB) in %.2fs",
                         out["rows"], out["bytes"] / 2 ** 20, out["seconds"])
        except Exception:  # broad-ok — join must not die on migration
            log.warning("join migration failed", exc_info=True)

    # -- model snapshots + rollback ---------------------------------------------
    def _model_snapshot_tick(self) -> None:
        """One tick: take a snapshot into the rollback ring when the
        interval elapsed (the first tick seeds the baseline)."""
        now = time.monotonic()
        if self._last_snapshot and \
                now - self._last_snapshot < self.args.model_snapshot_interval:
            return
        try:
            self.take_snapshot()
        except Exception:  # broad-ok — a failed snapshot must not kill
            log.warning("model snapshot failed", exc_info=True)  # the tick

    def take_snapshot(self) -> Dict[str, Any]:
        """Capture one in-process model snapshot (CRC-stamped save_load
        envelope) into the bounded rollback ring; the model lock is held
        over the pack and the envelope, as in the JAX server. The entry's
        ``lock_ms`` is that hold."""
        version = getattr(self.mixer, "model_version", 0) \
            if self.mixer is not None else 0
        with self.trace.span("snapshot.lock") as sp:
            with on_driver(self.driver):
                entry = self.snapshots.snapshot(self.driver, version)
        self._last_snapshot = time.monotonic()
        self.trace.gauge("mix.snapshots",
                         float(self.snapshots.stats()["count"]))
        self.trace.gauge("snapshot.lock_ms", round(sp.seconds * 1e3, 3))
        out = {k: v for k, v in entry.items() if k != "blob"}
        out["lock_ms"] = round(sp.seconds * 1e3, 3)
        return out

    def rollback(self, _name: str = "", reason: str = "") -> Dict[str, Any]:
        """Restore the newest last-good snapshot into the live model. The
        restore revalidates the envelope CRC; the mixer's model version
        rebases to the snapshot's."""
        reason = _text(reason) if reason else "operator"
        entry = self.snapshots.latest()
        if entry is None:
            return {"rolled_back": False,
                    "error": "no model snapshot retained "
                             "(--model-snapshot-interval off?)"}
        with on_driver(self.driver):
            version = self.snapshots.restore(self.driver)
        if self.mixer is not None and hasattr(self.mixer, "model_version"):
            self.mixer.model_version = version
        self.rollbacks += 1
        self.trace.count("mix.rollbacks")
        self.trace.events.emit(
            "mix", "rollback", severity="error", reason=reason,
            model_version=version)
        log.error("model rolled back to snapshot v%d (%s)", version, reason)
        return {"rolled_back": True, "model_version": version,
                "snapshot_ts": entry["ts"], "reason": reason,
                "snapshots": self.snapshots.stats()}

    def _auto_rollback(self) -> None:
        """The mixer's on_poisoned_total callback: put_diff refused a
        non-finite folded total — return to last-good."""
        out = self.rollback(self.args.name, reason="nonfinite_total")
        if not out.get("rolled_back"):
            log.error("auto-rollback unavailable: %s", out.get("error"))

    # -- durable model plane: uploads, warm boot, restore -------------------------
    def _store_node_name(self) -> str:
        return self.self_nodeinfo().name

    def _store_upload_tick(self) -> None:
        """One tick of the background uploader: snapshot → diff against
        the chain's belief → upload (a full record every
        --store-compact-every diffs). Failures are counted by the store
        and never touch the serving path."""
        if self.store_uploader is None:
            return
        now = time.monotonic()
        if self._last_store_upload and \
                now - self._last_store_upload < self.args.store_interval:
            return
        self._last_store_upload = now
        # upload clock: local training progress + mix progress
        version = int(self.driver.update_count)
        if self.mixer is not None:
            version += int(getattr(self.mixer, "model_version", 0) or 0)
        if version == 0 and not self.last_loaded:
            return  # pristine model: nothing worth a store record yet
        try:
            self.store_uploader.tick(self.driver, version)
        except Exception:  # broad-ok — a flaky store must not kill the tick
            log.warning("store upload failed", exc_info=True)

    def _warm_boot(self) -> None:
        """The warm-boot ladder (before the ring sees this node): load the
        freshest store snapshot + diff chain into the driver under its
        lock and rebase the mixer's model version to the chain head; the
        mix plane catches the tail up. ANY failure degrades to a cold
        boot, never a partial model (counted + evented)."""
        t0 = time.monotonic()
        self.trace.count("warmboot.attempts")
        outcome = "cold"
        meta: Dict[str, Any] = {}
        try:
            got = self.store.latest()
            if got is None:
                if self.store.records(kind="full"):
                    # records exist but NONE materialized (corrupt/flaky
                    # store): a degrade, not a clean cold boot
                    raise SaveLoadError(
                        "store records present but none materializable")
                self.trace.count("warmboot.no_snapshot")
            else:
                blob, meta = got
                with on_driver(self.driver):
                    load_model_bytes(blob, self.driver,
                                     where=f"store:{meta['key']}",
                                     expected_config=self.config_json)
                if self.mixer is not None and \
                        hasattr(self.mixer, "model_version"):
                    self.mixer.model_version = int(meta["model_version"])
                self.last_loaded = time.time()  # wall-clock
                outcome = "warm"
                self.trace.count("warmboot.warm")
        except Exception as e:  # broad-ok — ANY failure degrades to cold
            outcome = "degraded_to_cold"
            self.trace.count("warmboot.degraded_to_cold")
            self.trace.events.emit(
                "warmboot", "degraded_to_cold", severity="warning",
                error=str(e)[:200])
            log.warning("warm boot degraded to cold: %s", e)
        seconds = round(time.monotonic() - t0, 3)
        self.trace.gauge("warmboot.seconds", seconds)
        self.warmboot = {
            "outcome": outcome, "seconds": seconds,
            "model_version": int(meta.get("model_version", 0)),
            "chain_len": int(meta.get("chain_len", 0)),
            "hlc": int(meta.get("hlc", 0)),
        }
        if outcome == "warm":
            self.trace.events.emit(
                "warmboot", "loaded", model_version=meta["model_version"],
                chain_len=meta["chain_len"], seconds=seconds)
            log.info("warm boot: model v%d (+%d diffs) in %.3fs",
                     meta["model_version"], meta["chain_len"], seconds)

    def store_restore(self, _name: str = "", at: int = 0) -> Dict[str, Any]:
        """Point-in-time restore from the store: load the freshest
        snapshot at/before ``at`` (HLC; 0 = latest) as this node's model,
        then — for row-holding drivers — union in the rows THIS node owns
        under the CURRENT ring from every other uploading node's snapshot
        (an N-shard fleet's snapshot restores onto an M-shard fleet)."""
        if self.store is None:
            return {"restored": False, "error": "no --store-dir configured"}
        hlc_at = int(at or 0) or None
        t0 = time.monotonic()
        got = self.store.latest(at=hlc_at)
        if got is None:
            return {"restored": False,
                    "error": "no store snapshot"
                             + (f" at hlc<={hlc_at}" if hlc_at else "")}
        blob, meta = got
        try:
            with on_driver(self.driver):
                load_model_bytes(blob, self.driver,
                                 where=f"store:{meta['key']}",
                                 expected_config=self.config_json)
        except SaveLoadError as e:
            return {"restored": False, "error": str(e)[:300]}
        if self.mixer is not None and hasattr(self.mixer, "model_version"):
            self.mixer.model_version = int(meta["model_version"])
        rows = self._restore_rows(hlc_at, skip_node=meta["node"])
        self.last_loaded = time.time()  # wall-clock
        self.trace.count("store.restores")
        doc = {"restored": True, "model_version": int(meta["model_version"]),
               "hlc": int(meta["hlc"]), "chain_len": int(meta["chain_len"]),
               "primary_node": meta["node"], "rows_imported": rows,
               "seconds": round(time.monotonic() - t0, 3)}
        self.trace.events.emit("store", "restored", **doc)
        return doc

    def _restore_rows(self, hlc_at: Optional[int], skip_node: str) -> int:
        """Reshard-on-restore: walk every OTHER uploading node's
        materialized snapshot through a scratch driver and put_rows the
        rows this member owns under the current ring (standalone: all of
        them). Row-less drivers import nothing — the primary envelope
        already carried the whole model."""
        if not hasattr(self.driver, "put_rows"):
            return 0
        ring = self.cluster_cht()
        me = self._store_node_name()
        imported = 0
        for node, (blob, _meta) in sorted(
                self.store.materialize_all(at=hlc_at).items()):
            if node == skip_node:
                continue
            try:
                _sys, user_bytes = read_envelope(blob, f"store:{node}")
                _uv, state = unpack_obj(user_bytes)
                scratch = create_driver(self.engine,
                                        json.loads(self.config_json),
                                        device=self.driver.device)
                with device_scope(self.driver.device):
                    scratch.unpack(state)
            except Exception:  # broad-ok — a sick snapshot skips, never aborts
                log.warning("restore: skipping node %s snapshot", node,
                            exc_info=True)
                continue
            if not hasattr(scratch, "row_ids"):
                continue
            if ring is None:
                rows = scratch.get_rows(sorted(scratch.row_ids()))
                with on_driver(self.driver):
                    imported += int(self.driver.put_rows(rows))
                continue
            cursor = ""
            while True:
                doc = serve_range(scratch, ring, me, cursor)
                if doc["rows"]:
                    with on_driver(self.driver):
                        imported += int(self.driver.put_rows(doc["rows"]))
                if doc["done"]:
                    break
                cursor = doc["cursor"]
        return imported

    def get_store_status(self, _name: str = "") -> Dict[str, Any]:
        """The durable plane's view, keyed like get_status: record counts,
        head HLC, this node's warm-boot outcome and the newest records."""
        node = self.self_nodeinfo().name
        if self.store is None:
            return {node: {}}
        doc: Dict[str, Any] = dict(self.store.stats())
        doc["warmboot"] = dict(self.warmboot)
        doc["store_dir"] = self.args.store_dir
        doc["records"] = [
            {"kind": r.kind, "hlc": r.hlc, "version": r.version,
             "node": r.node} for r in self.store.records()[-64:]]
        return {node: doc}

    # -- built-in RPCs (server_base.hpp:41-109) --------------------------------
    def get_config(self, _name: str = "") -> str:
        return self.config_json

    def model_path(self, model_id: str) -> str:
        """<datadir>/<ip>_<port>_<type>_<id>.jubatus (server_base.cpp:41-49)."""
        node = NodeInfo(self.args.eth, self.args.rpc_port)
        return os.path.join(
            self.args.datadir, f"{node.name}_{self.engine}_{model_id}.jubatus")

    def save(self, _name: str, model_id: str) -> Dict[str, str]:
        """Write the model file; the reply maps this node to its path. With
        ``--store-dir`` the same bytes go to the shared store too, and the
        reply carries their store id under ``store:<node>``: ``load`` on
        any member accepts ``store:<key>``."""
        model_id = _text(model_id)
        path = self.model_path(model_id)
        with on_driver(self.driver):
            save_model(path, self.driver, model_id=model_id,
                       config=self.config_json)
        self.last_saved = time.time()  # wall-clock
        node = NodeInfo(self.args.eth, self.args.rpc_port)
        out = {node.name: path}
        if self.store is not None:
            version = getattr(self.mixer, "model_version", 0) \
                if self.mixer is not None else int(self.driver.update_count)
            try:
                with open(path, "rb") as f:
                    blob = f.read()
                out[f"store:{node.name}"] = self.store.put_blob(
                    blob, kind="full", node=node.name,
                    model_version=version)
            except Exception:  # broad-ok — local save stands on its own
                log.warning("save: store upload failed", exc_info=True)
        return out

    def load(self, _name: str, model_id: str) -> bool:
        """Load by model id: the file ``save(model_id)`` wrote, or a store
        id from a save reply (``store:<key>``, fetched and CRC-checked from
        the shared store). When the local file is missing and a store is
        configured, the newest full record saved under this model id."""
        model_id = _text(model_id)
        if model_id.startswith("store:") and self.store is not None:
            key = model_id[len("store:"):]
            blob = self.store.fetch(key)
            with on_driver(self.driver):
                load_model_bytes(blob, self.driver, where=f"store:{key}",
                                 expected_config=self.config_json)
            self.last_loaded = time.time()  # wall-clock
            return True
        try:
            self.load_file(self.model_path(model_id))
        except FileNotFoundError:
            if self.store is None or not self._load_from_store(model_id):
                raise
        return True

    def _load_from_store(self, model_id: str) -> bool:
        """Store fallback for ``load``: scan the newest full records for
        one saved under ``model_id`` (save-uploaded records carry ids,
        the background chain does not)."""
        for rec in reversed(self.store.records(kind="full")[-32:]):
            try:
                blob = self.store.fetch(rec.key)
                system = unpack_obj(read_envelope(blob, rec.key)[0])
                if system.get("id") != model_id:
                    continue
                with on_driver(self.driver):
                    load_model_bytes(blob, self.driver,
                                     where=f"store:{rec.key}",
                                     expected_config=self.config_json)
            except (SaveLoadError, OSError):
                continue  # corrupt/missing record: keep scanning
            self.last_loaded = time.time()  # wall-clock
            log.info("load: %s restored from store record %s",
                     model_id, rec.key)
            return True
        return False

    def load_file(self, path: str) -> None:
        with on_driver(self.driver):
            load_model(path, self.driver, expected_config=self.config_json)
        self.last_loaded = time.time()  # wall-clock

    def do_mix(self, _name: str = "") -> bool:
        if self.mixer is None:
            return False
        return self.mixer.mix_now() is not None

    def get_status(self, _name: str = "") -> Dict[str, Dict[str, Any]]:
        """One map keyed by <ip>_<port>: uptime, flags, driver state, the
        coalescers' stats, the kernels' launch counts in this process, the
        membership epoch, drain state and migration counters
        (``migration.*``), the snapshot ring (``snapshot.*``,
        ``rollback.count``), the store and this node's warm boot
        (``store.*``, ``warmboot.*``), and in a fleet the mixer's state
        (``mixer.*``), the round's spans and counters (``trace.*``) and
        its gauges (``mix.*``); on a sharded model the shard layout
        (``driver.shard.*`` and the ``shard.*`` gauges), on the instance
        engines the IVF tier (``driver.ann.*``, the ``ann.*`` gauges)."""
        st: Dict[str, Any] = {
            "timestamp": int(time.time()),  # wall-clock
            "uptime": int(time.time() - self.start_time),  # wall-clock
            "type": self.engine,
            "name": self.args.name,
            "version": __version__,
            "update_count": self.driver.update_count,
            "last_saved": self.last_saved,
            "last_loaded": self.last_loaded,
            "rpc_port": self.rpc.port or self.args.rpc_port,
        }
        st.update(self.args.flags_status())
        st.update({f"driver.{k}": v for k, v in self.driver.get_status().items()})
        for method, co in self.coalescers.items():
            st.update({f"microbatch.{method}.{k}": v
                       for k, v in co.stats().items()})
        for kern in (sig_scan.hamming, sig_scan.minhash):
            st[f"kernel.sig_scan.{kern.mode}.launches"] = kern.launches
        for kern in sig_scan.GATHERS.values():
            st[f"kernel.sig_scan.{kern.mode}.gather.launches"] = kern.launches
        st["kernel.online_scan.launches"] = online_scan.pa_scan.launches
        for variant, n in online_scan.pa_scan.by_variant.items():
            st[f"kernel.online_scan.{variant}.launches"] = n
        st["cluster.epoch"] = self.membership_epoch()
        st["drain.state"] = self.drain_ctl.state
        st.update({f"migration.{k}": v
                   for k, v in self.migration.snapshot().items()})
        st.update({f"snapshot.{k}": v
                   for k, v in self.snapshots.stats().items()})
        st["rollback.count"] = self.rollbacks
        if self.store is not None:
            st.update(self.store.stats())
            st.update({f"warmboot.{k}": v
                       for k, v in self.warmboot.items()})
        if self.mixer is not None:
            st.update({f"mixer.{k}": v
                       for k, v in self.mixer.get_status().items()})
        reasons = self._degraded_reasons()
        st["health.status"] = "degraded" if reasons else "ok"
        st["health.reasons"] = reasons
        st.update(self.trace.trace_status())
        self._publish_index_gauges()
        st.update(self.trace.gauges())
        if self.mixer is not None:
            node = self.self_nodeinfo().name
        else:
            host = self.args.listen_addr or "127.0.0.1"
            node = f"{host}_{self.rpc.port or self.args.rpc_port}"
        return {node: st}

    def _degraded_reasons(self) -> list:
        """The mix plane's degraded reasons (the JAX server's list, less
        the planes the port has not reached): open mix breakers, a
        quorum-degraded last round, an obsolete model, a destroyed
        collective process group, a drain."""
        reasons: list = []
        m = self.mixer
        if m is not None:
            breakers = getattr(getattr(m, "comm", None), "breakers", None)
            if breakers is not None:
                open_backends = [k for k, b in breakers.snapshot().items()
                                 if b["state"] == "open"]
                if open_backends:
                    reasons.append({"kind": "mix_breaker_open",
                                    "count": len(open_backends),
                                    "backends": sorted(open_backends)})
            if getattr(m, "last_round_degraded", False):
                reasons.append({"kind": "mix_quorum_degraded"})
            if getattr(m, "_obsolete", False):
                reasons.append({"kind": "model_obsolete",
                                "staleness": getattr(m, "self_staleness", 0)})
            if getattr(m, "collective_dead", False):
                reasons.append({"kind": "collective_dead"})
        if self.drain_ctl.state != "active":
            reasons.append({"kind": "draining",
                            "state": self.drain_ctl.state})
        return reasons

    def _publish_index_gauges(self) -> None:
        """The shard-layout gauges (count, live rows, arena bytes, the last
        sharded top-k's merge wall) and the IVF gauges (cells, probe
        width, rescore budget, the shadow-query recall and its deficit,
        which the SLO grammar alarms on since it alarms on high gauges)."""
        shard_stats = getattr(self.driver, "shard_stats", None)
        doc = shard_stats() if shard_stats is not None else {}
        if doc:
            self.trace.gauge("shard.count", float(doc["count"]))
            self.trace.gauge("shard.rows", float(doc.get("rows", 0)))
            self.trace.gauge("shard.bytes_in_use",
                             float(doc.get("bytes_in_use", 0)))
            if doc.get("topk_merge_ms") is not None:
                self.trace.gauge("shard.topk_merge_ms",
                                 float(doc["topk_merge_ms"]))
        ann_stats = getattr(self.driver, "ann_stats", None)
        doc = ann_stats() if ann_stats is not None else {}
        if doc:
            self.trace.gauge("ann.cells", float(doc.get("cells", 0)))
            self.trace.gauge("ann.probed_cells",
                             float(doc.get("probed_cells", 0)))
            self.trace.gauge("ann.rescore_candidates",
                             float(doc.get("rescore_candidates", 0)))
            if doc.get("recall_probe") is not None:
                self.trace.gauge("ann.recall_probe",
                                 float(doc["recall_probe"]))
                self.trace.gauge("ann.recall_probe_deficit",
                                 round(1.0 - float(doc["recall_probe"]), 4))

    # -- lifecycle (server_helper::start, server_helper.hpp:221-262) -----------
    def start(self, port: Optional[int] = None) -> int:
        from jubatus_tpu_torch.server.service import bind_engine

        bind_engine(self.rpc, self)
        if self.mixer is not None:
            self.mixer.register_api(self.rpc)
        # warm boot BEFORE the socket serves and BEFORE membership: a
        # spawning replica loads the freshest store snapshot + chain, then
        # enters the ring warm and catches the tail up through the mix
        if self.store is not None and self.args.store_warmboot \
                and not self.driver.update_count and not self.last_loaded:
            self._warm_boot()
        actual = self.rpc.serve_background(
            self.args.rpc_port if port is None else port,
            nthreads=self.args.thread, host=self.args.bind_host)
        self.args.rpc_port = actual
        self.trace.events.node = NodeInfo(self.args.eth, actual).name
        # the uploader needs the BOUND port for its node name
        if self.store is not None and self.args.store_interval > 0:
            from jubatus_tpu_torch.framework.model_store import StoreUploader

            self.store_uploader = StoreUploader(
                self.store, self._store_node_name(),
                model_id="auto", config=self.config_json,
                compress=self.args.store_compress,
                compact_every=self.args.store_compact_every)
        hooks = []
        if self.args.model_snapshot_interval > 0:
            hooks.append((self.args.model_snapshot_interval,
                          self._model_snapshot_tick))
        if self.store_uploader is not None:
            hooks.append((self.args.store_interval, self._store_upload_tick))
        if hooks:
            period = min(TICK_MAX_SEC, *(sec for sec, _ in hooks))
            threading.Thread(
                target=self._tick_loop, args=(period, [h for _, h in hooks]),
                daemon=True, name="server-tick").start()
        if self.coord is not None and self.mixer is not None:
            self._join_fleet(NodeInfo(self.args.eth, actual))
        return actual

    def _tick_loop(self, period: float, hooks) -> None:
        """The snapshot and upload hooks, once per ``period`` seconds,
        until the server stops."""
        while not self._stopped.wait(period):
            for hook in hooks:
                hook()

    def _join_fleet(self, node: NodeInfo) -> None:
        """Register membership, arm the suicide watcher, start the mix
        loop (server_helper.cpp:91-109) and the join-time row pull."""
        # ephemeral-port binds (start(0)) resolve only now
        self.mixer.self_node = node
        self.mixer.flight.node = node.name
        engine, name = self.engine, self.args.name
        path = membership.register_actor(self.coord, engine, name,
                                         node.host, node.port)
        membership.register_active(self.coord, engine, name,
                                   node.host, node.port)

        # put_diff outcome drives my own actives entry (through MY
        # coordinator session, so it dies with me, not with the master)
        def on_active(ok: bool) -> None:
            if ok:
                membership.register_active(self.coord, engine, name,
                                           node.host, node.port)
            else:
                membership.unregister_active(self.coord, engine, name,
                                             node.host, node.port)

        self.mixer.on_active = on_active
        self.coord.watch_delete(path, lambda _p: self.stop())
        # keyword partitioning: burst processes only its CHT(2)-assigned
        # keywords, re-hashed on membership change (burst_serv.cpp:225-290)
        if hasattr(self.driver, "set_assignment"):
            self._install_assignment(node)
        self.mixer.start()
        # a joining replica streams its owned ranges from the current
        # owners in the background (drivers with the row hooks only)
        if self.args.auto_rebalance and hasattr(self.driver, "put_rows"):
            self.join_thread = threading.Thread(
                target=self._join_migration, daemon=True, name="join-migrate")
            self.join_thread.start()

    def _install_assignment(self, me: NodeInfo) -> None:
        """Wire CHT keyword assignment into the driver and keep it fresh
        across membership changes. The predicate snapshots the ring at
        (re)build time; each change swaps in a new snapshot."""
        from jubatus_tpu_torch.coord.cht import CHT

        def rebuild(_path: str = "") -> None:
            try:
                cht = CHT.from_coordinator(
                    self.coord, self.engine, self.args.name,
                    actives_only=False)
            except Exception:  # broad-ok — transient coord trouble
                log.warning("assignment rebuild failed; keeping previous",
                            exc_info=True)
                return
            if not cht.members:
                return

            def assigned(kw: str, _cht=cht, _me=me.name) -> bool:
                return any(n.name == _me for n in _cht.find(kw, 2))

            self.driver.set_assignment(assigned)

        rebuild()
        self.coord.watch_children(
            membership.actor_path(self.engine, self.args.name) + "/nodes",
            rebuild)

    def stop(self) -> None:
        # reentry-safe: the suicide watcher and a signal can both call
        # stop() from different threads
        if not self._stop_once.acquire(blocking=False):
            return
        try:
            for step in (
                    (self.mixer.stop if self.mixer is not None else None),
                    (self.coord.close if self.coord is not None else None),
                    self.rpc.stop,
                    self._close_peers):
                if step is None:
                    continue
                try:
                    step()
                except Exception:  # broad-ok — teardown must finish
                    log.exception("shutdown step %r failed", step)
        finally:
            self._stopped.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        return self._stopped.wait(timeout)


def _text(x: Any) -> str:
    return x.decode() if isinstance(x, bytes) else str(x)
