"""EngineServer (lean counterpart of ``jubatus_tpu/server/base.py``).

Owns one driver on an explicit device and the RPC server, and answers the
engine's IDL methods plus the built-ins get_config, get_status, save, load
and do_mix. Models are saved in the JAX package's file format
(framework/save_load.py) under ``<datadir>/<ip>_<port>_<type>_<id>.jubatus``,
so a file saved by either package's server loads in the other's; ``-m``
loads one at start.

Given a coordinator (``-z``), the server registers its membership, mixes
with its fleet through the RPC linear mixer (framework/linear_mixer.py),
which serves the ``mix_*`` RPCs, mints anomaly's and graph's ids through
the coordinator, and keeps burst's keyword assignment on the CHT of the
booted members. The fleet may hold JAX servers too: the coordinator
layout, the mix wire and the model files are the JAX package's. Not
carried over: ``store:`` model ids (the model store), the snapshot ring
and rollback, the CHT replication of anomaly ``add`` and graph
``create_node`` (both apply locally), the push, async and collective
mixers, and the observability planes.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

from jubatus_tpu_torch import NotYetPorted, __version__, device_scope
from jubatus_tpu_torch.coord import Coordinator, create_coordinator, membership
from jubatus_tpu_torch.coord.base import NodeInfo
from jubatus_tpu_torch.coord.idgen import IdGenerator
from jubatus_tpu_torch.framework.linear_mixer import (RpcLinearCommunication,
                                                      RpcLinearMixer)
from jubatus_tpu_torch.framework.model_guard import MixGuard
from jubatus_tpu_torch.framework.save_load import load_model, save_model
from jubatus_tpu_torch.ops import online_scan, sig_scan
from jubatus_tpu_torch.rpc.server import RpcServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.server.factory import create_driver
from jubatus_tpu_torch.utils.tracing import Registry

log = logging.getLogger(__name__)


class EngineServer:
    def __init__(self, engine: str, config: Any,
                 args: Optional[ServerArgs] = None, device=None,
                 coord: Optional[Coordinator] = None) -> None:
        self.engine = engine
        self.args = args or ServerArgs(engine=engine)
        self.args.check_ported()
        if isinstance(config, dict):
            config = json.dumps(config)
        self.config_json: str = config
        self.driver = create_driver(
            engine, json.loads(config),
            device=device if device is not None else self.args.device)
        self.start_time = time.time()  # wall-clock
        self.last_saved = 0.0
        self.last_loaded = 0.0
        self.rpc = RpcServer()
        #: this server's metrics (mix spans, counters, gauges, events)
        self.trace = Registry()
        #: method -> its microbatch coalescer (server/service.py)
        self.coalescers: Dict[str, Any] = {}
        self._stopped = threading.Event()
        self._stop_once = threading.Lock()  # first stop() wins; rest no-op

        # distributed wiring (server_helper ctor path, server_helper.cpp:48-78)
        self.coord = coord
        self.mixer: Optional[RpcLinearMixer] = None
        if not self.args.is_standalone or coord is not None:
            if self.coord is None:
                self.coord = create_coordinator(self.args.coordinator)
            comm = RpcLinearCommunication(
                self.coord, engine, self.args.name,
                timeout=self.args.interconnect_timeout)
            self.mixer = RpcLinearMixer(
                self.driver, comm,
                self_node=NodeInfo(self.args.eth, self.args.rpc_port),
                interval_sec=self.args.interval_sec,
                interval_count=self.args.interval_count,
                quorum_fraction=self.args.mix_quorum,
                guard=MixGuard(mode=self.args.mix_guard,
                               norm_bound=self.args.mix_norm_bound))
            self.mixer.set_trace_registry(self.trace)
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

    # -- built-in RPCs (server_base.hpp:41-109) --------------------------------
    def get_config(self, _name: str = "") -> str:
        return self.config_json

    def model_path(self, model_id: str) -> str:
        """<datadir>/<ip>_<port>_<type>_<id>.jubatus (server_base.cpp:41-49)."""
        node = NodeInfo(self.args.eth, self.args.rpc_port)
        return os.path.join(
            self.args.datadir, f"{node.name}_{self.engine}_{model_id}.jubatus")

    def save(self, _name: str, model_id: str) -> Dict[str, str]:
        """Write the model file; the reply maps this node to its path."""
        model_id = _text(model_id)
        path = self.model_path(model_id)
        with device_scope(self.driver.device), self.driver.lock:
            save_model(path, self.driver, model_id=model_id,
                       config=self.config_json)
        self.last_saved = time.time()  # wall-clock
        return {NodeInfo(self.args.eth, self.args.rpc_port).name: path}

    def load(self, _name: str, model_id: str) -> bool:
        """Load the model file that ``save(model_id)`` wrote."""
        model_id = _text(model_id)
        if model_id.startswith("store:"):
            raise NotYetPorted(
                f"load {model_id!r}: store ids need the model store, which "
                "is not yet ported")
        self.load_file(self.model_path(model_id))
        return True

    def load_file(self, path: str) -> None:
        with device_scope(self.driver.device), self.driver.lock:
            load_model(path, self.driver, expected_config=self.config_json)
        self.last_loaded = time.time()  # wall-clock

    def do_mix(self, _name: str = "") -> bool:
        if self.mixer is None:
            return False
        return self.mixer.mix_now() is not None

    def get_status(self, _name: str = "") -> Dict[str, Dict[str, Any]]:
        """One map keyed by <ip>_<port>: uptime, flags, driver state, the
        coalescers' stats, the kernels' launch counts in this process, and
        in a fleet the mixer's state (``mixer.*``), the round's spans and
        counters (``trace.*``) and its gauges (``mix.*``)."""
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
        st["kernel.online_scan.launches"] = online_scan.pa_scan.launches
        for variant, n in online_scan.pa_scan.by_variant.items():
            st[f"kernel.online_scan.{variant}.launches"] = n
        if self.mixer is not None:
            st.update({f"mixer.{k}": v
                       for k, v in self.mixer.get_status().items()})
            st.update(self.trace.trace_status())
            st.update(self.trace.gauges())
            node = self.self_nodeinfo().name
        else:
            host = self.args.listen_addr or "127.0.0.1"
            node = f"{host}_{self.rpc.port or self.args.rpc_port}"
        return {node: st}

    # -- lifecycle (server_helper::start, server_helper.hpp:221-262) -----------
    def start(self, port: Optional[int] = None) -> int:
        from jubatus_tpu_torch.server.service import bind_engine

        bind_engine(self.rpc, self)
        if self.mixer is not None:
            self.mixer.register_api(self.rpc)
        actual = self.rpc.serve_background(
            self.args.rpc_port if port is None else port,
            nthreads=self.args.thread, host=self.args.bind_host)
        self.args.rpc_port = actual
        if self.coord is not None and self.mixer is not None:
            self._join_fleet(NodeInfo(self.args.eth, actual))
        return actual

    def _join_fleet(self, node: NodeInfo) -> None:
        """Register membership, arm the suicide watcher and start the mix
        loop (server_helper.cpp:91-109)."""
        # ephemeral-port binds (start(0)) resolve only now
        self.mixer.self_node = node
        self.mixer.flight.node = node.name
        self.trace.events.node = node.name
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
                    self.rpc.stop):
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
