"""EngineServer — a lean standalone server (counterpart of
``jubatus_tpu/server/base.py``).

Owns one driver on an explicit device and the RPC server, and answers the
engine's IDL methods plus get_config / get_status. No coordinator, no
mixer, no mesh, no observability planes yet.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional

from jubatus_tpu_torch import __version__
from jubatus_tpu_torch.ops import online_scan, sig_scan
from jubatus_tpu_torch.rpc.server import RpcServer
from jubatus_tpu_torch.server.args import ServerArgs
from jubatus_tpu_torch.server.factory import create_driver


class EngineServer:
    def __init__(self, engine: str, config: Any,
                 args: Optional[ServerArgs] = None, device=None) -> None:
        self.engine = engine
        self.args = args or ServerArgs(engine=engine)
        if isinstance(config, dict):
            config = json.dumps(config)
        self.config_json: str = config
        self.driver = create_driver(
            engine, json.loads(config),
            device=device if device is not None else self.args.device)
        self.start_time = time.time()  # wall-clock
        self.rpc = RpcServer()
        #: method -> its microbatch coalescer (server/service.py)
        self.coalescers: Dict[str, Any] = {}
        self._stopped = threading.Event()

    @classmethod
    def from_args(cls, args: ServerArgs) -> "EngineServer":
        with open(args.configpath) as f:
            config = f.read()
        return cls(args.engine, config, args)

    # -- built-in RPCs ---------------------------------------------------------
    def get_config(self, _name: str = "") -> str:
        return self.config_json

    def get_status(self, _name: str = "") -> Dict[str, Dict[str, Any]]:
        """One map keyed by <ip>_<port>: uptime, flags, driver state, the
        coalescers' stats and the kernels' launch counts in this process."""
        st: Dict[str, Any] = {
            "timestamp": int(time.time()),  # wall-clock
            "uptime": int(time.time() - self.start_time),  # wall-clock
            "type": self.engine,
            "name": self.args.name,
            "version": __version__,
            "update_count": self.driver.update_count,
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
        host = self.args.listen_addr or "127.0.0.1"
        return {f"{host}_{self.rpc.port or self.args.rpc_port}": st}

    # -- lifecycle ---------------------------------------------------------------
    def start(self, port: Optional[int] = None) -> int:
        from jubatus_tpu_torch.server.service import bind_engine

        bind_engine(self.rpc, self)
        return self.rpc.serve_background(
            self.args.rpc_port if port is None else port,
            nthreads=self.args.thread,
            host=self.args.listen_addr or "0.0.0.0")

    def stop(self) -> None:
        self.rpc.stop()
        self._stopped.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        return self._stopped.wait(timeout)
