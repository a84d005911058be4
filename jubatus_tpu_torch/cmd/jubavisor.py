"""Per-host process supervisor daemon (copy of
``jubatus_tpu/cmd/jubavisor.py``; ≙ jubavisor/jubavisor.{hpp,cpp}).

    python -m jubatus_tpu_torch.cmd.jubavisor -z tcp://host:2199 [-p 9198]
        [-m MAX] [-l LOGFILE] [-b HOST] [--device cpu]
        [--server-flags "--profile-hz 0 ..."]

An RPC-controlled process manager: ``jubactl -c start`` asks every
registered jubavisor to spawn N engine servers; ``stop`` kills them.

RPC surface (jubavisor.hpp:36-86, wire names identical, so either
package's jubactl drives it):
- ``start(name, N, argv) -> int``   name = "<server>/<cluster>"
  (e.g. "jubaclassifier/mycluster" — the reference passes the executable
  name; plain engine names work too), argv = flag map forwarded to each
  spawned server. 0 on success.
- ``stop(name, N) -> int``          kills all children of that name
  (the reference ignores N and stops all, jubavisor.hpp:47-49).

Children are ``python -m jubatus_tpu_torch.server <engine> ...``
subprocesses on ``--device`` (cuda unless cpu is asked for), given ports
from a pool [port+1, port+max] (jubavisor.cpp port_pool_); a reaper thread
collects exits and recycles ports (≙ SIGCHLD handler); ``stop_all`` runs
at exit (atexit_ kill-all). Registers ephemerally under
/jubatus/supervisors so jubactl can find it (membership.cpp). Of the argv
map, the keys of the server flags are forwarded (``_FLAG_MAP``, the JAX
package's, ``timeout`` and ``logdir`` included). ``--server-flags`` (port only) appends the same extra server flags to
every child's command line, for the flags no jubactl argv key carries
(the forensics plane's ``--profile-hz``, ``--telemetry-interval``, ...).
"""

from __future__ import annotations

import argparse
import logging
import shlex
import signal
import subprocess
import sys
import threading
from typing import Any, Dict, List, Optional

from jubatus_tpu_torch.cmd import resolve_coordinator
from jubatus_tpu_torch.coord import create_coordinator, membership
from jubatus_tpu_torch.framework.idl import ENGINES
from jubatus_tpu_torch.rpc.server import RpcServer

log = logging.getLogger(__name__)

#: jubactl argv-map keys → the port server's CLI flags
_FLAG_MAP = {
    "listen_if": "--listen-addr",
    "thread": "--thread",
    "timeout": "--timeout",
    "datadir": "--datadir",
    "logdir": "--logdir",
    "mixer": "--mixer",
    "interval_sec": "--interval-sec",
    "interval_count": "--interval-count",
    "zookeeper_timeout": "--coordinator-timeout",
    "interconnect_timeout": "--interconnect-timeout",
}


def parse_engine(name: str) -> str:
    """"jubaclassifier/c1" | "classifier/c1" → engine name."""
    server = name.split("/", 1)[0]
    engine = server[4:] if server.startswith("juba") else server
    if engine not in ENGINES:
        raise ValueError(f"unknown engine in {name!r}")
    return engine


class _Child:
    __slots__ = ("proc", "port", "name")

    def __init__(self, proc: subprocess.Popen, port: int, name: str) -> None:
        self.proc = proc
        self.port = port
        self.name = name


class Jubavisor:
    def __init__(self, coordinator: str, port: int = 9198, max_children: int = 10,
                 logfile: str = "", host: str = "127.0.0.1",
                 device: str = "cuda",
                 server_flags: Optional[List[str]] = None) -> None:
        self.coordinator = coordinator
        self.host = host
        self.port = port
        self.logfile = logfile
        self.device = device
        self.server_flags = list(server_flags or ())
        self.coord = create_coordinator(coordinator)
        self.rpc = RpcServer()
        self.rpc.register("start", self.start_procs, arity=3)
        self.rpc.register("stop", self.stop_procs, arity=2)
        self._mu = threading.Lock()
        self.max_children = max_children
        self._pool: List[int] = []  # filled in start() once the port is known
        self._children: Dict[str, List[_Child]] = {}
        self._stop_event = threading.Event()
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True,
                                        name="visor-reaper")

    # -- RPC: start (jubavisor.cpp start_) -----------------------------------
    def start_procs(self, name: str, n: int, argv: Optional[Dict[str, Any]]) -> int:
        try:
            engine = parse_engine(name)
        except ValueError as e:
            log.error("%s", e)
            return -1
        cluster = name.split("/", 1)[1] if "/" in name else name
        argv = argv or {}
        with self._mu:
            for _ in range(int(n)):
                if not self._pool:
                    log.error("port pool exhausted (max children reached)")
                    return -1
                port = self._pool.pop(0)
                cmd = [sys.executable, "-m", "jubatus_tpu_torch.server", engine,
                       "-z", self.coordinator, "-n", cluster, "-p", str(port),
                       "--device", self.device]
                for key, flag in _FLAG_MAP.items():
                    if key in argv and argv[key] not in ("", None):
                        cmd += [flag, str(argv[key])]
                cmd += self.server_flags
                out = (open(self.logfile, "ab") if self.logfile
                       else subprocess.DEVNULL)
                try:
                    proc = subprocess.Popen(cmd, stdout=out, stderr=out)
                except OSError as e:
                    log.error("spawn failed: %s", e)
                    self._pool.insert(0, port)
                    return -1
                finally:
                    if out is not subprocess.DEVNULL:
                        out.close()
                self._children.setdefault(name, []).append(
                    _Child(proc, port, name))
                log.info("started %s on port %d (pid %d)", name, port, proc.pid)
        return 0

    # -- RPC: stop (reference stops ALL processes of the name) ---------------
    def stop_procs(self, name: str, _n: int = 0) -> int:
        with self._mu:
            children = self._children.pop(name, [])
        for c in children:
            self._kill(c)
        log.info("stopped %d process(es) of %s", len(children), name)
        return 0

    def stop_all(self) -> None:
        with self._mu:
            everything = [c for lst in self._children.values() for c in lst]
            self._children.clear()
        for c in everything:
            self._kill(c)

    def _kill(self, child: _Child) -> None:
        try:
            child.proc.terminate()
            try:
                child.proc.wait(timeout=5.0)
            except subprocess.TimeoutExpired:
                child.proc.kill()
                child.proc.wait(timeout=5.0)
        except OSError:
            pass
        with self._mu:
            self._pool.append(child.port)

    def _reap_loop(self) -> None:
        """Collect dead children, recycle their ports (≙ SIGCHLD reaping)."""
        while not self._stop_event.wait(1.0):
            with self._mu:
                for name, lst in list(self._children.items()):
                    for c in list(lst):
                        if c.proc.poll() is not None:
                            lst.remove(c)
                            self._pool.append(c.port)
                            log.warning("child %s port %d exited with %s",
                                        name, c.port, c.proc.returncode)
                    if not lst:
                        self._children.pop(name, None)

    def status(self) -> Dict[str, List[int]]:
        with self._mu:
            return {name: [c.port for c in lst]
                    for name, lst in self._children.items()}

    # -- lifecycle -----------------------------------------------------------
    def start(self, port: Optional[int] = None) -> int:
        actual = self.rpc.serve_background(
            port if port is not None else self.port, host="0.0.0.0")
        self.port = actual
        # child ports [port+1, port+max] (jubavisor.cpp port_pool_)
        self._pool = list(range(actual + 1, actual + 1 + self.max_children))
        membership.register_supervisor(self.coord, self.host, actual)
        self._reaper.start()
        log.info("jubavisor listening on %d", actual)
        return actual

    def join(self, timeout: Optional[float] = None) -> bool:
        return self._stop_event.wait(timeout)

    def stop(self) -> None:
        self._stop_event.set()
        self.stop_all()
        self.rpc.stop()
        self.coord.close()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="jubavisor")
    p.add_argument("-p", "--rpc-port", type=int, default=9198)
    p.add_argument("-z", "--coordinator", default="")
    p.add_argument("-m", "--max", type=int, default=10,
                   help="max children (= port pool size)")
    p.add_argument("-l", "--logfile", default="",
                   help="redirect child output here")
    p.add_argument("-b", "--host", default="127.0.0.1",
                   help="address to register in the supervisor registry")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device of every child server (its --device); "
                        "cuda unless cpu is asked for")
    p.add_argument("--server-flags", default="",
                   help="extra flags appended to every child server's "
                        "command line, one shell-quoted string")
    ns = p.parse_args(argv)
    spec = resolve_coordinator(ns.coordinator)
    if not spec:
        print("no coordinator: pass -z or set JUBATUS_COORDINATOR/ZK",
              file=sys.stderr)
        return 1
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s [jubavisor] %(message)s")
    visor = Jubavisor(spec, ns.rpc_port, ns.max, ns.logfile, host=ns.host,
                      device=ns.device,
                      server_flags=shlex.split(ns.server_flags))
    signal.signal(signal.SIGTERM, lambda *_: visor.stop())
    signal.signal(signal.SIGINT, lambda *_: visor.stop())
    port = visor.start()
    print(f"jubavisor serving on port {port}", flush=True)
    visor.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
