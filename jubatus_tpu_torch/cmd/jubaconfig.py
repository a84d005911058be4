"""Config management CLI (copy of ``jubatus_tpu/cmd/jubaconfig.py``;
≙ cmd/jubaconfig.cpp:79-137).

    jubaconfig -c write  -t classifier -n mycluster -f conf.json -z tcp://host:2199
    jubaconfig -c read   -t classifier -n mycluster -z tcp://host:2199
    jubaconfig -c delete -t classifier -n mycluster -z tcp://host:2199
    jubaconfig -c list   -z tcp://host:2199

``write`` validates the file is JSON, that the engine type is known, and
that the port's driver accepts it (dry-constructed on ``--device``, cuda
unless cpu is asked for, like the servers' ``--config-test``) before
storing it at /jubatus/config/<type>/<name>, the JAX package's path, so
servers of either package read it.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from jubatus_tpu_torch.cmd import resolve_coordinator
from jubatus_tpu_torch.coord import create_coordinator, membership
from jubatus_tpu_torch.framework.idl import ENGINES


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="jubaconfig")
    p.add_argument("-c", "--cmd", required=True,
                   choices=["write", "read", "delete", "list"])
    p.add_argument("-f", "--file", default="", help="[write] config file")
    p.add_argument("-t", "--type", default="", help="engine type")
    p.add_argument("-n", "--name", default="", help="cluster name")
    p.add_argument("-z", "--coordinator", default="",
                   help="coordination store ($JUBATUS_COORDINATOR or $ZK)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="[write] device the config's driver is "
                        "dry-constructed on; cuda unless cpu is asked for")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    ns = _parser().parse_args(argv)
    spec = resolve_coordinator(ns.coordinator)
    if not spec:
        print("no coordinator: pass -z or set JUBATUS_COORDINATOR/ZK",
              file=sys.stderr)
        return 1
    coord = create_coordinator(spec)
    try:
        if ns.cmd in ("write", "read", "delete"):
            if not ns.type or not ns.name:
                print(f"can't execute {ns.cmd} without -t and -n", file=sys.stderr)
                return 1
            path = membership.config_path(ns.type, ns.name)
            if ns.cmd == "write":
                if not ns.file:
                    print("write requires -f <config.json>", file=sys.stderr)
                    return 1
                with open(ns.file) as f:
                    raw = f.read()
                try:
                    parsed = json.loads(raw)
                except json.JSONDecodeError as e:
                    print(f"invalid JSON in {ns.file}: {e}", file=sys.stderr)
                    return 1
                if ns.type not in ENGINES:
                    print(f"unknown engine type {ns.type!r} "
                          f"(known: {', '.join(ENGINES)})", file=sys.stderr)
                    return 1
                # full semantic validation: dry-construct the driver, like
                # the servers' --config-test (the reference validates via
                # jsonconfig before writing, jubaconfig.cpp validate_config)
                from jubatus_tpu_torch.server.factory import create_driver

                try:
                    create_driver(ns.type, parsed, device=ns.device)
                except Exception as e:  # broad-ok — report any reason
                    print(f"config rejected by {ns.type} driver: {e}",
                          file=sys.stderr)
                    return 1
                if not coord.create(path, raw.encode()):
                    coord.set(path, raw.encode())
                print(f"wrote config for {ns.type}/{ns.name}")
            elif ns.cmd == "read":
                raw = coord.read(path)
                if raw is None:
                    print(f"no config for {ns.type}/{ns.name}", file=sys.stderr)
                    return 1
                print(raw.decode())
            else:  # delete
                if coord.remove(path):
                    print(f"deleted config for {ns.type}/{ns.name}")
                else:
                    print(f"no config for {ns.type}/{ns.name}", file=sys.stderr)
                    return 1
        else:  # list: walk /jubatus/config/<type>/<name>
            for etype in coord.list(membership.CONFIG_BASE):
                for name in coord.list(f"{membership.CONFIG_BASE}/{etype}"):
                    print(f"{etype}/{name}")
        return 0
    finally:
        coord.close()


if __name__ == "__main__":
    sys.exit(main())
