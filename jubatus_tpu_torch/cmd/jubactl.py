"""Cluster control CLI (trimmed copy of ``jubatus_tpu/cmd/jubactl.py``;
≙ cmd/jubactl.cpp).

    jubactl -c start  -t classifier -s jubaclassifier -n c1 -N 4 -z tcp://host:2199
    jubactl -c stop   -t classifier -s jubaclassifier -n c1 -z tcp://host:2199
    jubactl -c save   -t classifier -n c1 -z tcp://host:2199 [-i model_id]
    jubactl -c load   -t classifier -n c1 -z tcp://host:2199 [-i model_id]
    jubactl -c status -t classifier -n c1 -z tcp://host:2199 [--all]
    jubactl -c breakers -t classifier -n c1 -z tcp://host:2199
    jubactl -c drain  -t nearest_neighbor -n c1 --target IP_PORT [--stop]
    jubactl -c rebalance | rollback [--target IP_PORT] | restore [--at HLC]
    jubactl -c watch  -t classifier -n c1 -z tcp://host:2199 [--once]

start/stop fan out to every jubavisor under /jubatus/supervisors,
distributing N processes round-robin (N/visors each, remainder to the
first ones; N=0 → one per visor — jubactl.cpp:133-142,240-260). save/load
RPC every registered server of the cluster (send2server). status prints
the nodes/actives registries with the membership epoch and the draining
members; ``--all`` additionally scrapes every member's get_status map.
``breakers`` scrapes every registered proxy's per-backend circuit breaker
and retry-budget state. ``drain`` drives one member through the drain
state machine and waits for ``drained``; ``rebalance`` asks every member
to pull the rows it owns under the current ring; ``rollback`` restores
the last-good snapshot on one member (``--target``) or all; ``restore``
is the point-in-time restore from the shared model store. ``watch``
renders the cluster frame from every member's ``get_status`` (requests,
errors and the worst p99 of the ``rpc.*`` spans since the member
started, drain state, mix health) and every proxy's
``get_proxy_status``. Server flags (-B/-C/-D/-X/-S/-I/-Z/-R) are forwarded
to visor-spawned processes (jubactl.cpp:90-110). The commands whose
server side the port has not yet (``metrics``, ``trace``, ``alerts``,
``profile``, ``quality``, ``usage``, ``tune``, ``timeline``: ROADMAP A20;
``autoscale``: A21; ``incident``: A22) exit 1 with "not yet ported"; so
does ``watch`` without ``--once``, whose windowed rates need the time
series (A20).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional

from jubatus_tpu_torch.cmd import resolve_coordinator
from jubatus_tpu_torch.coord import create_coordinator, membership
from jubatus_tpu_torch.coord.base import Coordinator, NodeInfo
from jubatus_tpu_torch.rpc.client import RpcClient

#: the JAX jubactl's commands whose server side the port has not yet, with
#: the ROADMAP item that ports it
NOT_YET_PORTED = {
    "metrics": "A20", "trace": "A20", "alerts": "A20", "profile": "A20",
    "quality": "A20", "usage": "A20", "tune": "A20", "timeline": "A20",
    "autoscale": "A21", "incident": "A22",
}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="jubactl")
    p.add_argument("-c", "--cmd", required=True,
                   choices=["start", "stop", "save", "load", "status",
                            "breakers", "watch", "drain", "rebalance",
                            "rollback", "restore", *NOT_YET_PORTED])
    p.add_argument("--all", action="store_true",
                   help="[status] also scrape every member's get_status")
    p.add_argument("--once", action="store_true",
                   help="[watch] render one frame and exit (scripts/CI)")
    p.add_argument("--target", default="",
                   help="[drain|rollback|restore] the member to act on, "
                        "as IP_PORT (a node name from -c status); "
                        "rollback/restore without --target act on EVERY "
                        "member (the fleet-wide recovery)")
    p.add_argument("--at", default="latest", metavar="HLC|latest",
                   help="[restore] point in time to restore to: a packed "
                        "HLC (store.head_hlc in -c status) or 'latest' "
                        "(the default). Each member materializes the "
                        "newest snapshot+diff chain at/before that instant "
                        "and re-imports its owned rows under the CURRENT "
                        "hash ring")
    p.add_argument("--stop", action="store_true",
                   help="[drain] also unregister the member's nodes/ "
                        "entry when drained, firing its suicide watcher "
                        "(the process exits); default leaves it running "
                        "drained for inspection")
    p.add_argument("--drain-timeout", type=float, default=120.0,
                   help="[drain] seconds to wait for the drained state")
    p.add_argument("-s", "--server", default="",
                   help="server name forwarded to jubavisor "
                        "(jubaclassifier or plain engine name)")
    p.add_argument("-t", "--type", required=True, help="engine type")
    p.add_argument("-n", "--name", required=True, help="cluster name")
    p.add_argument("-N", "--num", type=int, default=0,
                   help="total processes across the cluster (0 = one per visor)")
    p.add_argument("-z", "--coordinator", default="")
    p.add_argument("-i", "--id", default="", help="[save|load] model id")
    # forwarded server flags (jubactl.cpp:90-110)
    p.add_argument("-B", "--listen-if", dest="listen_if", default="")
    p.add_argument("-C", "--thread", type=int, default=2)
    p.add_argument("-D", "--datadir", default="/tmp")
    p.add_argument("-X", "--mixer", default="linear_mixer")
    p.add_argument("-S", "--interval-sec", dest="interval_sec", type=int, default=16)
    p.add_argument("-I", "--interval-count", dest="interval_count", type=int, default=512)
    p.add_argument("-Z", "--zookeeper-timeout", dest="zookeeper_timeout",
                   type=int, default=10)
    p.add_argument("-R", "--interconnect-timeout", dest="interconnect_timeout",
                   type=int, default=10)
    return p


def _visors(coord: Coordinator) -> List[NodeInfo]:
    out = []
    for child in coord.list(membership.SUPERVISOR_BASE):
        try:
            out.append(NodeInfo.from_name(child))
        except (ValueError, IndexError):
            continue
    return out


def send2supervisor(coord: Coordinator, cmd: str, engine: str, name: str,
                    num: int, argv: Dict[str, Any]) -> int:
    """Distribute start/stop over all visors (jubactl.cpp:240-280)."""
    visors = _visors(coord)
    if not visors:
        print(f"no supervisor to {cmd} {name}", file=sys.stderr)
        return -1
    total = num if num > 0 else len(visors)
    per, extra = divmod(total, len(visors))
    rc = 0
    for i, visor in enumerate(visors):
        n = per + (1 if i < extra else 0)
        if n == 0 and cmd == "start":
            continue
        print(f"sending {cmd} / {name} to {visor.name}...", end="", flush=True)
        with RpcClient(visor.host, visor.port, timeout=10.0) as c:
            if cmd == "start":
                r = c.call("start", name, n, argv)
            else:
                r = c.call("stop", name, n)
        print("ok." if r == 0 else "failed.")
        rc = rc or r
    return rc


def send2server(coord: Coordinator, cmd: str, engine: str, name: str,
                model_id: str) -> int:
    """save/load on every registered server of the cluster (send2server)."""
    nodes = membership.get_all_nodes(coord, engine, name)
    if not nodes:
        print(f"no server of {engine}/{name}", file=sys.stderr)
        return -1
    rc = 0
    for node in nodes:
        print(f"sending {cmd} / {name} to {node.name}...", end="", flush=True)
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                r = c.call(cmd, name, model_id)
            ok = bool(r)
        except Exception as e:  # noqa: BLE001 — report per-host, keep going
            print(f"failed. ({e})")
            rc = -1
            continue
        print("ok." if ok else "failed.")
        rc = rc if ok else -1
    return rc


def show_status(coord: Coordinator, engine: str, name: str,
                show_all: bool = False) -> int:
    nodes = membership.get_all_nodes(coord, engine, name)
    actives = {n.name for n in membership.get_all_actives(coord, engine, name)}
    draining = {n.name for n in membership.get_draining(coord, engine, name)}
    epoch = membership.get_epoch(coord, engine, name)
    print(f"{engine}/{name}: {len(nodes)} node(s), {len(actives)} active, "
          f"epoch {epoch}"
          + (f", {len(draining)} draining" if draining else ""))
    rc = 0
    for node in nodes:
        mark = ("draining" if node.name in draining
                else "active" if node.name in actives else "standby")
        print(f"  {node.name}  [{mark}]")
        if not show_all:
            continue
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                status = c.call("get_status", name)
        except Exception as e:  # noqa: BLE001 — report per-host, keep going
            print(f"    <get_status failed: {e}>")
            rc = -1
            continue
        for _node_name, st in sorted(status.items()):
            # model-health verdict first (a JAX member serves it): the
            # structured degraded reasons, rendered as one line
            hs = st.get("health.status")
            if hs:
                reasons = st.get("health.reasons") or []
                kinds = ", ".join(
                    str(r.get("kind", "?")) +
                    (f":{r['name']}" if r.get("name") else "")
                    for r in reasons) if isinstance(reasons, list) else ""
                print(f"    health: {hs}" + (f" [{kinds}]" if kinds else ""))
            guard_line = _fmt_guard(st)
            if guard_line:
                print(f"    {guard_line}")
            shard_line = _fmt_shard_layout(st)
            if shard_line:
                print(f"    {shard_line}")
            for k in sorted(st):
                print(f"    {k}: {st[k]}")
    return rc


def _fmt_guard(st: Dict[str, Any]) -> str:
    """One-line model-integrity summary: guard mode,
    quarantined members, snapshot/rollback state; "" when the guard is
    off and nothing ever rolled back."""
    mode = st.get("mixer.guard_mode")
    rolls = int(st.get("rollback.count", 0) or 0)
    if (not mode or mode == "off") and not rolls:
        return ""
    bits = [f"guard: {mode or 'off'}"]
    q = st.get("mixer.guard_quarantined") or []
    if q:
        names = ", ".join(s.decode() if isinstance(s, bytes) else str(s)
                          for s in q)
        bits.append(f"quarantined [{names}]")
    snaps = st.get("snapshot.count")
    if snaps:
        bits.append(f"snapshots {int(snaps)} "
                    f"(v{st.get('snapshot.last_model_version', '?')})")
    if rolls:
        bits.append(f"rollbacks {rolls}")
    return "  ".join(bits)


def _fmt_shard_layout(st: Dict[str, Any]) -> str:
    """One-line shard-layout summary from the driver.shard.* gauges:
    ``shards: N × rows/bytes per shard``; "" when the model is
    unsharded."""
    count = st.get("driver.shard.count")
    if not count:
        return ""
    count = int(count)
    rows = st.get("driver.shard.rows", 0)
    nbytes = int(st.get("driver.shard.bytes_in_use", 0))
    per = st.get("driver.shard.rows_per_shard")
    if isinstance(per, (list, tuple)) and per:
        rows_bit = "/".join(str(int(r)) for r in per[:8])
        if len(per) > 8:
            rows_bit += "/…"
        rows_bit = f"rows {rows_bit}"
    else:
        rows_bit = f"rows {int(rows)}"
    mb = nbytes / 2 ** 20
    out = (f"shards: {count} × [{rows_bit}, "
           f"{mb / max(count, 1):.1f} MB/shard]")
    merge = st.get("driver.shard.topk_merge_ms")
    if merge is not None:
        out += f" topk_merge {float(merge):.1f} ms"
    return out


def show_breakers(coord: Coordinator, engine: str, name: str) -> int:
    """Per-backend circuit breaker + retry-budget state from every
    registered proxy (the self-healing plane's ops view): which backends
    are open/half-open, how many trips, how full the failover budget is.
    Answers 'why is this backend getting no traffic?' without grepping
    proxy logs."""
    proxies = []
    for child in coord.list(membership.PROXY_BASE):
        try:
            proxies.append(NodeInfo.from_name(child))
        except (ValueError, IndexError):
            continue
    if not proxies:
        print("no proxy registered", file=sys.stderr)
        return -1
    rc = 0
    for proxy in proxies:
        try:
            with RpcClient(proxy.host, proxy.port, timeout=10.0) as c:
                per_node = c.call("get_breakers", name)
        except Exception as e:  # noqa: BLE001 — report per-proxy, keep going
            print(f"  <{proxy.name}: get_breakers failed: {e}>",
                  file=sys.stderr)
            rc = -1
            continue
        for node_name, doc in sorted(per_node.items()):
            breakers = doc.get("breakers") or {}
            budget = doc.get("retry_budget") or {}
            print(f"proxy {node_name}: {len(breakers)} backend(s) tracked")
            if budget:
                print(f"  retry budget: {budget.get('tokens')} tokens "
                      f"(ratio {budget.get('ratio')}, "
                      f"{budget.get('withdrawals', 0)} spent, "
                      f"{budget.get('denials', 0)} denied)")
            for backend in sorted(breakers):
                b = breakers[backend]
                print(f"  {backend:<28} {b.get('state', '?'):>9}  "
                      f"failures_in_window={b.get('failures_in_window', 0)} "
                      f"opened_total={b.get('opened_total', 0)}")
    return rc


def drain_member(coord: Coordinator, engine: str, name: str, target: str,
                 stop_after: bool = False, timeout: float = 120.0) -> int:
    """Elastic membership: drive one member through the drain
    state machine — stop routing new effectful work to it, finish
    in-flight, hand its rows to the new ring owners, unregister — and
    poll until ``drained`` (or the process exits, with ``--stop``)."""
    import time as _time

    if not target:
        print("drain needs --target IP_PORT (a node name from -c status)",
              file=sys.stderr)
        return 1
    try:
        node = NodeInfo.from_name(target)
    except (ValueError, IndexError):
        print(f"bad --target {target!r}: expected IP_PORT", file=sys.stderr)
        return 1
    known = {n.name for n in membership.get_all_nodes(coord, engine, name)}
    if node.name not in known:
        print(f"{node.name} is not a registered member of {engine}/{name}",
              file=sys.stderr)
        return 1
    print(f"draining {node.name} (stop_after={stop_after})...")
    try:
        with RpcClient(node.host, node.port, timeout=10.0) as c:
            st = c.call("drain", name, bool(stop_after))
    except Exception as e:  # noqa: BLE001 — report and fail
        print(f"drain RPC failed: {e}", file=sys.stderr)
        return -1
    deadline = _time.monotonic() + max(timeout, 1.0)
    while _time.monotonic() < deadline:
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                st = c.call("drain_status", name)
        except Exception:  # noqa: BLE001 — with --stop the exit IS success
            if stop_after:
                print("member exited (drained + unregistered)")
                return 0
            raise
        state = st.get("state")
        state = state.decode() if isinstance(state, bytes) else state
        if state == "drained":
            print(f"drained: {st.get('rows_handed_off', 0)} row(s) "
                  f"({st.get('bytes_handed_off', 0)} bytes) handed off, "
                  f"epoch {st.get('epoch')}")
            if st.get("error"):
                print(f"  warning: {st['error']}", file=sys.stderr)
            return 0
        _time.sleep(0.5)
    print(f"drain timed out in state {st!r}", file=sys.stderr)
    return -1


def rollback_member(coord: Coordinator, engine: str, name: str,
                    target: str) -> int:
    """Model-integrity plane: restore one member's last-good
    model snapshot (``rollback`` RPC — the ring the server keeps under
    ``--model-snapshot-interval``). ``--target IP_PORT`` names the node
    (a name from ``-c status``); without it, every registered member
    rolls back (the fleet-wide recovery after a poisoning incident)."""
    nodes = membership.get_all_nodes(coord, engine, name)
    if not nodes:
        print(f"no server of {engine}/{name}", file=sys.stderr)
        return -1
    if target:
        try:
            node = NodeInfo.from_name(target)
        except (ValueError, IndexError):
            print(f"bad --target {target!r}: expected IP_PORT",
                  file=sys.stderr)
            return 1
        if node.name not in {n.name for n in nodes}:
            print(f"{node.name} is not a registered member of "
                  f"{engine}/{name}", file=sys.stderr)
            return 1
        nodes = [node]
    rc = 0
    for node in nodes:
        print(f"rollback {node.name}...", end="", flush=True)
        try:
            with RpcClient(node.host, node.port, timeout=60.0) as c:
                out = c.call("rollback", name, "operator")
        except Exception as e:  # noqa: BLE001 — report per-host
            print(f" failed. ({e})")
            rc = -1
            continue
        if out.get("rolled_back"):
            print(f" ok: model_version {out.get('model_version')} "
                  f"(snapshot age "
                  f"{out.get('snapshots', {}).get('last_age_s', '?')}s)")
        else:
            print(f" refused: {out.get('error')}")
            rc = -1
    return rc


def restore_fleet(coord: Coordinator, engine: str, name: str,
                  target: str, at: str) -> int:
    """Durable model plane: point-in-time restore from the
    shared snapshot store. Every member (or just ``--target``)
    materializes the newest full snapshot + diff chain at/before
    ``--at`` (a packed HLC, or ``latest``) and re-imports the rows it
    owns under the CURRENT ring — restoring an 8-shard save into a
    2-shard fleet (or 1 into 8) resharded-on-the-fly."""
    if at == "latest":
        at_hlc = 0
    else:
        try:
            at_hlc = int(at)
        except ValueError:
            print(f"bad --at {at!r}: expected a packed HLC or 'latest'",
                  file=sys.stderr)
            return 1
    nodes = membership.get_all_nodes(coord, engine, name)
    if not nodes:
        print(f"no server of {engine}/{name}", file=sys.stderr)
        return -1
    if target:
        try:
            node = NodeInfo.from_name(target)
        except (ValueError, IndexError):
            print(f"bad --target {target!r}: expected IP_PORT",
                  file=sys.stderr)
            return 1
        if node.name not in {n.name for n in nodes}:
            print(f"{node.name} is not a registered member of "
                  f"{engine}/{name}", file=sys.stderr)
            return 1
        nodes = [node]
    rc = 0
    for node in nodes:
        print(f"restore {node.name} @ {at}...", end="", flush=True)
        try:
            with RpcClient(node.host, node.port, timeout=600.0) as c:
                out = c.call("store_restore", name, at_hlc)
        except Exception as e:  # noqa: BLE001 — report per-host
            print(f" failed. ({e})")
            rc = -1
            continue
        if out.get("restored"):
            print(f" ok: model_version {out.get('model_version')} "
                  f"hlc {out.get('hlc')} chain {out.get('chain_len')} "
                  f"(+{out.get('rows_imported', 0)} row(s) resharded, "
                  f"{out.get('seconds', 0)}s)")
        else:
            print(f" refused: {out.get('error')}")
            rc = -1
    return rc


def rebalance_cluster(coord: Coordinator, engine: str, name: str) -> int:
    """Ask every member to pull the rows it owns under the CURRENT ring
    (the repair action after churn; safe to re-run — rows apply as
    overwrites)."""
    nodes = membership.get_all_nodes(coord, engine, name)
    if not nodes:
        print(f"no server of {engine}/{name}", file=sys.stderr)
        return -1
    rc = 0
    total_rows = 0
    for node in nodes:
        print(f"rebalance {node.name}...", end="", flush=True)
        try:
            with RpcClient(node.host, node.port, timeout=600.0) as c:
                out = c.call("rebalance", name)
        except Exception as e:  # noqa: BLE001 — report per-host
            print(f" failed. ({e})")
            rc = -1
            continue
        rows = out.get("rows", 0)
        total_rows += rows
        print(f" ok: {rows} row(s), {out.get('mb_per_sec', 0.0)} MB/s"
              + (f" (failed sources: {out.get('sources_failed')})"
                 if out.get("sources_failed") else ""))
    print(f"rebalance complete: {total_rows} row(s) moved, "
          f"epoch {membership.get_epoch(coord, engine, name)}")
    return rc


def _proxies(coord: Coordinator) -> List[NodeInfo]:
    out = []
    for child in coord.list(membership.PROXY_BASE):
        try:
            out.append(NodeInfo.from_name(child))
        except (ValueError, IndexError):
            continue
    return out


def collect_watch(coord: Coordinator, engine: str,
                  name: str) -> Dict[str, Any]:
    """One scrape of the whole cluster for the watch view: per-member
    get_status, per-proxy get_proxy_status. Failures degrade per node (a
    sick node is exactly what the watch exists to show)."""
    nodes = membership.get_all_nodes(coord, engine, name)
    actives = {n.name for n in membership.get_all_actives(
        coord, engine, name)}
    data: Dict[str, Any] = {"engine": engine, "name": name, "nodes": {},
                            "proxies": {}, "actives": actives,
                            "epoch": membership.get_epoch(
                                coord, engine, name),
                            "draining": {n.name for n in
                                         membership.get_draining(
                                             coord, engine, name)}}
    for node in nodes:
        entry: Dict[str, Any] = {"error": ""}
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                status = c.call("get_status", name)
        except Exception as e:  # broad-ok — render the sick node
            entry["error"] = str(e)
            data["nodes"][node.name] = entry
            continue
        entry["status"] = (status or {}).get(node.name) or \
            next(iter((status or {}).values()), {})
        data["nodes"][node.name] = entry
    for pxy in _proxies(coord):
        try:
            with RpcClient(pxy.host, pxy.port, timeout=10.0) as c:
                pst = c.call("get_proxy_status", name)
        except Exception as e:  # broad-ok — render the sick proxy
            data["proxies"][pxy.name] = {"error": str(e)}
            continue
        for node_name, st in (pst or {}).items():
            data["proxies"][node_name] = {"status": st, "error": ""}
    return data


def _rpc_totals(st: Dict[str, Any]):
    """(requests, errors, worst p99 ms, its span) over the ``rpc.*``
    dispatch spans of one get_status map, since the member started."""
    reqs = errs = 0
    p99, p99_span = None, ""
    for key, v in st.items():
        if key.startswith("trace.rpc.") and key.endswith(".count"):
            reqs += int(v)
            span = key[len("trace."):-len(".count")]
            q = st.get(f"trace.{span}.p99_ms")
            if q is not None and (p99 is None or float(q) > p99):
                p99, p99_span = float(q), span
        elif key.startswith("trace.counter.rpc.") and \
                key.endswith(".errors"):
            errs += int(v)
    return reqs, errs, p99, p99_span


def _watch_node_row(node_name: str, entry: Dict[str, Any],
                    active: bool, draining: bool = False) -> str:
    if entry.get("error"):
        return (f"  {node_name:<22} {'DOWN':<9} "
                f"<{entry['error'][:60]}>")
    st = entry.get("status") or {}
    reqs, errs, p99, p99_span = _rpc_totals(st)
    health = st.get("health.status", "up")
    state = (f"{health}/drain" if draining
             else health if active else f"{health}/standby")
    mix_bits = []
    stale = st.get("mixer.health_staleness_max",
                   st.get("mixer.self_staleness"))
    if stale is not None:
        mix_bits.append(f"stale {int(stale)}")
    if st.get("mixer.model_version") is not None:
        mix_bits.append(f"v{st['mixer.model_version']}")
    # model-integrity plane: members this node's guard holds in
    # quarantine, and rollbacks this model took
    q = st.get("mixer.guard_quarantined")
    if q:
        mix_bits.append(f"quar {len(q)}")
    if st.get("rollback.count"):
        mix_bits.append(f"rb {int(st['rollback.count'])}")
    # async mix: this member's distance behind the fold cadence and, on
    # the master, the pending inbox
    if st.get("mixer.async_mode"):
        mix_bits.append(f"lag {int(st.get('mixer.async_lag_rounds', 0))}")
        depth = st.get("mixer.async_inbox_depth")
        if depth:
            mix_bits.append(f"inbox {int(depth)}")
    # shard layout: N shards × live rows (row stores) or MB a shard
    # (feature-sharded weight tables)
    shards = st.get("driver.shard.count")
    if shards:
        nbytes = int(st.get("driver.shard.bytes_in_use", 0))
        if st.get("driver.shard.rows_per_shard") is not None:
            mix_bits.append(
                f"sh {int(shards)}x{int(st.get('driver.shard.rows', 0))}r")
        else:
            mix_bits.append(
                f"sh {int(shards)}x"
                f"{nbytes / max(int(shards), 1) / 2 ** 20:.0f}MB")
    # elastic membership: the member's drain state machine and the rows
    # it moved
    drain = st.get("drain.state")
    if drain and drain != "active":
        mix_bits.append(f"drain {drain}")
    moved = st.get("migration.rows_moved")
    if moved:
        mix_bits.append(f"moved {int(moved)}")
    p99_cell = f"{p99:.1f} {p99_span[4:]}" if p99 is not None else "-"
    return (f"  {node_name:<22} {state:<9} {reqs:>8} {errs:>7}  "
            f"{p99_cell:<22} {' '.join(mix_bits) or '-'}")


def render_watch_frame(data: Dict[str, Any], ts: str = "") -> str:
    """One watch frame as text (pure; asserted by tests, printed by
    ``show_watch``): per-node requests, errors and the worst p99 of the
    rpc spans, drain state and mix health, then the proxies' breaker
    states and forwards."""
    lines: List[str] = []
    nodes = data.get("nodes") or {}
    proxies = data.get("proxies") or {}
    actives = data.get("actives") or set()
    draining = data.get("draining") or set()
    lines.append(f"{data.get('engine')}/{data.get('name')}"
                 f"{'  ' + ts if ts else ''}  "
                 f"epoch {data.get('epoch', 0)}  "
                 f"({len(nodes)} server(s), {len(proxies)} proxy(ies)"
                 + (f", {len(draining)} draining" if draining else "")
                 + ")")
    lines.append(f"  {'node':<22} {'state':<9} {'requests':>8} {'errors':>7}  "
                 f"{'p99 ms (span)':<22} mix health")
    for node_name in sorted(nodes):
        lines.append(_watch_node_row(node_name, nodes[node_name],
                                     node_name in actives,
                                     node_name in draining))
    for pname in sorted(proxies):
        p = proxies[pname]
        if p.get("error"):
            lines.append(f"  proxy {pname:<16} DOWN <{p['error'][:60]}>")
            continue
        st = p.get("status") or {}
        lines.append(
            f"  proxy {pname:<16} {st.get('breaker_open', 0)} breaker(s) "
            f"open / {st.get('breaker_backends', 0)} tracked, "
            f"forwards {st.get('forward_count', 0)} "
            f"(errors {st.get('forward_errors', 0)}, "
            f"relayed {st.get('relay_count', 0)})")
    return "\n".join(lines)


def show_watch(coord: Coordinator, engine: str, name: str, *,
               once: bool = False) -> int:
    """One cluster frame (``--once``, the scriptable form). The live
    refresh loop of the JAX jubactl renders windowed rates from each
    member's time series, which the port does not serve yet (A20)."""
    import time as _time

    if not once:
        print("jubactl -c watch without --once: not yet ported (ROADMAP "
              "A20: the windowed rates need the time series)",
              file=sys.stderr)
        return 1
    data = collect_watch(coord, engine, name)
    print(render_watch_frame(data, ts=_time.strftime("%H:%M:%S")))
    return 0 if data.get("nodes") else -1


def main(argv: Optional[List[str]] = None) -> int:
    ns = _parser().parse_args(argv)
    if ns.cmd in NOT_YET_PORTED:
        print(f"jubactl -c {ns.cmd}: not yet ported (ROADMAP "
              f"{NOT_YET_PORTED[ns.cmd]})", file=sys.stderr)
        return 1
    spec = resolve_coordinator(ns.coordinator)
    if not spec:
        print("no coordinator: pass -z or set JUBATUS_COORDINATOR/ZK",
              file=sys.stderr)
        return 1
    coord = create_coordinator(spec)
    try:
        if ns.cmd == "status":
            return show_status(coord, ns.type, ns.name, show_all=ns.all)
        if ns.cmd == "breakers":
            return show_breakers(coord, ns.type, ns.name)
        if ns.cmd == "watch":
            return show_watch(coord, ns.type, ns.name, once=ns.once)
        if ns.cmd == "drain":
            return drain_member(coord, ns.type, ns.name, ns.target,
                                stop_after=ns.stop,
                                timeout=ns.drain_timeout)
        if ns.cmd == "rebalance":
            return rebalance_cluster(coord, ns.type, ns.name)
        if ns.cmd == "rollback":
            return rollback_member(coord, ns.type, ns.name, ns.target)
        if ns.cmd == "restore":
            return restore_fleet(coord, ns.type, ns.name, ns.target,
                                 ns.at)
        if ns.cmd in ("start", "stop"):
            server = ns.server or ns.type
            name = f"{server}/{ns.name}"
            server_argv = {
                "listen_if": ns.listen_if, "thread": ns.thread,
                "datadir": ns.datadir, "mixer": ns.mixer,
                "interval_sec": ns.interval_sec,
                "interval_count": ns.interval_count,
                "zookeeper_timeout": ns.zookeeper_timeout,
                "interconnect_timeout": ns.interconnect_timeout,
            } if ns.cmd == "start" else {}
            return send2supervisor(coord, ns.cmd, ns.type, name, ns.num,
                                   server_argv)
        # save / load ('name' is the default id, jubactl.cpp:144-149)
        model_id = ns.id or ns.name
        return send2server(coord, ns.cmd, ns.type, ns.name, model_id)
    finally:
        coord.close()


if __name__ == "__main__":
    sys.exit(main())
