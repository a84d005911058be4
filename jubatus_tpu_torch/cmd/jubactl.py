"""Cluster control CLI (counterpart of ``jubatus_tpu/cmd/jubactl.py``;
≙ cmd/jubactl.cpp).

    jubactl -c start  -t classifier -s jubaclassifier -n c1 -N 4 -z tcp://host:2199
    jubactl -c stop   -t classifier -s jubaclassifier -n c1 -z tcp://host:2199
    jubactl -c save   -t classifier -n c1 -z tcp://host:2199 [-i model_id]
    jubactl -c load   -t classifier -n c1 -z tcp://host:2199 [-i model_id]
    jubactl -c status -t classifier -n c1 -z tcp://host:2199 [--all]
    jubactl -c metrics | alerts | quality | usage [--top N] ...
    jubactl -c breakers -t classifier -n c1 -z tcp://host:2199
    jubactl -c trace TRACE_ID -t classifier -n c1 -z tcp://host:2199
    jubactl -c profile ... [--folded] [--top N] [--device [--device-seconds S]]
    jubactl -c watch  ... [--once] [--interval S] [--window S]
    jubactl -c timeline ... [--since S] [--grep TEXT] [--follow]
    jubactl -c incident ... [--pull ID]
    jubactl -c drain  -t nearest_neighbor -n c1 --target IP_PORT [--stop]
    jubactl -c rebalance | rollback [--target IP_PORT] | restore [--at HLC]
    jubactl -c tune   -t classifier -n c1 -z tcp://host:2199
    jubactl -c autoscale -t regression -n c1 -z tcp://host:2199 [--watch]
            [--once] [--min N] [--max N] [--autoscale-interval S] ...

start/stop fan out to every jubavisor under /jubatus/supervisors,
distributing N processes round-robin (N/visors each, remainder to the
first ones; N=0 → one per visor — jubactl.cpp:133-142,240-260). save/load
RPC every registered server of the cluster (send2server). status prints
the nodes/actives registries with the membership epoch and the draining
members; ``--all`` additionally scrapes every member's get_status map,
with one-line health, guard, shard-layout and ANN summaries.
``breakers`` scrapes every registered proxy's per-backend circuit breaker
and retry-budget state. ``drain`` drives one member through the drain
state machine and waits for ``drained``; ``rebalance`` asks every member
to pull the rows it owns under the current ring; ``rollback`` restores
the last-good snapshot on one member (``--target``) or all; ``restore``
is the point-in-time restore from the shared model store.

The observability views, the JAX jubactl's text for the same docs:
``metrics`` folds every member's histogram snapshot (``get_metrics``)
into one cluster quantile table (exact at bucket resolution);
``alerts`` lists every member's and proxy's SLO states; ``quality`` and
``usage`` fold the data-quality sketches and the per-tenant ledgers
(``get_quality`` / ``get_usage``; a proxy answers for the fleet);
``trace TRACE_ID`` stitches every member's and proxy's span records into
one cross-node tree with per-hop timings; ``profile`` folds every node's
collapsed stacks into one top-N table, or ``--folded`` lines for
flamegraph.pl, and ``--device`` lists or triggers the backends'
torch.profiler captures; ``watch`` refreshes one cluster frame every
``--interval`` seconds (``--once``: one frame) with windowed request and
error rates and p99 from each member's time series, mix health, the last
event and the firing SLOs; ``timeline`` merges every node's event journal
in HLC order (``--follow`` streams with per-node cursors); ``incident``
lists the captured bundles or ``--pull``s one.

The control loops: ``tune`` scrapes every member's self-tuning plane
(``get_tune``) and renders per-node tuner state — mode, the mix plan
hill-climb, coalescer and cadence gate state, actuation backoff — and
the recent decision journal (dry-run-tagged under ``--auto-tune
observe``). ``autoscale`` runs the autoscaling control loop
(coord/autoscaler.py) in the foreground — poll SLO burn and queue
depth, spawn replicas through registered jubavisors, drain the
least-loaded member when sustained-cold — serving its journal over
``get_autoscale_status``; ``--watch`` renders live frames (attaching to
an already-registered autoscaler instead of starting a second loop),
``--once`` renders one observe-only tick. Server flags
(-B/-C/-T/-D/-L/-X/-S/-I/-Z/-R) are forwarded to visor-spawned processes
(jubactl.cpp:90-110).
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional

from jubatus_tpu_torch.cmd import resolve_coordinator
from jubatus_tpu_torch.coord import create_coordinator, membership
from jubatus_tpu_torch.coord.base import Coordinator, NodeInfo
from jubatus_tpu_torch.rpc.client import RpcClient


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="jubactl")
    p.add_argument("-c", "--cmd", required=True,
                   choices=["start", "stop", "save", "load", "status",
                            "metrics", "breakers", "trace", "alerts",
                            "watch", "profile", "drain", "rebalance",
                            "autoscale", "timeline", "incident",
                            "rollback", "quality", "restore", "usage",
                            "tune"])
    p.add_argument("trace_id", nargs="?", default="",
                   help="[trace] trace id to assemble (from a slow-log "
                        "record, a /metrics exemplar, or "
                        "trace.*.last_trace_id in get_status)")
    p.add_argument("--all", action="store_true",
                   help="[status] also scrape every member's get_status")
    p.add_argument("--once", action="store_true",
                   help="[watch] render one frame and exit (scripts/CI)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="[watch|timeline --follow] refresh period in "
                        "seconds")
    p.add_argument("--window", type=float, default=60.0,
                   help="[watch] rate/quantile window in seconds "
                        "(computed from each node's get_timeseries ring)")
    p.add_argument("--seconds", type=float, default=60.0,
                   help="[profile] sampling window to fold (seconds; "
                        "0 = every retained bucket)")
    p.add_argument("--folded", action="store_true",
                   help="[profile] emit collapsed-stack 'stack count' "
                        "lines (flamegraph.pl / speedscope input) "
                        "instead of the top-N table")
    p.add_argument("--top", type=int, default=30,
                   help="[profile] rows in the self/cumulative table; "
                        "[usage] principals in the per-tenant table")
    p.add_argument("--device", action="store_true",
                   help="[profile] on-demand torch.profiler device "
                        "capture instead of stack sampling: list existing "
                        "artifacts, or capture for --device-seconds on "
                        "every backend")
    p.add_argument("--device-seconds", type=float, default=0.0,
                   help="[profile --device] capture duration in seconds "
                        "(0 = just list existing artifacts)")
    p.add_argument("--since", type=float, default=0.0,
                   help="[timeline] only events from the last this many "
                        "seconds (0 = every retained event)")
    p.add_argument("--grep", default="",
                   help="[timeline] substring filter (subsystem, type, "
                        "node, field values; applied server-side)")
    p.add_argument("--follow", action="store_true",
                   help="[timeline] keep polling with per-node HLC "
                        "cursors and stream new events as they happen "
                        "(--interval controls the poll period)")
    p.add_argument("--list", action="store_true",
                   help="[incident] list captured bundles across the "
                        "cluster (the default)")
    p.add_argument("--pull", default="", metavar="ID",
                   help="[incident] fetch one bundle by id (from "
                        "--list) and print its full forensic JSON")
    p.add_argument("--target", default="",
                   help="[drain|rollback|restore] the member to act on, "
                        "as IP_PORT (a node name from -c status); "
                        "rollback/restore without --target act on EVERY "
                        "member (the fleet-wide recovery)")
    p.add_argument("--at", default="latest", metavar="HLC|latest",
                   help="[restore] point in time to restore to: a packed "
                        "HLC (from -c timeline or store.head_hlc in -c "
                        "status) or 'latest' (the default). Each member "
                        "materializes the newest snapshot+diff chain "
                        "at/before that instant and re-imports its owned "
                        "rows under the CURRENT hash ring")
    p.add_argument("--stop", action="store_true",
                   help="[drain] also unregister the member's nodes/ "
                        "entry when drained, firing its suicide watcher "
                        "(the process exits); default leaves it running "
                        "drained for inspection")
    p.add_argument("--drain-timeout", type=float, default=120.0,
                   help="[drain] seconds to wait for the drained state")
    # autoscaling control plane (coord/autoscaler.py)
    p.add_argument("--watch", action="store_true",
                   help="[autoscale] render a live frame every poll "
                        "(attaches to an already-registered autoscaler's "
                        "get_autoscale_status instead of starting a "
                        "second control loop)")
    p.add_argument("--min", dest="as_min", type=int, default=1,
                   help="[autoscale] fleet floor — a fleet below it "
                        "restores immediately, bypassing confirm and "
                        "cooldown")
    p.add_argument("--max", dest="as_max", type=int, default=8,
                   help="[autoscale] fleet ceiling for scale-out")
    p.add_argument("--autoscale-interval", type=float, default=5.0,
                   help="[autoscale] control-loop poll period (seconds)")
    p.add_argument("--cooldown", type=float, default=30.0,
                   help="[autoscale] quiet period after any actuation")
    p.add_argument("--scale-out-confirm", type=int, default=2,
                   help="[autoscale] consecutive hot polls before a "
                        "scale-out fires (flap suppression)")
    p.add_argument("--scale-in-confirm", type=int, default=6,
                   help="[autoscale] consecutive cold polls before a "
                        "scale-in drains the least-loaded replica")
    p.add_argument("--burn-hot", type=float, default=2.0,
                   help="[autoscale] SLO fast-window burn rate at/above "
                        "which a poll counts hot")
    p.add_argument("--queue-hot", type=float, default=4096.0,
                   help="[autoscale] queued examples per replica "
                        "(microbatch.queue_depth) at/above which a poll "
                        "counts hot")
    p.add_argument("--autoscale-port", type=int, default=0,
                   help="[autoscale] port for the get_autoscale_status "
                        "RPC (0 = ephemeral); registered under "
                        "/jubatus/autoscalers")
    p.add_argument("--dry-run", action="store_true",
                   help="[autoscale] observe and journal decisions, "
                        "never actuate (the safe exploration mode; "
                        "--once defaults to it when no autoscaler is "
                        "registered)")
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
    p.add_argument("-T", "--timeout", type=int, default=10)
    p.add_argument("-D", "--datadir", default="/tmp")
    p.add_argument("-L", "--logdir", default="")
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
            # model-health verdict first: the structured degraded
            # reasons /healthz carries, rendered as one line
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
            ann_line = _fmt_ann(st)
            if ann_line:
                print(f"    {ann_line}")
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


def _fmt_ann(st: Dict[str, Any]) -> str:
    """One-line ANN-tier summary from the driver.ann.* gauges: mode, cell
    count, last probe/rescore widths, rolling recall probe; "" when the
    tier is off."""
    mode = st.get("driver.ann.mode")
    if not mode or mode == "off":
        return ""
    bits = [f"ann: {mode}"]
    if st.get("driver.ann.degraded"):
        bits.append("DEGRADED(exact fallback)")
    cells = st.get("driver.ann.cells")
    if cells:
        bits.append(f"{int(cells)} cells "
                    f"(probe {int(st.get('driver.ann.nprobe', 0))})")
    probed = st.get("driver.ann.probed_cells")
    cand = st.get("driver.ann.rescore_candidates")
    if probed:
        bits.append(f"last {int(probed)}c/{int(cand or 0)}r")
    recall = st.get("driver.ann.recall_probe")
    if recall is not None:
        bits.append(f"recall~{float(recall):.2f}")
    return "  ".join(bits)


def _fmt_ms(v) -> str:
    return f"{v:10.3f}" if isinstance(v, (int, float)) else f"{v:>10}"


def show_metrics(coord: Coordinator, engine: str, name: str) -> int:
    """Merged cluster quantile view: scrape every member's get_metrics
    snapshot and fold bucket counts (exact at bucket resolution)."""
    from jubatus_tpu_torch.utils import tracing

    nodes = membership.get_all_nodes(coord, engine, name)
    if not nodes:
        print(f"no server of {engine}/{name}", file=sys.stderr)
        return -1
    snaps: List[Dict[str, Any]] = []
    scraped = []
    for node in nodes:
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                per_node = c.call("get_metrics", name)
        except Exception as e:  # noqa: BLE001 — partial view beats none
            print(f"  <{node.name}: get_metrics failed: {e}>",
                  file=sys.stderr)
            continue
        for node_name, snap in per_node.items():
            snaps.append(snap)
            scraped.append(node_name)
    if not snaps:
        print("no member answered get_metrics", file=sys.stderr)
        return -1
    merged = tracing.merge_snapshots(snaps)
    print(f"{engine}/{name}: merged metrics from {len(scraped)} node(s): "
          f"{', '.join(sorted(scraped))}")
    hists = merged.get("hists") or {}
    if hists:
        print(f"  {'span':<32} {'count':>8} {'p50_ms':>10} {'p90_ms':>10} "
              f"{'p99_ms':>10} {'max_ms':>10}")
        for span in sorted(hists):
            st = hists[span]
            qs = [tracing.state_quantile(st, q) for q in (0.5, 0.9, 0.99)]
            cells = " ".join(_fmt_ms((q or 0.0) * 1e3) for q in qs)
            print(f"  {span:<32} {st.get('count', 0):>8} {cells} "
                  f"{_fmt_ms(float(st.get('max_s', 0.0)) * 1e3)}")
    counters = merged.get("counters") or {}
    if counters:
        print("  counters:")
        for cname in sorted(counters):
            print(f"    {cname}: {counters[cname]}")
    return 0


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


def show_alerts(coord: Coordinator, engine: str, name: str) -> int:
    """Model-health plane: every member's + proxy's SLO state
    (``get_alerts`` / ``get_proxy_alerts``) — which alerts are FIRING,
    and every configured SLO's current fast/slow burn rates."""
    rows: List[Dict[str, Any]] = []
    scraped = 0
    for node, method in (
            [(n, "get_alerts")
             for n in membership.get_all_nodes(coord, engine, name)]
            + [(pxy, "get_proxy_alerts") for pxy in _proxies(coord)]):
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                per_node = c.call(method, name)
        except Exception as e:  # noqa: BLE001 — partial view beats none
            print(f"  <{node.name}: {method} failed: {e}>", file=sys.stderr)
            continue
        scraped += 1
        for node_name, doc in sorted((per_node or {}).items()):
            for st in (doc or {}).get("slos") or []:
                st = dict(st)
                st["node"] = node_name
                rows.append(st)
    if not scraped:
        print(f"no member of {engine}/{name} answered get_alerts",
              file=sys.stderr)
        return -1
    firing = [r for r in rows if r.get("firing")]
    print(f"{engine}/{name}: {len(firing)} alert(s) firing, "
          f"{len(rows)} SLO state(s) across the cluster")
    if rows:
        print(f"  {'node':<22} {'slo':<28} {'state':<8} "
              f"{'burn_fast':>9} {'burn_slow':>9}")
        for r in sorted(rows, key=lambda r: (not r.get("firing"),
                                             r.get("node", ""),
                                             r.get("name", ""))):
            state = "FIRING" if r.get("firing") else "ok"
            print(f"  {r.get('node', '?'):<22} {r.get('name', '?'):<28} "
                  f"{state:<8} {r.get('burn_fast', 0.0):>9.2f} "
                  f"{r.get('burn_slow', 0.0):>9.2f}")
            if r.get("firing"):
                print(f"      {r.get('describe', '')}")
    else:
        print("  (no SLOs configured — pass --slo to the servers)")
    return 0


def collect_quality(coord: Coordinator, engine: str,
                    name: str) -> Dict[str, Dict[str, Any]]:
    """Every member's ``get_quality`` doc keyed by node name. A proxy
    answers for the whole fleet in one call (broadcast + fold), so try
    proxies first and fall back to scraping members directly."""
    docs: Dict[str, Dict[str, Any]] = {}
    for pxy in _proxies(coord):
        try:
            with RpcClient(pxy.host, pxy.port, timeout=10.0) as c:
                per_node = c.call("get_quality", name)
        except Exception as e:  # noqa: BLE001 — fall back to members
            print(f"  <{pxy.name}: get_quality failed: {e}>",
                  file=sys.stderr)
            continue
        docs.update({k: v for k, v in (per_node or {}).items() if v})
    if docs:
        return docs
    for node in membership.get_all_nodes(coord, engine, name):
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                per_node = c.call("get_quality", name)
        except Exception as e:  # noqa: BLE001 — partial view beats none
            print(f"  <{node.name}: get_quality failed: {e}>",
                  file=sys.stderr)
            continue
        docs.update({k: v for k, v in (per_node or {}).items() if v})
    return docs


def render_quality(engine: str, name: str,
                   docs: Dict[str, Dict[str, Any]]) -> str:
    """The ``-c quality`` view (pure; asserted by tests): fleet-merged
    per-feature drift table, prequential accuracy trend, calibration
    bins. Fleet drift is recomputed from the MERGED sketches
    (utils/quality.merge_quality), not averaged node scores."""
    from jubatus_tpu_torch.utils import quality as q

    lines: List[str] = []
    fleet = q.merge_quality(list(docs.values()))
    lines.append(f"{engine}/{name}: data quality across "
                 f"{fleet['nodes']} node(s), "
                 f"sample {fleet.get('sample', 0.0):g}")
    drift = fleet.get("drift") or {}
    ref = fleet.get("reference") or {}
    live = fleet.get("live") or {}
    if drift:
        lines.append(f"  {'feature group':<24} {'psi':>8}  "
                     f"{'ref n':>9} {'live n':>9}  verdict")
        for g in sorted(drift, key=lambda g: -drift[g]):
            rn = int(((ref.get("features") or {}).get(g) or {})
                     .get("count", 0)) if g not in (
                "labels", "label_predictions") else \
                int((ref.get("labels") or {}).get("total", 0))
            ln_ = int(((live.get("features") or {}).get(g) or {})
                      .get("count", 0)) if g not in (
                "labels", "label_predictions") else \
                int((live.get("labels") or {}).get("total", 0))
            verdict = "DRIFTING" if drift[g] >= q.DEFAULT_DRIFT_THRESHOLD \
                else "ok"
            lines.append(f"  {g:<24} {drift[g]:>8.3f}  "
                         f"{rn:>9} {ln_:>9}  {verdict}")
    else:
        lines.append("  (no drift scores yet — reference window still "
                     "filling, or the quality plane is disarmed)")
    preq = fleet.get("prequential") or {}
    n = int(preq.get("n", 0))
    if n:
        acc = q.prequential_accuracy(preq)
        mae = q.prequential_mae(preq)
        bits = [f"prequential n={n}"]
        if preq.get("correct") or (acc is not None and acc > 0):
            bits.append(f"accuracy {acc:.4f}")
        if preq.get("abs_err"):
            bits.append(f"mae {mae:.4f}")
        ece = q.calibration_ece(preq)
        if ece is not None and any(int(r[0]) for r in
                                   (preq.get("conf") or [])):
            bits.append(f"ece {ece:.4f}")
        lines.append("  " + "  ".join(bits))
        conf = preq.get("conf") or []
        if any(int(r[0]) for r in conf):
            lines.append(f"  {'confidence':<12} {'n':>7} "
                         f"{'accuracy':>9} {'mean conf':>10}")
            for i, (cn, correct, conf_sum) in enumerate(conf):
                if not cn:
                    continue
                lines.append(
                    f"  [{i / 10:.1f},{(i + 1) / 10:.1f}){'':<3} {cn:>7} "
                    f"{correct / cn:>9.3f} {conf_sum / cn:>10.3f}")
    else:
        lines.append("  (no prequential scores yet — the hook samples "
                     "the train path; raise --quality-sample)")
    trend = fleet.get("trend") or []
    accs = [p["accuracy"] for p in trend if p.get("accuracy") is not None]
    if len(accs) >= 2:
        lines.append("  accuracy trend (old -> new): "
                     + " ".join(f"{a:.3f}" for a in accs[-12:]))
    drift_pts = [p.get("drift_max", 0.0) for p in trend]
    if len(drift_pts) >= 2:
        lines.append("  drift_max trend (old -> new): "
                     + " ".join(f"{d:.2f}" for d in drift_pts[-12:]))
    return "\n".join(lines)


def show_quality(coord: Coordinator, engine: str, name: str) -> int:
    """Data-quality plane: fleet-wide drift / prequential /
    calibration view from merged ``get_quality`` sketches."""
    docs = collect_quality(coord, engine, name)
    if not docs:
        print(f"no member of {engine}/{name} answered get_quality",
              file=sys.stderr)
        return -1
    print(render_quality(engine, name, docs))
    return 0


def collect_usage(coord: Coordinator, engine: str,
                  name: str) -> Dict[str, Dict[str, Any]]:
    """Every node's ``get_usage`` ledger doc keyed by node name
    (proxy hops included — they bill their own dispatch cost). A proxy
    answers for the whole fleet in one call (broadcast + fold), so try
    proxies first and fall back to scraping members directly."""
    docs: Dict[str, Dict[str, Any]] = {}
    for pxy in _proxies(coord):
        try:
            with RpcClient(pxy.host, pxy.port, timeout=10.0) as c:
                per_node = c.call("get_usage", name)
        except Exception as e:  # noqa: BLE001 — fall back to members
            print(f"  <{pxy.name}: get_usage failed: {e}>",
                  file=sys.stderr)
            continue
        docs.update({k: v for k, v in (per_node or {}).items() if v})
    if docs:
        return docs
    for node in membership.get_all_nodes(coord, engine, name):
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                per_node = c.call("get_usage", name)
        except Exception as e:  # noqa: BLE001 — partial view beats none
            print(f"  <{node.name}: get_usage failed: {e}>",
                  file=sys.stderr)
            continue
        docs.update({k: v for k, v in (per_node or {}).items() if v})
    return docs


def render_usage(engine: str, name: str,
                 docs: Dict[str, Dict[str, Any]], top: int = 0) -> str:
    """The ``-c usage`` view (pure; asserted by tests): the fleet-wide
    per-tenant bill from MERGED ledgers (utils/usage.merge_usage —
    exact-table sums + sketch merge, never gauge averaging), ranked by
    CPU-thread-seconds, plus the capacity/headroom footer."""
    from jubatus_tpu_torch.utils import sketches
    from jubatus_tpu_torch.utils import usage as u

    fleet = u.merge_usage(list(docs.values()))
    lines: List[str] = []
    lines.append(f"{engine}/{name}: usage across "
                 f"{fleet.get('nodes', 0)} node(s)")
    rows = u.principal_rows(fleet)
    shown = rows[:top] if top and top > 0 else rows
    if shown:
        lines.append(
            f"  {'principal':<24} {'req':>9} {'err':>6} {'rty':>5} "
            f"{'cpu s':>9} {'dev s':>8} {'queue s':>8} {'rows':>10} "
            f"{'MB in':>8} {'MB out':>8} {'rows/s':>8}")
        for p, agg in shown:
            lines.append(
                f"  {p:<24} {int(agg['requests']):>9} "
                f"{int(agg['errors']):>6} {int(agg['retries']):>5} "
                f"{agg['cpu_seconds']:>9.3f} "
                f"{agg['device_seconds']:>8.3f} "
                f"{agg['queue_seconds']:>8.3f} {int(agg['rows']):>10} "
                f"{agg['bytes_in'] / 2 ** 20:>8.2f} "
                f"{agg['bytes_out'] / 2 ** 20:>8.2f} "
                f"{agg['demand_rows_per_sec']:>8.1f}")
        if top and top > 0 and len(rows) > top:
            lines.append(f"  ... {len(rows) - top} more principal(s) "
                         f"(raise --top)")
    else:
        lines.append("  (no usage recorded yet — the ledger fills as "
                     "requests dispatch; tag tenants via the envelope "
                     "principal, see docs/OBSERVABILITY.md §11)")
    # heavy-hitter lane: tenants still identifiable past the exact cap
    freqs = sketches.categorical_freqs(fleet.get("sketch") or {})
    hh = [p for p, _n in sorted(freqs.items(), key=lambda kv: -kv[1])
          if p not in (fleet.get("table") or {})]
    if hh:
        lines.append("  beyond-cap heavy hitters (sketch lane): "
                     + " ".join(hh[:8]))
    cap = float(fleet.get("capacity_rows_per_sec", 0.0))
    if cap > 0.0:
        lines.append(f"  capacity {cap:g} rows/s  "
                     f"saturation {fleet.get('saturation', 0.0):.3f}  "
                     f"headroom {fleet.get('headroom', 0.0):.3f}")
    else:
        lines.append("  (no capacity estimate yet — replicas learn "
                     "theirs from measured flush throughput)")
    return "\n".join(lines)


def show_usage(coord: Coordinator, engine: str, name: str,
               top: int = 0) -> int:
    """Usage-attribution plane: fleet-wide per-tenant cost
    view from merged ``get_usage`` ledgers."""
    docs = collect_usage(coord, engine, name)
    if not docs:
        print(f"no member of {engine}/{name} answered get_usage",
              file=sys.stderr)
        return -1
    print(render_usage(engine, name, docs, top=top))
    return 0


def collect_tune(coord: Coordinator, engine: str,
                 name: str) -> Dict[str, Dict[str, Any]]:
    """Every member's ``get_tune`` doc keyed by node name. Per-node
    state (each process tunes its own knobs), so members are scraped
    directly; failures degrade per node."""
    docs: Dict[str, Dict[str, Any]] = {}
    for node in membership.get_all_nodes(coord, engine, name):
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                per_node = c.call("get_tune", name)
        except Exception as e:  # noqa: BLE001 — partial view beats none
            print(f"  <{node.name}: get_tune failed: {e}>",
                  file=sys.stderr)
            continue
        docs.update(per_node or {})
    return docs


def render_tune(engine: str, name: str,
                docs: Dict[str, Dict[str, Any]], last: int = 8) -> str:
    """The ``-c tune`` view (pure; the JAX jubactl's text for the same
    docs): per-node tuner mode + plane state + the recent decision
    journal."""
    lines: List[str] = [f"{engine}/{name}: auto-tune across "
                        f"{len(docs)} node(s)"]
    for node in sorted(docs):
        st = docs[node] or {}
        if not st:
            lines.append(f"  {node}: tuner off (--auto-tune off)")
            continue
        head = f"  {node}: mode {st.get('mode', '?')}"
        backoff = float(st.get("backoff_s") or 0.0)
        if backoff > 0:
            head += f"  backoff {backoff:g}s"
        lines.append(head)
        mix = st.get("mix")
        if mix:
            plan = f"{mix.get('wire')}/{mix.get('chunk_mb'):g}MB"
            bits = [f"plan {plan}", f"trials {mix.get('trials', 0)}",
                    "converged" if mix.get("converged") else "searching"]
            if mix.get("best_wire") is not None:
                bits.append(f"best {mix['best_wire']}/"
                            f"{mix['best_chunk_mb']:g}MB"
                            + (f" {mix['best_ms']:g}ms"
                               if mix.get("best_ms") is not None else ""))
            if mix.get("int8_blacklisted"):
                bits.append("int8 BLACKLISTED (ef drift)")
            lines.append("    mix: " + "  ".join(bits))
        for cname, gate in sorted((st.get("coalescers") or {}).items()):
            lines.append(f"    coalescer {cname}: streaks "
                         f"hot {gate.get('hot_streak', 0)} / "
                         f"cold {gate.get('cold_streak', 0)}")
        gate = st.get("cadence") or {}
        if gate:
            lines.append(f"    cadence: streaks "
                         f"hot {gate.get('hot_streak', 0)} / "
                         f"cold {gate.get('cold_streak', 0)}")
        journal = (st.get("journal") or [])[-max(0, last):]
        for rec in journal:
            action = rec.get("action", "?")
            tag = " [dry-run]" if rec.get("dry_run") else ""
            tgt = rec.get("target")
            sig = rec.get("signals") or {}
            detail = ""
            if "wire" in sig:
                detail = f" -> {sig.get('wire')}/{sig.get('chunk_mb')}MB"
            elif "depth" in sig:
                detail = f" -> depth {sig.get('depth')}"
            elif "interval_sec" in sig:
                detail = f" -> {sig.get('interval_sec')}s"
            err = f"  ({rec['error']})" if rec.get("error") else ""
            lines.append(f"    [{rec.get('ts', 0):.1f}] {action:<8} "
                         f"{rec.get('reason', '')}"
                         f"{' @' + str(tgt) if tgt else ''}"
                         f"{detail}{tag}{err}")
        if not journal:
            lines.append("    (no decisions journaled yet)")
    return "\n".join(lines)


def show_tune(coord: Coordinator, engine: str, name: str,
              last: int = 8) -> int:
    """The self-tuning performance plane: per-node tuner state and
    decision journal from ``get_tune``."""
    docs = collect_tune(coord, engine, name)
    if not docs:
        print(f"no member of {engine}/{name} answered get_tune",
              file=sys.stderr)
        return -1
    print(render_tune(engine, name, docs, last=last))
    return 0


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


def collect_watch(coord: Coordinator, engine: str, name: str,
                  window_s: float = 60.0) -> Dict[str, Any]:
    """One scrape of the whole cluster for the watch view: per-member
    get_status + get_timeseries + get_alerts, per-proxy
    get_proxy_status. Failures degrade per node (a sick node is exactly
    what the watch exists to show)."""
    from jubatus_tpu_torch.utils.timeseries import window_from_points

    nodes = membership.get_all_nodes(coord, engine, name)
    actives = {n.name for n in membership.get_all_actives(
        coord, engine, name)}
    data: Dict[str, Any] = {"engine": engine, "name": name,
                            "window_s": window_s, "nodes": {},
                            "proxies": {}, "actives": actives,
                            "epoch": membership.get_epoch(
                                coord, engine, name),
                            "draining": {n.name for n in
                                         membership.get_draining(
                                             coord, engine, name)}}
    import time as _time

    from jubatus_tpu_torch.utils import events as ev

    ev_since = ev.wall_to_hlc(_time.time() - max(window_s * 5, 600.0))
    for node in nodes:
        entry: Dict[str, Any] = {"error": ""}
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                status = c.call("get_status", name)
                ts = c.call("get_timeseries", name)
                alerts = c.call("get_alerts", name)
                # event plane: recent events feed the
                # last_event column and the inline firing-SLO lines
                try:
                    evs = c.call("get_events", name, ev_since, "")
                except Exception:  # noqa: BLE001 — pre-event-plane node
                    evs = {}
        except Exception as e:  # noqa: BLE001 — render the sick node
            entry["error"] = str(e)
            data["nodes"][node.name] = entry
            continue
        st = (status or {}).get(node.name) or \
            next(iter((status or {}).values()), {})
        entry["status"] = st
        points = ((ts or {}).get(node.name) or {}).get("points") or []
        entry["window"] = window_from_points(points, window_s)
        doc = (alerts or {}).get(node.name) or {}
        entry["alerts"] = [a.get("name") for a in doc.get("alerts") or []]
        entry["events"] = ((evs or {}).get(node.name) or {}).get(
            "events") or []
        data["nodes"][node.name] = entry
    for pxy in _proxies(coord):
        try:
            with RpcClient(pxy.host, pxy.port, timeout=10.0) as c:
                pst = c.call("get_proxy_status", name)
        except Exception as e:  # noqa: BLE001
            data["proxies"][pxy.name] = {"error": str(e)}
            continue
        for node_name, st in (pst or {}).items():
            data["proxies"][node_name] = {"status": st, "error": ""}
    return data


def _watch_node_row(node_name: str, entry: Dict[str, Any],
                    active: bool, draining: bool = False) -> str:
    if entry.get("error"):
        return (f"  {node_name:<22} {'DOWN':<9} "
                f"<{entry['error'][:60]}>")
    st = entry.get("status") or {}
    win = entry.get("window")
    req_s = err_s = 0.0
    p99 = None
    p99_span = ""
    if win is not None:
        for span in win.spans("rpc."):
            r = win.span_rate(span)
            req_s += r
            if r > 0:
                q = win.quantile_ms(span, 0.99)
                if q is not None and (p99 is None or q > p99):
                    p99, p99_span = q, span
        for cname in win.counter_names("rpc."):
            if cname.endswith(".errors"):
                err_s += win.counter_rate(cname)
    health = st.get("health.status", "?")
    state = (f"{health}/drain" if draining
             else health if active else f"{health}/standby")
    div = st.get("mixer.health_premix_divergence_mean",
                 st.get("mixer.health_premix_divergence"))
    stale = st.get("mixer.health_staleness_max",
                   st.get("mixer.self_staleness"))
    drift = st.get("mixer.mix_ef_contrib_residual_norm")
    mix_bits = []
    if div is not None:
        mix_bits.append(f"div {float(div):.3f}")
    if stale is not None:
        mix_bits.append(f"stale {int(stale)}")
    if st.get("mixer.model_version") is not None:
        mix_bits.append(f"v{st['mixer.model_version']}")
    if drift is not None:
        mix_bits.append(f"ef {float(drift):.3g}")
    # model-integrity plane: members this node's guard holds
    # in quarantine, and rollbacks this model took
    q = st.get("mixer.guard_quarantined")
    if q:
        mix_bits.append(f"quar {len(q)}")
    if st.get("rollback.count"):
        mix_bits.append(f"rb {int(st['rollback.count'])}")
    # async mix: this member's distance behind the fold
    # cadence and, on the master, the pending inbox
    if st.get("mixer.async_mode"):
        mix_bits.append(f"lag {int(st.get('mixer.async_lag_rounds', 0))}")
        depth = st.get("mixer.async_inbox_depth")
        if depth:
            mix_bits.append(f"inbox {int(depth)}")
    # shard layout: N shards × live rows (row stores) or
    # MB/shard (feature-sharded weight state)
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
    # ANN tier: cell count when armed, or DEG on degrade
    ann_mode = st.get("driver.ann.mode")
    if ann_mode and ann_mode != "off":
        if st.get("driver.ann.degraded"):
            mix_bits.append("ann DEG")
        else:
            mix_bits.append(f"ann {int(st.get('driver.ann.cells', 0))}c")
    # ANN shadow recall: sag
    # here is the early warning the recall-deficit SLO alarms on
    recall = st.get("driver.ann.recall_probe")
    if recall is not None:
        mix_bits.append(f"rec {float(recall):.2f}")
    # data-quality plane: PSI drift vs the pinned reference
    # + prequential (test-then-train) accuracy
    qd = st.get("quality.drift_max")
    if qd is not None and st.get("quality.reference_pinned"):
        mix_bits.append(f"drift {float(qd):.2f}")
    qa = st.get("quality.prequential_accuracy")
    if qa is not None:
        mix_bits.append(f"acc {float(qa):.3f}")
    # usage-attribution plane: the tenant currently
    # demanding the most of this replica + its remaining headroom
    tp = st.get("usage.top_principal")
    if tp:
        mix_bits.append(f"ten {tp}")
    hr = st.get("usage.headroom")
    if hr is not None:
        mix_bits.append(f"hr {float(hr):.2f}")
    alerts = ",".join(entry.get("alerts") or []) or "-"
    p99_cell = f"{p99:.1f} {p99_span[4:]}" if p99 is not None else "-"
    # event plane: the node's newest event + its age — one
    # glance says whether something just transitioned here
    evs = entry.get("events") or []
    if evs:
        import time as _time

        last = evs[-1]
        age = max(0.0, _time.time() - float(last.get("ts", 0.0)))
        last_evt = f"{last.get('subsystem')}.{last.get('type')} {age:.0f}s"
    else:
        last_evt = "-"
    return (f"  {node_name:<22} {state:<9} {req_s:>8.1f} {err_s:>7.2f}  "
            f"{p99_cell:<22} {' '.join(mix_bits) or '-':<28} "
            f"{last_evt:<26} {alerts}")


def render_watch_frame(data: Dict[str, Any], ts: str = "") -> str:
    """One watch frame as text (pure; asserted by tests, printed by the
    refresh loop): per-node request/error rates + windowed p99 from the
    time-series, mix health (divergence/staleness/quant drift), proxy
    breaker states, and the firing alerts."""
    lines: List[str] = []
    nodes = data.get("nodes") or {}
    proxies = data.get("proxies") or {}
    actives = data.get("actives") or set()
    draining = data.get("draining") or set()
    # event plane: the header shows not just WHICH epoch the
    # cluster is on but how long ago membership last CHANGED — the age
    # of the newest membership event across every node's journal
    import time as _time

    all_events = [e for entry in nodes.values()
                  for e in (entry.get("events") or [])]
    member_evts = [e for e in all_events
                   if e.get("subsystem") == "membership"]
    if member_evts:
        newest = max(member_evts, key=lambda e: e.get("hlc", 0))
        age = max(0.0, _time.time() - float(newest.get("ts", 0.0)))
        epoch_bit = (f"epoch {data.get('epoch', 0)} "
                     f"(last event {age:.0f}s ago)")
    else:
        epoch_bit = f"epoch {data.get('epoch', 0)}"
    lines.append(f"{data.get('engine')}/{data.get('name')}"
                 f"{'  ' + ts if ts else ''}  "
                 f"window {data.get('window_s', 0):g}s  "
                 f"{epoch_bit}  "
                 f"({len(nodes)} server(s), {len(proxies)} proxy(ies)"
                 + (f", {len(draining)} draining" if draining else "")
                 + ")")
    lines.append(f"  {'node':<22} {'state':<9} {'req/s':>8} {'err/s':>7}  "
                 f"{'p99 ms (span)':<22} {'mix health':<28} "
                 f"{'last_event':<26} alerts")
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
            f"(errors {st.get('forward_errors', 0)})")
    firing = sorted({a for e in nodes.values()
                     for a in (e.get("alerts") or [])})
    lines.append("  alerts firing: " + (", ".join(firing) or "none"))
    # firing-SLO events inline: the fire/clear EDGES of the
    # recent window, so a cleared-but-recent page is still visible
    slo_edges = sorted((e for e in all_events
                        if e.get("subsystem") == "slo"),
                       key=lambda e: e.get("hlc", 0))
    for e in slo_edges[-4:]:
        age = max(0.0, _time.time() - float(e.get("ts", 0.0)))
        lines.append(f"  ! {age:>4.0f}s ago  {e.get('node', '?'):<22} "
                     f"slo {e.get('type')} {e.get('name', '?')} "
                     f"burn_fast={e.get('burn_fast', 0)}")
    return "\n".join(lines)


def show_watch(coord: Coordinator, engine: str, name: str, *,
               once: bool = False, interval: float = 2.0,
               window_s: float = 60.0) -> int:
    """Live cluster watch: poll + render until interrupted
    (``--once`` renders a single frame — the scriptable/CI form)."""
    import time as _time

    while True:
        data = collect_watch(coord, engine, name, window_s)
        ts = _time.strftime("%H:%M:%S")
        frame = render_watch_frame(data, ts=ts)
        if once:
            print(frame)
            return 0 if data.get("nodes") else -1
        # full-frame refresh: clear + home, like watch(1)
        sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
        sys.stdout.flush()
        try:
            _time.sleep(max(interval, 0.2))
        except KeyboardInterrupt:
            return 0


def collect_profiles(coord: Coordinator, engine: str, name: str,
                     seconds: float = 60.0) -> Dict[str, Dict[str, Any]]:
    """Scrape every member's folded stack profile (``get_profile``) and
    every registered proxy's own (``get_proxy_profile``) — one doc per
    node name. Per-node failures degrade (partial profile beats none,
    same stance as the trace/alert collectors)."""
    docs: Dict[str, Dict[str, Any]] = {}
    for node, method in (
            [(n, "get_profile")
             for n in membership.get_all_nodes(coord, engine, name)]
            + [(pxy, "get_proxy_profile") for pxy in _proxies(coord)]):
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                per_node = c.call(method, name, float(seconds))
        except Exception as e:  # noqa: BLE001 — partial profile beats none
            print(f"  <{node.name}: {method} failed: {e}>", file=sys.stderr)
            continue
        for node_name, doc in (per_node or {}).items():
            if isinstance(doc, dict):
                docs[str(node_name)] = doc
    return docs


def show_profile(coord: Coordinator, engine: str, name: str, *,
                 seconds: float = 60.0, folded: bool = False,
                 top: int = 30, device: bool = False,
                 device_seconds: float = 0.0) -> int:
    """The cluster profile view. Default mode folds every
    member's (and proxy's) collapsed stacks over the last ``seconds``
    and prints a top-N self/cumulative table; ``--folded`` emits raw
    ``stack count`` lines on stdout (header on stderr) so the output
    pipes straight into flamegraph.pl or speedscope. ``--device``
    switches to the on-demand device capture plane (torch.profiler on
    each backend): list artifacts, or
    capture ``--device-seconds`` on every backend."""
    from jubatus_tpu_torch.utils import profiler as prof

    if device:
        nodes = membership.get_all_nodes(coord, engine, name)
        if not nodes:
            print(f"no server of {engine}/{name}", file=sys.stderr)
            return -1
        rc = 0
        for node in nodes:
            try:
                # capture blocks for its duration: size the timeout to it
                with RpcClient(node.host, node.port,
                               timeout=max(10.0, device_seconds + 10.0)) as c:
                    per_node = c.call("profile_device", name,
                                      float(device_seconds))
            except Exception as e:  # noqa: BLE001 — report per-host
                print(f"  <{node.name}: profile_device failed: {e}>",
                      file=sys.stderr)
                rc = -1
                continue
            for node_name, doc in sorted((per_node or {}).items()):
                if "error" in doc:
                    print(f"{node_name}: capture error: {doc['error']}")
                    rc = -1
                elif "artifact" in doc:
                    print(f"{node_name}: captured {doc.get('seconds')}s "
                          f"-> {doc['artifact']} ({doc.get('bytes', 0)} "
                          "bytes)")
                else:
                    arts = doc.get("artifacts") or []
                    print(f"{node_name}: {len(arts)} capture(s) in "
                          f"{doc.get('dir', '?')}")
                    for a in arts:
                        print(f"  {a.get('name')}  {a.get('bytes', 0)} bytes")
        return rc
    docs = collect_profiles(coord, engine, name, seconds)
    if not docs:
        print(f"no member of {engine}/{name} answered get_profile",
              file=sys.stderr)
        return -1
    merged = prof.fold_profiles(docs.values())
    per_node = ", ".join(
        f"{n} ({sum((d.get('folded') or {}).values())} samples)"
        for n, d in sorted(docs.items()))
    header = (f"{engine}/{name}: profile window {seconds:g}s, folded "
              f"from {len(docs)} node(s): {per_node}")
    if not merged:
        print(header, file=sys.stderr)
        print("no samples retained (is --profile-hz 0 everywhere?)",
              file=sys.stderr)
        return -1
    if folded:
        # stdout stays pure collapsed-stack lines for flamegraph.pl
        print(header, file=sys.stderr)
        for line in prof.folded_lines(merged):
            print(line)
        return 0
    print(header)
    print(prof.render_top(merged, top=top))
    snaps = [(n, s) for n, d in sorted(docs.items())
             for s in d.get("snapshots") or []]
    if snaps:
        print(f"  tail-triggered snapshots ({len(snaps)}):")
        for n, s in snaps[-8:]:
            ids = ",".join(s.get("trace_ids") or []) or "-"
            print(f"    {n}  span={s.get('span')}  "
                  f"samples={s.get('samples')}  traces={ids}")
    return 0


def collect_trace_spans(coord: Coordinator, engine: str, name: str,
                        trace_id: str) -> List[Dict[str, Any]]:
    """Scrape every member's span store (``get_spans``) and every
    registered proxy's own (``get_proxy_spans``) for one trace; each
    span record is annotated with the node it came from."""
    spans: List[Dict[str, Any]] = []
    for node, method in (
            [(n, "get_spans")
             for n in membership.get_all_nodes(coord, engine, name)]
            + [(pxy, "get_proxy_spans") for pxy in _proxies(coord)]):
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                per_node = c.call(method, name, trace_id)
        except Exception as e:  # noqa: BLE001 — partial trace beats none
            print(f"  <{node.name}: {method} failed: {e}>", file=sys.stderr)
            continue
        for node_name, recs in (per_node or {}).items():
            for rec in recs or []:
                rec = dict(rec)
                rec.setdefault("node", node_name)
                spans.append(rec)
    return spans


def assemble_trace(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Stitch span records (possibly from many nodes) into a forest:
    each returned root carries nested ``children`` lists. A span whose
    parent was not captured anywhere (the client's side of the story, or
    a ring-evicted hop) becomes a root — partial traces still render."""
    by_id: Dict[str, Dict[str, Any]] = {}
    for rec in spans:
        node = dict(rec)
        node["children"] = []
        by_id[str(node.get("span_id", ""))] = node
    roots: List[Dict[str, Any]] = []
    for node in by_id.values():
        parent = by_id.get(str(node.get("parent_id", "")))
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    def _start(n: Dict[str, Any]) -> float:
        return float(n.get("ts", 0.0))
    for node in by_id.values():
        node["children"].sort(key=_start)
    roots.sort(key=_start)
    return roots


def render_trace(trace_id: str, roots: List[Dict[str, Any]],
                 out=None) -> None:
    """Print one assembled span tree with per-hop timings: duration,
    owning node, and offset from the trace's first captured span."""
    out = out or sys.stdout
    t0 = min((float(r.get("ts", 0.0)) for r in roots), default=0.0)
    count = [0]

    def _walk(node: Dict[str, Any], indent: str, last: bool) -> None:
        count[0] += 1
        branch = "└─ " if last else "├─ "
        off = (float(node.get("ts", 0.0)) - t0) * 1e3
        print(f"{indent}{branch}{node.get('name', '?'):<24} "
              f"{float(node.get('duration_ms', 0.0)):>9.3f} ms  "
              f"@{node.get('node', '?')}  [t+{off:.1f}ms]", file=out)
        child_indent = indent + ("   " if last else "│  ")
        kids = node.get("children", [])
        for i, child in enumerate(kids):
            _walk(child, child_indent, i == len(kids) - 1)

    for i, root in enumerate(roots):
        _walk(root, "", i == len(roots) - 1)
    print(f"trace {trace_id}: {count[0]} span(s), "
          f"{len(roots)} root(s)", file=out)


def show_trace(coord: Coordinator, engine: str, name: str,
               trace_id: str) -> int:
    """Assemble + render ONE cross-node span tree
    for a trace id, proxy and backend hops included."""
    if not trace_id:
        print("trace needs a TRACE_ID (jubactl -c trace TRACE_ID ...)",
              file=sys.stderr)
        return 1
    spans = collect_trace_spans(coord, engine, name, trace_id)
    if not spans:
        print(f"no spans retained for trace {trace_id} "
              "(ring-evicted, or the id never existed)", file=sys.stderr)
        return -1
    nodes = {s.get("node", "?") for s in spans}
    print(f"{engine}/{name}: trace {trace_id} across "
          f"{len(nodes)} node(s): {', '.join(sorted(nodes))}")
    render_trace(trace_id, assemble_trace(spans))
    return 0


def collect_events(coord: Coordinator, engine: str, name: str,
                   cursors: Optional[Dict[str, int]] = None,
                   since: int = 0, grep: str = ""
                   ) -> List[Dict[str, Any]]:
    """Scrape every member's event journal (``get_events``) and every
    registered proxy's own (``get_proxy_events``), each with its own
    HLC cursor (clocks differ per node — one shared cursor would skip
    or duplicate), and fold into one causally ordered timeline. Updates
    ``cursors`` in place (the ``--follow`` loop's state)."""
    from jubatus_tpu_torch.utils import events as ev

    cursors = cursors if cursors is not None else {}
    lists: List[List[Dict[str, Any]]] = []
    for node, method in (
            [(n, "get_events")
             for n in membership.get_all_nodes(coord, engine, name)]
            + [(pxy, "get_proxy_events") for pxy in _proxies(coord)]):
        cur = cursors.get(node.name, since)
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                per_node = c.call(method, name, int(cur), grep)
        except Exception as e:  # noqa: BLE001 — partial timeline beats none
            print(f"  <{node.name}: {method} failed: {e}>", file=sys.stderr)
            continue
        for node_name, doc in (per_node or {}).items():
            recs = (doc or {}).get("events") or []
            for rec in recs:
                rec.setdefault("node", node_name)
            lists.append(recs)
            if recs:
                cursors[node.name] = max(
                    cursors.get(node.name, since),
                    max(int(r.get("hlc", 0)) for r in recs))
    return ev.merge_events(lists)


_SEV_MARK = {"debug": " ", "info": " ", "warning": "!", "error": "E"}

#: event-record keys that are rendered structurally, not as k=v fields
_EVENT_META = ("hlc", "ts", "node", "subsystem", "type", "severity",
               "trace_id")


def render_event_line(rec: Dict[str, Any]) -> str:
    """One timeline row: wall time, severity mark, node, subsystem.type,
    the remaining fields as k=v, and the trace id when one was active."""
    import time as _time

    ts = float(rec.get("ts", 0.0))
    clock = _time.strftime("%H:%M:%S", _time.localtime(ts)) + \
        f".{int(ts * 1000) % 1000:03d}"
    sev = str(rec.get("severity", "info"))
    fields = " ".join(f"{k}={rec[k]}" for k in rec
                      if k not in _EVENT_META)
    tid = rec.get("trace_id", "")
    return (f"{clock} {_SEV_MARK.get(sev, ' ')} "
            f"{rec.get('node', '?'):<22} "
            f"{rec.get('subsystem', '?')}.{rec.get('type', '?'):<20} "
            f"{fields}"
            + (f"  trace={tid}" if tid else ""))


def show_timeline(coord: Coordinator, engine: str, name: str, *,
                  since_s: float = 0.0, grep: str = "",
                  follow: bool = False, interval: float = 2.0) -> int:
    """ONE interleaved cluster narrative — every
    node's state-transition events merged in causal (HLC) order.
    ``--follow`` streams: per-node cursors advance to the max HLC seen,
    so each poll prints exactly the events emitted since."""
    import time as _time

    from jubatus_tpu_torch.utils import events as ev

    since = ev.wall_to_hlc(_time.time() - since_s) if since_s > 0 else 0
    cursors: Dict[str, int] = {}
    first = True
    while True:
        recs = collect_events(coord, engine, name, cursors=cursors,
                              since=since, grep=grep)
        if first and not recs and not follow:
            print(f"no events retained for {engine}/{name}"
                  + (f" matching {grep!r}" if grep else ""),
                  file=sys.stderr)
            return -1
        if first:
            nodes = {r.get("node", "?") for r in recs}
            print(f"{engine}/{name}: {len(recs)} event(s) across "
                  f"{len(nodes)} node(s)"
                  + (f", since {since_s:g}s" if since_s else "")
                  + (f", grep {grep!r}" if grep else "")
                  + ("  [following]" if follow else ""), file=sys.stderr)
        for rec in recs:
            print(render_event_line(rec))
        if not follow:
            return 0
        first = False
        sys.stdout.flush()
        try:
            _time.sleep(max(interval, 0.2))
        except KeyboardInterrupt:
            return 0


def show_incidents(coord: Coordinator, engine: str, name: str, *,
                   pull: str = "") -> int:
    """The incident-bundle surface. Default lists every
    node's captured bundles (id, reason, age, size, correlated trace
    count); ``--pull ID`` prints one bundle's full forensic JSON on
    stdout (header on stderr — pipe it to jq/a file)."""
    import json as _json
    import time as _time

    targets = ([(n, "get_incidents")
                for n in membership.get_all_nodes(coord, engine, name)]
               + [(pxy, "get_proxy_incidents")
                  for pxy in _proxies(coord)])
    if pull:
        for node, method in targets:
            try:
                with RpcClient(node.host, node.port, timeout=10.0) as c:
                    per_node = c.call(method, name, pull)
            except Exception as e:  # noqa: BLE001 — try the next node
                print(f"  <{node.name}: {method} failed: {e}>",
                      file=sys.stderr)
                continue
            for node_name, doc in (per_node or {}).items():
                if isinstance(doc, dict) and "error" not in doc:
                    print(f"incident {pull} from {node_name}",
                          file=sys.stderr)
                    print(_json.dumps(doc, indent=2, default=str))
                    return 0
        print(f"incident {pull!r} not found on any node", file=sys.stderr)
        return -1
    rows = []
    scraped = 0
    for node, method in targets:
        try:
            with RpcClient(node.host, node.port, timeout=10.0) as c:
                per_node = c.call(method, name, "")
        except Exception as e:  # noqa: BLE001 — partial list beats none
            print(f"  <{node.name}: {method} failed: {e}>", file=sys.stderr)
            continue
        scraped += 1
        for node_name, doc in sorted((per_node or {}).items()):
            for meta in (doc or {}).get("incidents") or []:
                meta = dict(meta)
                meta["node"] = node_name
                rows.append(meta)
    if not scraped:
        print(f"no member of {engine}/{name} answered get_incidents",
              file=sys.stderr)
        return -1
    rows.sort(key=lambda m: m.get("hlc", 0))
    print(f"{engine}/{name}: {len(rows)} incident bundle(s) across "
          f"{scraped} node(s)")
    if rows:
        print(f"  {'id':<24} {'node':<22} {'age':>8} {'bytes':>9} "
              f"{'traces':>6}  reason")
        now = _time.time()
        for m in rows:
            age = now - float(m.get("ts", now))
            print(f"  {m.get('id', '?'):<24} {m.get('node', '?'):<22} "
                  f"{age:>7.0f}s {m.get('bytes', 0):>9} "
                  f"{len(m.get('trace_ids') or []):>6}  "
                  f"{m.get('reason', '')}")
    return 0


def render_autoscale_frame(doc: Dict[str, Any], ts: str = "",
                           journal_rows: int = 8) -> str:
    """One autoscaler status frame as text (pure; the JAX jubactl's text
    for the same doc, printed by --watch/--once): fleet signals,
    controller state, decision counters, per-replica rows, and the
    journal tail."""
    lines: List[str] = []
    fleet = doc.get("fleet") or {}
    st = doc.get("state") or {}
    counters = doc.get("counters") or {}
    cfg = doc.get("config") or {}
    lines.append(
        f"{doc.get('engine')}/{doc.get('name')} autoscaler"
        f"{'  ' + ts if ts else ''}  "
        f"fleet {fleet.get('replicas', '?')} replica(s) "
        f"[{cfg.get('min_replicas', '?')}..{cfg.get('max_replicas', '?')}]"
        f"  burn {fleet.get('burn_max', 0.0):g}"
        f"  queue/replica {fleet.get('queue_per_replica', 0.0):g}"
        f"  req/s {fleet.get('req_per_sec', 0.0):g}"
        + ("  [dry-run]" if cfg.get("dry_run") else ""))
    lines.append(
        f"  state: hot_streak {st.get('hot_streak', 0)}, "
        f"cold_streak {st.get('cold_streak', 0)}, "
        f"backoff_s {st.get('backoff_s', 0.0):g}; counters: "
        + ", ".join(f"{k.split('.', 1)[1]} {counters.get(k, 0)}"
                    for k in ("autoscale.decisions", "autoscale.spawns",
                              "autoscale.drains", "autoscale.blocked")))
    for r in doc.get("replicas") or []:
        mark = ("drain" if r.get("draining")
                else "DOWN" if not r.get("reachable", True) else "ok")
        lines.append(
            f"  {r.get('name', '?'):<22} {mark:<6} "
            f"req/s {r.get('req_per_sec', 0.0):>8.1f}  "
            f"p99 {r.get('p99_ms', 0.0):>8.1f} ms  "
            f"queue {r.get('queue_depth', 0.0):>8.0f}  "
            f"burn {r.get('burn_max', 0.0):>6.2f}"
            + ("  FIRING" if r.get("firing") else ""))
    tail = (doc.get("journal") or [])[-journal_rows:]
    moves = [j for j in tail if j.get("action") != "hold"] or tail[-3:]
    lines.append(f"  journal ({len(doc.get('journal') or [])} record(s) "
                 "retained):")
    for j in moves[-journal_rows:]:
        extra = ""
        if j.get("target"):
            extra += f" target={j['target']}"
        if j.get("count"):
            extra += f" count={j['count']}"
        if j.get("error"):
            extra += f" error={j['error'][:60]}"
        if j.get("backoff_s"):
            extra += f" backoff={j['backoff_s']:g}s"
        lines.append(f"    t={j.get('ts', 0):.1f}  "
                     f"{j.get('action', '?'):<10} {j.get('reason', ''):<18}"
                     f" {j.get('signals', {})}{extra}")
    return "\n".join(lines)


def _attach_autoscaler(coord: Coordinator) -> Optional[NodeInfo]:
    """First reachable registered autoscaler, or None."""
    for node in membership.get_autoscalers(coord):
        try:
            with RpcClient(node.host, node.port, timeout=5.0) as c:
                c.call("get_autoscale_status", "", 1)
            return node
        except Exception:  # noqa: BLE001 — stale ephemeral entry
            continue
    return None


def run_autoscale(coord: Coordinator, engine: str, name: str,
                  ns: Any) -> int:
    """The autoscaling control loop. Default: run the loop in the
    foreground (spawning via registered jubavisors, draining via the
    member drain RPC), serving ``get_autoscale_status``. With an
    autoscaler already registered, ``--watch``/``--once`` ATTACH to it
    and render its journal instead of starting a competing loop; a bare
    ``--once`` with no autoscaler running does one observe-only
    (dry-run) tick and renders it."""
    import time as _time

    from jubatus_tpu_torch.coord.autoscaler import (AutoscaleConfig,
                                                    Autoscaler, VisorActuator)

    remote = _attach_autoscaler(coord) if (ns.watch or ns.once) else None
    if remote is not None:
        print(f"attached to autoscaler {remote.name}", file=sys.stderr)
        while True:
            try:
                with RpcClient(remote.host, remote.port, timeout=10.0) as c:
                    per_node = c.call("get_autoscale_status", name, 32)
            except Exception as e:  # noqa: BLE001 — it may have exited
                print(f"autoscaler {remote.name} unreachable: {e}",
                      file=sys.stderr)
                return -1
            doc = next(iter((per_node or {}).values()), {})
            frame = render_autoscale_frame(doc, ts=_time.strftime("%H:%M:%S"))
            if ns.once:
                print(frame)
                return 0
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            try:
                _time.sleep(max(ns.interval, 0.2))
            except KeyboardInterrupt:
                return 0
    try:
        config = AutoscaleConfig(
            min_replicas=ns.as_min, max_replicas=ns.as_max,
            poll_interval_s=ns.autoscale_interval, window_s=ns.window,
            cooldown_s=ns.cooldown, scale_out_confirm=ns.scale_out_confirm,
            scale_in_confirm=ns.scale_in_confirm, burn_hot=ns.burn_hot,
            queue_hot=ns.queue_hot,
            dry_run=bool(ns.dry_run or ns.once)).validate()
    except ValueError as e:
        print(f"autoscale: {e}", file=sys.stderr)
        return 2
    if not ns.once and membership.get_autoscalers(coord):
        # a registered loop exists but did not answer — warn, continue
        print("warning: another autoscaler is registered for this "
              "coordinator (stale entry, or it will fight this one)",
              file=sys.stderr)
    actuator = VisorActuator(coord, engine, name, server_argv={
        "thread": ns.thread, "timeout": ns.timeout,
        "datadir": ns.datadir, "logdir": ns.logdir, "mixer": ns.mixer,
        "interval_sec": ns.interval_sec,
        "interval_count": ns.interval_count})
    scaler = Autoscaler(coord, engine, name, actuator, config=config)
    if ns.once:
        rec = scaler.tick()
        print(render_autoscale_frame(scaler.status()))
        return 0 if rec else -1
    port = scaler.serve(ns.autoscale_port)
    print(f"autoscaler for {engine}/{name} up "
          f"(get_autoscale_status on 127.0.0.1:{port}, "
          f"bounds [{config.min_replicas}..{config.max_replicas}]"
          + (", DRY RUN)" if config.dry_run else ")"), file=sys.stderr)
    try:
        while True:
            scaler.tick()
            if ns.watch:
                frame = render_autoscale_frame(
                    scaler.status(), ts=_time.strftime("%H:%M:%S"))
                sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
                sys.stdout.flush()
            _time.sleep(max(config.poll_interval_s, 0.2))
    except KeyboardInterrupt:
        return 0
    finally:
        scaler.stop()


def main(argv: Optional[List[str]] = None) -> int:
    ns = _parser().parse_args(argv)
    spec = resolve_coordinator(ns.coordinator)
    if not spec:
        print("no coordinator: pass -z or set JUBATUS_COORDINATOR/ZK",
              file=sys.stderr)
        return 1
    coord = create_coordinator(spec)
    try:
        if ns.cmd == "status":
            return show_status(coord, ns.type, ns.name, show_all=ns.all)
        if ns.cmd == "metrics":
            return show_metrics(coord, ns.type, ns.name)
        if ns.cmd == "breakers":
            return show_breakers(coord, ns.type, ns.name)
        if ns.cmd == "trace":
            return show_trace(coord, ns.type, ns.name, ns.trace_id)
        if ns.cmd == "alerts":
            return show_alerts(coord, ns.type, ns.name)
        if ns.cmd == "quality":
            return show_quality(coord, ns.type, ns.name)
        if ns.cmd == "usage":
            return show_usage(coord, ns.type, ns.name, top=ns.top)
        if ns.cmd == "tune":
            return show_tune(coord, ns.type, ns.name)
        if ns.cmd == "autoscale":
            return run_autoscale(coord, ns.type, ns.name, ns)
        if ns.cmd == "watch":
            return show_watch(coord, ns.type, ns.name, once=ns.once,
                              interval=ns.interval, window_s=ns.window)
        if ns.cmd == "timeline":
            return show_timeline(coord, ns.type, ns.name,
                                 since_s=ns.since, grep=ns.grep,
                                 follow=ns.follow, interval=ns.interval)
        if ns.cmd == "incident":
            return show_incidents(coord, ns.type, ns.name, pull=ns.pull)
        if ns.cmd == "profile":
            return show_profile(coord, ns.type, ns.name,
                                seconds=ns.seconds, folded=ns.folded,
                                top=ns.top, device=ns.device,
                                device_seconds=ns.device_seconds)
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
                "timeout": ns.timeout, "datadir": ns.datadir,
                "logdir": ns.logdir, "mixer": ns.mixer,
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
