"""Tenant-level resource attribution & capacity accounting (copy of
``jubatus_tpu/utils/usage.py``).

The tracing plane measures *how fast* the system is; this module
measures *who is spending it*. Every dispatched request is attributed
to a **principal** (the tenant id riding the envelope's optional 7th
element, ``rpc/principal.py``); per principal × method the ledger
accounts:

- request / error / retry counts,
- **CPU-thread-seconds** from the span plane: the registry's
  ``usage_sink`` feeds every ``rpc.<method>`` span duration here while
  the dispatch thread still holds the request's principal,
- **coalescer residency**: queue-wait seconds plus device-batch time
  amortized by rows contributed per flush (``server/microbatch.py``
  tickets carry the principal),
- bytes in / out.

Traffic that names no principal folds into ``(untagged)``; the
system's own work (mix, telemetry, store, migration) into
``(system)`` — the books always close, which the bench proves with a
**conservation gate**: per-principal accounted CPU sums to within 10%
of the process's span-plane total (``e2e_usage_attribution_err_frac``).

Cardinality is bounded two ways (zipf users must not blow the ledger
up): an EXACT table for the first ``top`` (64) principals with the
long tail folded into ``(other)``, plus a :class:`CategoricalSketch`
heavy-hitter lane that keeps identifying heavy principals even past
the cap and merges exactly across the fleet (the quality plane's machinery).

The **capacity model** layers on top: per tick, per-principal demand
(rows/s and CPU-share deltas) is compared against the replica's
measured flush throughput — the same signal the autoscaler uses — and
published as ``usage.<principal>.*`` / ``capacity.*`` gauges, SLO-able
via the existing ``gauge:`` grammar. ``capacity.saturation``
(demand/capacity, alarms HIGH — the ``gauge:`` grammar fires on high
means) is the SLO form; ``capacity.headroom`` is its up-good
complement for operators and benches.

``server/base.py`` ticks the ledger from the telemetry thread and
ships ``snapshot()`` through the idempotent ``get_usage`` RPC;
``merge_usage`` is the proxy/CLI fold (table sum + sketch merge —
never gauge averaging).
"""

from __future__ import annotations

import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from jubatus_tpu_torch.rpc import principal as principals
from jubatus_tpu_torch.utils import sketches

#: exact-table row fields, in wire order (snapshot rows are lists —
#: compact on the wire, summed element-wise in the fold)
FIELDS = ("requests", "errors", "retries", "cpu_seconds",
          "queue_seconds", "device_seconds", "rows",
          "bytes_in", "bytes_out")
_NFIELDS = len(FIELDS)
_IDX = {f: i for i, f in enumerate(FIELDS)}

#: the ledger row the exact table's long tail folds into once ``top``
#: distinct principals exist (the sketch lane still sees everyone)
OVERFLOW = "(other)"

#: a request with no principal on an un-tenanted method is the
#: system's own work: mix rounds, telemetry/forensics reads, store
#: uploads, migration/drain, autoscaler actuation. Anything else
#: untagged is user traffic from a client that never stamped a tenant.
_SYSTEM_METHOD_RE = re.compile(
    r"^(mix|do_mix|get_|put_|take_|save|load|clear|store|migrate|"
    r"drain|rebalance|rollback|restore|warm|snapshot|diff|iterate|"
    r"profile|bootstrap|name|version)")

#: gauge keys must stay shell/dot safe; tenant ids are operator input
_SANITIZE_RE = re.compile(r"[^A-Za-z0-9_-]")


def classify(principal: Optional[str], method: str) -> str:
    """Resolve the ledger row a request bills to: its wire principal,
    else ``(system)`` for the fleet's own methods, else
    ``(untagged)``."""
    if principal:
        return principal
    if _SYSTEM_METHOD_RE.match(method or ""):
        return principals.SYSTEM
    return principals.UNTAGGED


def sanitize(principal: str) -> str:
    """A principal as a gauge-key segment (dots would splice into the
    metric namespace, so every non-word char folds to ``_``)."""
    return _SANITIZE_RE.sub("_", principal) or "_"


class UsageLedger:
    """Per-process principal × method resource ledger. All entry
    points are thread-safe (one lock; record paths are O(1) dict
    bumps) and every accumulator is mergeable across the fleet."""

    def __init__(self, *, top: int = 64, gauge_principals: int = 8,
                 registry: Any = None) -> None:
        self.top = max(1, int(top))
        self.gauge_principals = max(1, int(gauge_principals))
        self.registry = registry
        self._lock = threading.Lock()
        #: principal -> method -> [FIELDS...] (exact, bounded)
        self._table: Dict[str, Dict[str, List[float]]] = {}
        #: heavy-hitter lane: observes EVERY principal by rows+requests
        #: weight, so heavy tenants stay identifiable past the cap
        self._sketch = sketches.CategoricalSketch()
        self._capacity = 0.0
        self._last_ts: Optional[float] = None
        self._last_rows: Dict[str, float] = {}
        self._last_cpu: Dict[str, float] = {}
        self._demand: Dict[str, float] = {}
        self._cpu_share: Dict[str, float] = {}

    # -- recording -----------------------------------------------------------
    def _row_locked(self, principal: str, method: str) -> List[float]:
        by_m = self._table.get(principal)
        if by_m is None:
            if len(self._table) >= self.top and principal not in \
                    (principals.UNTAGGED, principals.SYSTEM, OVERFLOW):
                principal = OVERFLOW
                by_m = self._table.get(principal)
                if by_m is None:
                    by_m = self._table[principal] = {}
            else:
                by_m = self._table[principal] = {}
        row = by_m.get(method)
        if row is None:
            row = by_m[method] = [0.0] * _NFIELDS
        return row

    def account(self, method: str, *, principal: Optional[str] = None,
                resolve: bool = True, **amounts: float) -> None:
        """The core accumulator: bump ``FIELDS`` amounts for one
        principal × method cell. ``principal=None`` with ``resolve``
        reads the dispatch thread's principal and classifies."""
        if principal is None and resolve:
            principal = principals.current()
        p = classify(principal, method)
        with self._lock:
            row = self._row_locked(p, method)
            for k, v in amounts.items():
                row[_IDX[k]] += v
            if amounts.get("requests") or amounts.get("rows"):
                self._sketch.observe(
                    p, int(amounts.get("requests", 0))
                    + int(amounts.get("rows", 0)))

    def span_sink(self, name: str, seconds: float) -> None:
        """Registry ``usage_sink`` hook: every completed span lands
        here. Server dispatch spans are ``rpc.<method>`` and fire while
        the dispatch thread still holds the request's principal — each
        one is one request plus its CPU-thread-seconds. Client-side
        spans (``rpc.client.*``) are the same work seen from the
        caller; counting them would double-bill, so they're skipped."""
        if not name.startswith("rpc.") or name.startswith("rpc.client."):
            return
        self.account(name[4:], requests=1, cpu_seconds=float(seconds))

    def note_error(self, method: str) -> None:
        self.account(method, errors=1)

    def note_retry(self, method: str) -> None:
        self.account(method, retries=1)

    def note_bytes(self, method: str, bytes_in: int = 0,
                   bytes_out: int = 0) -> None:
        self.account(method, bytes_in=float(bytes_in),
                     bytes_out=float(bytes_out))

    def record_batch(self, principal: Optional[str], method: str,
                     rows: float, queue_seconds: float,
                     device_seconds: float) -> None:
        """Coalescer completion hook: one ticket's share of a device
        flush — ``rows`` it contributed, its queue residency, and the
        flush's device time amortized by rows (microbatch carries the
        submitting thread's principal on the ticket)."""
        self.account(method, principal=principal, rows=float(rows),
                     queue_seconds=float(queue_seconds),
                     device_seconds=float(device_seconds))

    # -- capacity model ------------------------------------------------------
    def tick(self, capacity_rows_per_sec: float = 0.0,
             now: Optional[float] = None) -> Dict[str, float]:
        """One telemetry tick: recompute per-principal demand from the
        deltas since the last tick, compare against the replica's
        measured capacity, publish the ``usage.*`` / ``capacity.*``
        gauges. Returns the gauge dict (tests read it directly)."""
        now = time.time() if now is None else float(now)
        if capacity_rows_per_sec > 0.0:
            self._capacity = float(capacity_rows_per_sec)
        with self._lock:
            rows_now: Dict[str, float] = {}
            cpu_now: Dict[str, float] = {}
            for p, by_m in self._table.items():
                rows_now[p] = sum(
                    r[_IDX["rows"]] + r[_IDX["requests"]]
                    for r in by_m.values())
                cpu_now[p] = sum(r[_IDX["cpu_seconds"]]
                                 for r in by_m.values())
            dt = 0.0 if self._last_ts is None else now - self._last_ts
            if dt > 0.0:
                self._demand = {
                    p: max(0.0, (v - self._last_rows.get(p, 0.0)) / dt)
                    for p, v in rows_now.items()}
                self._cpu_share = {
                    p: max(0.0, (v - self._last_cpu.get(p, 0.0)) / dt)
                    for p, v in cpu_now.items()}
            self._last_ts = now
            self._last_rows = rows_now
            self._last_cpu = cpu_now
            demand = dict(self._demand)
            cpu_share = dict(self._cpu_share)
            nprincipals = len(self._table)
            cap = self._capacity
        gauges: Dict[str, float] = {"usage.principals": float(nprincipals)}
        # top-N principals by current demand (CPU-share breaks ties):
        # the gauge namespace stays bounded no matter the tenant count
        ranked = sorted(demand,
                        key=lambda p: (demand.get(p, 0.0),
                                       cpu_share.get(p, 0.0)),
                        reverse=True)[:self.gauge_principals]
        for p in ranked:
            s = sanitize(p)
            gauges[f"usage.{s}.demand_rows_per_sec"] = \
                round(demand.get(p, 0.0), 3)
            gauges[f"usage.{s}.cpu_share"] = \
                round(cpu_share.get(p, 0.0), 6)
        total_demand = sum(demand.values())
        if cap > 0.0:
            sat = total_demand / cap
            gauges["capacity.rows_per_sec"] = round(cap, 1)
            gauges["capacity.saturation"] = round(sat, 4)
            gauges["capacity.headroom"] = round(max(0.0, 1.0 - sat), 4)
        reg = self.registry
        if reg is not None:
            for k, v in gauges.items():
                reg.gauge(k, v)
        return gauges

    # -- views ---------------------------------------------------------------
    def totals(self) -> Dict[str, float]:
        """Process-wide sums over every principal × method cell — the
        side of the books the conservation gate compares against the
        span plane."""
        with self._lock:
            out = {f: 0.0 for f in FIELDS}
            for by_m in self._table.values():
                for row in by_m.values():
                    for i, f in enumerate(FIELDS):
                        out[f] += row[i]
            return out

    def snapshot(self) -> Dict[str, Any]:
        """This node's mergeable usage doc — the ``get_usage`` RPC
        payload (exact table, sketch state, capacity + last demand)."""
        with self._lock:
            return {
                "top": self.top,
                "table": {p: {m: list(r) for m, r in by_m.items()}
                          for p, by_m in self._table.items()},
                "sketch": self._sketch.state(),
                "capacity_rows_per_sec": self._capacity,
                "demand": {p: round(v, 3)
                           for p, v in self._demand.items()},
                "cpu_share": {p: round(v, 6)
                              for p, v in self._cpu_share.items()},
                "ts": time.time(),
            }

    def incident_doc(self) -> Dict[str, Any]:
        """The forensic slice an incident bundle captures: who was
        spending the replica when it breached — top principals by CPU
        with their full rows, plus the capacity picture."""
        with self._lock:
            cpu = {p: sum(r[_IDX["cpu_seconds"]] for r in by_m.values())
                   for p, by_m in self._table.items()}
            top = sorted(cpu, key=lambda p: cpu[p],
                         reverse=True)[:self.gauge_principals]
            doc: Dict[str, Any] = {
                "capacity_rows_per_sec": self._capacity,
                "demand": {p: round(v, 3)
                           for p, v in self._demand.items()},
                "top_principals": {
                    p: {m: dict(zip(FIELDS, r))
                        for m, r in self._table[p].items()}
                    for p in top},
            }
            return doc

    def stats(self) -> Dict[str, Any]:
        """Flat stat rows for get_status (``usage.*`` keys)."""
        with self._lock:
            cpu = {p: sum(r[_IDX["cpu_seconds"]] for r in by_m.values())
                   for p, by_m in self._table.items()}
            reqs = sum(r[_IDX["requests"]] for by_m in self._table.values()
                       for r in by_m.values())
            demand = dict(self._demand)
            cap = self._capacity
        # the watch column wants ONE name: the principal currently
        # demanding the most (CPU breaks the no-demand-yet tie)
        top = max(demand or cpu, key=lambda p: (demand.get(p, 0.0),
                                                cpu.get(p, 0.0)),
                  default="")
        out: Dict[str, Any] = {
            "principals": len(cpu),
            "requests": int(reqs),
            "cpu_seconds": round(sum(cpu.values()), 3),
            "top_principal": top,
            "top_demand_rows_per_sec": round(demand.get(top, 0.0), 1),
        }
        if cap > 0.0:
            sat = sum(demand.values()) / cap
            out["capacity_rows_per_sec"] = round(cap, 1)
            out["headroom"] = round(max(0.0, 1.0 - sat), 4)
        return out


# -- client-retry fan-in ----------------------------------------------------

#: ledgers attached for retry attribution: the RPC *client* sees the
#: retry (the server just sees another request), so the client layer
#:  notes it into whatever ledgers this process runs
_ATTACHED: List[UsageLedger] = []
_ATTACH_LOCK = threading.Lock()


def attach(ledger: UsageLedger) -> None:
    with _ATTACH_LOCK:
        if ledger not in _ATTACHED:
            _ATTACHED.append(ledger)


def detach(ledger: UsageLedger) -> None:
    with _ATTACH_LOCK:
        if ledger in _ATTACHED:
            _ATTACHED.remove(ledger)


def note_retry(method: str) -> None:
    """Client-layer hook: one retried attempt on ``method`` (billed to
    the calling thread's principal in every attached ledger)."""
    with _ATTACH_LOCK:
        targets = list(_ATTACHED)
    for led in targets:
        led.note_retry(method)


# -- fleet fold -------------------------------------------------------------

def merge_usage(docs: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-node ``get_usage`` docs into one fleet view: sum the
    exact tables cell-wise (re-folding the long tail once the union
    passes the cap), MERGE the heavy-hitter sketches (that is what
    mergeable sketches buy — fleet heavy hitters are exact, not an
    average of node top-ks), and SUM capacity/demand across replicas
    (capacity is additive over a fleet; headroom is recomputed from
    the sums, never averaged)."""
    table: Dict[str, Dict[str, List[float]]] = {}
    demand: Dict[str, float] = {}
    cpu_share: Dict[str, float] = {}
    states: List[Dict[str, Any]] = []
    cap = 0.0
    top = 64
    for d in docs:
        if not d:
            continue
        top = max(top, int(d.get("top", 0)))
        cap += float(d.get("capacity_rows_per_sec", 0.0))
        for p, v in (d.get("demand") or {}).items():
            demand[p] = demand.get(p, 0.0) + float(v)
        for p, v in (d.get("cpu_share") or {}).items():
            cpu_share[p] = cpu_share.get(p, 0.0) + float(v)
        if d.get("sketch"):
            states.append(d["sketch"])
        for p, by_m in (d.get("table") or {}).items():
            dst = table.setdefault(p, {})
            for m, row in by_m.items():
                acc = dst.setdefault(m, [0.0] * _NFIELDS)
                for i in range(min(_NFIELDS, len(row))):
                    acc[i] += float(row[i])
    if len(table) > top:  # union overflow: re-fold the smallest tails
        cpu = {p: sum(r[_IDX["cpu_seconds"]] + r[_IDX["requests"]]
                      for r in by_m.values())
               for p, by_m in table.items()}
        keep = set(sorted(
            cpu, key=lambda p: cpu[p], reverse=True)[:top]) \
            | {principals.UNTAGGED, principals.SYSTEM, OVERFLOW}
        fold = table.setdefault(OVERFLOW, {})
        for p in [p for p in table if p not in keep and p != OVERFLOW]:
            for m, row in table.pop(p).items():
                acc = fold.setdefault(m, [0.0] * _NFIELDS)
                for i in range(_NFIELDS):
                    acc[i] += row[i]
    total_demand = sum(demand.values())
    out: Dict[str, Any] = {
        "nodes": len([d for d in docs if d]),
        "top": top,
        "table": table,
        "sketch": sketches.merge_categorical_states(states),
        "capacity_rows_per_sec": round(cap, 1),
        "demand": {p: round(v, 3) for p, v in demand.items()},
        "cpu_share": {p: round(v, 6) for p, v in cpu_share.items()},
    }
    if cap > 0.0:
        sat = total_demand / cap
        out["saturation"] = round(sat, 4)
        out["headroom"] = round(max(0.0, 1.0 - sat), 4)
    return out


def principal_rows(doc: Dict[str, Any]) -> List[Tuple[str, Dict[str, float]]]:
    """A (merged or single-node) usage doc as per-principal summary
    rows sorted by CPU-seconds — the ``jubactl -c usage`` render
    order."""
    out: List[Tuple[str, Dict[str, float]]] = []
    for p, by_m in (doc.get("table") or {}).items():
        agg = {f: 0.0 for f in FIELDS}
        for row in by_m.values():
            for i, f in enumerate(FIELDS):
                agg[f] += float(row[i]) if i < len(row) else 0.0
        agg["methods"] = float(len(by_m))
        agg["demand_rows_per_sec"] = float(
            (doc.get("demand") or {}).get(p, 0.0))
        out.append((p, agg))
    out.sort(key=lambda kv: (kv[1]["cpu_seconds"], kv[1]["requests"]),
             reverse=True)
    return out
