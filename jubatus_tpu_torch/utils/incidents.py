"""Automatic incident forensics bundles (copy of
``jubatus_tpu/utils/incidents.py``).

When an SLO transitions to firing or /healthz goes degraded, the first
question is always the same: what did the cluster look like *right
then*? By the time an operator runs the forensics RPCs by hand, the
rings have rotated and the moment is gone. The IncidentManager snapshots
the correlated state AT the transition — the event-journal window, the
metric time-series window, slow-log entries, mix flight records, the
profiler's tail snapshots, breaker/health state — into one JSON bundle
in a capped artifacts dir.

- **Debounced**: one capture per ``--incident-window`` (default 300 s);
  a storm of SLO flaps produces one bundle per window, with the
  suppressed triggers counted (``incident.suppressed``).
- **Capped**: at most ``capacity`` bundles on disk; the oldest is
  pruned (same stance as the device-capture dir).
- **Owner-assembled**: the owning server/proxy supplies a ``collector``
  callable that builds the forensic doc from its own rings — the
  manager owns only the trigger discipline, artifact naming, disk cap,
  and the ``list``/``get`` surface behind the ``get_incidents`` RPC and
  ``jubactl -c incident [--list | --pull ID]``.

Bundle identity: ``inc-<hlc-hex>`` — the capturing process's HLC tick,
which also orders bundles against the event timeline they snapshot.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from jubatus_tpu_torch.utils import events

log = logging.getLogger(__name__)

#: bundles kept on disk; the oldest is pruned past this
DEFAULT_CAPACITY = 16
#: default debounce window (seconds); 0 disables auto-capture entirely
DEFAULT_WINDOW_S = 300.0


class IncidentManager:
    """Trigger discipline + artifact store for one server/proxy."""

    def __init__(self, registry: Any,
                 collector: Callable[[], Dict[str, Any]],
                 dir_fn: Callable[[], str],
                 window_s: float = DEFAULT_WINDOW_S,
                 capacity: int = DEFAULT_CAPACITY,
                 journal: Optional[events.EventJournal] = None) -> None:
        self.registry = registry
        self.collector = collector
        #: resolved lazily — the default dir carries the BOUND rpc port,
        #: which an ephemeral-port start only knows at serve time
        self.dir_fn = dir_fn
        self.window_s = float(window_s)
        self.capacity = max(1, int(capacity))
        self.journal = journal
        self._lock = threading.Lock()
        self._last_capture = 0.0  # monotonic
        self.captured = 0
        self.suppressed = 0
        self.last_id = ""
        self.last_error = ""

    @property
    def enabled(self) -> bool:
        return self.window_s > 0

    # -- trigger --------------------------------------------------------------
    def trigger(self, reason: str,
                trace_ids: Optional[List[str]] = None,
                force: bool = False) -> Optional[Dict[str, Any]]:
        """Maybe capture one bundle. Debounced to once per window
        (``force=True`` bypasses — the operator's manual capture path).
        Never raises: a broken collector must not take down the
        telemetry tick that fired the trigger."""
        if not self.enabled and not force:
            return None
        now = time.monotonic()
        with self._lock:
            if not force and self._last_capture and \
                    now - self._last_capture < self.window_s:
                self.suppressed += 1
                if self.registry is not None:
                    self.registry.count("incident.suppressed")
                return None
            self._last_capture = now
        try:
            return self._capture(reason, trace_ids or [])
        except Exception as e:  # broad-ok — forensics must never harm serving
            self.last_error = repr(e)[:200]
            log.warning("incident capture failed (%s)", reason,
                        exc_info=True)
            return None

    def _capture(self, reason: str,
                 trace_ids: List[str]) -> Dict[str, Any]:
        h = events.hlc_now()
        incident_id = f"inc-{h:x}"
        doc: Dict[str, Any] = {
            "id": incident_id,
            "reason": reason,
            "hlc": h,
            "ts": round(events.hlc_wall_s(h), 3),
            "trace_ids": [t for t in trace_ids if t],
        }
        doc.update(self.collector() or {})
        path = self._write(incident_id, doc)
        doc["path"] = path
        self.captured += 1
        self.last_id = incident_id
        if self.registry is not None:
            self.registry.count("incident.captured")
        if self.journal is not None:
            self.journal.emit("incident", "captured", severity="warning",
                              id=incident_id, reason=reason,
                              bundle_trace_ids=len(doc["trace_ids"]))
        log.warning("incident bundle captured: %s (%s) -> %s",
                    incident_id, reason, path)
        return doc

    # -- disk -----------------------------------------------------------------
    def _dir(self) -> str:
        d = self.dir_fn()
        os.makedirs(d, exist_ok=True)
        return d

    def _write(self, incident_id: str, doc: Dict[str, Any]) -> str:
        d = self._dir()
        path = os.path.join(d, f"{incident_id}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, default=str)
        os.replace(tmp, path)
        self._prune(d)
        return path

    def _prune(self, d: str) -> None:
        bundles = sorted(
            f for f in os.listdir(d)
            if f.startswith("inc-") and f.endswith(".json"))
        # inc-<hlc-hex> names sort chronologically only at equal width;
        # sort by mtime to stay honest across clock jumps
        bundles.sort(key=lambda f: os.path.getmtime(os.path.join(d, f)))
        for f in bundles[:max(0, len(bundles) - self.capacity)]:
            try:
                os.remove(os.path.join(d, f))
            except OSError:
                pass

    # -- query surface (get_incidents RPC) ------------------------------------
    def list(self) -> Dict[str, Any]:
        """Bundle index from the artifacts dir (survives restarts)."""
        try:
            d = self._dir()
        except OSError as e:
            return {"dir": "", "error": str(e), "incidents": [],
                    "stats": self.stats()}
        out: List[Dict[str, Any]] = []
        for f in sorted(os.listdir(d)):
            if not (f.startswith("inc-") and f.endswith(".json")):
                continue
            path = os.path.join(d, f)
            meta = {"id": f[:-len(".json")],
                    "bytes": os.path.getsize(path)}
            try:
                with open(path) as fh:
                    doc = json.load(fh)
                meta["reason"] = doc.get("reason", "")
                meta["ts"] = doc.get("ts", 0.0)
                meta["hlc"] = doc.get("hlc", 0)
                meta["trace_ids"] = doc.get("trace_ids") or []
            except (OSError, json.JSONDecodeError) as e:
                meta["error"] = str(e)
            out.append(meta)
        out.sort(key=lambda m: m.get("hlc", 0))
        return {"dir": d, "incidents": out, "stats": self.stats()}

    def get(self, incident_id: str) -> Dict[str, Any]:
        incident_id = str(incident_id)
        if os.sep in incident_id or not incident_id.startswith("inc-"):
            return {"error": f"bad incident id {incident_id!r}"}
        try:
            path = os.path.join(self._dir(), f"{incident_id}.json")
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return {"error": f"{incident_id}: {e}"}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"captured": self.captured,
                    "suppressed": self.suppressed,
                    "window_s": self.window_s,
                    "capacity": self.capacity,
                    "last_id": self.last_id,
                    "last_error": self.last_error}
