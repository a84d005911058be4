"""Mix admission guard and model snapshot ring (copy of
``jubatus_tpu/framework/model_guard.py``).

Mix is model averaging, so one replica gone sick (a NaN from a bad datum,
a norm-exploded diff from a runaway learner) poisons every peer's weights
in a single round. **MixGuard** is the fold-time admission screen shared
by the sync master (``linear_mixer._run_as_master``), the async fold
(``async_mixer._weighted_fold``), the async inbox (``local_submit_diff``)
and the push exchange. Two screens, in order:

* **finite screen** — any non-finite element in a summable mixable's
  diff rejects the contribution outright (NaN is absorbing under
  addition);
* **norm screen** — a contribution whose update norm exceeds
  ``--mix-norm-bound`` × the median of its PEERS' norms this round is an
  outlier (leave-one-out median). An all-quiet baseline judges nothing.

Verdicts feed a per-member quarantine breaker. Mode ladder
(``--mix-guard``): ``off`` — no screening; ``warn`` — screen, count, emit,
fold everything anyway; ``quarantine`` — drop screened-out contributions,
and refuse a non-finite folded total at apply time.

**ModelSnapshotRing** is a bounded ring of periodic in-process model
snapshots in the save_load envelope format (48-byte header + CRC32), so a
restore revalidates integrity exactly like a checkpoint load. ``put_diff``
refusing a non-finite folded total rolls the server back to the newest
snapshot (server/base.py wires the callback); ``rollback`` does it by RPC.
The snapshot packs the model under the driver's lock: ``driver.pack()``
reads the device state back to the host there.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from jubatus_tpu_torch.utils.tree import tree_leaves

GUARD_MODES = ("off", "warn", "quarantine")

#: consecutive screened offenses that trip the per-member quarantine
#: breaker, and consecutive clean screens that release it
DEFAULT_QUARANTINE_AFTER = 2
DEFAULT_RELEASE_AFTER = 3


def norm_mode(mode: Any) -> str:
    m = (mode or "off").lower() if isinstance(mode, str) else \
        ("quarantine" if mode else "off")
    if m not in GUARD_MODES:
        raise ValueError(f"unknown mix guard mode {mode!r}; "
                         f"expected one of {GUARD_MODES}")
    return m


def tree_nonfinite(tree: Any) -> bool:
    """True when any element of any leaf is NaN/Inf. Leaves are host
    numpy on every screened path (mix payloads materialize before the
    wire); a stray device leaf round-trips through np.asarray."""
    for leaf in tree_leaves(tree):
        a = np.asarray(leaf)
        if a.dtype == object:
            continue  # non-numeric custom leaf: not summable anyway
        if not np.isfinite(a).all():
            return True
    return False


def payload_nonfinite(diffs: Dict[str, Any], names: List[str]) -> bool:
    """Finite screen over one contribution's SUMMABLE mixables (the
    ones whose fold is addition, where NaN is absorbing)."""
    return any(name in diffs and tree_nonfinite(diffs[name])
               for name in names)


def payload_norm(diffs: Dict[str, Any], names: List[str]) -> float:
    """L2 norm of one contribution over the summable mixables — the
    quantity the norm screen compares across the round's peers."""
    s = 0.0
    for name in names:
        if name not in diffs:
            continue
        for leaf in tree_leaves(diffs[name]):
            a = np.asarray(leaf)
            if a.dtype == object:
                continue
            d = a * 1.0
            s += float((d * d).sum())
    return math.sqrt(s)


def norm_outliers(norms: Dict[str, float], bound: float) -> Dict[str, float]:
    """member -> peer-median baseline, for every member whose norm
    exceeds ``bound`` × the median of the OTHER members' norms.
    Leave-one-out keeps the screen honest at small N (with two
    contributors, a 1e6-scaled diff is judged against its healthy peer,
    not a median it dominates). A non-positive peer baseline judges
    nothing: on a quiet fleet there is no evidence of normal scale."""
    out: Dict[str, float] = {}
    if bound <= 0 or len(norms) < 2:
        return out
    for member, n in norms.items():
        others = [v for m, v in norms.items() if m != member]
        base = float(np.median(others))
        if base > 0.0 and n > bound * base:
            out[member] = base
    return out


class GuardReport:
    """One round's screening outcome: what folds, what was flagged and
    why, and the breaker transitions the mixer turns into counters and
    timeline events."""

    __slots__ = ("admitted", "flagged", "norms", "quarantined_now",
                 "released")

    def __init__(self) -> None:
        self.admitted: Dict[str, Dict[str, Any]] = {}
        #: member -> reason in {"nonfinite", "norm_outlier", "quarantined"}
        self.flagged: Dict[str, str] = {}
        self.norms: Dict[str, float] = {}
        self.quarantined_now: List[str] = []
        self.released: List[str] = []


class MixGuard:
    """Fold-time admission guard + per-member quarantine breaker.
    Thread-safe: a master round may run from the mixer thread or from an
    RPC worker (``do_mix``)."""

    def __init__(self, mode: Any = "off", norm_bound: float = 10.0,
                 quarantine_after: int = DEFAULT_QUARANTINE_AFTER,
                 release_after: int = DEFAULT_RELEASE_AFTER) -> None:
        self.mode = norm_mode(mode)
        self.norm_bound = float(norm_bound)
        self.quarantine_after = int(quarantine_after)
        self.release_after = int(release_after)
        self._lock = threading.Lock()
        self._offenses: Dict[str, int] = {}
        self._clean: Dict[str, int] = {}
        self._quarantined: Dict[str, float] = {}  # member -> since ts
        #: lifetime totals (mirrored into counters by the owning mixer;
        #: kept here too so get_status works without registry plumbing)
        self.screened = 0
        self.rejected = 0

    @property
    def enabled(self) -> bool:
        return self.mode != "off"

    def is_quarantined(self, member: str) -> bool:
        with self._lock:
            return member in self._quarantined

    def _note_offense(self, member: str) -> bool:
        """Record one screened offense; True when it TRIPS the breaker
        (caller emits the quarantine event exactly once)."""
        with self._lock:
            self._clean.pop(member, None)
            if member in self._quarantined:
                return False
            n = self._offenses.get(member, 0) + 1
            self._offenses[member] = n
            if self.mode == "quarantine" and n >= self.quarantine_after:
                self._quarantined[member] = time.monotonic()
                self._offenses.pop(member, None)
                return True
        return False

    def _note_clean(self, member: str) -> bool:
        """Record one clean screen; True when it RELEASES the member
        from quarantine (K consecutive clean rounds)."""
        with self._lock:
            self._offenses.pop(member, None)
            if member not in self._quarantined:
                return False
            n = self._clean.get(member, 0) + 1
            self._clean[member] = n
            if n >= self.release_after:
                del self._quarantined[member]
                del self._clean[member]
                return True
        return False

    def screen(self, entries: Dict[str, Dict[str, Any]],
               names: List[str]) -> GuardReport:
        """Screen one round's contributions (member -> diffs). In
        quarantine mode, ``admitted`` excludes flagged members and
        members already behind the breaker; warn mode admits everything
        and only reports. ``off`` short-circuits (no screening cost)."""
        rep = GuardReport()
        if not self.enabled or not entries:
            rep.admitted = dict(entries)
            return rep
        self.screened += len(entries)
        verdicts: Dict[str, Optional[str]] = {}
        finite_members: Dict[str, Dict[str, Any]] = {}
        for member, diffs in entries.items():
            if payload_nonfinite(diffs, names):
                verdicts[member] = "nonfinite"
            else:
                finite_members[member] = diffs
                rep.norms[member] = payload_norm(diffs, names)
        for member, base in norm_outliers(rep.norms,
                                          self.norm_bound).items():
            verdicts[member] = "norm_outlier"
        for member, diffs in entries.items():
            reason = verdicts.get(member)
            quarantined = self.is_quarantined(member)
            if reason is None:
                if self._note_clean(member):
                    rep.released.append(member)
                    quarantined = False
            else:
                if self._note_offense(member):
                    rep.quarantined_now.append(member)
                    quarantined = True
                rep.flagged[member] = reason
            if self.mode == "quarantine" and quarantined and \
                    member not in rep.flagged:
                # behind the breaker: clean rounds count toward release
                # but the contribution stays out of the fold until K
                rep.flagged[member] = "quarantined"
            if self.mode == "quarantine" and member in rep.flagged:
                self.rejected += 1
                continue
            rep.admitted[member] = diffs
        return rep

    def screen_payload(self, member: str, diffs: Dict[str, Any],
                       names: List[str]) -> Optional[str]:
        """Single-payload admission screen (the async inbox, the push
        exchange): the finite screen plus the breaker — no peer
        distribution exists yet, so norm outliers are judged at fold
        time. Returns the flag reason ("nonfinite" / "quarantined") or
        None; the caller REJECTS only in quarantine mode (warn flags and
        admits). A quarantined member's clean payload still counts
        toward its K-clean release."""
        if not self.enabled:
            return None
        self.screened += 1
        if payload_nonfinite(diffs, names):
            self._note_offense(member)
            if self.mode == "quarantine":
                self.rejected += 1
            return "nonfinite"
        if self.mode == "quarantine" and self.is_quarantined(member):
            self._note_clean(member)
            if self.is_quarantined(member):
                self.rejected += 1
                return "quarantined"
        return None

    def quarantined(self) -> Dict[str, float]:
        """member -> seconds in quarantine (status/watch view)."""
        now = time.monotonic()
        with self._lock:
            return {m: round(now - t, 1)
                    for m, t in self._quarantined.items()}

    def status(self) -> Dict[str, Any]:
        with self._lock:
            q = sorted(self._quarantined)
            offenses = dict(self._offenses)
        return {
            "guard_mode": self.mode,
            "guard_norm_bound": self.norm_bound,
            "guard_screened": self.screened,
            "guard_rejected": self.rejected,
            "guard_quarantined": q,
            "guard_offense_streaks": offenses,
        }


class ModelSnapshotRing:
    """Bounded ring of in-process model snapshots — the rollback
    plane's "last good". Entries are full save_load envelopes (header +
    CRC32 + system + user sections), so ``restore`` revalidates exactly
    like a checkpoint load: a snapshot that rotted in RAM refuses to
    apply instead of substituting one corruption for another."""

    def __init__(self, capacity: int = 4) -> None:
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._ring: List[Dict[str, Any]] = []
        self.taken = 0
        self.restored = 0

    def snapshot(self, driver, model_version: int) -> Dict[str, Any]:
        """Capture one snapshot. The caller holds the driver's model
        lock — pack() must see a quiescent model."""
        from jubatus_tpu_torch.utils.serialization import pack_obj

        system = {"version": 1, "timestamp": int(time.time()),  # wall-clock
                  "type": driver.TYPE, "id": "snapshot",
                  "model_version": int(model_version), "config": ""}
        from jubatus_tpu_torch.framework.save_load import pack_envelope

        blob = pack_envelope(
            pack_obj(system),
            pack_obj([driver.USER_DATA_VERSION, driver.pack()]))
        entry = {"model_version": int(model_version),
                 "ts": time.time(),  # wall-clock
                 "bytes": len(blob), "blob": blob}
        with self._lock:
            self._ring.append(entry)
            if len(self._ring) > self.capacity:
                self._ring.pop(0)
            self.taken += 1
        return entry

    def latest(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def restore(self, driver, entry: Optional[Dict[str, Any]] = None) -> int:
        """Apply a snapshot (default: newest) back into the driver —
        CRC-validated through the same read_envelope every checkpoint
        load uses. The caller holds the driver's model lock. Returns
        the snapshot's model_version."""
        from jubatus_tpu_torch.framework.save_load import read_envelope
        from jubatus_tpu_torch.utils.serialization import unpack_obj

        if entry is None:
            entry = self.latest()
        if entry is None:
            raise RuntimeError("no model snapshot to roll back to "
                               "(--model-snapshot-interval off?)")
        system_b, user_b = read_envelope(entry["blob"], "snapshot-ring")
        system = unpack_obj(system_b)
        user_version, user_data = unpack_obj(user_b)
        if user_version != driver.USER_DATA_VERSION:
            raise RuntimeError(
                f"snapshot user data version {user_version} != "
                f"{driver.USER_DATA_VERSION}")
        driver.unpack(user_data)
        with self._lock:
            self.restored += 1
        return int(system.get("model_version", 0))

    def list(self) -> List[Dict[str, Any]]:
        """Metadata view (no blobs) for status / jubactl."""
        with self._lock:
            return [{k: v for k, v in e.items() if k != "blob"}
                    for e in self._ring]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            newest = self._ring[-1] if self._ring else None
            return {
                "count": len(self._ring),
                "capacity": self.capacity,
                "taken": self.taken,
                "restored": self.restored,
                "bytes": sum(e["bytes"] for e in self._ring),
                "last_model_version": (newest or {}).get(
                    "model_version", -1),
                "last_age_s": round(
                    time.time() - newest["ts"], 1)  # wall-clock
                if newest else -1.0,
            }
