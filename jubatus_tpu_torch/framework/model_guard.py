"""Mix admission guard (``MixGuard`` and the screens of
``jubatus_tpu/framework/model_guard.py``).

Mix is model averaging, so one replica gone sick (a NaN from a bad datum,
a norm-exploded diff from a runaway learner) poisons every peer's weights
in a single round. **MixGuard** is the fold-time admission screen of the
sync master (``linear_mixer._run_as_master``). Two screens, in order:

* **finite screen** — any non-finite element in a summable mixable's
  diff rejects the contribution outright (NaN is absorbing under
  addition);
* **norm screen** — a contribution whose update norm exceeds
  ``--mix-norm-bound`` × the median of its PEERS' norms this round is an
  outlier (leave-one-out median). An all-quiet baseline judges nothing.

Verdicts feed a per-member quarantine breaker. Mode ladder
(``--mix-guard``): ``off`` — no screening; ``warn`` — screen, count, emit,
fold everything anyway; ``quarantine`` — drop screened-out contributions.
The port's server accepts ``off`` and ``warn``: ``quarantine`` refuses a
non-finite total by rolling back to the last-good model snapshot, and the
snapshot ring (``ModelSnapshotRing``) is not ported yet, so the server
raises ``NotYetPorted`` for it.
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
