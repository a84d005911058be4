"""Asynchronous staleness-bounded mix — the round barrier off the
serving path (copy of ``jubatus_tpu/framework/async_mixer.py``).

Every synchronous mix mode is a pulled round: the master fans out
``get_diff``, folds while every contributor's freshness decays, and a
below-quorum round aborts AFTER the gather is already paid. One slow or
dead member stalls the whole fleet ("Exploring the limits of
Concurrency in ML Training on Google TPUs": past a point you must
overlap communication with compute or scaling dies; "TensorFlow: A
system for large-scale machine learning" treats asynchronous,
staleness-tolerant updates as the baseline posture for a fleet of
unreliable workers).

Here rounds stream continuously in the background and nothing on the
serving path ever waits for one:

- **Members push, the master folds.** Each member's scheduler tick
  snapshots its local diff (the only model-lock hold — gauged as
  ``mix.snapshot_stall_ms``) and SUBMITS it to the current master over
  ``mix_submit_diff``, then returns. No member ever blocks inside a
  round: the wire transfer, the fold, and the broadcast all happen on
  other threads while train/classify keep running against the current
  model snapshot.
- **A diff inbox replaces the gather.** The master keeps the latest
  submitted payload per member (successive ``get_diff`` snapshots are
  cumulative — put_diff resets accumulation — so latest-wins is exact,
  not lossy). The fold tick consumes whatever has arrived; an empty
  inbox is an idle tick, not an abort.
- **Bounded-staleness weights replace quorum aborts.** Every payload
  carries the model version it was snapshot against. At fold time its
  staleness is ``base - version`` (one fold == one version bump, so
  this is rounds-stale); its fold weight decays as ``2**-staleness``
  and past ``--mix-staleness-bound`` the payload is dropped
  (``mix.async_dropped_stale``). A straggler therefore degrades its
  OWN contribution instead of stalling or aborting the round.
- **Double-buffered apply.** The fold's broadcast applies through the
  same ``local_put_obj`` every mode uses: unpack and version gating
  happen OFF the model lock, the lock is held only for the put_diff
  swaps, and the model version bumps INSIDE the lock — concurrent
  train/classify see a consistent (model, version) pair and a monotone
  ``mix.model_version`` gauge, never a torn intermediate.

The degradation ladder, in order: fresh (weight 1) → decayed
(``2**-s``) → dropped (``s > bound``, resubmits next tick) → obsolete
(missed applies; the existing full-model recovery pulls it back).
The convergence telemetry (``mix.premix_divergence_*``,
``mix.staleness_max``) is computed per fold exactly as the sync master
does, so the async plane's learning health is measured by the same
gauges — the drift-parity test holds async divergence to the sync
plane's.

The port's tree walks are plain dict/list walks (utils/tree.py), and
the fold weights scale host numpy leaves exactly as the JAX package
does, so a port master and a JAX master fold one inbox to the same
bits. Device work: the member's snapshot (``get_diff`` on the card under
the model lock) and the apply (``put_diff``) enter the driver's device.

Master discovery: the fold-tick winner of the coordinator master lock
publishes its node name at ``<actor>/async_master``; submitters read
it per tick (one coordinator read) and push there. A dead master's
hint goes stale harmlessly — submits fail fast through the breaker
board, and the next fold tick's lock winner republishes.
"""

from __future__ import annotations

import functools
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from jubatus_tpu_torch.coord import membership
from jubatus_tpu_torch.coord.base import NodeInfo
from jubatus_tpu_torch.framework import model_guard
from jubatus_tpu_torch.framework.linear_mixer import (
    PROTOCOL_VERSION,
    RpcLinearMixer,
    _sum_names,
    mix_health,
    pack_mix,
    unpack_mix,
)
from jubatus_tpu_torch.parallel.mix import tree_sum
from jubatus_tpu_torch.rpc.client import RpcClient
from jubatus_tpu_torch.utils import faults
from jubatus_tpu_torch.utils.tree import tree_map

log = logging.getLogger(__name__)

#: default rounds-stale bound (--mix-staleness-bound): weight has
#: decayed to 2**-8 ≈ 0.4% by the time a payload is dropped outright
DEFAULT_STALENESS_BOUND = 8


def fold_weight(staleness: int, bound: int) -> float:
    """Bounded-staleness fold weight: 1.0 when fresh, halved per round
    stale (the payload's information content decays geometrically as
    folds it missed land on top of its base), 0.0 past the bound —
    the drop that replaces the sync plane's quorum abort."""
    if staleness <= 0:
        return 1.0
    if staleness > bound:
        return 0.0
    return 2.0 ** -staleness


def _scale_leaf(x: Any, w: float) -> Any:
    """One diff leaf scaled by a fold weight, dtype-preserving: integer
    count leaves stay integral (truncation IS the down-weighting) so
    put_diff consumers never see a surprise float table."""
    y = x * w
    dt = getattr(x, "dtype", None)
    if dt is not None and getattr(y, "dtype", None) != dt:
        y = y.astype(dt)
    return y


def scale_tree(diff: Any, w: float) -> Any:
    """A diff pytree scaled by a staleness weight (identity at 1.0)."""
    if w == 1.0:
        return diff
    return tree_map(lambda x: _scale_leaf(x, w), diff)


def _merge_delta_tree(a: Any, b: Any) -> Any:
    """Combine TWO DELTAS OF ONE MEMBER (an apply-time capture + a
    fresh snapshot) leaf-wise. Array leaves add (with tree_sum's
    trailing-row pad); EQUAL 0-d scalar leaves keep one copy — those
    are per-payload normalization markers (e.g. the classifier's
    replica-count leaf the cluster fold sums to average weights), and
    one member's two deltas are still ONE replica's contribution."""

    def comb(x, y):
        xs = getattr(x, "shape", None)
        ys = getattr(y, "shape", None)
        if xs in ((), None) and ys in ((), None):
            try:
                if float(x) == float(y):
                    return x
            except (TypeError, ValueError):
                pass
        return tree_sum([x, y])  # no-guard — one member's own two deltas
        # (capture + fresh snapshot); admission screening happens when
        # the merged payload reaches an inbox or fold

    return tree_map(comb, a, b)


class DiffInbox:
    """Latest-diff-per-member store on the master — the async plane's
    replacement for the get_diff gather. ``submit`` keeps only the
    newest payload per member (cumulative snapshots make that exact);
    ``drain`` consumes everything for one fold."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, Any]] = {}
        self.submits = 0

    def submit(self, member: str, payload: Dict[str, Any]) -> None:
        entry = {"payload": payload,
                 "version": int(payload.get("version", 0)),
                 "ts": time.monotonic()}
        with self._lock:
            self._entries[member] = entry
            self.submits += 1

    def drain(self) -> Dict[str, Dict[str, Any]]:
        """Consume every pending entry (one fold's input). Entries are
        folded at most once — a silent member contributes nothing to
        later folds rather than replaying its last delta."""
        with self._lock:
            entries, self._entries = self._entries, {}
        return entries

    def depth(self) -> int:
        with self._lock:
            return len(self._entries)


class AsyncLinearMixer(RpcLinearMixer):
    """RpcLinearMixer whose rounds stream in the background: members
    push diffs asynchronously, the master folds its inbox with
    bounded-staleness weights, and nothing blocks the serving path.
    Serves the whole linear-mixer RPC surface plus ``mix_submit_diff``
    / ``mix_async_status``, so recovery, health telemetry, and the
    flight recorder ride the existing machinery unchanged."""

    def __init__(self, driver: Any, comm: Any, *,
                 staleness_bound: int = DEFAULT_STALENESS_BOUND,
                 **kwargs) -> None:
        super().__init__(driver, comm, **kwargs)
        self.staleness_bound = int(staleness_bound)
        self.inbox = DiffInbox()
        #: fold ticks fire on the interval even when THIS node saw no
        #: local updates — other members' submissions may be pending
        self._scheduler.fire_idle = True
        self.async_rounds = 0
        self.async_dropped_stale = 0
        self.async_submit_errors = 0
        #: set by a fold whose every payload was schema-deferred (the
        #: fold tick retries once with a realigned self snapshot)
        self._fold_all_deferred = False
        #: member-side view of its own distance from the master's fold
        #: cadence, refreshed from every submit ack (base - my version)
        self.async_lag_rounds = 0
        #: master hint this member last submitted to (status/debugging)
        self.async_master = ""
        #: update_count at the last snapshot this member shipped: a
        #: tick with no new local updates submits nothing (a zero diff
        #: would only dilute the fold's contributor accounting)
        self._last_submitted_updates = -1
        #: pooled submit client, keyed by the master it points at
        self._submit_cli: Optional[RpcClient] = None
        self._submit_target = ""
        self._submit_lock = threading.Lock()
        #: accumulation captured just before a broadcast apply would
        #: have reset it unfolded (this member was not among the
        #: fold's contributors) — merged into the next submission
        self._captured: Optional[Dict[str, Any]] = None
        self._captured_lock = threading.Lock()
        #: update_count at the last successful apply (= accumulator
        #: reset): an accumulator with no training since the last
        #: reset is EMPTY — capturing it would only inject per-payload
        #: normalization markers (a count leaf) into a later merge
        self._updates_at_reset = getattr(driver, "update_count", 0) or 0

    # -- RPC surface ---------------------------------------------------------
    def register_api(self, rpc_server, name_check: str = "") -> None:
        super().register_api(rpc_server, name_check)
        rpc_server.register(
            "mix_submit_diff",
            lambda _n, member, packed: self.local_submit_diff(member, packed))
        rpc_server.register(
            "mix_async_status", lambda _n: self.async_status())

    def local_submit_diff(self, member: Any, packed: bytes) -> Dict[str, Any]:
        """Accept one member's pushed diff into the inbox and ack with
        my current base version (the submitter's lag gauge). Accepting
        while not (yet) master is deliberate: masterhood migrates
        tick-to-tick, and an inbox entry on a non-master is folded the
        moment this node wins the lock."""
        member = member.decode() if isinstance(member, bytes) \
            else str(member)
        # chaos site: drop = the submit is lost in transit (sender is
        # told, so the chaos ladder can distinguish drop from blackhole)
        if faults.is_armed() and faults.fire(f"mix.async.inbox.{member}"):
            return {"accepted": False, "base": int(self.model_version)}
        msg = unpack_mix(packed)
        if msg.get("protocol") != PROTOCOL_VERSION:
            return {"accepted": False, "base": int(self.model_version)}
        # inbox admission screen: the async plane has no
        # gather phase, so the finite screen runs the moment a payload
        # arrives — a poisoned submission never even occupies an inbox
        # slot (norm outliers are judged at fold time, where the peer
        # distribution exists). warn mode flags and admits.
        if self.guard.enabled:
            reason = self.guard.screen_payload(
                member, msg.get("diffs") or {},
                _sum_names(self.driver.get_mixables()))
            if reason is not None:
                if reason == "nonfinite":
                    self._count("mix.guard.nonfinite")
                if self.guard.mode == "quarantine":
                    self._count("mix.quarantined")
                    self.trace.events.emit(
                        "mix", "inbox_rejected", severity="warning",
                        member=member, reason=reason)
                    return {"accepted": False, "quarantined": True,
                            "base": int(self.model_version)}
        self.inbox.submit(member, msg)
        self._count("mix.async_submits")
        self.trace.gauge("mix.async_inbox_depth", float(self.inbox.depth()))
        return {"accepted": True, "base": int(self.model_version)}

    def async_status(self) -> Dict[str, Any]:
        return {
            "inbox_depth": self.inbox.depth(),
            "inbox_submits": self.inbox.submits,
            "rounds": self.async_rounds,
            "dropped_stale": self.async_dropped_stale,
            "submit_errors": self.async_submit_errors,
            "lag_rounds": self.async_lag_rounds,
            "master": self.async_master,
            "staleness_bound": self.staleness_bound,
            "model_version": self.model_version,
        }

    # -- apply-time capture (loss-window closure) ----------------------------
    def local_put_obj(self, msg) -> bool:
        self._capture_before_apply(msg)
        ok = super().local_put_obj(msg)
        if ok:
            # the apply reset the accumulators; training that lands in
            # the microseconds between the reset and this read may be
            # classed pre-reset (skipped by a later capture gate) —
            # the same loss window a sync apply always had
            self._updates_at_reset = getattr(
                self.driver, "update_count", 0) or 0
        return ok

    def _capture_before_apply(self, msg) -> None:
        """A broadcast apply resets local accumulation whether or not
        this member's diff made the fold (reference ``put_diff``
        semantics — the sync plane destroys a failed-gather member's
        accumulation identically). When this member is NOT among the
        fold's contributors, nothing of its accumulator was folded —
        capture it before the reset and merge it into the next
        submission, so a fold landing between this member's submits
        (bootstrap before the first master election, a master folding
        faster than a member ticks) destroys nothing. Contributors
        skip: their accumulators contain already-folded content and a
        capture would double-count — their loss window is exactly the
        sync plane's [get_diff, put_diff] window."""
        try:
            contributors = {c.decode() if isinstance(c, bytes) else str(c)
                            for c in (msg.get("contributors") or [])}
            me = self.self_node.name if self.self_node is not None \
                else "self"
            if not contributors or me in contributors:
                return  # pre-capture-era master, or my diff was folded
            updates = getattr(self.driver, "update_count", None)
            if updates is not None and updates == self._updates_at_reset:
                # nothing trained since the last reset: the
                # accumulator is empty — there is nothing to save
                return
            with self._captured_lock:
                have = self._captured is not None
            if updates is not None and \
                    updates == self._last_submitted_updates and not have:
                # everything trained is already submitted: the inbox's
                # latest-wins copy (or a past fold) covers it
                return
            snap = self.local_diff_obj(materialize=True,
                                       canonical_schema=True)
            self._count("mix.async_captures")
            with self._captured_lock:
                prev = self._captured
                # a second consecutive non-contributor apply: the new
                # accumulator holds only post-first-capture updates —
                # merging keeps the total
                self._captured = snap if prev is None \
                    else self._merge_payloads(prev, snap)
            if updates is not None:
                self._last_submitted_updates = updates
        except Exception:  # broad-ok — capture is best-effort protection
            log.warning("pre-apply capture failed", exc_info=True)

    def _merge_payloads(self, cap: Dict[str, Any],
                        fresh: Dict[str, Any]) -> Dict[str, Any]:
        """Merge a captured payload into a fresh snapshot (both are
        deltas; summable mixables add, custom-mix ones fold). Row
        alignment: the capture's schema must be a sorted PREFIX of the
        fresh schema (vocabularies grow; tree_sum pads trailing rows)
        — a rare non-prefix capture (novel early-sorting label in
        between) cannot be realigned and is dropped, counted."""
        cs = [s.decode() if isinstance(s, bytes) else s
              for s in (cap.get("schema") or [])]
        fs = [s.decode() if isinstance(s, bytes) else s
              for s in (fresh.get("schema") or [])]
        if cs != fs[:len(cs)]:
            self._count("mix.async_capture_dropped")
            return fresh
        mixables = self.driver.get_mixables()
        diffs = dict(fresh["diffs"])
        for name, d in (cap.get("diffs") or {}).items():
            if name not in diffs:
                diffs[name] = d
                continue
            m = mixables.get(name)
            custom = getattr(m, "mix", None) if m is not None else None
            if custom is not None and \
                    not getattr(m, "MIX_IS_SUM", False):
                diffs[name] = functools.reduce(custom, [d, diffs[name]])
            else:
                diffs[name] = _merge_delta_tree(d, diffs[name])
        return dict(fresh, diffs=diffs)

    def _with_captured(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Fold any apply-time capture into an outgoing snapshot (the
        capture rides the fresh stamp: additive deltas a sync round
        would have gathered at full weight one round later)."""
        with self._captured_lock:
            cap, self._captured = self._captured, None
        if cap is None:
            return payload
        return self._merge_payloads(cap, payload)

    # -- master discovery ----------------------------------------------------
    def _hint_path(self) -> str:
        actor = membership.actor_path(self.comm.engine, self.comm.name)
        return f"{actor}/async_master"

    def _publish_master_hint(self) -> None:
        if self.self_node is None:
            return
        try:
            if not self.comm.coord.set(
                    self._hint_path(), self.self_node.name.encode()):
                self.comm.coord.create(
                    self._hint_path(), self.self_node.name.encode())
        except Exception:  # broad-ok — next fold tick republishes
            log.debug("async master hint publish failed", exc_info=True)

    def _master_hint(self) -> Optional[NodeInfo]:
        try:
            raw = self.comm.coord.read(self._hint_path())
        except Exception:  # broad-ok — transient coordinator issue
            return None
        if not raw:
            return None
        try:
            return NodeInfo.from_name(raw.decode())
        except (ValueError, IndexError):
            return None

    # -- member side: the push ----------------------------------------------
    def submit_now(self) -> bool:
        """One submit tick, callable directly (tests, drills):
        snapshot my diff and push it at the current master."""
        members = self.comm.update_members()
        return self._submit_tick(members)

    def _submit_client(self, master: NodeInfo) -> RpcClient:
        with self._submit_lock:
            if self._submit_cli is None or \
                    self._submit_target != master.name:
                if self._submit_cli is not None:
                    try:
                        self._submit_cli.close()
                    except Exception:  # broad-ok — stale socket teardown
                        pass
                self._submit_cli = RpcClient(
                    master.host, master.port,
                    getattr(self.comm, "timeout", 10.0))
                self._submit_target = master.name
            return self._submit_cli

    def _drop_submit_client(self) -> None:
        with self._submit_lock:
            cli, self._submit_cli = self._submit_cli, None
            self._submit_target = ""
        if cli is not None:
            try:
                cli.close()
            except Exception:  # broad-ok
                pass

    def _submit_tick(self, members: Sequence[NodeInfo]) -> bool:
        if self.self_node is None:
            return False
        master = self._master_hint()
        self.async_master = master.name if master is not None else ""
        if master is None or master.name == self.self_node.name:
            # no master yet (first ticks of a fresh cluster) or I am
            # it: my own fold tick enqueues my diff in-process
            return False
        updates = getattr(self.driver, "update_count", None)
        with self._captured_lock:
            have_capture = self._captured is not None
        if not have_capture and updates is not None and \
                updates == self._last_submitted_updates:
            return False  # nothing new since the last shipped snapshot
        # brief model-lock hold (gauged); materialized so later train
        # steps cannot donate the snapshot's buffers mid-flight.
        # An apply-time capture merges in; on a FAILED submit the
        # capture is re-stashed (unlike the fresh snapshot, its
        # content no longer lives in the accumulator).
        with self._captured_lock:
            cap, self._captured = self._captured, None
        payload = self.local_diff_obj(materialize=True,
                                      canonical_schema=True)
        if cap is not None:
            payload = self._merge_payloads(cap, payload)

        def restore_capture() -> None:
            # a resubmit next tick must not be swallowed by the
            # update-count gate, and a popped capture must survive
            self._last_submitted_updates = -1
            if cap is None:
                return
            with self._captured_lock:
                self._captured = cap if self._captured is None \
                    else self._merge_payloads(cap, self._captured)

        if updates is not None:
            self._last_submitted_updates = updates
        # chaos site carries the SENDER's name so a straggler drill can
        # delay exactly one member's submissions
        if faults.is_armed() and \
                faults.fire(f"mix.async.submit.{self.self_node.name}"):
            restore_capture()  # the snapshot never left this process
            return False
        packed = pack_mix(payload)
        try:
            with self.trace.span("mix.phase.submit"):
                ack = self._submit_client(master).call(
                    "mix_submit_diff", self.comm.name,
                    self.self_node.name, packed)
        except Exception as e:  # broad-ok — submit is fire-and-forget
            self.async_submit_errors += 1
            self._count("mix.async_submit_errors")
            self._drop_submit_client()
            self.flight.record("async_submit", ok=False,
                               reason=f"{type(e).__name__}: {e}",
                               master=master.name)
            restore_capture()
            return False
        ack = {(k.decode() if isinstance(k, bytes) else str(k)): v
               for k, v in (ack or {}).items()}
        base = int(ack.get("base", 0))
        self.async_lag_rounds = max(0, base - int(payload["version"]))
        self.trace.gauge("mix.async_lag_rounds",
                         float(self.async_lag_rounds))
        self.bytes_sent += len(packed)
        accepted = bool(ack.get("accepted"))
        if not accepted:
            # refused (injected drop / protocol gate): the snapshot
            # never landed — next tick resubmits, the capture survives
            restore_capture()
        return accepted

    # -- the streaming round -------------------------------------------------
    def _mix_round(self) -> Optional[Dict[str, Any]]:
        if self._obsolete:
            self.maybe_recover()
        members = self.comm.update_members()
        if len(members) < 2 and self.self_node is not None:
            return None  # nothing to mix with
        self._submit_tick(members)
        if not self.comm.try_lock():
            return None  # submit-only tick; someone else folds
        try:
            self._publish_master_hint()
            if self.self_node is not None and \
                    self.async_master != self.self_node.name:
                # event plane: a new fold-lock winner is an
                # async-mix master election — emitted only on CHANGE
                # (the same master re-winning every tick is not news)
                self.trace.events.emit(
                    "mix", "async_master_elected",
                    master=self.self_node.name,
                    previous=self.async_master or None)
            if self.self_node is not None:
                self.async_master = self.self_node.name
            return self._fold_round(members)
        finally:
            self.comm.unlock()

    def _enqueue_own_diff(self) -> None:
        """The master's own contribution enters through the same inbox
        as everyone else's (freshest possible stamp, no special-cased
        fold path)."""
        updates = getattr(self.driver, "update_count", None)
        with self._captured_lock:
            have_capture = self._captured is not None
        if not have_capture and updates is not None and \
                updates == self._last_submitted_updates:
            return
        name = self.self_node.name if self.self_node is not None else "self"
        # materialized: unlike RPC-submitted payloads (wire copies),
        # the in-process snapshot would otherwise reference LIVE model
        # buffers a train step could donate out from under the fold
        self.inbox.submit(name, self._with_captured(self.local_diff_obj(
            materialize=True, canonical_schema=True)))
        if updates is not None:
            self._last_submitted_updates = updates

    def _fold_round(self, members: Sequence[NodeInfo]
                    ) -> Optional[Dict[str, Any]]:
        t0 = time.monotonic()
        phases: Dict[str, Any] = {}
        self._enqueue_own_diff()
        entries = self.inbox.drain()
        self.trace.gauge("mix.async_inbox_depth", 0.0)
        if not entries:
            return None  # idle tick — nothing arrived since last fold
        with self.trace.span("mix.phase.fold") as sp:
            self._fold_all_deferred = False
            folded = self._weighted_fold(entries)
            if folded is None and self._fold_all_deferred:
                # every payload was schema-deferred, but the union
                # sync just realigned OUR vocabulary too: retry once
                # with a fresh self snapshot so the tick still folds
                # (peers' deferred payloads return next tick aligned)
                self._last_submitted_updates = -1
                self._enqueue_own_diff()
                retry = self.inbox.drain()
                if retry:
                    folded = self._weighted_fold(retry)
        phases["fold_ms"] = round(sp.seconds * 1e3, 2)
        if folded is None:
            return None  # everything stale/deferred; next tick retries
        packed, meta = folded
        with self.trace.span("mix.phase.put_diff") as sp:
            # broadcast of a fold that _weighted_fold already screened
            acks = self.comm.put_diff(packed)  # no-guard — pre-screened
        phases["put_diff_ms"] = round(sp.seconds * 1e3, 2)
        for member in members:
            if not acks.get(member.name, False):
                self.comm.register_active(member, False)
        self.mix_count += 1
        self.async_rounds += 1
        self.bytes_sent += len(packed)
        self._count("mix.async_rounds")
        self._count("mix.bytes_shipped", len(packed))
        log.info("async mix round %d: %d/%d contributors (%d stale-"
                 "dropped), %d bytes, %.3fs", self.async_rounds,
                 meta["contributors"], len(entries), meta["dropped"],
                 len(packed), time.monotonic() - t0)
        epoch = self.comm.membership_epoch() \
            if hasattr(self.comm, "membership_epoch") else 0
        if epoch:
            self.trace.gauge("mix.epoch", float(epoch))
        return {"members": len(members), "bytes": len(packed),
                "mode": "async", "phases": phases,
                "contributors": meta["contributors"],
                "dropped_stale": meta["dropped"] or None,
                "deferred_schema": meta["deferred"] or None,
                "quarantined": meta.get("quarantined"),
                "weights": meta["weights"],
                "base_version": meta["base_version"],
                "epoch": epoch or None,
                "health": meta["health"] or None,
                "acked": sum(bool(v) for v in acks.values())}

    def _weighted_fold(self, entries: Dict[str, Dict[str, Any]]
                       ) -> Optional[Tuple[bytes, Dict[str, Any]]]:
        """Fold the inbox with bounded-staleness weights. Returns the
        packed put_diff broadcast + round metadata, or None when no
        payload survived the staleness/schema gates."""
        base_version = max(
            max(e["version"] for e in entries.values()),
            self.model_version)
        weights: Dict[str, float] = {}
        dropped = 0
        live: Dict[str, Dict[str, Any]] = {}
        for member, e in entries.items():
            staleness = max(0, base_version - e["version"])
            w = fold_weight(staleness, self.staleness_bound)
            if w == 0.0:
                dropped += 1
                continue
            weights[member] = round(w, 6)
            live[member] = e
        if dropped:
            self.async_dropped_stale += dropped
            self._count("mix.async_dropped_stale", dropped)
        if not live:
            return None
        # model-integrity admission screen: the inbox's
        # finite screen ran at submit time, but the NORM screen needs
        # this fold's peer distribution — and the master's own
        # in-process enqueue skipped the inbox screen entirely. Same
        # ladder as the sync master: warn counts, quarantine drops.
        quarantined_round: List[str] = []
        if self.guard.enabled:
            rep = self._guard_screen(
                {m: e["payload"]["diffs"] for m, e in live.items()},
                _sum_names(self.driver.get_mixables()))
            quarantined_round = sorted(rep.flagged)
            if self.guard.mode == "quarantine" and rep.flagged:
                for m in rep.flagged:
                    live.pop(m, None)
                    weights.pop(m, None)
                if not live:
                    self._count("mix.guard.all_quarantined")
                    return None
        # schema gate. The broadcast's schema must be the union of the
        # WHOLE cluster's vocabularies, not just this fold's
        # contributors — members apply it via sync_schema, and a
        # narrower union would shrink their label tables (drop rows).
        # So schema-bearing engines pay one failure-tolerant
        # get_schemas fan-out per fold (tiny lists; breakers skip dead
        # members — this is the sync round's phase 1, off the serving
        # path). Row alignment: diff rows sit in sorted-vocabulary
        # order (the snapshot self-canonicalizes), so a payload whose
        # schema is a sorted PREFIX of the union is foldable as-is
        # (absent trailing rows contribute zeros, exactly the pad
        # tree_sum applies); a non-prefix payload cannot be realigned
        # after the fact — it defers one tick while the union
        # broadcast realigns its owner's vocabulary.
        schemas = {m: [s.decode() if isinstance(s, bytes) else s
                       for s in (e["payload"].get("schema") or [])]
                   for m, e in live.items()}
        vocab = set().union(*(set(s) for s in schemas.values())) \
            if schemas else set()
        if self._has_schema():
            with self._on_driver():
                vocab |= set(self.driver.get_schema())
            try:
                for s in self.comm.get_schemas():
                    vocab |= {x.decode() if isinstance(x, bytes) else x
                              for x in s}
            except Exception:  # broad-ok — degraded union this tick
                log.warning("async schema fan-out failed", exc_info=True)
        union = sorted(vocab)
        deferred = 0
        if union:
            misaligned = [m for m, s in schemas.items()
                          if s != union[:len(s)]]
            if misaligned:
                self.comm.sync_schema(union)
                self._count("mix.async_schema_deferred", len(misaligned))
                deferred = len(misaligned)
                for m in misaligned:
                    weights.pop(m, None)
                    live.pop(m, None)
                if not live:
                    # everything deferred this tick; the union sync
                    # above realigned vocabularies (ours included) —
                    # the caller may retry once with a fresh snapshot
                    self._fold_all_deferred = True
                    return None
        payloads = [(weights[m], e["payload"]) for m, e in live.items()]
        mixables = self.driver.get_mixables()
        totals: Dict[str, Any] = {}
        for name, mixable in mixables.items():
            pairs = [(w, p["diffs"][name]) for w, p in payloads
                     if name in p["diffs"]]
            if not pairs:
                continue
            custom_mix = getattr(mixable, "mix", None)
            if custom_mix is not None and \
                    not getattr(mixable, "MIX_IS_SUM", False):
                # dict-shaped custom folds (bandit, row stores) have no
                # meaningful scalar weighting — staleness still gates
                # them (dropped past the bound), freshness does not
                totals[name] = functools.reduce(
                    custom_mix, [d for _, d in pairs])
            else:
                totals[name] = tree_sum(
                    [scale_tree(d, w) for w, d in pairs])
        if weights:
            self.trace.gauge("mix.async_fold_weight_min",
                             min(weights.values()))
        # fold-total finite screen: same contract as the
        # sync master — a non-finite total is never broadcast in
        # quarantine mode (warn counts and proceeds)
        if self.guard.enabled and \
                model_guard.payload_nonfinite(totals,
                                              _sum_names(mixables)):
            self._count("mix.guard.nonfinite_total")
            self.trace.events.emit(
                "mix", "nonfinite_fold_total", severity="error",
                mode=self.guard.mode)
            if self.guard.mode == "quarantine":
                log.error("async fold aborted: total is non-finite")
                return None
        health = mix_health([p["diffs"] for _, p in payloads], totals,
                            _sum_names(mixables))
        members = self.comm._members if hasattr(self.comm, "_members") \
            else []
        health.update(self._staleness_update(members, set(live)))
        # the broadcast names its contributors: a member NOT listed
        # knows the apply is about to reset an accumulator nothing of
        # which was folded — it captures first (_capture_before_apply)
        packed = pack_mix(
            {"protocol": PROTOCOL_VERSION, "schema": union,
             "base_version": base_version, "diffs": totals,
             "contributors": sorted(live), "health": health})
        return packed, {"contributors": len(live), "dropped": dropped,
                        "deferred": deferred, "weights": weights,
                        "quarantined": quarantined_round or None,
                        "base_version": base_version, "health": health}

    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        st.update({
            "async_mode": True,
            "async_rounds": self.async_rounds,
            "async_inbox_depth": self.inbox.depth(),
            "async_inbox_submits": self.inbox.submits,
            "async_dropped_stale": self.async_dropped_stale,
            "async_submit_errors": self.async_submit_errors,
            "async_lag_rounds": self.async_lag_rounds,
            "async_master": self.async_master,
            "staleness_bound": self.staleness_bound,
        })
        return st

    def stop(self) -> None:
        super().stop()
        self._drop_submit_client()
