"""Distributed linear mixer over RPC (copy of
``jubatus_tpu/framework/linear_mixer.py``; ≙ mixer/linear_mixer.{hpp,cpp}).

The mix loop for deployments that are N independent server processes:
the port's servers, the JAX package's, or both in one fleet. The wire
(``mix_*`` RPCs, ``pack_mix`` payloads, protocol version 2) is the JAX
package's, and diffs are host numpy in both packages, so a JAX master and
a port master fold the same contributions to the same bits.

Round semantics mirror the reference exactly (linear_mixer.cpp:437-559):

  1. elect a per-round master (coordinator master_lock try_lock, :386);
  2. schema sync — engines whose diff arrays are row-keyed by a dynamic
     vocabulary (classifier labels, stat keys) first agree on the sorted
     union schema (fan-out get_schema → union → fan-out sync_schema), so
     per-replica diff arrays are row-aligned before any fold. Engines with
     no schema skip this (two cheap no-op fan-outs);
  3. master fans out ``get_diff`` to every member — including itself, through
     the same path, so all diffs are wire-canonical;
  4. folds diffs pairwise per mixable (custom ``mix`` or elementwise add);
  5. broadcasts ``put_diff``; each member applies it under its model lock;
  6. put_diff success drives the actives list (:658-681): valid → register
     active, obsolete → unregister + full-model recovery via ``get_model``
     from a random peer (:598-632).

The ``LinearCommunication`` seam makes rounds testable without sockets
(reference linear_communication_stub, linear_mixer_test.cpp:65-112).

Not carried over: the collective plane's entry points and the trace
context of a round.
"""

from __future__ import annotations

import functools
import logging
import math
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from jubatus_tpu_torch.coord import membership
from jubatus_tpu_torch.coord.base import Coordinator, NodeInfo
from jubatus_tpu_torch.framework.driver import DriverBase, on_driver
from jubatus_tpu_torch.framework.mixer import IntervalMixer, MixFlightRecorder
from jubatus_tpu_torch.framework.model_guard import MixGuard, payload_nonfinite
from jubatus_tpu_torch.parallel.mix import tree_sum
from jubatus_tpu_torch.rpc.breaker import BreakerBoard
from jubatus_tpu_torch.rpc.client import RpcClient, RpcMClient
from jubatus_tpu_torch.utils import events, faults
from jubatus_tpu_torch.utils.serialization import pack_obj, unpack_obj
from jubatus_tpu_torch.utils.tree import tree_leaves, tree_map

log = logging.getLogger(__name__)

#: mixer protocol version — mismatch forces shutdown (linear_mixer.cpp:618-624).
#: v2: payloads carry the R/Z compression tag (pack_mix). A v1 peer cannot
#: decode v2 payloads at all; v2 decodes v1 via the unpack_mix fallback and
#: the version gate then rejects it cleanly.
PROTOCOL_VERSION = 2

#: payloads above this compress with zlib before hitting the wire — mix
#: rounds cross hosts (DCN), where sparse/periodic diffs compress well;
#: below it the header+cpu cost isn't worth it
COMPRESS_THRESHOLD = 2048


def pack_mix(obj) -> bytes:
    """Pack a mix payload, zlib-compressed when large (1-byte tag)."""
    raw = pack_obj(obj)
    if len(raw) > COMPRESS_THRESHOLD:
        import zlib

        z = zlib.compress(raw, 1)
        if len(z) + 1 < len(raw):
            return b"Z" + z
    return b"R" + raw


def unpack_mix(data: bytes):
    """Inverse of pack_mix; unprefixed payloads (older peers) pass through."""
    tag = data[:1]
    if tag == b"Z":
        import zlib

        return unpack_obj(zlib.decompress(data[1:]))
    if tag == b"R":
        return unpack_obj(data[1:])
    return unpack_obj(data)


# -- mix-convergence telemetry --------------------------------------
# The health plane answers "is the LEARNING healthy?": how far apart the
# replicas' contributions are before the fold (divergence), how big the
# applied step is (update norm), and which members keep missing rounds
# (staleness). Computed once per round from data the round already holds
# — no extra RPCs, one vector pass over the payloads.

def _leaf_sq(x: Any) -> float:
    """Sum of squares of one diff leaf. Multiplying by 1.0 promotes int
    leaves; scalar leaves fall through."""
    d = x * 1.0
    s = getattr(d, "sum", None)
    if s is None:
        return float(d * d)
    return float((d * d).sum())


def _pair_sq(a: Any, b: Any, b_scale: float) -> float:
    """Sum of squares of ``a - b * b_scale`` (0.0 on a leaf-shape
    mismatch: row-trimmed label diffs may differ by a row — tree_sum
    pads them for the fold, the health stats just skip them)."""
    if getattr(a, "shape", None) != getattr(b, "shape", None):
        return 0.0
    d = a * 1.0 - b * b_scale
    s = getattr(d, "sum", None)
    if s is None:
        return float(d * d)
    return float((d * d).sum())


def _sum_names(mixables: Dict[str, Any]) -> List[str]:
    """Mixables whose fold is elementwise addition — the only ones for
    which "contribution vs folded average" is meaningful."""
    return [name for name, m in mixables.items()
            if getattr(m, "mix", None) is None
            or getattr(m, "MIX_IS_SUM", False)]


def _host(leaf: Any) -> Any:
    """A diff leaf as host data: a tensor is read back (``.cpu()``, which
    waits for the device); anything else is already host data."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return leaf


def divergence_sq(diffs: Dict[str, Any], totals: Dict[str, Any],
                  n: int, names: List[str]) -> float:
    """Squared L2 distance of one member's contribution from the folded
    average (``totals / n``), summed over the summable mixables."""
    s = 0.0
    for name in names:
        if name not in diffs or name not in totals:
            continue
        own = tree_leaves(diffs[name])
        tot = tree_leaves(totals[name])
        if len(own) != len(tot):
            continue
        for a, t in zip(own, tot):
            s += _pair_sq(a, t, 1.0 / n)
    return s


def mix_health(contribs: List[Dict[str, Any]], totals: Dict[str, Any],
               names: List[str]) -> Dict[str, Any]:
    """Per-round convergence stats: relative pre-mix divergence of each
    contribution vs the folded average, and the applied step's norm.
    Divergences are normalized by the average's own norm so the signal
    is scale-free — 0.0 means the replicas agree, ~1.0 means they are
    as far apart as the update is big (learning divergence or a sick
    replica)."""
    n = len(contribs)
    if n == 0 or not names:
        return {}
    avg_sq = sum(
        _leaf_sq(t) / (n * n)
        for name in names if name in totals
        for t in tree_leaves(totals[name]))
    denom = math.sqrt(avg_sq) + 1e-12
    rel = [math.sqrt(divergence_sq(d, totals, n, names)) / denom
           for d in contribs]
    update_norm = math.sqrt(avg_sq) * n
    return {
        "premix_divergence_mean": round(sum(rel) / n, 6),
        "premix_divergence_max": round(max(rel), 6),
        "update_norm": round(update_norm, 6),
        "contributors": n,
    }


class LinearCommunication:
    """Communication seam (≙ linear_communication, linear_mixer.hpp:35-72)."""

    def update_members(self) -> List[NodeInfo]:
        raise NotImplementedError

    def try_lock(self) -> bool:
        raise NotImplementedError

    def unlock(self) -> None:
        raise NotImplementedError

    def get_schemas(self) -> List[List[str]]:
        """Fan out get_schema; per-host row vocabularies (default: none)."""
        return []

    def sync_schema(self, union: List[str]) -> None:
        """Broadcast the union schema for pre-diff row alignment."""

    def get_diff(self) -> List[Tuple[NodeInfo, bytes]]:
        """Fan out get_diff; per-host packed diffs (failures skipped)."""
        raise NotImplementedError

    def put_diff(self, packed: bytes) -> Dict[str, bool]:
        """Broadcast the reduced diff; host name → accepted."""
        raise NotImplementedError

    def get_model(self, member: NodeInfo) -> bytes:
        raise NotImplementedError

    def register_active(self, node: NodeInfo, active: bool) -> None:
        pass


class RpcLinearCommunication(LinearCommunication):
    def __init__(
        self,
        coord: Coordinator,
        engine: str,
        name: str,
        timeout: float = 10.0,
    ) -> None:
        self.coord = coord
        self.engine = engine
        self.name = name
        self.timeout = timeout
        self._members: List[NodeInfo] = []
        #: per-member circuit breakers (rpc/breaker.py): a member that
        #: has been failing its mix RPCs for a while is skipped by the
        #: fan-out (instant BreakerOpen host error instead of a timeout
        #: burned EVERY round) and re-admitted via half-open probes. The
        #: registry is installed by the owning mixer's
        #: set_trace_registry, so trips count as mix.breaker_open there.
        self.breakers = BreakerBoard(counter_prefix="mix.breaker")
        self._mc: Optional[RpcMClient] = None  # persistent session pool

    def update_members(self) -> List[NodeInfo]:
        self._members = membership.get_all_nodes(self.coord, self.engine, self.name)
        # elastic membership: draining members are mid-exit —
        # they stopped accepting effectful work and will unregister, so
        # they must not count against the round's quorum denominator
        # (the EPOCH's member set, not the booted-process set)
        try:
            draining = {m.name for m in membership.get_draining(
                self.coord, self.engine, self.name)}
        except Exception:  # broad-ok — a coord hiccup must not stop mix
            draining = set()
        if draining:
            self._members = [m for m in self._members
                             if m.name not in draining]
        if self._members:
            hosts = self._hosts()
            if self._mc is None:
                self._mc = RpcMClient(hosts, self.timeout,
                                      breakers=self.breakers)
            else:
                self._mc.set_hosts(hosts)
        return self._members

    def membership_epoch(self) -> int:
        """The ring version this round's member set was read under."""
        try:
            return membership.get_epoch(self.coord, self.engine, self.name)
        except Exception:  # broad-ok
            return 0

    def _lock_path(self) -> str:
        return f"{membership.actor_path(self.engine, self.name)}/master_lock"

    def try_lock(self) -> bool:
        return self.coord.try_lock(self._lock_path())

    def unlock(self) -> None:
        self.coord.unlock(self._lock_path())

    def _hosts(self) -> List[Tuple[str, int]]:
        return [(m.host, m.port) for m in self._members]

    def get_schemas(self) -> List[List[str]]:
        results, errors = self._mc.call_collect("mix_get_schema", self.name)
        for e in errors:
            # a host missing schema sync would contribute row-misaligned
            # diffs; surface it loudly (its get_diff may still succeed)
            log.warning("get_schema failed: %s", e)
        return [r for _, r in results]

    def sync_schema(self, union: List[str]) -> None:
        _results, errors = self._mc.call_collect("mix_sync_schema", self.name, union)
        for e in errors:
            log.warning("sync_schema failed: %s", e)

    def get_diff(self) -> List[Tuple[NodeInfo, bytes]]:
        # chaos site (utils/faults.py): drop = the whole gather vanishes
        # on the wire, error/delay model a sick master-side fan-out
        if faults.is_armed() and faults.fire("mix.comm.get_diff"):
            return []
        results, errors = self._mc.call_collect("mix_get_diff", self.name)
        for e in errors:
            log.warning("get_diff failed: %s", e)
        return [(NodeInfo(h, p), r) for (h, p), r in results]

    def put_diff(self, packed: bytes) -> Dict[str, bool]:
        # chaos site: drop = the broadcast is lost (no member acks)
        if faults.is_armed() and faults.fire("mix.comm.put_diff"):
            return {}
        results, errors = self._mc.call_collect("mix_put_diff", self.name, packed)
        for e in errors:
            log.warning("put_diff failed: %s", e)
        out = {f"{h}_{p}": bool(r) for (h, p), r in results}
        for e in errors:
            out[f"{e.host}_{e.port}"] = False
        return out

    def get_model(self, member: NodeInfo) -> bytes:
        with RpcClient(member.host, member.port, self.timeout) as c:
            return c.call("mix_get_model", self.name)

    def collect(self, method: str, *args):
        """Parallel fan-out of one RPC to all members (the collective
        mixer's prepare and abort); returns (results, errors)."""
        return self._mc.call_collect(method, self.name, *args)

    def close(self) -> None:
        if self._mc is not None:
            self._mc.close()
            self._mc = None

    def register_active(self, node: NodeInfo, active: bool) -> None:
        # The master only DEMOTES failed members (removal is session-less).
        # Promotion happens on the member itself via on_active — an actives
        # entry must be an ephemeral owned by the member's own session, or it
        # dies with the master instead of with the member.
        if not active:
            membership.unregister_active(
                self.coord, self.engine, self.name, node.host, node.port
            )


class RpcLinearMixer:
    """Drives one driver's participation in the cluster mix."""

    def __init__(
        self,
        driver: Any,
        comm: LinearCommunication,
        *,
        self_node: Optional[NodeInfo] = None,
        interval_sec: float = 16.0,
        interval_count: int = 512,
        quorum_fraction: float = 0.5,
        guard: Optional[MixGuard] = None,
    ) -> None:
        self.driver = driver
        self.comm = comm
        self.self_node = self_node
        #: model-integrity admission guard: screens every contribution before
        #: it enters a fold and every folded total before it applies —
        #: --mix-guard {off,warn,quarantine} + --mix-norm-bound
        self.guard = guard if guard is not None else MixGuard()
        #: set by the owning server: called when put_diff refuses a
        #: non-finite folded total, so the server can roll back to its
        #: last-good model snapshot
        self.on_poisoned_total: Optional[Any] = None
        #: minimum fraction of members whose diffs must arrive for the
        #: round to proceed (--mix-quorum). The reference aborts only
        #: when ALL get_diffs fail — a round folding 1 of 50 diffs then
        #: broadcasting it as everyone's new base is technically a mix
        #: but practically a rollback. Rounds that proceed with missing
        #: members are DEGRADED: counted (mix.quorum_degraded) and
        #: stamped in the flight recorder.
        self.quorum_fraction = float(quorum_fraction)
        #: per-round flight recorder (framework/mixer.py): master rounds
        #: land via the scheduler, failure reasons are recorded by the
        #: mixer directly
        self.flight = MixFlightRecorder()
        if self_node is not None:
            self.flight.node = self_node.name
        self._scheduler = IntervalMixer(
            self._mix_round,
            interval_sec=interval_sec,
            interval_count=interval_count,
            flight=self.flight,
        )
        self.mix_count = 0
        self.bytes_sent = 0
        self._obsolete = False
        #: mix epoch (≙ core::storage::version, linear_mixer.cpp:48,222-233):
        #: bumped on every applied round. A node whose version is behind the
        #: round's base missed history its peers hold only in their MASTER
        #: arrays (diffs are deltas!), so applying the fold cannot catch it
        #: up — it must pull a full model (the restart/joining case).
        self.model_version = 0
        #: the round base that declared us obsolete: recovery must pull a
        #: model at least this current or keep trying
        self._required_version = 0
        #: set by the owning server: called with True/False after each
        #: locally-applied put_diff so the member (re)registers ITSELF in the
        #: actives list through its own coordinator session
        self.on_active: Optional[Any] = None
        # -- model-health plane ------------------------------------------
        #: master-side staleness bookkeeping: rounds THIS node led, and
        #: per-member (round index of last contribution, round index
        #: first seen) — staleness = rounds since a member's diff last
        #: made it into a fold this master ran
        self._rounds_led = 0
        self._member_last_contrib: Dict[str, int] = {}
        self._member_first_seen: Dict[str, int] = {}
        #: membership epoch the ledger entries were accumulated under:
        #: when the epoch bumps, entries for names no longer in the member
        #: set are dropped — a drained node that later rejoins under the
        #: same name is re-seeded fresh instead of inheriting rounds of
        #: bogus staleness from its past life
        self._ledger_epoch = 0
        #: did the last master round this node led proceed without every
        #: member's diff?
        self.last_round_degraded = False
        #: member-side staleness: consecutive put_diffs this member
        #: failed to apply (0 = healthy; grows while obsolete/recovering)
        self.self_staleness = 0
        #: last round's convergence stats, as received in the put_diff
        #: payload (every member holds the master's computed view)
        self.last_health: Dict[str, Any] = {}
        #: the last background recovery attempt (put_diff found this
        #: member obsolete), if any
        self.recover_thread: Optional[threading.Thread] = None

    # -- RPC surface served by the owning server (linear_mixer.cpp:270-290) --
    def register_api(self, rpc_server, name_check: str = "") -> None:
        # mix_get_diff / mix_get_model answer packed bytes (msgpack bin)
        rpc_server.register("mix_get_schema", lambda _name: self.local_get_schema())
        rpc_server.register(
            "mix_sync_schema", lambda _name, union: self.local_sync_schema(union)
        )
        rpc_server.register("mix_get_diff", lambda _name: self.local_get_diff())
        rpc_server.register(
            "mix_put_diff", lambda _name, packed: self.local_put_diff(packed)
        )
        rpc_server.register("mix_get_model", lambda _name: self.local_get_model())
        # flight recorder: structured per-round history — the
        # same records jubadump --mix-history dumps
        rpc_server.register(
            "get_mix_history", lambda _name: self.flight.snapshot())
        # do_mix itself is served by the engine server (it delegates here)

    def local_get_schema(self) -> List[str]:
        with self._on_driver():
            return (
                self.driver.get_schema() if hasattr(self.driver, "get_schema") else []
            )

    def local_sync_schema(self, union) -> bool:
        with self._on_driver():
            if hasattr(self.driver, "sync_schema"):
                self.driver.sync_schema([
                    s.decode() if isinstance(s, bytes) else s for s in union
                ])
        return True

    def local_diff_obj(self, materialize: bool = False,
                       canonical_schema: bool = False) -> Dict[str, Any]:
        """My diff as a payload dict (model read lock;
        linear_mixer.cpp:562-579) — in-process consumers (push exchange)
        use this directly, skipping the wire pack/unpack.

        ``materialize=True`` reads device leaves back to host numpy INSIDE
        the lock: the RPC pack runs after release, and a train step in
        between would race the very buffers the snapshot references.

        ``canonical_schema=True`` is the ASYNC plane's extra contract:
        ``get_schema`` is sorted but diff ROWS sit in slot (training)
        order, and the async fold has no pre-round schema phase to
        align contributors — so the snapshot first aligns its own rows
        to its sorted vocabulary (a no-op in steady state). The sync
        round must NOT do this: its schema phase already aligned slots
        to the union, and re-sorting around a just-trained novel label
        would break the trailing-row pad tree_sum relies on.

        The lock-held time is the snapshot's ENTIRE train-path cost —
        gauged as ``mix.snapshot_stall_ms``."""
        with self.trace.span("mix.stall.snapshot") as sp:
            with self._on_driver():
                if canonical_schema and self._has_schema() and \
                        hasattr(self.driver, "sync_schema"):
                    self.driver.sync_schema(self.driver.get_schema())
                diffs = {
                    name: m.get_diff()
                    for name, m in self.driver.get_mixables().items()
                }
                if materialize:
                    diffs = tree_map(_host, diffs)
                schema = (
                    self.driver.get_schema()
                    if hasattr(self.driver, "get_schema") else []
                )
        self.trace.gauge("mix.snapshot_stall_ms", round(sp.seconds * 1e3, 3))
        # chaos site: nan patches one element of a float leaf (a single
        # bad datum), scale:F multiplies the whole contribution (a
        # runaway learner) — the poisons the admission guard must catch.
        # The site carries this NODE's name so a drill can poison exactly
        # one member of an in-process cluster; arm `mix.diff.poison*` to
        # hit any member. Mutates only the outgoing snapshot (leaves
        # copy), never the model.
        if faults.is_armed():
            site = "mix.diff.poison" + (
                f".{self.self_node.name}" if self.self_node is not None
                else "")
            mut = faults.fire_mutate(site)
            if mut is not None:
                diffs = faults.poison_tree(diffs, mut)
        return {"protocol": PROTOCOL_VERSION, "schema": schema,
                "version": self.model_version, "diffs": diffs}

    def local_get_diff(self) -> bytes:
        # materialize: the pack below runs OUTSIDE the model lock, and a
        # train step in between would race the snapshot's buffers
        obj = self.local_diff_obj(materialize=True)
        with self.trace.span("mix.diff.pack"):
            return pack_mix(obj)

    def local_put_diff(self, packed: bytes) -> bool:
        # chaos site: drop = this member silently loses the broadcast
        # (it goes stale and recovers via the existing ladder)
        if faults.is_armed() and faults.fire("mix.put_diff"):
            return False
        with self.trace.span("mix.total.unpack"):
            msg = unpack_mix(packed)
        return self.local_put_obj(msg)

    def local_put_obj(self, msg) -> bool:
        """Apply a reduced-diff message already in object form."""
        if msg.get("protocol") != PROTOCOL_VERSION:
            log.error("mix protocol mismatch: %s", msg.get("protocol"))
            return False
        health = msg.get("health")
        if isinstance(health, dict):
            self._note_health(health)
        # the last line of defense — a non-finite folded total must
        # NEVER reach the weights (NaN is absorbing under the apply's
        # adds; one poisoned broadcast resets every member to garbage).
        # quarantine mode refuses the apply and asks the owning server
        # to roll back to last-good; warn mode counts and proceeds. The
        # obsolete/recovery ladder is skipped on refusal: the model we
        # HOLD is good, and a peer pull could import the very poison we
        # just refused.
        # guard_screened: the collective entry already screened these
        # totals where they live — a host re-screen would read a device
        # payload back whole
        if self.guard.enabled and not msg.get("guard_screened") and \
                self._total_poisoned(msg):
            if self.guard.mode != "quarantine":
                log.warning("mix guard (warn): non-finite folded total "
                            "applied anyway")
            else:
                self._poisoned_total_rollback()
                return False
        base_version = int(msg.get("base_version", 0))
        if self.model_version < base_version:
            # I missed rounds (fresh boot / restart): the fold is deltas
            # only — reject it and pull a full model instead
            # (linear_mixer.cpp:644-652 put_diff → not_obsolete=false)
            log.warning("model obsolete (mine v%d < round base v%d); "
                        "recovering", self.model_version, base_version)
            self._required_version = base_version
            ok = False
        else:
            # everything above this lock (unpack, version gate, health
            # adoption) ran without the model lock: the apply holds it
            # only for the put_diff swaps — that lock-held time is the
            # round's whole train-path stall, gauged per apply
            with self.trace.span("mix.stall.apply") as sp:
                with self._on_driver():
                    if msg.get("schema") and \
                            hasattr(self.driver, "sync_schema"):
                        self.driver.sync_schema(list(msg["schema"]))
                    ok = True
                    mixables = self.driver.get_mixables()
                    for name, diff in msg["diffs"].items():
                        m = mixables.get(name)
                        if m is not None:
                            ok = bool(m.put_diff(diff)) and ok
                    if ok:
                        # version bump INSIDE the lock: a reader holding
                        # the model lock sees (model, version) move
                        # together — no torn snapshot/version pairs
                        self.model_version = base_version + 1
            self.trace.gauge("mix.apply_stall_ms",
                             round(sp.seconds * 1e3, 3))
        self.trace.gauge("mix.model_version", float(self.model_version))
        self._obsolete = not ok
        # member-side staleness: every member gauges its OWN distance
        # from the cluster's round cadence (applied rounds reset it)
        self.self_staleness = 0 if ok else self.self_staleness + 1
        self.trace.gauge("mix.self_staleness", self.self_staleness)
        if self.on_active is not None:
            try:
                self.on_active(ok)
            except Exception:  # broad-ok
                log.exception("active-list transition failed")
        if not ok:
            # pull a full model from a peer once the round settles
            # (linear_mixer.cpp:404-424 runs this from the stabilizer loop);
            # the handle lets a caller wait for the attempt to finish
            self.recover_thread = threading.Thread(
                target=self._recover_soon, daemon=True, name="mix-recover")
            self.recover_thread.start()
        return ok

    def _note_health(self, health: Dict[str, Any]) -> None:
        """Adopt one round's convergence stats (master-computed):
        remember the dict for get_status and publish the scalar gauges
        every member carries."""
        norm = {k.decode() if isinstance(k, bytes) else str(k): v
                for k, v in health.items()}
        self.last_health = norm
        # HLC causality: adopting a round's health payload is
        # receiving a message from the master — merge its clock so this
        # member's subsequent events sort after the fold that drove them
        if norm.get("hlc"):
            events.observe(norm["hlc"])
        for key in ("premix_divergence_mean", "premix_divergence_max",
                    "premix_divergence", "update_norm", "staleness_max",
                    "contributors"):
            v = norm.get(key)
            if isinstance(v, (int, float)):
                self.trace.gauge(f"mix.{key}", float(v))

    def _total_poisoned(self, msg) -> bool:
        """Finite screen of an incoming folded total over the summable
        mixables."""
        try:
            names = _sum_names(self.driver.get_mixables())
            return payload_nonfinite(msg.get("diffs") or {}, names)
        except Exception:  # broad-ok — the screen must never fail an apply
            log.warning("guard total screen failed", exc_info=True)
            return False

    def _poisoned_total_rollback(self) -> None:
        """One refused non-finite total: count, emit, and hand the
        server the auto-rollback trigger."""
        log.error("mix guard: refusing non-finite folded total "
                  "(rolling back to last-good)")
        self._count("mix.guard.nonfinite_total")
        self.trace.events.emit(
            "mix", "poisoned_total_refused", severity="error")
        if self.on_poisoned_total is not None:
            try:
                self.on_poisoned_total()
            except Exception:  # broad-ok — rollback failure must not
                log.exception("auto-rollback failed")  # kill the apply path

    def _guard_round(self, entries, mixables):
        """Master-side admission screen: screen every
        contribution's summable mixables for non-finite leaves and
        update-norm outliers before anything enters the fold. Returns
        the surviving (node, payload) list + the GuardReport (None when
        the guard is off). Counting/events happen here so the keys land
        in the owning server's registry; a quarantined member's entry
        is dropped, which also keeps it out of the round's contributed
        set — its staleness ledger entry grows exactly like a member
        whose get_diff failed."""
        guard = self.guard
        if not guard.enabled or not entries:
            return entries, None
        rep = self._guard_screen(
            {node.name: p["diffs"] for node, p in entries},
            _sum_names(mixables))
        if guard.mode != "quarantine":
            return entries, rep
        return [(n, p) for n, p in entries
                if n.name in rep.admitted], rep

    def _guard_screen(self, by_member, names):
        """Run one full guard screen over member -> diffs and turn the
        report into counters/events/gauges in the owning registry."""
        guard = self.guard
        rep = guard.screen(by_member, names)
        for member, reason in rep.flagged.items():
            if reason in ("nonfinite", "norm_outlier"):
                self._count(f"mix.guard.{reason}")
        if rep.flagged:
            if guard.mode == "quarantine":
                self._count("mix.quarantined", len(rep.flagged))
            self.trace.events.emit(
                "mix", "guard_flagged", severity="warning",
                mode=guard.mode, flagged=dict(rep.flagged))
        for member in rep.quarantined_now:
            log.error("mix guard: member %s quarantined", member)
            self.trace.events.emit("mix", "member_quarantined",
                                   severity="error", member=member)
        for member in rep.released:
            log.info("mix guard: member %s released from quarantine",
                     member)
            self.trace.events.emit("mix", "member_released",
                                   member=member)
        self.trace.gauge("mix.guard.quarantined_members",
                         float(len(guard.quarantined())))
        return rep

    def _recover_soon(self) -> None:
        time.sleep(0.2)  # let the master finish broadcasting this round
        try:
            self.maybe_recover()
        except Exception:  # broad-ok — retried on the next round
            log.exception("model recovery failed")

    def local_get_model(self) -> bytes:
        with self._on_driver():
            return pack_mix(
                {"protocol": PROTOCOL_VERSION, "model": self.driver.pack(),
                 "version": self.model_version}
            )

    def _on_driver(self):
        """The model lock, entered on the driver's device."""
        return on_driver(self.driver)

    def set_trace_registry(self, registry) -> None:
        """Route mix.round spans into the owning server's registry (and
        the comm seam's breaker transitions with them)."""
        self._scheduler.trace = registry
        if hasattr(self.comm, "breakers"):
            self.comm.breakers.registry = registry

    @property
    def trace(self):
        """The owning server's tracing registry (mix.phase.* spans)."""
        return self._scheduler.trace

    def _count(self, name: str, n: int = 1) -> None:
        """Bump a counter in the owning server's registry."""
        self._scheduler.trace.count(name, n)

    # -- scheduling (≙ stabilizer_loop) --------------------------------------
    def start(self) -> None:
        self._scheduler.start()

    def stop(self) -> None:
        self._scheduler.stop()
        if hasattr(self.comm, "close"):
            self.comm.close()

    def updated(self, n: int = 1) -> None:
        self._scheduler.updated(n)

    def mix_now(self) -> Optional[Dict[str, Any]]:
        return self._scheduler.mix_now()

    def _has_schema(self) -> bool:
        """True iff the driver class overrides DriverBase.get_schema — only
        those engines pay the two schema fan-outs per round."""
        cls_fn = getattr(type(self.driver), "get_schema", None)
        return cls_fn is not None and \
            cls_fn is not getattr(DriverBase, "get_schema", None)

    # -- the round (≙ linear_mixer::mix) -------------------------------------
    def _mix_round(self) -> Optional[Dict[str, Any]]:
        if self._obsolete:
            self.maybe_recover()
        members = self.comm.update_members()
        if len(members) < 2 and self.self_node is not None:
            return None  # nothing to mix with
        if not self.comm.try_lock():
            return None  # someone else is master this round
        try:
            return self._run_as_master(members)
        finally:
            self.comm.unlock()

    def _run_as_master(self, members: Sequence[NodeInfo]) -> Optional[Dict[str, Any]]:
        t0 = time.monotonic()
        phases: Dict[str, Any] = {}
        # Each phase is a registry span (mix.phase.*): the flight record
        # keeps its per-round ms, the histograms accumulate the quantile
        # view.
        # phase 1: schema alignment (classifier label vocab, stat keys) —
        # skipped entirely for engines that don't define a row schema
        with self.trace.span("mix.phase.schema") as sp:
            schemas = self.comm.get_schemas() if self._has_schema() else []
            schema_union: List[str] = sorted(
                set().union(*(set(s) for s in schemas))
            ) if schemas else []
            schema_union = [
                s.decode() if isinstance(s, bytes) else s
                for s in schema_union
            ]
            if schema_union:
                self.comm.sync_schema(schema_union)
        phases["schema_ms"] = round(sp.seconds * 1e3, 2)
        # phase 2: pull row-aligned diffs
        with self.trace.span("mix.phase.get_diff") as sp:
            replies = self.comm.get_diff()
            if not replies:
                log.error("mix aborted: all get_diffs failed")
                self.flight.record("rpc", ok=False,
                                   reason="all_get_diffs_failed",
                                   members=len(members))
                return None
            with self.trace.span("mix.diff.unpack"):
                entries = [(node, unpack_mix(p)) for node, p in replies]
            entries = [(node, p) for node, p in entries
                       if p.get("protocol") == PROTOCOL_VERSION]
            payloads = [p for _, p in entries]
            if not payloads:
                self.flight.record("rpc", ok=False,
                                   reason="no_protocol_payloads",
                                   members=len(members))
                return None
            # quorum gate: proceeding on a sliver of the cluster would
            # broadcast a near-empty fold as everyone's new base version
            if len(payloads) < self.quorum_fraction * len(members):
                log.error("mix aborted: quorum not met (%d/%d diffs, quorum "
                          "%.0f%%)", len(payloads), len(members),
                          self.quorum_fraction * 100)
                self._count("mix.quorum_aborted")
                self.trace.events.emit(
                    "mix", "quorum_abort", severity="error",
                    contributors=len(payloads), members=len(members))
                self.flight.record(
                    "rpc", ok=False,
                    reason=f"quorum_not_met: {len(payloads)}/{len(members)}",
                    members=len(members))
                return None
            degraded = len(payloads) < len(members)
            if degraded:
                self._count("mix.quorum_degraded")
                self.trace.events.emit(
                    "mix", "quorum_degraded", severity="warning",
                    contributors=len(payloads), members=len(members))
        phases["get_diff_ms"] = round(sp.seconds * 1e3, 2)
        # phase 3: pairwise fold per mixable (linear_mixer.cpp:481-499)
        with self.trace.span("mix.phase.fold") as sp:
            mixables = self.driver.get_mixables()
            # model-integrity admission screen: quarantine a
            # poisoned contribution BEFORE it enters the fold — NaN is
            # absorbing under tree_sum, and the broadcast would poison
            # every member in one round
            entries, guard_rep = self._guard_round(entries, mixables)
            if not entries:
                log.error("mix aborted: every contribution quarantined")
                self._count("mix.guard.all_quarantined")
                self.flight.record("rpc", ok=False,
                                   reason="all_quarantined",
                                   members=len(members))
                return None
            payloads = [p for _, p in entries]
            totals: Dict[str, Any] = {}
            for name, mixable in mixables.items():
                diffs = [p["diffs"][name] for p in payloads
                         if name in p["diffs"]]
                if not diffs:
                    continue
                custom_mix = getattr(mixable, "mix", None)
                if custom_mix is not None:
                    totals[name] = functools.reduce(custom_mix, diffs)
                else:
                    totals[name] = tree_sum(diffs)
            # the round's base = the most advanced contributor; anyone
            # behind it cannot be caught up by deltas and must recover a
            # full model
            base_version = max(
                (int(p.get("version", 0)) for p in payloads), default=0
            )
            # mix-convergence telemetry: divergence of each
            # contribution vs the folded average + per-member staleness,
            # shipped INSIDE the put_diff payload so every member (not
            # just the master) gauges the round's health. Old peers
            # ignore the extra key — the protocol version is unchanged.
            health = mix_health([p["diffs"] for p in payloads], totals,
                                _sum_names(mixables))
            health.update(self._staleness_update(
                members, {node.name for node, _ in entries}))
            # master-side total screen: even with every
            # contribution admitted, the FOLD can overflow to inf —
            # never broadcast a non-finite total (quarantine mode
            # aborts the round; warn counts and proceeds)
            if self.guard.enabled and \
                    payload_nonfinite(totals, _sum_names(mixables)):
                self._count("mix.guard.nonfinite_total")
                self.trace.events.emit(
                    "mix", "nonfinite_fold_total", severity="error",
                    mode=self.guard.mode)
                if self.guard.mode == "quarantine":
                    log.error("mix aborted: folded total is non-finite")
                    self.flight.record("rpc", ok=False,
                                       reason="nonfinite_fold_total",
                                       members=len(members))
                    return None
            # event plane: the master's HLC rides the
            # broadcast; receivers observe() it in _note_health, so a
            # member's post-apply events sort after the round that
            # caused them even under skewed wall clocks
            health["hlc"] = events.hlc_now()
            packed = pack_mix(
                {"protocol": PROTOCOL_VERSION, "schema": schema_union,
                 "base_version": base_version, "diffs": totals,
                 "health": health}
            )
        phases["fold_ms"] = round(sp.seconds * 1e3, 2)
        with self.trace.span("mix.phase.put_diff") as sp:
            acks = self.comm.put_diff(packed)
        phases["put_diff_ms"] = round(sp.seconds * 1e3, 2)
        # active-list transitions (linear_mixer.cpp:658-681): master demotes
        # failures; successes promote themselves via on_active
        for member in members:
            if not acks.get(member.name, False):
                self.comm.register_active(member, False)
        self.mix_count += 1
        self.bytes_sent += len(packed)
        self._count("mix.bytes_shipped", len(packed))
        log.info(
            "mix round %d: %d members, %d bytes, %.3fs",
            self.mix_count, len(members), len(packed), time.monotonic() - t0,
        )
        self.last_round_degraded = bool(degraded)
        # elastic membership: stamp the ring version the
        # round's member set (and therefore its quorum denominator) was
        # read under — churn forensics read it off the flight record
        epoch = self.comm.membership_epoch() \
            if hasattr(self.comm, "membership_epoch") else 0
        if epoch:
            self.trace.gauge("mix.epoch", float(epoch))
        return {"members": len(members), "bytes": len(packed),
                "mode": "rpc", "phases": phases,
                "contributors": len(payloads),
                "degraded": True if degraded else None,
                "epoch": epoch or None,
                "health": health or None,
                "quarantined": sorted(guard_rep.flagged)
                if guard_rep is not None and guard_rep.flagged else None,
                "acked": sum(bool(v) for v in acks.values())}

    def _staleness_update(self, members: Sequence[NodeInfo],
                          contributed: set) -> Dict[str, Any]:
        """Advance the master-side staleness ledger for one led round
        and return the health fields: per-member rounds since last
        contribution (0 = contributed this round) and the max.

        The ledger is keyed by node name and survives membership epoch
        changes by REBASING: when the membership epoch bumps,
        entries for names no longer registered are dropped, so a node
        that drained away and later rejoined under the same name is
        seeded fresh by the setdefault below instead of inheriting the
        staleness its past incarnation accrued while gone."""
        epoch = self.comm.membership_epoch() \
            if hasattr(self.comm, "membership_epoch") else 0
        if epoch != self._ledger_epoch:
            current = {m.name for m in members}
            for ledger in (self._member_last_contrib,
                           self._member_first_seen):
                for name in [n for n in ledger if n not in current]:
                    del ledger[name]
            self._ledger_epoch = epoch
        self._rounds_led += 1
        idx = self._rounds_led
        staleness: Dict[str, int] = {}
        for m in members:
            self._member_first_seen.setdefault(m.name, idx - 1)
            if m.name in contributed:
                self._member_last_contrib[m.name] = idx
            base = self._member_last_contrib.get(
                m.name, self._member_first_seen[m.name])
            staleness[m.name] = idx - base
        if not staleness:
            return {}
        return {"staleness": staleness,
                "staleness_max": max(staleness.values())}

    # -- obsolete-model recovery (linear_mixer.cpp:404-424,598-632) ----------
    def maybe_recover(self) -> bool:
        if not self._obsolete:
            return False
        members = [
            m for m in self.comm.update_members()
            if self.self_node is None or m.name != self.self_node.name
        ]
        if not members:
            return False
        # a random member may be another stale joiner mid-recovery; try a
        # few and accept only a model at least as current as the round base
        # that declared us obsolete (the reference re-tries each stabilizer
        # tick until current, linear_mixer.cpp:404-424)
        random.shuffle(members)
        for peer in members[:3]:
            try:
                packed = self.comm.get_model(peer)
            except Exception as e:  # broad-ok — dead peer, try another
                log.warning("recovery pull from %s failed: %s", peer.name, e)
                continue
            msg = unpack_mix(packed)
            if msg.get("protocol") != PROTOCOL_VERSION:
                raise RuntimeError(
                    "protocol version mismatch on recovery — restart")
            version = int(msg.get("version", 0))
            if version < self._required_version:
                log.info("peer %s model v%d < required v%d; trying another",
                         peer.name, version, self._required_version)
                continue
            with self._on_driver():
                self.driver.unpack(msg["model"])
            self.model_version = version
            self._obsolete = False
            log.info("recovered full model (v%d) from %s",
                     version, peer.name)
            return True
        return False  # retried next stabilizer tick / round

    def get_status(self) -> Dict[str, Any]:
        st = self._scheduler.get_status()
        st.update({"bytes_sent": self.bytes_sent, "obsolete": self._obsolete,
                   "model_version": self.model_version,
                   "quorum_fraction": self.quorum_fraction,
                   "self_staleness": self.self_staleness,
                   "last_round_degraded": self.last_round_degraded})
        # model-integrity plane: guard mode + quarantine set
        st.update(self.guard.status())
        for k, v in self.last_health.items():
            if isinstance(v, (int, float, dict)):
                st[f"health_{k}"] = v
        breakers = getattr(self.comm, "breakers", None)
        if breakers is not None:
            snap = breakers.snapshot()
            st["breaker_backends"] = len(snap)
            st["breaker_open"] = sum(
                1 for b in snap.values() if b["state"] == "open")
        return st
