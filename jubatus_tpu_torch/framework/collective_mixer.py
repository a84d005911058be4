"""Collective mixer — the production mix as a collective across the ranks
of one ``torch.distributed`` world (counterpart of
``jubatus_tpu/framework/collective_mixer.py``).

``--mixer collective_mixer``: the control plane stays on the coordinator
and RPC (master election by the coordinator lock, schema sync, a
two-phase prepare/GO), but the DIFF payload — the reference's get_diff
fan-out, pairwise fold and put_diff broadcast (linear_mixer.cpp:437-559)
— moves onto the collective (parallel/collective.py).

Round protocol (master = this round's lock holder):

1. ``mix_prepare(round, schema_union)`` (RPC): every member syncs the
   schema, STAGES its local diff (device-resident, copied under the model
   lock), starts a GO waiter, and answers (version, signature). Nothing
   has entered a collective yet.
2. The master verifies every member staged with one signature and that
   the world's rank count matches the member set; any mismatch aborts the
   round (members discard their stage) and the round falls back to the
   plain RPC mix, so the cluster always mixes.
3. The master writes a GO marker into the COORDINATOR: a member enters
   the collective only when it OBSERVES the marker, so no dropped message
   can leave part of the world inside the reduce. Each member runs
   ``psum_pytree`` on its staged diff, applies the identical total as the
   RPC path does, and writes an ack node the master folds into the
   actives transitions.

The signature carries a backend tag only this package signs
(``|backend=torch``): a JAX member and a port member always mismatch at
prepare and mix over RPC, so the two packages never enter one collective.

Failure model: a member that never observes GO makes a FINAL verification
read before discarding its stage — GO present after all: enter late; GO
verifiably absent: discard; coordinator UNREADABLE (peers may be inside
the collective): the member destroys its process group, which turns into
errors in every peer's collectives within the group's bounded timeout
(parallel/multihost.py), and routes its later rounds to the RPC mix
(``collective_dead``). Engines whose mixables are not plain sums are
detected in prepare and served by the RPC path unchanged.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from jubatus_tpu_torch.coord import membership
from jubatus_tpu_torch.coord.base import NodeInfo
from jubatus_tpu_torch.framework.linear_mixer import (
    PROTOCOL_VERSION,
    RpcLinearMixer,
    _leaf_sq,
    _sum_names,
    divergence_sq,
)
from jubatus_tpu_torch.parallel import collective, multihost
from jubatus_tpu_torch.utils.serialization import pack_obj, unpack_obj
from jubatus_tpu_torch.utils.tree import tree_flatten, tree_leaves

log = logging.getLogger(__name__)

#: how long a prepared member waits to observe the GO marker before
#: discarding its staged diff
GO_WAIT_SEC = 20.0
_GO_POLL_SEC = 0.05

#: the signature tag only this package signs
BACKEND_TAG = "|backend=torch"


def go_wait(interconnect_timeout: float) -> float:
    """A member's GO deadline for a fleet whose RPC timeout is
    ``interconnect_timeout``: it must exceed the prepare fan-out's
    timeout, since GO is written at most one such timeout after the first
    member staged."""
    return max(GO_WAIT_SEC, 3.0 * interconnect_timeout)


def collective_timeout(interconnect_timeout: float) -> float:
    """The process group's timeout: a member's collectives wait at most
    this for a peer. Longer than the GO window (a peer may enter that
    much later) with room for one round's reduce."""
    return 3.0 * go_wait(interconnect_timeout)


def _summable(mixable: Any) -> bool:
    return getattr(mixable, "mix", None) is None or \
        getattr(mixable, "MIX_IS_SUM", False)


def _staged_diff(mixable: Any) -> Any:
    """The diff the collective takes: the device-resident copy where the
    mixable offers one, as the JAX models' diffs are, so a full-width
    round pays no device→host→device trip."""
    fn = getattr(mixable, "get_device_diff", None)
    return fn() if fn is not None else mixable.get_diff()


def elect_representatives(member_names, topo) -> Dict[int, str]:
    """host index -> the member fronting that host on the inter-host wire.
    Derived ONLY from the full registered member list + topology (names
    sorted, grouped host-major; the group's first name represents it), so
    a degraded round cannot reshuffle representatives. Empty when the
    member count fits neither one process per (host, local) slot nor one
    per host."""
    if topo is None:
        return {}
    names = sorted(member_names)
    if len(names) == topo.hosts * topo.locals:
        return {h: names[h * topo.locals] for h in range(topo.hosts)}
    if len(names) == topo.hosts:
        return {h: names[h] for h in range(topo.hosts)}
    return {}


def _signature(diffs: Dict[str, Any]) -> str:
    """Canonical shape/dtype signature; every member must match before
    anyone enters the collective. 64-bit leaves report "unsupported": a
    reduce in float32 would be LESS exact than the RPC fold. Shapes come
    from the leaves' attributes, never a readback."""
    parts: List[str] = []
    for name in sorted(diffs):
        leaves, spec = tree_flatten(diffs[name])
        sigs = []
        for x in leaves:
            _, dtype, shape = collective._leaf_meta(x)
            if dtype in collective._64BIT:
                return "unsupported"
            sigs.append(f"{tuple(shape)}/{str(dtype).replace('torch.', '')}")
        parts.append(f"{name}:{spec}:{','.join(sigs)}")
    return "|".join(parts)


class CollectiveMixer(RpcLinearMixer):
    """RpcLinearMixer whose round rides the collective when it can, and
    the RPC fan-out when it can't (non-sum mixables, a world mismatch,
    prepare failures)."""

    def __init__(self, *args, compress: Any = False,
                 topology: str = "", **kwargs) -> None:
        super().__init__(*args, **kwargs)
        #: --mix-compress: off / bf16 / int8 (a bool still resolves);
        #: folded into the prepare signature
        self.compress = compress
        #: chunk plan override (set_wire_plan); None = the module default
        self.chunk_mb: Optional[float] = None
        #: bumped by every set_wire_plan
        self.plan_version = 0
        #: --mix-topology: "" flat, "auto", or an explicit "HxM"
        self.topology = topology or ""
        self._topo: Optional[Any] = None
        self._topo_resolved = False
        #: the last per-host representative election a master round made
        self._reps: Dict[int, str] = {}
        #: int8 error-feedback residuals (committed only on success)
        self.ef: Optional[collective.ErrorFeedback] = None
        self._staged_lock = threading.Lock()
        self._staged: Dict[str, Dict[str, Any]] = {}
        self._round_seq = 0
        self.collective_rounds = 0
        self.fallback_rounds = 0
        #: set once this member destroyed its process group: every later
        #: round mixes over RPC
        self.collective_dead = False
        #: rounds to answer "unsupported" after a chunk integrity failure
        self._force_rpc_rounds = 0
        self.integrity_failures = 0
        #: phases of the last collective entry this member ran
        self.last_phases: Dict[str, Any] = {}
        #: error-feedback residual norms cached at round end
        self._ef_norms: Dict[str, float] = {}

    def set_wire_plan(self, chunk_mb: Optional[float] = None,
                      compress: Any = None) -> Dict[str, Any]:
        """Retarget this member's wire plan. Only the NEXT prepare signs
        it; a fleet changing plans out of step mismatches at prepare and
        mixes that round over RPC. Returns the applied plan."""
        if chunk_mb is not None:
            self.chunk_mb = max(0.25, float(chunk_mb))
        if compress is not None:
            self.compress = collective._norm_compress(compress)
        self.plan_version += 1
        return {"chunk_mb": self.chunk_mb,
                "compress": collective._norm_compress(self.compress),
                "plan_version": self.plan_version}

    def _resolve_topology(self) -> Optional[Any]:
        """The tier shape this member signs and enters with, resolved once
        (a failed resolution logs and stays flat: its signature then
        mismatches correctly-resolved peers, and the round goes to RPC)."""
        if self._topo_resolved:
            return self._topo
        topo = None
        if self.topology:
            try:
                from jubatus_tpu_torch.parallel.mesh import host_topology

                if self.topology == "auto":
                    t = host_topology()
                    topo = t if t.locals > 1 else None
                else:
                    topo = host_topology(override=self.topology)
            except Exception:  # broad-ok — degrade to flat, peers mismatch
                log.warning("cannot resolve mix topology %r; staying flat",
                            self.topology, exc_info=True)
                topo = None
        self._topo = topo
        self._topo_resolved = True
        return topo

    # -- coordinator paths ----------------------------------------------------
    def _go_path(self) -> str:
        actor = membership.actor_path(self.comm.engine, self.comm.name)
        return f"{actor}/collective_go"

    def _ack_dir(self) -> str:
        actor = membership.actor_path(self.comm.engine, self.comm.name)
        return f"{actor}/collective_acks"

    def _ack_leaf(self, rid: str, node_name: str) -> str:
        return f"{rid.replace('/', '_')}__{node_name}"

    def _go_wait(self) -> float:
        return go_wait(getattr(self.comm, "timeout", 10.0))

    # -- RPC surface ---------------------------------------------------------
    def register_api(self, rpc_server, name_check: str = "") -> None:
        super().register_api(rpc_server, name_check)
        rpc_server.register(
            "mix_prepare", lambda _n, rid, union: self.local_prepare(rid, union))
        rpc_server.register(
            "mix_abort", lambda _n, rid: self.local_abort(rid))

    # -- member-side phases --------------------------------------------------
    def local_prepare(self, rid, union) -> List[Any]:
        rid = rid.decode() if isinstance(rid, bytes) else rid
        union = [u.decode() if isinstance(u, bytes) else u for u in union]
        with self._on_driver():
            if union and hasattr(self.driver, "sync_schema"):
                self.driver.sync_schema(union)
            mixables = self.driver.get_mixables()
            if self._force_rpc_rounds > 0:
                # a chunk integrity failure last round: this round mixes
                # over RPC, whose fold-time guard screens on the host
                self._force_rpc_rounds -= 1
                return [int(self.model_version), "unsupported"]
            if self.collective_dead or \
                    not all(_summable(m) for m in mixables.values()):
                return [int(self.model_version), "unsupported"]
            diffs = {name: _staged_diff(m) for name, m in mixables.items()}
        sig = _signature(diffs)
        plan: Optional[Dict[str, Any]] = None
        if sig != "unsupported":
            # the wire mode and the chunk plan ride the signature (the
            # chunked reduce is a SEQUENCE of collectives); the sentinel
            # "unsupported" stays bare. The live plan is snapshot ONCE:
            # the entry runs what prepare signed even if set_wire_plan
            # lands before GO.
            mode = collective._norm_compress(self.compress)
            chunk = collective.DEFAULT_CHUNK_MB if self.chunk_mb is None \
                else float(self.chunk_mb)
            plan = {"mode": mode, "chunk_mb": chunk}
            sig += f"|bf16={int(mode == 'bf16')}"
            if mode == "int8":
                sig += f"|quant=int8:{collective.QUANT_BLOCK}"
            sig += f"|chunk={chunk}"
            topo = self._resolve_topology()
            if topo is not None:
                sig += f"|topo={topo.signature}"
            sig += BACKEND_TAG
        with self._staged_lock:
            # one staged round at a time: a newer prepare supersedes a
            # stale round a dead master left behind
            self._staged = {rid: {"diffs": diffs, "union": union,
                                  "plan": plan}}
        threading.Thread(target=self._wait_for_go, args=(rid,), daemon=True,
                         name="mix-go-wait").start()
        return [int(self.model_version), sig]

    def local_abort(self, rid) -> bool:
        rid = rid.decode() if isinstance(rid, bytes) else rid
        with self._staged_lock:
            return self._staged.pop(rid, None) is not None

    def _read_go(self, rid: str, raw) -> Optional[tuple]:
        """(base, world) of a GO marker naming ``rid``, else None."""
        try:
            msg = unpack_obj(raw)
        except Exception:  # broad-ok
            return None
        if not msg:
            return None
        got = msg.get("rid")
        got = got.decode() if isinstance(got, bytes) else got
        if got != rid:
            return None
        return int(msg.get("base", 0)), int(msg.get("n", 0))

    def _wait_for_go(self, rid: str) -> None:
        """Observe the GO marker, then enter the collective. Entering only
        on OBSERVED shared state makes partial entry impossible for live
        members."""
        deadline = time.monotonic() + self._go_wait()
        go: Optional[tuple] = None
        while time.monotonic() < deadline:
            with self._staged_lock:
                if rid not in self._staged:
                    return  # aborted or superseded
            try:
                raw = self.comm.coord.read(self._go_path())
            except Exception:  # broad-ok — transient coordinator issue
                raw = None
            if raw:
                go = self._read_go(rid, raw)
                if go is not None:
                    break
            time.sleep(_GO_POLL_SEC)
        if go is None:
            # deadline passed without GO. VERIFY its absence before
            # discarding: peers may have observed GO and entered
            with self._staged_lock:
                if rid not in self._staged:
                    return
            try:
                raw = self.comm.coord.read(self._go_path())
            except Exception:  # broad-ok — coordinator unreadable
                raw = False  # sentinel: absence NOT verified
            if raw not in (None, False, b""):
                go = self._read_go(rid, raw)  # enter late: peers wait
            if go is None:
                with self._staged_lock:
                    dropped = self._staged.pop(rid, None)
                if dropped is None:
                    return
                if raw is False:
                    log.error("round %s: no GO within %.0fs and the "
                              "coordinator is unreadable; destroying the "
                              "process group to unblock any entered peers",
                              rid, self._go_wait())
                    self.flight.record(
                        "collective", ok=False, round_id=rid,
                        reason="go_timeout_unverifiable_world_torn_down")
                    self._kill_world()
                else:
                    log.warning("round %s: no GO within %.0fs (verified "
                                "absent); staged diff discarded", rid,
                                self._go_wait())
                    self.flight.record(
                        "collective", ok=False, round_id=rid,
                        reason="go_timeout_verified_absent")
                return
        ok = False
        try:
            ok = self._enter_collective(rid, go[0], go[1])
        except Exception as e:  # broad-ok — world torn down mid-reduce
            log.exception("collective entry failed for round %s", rid)
            self.flight.record("collective", ok=False, round_id=rid,
                               reason=f"entry_failed: {type(e).__name__}: "
                                      f"{e}")
        if self.self_node is not None:
            leaf = (f"{self._ack_dir()}/"
                    f"{self._ack_leaf(rid, self.self_node.name)}")
            payload = b"1" if ok else b"0"
            for attempt in range(3):
                try:
                    if self.comm.coord.create(leaf, payload, ephemeral=True):
                        break
                    self.comm.coord.remove(leaf)  # stale same-name leaf
                except Exception:  # broad-ok
                    if attempt == 2:
                        log.warning("ack write failed for round %s", rid,
                                    exc_info=True)
                    time.sleep(0.1)

    def _kill_world(self) -> None:
        self.collective_dead = True
        self.trace.events.emit("mix", "collective_dead", severity="error")
        try:
            multihost.shutdown()
        except Exception:  # broad-ok — already down is fine
            log.debug("destroying the process group raised", exc_info=True)

    def _enter_collective(self, rid: str, base_version: int,
                          world_n: int = 0) -> bool:
        with self._staged_lock:
            entry = self._staged.pop(rid, None)
        if entry is None:
            return False
        if self.ef is None:
            self.ef = collective.ErrorFeedback()
        self.last_phases = {}
        # the plan prepare SIGNED, not the live attributes
        plan = entry.get("plan") or {}
        try:
            totals = collective.psum_pytree_start(
                entry["diffs"], compress=plan.get("mode", self.compress),
                chunk_mb=plan.get("chunk_mb", self.chunk_mb),
                phases=self.last_phases, prefer_device=True,
                feedback=self.ef, guard=self.guard.mode,
                topology=self._resolve_topology(),
                device=getattr(self.driver, "device", None)).result()
        except collective.ChunkIntegrityError as e:
            # nothing applied; the NEXT round routes to the RPC mix
            self.integrity_failures += 1
            self._force_rpc_rounds = max(self._force_rpc_rounds, 1)
            self._count("mix.guard.chunk_crc_mismatch" if e.kind == "crc"
                        else "mix.guard.nonfinite_total")
            self.trace.events.emit(
                "mix", "chunk_integrity_failure", severity="error",
                kind=e.kind, round_id=rid)
            log.error("collective round %s: %s; next round falls back "
                      "to the RPC mix", rid, e)
            self.flight.record(
                "collective", ok=False, round_id=rid,
                reason=f"chunk_integrity_{e.kind}",
                phases=dict(self.last_phases) or None)
            return False
        health = self._entry_health(entry["diffs"], totals, world_n)
        ok = self.local_put_obj({
            "protocol": PROTOCOL_VERSION,
            "schema": entry["union"],
            "base_version": base_version,
            "diffs": totals,
            "health": health,
            # the collective screened these totals where they live
            "guard_screened": True,
        })
        if ok:
            self._note_round_telemetry()
        self.flight.record("collective", ok=ok, round_id=rid,
                           phases=dict(self.last_phases),
                           health=health or None)
        return ok

    def _entry_health(self, own: Dict[str, Any], totals: Dict[str, Any],
                      world_n: int) -> Dict[str, Any]:
        """Relative L2 of (own contribution − totals / n); empty when the
        GO marker names no world size."""
        if world_n <= 0:
            return {}
        try:
            with self._on_driver():
                names = _sum_names(self.driver.get_mixables())
            if not names:
                return {}
            avg_sq = sum(
                _leaf_sq(t) / (world_n * world_n)
                for name in names if name in totals
                for t in tree_leaves(totals[name]))
            denom = (avg_sq ** 0.5) + 1e-12
            rel = (divergence_sq(own, totals, world_n, names) ** 0.5) / denom
            return {"premix_divergence": round(rel, 6),
                    "update_norm": round((avg_sq ** 0.5) * world_n, 6),
                    "contributors": world_n}
        except Exception:  # broad-ok — telemetry must never fail a round
            log.debug("entry health computation failed", exc_info=True)
            return {}

    def _note_round_telemetry(self) -> None:
        """Round-end gauges: wire MB, the tiers, residual norms and their
        drift rate."""
        for src, key in (("wire_mb", "mix.wire_mb"),
                         ("intra_ms", "mix.intra_ms"),
                         ("inter_ms", "mix.inter_ms"),
                         ("wire_bytes_per_host", "mix.wire_bytes_per_host")):
            v = self.last_phases.get(src)
            if isinstance(v, (int, float)):
                self.trace.gauge(key, float(v))
        if self.ef is None or self.ef.rounds == 0:
            return
        try:
            norms = self.ef.norms()
        except Exception:  # broad-ok — telemetry must never fail a round
            log.debug("ef norm computation failed", exc_info=True)
            return
        prev = self._ef_norms.get("contrib_residual_norm")
        self._ef_norms = norms
        self.trace.gauge("mix.ef_contrib_residual_norm",
                         norms["contrib_residual_norm"])
        self.trace.gauge("mix.ef_total_residual_norm",
                         norms["total_residual_norm"])
        if prev is not None:
            self.trace.gauge("mix.ef_residual_drift_rate",
                             round(norms["contrib_residual_norm"] - prev, 9))

    def _note_fallback(self, reason: str) -> None:
        self.fallback_rounds += 1
        self._count("mix.fallback_rounds")
        self.trace.events.emit("mix", "fallback", severity="warning",
                               reason=reason)

    # -- master round --------------------------------------------------------
    def _run_as_master(self, members: Sequence[NodeInfo]
                       ) -> Optional[Dict[str, Any]]:
        world = collective.world_size()
        if self.collective_dead or world != len(members):
            # the group is gone, or the replicas are not one world (not
            # all joined yet): mix over RPC
            self._note_fallback("collective_dead" if self.collective_dead
                                else "world_mismatch")
            self.flight.record(
                "collective", ok=False,
                reason=("collective_dead" if self.collective_dead
                        else f"world_mismatch: {world} ranks vs "
                             f"{len(members)} members"))
            return super()._run_as_master(members)
        breakers = getattr(self.comm, "breakers", None)
        if breakers is not None and any(
                not breakers.available((m.host, m.port)) for m in members):
            # the collective is all-or-wedge: a member behind an OPEN
            # breaker cannot be counted on to enter
            self._note_fallback("breaker_open_member")
            self.flight.record("collective", ok=False,
                               reason="breaker_open_member",
                               members=len(members))
            return super()._run_as_master(members)
        topo = self._resolve_topology()
        if topo is not None:
            self._reps = elect_representatives(
                [m.name for m in members], topo)
        t0 = time.monotonic()
        schemas = self.comm.get_schemas() if self._has_schema() else []
        union: List[str] = sorted(
            set().union(*(set(s) for s in schemas))) if schemas else []
        union = [s.decode() if isinstance(s, bytes) else s for s in union]

        self._round_seq += 1
        # globally unique rid: a restarted master reuses its name and seq
        rid = (f"{self.self_node.name if self.self_node else 'm'}"
               f"-{self._round_seq}-{os.urandom(6).hex()}")
        results, errors = self.comm.collect("mix_prepare", rid, union)
        sigs = {r[1] if not isinstance(r[1], bytes) else r[1].decode()
                for _, r in results}
        if errors or len(results) != len(members) or len(sigs) != 1 \
                or "unsupported" in sigs:
            self.comm.collect("mix_abort", rid)
            self._note_fallback("prepare_not_viable")
            log.info("collective round %s not viable (%d errors, sigs %s); "
                     "falling back to rpc mix", rid, len(errors), len(sigs))
            self.flight.record(
                "collective", ok=False, round_id=rid,
                reason=f"prepare_not_viable: {len(errors)} errors, "
                       f"{len(sigs)} signatures",
                members=len(members))
            return super()._run_as_master(members)
        base_version = max(int(r[0]) for _, r in results)

        try:
            if not self.comm.coord.set(
                    self._go_path(),
                    pack_obj({"rid": rid, "base": base_version,
                              "n": len(members)})):
                raise RuntimeError("coordinator refused the GO write")
        except Exception:  # broad-ok
            self.comm.collect("mix_abort", rid)
            self._note_fallback("go_write_failed")
            log.warning("collective round %s: GO write failed; falling "
                        "back to rpc mix", rid, exc_info=True)
            self.flight.record("collective", ok=False, round_id=rid,
                               reason="go_write_failed",
                               members=len(members))
            return super()._run_as_master(members)

        # collect acks: once the FIRST ack appears the reduce completed
        # everywhere, so stragglers get only a short grace
        acks: Dict[str, bool] = {}
        ack_dir = self._ack_dir()
        deadline = time.monotonic() + self._go_wait() + 10.0
        grace: Optional[float] = None
        prefix = f"{rid.replace('/', '_')}__"
        while time.monotonic() < deadline and len(acks) < len(members):
            try:
                leaves = [c for c in self.comm.coord.list(ack_dir)
                          if c.startswith(prefix)]
            except Exception:  # broad-ok
                leaves = []
            for leaf in leaves:
                name = leaf[len(prefix):]
                if name in acks:
                    continue
                raw = self.comm.coord.read(f"{ack_dir}/{leaf}")
                if raw is not None:
                    acks[name] = raw == b"1"
            if acks and grace is None:
                grace = time.monotonic() + 5.0
            if grace is not None and time.monotonic() > grace:
                break
            if len(acks) < len(members):
                time.sleep(_GO_POLL_SEC)
        for member in members:
            try:
                self.comm.coord.remove(
                    f"{ack_dir}/{self._ack_leaf(rid, member.name)}")
            except Exception:  # broad-ok
                pass
        if not acks:
            log.error("collective round %s: no member acked", rid)
            self.flight.record("collective_master", ok=False, round_id=rid,
                               reason="no_acks", members=len(members))
            return None
        for member in members:
            if not acks.get(member.name, False):
                self.comm.register_active(member, False)
        self.collective_rounds += 1
        self.mix_count += 1
        log.info("collective mix round %d: %d members (%d acked), %.3fs",
                 self.mix_count, len(members), sum(acks.values()),
                 time.monotonic() - t0)
        out = {"members": len(members), "collective": True,
               "acked": sum(acks.values()),
               "mode": "collective_master", "round_id": rid}
        if topo is not None:
            out["topology"] = topo.signature
            out["representatives"] = sorted(self._reps.values())
        return out

    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        topo = self._resolve_topology()
        st.update(collective_rounds=self.collective_rounds,
                  fallback_rounds=self.fallback_rounds,
                  integrity_failures=self.integrity_failures,
                  collective_dead=self.collective_dead,
                  mix_compress=collective._norm_compress(self.compress),
                  mix_chunk_mb=self.chunk_mb,
                  mix_plan_version=self.plan_version,
                  mix_topology=topo.signature if topo is not None
                  else "flat")
        if self._reps:
            st["mix_representatives"] = sorted(self._reps.values())
        for k, v in multihost.collective_capabilities().items():
            st[f"mix_caps_{k}"] = v
        if self.ef is not None:
            for k, v in self.ef.stats().items():
                st[f"mix_ef_{k}"] = v
        for k, v in self._ef_norms.items():
            st[f"mix_ef_{k}"] = v
        for k, v in self.last_phases.items():
            st[f"last_mix_{k}"] = v
        return st
