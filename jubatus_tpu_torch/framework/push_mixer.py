"""Gossip (push) mixers + candidate strategies (copy of
``jubatus_tpu/framework/push_mixer.py``; ≙ mixer/push_mixer.{hpp,cpp} +
broadcast_mixer / random_mixer / skip_mixer headers).

The reference's push mixers skip master election: each node, on its own
interval, picks candidate peers via a strategy and exchanges model state
pairwise (push_mixer.cpp:342-429). Strategies (mixer_factory.cpp:41-97):

- broadcast: every other member               (broadcast_mixer.hpp:46-55)
- random:    one uniformly random member      (random_mixer.hpp:45-58)
- skip:      Chord-style finger peers at offsets +1, +2, +4, ... around
             the name-sorted member ring      (skip_mixer.hpp:46-57)

Round semantics here: for each candidate, pull her packed diff
(``mix_get_diff`` — the same RPC surface the linear mixer serves, so push
and linear nodes interoperate), fold it with my own diff per mixable, and
apply the fold on BOTH sides (``mix_put_diff``). Each exchange is exactly
a 2-party linear mix; repeated gossip rounds converge the cluster without
any per-round master, trading the linear mixer's O(N) master fan-out for
elastic, leaderless propagation. Schema-bearing engines piggyback the
vocabulary union inside the packed diff (local_put_diff syncs schema
before applying). The wire is the JAX package's, so a JAX member and a
port member exchange as two members of one package do.

``create_mixer`` selects the mixer by the ``--mixer`` flag: the linear
mixer (or, with ``--mix-async``, the async plane of
framework/async_mixer.py), the collective mixer
(framework/collective_mixer.py), a push strategy, or the standalone
no-op.
"""

from __future__ import annotations

import functools
import logging
import random
import time
from typing import Any, Dict, List, Optional, Sequence

from jubatus_tpu_torch.coord.base import NodeInfo
from jubatus_tpu_torch.framework.linear_mixer import (
    PROTOCOL_VERSION,
    LinearCommunication,
    RpcLinearCommunication,
    RpcLinearMixer,
    _sum_names,
    pack_mix,
    unpack_mix,
)
from jubatus_tpu_torch.framework.model_guard import MixGuard
from jubatus_tpu_torch.parallel.mix import tree_sum
from jubatus_tpu_torch.rpc.client import RpcClient
from jubatus_tpu_torch.rpc.errors import is_retryable

log = logging.getLogger(__name__)


# -- candidate strategies -----------------------------------------------------


def broadcast_candidates(members: Sequence[NodeInfo],
                         self_node: Optional[NodeInfo]) -> List[NodeInfo]:
    return [m for m in members
            if self_node is None or m.name != self_node.name]


def random_candidates(members: Sequence[NodeInfo],
                      self_node: Optional[NodeInfo]) -> List[NodeInfo]:
    others = broadcast_candidates(members, self_node)
    return [random.choice(others)] if others else []


def skip_candidates(members: Sequence[NodeInfo],
                    self_node: Optional[NodeInfo]) -> List[NodeInfo]:
    """Finger peers on the name-sorted ring: offsets 1, 2, 4, ... from my
    position (skip_mixer.hpp:46-57)."""
    ring = sorted(members, key=lambda m: m.name)
    if self_node is None:
        return list(ring)
    try:
        me = next(i for i, m in enumerate(ring) if m.name == self_node.name)
    except StopIteration:
        return broadcast_candidates(members, self_node)
    n = len(ring)
    out, offset = [], 1
    while offset < n:
        peer = ring[(me + offset) % n]
        if peer.name != self_node.name and peer.name not in {p.name for p in out}:
            out.append(peer)
        offset <<= 1
    return out


STRATEGIES = {
    "broadcast_mixer": broadcast_candidates,
    "random_mixer": random_candidates,
    "skip_mixer": skip_candidates,
}


# -- per-peer communication ---------------------------------------------------


class PeerSession:
    """One connection for a whole pairwise exchange (up to 4 calls), instead
    of a TCP setup per call."""

    def __init__(self, client: RpcClient, name: str) -> None:
        self._c = client
        self._name = name

    def get_schema(self) -> List[str]:
        return self._c.call("mix_get_schema", self._name)

    def sync_schema(self, union: List[str]) -> bool:
        return bool(self._c.call("mix_sync_schema", self._name, union))

    def get_diff(self) -> bytes:
        return self._c.call("mix_get_diff", self._name)

    def put_diff(self, packed: bytes) -> bool:
        return bool(self._c.call("mix_put_diff", self._name, packed))

    def close(self) -> None:
        self._c.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PushCommunication(RpcLinearCommunication):
    """Adds the single-peer exchange session to the membership/session
    plumbing (≙ push_communication, push_mixer.hpp)."""

    def peer_session(self, member: NodeInfo) -> PeerSession:
        return PeerSession(
            RpcClient(member.host, member.port, self.timeout), self.name)


class RpcPushMixer(RpcLinearMixer):
    """Leaderless gossip rounds; serves the same mix_* RPC surface as the
    linear mixer (register_api inherited)."""

    def __init__(self, driver: Any, comm: LinearCommunication, *,
                 strategy: str = "random_mixer", **kwargs) -> None:
        super().__init__(driver, comm, **kwargs)
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown push strategy {strategy!r}")
        self.strategy = strategy
        self._select = STRATEGIES[strategy]

    # -- the round (≙ push_mixer::mix, push_mixer.cpp:342-429) ---------------
    def _mix_round(self) -> Optional[Dict[str, Any]]:
        if self._obsolete:
            self.maybe_recover()
        members = self.comm.update_members()
        candidates = self._select(members, self.self_node)
        if not candidates:
            return None
        t0 = time.monotonic()
        exchanged = 0
        total_bytes = 0
        skipped_open = 0
        failures: List[str] = []
        breakers = getattr(self.comm, "breakers", None)
        for peer in candidates:
            key = (peer.host, peer.port)
            if breakers is not None and not breakers.allow(key):
                # open circuit: don't burn a timeout gossiping at a peer
                # that has been failing for a while — half-open probes
                # re-admit it once its cooldown passes
                skipped_open += 1
                continue
            try:
                total_bytes += self._exchange(peer)
                exchanged += 1
                if breakers is not None:
                    breakers.record(key, True)
            except Exception as e:  # broad-ok — gossip shrugs off a peer
                log.warning("push exchange with %s failed: %s", peer.name, e)
                failures.append(f"{peer.name}: {type(e).__name__}")
                if breakers is not None:
                    breakers.record(key, not is_retryable(e))
        if not exchanged:
            # candidates existed but every exchange failed (or every
            # circuit is open): that's a failed round, not an idle tick
            self.flight.record(self.strategy, ok=False,
                               reason="; ".join(failures) or (
                                   "all_breakers_open" if skipped_open
                                   else "no_exchange"),
                               candidates=len(candidates))
            return None
        self.mix_count += 1
        self.bytes_sent += total_bytes
        log.info("push mix round %d (%s): %d/%d peers, %d bytes, %.3fs",
                 self.mix_count, self.strategy, exchanged, len(candidates),
                 total_bytes, time.monotonic() - t0)
        return {"members": exchanged, "bytes": total_bytes,
                "mode": self.strategy, "candidates": len(candidates),
                "skipped_open": skipped_open or None,
                "failed_peers": failures or None}

    def _exchange(self, peer: NodeInfo) -> int:
        """One pairwise linear mix over a single peer connection: align
        schemas, fold my diff with the peer's, apply the fold on both
        sides."""
        with self.comm.peer_session(peer) as sess:
            return self._exchange_on(sess, peer.name, peer=peer)

    def _exchange_on(self, sess, peer_name: str = "?",
                     peer: Optional[NodeInfo] = None) -> int:
        # phase 1: schema alignment — row-keyed diffs (classifier labels,
        # stat keys) must agree on the row vocabulary BEFORE diffing, same
        # as the linear round's phase 1
        schema: List[str] = []
        if self._has_schema():
            mine_schema = self.local_get_schema()
            hers_schema = sess.get_schema()
            schema = sorted(
                {s.decode() if isinstance(s, bytes) else s
                 for s in list(mine_schema) + list(hers_schema)}
            )
            if schema:
                self.local_sync_schema(schema)
                sess.sync_schema(schema)
        # phase 2: row-aligned diffs (mine stays in-process — no wire codec)
        # the spans time each exchange's device-touching steps: her
        # get_diff (her snapshot, pack and the wire), and the two applies
        mine = self.local_diff_obj()
        with self.trace.span("mix.push.get_diff"):
            hers = unpack_mix(sess.get_diff())
        if hers.get("protocol") != PROTOCOL_VERSION:
            raise RuntimeError(f"protocol mismatch from {peer_name}")
        # phase 2.5: version asymmetry. A node behind the pair's base has
        # history its peer absorbed into MASTER arrays — deltas can't carry
        # it. If I'M behind, adopt her full model now (my diff snapshot
        # `mine` is folded back in below, so nothing local is lost). If
        # SHE'S behind, apply the fold only on MY side: she catches up when
        # her own round initiates — never demoted, no recovery storm.
        mv = int(mine.get("version", 0))
        hv = int(hers.get("version", 0))
        if mv < hv and peer is not None:
            model = unpack_mix(self.comm.get_model(peer))
            if model.get("protocol") != PROTOCOL_VERSION:
                raise RuntimeError(f"protocol mismatch from {peer_name}")
            with self._on_driver():
                self.driver.unpack(model["model"])
            self.model_version = mv = int(model.get("version", hv))
            log.info("adopted full model v%d from %s before exchange",
                     mv, peer_name)
        mixables = self.driver.get_mixables()
        # model-integrity admission screen: a 2-party
        # exchange has no peer distribution for the norm screen, but
        # the finite screen + quarantine breaker still gate the fold —
        # a poisoned peer fails the exchange instead of poisoning us
        # (warn mode flags and folds; the apply-side total screen in
        # local_put_obj is the backstop either way)
        if self.guard.enabled:
            reason = self.guard.screen_payload(
                peer_name, hers.get("diffs") or {}, _sum_names(mixables))
            if reason is not None:
                if reason == "nonfinite":
                    self._count("mix.guard.nonfinite")
                if self.guard.mode == "quarantine":
                    self._count("mix.quarantined")
                    raise RuntimeError(
                        f"peer diff rejected by mix guard: {reason}")
        totals: Dict[str, Any] = {}
        for name, mixable in mixables.items():
            diffs = [p["diffs"][name] for p in (mine, hers)
                     if name in p["diffs"]]
            if not diffs:
                continue
            custom_mix = getattr(mixable, "mix", None)
            totals[name] = (functools.reduce(custom_mix, diffs)
                            if custom_mix is not None else tree_sum(diffs))
        base_version = max(mv, hv)
        packed = pack_mix({"protocol": PROTOCOL_VERSION, "schema": schema,
                           "base_version": base_version, "diffs": totals})
        with self.trace.span("mix.push.put_local"):
            self.local_put_diff(packed)  # mv == base (adopted above if not)
        if hv == base_version:
            with self.trace.span("mix.push.put_peer"):
                sess.put_diff(packed)
        # else: she's behind — skipping her keeps the version gate from
        # demoting a merely gossip-lagged member; her next initiated round
        # adopts a full model (phase 2.5 on her side)
        return len(packed)


class DummyMixer:
    """Standalone no-op (≙ dummy_mixer when built without ZK,
    mixer_factory.cpp:24-31)."""

    def __init__(self, *_a, **_k) -> None:
        from jubatus_tpu_torch.framework.mixer import MixFlightRecorder

        self.mix_count = 0
        self.flight = MixFlightRecorder()

    def register_api(self, rpc_server, name_check: str = "") -> None:
        # history stays queryable (empty) so tooling needn't special-case
        rpc_server.register(
            "get_mix_history", lambda _name: self.flight.snapshot())

    def set_trace_registry(self, registry) -> None:
        pass

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass

    def updated(self, n: int = 1) -> None:
        pass

    def mix_now(self) -> None:
        return None

    def get_status(self) -> Dict[str, Any]:
        return {"mix_count": 0, "counter": 0, "mixer": "dummy"}


def create_mixer(name: str, driver: Any, comm: LinearCommunication, *,
                 self_node: Optional[NodeInfo] = None,
                 interval_sec: float = 16.0, interval_count: int = 512,
                 quorum_fraction: float = 0.5,
                 mix_async: bool = False, mix_staleness_bound: int = 8,
                 mix_guard: str = "warn", mix_norm_bound: float = 10.0,
                 mix_compress: str = "off", mix_bf16: bool = False,
                 mix_topology: str = ""):
    """Mixer factory (≙ create_mixer, mixer_factory.cpp:41-97): selects by
    the --mixer flag. ``mix_async`` swaps the linear mixer for the
    asynchronous staleness-bounded plane (framework/async_mixer.py):
    members push diffs in the background and the master folds them with
    per-member weights decayed by ``mix_staleness_bound`` instead of
    gathering behind a round barrier. ``mix_guard``/``mix_norm_bound``
    configure the admission guard (framework/model_guard.py) every
    strategy carries; ``mix_compress`` (or the deprecated ``mix_bf16``)
    and ``mix_topology`` the collective mixer's wire mode and tiers."""
    kwargs = dict(self_node=self_node, interval_sec=interval_sec,
                  interval_count=interval_count,
                  quorum_fraction=quorum_fraction,
                  guard=MixGuard(mode=mix_guard,
                                 norm_bound=mix_norm_bound))
    if mix_async and name != "linear_mixer":
        raise ValueError(
            f"--mix-async rides the linear mix plane; --mixer {name} "
            "cannot stream rounds asynchronously (push mixers are "
            "already leaderless, the collective is a barrier by "
            "construction)")
    if name == "linear_mixer":
        if mix_async:
            from jubatus_tpu_torch.framework.async_mixer import \
                AsyncLinearMixer

            return AsyncLinearMixer(
                driver, comm, staleness_bound=mix_staleness_bound,
                **kwargs)
        return RpcLinearMixer(driver, comm, **kwargs)
    if name == "collective_mixer":
        from jubatus_tpu_torch.framework.collective_mixer import \
            CollectiveMixer

        mode = mix_compress if mix_compress != "off" else \
            ("bf16" if mix_bf16 else "off")
        return CollectiveMixer(driver, comm, compress=mode,
                               topology=mix_topology, **kwargs)
    if name in STRATEGIES:
        return RpcPushMixer(driver, comm, strategy=name, **kwargs)
    if name == "dummy_mixer":
        return DummyMixer()
    raise ValueError(f"unknown mixer {name!r}; known: linear_mixer, "
                     f"collective_mixer, {', '.join(sorted(STRATEGIES))}, "
                     "dummy_mixer")
