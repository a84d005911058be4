"""Fault injection registry (copy of ``jubatus_tpu/utils/faults.py``,
trimmed to the sites the port fires).

Named sites call ``fire(site)`` or ``fire_mutate(site)``. Rules are armed
by a test with ``armed(...)``, by a server's ``--fault`` flags at boot
(server/base.py), or by the ``JUBATUS_TPU_FAULTS`` environment variable
(comma-separated rules, armed when this module is first imported), all
process-wide. Rule syntax:

    <site-glob>:error            raise FaultInjected at matching sites
    <site-glob>:error:<p>        ... with probability p (seeded RNG)
    <site-glob>:delay:<seconds>  sleep before proceeding
    <site-glob>:drop             silently lose the operation (fire()
                                 returns True; drop-aware sites discard
                                 the message instead of erroring)
    <site-glob>:nan              poison: patch one element of a random
                                 float diff leaf to NaN (fire_mutate
                                 sites only)
    <site-glob>:scale:<F>        poison: multiply every float leaf of a
                                 contribution by F
    <site-glob>:bitflip          corrupt: flip one bit of the bytes a
                                 fire_mutate site stages (flip_byte)
    <site-glob>:error@<n>        ... only for the first n firings

Sites of the port: ``mix.comm.get_diff``, ``mix.comm.put_diff``,
``mix.put_diff``, ``mix.diff.poison[.<node>]``,
``mix.async.submit.<node>``, ``mix.async.inbox.<node>``,
``migration.pull``, ``store.put``, ``store.get``, ``store.compact``,
``breaker.allow.<host:port>``, the IVF tier's ``ann.rebuild`` (an index
build or a cell re-split; a fired error degrades the tier to the exact
scan), and the RPC plane's
``rpc.dispatch.<method>`` (before the deadline gate),
``rpc.call.<method>.<host:port>`` (each client attempt) and
``rpc.connect.<host:port>``, and the control loops' actuation sites:
the autoscaler's ``autoscale.spawn`` / ``autoscale.drain`` and the perf
tuner's ``tune.mix.apply`` / ``tune.coalescer.apply`` /
``tune.cadence.apply``. A fired error there surfaces as a ``blocked``
journal record with exponential backoff, never a hot loop
(coord/controller.py ``guarded``); the tune sites fire BEFORE the knob
mutates, so a failed apply leaves the fleet on its previous plan. ``fire``
is a no-op (one module flag read) when nothing is armed.

    with faults.armed("mix.comm.get_diff:error@1"):
        ...  # the next master-side gather fails once
"""

from __future__ import annotations

import fnmatch
import os
import random
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np

from jubatus_tpu_torch.utils import events
from jubatus_tpu_torch.utils.tree import tree_map

__all__ = ["FaultInjected", "armed", "fire", "fire_mutate", "poison_tree",
           "flip_byte", "is_armed", "disarm_all"]

#: actions that MUTATE data instead of dropping/raising: returned by
#: fire_mutate for the caller to apply (poison_tree), and invisible to
#: plain fire() sites by construction
MUTATE_ACTIONS = ("nan", "scale", "bitflip")


class FaultInjected(RuntimeError):
    """The error fault injection raises (subclasses RuntimeError so site
    error taxonomies treat it like any runtime failure)."""


class _Rule:
    __slots__ = ("pattern", "action", "arg", "remaining", "prob", "hits")

    def __init__(self, pattern: str, action: str, arg: float,
                 remaining: Optional[int], prob: float) -> None:
        self.pattern = pattern
        self.action = action
        self.arg = arg
        self.remaining = remaining
        self.prob = prob
        self.hits = 0


_lock = threading.Lock()
_rules: List[_Rule] = []
_armed = False  # fast-path flag: fire() returns immediately when False
_rng = random.Random(0xFA017)
_fired: Dict[str, int] = {}


def parse_rule(text: str) -> _Rule:
    # site patterns may themselves contain colons (host:port), so locate
    # the action token from the RIGHT
    parts = text.strip().split(":")
    action_idx = None
    for i in range(len(parts) - 1, -1, -1):
        if parts[i].split("@", 1)[0] in ("error", "delay", "drop",
                                         "nan", "scale", "bitflip"):
            action_idx = i
            break
    if action_idx is None or action_idx == 0:
        raise ValueError(
            f"bad fault rule {text!r} (want site:action[:arg], action in "
            "{error, delay, drop, nan, scale, bitflip})")
    pattern = ":".join(parts[:action_idx])
    action = parts[action_idx]
    extra = parts[action_idx + 1:]
    remaining = None
    if "@" in action:
        action, n = action.split("@", 1)
        remaining = int(n)
    arg = 0.0
    prob = 1.0
    if action == "delay":
        if not extra:
            raise ValueError(f"delay rule needs seconds: {text!r}")
        arg = float(extra[0])
    elif action == "scale":
        if not extra:
            raise ValueError(f"scale rule needs a factor: {text!r}")
        arg = float(extra[0])
    elif extra:  # error with probability
        prob = float(extra[0])
    return _Rule(pattern, action, arg, remaining, prob)


def arm(*rule_texts: str) -> List[_Rule]:
    """Add rules (see module docstring for syntax). Returns the rule
    objects so a scope can later remove exactly what it added."""
    global _armed
    parsed = [parse_rule(t) for t in rule_texts]
    if not parsed:
        return []
    with _lock:
        _rules.extend(parsed)
        _armed = True
    # an armed fault site is cluster state the event timeline must show
    events.emit("faults", "armed", severity="warning",
                rules=list(rule_texts))
    return parsed


def disarm(rules: List[_Rule]) -> None:
    """Remove specific rules (leaves others — env-armed, outer scopes —
    in place)."""
    global _armed
    with _lock:
        for r in rules:
            if r in _rules:
                _rules.remove(r)
        _armed = bool(_rules)


def disarm_all() -> None:
    global _armed
    with _lock:
        _rules.clear()
        _fired.clear()
        _armed = False


def is_armed() -> bool:
    """Cheap hot-path guard: callers may skip building site names when
    nothing is armed."""
    return _armed


@contextmanager
def armed(*rule_texts: str):
    """Scope rules to a with-block; removes ONLY the rules it added, so
    nesting and env-armed rules compose."""
    mine = arm(*rule_texts)
    try:
        yield
    finally:
        disarm(mine)


def _fire(site: str, mutate: bool):
    """Shared firing core: sleeps delays, raises errors, and returns
    (dropped, mutation) where mutation is the strongest matched
    ``(action, arg)`` mutation pair (only when ``mutate`` — plain
    fire() sites never consume or observe mutation rules)."""
    delay = 0.0
    boom = False
    dropped = False
    mutation: Optional[tuple] = None
    with _lock:
        for r in _rules:
            if r.remaining is not None and r.remaining <= 0:
                continue
            if r.action in MUTATE_ACTIONS and not mutate:
                continue
            if not fnmatch.fnmatch(site, r.pattern):
                continue
            if r.prob < 1.0 and _rng.random() >= r.prob:
                continue
            if r.remaining is not None:
                r.remaining -= 1
            r.hits += 1
            _fired[site] = _fired.get(site, 0) + 1
            if r.action == "delay":
                delay = max(delay, r.arg)
            elif r.action == "drop":
                dropped = True
            elif r.action in MUTATE_ACTIONS:
                if mutation is None:
                    mutation = (r.action, r.arg)
            else:
                boom = True
    if delay or boom or dropped or mutation:
        # a fault actually FIRING is a timeline event (emitted outside
        # the rule lock; the no-rule fast path above never reaches here)
        events.emit("faults", "fired", severity="warning", site=site,
                    action=("error" if boom else
                            "drop" if dropped else
                            mutation[0] if mutation else "delay"))
    if delay:
        time.sleep(delay)
    if boom:
        raise FaultInjected(f"injected fault at {site}")
    return dropped, mutation


def fire(site: str) -> bool:
    """Injection point. No-op unless rules are armed. Returns True when
    a ``drop`` rule matched — drop-aware sites silently discard the
    operation; everyone else ignores the return value (a drop then has
    no effect, by design). Mutation rules (nan/scale) never
    match here — only ``fire_mutate`` sites apply them."""
    if not _armed:
        return False
    dropped, _ = _fire(site, mutate=False)
    return dropped


def fire_mutate(site: str) -> Optional[tuple]:
    """Mutation-aware injection point (the model-integrity chaos sites):
    error/delay rules behave as at any site, and the strongest matched
    mutation rule is returned as ``(action, arg)`` for the caller to
    apply with ``poison_tree``. None = leave the data alone."""
    if not _armed:
        return None
    _, mutation = _fire(site, mutate=True)
    return mutation


def poison_tree(diffs, mutation: tuple):
    """Apply a ``nan``/``scale:F`` mutation to a materialized (host
    numpy) diff payload — the ``mix.diff.poison`` drill. ``nan``
    patches ONE element of the first float leaf encountered (a single
    bad datum's footprint); ``scale`` multiplies every float leaf by F
    (a runaway learner). Leaves are copied — the caller's model state
    is never touched, only the outgoing snapshot."""
    action, arg = mutation
    state = {"done": False}

    def mutate(x):
        if not isinstance(x, np.ndarray) or \
                not np.issubdtype(x.dtype, np.floating) or x.size == 0:
            return x
        if action == "scale":
            return x * np.asarray(arg, dtype=x.dtype)
        if state["done"]:
            return x
        state["done"] = True
        y = x.copy()
        y.reshape(-1)[_rng.randrange(x.size)] = np.nan
        return y

    return tree_map(mutate, diffs)


def flip_byte(buf: bytes) -> bytes:
    """One-byte corruption of staged bytes (the ``bitflip`` drill):
    returns a copy with a single bit flipped at a seeded-random offset."""
    if not buf:
        return buf
    out = bytearray(buf)
    out[_rng.randrange(len(out))] ^= 0x40
    return bytes(out)


def _arm_from_env() -> None:
    spec = os.environ.get("JUBATUS_TPU_FAULTS", "")
    if spec:
        arm(*[s for s in spec.split(",") if s.strip()])


_arm_from_env()
