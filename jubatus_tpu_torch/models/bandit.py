"""Bandit engine driver (copy of ``jubatus_tpu/models/bandit.py``).

Business API of the reference's bandit service: register_arm / delete_arm /
select_arm / register_reward / get_arm_info / reset / clear. Methods
epsilon_greedy {epsilon}, softmax {tau}, exp3 {gamma} and ucb1 {}, each
with {assume_unrewarded}.

- Arms are registered globally; per-player statistics (trial count,
  cumulative reward weight) appear lazily.
- ``assume_unrewarded=true``: selecting an arm counts an unrewarded trial
  at once, and a reward adds weight only; ``false``: ``register_reward``
  adds the trial and the weight.
- Selection: epsilon_greedy a uniform arm with probability epsilon, else
  the best empirical mean; softmax samples ∝ exp(mean / tau); exp3 samples
  p_a = (1 - gamma) w_a / Σw + gamma / K and on a reward adds
  gamma · (r / p_a) / K to log w_a; ucb1 tries every arm once, then takes
  the best mean + sqrt(2 ln N / n_a).
- The draws come from numpy's ``default_rng(seed)``, as in the JAX
  package, so both packages pick the same arms.

Stats are a handful of host scalars per (player, arm); the mix diff is a
sparse additive dict, as in the JAX package.
The driver resolves ``device`` as every driver of the port does (``cuda``
unless ``"cpu"`` is asked for, raising without CUDA), so that ``--device``
means the same for every engine; it holds no tensor.
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List

import numpy as np

from jubatus_tpu_torch import resolve_device
from jubatus_tpu_torch.framework.driver import DriverBase, locked

METHODS = ("epsilon_greedy", "softmax", "exp3", "ucb1")


class BanditConfigError(ValueError):
    pass


class _PlayerStats:
    """Per-player per-arm accumulators, master/diff split like the array
    engines: *_m = state as of last mix, *_d = local since last mix."""

    __slots__ = ("trials_m", "trials_d", "weight_m", "weight_d",
                 "logw_m", "logw_d")

    def __init__(self) -> None:
        self.trials_m: Dict[str, float] = {}
        self.trials_d: Dict[str, float] = {}
        self.weight_m: Dict[str, float] = {}
        self.weight_d: Dict[str, float] = {}
        self.logw_m: Dict[str, float] = {}
        self.logw_d: Dict[str, float] = {}

    def trials(self, arm: str) -> float:
        return self.trials_m.get(arm, 0.0) + self.trials_d.get(arm, 0.0)

    def weight(self, arm: str) -> float:
        return self.weight_m.get(arm, 0.0) + self.weight_d.get(arm, 0.0)

    def logw(self, arm: str) -> float:
        return self.logw_m.get(arm, 0.0) + self.logw_d.get(arm, 0.0)

    def mean(self, arm: str) -> float:
        t = self.trials(arm)
        return self.weight(arm) / t if t > 0 else 0.0


class BanditDriver(DriverBase):
    TYPE = "bandit"

    def __init__(self, config: dict, seed: int = 0, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        self.config_json = json.dumps(config)
        method = config.get("method")
        if method not in METHODS:
            raise BanditConfigError(f"unknown bandit method {method!r}")
        self.method = method
        param = config.get("parameter") or {}
        self.assume_unrewarded = bool(param.get("assume_unrewarded", False))
        self.epsilon = float(param.get("epsilon", 0.1))
        self.tau = float(param.get("tau", 0.05))
        self.gamma = float(param.get("gamma", 0.1))
        if method == "epsilon_greedy" and not (0.0 <= self.epsilon <= 1.0):
            raise BanditConfigError("epsilon must be in [0, 1]")
        if method == "softmax" and self.tau <= 0.0:
            raise BanditConfigError("tau must be positive")
        if method == "exp3" and not (0.0 < self.gamma <= 1.0):
            raise BanditConfigError("gamma must be in (0, 1]")
        self._rng = np.random.default_rng(seed)
        self._init_model()

    def _init_model(self) -> None:
        self.arms: List[str] = []
        self.players: Dict[str, _PlayerStats] = {}

    # -- arm registry --------------------------------------------------------
    @locked
    def register_arm(self, arm_id: str) -> bool:
        if arm_id in self.arms:
            return False
        self.arms.append(arm_id)
        self.event_model_updated()
        return True

    @locked
    def delete_arm(self, arm_id: str) -> bool:
        if arm_id not in self.arms:
            return False
        self.arms.remove(arm_id)
        for st in self.players.values():
            for d in (st.trials_m, st.trials_d, st.weight_m, st.weight_d,
                      st.logw_m, st.logw_d):
                d.pop(arm_id, None)
        self.event_model_updated()
        return True

    def _player(self, player_id: str) -> _PlayerStats:
        st = self.players.get(player_id)
        if st is None:
            st = _PlayerStats()
            self.players[player_id] = st
        return st

    # -- selection -----------------------------------------------------------
    @locked
    def select_arm(self, player_id: str) -> str:
        if not self.arms:
            raise RuntimeError("no arms registered")
        st = self._player(player_id)
        arm = self._select(st)
        if self.assume_unrewarded:
            st.trials_d[arm] = st.trials_d.get(arm, 0.0) + 1.0
            self.event_model_updated()
        return arm

    def _select(self, st: _PlayerStats) -> str:
        method = self.method
        if method == "epsilon_greedy":
            if self._rng.random() < self.epsilon:
                return self.arms[self._rng.integers(len(self.arms))]
            return max(self.arms, key=st.mean)
        if method == "softmax":
            logits = np.asarray([st.mean(a) / self.tau for a in self.arms])
            logits -= logits.max()
            p = np.exp(logits)
            p /= p.sum()
            return self.arms[self._rng.choice(len(self.arms), p=p)]
        if method == "exp3":
            p = self._exp3_probs(st)
            return self.arms[self._rng.choice(len(self.arms), p=p)]
        # ucb1: untried arms first
        for a in self.arms:
            if st.trials(a) == 0:
                return a
        total = sum(st.trials(a) for a in self.arms)
        return max(
            self.arms,
            key=lambda a: st.mean(a) + math.sqrt(2.0 * math.log(total) / st.trials(a)),
        )

    def _exp3_probs(self, st: _PlayerStats) -> np.ndarray:
        k = len(self.arms)
        logw = np.asarray([st.logw(a) for a in self.arms])
        logw -= logw.max()
        w = np.exp(logw)
        return (1.0 - self.gamma) * w / w.sum() + self.gamma / k

    # -- reward --------------------------------------------------------------
    @locked
    def register_reward(self, player_id: str, arm_id: str, reward: float) -> bool:
        if arm_id not in self.arms:
            return False
        st = self._player(player_id)
        if not self.assume_unrewarded:
            st.trials_d[arm_id] = st.trials_d.get(arm_id, 0.0) + 1.0
        st.weight_d[arm_id] = st.weight_d.get(arm_id, 0.0) + float(reward)
        if self.method == "exp3":
            p = self._exp3_probs(st)[self.arms.index(arm_id)]
            st.logw_d[arm_id] = st.logw_d.get(arm_id, 0.0) + \
                self.gamma * (float(reward) / p) / len(self.arms)
        self.event_model_updated()
        return True

    @locked
    def get_arm_info(self, player_id: str) -> Dict[str, Dict[str, float]]:
        st = self.players.get(player_id)
        out: Dict[str, Dict[str, float]] = {}
        for a in self.arms:
            out[a] = {
                "trial_count": int(st.trials(a)) if st else 0,
                "weight": float(st.weight(a)) if st else 0.0,
            }
        return out

    @locked
    def reset(self, player_id: str) -> bool:
        self.players.pop(player_id, None)
        self.event_model_updated()
        return True

    @locked
    def clear(self) -> None:
        self._init_model()
        self.update_count = 0

    # -- mix plane -----------------------------------------------------------
    # No schema sync: the registered-arm set propagates only via the
    # register_arm/delete_arm broadcasts (as in the reference, where the
    # storage merged by mix is separate from the registered-arm registry) —
    # schema-syncing arms would resurrect an arm deleted on one replica
    # while a delete broadcast is still in flight. Player stats travel as
    # sparse dict diffs, so no dense (player × arm) grid is ever built.
    def get_mixables(self):
        return {"bandit": _BanditMixable(self)}

    # -- persistence ---------------------------------------------------------
    @locked
    def pack(self) -> Any:
        return {
            "method": self.method,
            "arms": list(self.arms),
            # iterate each player's actual stat keys, not self.arms: a mix
            # can land stats for an arm whose register_arm broadcast hasn't
            # reached this replica yet — a checkpoint must not drop them
            "players": {
                p: {
                    "trials": {a: st.trials(a) for a in
                               set(st.trials_m) | set(st.trials_d)},
                    "weight": {a: st.weight(a) for a in
                               set(st.weight_m) | set(st.weight_d)},
                    "logw": {a: st.logw(a) for a in
                             set(st.logw_m) | set(st.logw_d)},
                }
                for p, st in self.players.items()
            },
        }

    @locked
    def unpack(self, obj: Any) -> None:
        def _s(x):
            return x.decode() if isinstance(x, bytes) else x

        saved = _s(obj.get("method"))
        if saved != self.method:
            raise ValueError(
                f"checkpoint method {saved!r} != driver method {self.method!r}")
        self._init_model()
        self.arms = [_s(a) for a in obj["arms"]]
        for p, rec in obj["players"].items():
            st = self._player(_s(p))
            st.trials_m = {_s(a): float(v) for a, v in rec["trials"].items()}
            st.weight_m = {_s(a): float(v) for a, v in rec["weight"].items()}
            st.logw_m = {_s(a): float(v) for a, v in rec["logw"].items()}

    @locked
    def get_status(self) -> Dict[str, Any]:
        st = super().get_status()
        st.update(method=self.method, num_arms=len(self.arms),
                  num_players=len(self.players), device=str(self.device))
        return st


class _BanditMixable:
    """Sparse additive diff: {player: {arm: [d_trials, d_weight, d_logw]}},
    carrying only cells touched since the last mix. ``mix`` is a recursive
    dict-sum (the custom-combiner seam in parallel/mix.py) — the fold across
    replicas reproduces the reference's additive bandit_storage merge without
    ever materializing a dense (players × arms) grid."""

    def __init__(self, driver: BanditDriver):
        self._d = driver

    def get_diff(self) -> Dict[str, Dict[str, List[float]]]:
        out: Dict[str, Dict[str, List[float]]] = {}
        for p, st in self._d.players.items():
            arms = set(st.trials_d) | set(st.weight_d) | set(st.logw_d)
            cells = {
                a: [st.trials_d.get(a, 0.0), st.weight_d.get(a, 0.0),
                    st.logw_d.get(a, 0.0)]
                for a in arms
            }
            if cells:
                out[p] = cells
        return out

    @staticmethod
    def mix(acc, diff):
        # merge in place: the fold's acc is always a transient — either the
        # first replica's freshly-built get_diff dict or a prior mix result —
        # so an O(touched-cells) in-place merge keeps the whole reduce linear
        for p, cells in diff.items():
            mine = acc.setdefault(p, {})
            for a, v in cells.items():
                if a in mine:
                    mine[a] = [x + y for x, y in zip(mine[a], v)]
                else:
                    mine[a] = list(v)
        return acc

    def put_diff(self, diff) -> bool:
        def _s(x):
            return x.decode() if isinstance(x, bytes) else x

        for p, cells in diff.items():
            st = self._d._player(_s(p))
            for a, (dt, dw, dl) in cells.items():
                a = _s(a)
                if dt:
                    st.trials_m[a] = st.trials_m.get(a, 0.0) + dt
                if dw:
                    st.weight_m[a] = st.weight_m.get(a, 0.0) + dw
                if dl:
                    st.logw_m[a] = st.logw_m.get(a, 0.0) + dl
            st.trials_d.clear()
            st.weight_d.clear()
            st.logw_d.clear()
        return True
