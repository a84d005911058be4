"""The port's stat and bandit engines (jubatus_tpu_torch/models/{stat,bandit}.py)
against the JAX package's: every case of tests/test_stat_bandit.py, run on
both packages with the same calls, and the answers held equal, exactly
(both keep host numpy state, and bandit draws from numpy's default_rng(seed)
in both). Each case also keeps the reference test's own assertions, on the
port. Plus the cross-pack cases: a JAX pack loads through
convert.from_jax_pack and answers the same; the port's pack loads in the
JAX driver.
"""

from __future__ import annotations

import math

import numpy as np
import pytest

from jubatus_tpu.models.bandit import BanditConfigError as JBanditConfigError
from jubatus_tpu.models.bandit import BanditDriver as JBandit
from jubatus_tpu.models.stat import StatDriver as JStat
from jubatus_tpu.parallel import LocalMixGroup
from jubatus_tpu_torch.convert import from_jax_pack
from jubatus_tpu_torch.models.bandit import BanditConfigError, BanditDriver
from jubatus_tpu_torch.models.stat import StatDriver
from torch_parity import port_mix


PORT = dict(Stat=lambda c: StatDriver(c, device="cpu"),
            Bandit=lambda c, **kw: BanditDriver(c, device="cpu", **kw),
            mix=port_mix, ConfigError=BanditConfigError)
JAX = dict(Stat=JStat, Bandit=JBandit,
           mix=lambda ds: LocalMixGroup(ds).mix(),
           ConfigError=JBanditConfigError)


def both(case):
    """Run ``case(pkg)`` on each package; their records must be equal.
    Returns the port's record."""
    got, want = case(PORT), case(JAX)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# stat
# ---------------------------------------------------------------------------
def test_stat_basic_reductions():
    def case(p):
        s = p["Stat"]({"window_size": 128})
        for v in [1.0, 2.0, 3.0, 4.0]:
            s.push("x", v)
        return [s.sum("x"), s.max("x"), s.min("x"), s.stddev("x"),
                s.moment("x", 1, 0.0), s.moment("x", 2, 2.5)]

    r = both(case)
    assert r[:3] == [10.0, 4.0, 1.0]
    assert r[3] == pytest.approx(np.std([1, 2, 3, 4]))
    assert r[4] == pytest.approx(2.5)
    assert r[5] == pytest.approx(np.mean((np.arange(1, 5) - 2.5) ** 2))


def test_stat_window_eviction():
    def case(p):
        s = p["Stat"]({"window_size": 3})
        for v in [1, 2, 3, 4, 5]:
            s.push("k", v)
        return [s.sum("k"), s.min("k")]

    assert both(case) == [12.0, 3.0]


def test_stat_entropy_across_keys():
    def case(p):
        s = p["Stat"]({"window_size": 16})
        for _ in range(2):
            s.push("a", 1.0)
        for _ in range(2):
            s.push("b", 1.0)
        return [s.entropy(), s.entropy("a"), s.entropy("b")]

    r = both(case)
    assert r[0] == pytest.approx(math.log(2))
    assert r[1] == r[2]


def test_stat_missing_key_raises():
    for p in (PORT, JAX):
        s = p["Stat"]({"window_size": 4})
        with pytest.raises(KeyError):
            s.sum("nope")


def test_stat_save_load_roundtrip():
    def case(p):
        s = p["Stat"]({"window_size": 4})
        for v in [1, 2, 3, 4, 5]:
            s.push("k", v)
        s.push("j", 7.0)
        s2 = p["Stat"]({"window_size": 4})
        s2.unpack(s.pack())
        return [s2.sum("k"), s.sum("k"), s2.min("k"), s.min("k"), s2.sum("j")]

    r = both(case)
    assert r[0] == r[1] and r[2] == r[3] and r[4] == 7.0


def test_stat_mix_entropy_uses_cluster_counts():
    def case(p):
        a = p["Stat"]({"window_size": 16})
        b = p["Stat"]({"window_size": 16})
        for _ in range(4):
            a.push("x", 1.0)
        for _ in range(4):
            b.push("y", 1.0)
        p["mix"]([a, b])
        return [a.entropy(), b.entropy()]

    r = both(case)
    assert r == [pytest.approx(math.log(2))] * 2


# ---------------------------------------------------------------------------
# bandit
# ---------------------------------------------------------------------------
def _cfg(method, **param):
    return {"method": method, "parameter": {"assume_unrewarded": False, **param}}


def test_bandit_register_and_info():
    def case(p):
        b = p["Bandit"](_cfg("ucb1"))
        out = [b.register_arm("a"), b.register_arm("b"), b.register_arm("a")]
        b.register_reward("p1", "a", 1.0)
        out.append(b.get_arm_info("p1"))
        out.append(b.delete_arm("b"))
        out.append(b.get_arm_info("p1"))
        return out

    r = both(case)
    assert r[:3] == [True, True, False]
    assert r[3]["a"] == {"trial_count": 1, "weight": 1.0}
    assert r[3]["b"] == {"trial_count": 0, "weight": 0.0}
    assert r[4] and "b" not in r[5]


def test_bandit_ucb1_tries_all_then_exploits():
    def case(p):
        b = p["Bandit"](_cfg("ucb1"))
        for a in ("a", "b", "c"):
            b.register_arm(a)
        picks = []
        for _ in range(3):
            arm = b.select_arm("p")
            picks.append(arm)
            b.register_reward("p", arm, 1.0 if arm == "b" else 0.0)
        for _ in range(20):
            b.register_reward("p", "a", 0.0)
            b.register_reward("p", "b", 1.0)
            b.register_reward("p", "c", 0.0)
        picks.append(b.select_arm("p"))
        return picks

    r = both(case)
    assert set(r[:3]) == {"a", "b", "c"}
    assert r[3] == "b"


def test_bandit_epsilon_greedy_zero_eps_is_greedy():
    def case(p):
        b = p["Bandit"](_cfg("epsilon_greedy", epsilon=0.0))
        b.register_arm("bad")
        b.register_arm("good")
        b.register_reward("p", "good", 5.0)
        b.register_reward("p", "bad", 0.1)
        return [b.select_arm("p") for _ in range(5)]

    assert both(case) == ["good"] * 5


def test_bandit_assume_unrewarded_counts_trials_on_select():
    def case(p):
        b = p["Bandit"]({"method": "ucb1",
                         "parameter": {"assume_unrewarded": True}})
        b.register_arm("a")
        b.select_arm("p")
        out = [b.get_arm_info("p")["a"]["trial_count"]]
        b.register_reward("p", "a", 2.0)
        out.append(b.get_arm_info("p"))
        return out

    r = both(case)
    assert r[0] == 1
    assert r[1]["a"]["trial_count"] == 1
    assert r[1]["a"]["weight"] == 2.0


@pytest.mark.parametrize("seed", [1, 5])
def test_bandit_softmax_and_exp3_prefer_rewarded_arm(seed):
    """The draws are equal too: both packages take numpy's default_rng(seed)
    (seed 1 is the reference test's; 5 another)."""
    def case(p):
        out = []
        for method, param in (("softmax", {"tau": 0.05}),
                              ("exp3", {"gamma": 0.3})):
            b = p["Bandit"](_cfg(method, **param), seed=seed)
            b.register_arm("x")
            b.register_arm("y")
            for _ in range(30):
                b.register_reward("p", "y", 1.0)
            out.append([b.select_arm("p") for _ in range(50)])
        return out

    for picks in both(case):
        assert picks.count("y") > picks.count("x")


def test_bandit_epsilon_greedy_draws_equal():
    """epsilon_greedy at the shipped epsilon (config/bandit/default.json):
    the same uniform draws pick the same arms in both packages."""
    def case(p):
        b = p["Bandit"](_cfg("epsilon_greedy", epsilon=0.3), seed=11)
        for a in "abcd":
            b.register_arm(a)
        picks = []
        for i in range(200):
            arm = b.select_arm("p")
            picks.append(arm)
            b.register_reward("p", arm, float(arm == "c") + 0.01 * (i % 3))
        return picks, b.get_arm_info("p")

    picks, _ = both(case)
    assert len(set(picks)) == 4


def test_bandit_reset_and_clear():
    def case(p):
        b = p["Bandit"](_cfg("ucb1"))
        b.register_arm("a")
        b.register_reward("p", "a", 1.0)
        b.reset("p")
        out = [b.get_arm_info("p")["a"]["trial_count"]]
        b.clear()
        out.append(list(b.arms))
        return out

    assert both(case) == [0, []]


def test_bandit_bad_config():
    for p in (PORT, JAX):
        with pytest.raises(p["ConfigError"]):
            p["Bandit"]({"method": "thompson"})
        with pytest.raises(p["ConfigError"]):
            p["Bandit"](_cfg("softmax", tau=0.0))


def test_bandit_mix_merges_player_stats():
    def case(p):
        a = p["Bandit"](_cfg("ucb1"))
        b = p["Bandit"](_cfg("ucb1"))
        for d in (a, b):
            d.register_arm("arm")
        a.register_reward("p", "arm", 1.0)
        b.register_reward("p", "arm", 2.0)
        b.register_reward("q", "arm", 5.0)
        p["mix"]([a, b])
        out = [(d.get_arm_info("p"), d.get_arm_info("q")) for d in (a, b)]
        p["mix"]([a, b])
        out.append(a.get_arm_info("p"))
        return out

    r = both(case)
    for info_p, info_q in r[:2]:
        assert info_p["arm"]["trial_count"] == 2
        assert info_p["arm"]["weight"] == pytest.approx(3.0)
        assert info_q["arm"]["weight"] == pytest.approx(5.0)
    assert r[2]["arm"]["weight"] == pytest.approx(3.0)


def test_bandit_save_load_roundtrip():
    def case(p):
        b = p["Bandit"](_cfg("exp3", gamma=0.2), seed=3)
        b.register_arm("a")
        b.register_arm("b")
        for _ in range(5):
            arm = b.select_arm("p")
            b.register_reward("p", arm, 1.0)
        b2 = p["Bandit"](_cfg("exp3", gamma=0.2))
        b2.unpack(b.pack())
        return [b2.get_arm_info("p"), b.get_arm_info("p")]

    r = both(case)
    assert r[0] == r[1]


# ---------------------------------------------------------------------------
# cross-pack
# ---------------------------------------------------------------------------
def test_stat_packs_cross_load_both_ways():
    conf = {"window_size": 8}
    rng = np.random.default_rng(4)
    j = JStat(conf)
    for i in range(40):
        j.push(f"k{i % 3}", float(rng.normal()))
    t = from_jax_pack(j.pack(), conf, engine="stat", device="cpu")
    # a pack stores each full ring oldest first, so a loaded window sums in
    # another order than the packed driver's: hold it against the JAX
    # driver loaded from the same pack
    j = JStat(conf)
    j.unpack(t.pack())
    for k in ("k0", "k1", "k2"):
        assert [t.sum(k), t.stddev(k), t.max(k), t.min(k),
                t.moment(k, 3, 0.5)] == \
            [j.sum(k), j.stddev(k), j.max(k), j.min(k), j.moment(k, 3, 0.5)]
    assert t.entropy() == j.entropy()
    t.push("k0", 9.0)
    packed = t.pack()
    j2 = JStat(conf)
    j2.unpack(packed)
    t2 = StatDriver(conf, device="cpu")
    t2.unpack(packed)
    for k in ("k0", "k1", "k2"):
        assert [j2.sum(k), j2.stddev(k)] == [t2.sum(k), t2.stddev(k)]
    assert j2.max("k0") == 9.0 and j2.entropy() == t.entropy()


def test_bandit_packs_cross_load_both_ways():
    conf = _cfg("exp3", gamma=0.25)
    j = JBandit(conf, seed=2)
    for a in "xyz":
        j.register_arm(a)
    for i in range(30):
        arm = j.select_arm(f"p{i % 2}")
        j.register_reward(f"p{i % 2}", arm, float(arm == "y"))
    t = from_jax_pack(j.pack(), conf, engine="bandit", device="cpu")
    for p in ("p0", "p1"):
        assert t.get_arm_info(p) == j.get_arm_info(p)
    t.register_reward("p0", "z", 2.0)
    j2 = JBandit(conf)
    j2.unpack(t.pack())
    assert j2.get_arm_info("p0") == t.get_arm_info("p0")
    with pytest.raises(ValueError):
        from_jax_pack(j.pack(), _cfg("ucb1"), engine="bandit", device="cpu")
