"""The port server's flags against the JAX server's: every option string
of ``jubatus_tpu/server/args.py``'s parser parses on the port's, with the
JAX default, the perf tuner's and the legacy wire's included; the flags of
the planes the port carries refuse a bad value with the JAX server's
message."""

from __future__ import annotations

import argparse

import pytest

from jubatus_tpu.server.args import build_parser as jax_build_parser
from jubatus_tpu.server.args import parse_server_args as jax_parse
from jubatus_tpu_torch.server.args import ServerArgs, build_parser
from jubatus_tpu_torch.server.args import parse_server_args as port_parse

#: the JAX server's options the port has not reached: none since the perf
#: tuner's and the legacy wire's were ported
MISSING: frozenset = frozenset()

#: a value that passes the checks, for options whose default does not
_VALUES = {"fault": "store.put:delay:0", "slo": "gauge:mix.drift:0.1",
           "name": "c1", "configpath": "conf.json"}


def _options():
    out = []
    for action in jax_build_parser()._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        for opt in action.option_strings:
            out.append((opt, action))
    return out


OPTIONS = _options()


def _argv(opt, action):
    base = ["classifier", "-f", "conf.json"]
    if action.nargs == 0:  # store_true / store_false
        return base + [opt]
    value = _VALUES.get(action.dest, action.default)
    if action.dest == "coordinator":
        return base + [opt, "/tmp/coord", "-n", "c1"]
    return base + [opt, str(value)]


@pytest.mark.parametrize("opt,action", OPTIONS,
                         ids=[o for o, _ in OPTIONS])
def test_port_parser_takes_every_jax_server_option(opt, action):
    if opt in MISSING:
        with pytest.raises(SystemExit):
            port_parse(_argv(opt, action))
        return
    args = port_parse(_argv(opt, action))
    want = jax_parse(_argv(opt, action))
    assert getattr(args, action.dest) == getattr(want, action.dest)


def test_only_the_tuner_and_legacy_wire_options_are_missing():
    port = {o for a in build_parser()._actions for o in a.option_strings}
    jax = {o for o, _ in OPTIONS}
    assert jax - port == MISSING
    assert port - jax == {"-h", "--help", "--device"}


def test_defaults_of_the_shared_fields_match_the_jax_server():
    from jubatus_tpu.server.args import ServerArgs as JaxArgs

    port, jax = ServerArgs(), JaxArgs()
    shared = set(vars(port)) & set(vars(jax))
    assert {"timeout", "logdir", "log_config", "daemon", "fv_cache_size",
            "slo", "slo_fast_window", "slo_slow_window",
            "slo_burn_threshold", "timeseries_capacity", "event_capacity",
            "incident_dir", "incident_window", "quality_sample",
            "quality_window", "quality_ref_windows", "usage_top",
            "usage_gauge_principals", "auto_tune", "tune_interval_floor",
            "tune_interval_ceiling", "legacy_wire", "modern_wire"} <= shared
    for f in shared:
        assert getattr(port, f) == getattr(jax, f), f


@pytest.mark.parametrize("flag,value", [
    ("--fv-cache-size", "-1"), ("--timeseries-capacity", "-1"),
    ("--slo-fast-window", "0"), ("--slo-slow-window", "-5"),
    ("--slo-burn-threshold", "0"), ("--event-capacity", "-1"),
    ("--incident-window", "-1"), ("--quality-sample", "1.5"),
    ("--quality-window", "0"), ("--quality-ref-windows", "0"),
    ("--usage-top", "-1"), ("--usage-gauge-principals", "0"),
    ("--slo", "latency:rpc.x:q99:50"), ("--slo", "nope:x:y"),
    ("--auto-tune", "maybe"), ("--tune-interval-floor", "0"),
    ("--tune-interval-floor", "200"),
])
def test_bad_values_exit_with_the_jax_message(flag, value):
    argv = ["classifier", "-f", "conf.json", flag, value]
    with pytest.raises(SystemExit) as jax_exit:
        jax_parse(argv)
    with pytest.raises(SystemExit) as port_exit:
        port_parse(argv)
    assert str(port_exit.value) == str(jax_exit.value)
    assert str(port_exit.value)


def test_repeated_slo_and_fault_do_not_leak_across_parses():
    a = port_parse(["stat", "-f", "c", "--slo", "gauge:a:1",
                    "--fault", "x.y:delay:0"])
    b = port_parse(["stat", "-f", "c"])
    assert a.slo == ["gauge:a:1"] and a.fault == ["x.y:delay:0"]
    assert b.slo == [] and b.fault == []
