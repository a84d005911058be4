"""The port's IDL compiler (``jubatus_tpu_torch/codegen``).

Mirrors ``tests/test_codegen.py`` case for case against the port's
codegen; the three cases that read the reference's .idl tree skip where it
is not mounted, as the JAX ones do. Then the parity of the two packages:
for every service in ``SERVICES``, an IDL written from the routing table
goes through both packages' parsers and every emitter (the routing table,
the RST docs, the Python, C++, Ruby, Java and Go clients), and each output
is byte-equal between them.
"""

from __future__ import annotations

import dataclasses

import pytest

from jubatus_tpu_torch.codegen import (
    emit_python_client,
    emit_rst,
    emit_service_table,
    parse_idl,
    to_methods,
)
from jubatus_tpu_torch.codegen.parser import parse_reference_idls
from jubatus_tpu_torch.framework.idl import SERVICES

from test_codegen import REFERENCE_IDL_DIR, needs_reference

SAMPLE = """
message labeled_datum {
  0: string label
  1: datum data
}

service classifier {
  #- doc line
  #@random #@nolock #@pass
  int train(0: list<labeled_datum> data)

  #@cht(1) #@update #@all_and
  bool push(0: string key, 1: double value)

  #@cht #@analysis #@pass
  map<string, ulong> get_labels()

  #@broadcast #@update #@all_and
  bool clear()
}
"""


def test_parse_sample():
    idl = parse_idl(SAMPLE)
    assert [m.name for m in idl.messages] == ["labeled_datum"]
    assert idl.messages[0].fields[1].type == "datum"
    svc = idl.service("classifier")
    train, push, get_labels, clear = svc.methods
    assert (train.routing, train.lock, train.aggregator) == ("random", "nolock", "pass")
    assert train.return_type == "int"
    assert train.args[0].type == "list<labeled_datum>"
    assert (push.routing, push.cht_n) == ("cht", 1)
    assert get_labels.cht_n == 2  # bare #@cht defaults to 2
    assert get_labels.return_type == "map<string, ulong>"
    assert (clear.routing, clear.aggregator) == ("broadcast", "all_and")


def test_message_alias():
    idl = parse_idl('message node("jubatus::core::graph::node_info") {\n'
                    "  0: string prop\n}\n")
    assert idl.messages[0].alias == "jubatus::core::graph::node_info"


def test_to_methods_and_emit():
    idl = parse_idl(SAMPLE)
    methods = to_methods(idl.service("classifier"))
    assert methods[0].name == "train"
    assert methods[1].routing == "cht"
    table = emit_service_table(idl.service("classifier"))
    assert '"classifier": (' in table
    assert '_m("push", ("key", "value"), CHT, 1' in table


def test_emit_python_client_compiles():
    idl = parse_idl(SAMPLE)
    src = emit_python_client(idl, "classifier")
    assert "from jubatus_tpu_torch.client import ClientBase" in src
    ns: dict = {}
    exec(compile(src, "<generated>", "exec"), ns)  # noqa: S102 — own output
    cls = ns["ClassifierClient"]
    assert cls.ENGINE == "classifier"
    assert hasattr(cls, "train") and hasattr(cls, "clear")


def test_emit_rst_includes_docs():
    idl = parse_idl(
        "service s {\n"
        "  #- Trains the thing.\n"
        "  #@random #@nolock #@pass\n"
        "  int train(0: string x)\n"
        "}\n"
    )
    assert idl.service("s").methods[0].docs == ["Trains the thing."]
    rst = emit_rst(idl, "s")
    assert ".. function:: int train(string x)" in rst
    assert ":routing: random" in rst
    assert "Trains the thing." in rst


@needs_reference
def test_emit_rst_all_reference_services():
    for engine, idl in parse_reference_idls(REFERENCE_IDL_DIR).items():
        rst = emit_rst(idl, engine)
        assert f"{engine} API" in rst
        assert ".. function::" in rst


# -- parity with the reference ------------------------------------------------


@needs_reference
def test_all_reference_idls_parse():
    idls = parse_reference_idls(REFERENCE_IDL_DIR)
    assert set(idls) == set(SERVICES)
    for engine, idl in idls.items():
        assert idl.service(engine).methods, engine


@needs_reference
def test_checked_in_table_matches_reference_idls():
    """Every method in framework/idl.py must match the reference .idl:
    same name set, same arity, same routing class, same cht fan-out, same
    aggregator. (Lock decorators intentionally differ: our table records
    model-lock semantics, the IDL's #@nolock is an RPC-layer detail.)"""
    idls = parse_reference_idls(REFERENCE_IDL_DIR)
    mismatches = []
    for engine, methods in SERVICES.items():
        ref = {d.name: d for d in idls[engine].service(engine).methods}
        ours = {m.name: m for m in methods}
        if set(ref) != set(ours):
            mismatches.append(f"{engine}: methods {set(ref) ^ set(ours)}")
            continue
        for name, d in ref.items():
            m = ours[name]
            if len(d.args) != len(m.args):
                mismatches.append(f"{engine}.{name}: arity {len(d.args)} != {len(m.args)}")
            if d.routing != m.routing:
                mismatches.append(f"{engine}.{name}: routing {d.routing} != {m.routing}")
            if d.routing == "cht" and d.cht_n != m.cht_n:
                mismatches.append(f"{engine}.{name}: cht_n {d.cht_n} != {m.cht_n}")
            if d.routing in ("broadcast", "cht") and d.aggregator != m.aggregator:
                mismatches.append(
                    f"{engine}.{name}: agg {d.aggregator} != {m.aggregator}")
    assert not mismatches, "\n".join(mismatches)


# -- parity with the JAX package ---------------------------------------------

#: argument types cycled over a service's methods, so every emitter meets
#: primitives, the datum, a message, lists, maps and tuples
ARG_TYPES = ("string", "datum", "list<labeled_datum>", "map<string, double>",
             "ulong", "double", "list<string>", "tuple<string, double>",
             "bool", "list<datum>")
RET_TYPES = ("bool", "map<string, ulong>", "list<tuple<string, float>>",
             "int", "string", "datum", "list<labeled_datum>", "double")


def _idl_of(engine):
    """An .idl for one service, written from its routing-table entry:
    the decorators, names and arity of each method, typed by cycling
    ``ARG_TYPES`` / ``RET_TYPES``, with a doc line and one message."""
    lines = ["message labeled_datum {", "  0: string label",
             "  1: datum data", "}", "", f"service {engine} {{"]
    n = 0
    for i, m in enumerate(SERVICES[engine]):
        routing = {"cht": f"#@cht({m.cht_n})"}.get(m.routing,
                                                   f"#@{m.routing}")
        args = []
        for a in m.args:
            args.append(f"{len(args)}: {ARG_TYPES[n % len(ARG_TYPES)]} {a}")
            n += 1
        lines += [f"  #- {m.name} of {engine}.",
                  f"  {routing} #@{m.lock} #@{m.aggregator}",
                  f"  {RET_TYPES[i % len(RET_TYPES)]} {m.name}"
                  f"({', '.join(args)})", ""]
    lines.append("}")
    return "\n".join(lines) + "\n"


def _emit_all(codegen, emit_clients, emit_cpp, text, engine, **py):
    idl = codegen.parse_idl(text)
    return {
        "methods": [dataclasses.astuple(m)
                    for m in codegen.to_methods(idl.service(engine))],
        "table": codegen.emit_service_table(idl.service(engine)),
        "rst": codegen.emit_rst(idl, engine),
        "python": codegen.emit_python_client(idl, engine, **py),
        "cpp": emit_cpp.emit_cpp_client(idl, engine),
        "ruby": emit_clients.emit_ruby_client(idl, engine),
        "java": emit_clients.emit_java_client(idl, engine),
        "go": emit_clients.emit_go_client(idl, engine),
    }


@pytest.mark.parametrize("engine", sorted(SERVICES))
def test_every_emitter_is_byte_equal_to_the_jax_package(engine):
    """Every emitter's output for the service equals the JAX package's,
    byte for byte; the generated Python client differs only in the
    package it imports unless ``package="jubatus_tpu"`` is asked for."""
    import jubatus_tpu.codegen as jcodegen
    from jubatus_tpu.codegen import emit_clients as jemit_clients
    from jubatus_tpu.codegen import emit_cpp as jemit_cpp
    from jubatus_tpu.framework.idl import SERVICES as JSERVICES

    import jubatus_tpu_torch.codegen as codegen
    from jubatus_tpu_torch.codegen import emit_clients, emit_cpp

    assert ([dataclasses.astuple(m) for m in SERVICES[engine]]
            == [dataclasses.astuple(m) for m in JSERVICES[engine]])
    text = _idl_of(engine)
    want = _emit_all(jcodegen, jemit_clients, jemit_cpp, text, engine)
    got = _emit_all(codegen, emit_clients, emit_cpp, text, engine,
                    package="jubatus_tpu")
    assert got.keys() == want.keys()
    for kind in want:
        assert got[kind] == want[kind], kind
    assert [m[:6] for m in got["methods"]] == [
        dataclasses.astuple(m)[:6] for m in SERVICES[engine]]
    own = emit_python_client(parse_idl(text), engine)
    assert own == want["python"].replace("jubatus_tpu.", "jubatus_tpu_torch.")
    ns: dict = {}
    exec(compile(own, "<generated>", "exec"), ns)  # noqa: S102 — own output
    assert ns[f"{engine.title().replace('_', '')}Client"].ENGINE == engine
