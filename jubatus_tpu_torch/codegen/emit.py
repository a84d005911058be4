"""Emitters (≙ jenerator's cpp.ml/python.ml backends, Python-targeted).

``to_methods``         — AST service → framework.idl Method tuple (the
                         routing table the server/proxy/client consume).
``emit_service_table`` — source text for a SERVICES entry.
``emit_python_client`` — a standalone typed client module for one service,
                         mirroring the reference's generated clients
                         (client/common/client.hpp base + per-RPC methods).
"""

from __future__ import annotations

from typing import Tuple

from jubatus_tpu_torch.codegen.parser import IdlFile, MethodDecl, Service
from jubatus_tpu_torch.framework.idl import Method


def to_methods(service: Service) -> Tuple[Method, ...]:
    out = []
    for d in service.methods:
        out.append(Method(
            name=d.name,
            args=tuple(a.name for a in d.args),
            routing=d.routing,
            cht_n=d.cht_n,
            lock={"update": "update", "analysis": "analysis"}.get(d.lock, "nolock"),
            aggregator=d.aggregator,
        ))
    return tuple(out)


def emit_service_table(service: Service) -> str:
    """SERVICES-entry source for framework/idl.py."""
    lines = [f'    "{service.name}": (']
    for d in service.methods:
        inner = ", ".join(f'"{a.name}"' for a in d.args)
        args = f"({inner},)" if len(d.args) == 1 else f"({inner})"
        parts = [f'"{d.name}"', args, d.routing.upper()
                 if d.routing in ("random", "broadcast", "cht") else '"internal"']
        if d.routing == "cht":
            parts.append(str(d.cht_n))
        parts.append(f'lock="{d.lock}"')
        if d.aggregator != "pass":
            parts.append(f'agg="{d.aggregator}"')
        lines.append(f"        _m({', '.join(parts)}),")
    lines.append("    ),")
    return "\n".join(lines)


def _py_type(idl_type: str) -> str:
    """IDL type → Python annotation (documentation only; wire is msgpack)."""
    prim = {"string": "str", "int": "int", "long": "int", "ulong": "int",
            "uint": "int", "short": "int", "ushort": "int", "byte": "int",
            "double": "float", "float": "float", "bool": "bool",
            "datum": "Datum", "void": "None", "raw": "bytes"}
    t = idl_type.strip()
    if t in prim:
        return prim[t]
    if t.startswith("list<") and t.endswith(">"):
        return f"List[{_py_type(t[5:-1])}]"
    if t.startswith("map<") and t.endswith(">"):
        k, _, v = t[4:-1].partition(",")
        return f"Dict[{_py_type(k)}, {_py_type(v)}]"
    if t.startswith("tuple<") and t.endswith(">"):
        inner = ", ".join(_py_type(x) for x in t[6:-1].split(","))
        return f"Tuple[{inner}]"
    return "Any"  # message types travel as msgpack lists


def emit_python_client(idl: IdlFile, service_name: str,
                       package: str = "jubatus_tpu_torch") -> str:
    """A generated, static, typed client module (≙ jenerator python.ml)
    over ``package``'s client library; ``package="jubatus_tpu"`` gives
    the JAX package's module byte for byte."""
    svc = idl.service(service_name)
    cls = service_name.title().replace("_", "")
    out = [
        f'"""Generated {service_name} client — {package}.codegen, from '
        f'{service_name}.idl. Do not edit."""',
        "",
        "from __future__ import annotations",
        "",
        "from typing import Any, Dict, List, Tuple",
        "",
        f"from {package}.client import ClientBase",
        f"from {package}.core.datum import Datum  # noqa: F401",
        "",
        "",
        f"class {cls}Client(ClientBase):",
        f'    ENGINE = "{service_name}"',
        "",
    ]
    for d in svc.methods:
        params = "".join(
            f", {a.name}: {_py_type(a.type)}" for a in d.args
        )
        ret = _py_type(d.return_type)
        call_args = "".join(f", {a.name}" for a in d.args)
        out += [
            f"    def {d.name}(self{params}) -> {ret}:",
            f'        """#{d.routing}'
            + (f"({d.cht_n})" if d.routing == "cht" else "")
            + f" #{d.lock} #{d.aggregator}\"\"\"",
            f'        return self.client.call("{d.name}", self.name{call_args})',
            "",
        ]
    return "\n".join(out)


def emit_rst(idl: IdlFile, service_name: str) -> str:
    """RST API documentation for one service (≙ tools/jubadoc rst_generator:
    same inputs — the .idl with its '#-' doc comments — same RST target)."""
    svc = idl.service(service_name)
    title = f"{service_name} API"
    out = [title, "=" * len(title), ""]
    if idl.messages:
        out += ["Data structures", "-" * len("Data structures"), ""]
        for msg in idl.messages:
            out.append(f".. describe:: {msg.name}")
            out.append("")
            for f in msg.fields:
                out.append(f"   :{f.index}: ``{f.type}`` {f.name}")
            out.append("")
    out += ["Methods", "-------", ""]
    for d in svc.methods:
        sig = ", ".join(f"{a.type} {a.name}" for a in d.args)
        out.append(f".. function:: {d.return_type} {d.name}({sig})")
        out.append("")
        routing = d.routing + (f"({d.cht_n})" if d.routing == "cht" else "")
        out.append(f"   :routing: {routing}")
        out.append(f"   :lock: {d.lock}")
        out.append(f"   :aggregator: {d.aggregator}")
        out.append("")
        for line in d.docs:
            out.append(f"   {line}" if line else "")
        if d.docs:
            out.append("")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    """CLI: ``python -m jubatus_tpu_torch.codegen <file.idl> [--client SERVICE]
    [--lang python|cpp|ruby|java|go] [--out DIR] [--table SERVICE]
    [--rst SERVICE]`` — single-file output prints to stdout; multi-file
    languages (cpp/ruby/java/go, ≙ jenerator's 5 client backends) write
    into --out (default '.')."""
    import argparse
    import os
    import sys

    from jubatus_tpu_torch.codegen.parser import parse_idl_file

    p = argparse.ArgumentParser(prog="jubatus_tpu_torch.codegen")
    p.add_argument("idl")
    p.add_argument("--client", default="", metavar="SERVICE")
    p.add_argument("--lang", default="python",
                   choices=("python", "cpp", "ruby", "java", "go"),
                   help="client language (with --client)")
    p.add_argument("--out", default=".", metavar="DIR",
                   help="output dir for multi-file languages")
    p.add_argument("--table", default="", metavar="SERVICE")
    p.add_argument("--rst", default="", metavar="SERVICE",
                   help="emit RST API docs (jubadoc)")
    ns = p.parse_args(argv)
    idl = parse_idl_file(ns.idl)
    if ns.client:
        if ns.lang == "python":
            sys.stdout.write(emit_python_client(idl, ns.client))
        else:
            from jubatus_tpu_torch.codegen.emit_clients import (
                emit_go_client,
                emit_java_client,
                emit_ruby_client,
            )
            from jubatus_tpu_torch.codegen.emit_cpp import emit_cpp_client

            emitter = {"cpp": emit_cpp_client, "ruby": emit_ruby_client,
                       "java": emit_java_client, "go": emit_go_client}[ns.lang]
            files = emitter(idl, ns.client)
            os.makedirs(ns.out, exist_ok=True)
            for fn, src in files.items():
                path = os.path.join(ns.out, fn)
                with open(path, "w", encoding="utf-8") as f:
                    f.write(src)
                print(path, file=sys.stderr)
    elif ns.rst:
        sys.stdout.write(emit_rst(idl, ns.rst))
    elif ns.table:
        sys.stdout.write(emit_service_table(idl.service(ns.table)))
    else:
        for svc in idl.services:
            sys.stdout.write(emit_service_table(svc) + "\n")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
