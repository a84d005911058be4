"""C++ client emitter (≙ jenerator's cpp.ml client backend).

Generates, for one IDL service, a self-contained typed C++ client header
mirroring the reference's generated clients (classifier_client.hpp:19-60:
same class layout ``jubatus_tpu::<engine>::client::<engine>`` over a common
base, same method signatures) — but over the framework's own dependency-free
runtime header (templates/jubatus_tpu_client.hpp) instead of the external
jubatus_msgpack-rpc stack, so a generated client builds with nothing but
``g++`` and talks to any wire-compatible server (this framework's or the
reference's).

``emit_cpp_client(idl, service)`` returns ``{filename: source}`` — the
generated ``<service>_client.hpp`` plus the (constant) runtime header.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

from jubatus_tpu_torch.codegen.parser import (
    IdlFile,
    Message,
    Service,
    split_top_commas as _split_top,
)

_TEMPLATE_DIR = os.path.join(os.path.dirname(__file__), "templates")
RUNTIME_HEADER_NAME = "jubatus_tpu_client.hpp"

_PRIMITIVES = {
    "string": "std::string",
    "datum": "jubatus_tpu::datum",
    "bool": "bool",
    "double": "double",
    "float": "float",
    "int": "int64_t",
    "long": "int64_t",
    "short": "int64_t",
    "byte": "int64_t",
    "uint": "uint64_t",
    "ulong": "uint64_t",
    "ushort": "uint64_t",
    "raw": "std::string",
}


def runtime_header() -> str:
    with open(os.path.join(_TEMPLATE_DIR, RUNTIME_HEADER_NAME)) as f:
        return f.read()



def cpp_type(idl_type: str, qualify: str = "") -> str:
    """IDL type expression → C++ type. ``qualify`` prefixes message-struct
    names (needed where the emitted code sits outside their namespace, i.e.
    the conv<> specializations at jubatus_tpu scope)."""
    t = idl_type.strip()
    if t in _PRIMITIVES:
        return _PRIMITIVES[t]
    for outer, tmpl in (("list<", "std::vector<{} >"),
                        ("map<", "std::map<{} >"),
                        ("tuple<", "std::pair<{} >")):
        if t.startswith(outer) and t.endswith(">"):
            inner = _split_top(t[len(outer):-1])
            return tmpl.format(", ".join(cpp_type(x, qualify) for x in inner))
    return f"{qualify}::{t}" if qualify else t  # a message struct


def _emit_struct(msg: Message, ns: str) -> str:
    lines = [f"struct {msg.name} {{"]
    for f in sorted(msg.fields, key=lambda f: f.index):
        lines.append(f"  {cpp_type(f.type)} {f.name};")
    lines.append("};")
    return "\n".join(lines)


def _emit_conv(msg: Message, ns: str) -> str:
    """conv<> specialization: a message packs as the array of its fields in
    index order (the reference's MSGPACK_DEFINE layout)."""
    qual = f"{ns}::{msg.name}"
    fields = sorted(msg.fields, key=lambda f: f.index)
    to_lines = [f"    mp::value v = mp::v_arr();"]
    for f in fields:
        to_lines.append(
            f"    v.a.push_back(conv<{cpp_type(f.type, ns)} >::to(x.{f.name}));")
    to_lines.append("    return v;")
    from_lines = [f"    const std::vector<mp::value>& a = v.as_arr();",
                  f"    {qual} x;"]
    for j, f in enumerate(fields):
        from_lines.append(
            f"    x.{f.name} = conv<{cpp_type(f.type, ns)} >::from(a.at({j}));")
    from_lines.append("    return x;")
    return "\n".join(
        [f"template <>",
         f"struct conv<{qual} > {{",
         f"  static mp::value to(const {qual}& x) {{"]
        + to_lines
        + ["  }",
           f"  static {qual} from(const mp::value& v) {{"]
        + from_lines
        + ["  }", "};"])


def _emit_method(d) -> str:
    ret = cpp_type(d.return_type)
    params = ", ".join(
        f"const {cpp_type(a.type)}& {a.name}"
        if cpp_type(a.type) not in ("bool", "double", "float", "int64_t", "uint64_t")
        else f"{cpp_type(a.type)} {a.name}"
        for a in d.args)
    body = ["    std::vector<mp::value> p = args();"]
    for a in d.args:
        body.append(f"    p.push_back(conv<{cpp_type(a.type)} >::to({a.name}));")
    call = f'call("{d.name}", p)'
    if d.return_type.strip() == "void":
        body.append(f"    {call};")
        sig_ret = "void"
    else:
        body.append(f"    return conv<{ret} >::from({call});")
        sig_ret = ret
    routing = d.routing + (f"({d.cht_n})" if d.routing == "cht" else "")
    return "\n".join(
        [f"  // #{routing} #{d.lock} #{d.aggregator}",
         f"  {sig_ret} {d.name}({params}) {{"] + body + ["  }"])


def _topo_messages(messages: List[Message]) -> List[Message]:
    """Dependency order: a message's conv<> must be visible before any
    message (or container) that embeds it references conv<> of it."""
    names = {m.name for m in messages}
    by_name = {m.name: m for m in messages}
    deps = {
        m.name: {w for f in m.fields
                 for w in re.findall(r"\w+", f.type) if w in names}
        for m in messages
    }
    out, done = [], set()

    def visit(n: str, stack: frozenset = frozenset()) -> None:
        if n in done or n in stack:
            return
        for d in sorted(deps[n]):
            visit(d, stack | {n})
        done.add(n)
        out.append(by_name[n])

    for m in messages:
        visit(m.name)
    return out


def emit_cpp_client(idl: IdlFile, service_name: str) -> Dict[str, str]:
    svc: Service = idl.service(service_name)
    ns = service_name
    guard = f"JUBATUS_TPU_CLIENT_{service_name.upper()}_CLIENT_HPP_"

    out = [
        f"// {service_name}_client.hpp — generated from {service_name}.idl by",
        "// jubatus_tpu.codegen (--lang cpp). *** DO NOT EDIT ***",
        "//",
        "// Mirrors the reference's generated client API",
        f"// (jubatus/client/{service_name}_client.hpp) over the self-contained",
        f"// runtime in {RUNTIME_HEADER_NAME} (no external dependencies).",
        f"#ifndef {guard}",
        f"#define {guard}",
        "",
        "#include <map>",
        "#include <string>",
        "#include <utility>",
        "#include <vector>",
        "",
        f'#include "{RUNTIME_HEADER_NAME}"',
        "",
        "namespace jubatus_tpu {",
        f"namespace {ns} {{",
        "",
    ]
    ordered = _topo_messages(idl.messages)
    for msg in ordered:
        out.append(_emit_struct(msg, ns))
        out.append("")
    out.append(f"}}  // namespace {ns}")
    out.append("")
    if ordered:
        out.append("// msgpack layout: array of fields in IDL index order")
        for msg in ordered:
            out.append(_emit_conv(msg, ns))
            out.append("")
    out += [
        f"namespace {ns} {{",
        "namespace client {",
        "",
        f"class {service_name} : public jubatus_tpu::client::common::client {{",
        " public:",
        f"  {service_name}(const std::string& host, uint64_t port,",
        "      const std::string& name, double timeout_sec = 10.0)",
        "      : jubatus_tpu::client::common::client(host, port, name, timeout_sec) {",
        "  }",
        "",
    ]
    # bring emitted struct names used in signatures into scope of conv<> refs:
    # conv specializations are fully qualified, struct refs resolve inside ns.
    for d in svc.methods:
        out.append(_emit_method(d))
        out.append("")
    out += [
        "};",
        "",
        "}  // namespace client",
        f"}}  // namespace {ns}",
        "}  // namespace jubatus_tpu",
        "",
        f"#endif  // {guard}",
        "",
    ]
    return {
        f"{service_name}_client.hpp": "\n".join(out),
        RUNTIME_HEADER_NAME: runtime_header(),
    }
