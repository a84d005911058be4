"""msgpack-IDL parser (≙ tools/jenerator/src/{jdl_lexer.mll,jdl_parser.mly}).

Grammar subset actually used by the 11 engine IDLs:

    message NAME[("c++ alias")] { <idx>: <type> <field> ... }
    service NAME { [#@decorators] <rettype> <method>(<idx>: <type> <arg>, ...) }

Decorator tokens (syntax.ml:41-66): routing ``#@random | #@broadcast |
#@cht[(n)] | #@internal``; lock ``#@update | #@analysis | #@nolock``;
aggregator ``#@pass | #@all_and | #@all_or | #@concat | #@merge`` (plus
``#@add``, accepted because the reducer exists in aggregators.hpp:51 even
though no shipped .idl uses it).
``#@cht`` without an argument means 2 successors (jenerator README.rst:40).
``#-`` lines are docs, other ``#`` lines comments.

Types are kept as strings ("list<labeled_datum>", "map<string, ulong>") —
the wire is msgpack either way; emitters use them for docstrings only.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

ROUTINGS = {"random", "broadcast", "cht", "internal"}
LOCKS = {"update", "analysis", "nolock"}
AGGREGATORS = {"pass", "all_and", "all_or", "concat", "merge", "add"}


class IdlSyntaxError(ValueError):
    pass


@dataclass
class Field:
    index: int
    type: str
    name: str


@dataclass
class Message:
    name: str
    fields: List[Field] = field(default_factory=list)
    alias: str = ""  # C++ mapping annotation, e.g. "std::pair<...>"


@dataclass
class MethodDecl:
    name: str
    return_type: str
    args: List[Field] = field(default_factory=list)
    routing: str = "random"
    cht_n: int = 2
    lock: str = "nolock"
    aggregator: str = "pass"
    #: '#-' doc comment lines preceding the decl (consumed by the RST
    #: emitter, ≙ tools/jubadoc)
    docs: List[str] = field(default_factory=list)


@dataclass
class Service:
    name: str
    methods: List[MethodDecl] = field(default_factory=list)


@dataclass
class IdlFile:
    messages: List[Message] = field(default_factory=list)
    services: List[Service] = field(default_factory=list)

    def service(self, name: str) -> Service:
        for s in self.services:
            if s.name == name:
                return s
        raise KeyError(name)


_MESSAGE_RE = re.compile(r'^message\s+(\w+)\s*(?:\(\s*"([^"]*)"\s*\))?\s*\{')
_SERVICE_RE = re.compile(r"^service\s+(\w+)\s*\{")
_FIELD_RE = re.compile(r"^(\d+)\s*:\s*(.+?)\s+(\w+)$")
_METHOD_RE = re.compile(r"^(.+?)\s+(\w+)\s*\((.*)\)$", re.S)
_DECORATOR_RE = re.compile(r"#@(\w+)(?:\((\d+)\))?")


def split_top_commas(text: str) -> List[str]:
    """Split on commas outside <> nesting — shared by the parser (method
    arg lists) and every typed client emitter (template argument lists)."""
    out, depth, cur = [], 0, []
    for ch in text:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur and "".join(cur).strip():
        out.append("".join(cur))
    return [a.strip() for a in out if a.strip()]


_split_args = split_top_commas


def _parse_field(text: str, where: str) -> Field:
    m = _FIELD_RE.match(text.strip())
    if not m:
        raise IdlSyntaxError(f"bad field {text!r} in {where}")
    return Field(int(m.group(1)), m.group(2).strip(), m.group(3))


def parse_idl(text: str, name: str = "<idl>") -> IdlFile:
    idl = IdlFile()
    current_message: Optional[Message] = None
    current_service: Optional[Service] = None
    pending: List[Tuple[str, Optional[str]]] = []  # decorator (name, arg)
    pending_docs: List[str] = []  # '#-' doc lines for the next decl
    # join continuation lines: a method/field spans until its parens balance
    buffer = ""

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if line.startswith("#@"):
            pending.extend((d, a or None) for d, a in _DECORATOR_RE.findall(line))
            continue
        if line.startswith("#-"):
            pending_docs.append(line[2:].lstrip(" "))
            continue
        if not line or line.startswith("#"):
            continue  # plain comments
        if line.startswith("%include"):
            continue  # C++ header pragma for the jenerator cpp backend
        # strip trailing comments (burst.idl has '...) # //@broadcast')
        if "#" in line:
            line = line[: line.index("#")].strip()
            if not line:
                continue
        if buffer:
            line = f"{buffer} {line}"
            buffer = ""

        if current_message is None and current_service is None:
            m = _MESSAGE_RE.match(line)
            if m:
                current_message = Message(m.group(1), alias=m.group(2) or "")
                pending_docs = []  # block-level docs don't belong to a field
                continue
            m = _SERVICE_RE.match(line)
            if m:
                current_service = Service(m.group(1))
                pending_docs = []  # service docs don't belong to method #1
                continue
            raise IdlSyntaxError(f"{name}:{lineno}: unexpected {line!r}")

        if line == "}":
            if current_message is not None:
                idl.messages.append(current_message)
                current_message = None
            else:
                idl.services.append(current_service)
                current_service = None
            pending = []
            pending_docs = []
            continue

        if current_message is not None:
            current_message.fields.append(_parse_field(line, current_message.name))
            continue

        # inside a service: a method decl (may span lines)
        if line.count("(") > line.count(")") or "(" not in line:
            buffer = line
            continue
        m = _METHOD_RE.match(line)
        if not m:
            raise IdlSyntaxError(f"{name}:{lineno}: bad method {line!r}")
        decl = MethodDecl(name=m.group(2), return_type=m.group(1).strip(),
                          docs=pending_docs)
        pending_docs = []
        decl.args = [_parse_field(a, decl.name) for a in _split_args(m.group(3))]
        for dec, arg in pending:
            if dec in ROUTINGS:
                decl.routing = dec
                if dec == "cht":
                    decl.cht_n = int(arg) if arg else 2
            elif dec in LOCKS:
                decl.lock = dec
            elif dec in AGGREGATORS:
                decl.aggregator = dec
            else:
                raise IdlSyntaxError(
                    f"{name}:{lineno}: unknown decorator #@{dec}")
        pending = []
        current_service.methods.append(decl)

    if buffer or current_message is not None or current_service is not None:
        raise IdlSyntaxError(f"{name}: unexpected end of file")
    return idl


def parse_idl_file(path: str) -> IdlFile:
    with open(path) as f:
        return parse_idl(f.read(), name=path)


def parse_reference_idls(root: str) -> Dict[str, IdlFile]:
    """Parse every .idl under a directory (e.g. the reference's server dir)."""
    import glob
    import os

    out = {}
    for path in sorted(glob.glob(os.path.join(root, "*.idl"))):
        engine = os.path.splitext(os.path.basename(path))[0]
        out[engine] = parse_idl_file(path)
    return out
