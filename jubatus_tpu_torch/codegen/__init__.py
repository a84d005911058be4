"""IDL compiler (copy of ``jubatus_tpu/codegen/``; ≙ tools/jenerator/,
OCaml — rebuilt in Python).

The reference generates server bindings, proxy routing tables, and client
libraries for five languages from msgpack-IDL files with three decorator
groups per RPC — routing / lock / aggregator
(tools/jenerator/src/syntax.ml:41-66, README.rst:34-47). Here:

- ``parser``  — parse the same .idl dialect into an AST,
- ``emit``    — emit the framework's routing table (framework/idl.py
  SERVICES entries) and typed Python client modules.

Every emitter's output is the JAX package's, byte for byte
(tests/test_torch_codegen.py); a generated Python client imports the
port's client library unless ``package`` names another.
"""

from jubatus_tpu_torch.codegen.parser import (  # noqa: F401
    IdlFile,
    Message,
    MethodDecl,
    Service,
    parse_idl,
    parse_idl_file,
)
from jubatus_tpu_torch.codegen.emit import (  # noqa: F401
    emit_python_client,
    emit_rst,
    emit_service_table,
    to_methods,
)
