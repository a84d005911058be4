"""Fan-out reducers (copy of ``jubatus_tpu/rpc/aggregators.py``;
≙ framework/aggregators.hpp:27-63).

Used by the proxy's broadcast/cht routes and by RpcMClient.call_fold. The IDL
decorators #@merge/#@concat/#@pass/#@all_and/#@all_or name these; `add`
exists in the reference's aggregator library (aggregators.hpp:51) but no
shipped .idl uses it.
"""

from __future__ import annotations

from typing import Any, Dict, List


def merge(a: Dict, b: Dict) -> Dict:
    out = dict(a)
    out.update(b)
    return out


def concat(a: List, b: List) -> List:
    return list(a) + list(b)


def pass_(a: Any, b: Any) -> Any:  # noqa: ARG001 — keep first, per reference
    return a


def add(a: Any, b: Any) -> Any:
    return a + b


def all_and(a: Any, b: Any) -> bool:
    return bool(a) and bool(b)


def all_or(a: Any, b: Any) -> bool:
    return bool(a) or bool(b)


BY_NAME = {
    "merge": merge,
    "concat": concat,
    "pass": pass_,
    "add": add,
    "all_and": all_and,
    "all_or": all_or,
}
