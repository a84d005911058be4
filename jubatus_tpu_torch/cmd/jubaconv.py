"""Offline json→datum→fv conversion debugger (copy of
``jubatus_tpu/cmd/jubaconv.py``; ≙ cmd/jubaconv.cpp:131-160).

    echo '{"user": "alice", "age": 31}' | jubaconv -o datum
    echo '{"text": "hello world"}' | jubaconv -c conf.json -o fv

Input on stdin; ``-i json`` (default) or ``-i datum`` (the datum JSON shape
``{"string_values": [[k,v]...], "num_values": [[k,v]...]}``); ``-o`` picks
the pipeline stage to print: json | datum | fv. ``-o fv`` needs ``-c`` with
a converter config (same JSON schema the servers use).

JSON→datum flattening matches the reference's json_converter: nested object
keys join with '/', array elements index as '[i]'; strings become
string_values, numbers num_values, bools 1/0.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, List, Optional, Tuple

from jubatus_tpu_torch.core.datum import Datum


def json_to_datum(obj: Any) -> Datum:
    """Flatten a JSON document into a datum (≙ core json_converter)."""
    strings: List[Tuple[str, str]] = []
    nums: List[Tuple[str, float]] = []

    def walk(prefix: str, v: Any) -> None:
        if isinstance(v, dict):
            for k, sub in v.items():
                walk(f"{prefix}/{k}" if prefix else str(k), sub)
        elif isinstance(v, list):
            for i, sub in enumerate(v):
                walk(f"{prefix}[{i}]", sub)
        elif isinstance(v, bool):
            nums.append((prefix, 1.0 if v else 0.0))
        elif isinstance(v, (int, float)):
            nums.append((prefix, float(v)))
        elif isinstance(v, str):
            strings.append((prefix, v))
        elif v is None:
            pass
        else:
            raise TypeError(f"cannot convert {type(v).__name__} at {prefix!r}")

    walk("", obj)
    d = Datum()
    d.string_values = strings
    d.num_values = nums
    return d


def datum_from_json_shape(obj: Any) -> Datum:
    d = Datum()
    d.string_values = [(str(k), str(v)) for k, v in obj.get("string_values", [])]
    d.num_values = [(str(k), float(v)) for k, v in obj.get("num_values", [])]
    return d


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="jubaconv")
    p.add_argument("-i", "--input-format", default="json",
                   choices=["json", "datum"])
    p.add_argument("-o", "--output-format", default="fv",
                   choices=["json", "datum", "fv"])
    p.add_argument("-c", "--conf", default="", help="converter config file")
    return p


def main(argv: Optional[List[str]] = None,
         stdin=None, stdout=None) -> int:
    ns = _parser().parse_args(argv)
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    try:
        doc = json.load(stdin)
    except json.JSONDecodeError:
        print(f"invalid {ns.input_format} format", file=sys.stderr)
        return 1

    if ns.output_format == "json":
        if ns.input_format != "json":
            print("cannot output json from datum input", file=sys.stderr)
            return 1
        json.dump(doc, stdout, indent=1)
        stdout.write("\n")
        return 0

    datum = (json_to_datum(doc) if ns.input_format == "json"
             else datum_from_json_shape(doc))

    if ns.output_format == "datum":
        json.dump({"string_values": [[k, v] for k, v in datum.string_values],
                   "num_values": [[k, v] for k, v in datum.num_values]},
                  stdout, indent=1)
        stdout.write("\n")
        return 0

    # fv: needs the converter config (convert_datum, jubaconv.cpp:61-75)
    if not ns.conf:
        print("-o fv requires -c <converter config>", file=sys.stderr)
        return 1
    from jubatus_tpu_torch.core.fv.converter import make_fv_converter

    with open(ns.conf) as f:
        conf = json.load(f)
    conv = make_fv_converter(conf.get("converter", conf))
    for key, value in sorted(conv.convert_named(datum).items()):
        stdout.write(f"{key}: {value}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
