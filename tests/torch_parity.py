"""Helpers shared by the port's parity tests (tests/test_torch_*.py)."""

from __future__ import annotations

import functools


def port_mix(drivers):
    """One mix round over port drivers as the JAX package's LocalMixGroup
    runs it: the schema union where the drivers have one, then every
    mixable's diffs folded (its own ``mix``, else summed key by key) and
    put back on every driver."""
    schemas = [d.get_schema() for d in drivers if hasattr(d, "get_schema")]
    if schemas:
        union = sorted(set().union(*map(set, schemas)))
        for d in drivers:
            d.sync_schema(union)
    for name in drivers[0].get_mixables():
        ms = [d.get_mixables()[name] for d in drivers]
        diffs = [m.get_diff() for m in ms]
        fold = getattr(ms[0], "mix", None)
        if fold is None:
            total = {k: functools.reduce(lambda a, b: a + b,
                                         [df[k] for df in diffs])
                     for k in diffs[0]}
        else:
            total = functools.reduce(fold, diffs)
        for m in ms:
            m.put_diff(total)
