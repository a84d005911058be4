"""The host fold of the RPC mix (``tree_sum`` of
``jubatus_tpu/parallel/mix.py``).

Reference semantics (linear_mixer.cpp:437-559, SURVEY.md §3.3): the master
pulls diffs from all replicas, folds them pairwise, broadcasts the folded
diff, and every replica applies it via put_diff. Diffs here are host numpy
trees in both packages, so a JAX master and a port master fold the same
contributions to the same bits.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from jubatus_tpu_torch.utils.tree import tree_map


def _add(a: Any, b: Any) -> Any:
    """One leaf of the fold. Leaves whose LEADING dimension disagrees are
    zero-padded to the larger row count before adding."""
    an = getattr(a, "shape", None)
    bn = getattr(b, "shape", None)
    if an and bn and len(an) == len(bn) and an != bn and an[1:] == bn[1:]:
        rows = max(an[0], bn[0])
        if an[0] < rows:
            a = np.concatenate(
                [np.asarray(a),
                 np.zeros((rows - an[0],) + tuple(an[1:]),
                          np.asarray(a).dtype)])
        if bn[0] < rows:
            b = np.concatenate(
                [np.asarray(b),
                 np.zeros((rows - bn[0],) + tuple(bn[1:]),
                          np.asarray(b).dtype)])
    return a + b


def tree_sum(diffs: Sequence[Any]) -> Any:
    """Host-side fold of diff trees (the reference's pairwise fold —
    associative here, so order is irrelevant).

    Leaves whose LEADING dimension disagrees are zero-padded to the
    larger row count before adding: row-trimmed label diffs
    (models/classifier.py _ClassifierMixable) can legitimately differ by
    a row when a replica trained a novel label between the round's
    schema sync and its get_diff — the pad reproduces the full-capacity
    semantics (absent rows contribute zeros) instead of aborting the
    round on a shape error."""
    acc = diffs[0]
    for d in diffs[1:]:
        acc = tree_map(_add, acc, d)
    return acc
