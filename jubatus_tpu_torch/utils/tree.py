"""Plain walks over diff trees: nested dicts, lists and tuples whose
leaves are numpy arrays or scalars. They take the place of the
``jax.tree_util`` walks in the JAX package's mix plane, with the same
leaf order: dict keys sorted, sequences in order, ``None`` an empty
subtree.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in jax.tree_util order."""
    out: List[Any] = []

    def walk(node: Any) -> None:
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x)
        else:
            out.append(node)

    walk(tree)
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied leafwise over ``tree`` and the trees in ``rest``,
    which must have its structure; the result has it too."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        if any(not isinstance(r, dict) or r.keys() != tree.keys()
               for r in rest):
            raise ValueError("tree structures differ")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        if any(not isinstance(r, (list, tuple)) or len(r) != len(tree)
               for r in rest):
            raise ValueError("tree structures differ")
        out = [tree_map(fn, x, *(r[i] for r in rest))
               for i, x in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def tree_flatten(tree: Any):
    """``(leaves, spec)``: the leaves in ``tree_leaves`` order and a spec
    of the structure that ``tree_unflatten`` rebuilds it from. ``str(spec)``
    is stable, so it can key a plan on the structure."""

    def spec_of(node: Any):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", tuple(keys), tuple(spec_of(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            kind = "tuple" if isinstance(node, tuple) else "list"
            return (kind, tuple(spec_of(x) for x in node))
        return ("*",)

    return tree_leaves(tree), spec_of(tree)


def tree_unflatten(spec: Any, leaves: List[Any]) -> Any:
    """The tree of structure ``spec`` (from ``tree_flatten``) holding
    ``leaves`` in order."""
    it = iter(leaves)

    def build(s: Any) -> Any:
        kind = s[0]
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(sub) for k, sub in zip(s[1], s[2])}
        if kind in ("list", "tuple"):
            out = [build(sub) for sub in s[1]]
            return tuple(out) if kind == "tuple" else out
        return next(it)

    return build(spec)
